"""The port's spans (``fmdm_tpu_torch/utils/trace.py``) on the CPU: nothing
recorded outside a profiler session; inside one, a train step's phases, a
sampler call's steps and K1's and K2's plain backwards with their parents
and units; a span on a thread with none open of its own under the span open
on another; the ring's ranges under their names. A CPU span has no device
time."""

import threading

import pytest
import torch
import torch.nn as nn
from torch.profiler import ProfilerActivity, profile

from fmdm_tpu_torch.ops.kernels import group_norm, small_t_attention
from fmdm_tpu_torch.parallel.sequence import HOP, DeviceRing
from fmdm_tpu_torch.sample.engine import SamplingEngine
from fmdm_tpu_torch.schedulers.registry import build_scheduler
from fmdm_tpu_torch.train.common import make_adamw, make_denoise_train_step
from fmdm_tpu_torch.utils import trace


class TinyDenoiser(nn.Module):
    """A conv, K1's and K2's autograd Functions (whose launches the tests
    patch to the plain versions: on the CPU the wrappers never reach them),
    and a conv out."""

    def __init__(self):
        super().__init__()
        self.inp = nn.Conv2d(2, 4, 3, padding=1)
        self.gn_w, self.gn_b = nn.Parameter(torch.ones(4)), nn.Parameter(torch.zeros(4))
        self.out = nn.Conv2d(4, 1, 1)

    def forward(self, x, t, context_ca=None):
        h = self.inp(x)
        h = group_norm._GroupNormAct.apply(h, self.gn_w, self.gn_b, None, None, 2, 1e-5, True)
        n, c, hh, ww = h.shape
        q = h.flatten(2).transpose(1, 2).unsqueeze(1).contiguous()   # (n, 1, T, c)
        a = small_t_attention._SmallTAttention.apply(q, q, q, 0.5)
        return self.out(h + a.squeeze(1).transpose(1, 2).reshape(n, c, hh, ww))


@pytest.fixture(autouse=True)
def fresh_spans():
    trace.clear()
    yield
    trace.clear()


@pytest.fixture
def plain_launches(monkeypatch):
    monkeypatch.setattr(group_norm, "_launch", lambda x, w, b, scale, shift, g, eps, act:
                        group_norm.group_norm_act_reference(x, w, b, num_groups=g, eps=eps,
                                                            act=act, scale=scale, shift=shift))
    monkeypatch.setattr(small_t_attention, "_launch", lambda q, k, v, scale:
                        small_t_attention.small_t_attention_reference(q, k, v, scale=scale))


def _train_step():
    torch.manual_seed(0)
    model = TinyDenoiser()
    scheduler, _ = build_scheduler({"name": "flowmatch", "num_train_timesteps": 1000}, {})
    optimizer, rate = make_adamw(model.parameters(), 1e-4, 0.0, 0, 10)
    step = make_denoise_train_step(model, scheduler, optimizer, rate, variant="flow_matching",
                                   conditioning_mode="concatenate", latent_norm=None,
                                   device="cpu")
    batch = {"target": torch.randn(2, 1, 4, 4), "image": torch.randn(2, 1, 4, 4),
             "valid": torch.ones(2)}
    return step, batch


def _by_name(got):
    out = {}
    for s in got:
        out.setdefault(s.name, []).append(s)
    return out


def test_no_session_records_nothing(plain_launches):
    assert trace.span("train.step") is trace.span("anything")
    with trace.span("train.step") as s:
        pass
    assert s is trace.span("train.step")
    step, batch = _train_step()
    step.step(batch, generator=torch.Generator().manual_seed(1))
    assert trace.spans() == []


def test_train_step_phases_and_plain_backwards(plain_launches):
    step, batch = _train_step()
    gen = torch.Generator().manual_seed(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            step.step(batch, generator=gen)
    got = trace.spans()
    named = _by_name(got)
    assert {k: len(v) for k, v in named.items()} == {
        "train.step": 2, "train.forward": 2, "train.backward": 2, "train.optimizer": 2,
        "k1.backward": 2, "k2.backward": 2}
    ids = {s.id: s for s in got}
    for unit, root in enumerate(named["train.step"]):
        assert root.parent is None and root.unit == unit
    for name in ("train.forward", "train.backward", "train.optimizer"):
        for s in named[name]:
            assert ids[s.parent].name == "train.step" and s.unit == ids[s.parent].unit
    for name in ("k1.backward", "k2.backward"):
        for s in named[name]:
            assert ids[s.parent].name == "train.backward" and s.unit == ids[s.parent].unit
    assert all(s.device_ms is None and s.host_ms >= 0 for s in got)
    # the step's phases nest inside it on the host clock too
    for root in named["train.step"]:
        inside = [s for s in got if s.parent == root.id]
        assert sum(s.host_ms for s in inside) <= root.host_ms
    # the profiler shows each span as a range of its own
    events = [e.name for e in prof.events()]
    for name in named:
        assert events.count(name) == len(named[name])


def test_sampler_call_steps(plain_launches):
    torch.manual_seed(0)
    model = TinyDenoiser()
    scheduler, _ = build_scheduler({"name": "flowmatch", "num_train_timesteps": 1000}, {})
    engine = SamplingEngine(model, scheduler, scheduler.set_timesteps(3),
                            conditioning_mode="concatenate", device="cpu")
    shape = (2, 1, 4, 4)
    with profile(activities=[ProfilerActivity.CPU]):
        engine(shape, conditioning_batch=torch.randn(shape), init_sample=torch.randn(shape))
    got = trace.spans()
    named = _by_name(got)
    assert {k: len(v) for k, v in named.items()} == {
        "sample.call": 1, "sample.model": 3, "sample.scheduler": 3}
    (call,) = named["sample.call"]
    assert call.parent is None and call.unit == 0
    assert all(s.parent == call.id and s.unit == 0 and s.device_ms is None
               for s in named["sample.model"] + named["sample.scheduler"])


def test_a_thread_without_spans_takes_the_span_open_elsewhere(monkeypatch):
    """As autograd's device thread does during ``backward()``: the thread
    inherits the caller's profiler session (a plain thread does not, so the
    check is forced on for it here)."""
    def inner():
        with trace.span("inner"):
            pass

    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("outer") as outer:
            monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
            worker = threading.Thread(target=inner)
            worker.start()
            worker.join(timeout=30)
            assert not worker.is_alive()
            monkeypatch.undo()
    inner = _by_name(trace.spans())["inner"][0]
    assert inner.parent == outer.id and inner.unit == outer.unit


def test_ring_hop_keeps_its_name():
    ring = DeviceRing(["cpu", "cpu"])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ring.shift([[torch.zeros(2), torch.ones(2)]])
    assert [s.name for s in trace.spans()] == [HOP] == ["ring hop"]
    assert sum(e.name == HOP for e in prof.events()) == 1
