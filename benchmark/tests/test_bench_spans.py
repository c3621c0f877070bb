"""The readers of the program's spans (``metrics/program_spans.py`` and the
metrics beside it): their arithmetic on made-up spans, None where the
window's roots are not one per unit or the program has no spans, and, on
the card, the harness's own traced window of a tiny cell: every span timed
on the device, K1's plain backward on autograd's device thread counted once
per K1 launch of the forward."""

import dataclasses
import sys
import threading

import pytest
import torch

from benchmark.harness import Bench, TraceReading
from benchmark.tests.tiny import REPO, tiny_root

Span = dataclasses.make_dataclass("Span", ["name", "id", "parent", "unit", "host_ms",
                                           "device_ms"])
TRAIN_METRICS = ["forward_ms.train", "backward_ms.train", "optimizer_ms.train",
                 "k1_backward_ms.train", "k2_backward_ms.train", "host_enqueue_ms.train"]
SAMPLE_METRICS = ["host_enqueue_ms.sample", "scheduler_ms.sample"]


def reading(train: bool, units: int, forwards_per_unit: int = 1) -> TraceReading:
    return TraceReading(train=train, forwards_per_unit=forwards_per_unit, timed_units=0,
                        timed_s=0.0, units=units, window_s=1.0, busy_s=0.5, kernel_s={},
                        class_s={}, ops=[], dtype="bfloat16", peak_bytes=0)


def made_up(roots, children):
    """Spans of ``len(roots)`` units: each root (name, host, device) with
    the children (name, host, device) under it."""
    out, next_id = [], 0
    for unit, (name, host, dev) in enumerate(roots):
        root = Span(name, next_id, None, unit, host, dev)
        out.append(root)
        next_id += 1
        for child_name, child_host, child_dev in children:
            out.append(Span(child_name, next_id, root.id, unit, child_host, child_dev))
            next_id += 1
    return out


def read(metric, r, spans, monkeypatch):
    from fmdm_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "spans", lambda: spans)
    return Bench(REPO).reader(metric).read(r)


TRAIN_CHILDREN = [("train.forward", 10.0, 50.0), ("train.backward", 30.0, 280.0),
                  ("k1.backward", 0.2, 2.0), ("k1.backward", 0.2, 1.0),
                  ("k2.backward", 0.1, 0.5), ("train.optimizer", 1.0, 5.0)]


@pytest.mark.parametrize("metric,want", [
    ("forward_ms.train", 50.0), ("backward_ms.train", 280.0), ("optimizer_ms.train", 5.0),
    ("k1_backward_ms.train", 3.0), ("k2_backward_ms.train", 0.5),
    ("host_enqueue_ms.train", 120.0)])
def test_train_readers_per_step(monkeypatch, metric, want):
    spans = made_up([("train.step", 120.0, 340.0)] * 4, TRAIN_CHILDREN)
    assert read(metric, reading(True, 4), spans, monkeypatch) == pytest.approx(want)


@pytest.mark.parametrize("metric,want", [
    # per denoise step: (model + scheduler host ms) x 5 steps over 5 steps
    ("host_enqueue_ms.sample", 3.0 + 0.5), ("scheduler_ms.sample", 0.04)])
def test_sample_readers_per_denoise_step(monkeypatch, metric, want):
    steps = [("sample.model", 3.0, 90.0), ("sample.scheduler", 0.5, 0.04)] * 5
    spans = made_up([("sample.call", 20.0, 460.0)] * 2, steps)
    assert read(metric, reading(False, 2, forwards_per_unit=5), spans,
                monkeypatch) == pytest.approx(want)


@pytest.mark.parametrize("metric", TRAIN_METRICS)
def test_none_where_roots_are_not_one_per_unit(monkeypatch, metric):
    spans = made_up([("train.step", 120.0, 340.0)] * 3, TRAIN_CHILDREN)
    assert read(metric, reading(True, 4), spans, monkeypatch) is None
    # a sample call's root does not count as a step
    spans += made_up([("sample.call", 1.0, 1.0)], [])
    assert read(metric, reading(True, 4), spans, monkeypatch) is None


@pytest.mark.parametrize("metric", TRAIN_METRICS + SAMPLE_METRICS)
def test_none_without_device_time_or_spans(monkeypatch, metric):
    train = metric.endswith(".train")
    root = ("train.step", 120.0, None) if train else ("sample.call", 20.0, None)
    kids = [(n, h, None) for n, h, _ in TRAIN_CHILDREN] if train else [
        ("sample.model", 3.0, None), ("sample.scheduler", 0.5, None)]
    r = reading(train, 2)
    assert read(metric, r, made_up([root] * 2, kids), monkeypatch) is None
    assert read(metric, r, [], monkeypatch) is None


@pytest.mark.parametrize("metric", TRAIN_METRICS + SAMPLE_METRICS)
def test_none_where_the_program_has_no_spans(monkeypatch, metric):
    """A checkout before the spans: the module does not import."""
    monkeypatch.setitem(sys.modules, "fmdm_tpu_torch.utils.trace", None)
    assert Bench(REPO).reader(metric).read(reading(metric.endswith(".train"), 2)) is None


@pytest.mark.card
def test_the_harness_window_records_every_span_on_the_card(tmp_path):
    """Under the harness's device-only session: the session reads as active
    on the calling thread and on autograd's device thread; a tiny cell's
    traced window gives every span a device time, one ``k1.backward`` per K1
    launch of a step's forward, and every new metric in the line."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import harness
    from fmdm_tpu_torch.ops.kernels.group_norm import K1
    from fmdm_tpu_torch.utils import trace

    seen = {}

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, grad):
            seen["thread"] = threading.get_ident()
            seen["enabled"] = torch.autograd._profiler_enabled()
            return grad * 2

    x = torch.ones(8, device="cuda", requires_grad=True)
    with profile(activities=[ProfilerActivity.CUDA]):
        assert torch.autograd._profiler_enabled()
        Probe.apply(x).sum().backward()
    assert seen["thread"] != threading.get_ident() and seen["enabled"] is True

    root = tiny_root(tmp_path)
    checked = harness.Bench(root).cell("tiny2d_train")["checked_steps"]
    trace.clear()
    launches = K1.launches
    line = harness.run_cell(root, "tiny2d_train", 4_000_000_321, 0.5, True, device="cuda")
    steps = checked + line["attempted"]     # the checked steps of set-up, then both windows
    per_step = (K1.launches - launches) / steps
    got = trace.spans()
    assert got and all(s.device_ms is not None for s in got)
    ids = {s.id: s for s in got}
    roots = [s for s in got if s.parent is None]
    assert {s.name for s in roots} == {"train.step"} and len(roots) == 2
    k1 = [s for s in got if s.name == "k1.backward"]
    assert len(k1) == per_step * len(roots) and per_step > 0
    assert all(ids[s.parent].name == "train.backward" for s in k1)
    assert set(TRAIN_METRICS) <= set(line["metrics"])

    trace.clear()
    line = harness.run_cell(root, "tiny2d_sample", 4_000_000_321, 0.5, True, device="cuda")
    got = trace.spans()
    assert got and all(s.device_ms is not None for s in got)
    assert set(SAMPLE_METRICS) <= set(line["metrics"])
