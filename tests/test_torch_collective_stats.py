"""Collective accounting of the port (``parallel/collective_stats.py``, the
counterpart of ``fmdm_tpu/parallel/hlo_stats.py``) and each parallel
strategy's collective signature, the counterpart of
``tests/test_collective_signature.py``.

In process: the parser on a synthetic trace of every kind (its
``run_self_tests``), on a trace with no collective, and the per-rank link
bytes model. One cluster of two gloo ranks (``tests/torch_parallel_worker.py``,
mode ``collectives``), spawned once, runs one denoise step of the reduced
flagship UNet (its 4 attention calls at 64 tokens) under each strategy
inside ``torch.profiler`` and parses what it issued:

- data parallelism: the gradient all-reduce (one flat buffer) and the
  count's and loss's scalars, nothing else;
- FSDP: the weights' all-gathers (each unit's, forward and again backward)
  and the gradients' reduce-scatters, no send;
- tensor parallelism: the activations' all-gathers and the input
  gradients' all-reduces, no send;
- sequence parallelism: 2(n-1) to 2n hops per ring (n = 2), each a send and
  a receive per tensor, an all-to-all each way at every ring's boundary, and
  the gradient all-reduce."""

import pytest
import torch

from fmdm_tpu_torch.models.factories import DiffusionUNetFactory
from fmdm_tpu_torch.nn.layers import init_weights
from fmdm_tpu_torch.parallel import collective_stats as cs
from tests import torch_parallel_worker as worker

N = 2   # ranks, and the ring's positions


@pytest.fixture(scope="module")
def signatures(tmp_path_factory):
    """Each strategy's parsed collectives, from rank 0."""
    model = DiffusionUNetFactory().build(dict(worker.UNET), "concatenate", 1, device="cpu")
    init_weights(model, torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    inputs = {"denoise": {
        "weights": model.state_dict(), "target": torch.randn(4, 1, 16, 16, generator=gen),
        "image": torch.randn(4, 1, 16, 16, generator=gen), "valid": torch.ones(4),
        "noise": torch.randn(4, 1, 16, 16, generator=gen),
        "t": torch.randint(0, worker.N_TRAIN, (4,), generator=gen)}}
    result, _ = worker.run_cluster("collectives", N, tmp_path_factory.mktemp("coll"), inputs, None)
    return result["collectives"]


def _kinds(sig) -> dict:
    return cs.collective_summary(sig["collectives"])


def test_self_tests():
    cs.run_self_tests()


def test_a_trace_without_collectives(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    for as_file in (False, True):
        with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
            torch.ones(4).sum()
        trace = prof
        if as_file:   # a trace is exported once: as a file here
            trace = tmp_path / "trace.json"
            prof.export_chrome_trace(str(trace))
        assert cs.parse_collectives(trace) == []


@pytest.mark.parametrize("kind,payload,group,sent", [
    ("all-reduce", 1000, 4, 1500), ("all-gather", 1000, 4, 750),
    ("reduce-scatter", 1000, 4, 3000), ("all-to-all", 1000, 2, 500),
    ("send", 1000, None, 1000), ("recv", 1000, None, 0), ("all-reduce", 1000, 1, 0)])
def test_link_bytes_model(kind, payload, group, sent):
    assert cs.link_bytes_per_rank([{"kind": kind, "bytes": payload, "group_size": group}]) == sent


def test_dp_is_the_gradient_all_reduce_only(signatures):
    sig = signatures["dp"]
    summary = _kinds(sig)
    assert set(summary) == {"all-reduce"}, summary
    # the gradients as one f32 buffer, the count and the loss as scalars
    assert summary["all-reduce"]["count"] == 3
    assert sig["param_bytes"] <= summary["all-reduce"]["bytes"] <= sig["param_bytes"] + 64


def test_fsdp_gathers_weights_and_reduce_scatters_gradients(signatures):
    sig = signatures["fsdp"]
    summary = _kinds(sig)
    assert {"all-gather", "reduce-scatter"} <= set(summary), summary
    assert "send" not in summary and "all-to-all" not in summary
    gathered = summary["all-gather"]["bytes"]
    # every weight gathered for the forward, and again for the backward
    assert gathered >= 2 * sig["param_bytes"] * N * 0.9, (gathered, sig["param_bytes"])
    assert summary["all-gather"]["count"] >= 20   # per unit, not one blob
    assert summary["reduce-scatter"]["count"] >= 10
    assert all(c["group_size"] == N for c in sig["collectives"]
               if c["kind"] in ("all-gather", "reduce-scatter"))


def test_tp_gathers_activations_and_reduces_input_gradients(signatures):
    sig = signatures["tp"]
    summary = _kinds(sig)
    assert {"all-gather", "all-reduce"} <= set(summary), summary
    assert "send" not in summary and "reduce-scatter" not in summary
    # beyond DP's three: the column-parallel products' input gradients
    assert summary["all-reduce"]["count"] > 3 * 5
    assert summary["all-gather"]["count"] > 20


def test_sp_ring_hops(signatures):
    sig = signatures["sp"]
    summary = _kinds(sig)
    assert sig["rings"] == 4   # the UNet's attention calls at 64 tokens
    hops = sig["hops"] / sig["rings"]
    assert 2 * (N - 1) <= hops <= 2 * N, hops
    assert summary["send"]["count"] == summary["recv"]["count"] >= sig["hops"]
    # q, k, v in and out back, forward and backward
    assert summary["all-to-all"]["count"] == 8 * sig["rings"]
    assert "all-reduce" in summary and "all-gather" not in summary


def test_link_bytes_order_the_strategies(signatures):
    sent = {k: cs.link_bytes_per_rank(v["collectives"]) for k, v in signatures.items()}
    assert sent["dp"] > 0
    assert sent["dp"] < sent["fsdp"], sent
