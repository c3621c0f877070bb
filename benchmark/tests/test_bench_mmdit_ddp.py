"""The MMDiT's cell and the four-rank DDP cell on the CPU: the reference
MMDiT (``reference/mmdit.py``) against the repo's plain oracle
(``tests/oracles/mmdit_torch.py``) and against the program; both entries
(``entries/train_text.py``, ``entries/train_ddp.py`` over 4 gloo ranks)
through ``run_cell`` at tiny sizes, untraced and traced; faults planted
under their timed paths, each of which turns ``correct`` false; and the
five span readers the two cells add, on made-up spans.

``new_cells_root(tmp)`` is ``tiny.tiny_root`` with the configuration
``tinymmdit`` (SD3.5's MMDiT-X with a dual, a plain and the last,
text-dropping block at hidden 64 = 2 heads x 32, on 8x8 latents with 5
text tokens) and the cells ``tinymmdit_train`` (batch 4) and
``tiny2d_ddp`` (batch 4 on each of 4 gloo ranks)."""

import json
import sys

import pytest
import torch

from benchmark import build, compare, harness
from benchmark.entries import train_text
from benchmark.reference import mmdit
from benchmark.tests.test_bench_spans import made_up, read, reading
from benchmark.tests.tiny import REPO, TINY_LIMITS, run_tiny, tiny_root
from tests.oracles import mmdit_torch as oracle

torch.set_num_threads(2)
B = 2
# f32 on both sides, the sums in another order: the forward reads ~2e-7 of
# its largest value and the gradients ~1e-6; 2e-5 leaves 10x of room
TOL = 2e-5
TINY_MMDIT = ({"num_layers": 3, "num_attention_heads": 2, "attention_head_dim": 32,
               "caption_projection_dim": 64, "in_channels": 4, "out_channels": 4,
               "sample_size": 8, "pos_embed_max_size": 8, "joint_attention_dim": 24,
               "pooled_projection_dim": 16, "dual_attention_layers": [0]},
              {"channels": 4, "in_channels": 4, "spatial": [8, 8], "context_tokens": 5})
# the tiny MMDiT's readings on the CPU over 8 seeds: the program's bf16 at
# most 0.006 (grad_gap) and 0.012 (change_gap), the fp8 control at least
# 0.037 and 0.018, half a batch 0.40 and 0.068
TINY_MMDIT_LIMITS = {"grad_gap": 0.02, "change_gap": 0.05}
NEW_CELLS = {"tinymmdit_train": ("sd35m_mmdit_train_1024_b2", "tinymmdit", TINY_MMDIT_LIMITS),
             "tiny2d_ddp": ("unet2d_flow_train_ddp4", "tiny2d", TINY_LIMITS["train"])}


def tiny_mmdit_cfg(root=REPO) -> dict:
    cfg = json.loads((root / "benchmark" / "configs" / "sd35_medium_mmdit.json").read_text())
    cfg["model"]["unet"].update(TINY_MMDIT[0])
    cfg.update(TINY_MMDIT[1])
    return cfg


def new_cells_root(tmp):
    root = tiny_root(tmp)
    bdir = root / "benchmark"
    (bdir / "configs" / "tinymmdit.json").write_text(json.dumps(tiny_mmdit_cfg(root)))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for name, (base, cfg, limits) in NEW_CELLS.items():
        cell = json.loads((bdir / "workloads" / f"{base}.json").read_text())
        cell.update(config=cfg, batch=4, trace_units=2, limits=limits)
        if "collective_timeout_s" in cell:
            cell["collective_timeout_s"] = 60
        (bdir / "workloads" / f"{name}.json").write_text(json.dumps(cell))
        spec["workloads"].append({"name": name, "config": cfg, "traffic": cell["traffic"],
                                  "chips": cell["chips"], "why": "a tiny copy for the CPU tests"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if base in m.get("workloads", []):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return new_cells_root(tmp_path_factory.mktemp("bench"))


def tiny_inputs(cfg, seed=1):
    g = torch.Generator().manual_seed(seed)
    unet = cfg["model"]["unet"]
    return (torch.randn((B, cfg["in_channels"], *cfg["spatial"]), generator=g),
            torch.randn((B, cfg["context_tokens"], unet["joint_attention_dim"]), generator=g),
            torch.randn((B, unet["pooled_projection_dim"]), generator=g))


def gap(got, want):
    return float((got - want).detach().abs().max() / want.detach().abs().max().clamp(min=1e-30))


def test_reference_mmdit_matches_the_oracle():
    """The forward and the flow loss's gradients, from one dict of weights."""
    cfg = tiny_mmdit_cfg()
    weights = train_text.draw_weights(cfg, 5, "cpu")
    ref = build.reference_model(cfg, weights, "cpu")
    w = {k: v.clone().requires_grad_(True) for k, v in weights.items()
         if k != "pos_embed.pos_embed"}
    z, tokens, pooled = tiny_inputs(cfg)
    t = torch.tensor([0.25, 0.875])
    assert gap(ref(z, 1000 * t, tokens, pooled),
               oracle.forward(w, cfg["model"]["unet"], z, 1000 * t, tokens, pooled)) < TOL
    noise = torch.randn(z.shape, generator=torch.Generator().manual_seed(2))
    mmdit.flow_loss(ref, z, tokens, pooled, noise, t).backward()
    oracle.flow_loss(w, cfg["model"]["unet"], z, noise, t, tokens, pooled).backward()
    for name, p in ref.named_parameters():
        assert gap(p.grad, w[name].grad) < TOL, name


def test_reference_mmdit_matches_the_program():
    """One set of weights by name into both; the published widths' names,
    shapes and parameter count alike."""
    from fmdm_tpu_torch.models.factories import DiffusionUNetFactory

    cfg = tiny_mmdit_cfg()
    weights = train_text.draw_weights(cfg, 6, "cpu")
    prog = build.program_model(cfg, weights, "cpu")
    ref = build.reference_model(cfg, weights, "cpu")
    z, tokens, pooled = tiny_inputs(cfg, 3)
    t = torch.tensor([31.0, 999.0])
    with torch.no_grad():
        assert gap(prog(z, t, context_ca=(tokens, pooled)), ref(z, t, tokens, pooled)) < TOL
    full = json.loads((REPO / "benchmark" / "configs" / "sd35_medium_mmdit.json").read_text())
    prog = DiffusionUNetFactory().build(full["model"]["unet"], "text", 16, device="meta")
    assert build.weight_shapes(full) == {k: tuple(v.shape) for k, v in prog.state_dict().items()}
    assert sum(p.numel() for p in prog.parameters()) == full["parameters"] == 2_243_171_520


def test_the_tiny_configuration_is_the_published_one_cut():
    full = json.loads((REPO / "benchmark" / "configs" / "sd35_medium_mmdit.json").read_text())
    assert set(TINY_MMDIT[0]) <= set(full["model"]["unet"])
    assert set(TINY_MMDIT[1]) <= set(full)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", ["tinymmdit_train", "tiny2d_ddp"])
def test_the_new_entries_run_and_are_correct(root, cell, trace):
    line = run_tiny(root, cell, trace=trace)
    assert line["correct"] is True and line["failed"] == 0, line["checks"]
    assert set(line["checks"]) == {"grad_gap", "change_gap"}
    if cell == "tiny2d_ddp":
        assert line["device"]["count"] == 4
    if not trace:
        assert set(line["metrics"]) == {"train_samples_per_s", "train_step_ms_p90", "setup_s"}


def test_ddp_counts_the_global_batch(root, monkeypatch):
    """train_samples_per_s is the global rate: 4 ranks x batch over the
    interval between steps."""
    from benchmark.entries import train

    seen = {}
    window = train.Entry.window

    def spy(self, seconds=None, units=None):
        out = window(self, seconds=seconds, units=units)
        seen["per_rank"] = out.end_to_end["train_samples_per_s"]
        return out

    monkeypatch.setattr(train.Entry, "window", spy)
    line = run_tiny(root, "tiny2d_ddp")
    assert line["metrics"]["train_samples_per_s"]["value"] == pytest.approx(4 * seen["per_rank"])


# Faults under the timed path, in the harness's process (rank 0 of the DDP
# cell): each leaves the run printing its line, with ``correct`` false.

def _half_batch(monkeypatch):
    from fmdm_tpu_torch.train.common import DenoiseTrainStep

    step = DenoiseTrainStep.step

    def half(self, batch, *, noise=None, t=None, generator=None):
        h = batch["target"].shape[0] // 2
        cut = {k: tuple(x[:h] for x in v) if isinstance(v, tuple) else v[:h]
               for k, v in batch.items()}
        return step(self, cut, noise=noise[:h], t=t[:h])

    monkeypatch.setattr(DenoiseTrainStep, "step", half)


def _unchanged_weights(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)


def _scaled_gradient(monkeypatch):
    from fmdm_tpu_torch.train.common import DenoiseTrainStep

    accumulate = DenoiseTrainStep._accumulate

    def altered(self, *args):
        out = accumulate(self, *args)
        next(self.model.parameters()).grad.mul_(1.5)
        return out

    monkeypatch.setattr(DenoiseTrainStep, "_accumulate", altered)


def _rank_gradient_dropped(monkeypatch):
    """Rank 0's gradient never reaches the sum over the ranks."""
    from fmdm_tpu_torch.parallel import mesh as mesh_lib

    all_reduce = mesh_lib.all_reduce_grads

    def dropped(params, mesh):
        for p in params:
            if p.grad is not None:
                p.grad.zero_()
        return all_reduce(params, mesh)

    monkeypatch.setattr(mesh_lib, "all_reduce_grads", dropped)


@pytest.mark.parametrize("cell,fault", [
    ("tinymmdit_train", _half_batch), ("tinymmdit_train", _unchanged_weights),
    ("tinymmdit_train", _scaled_gradient), ("tiny2d_ddp", _half_batch),
    ("tiny2d_ddp", _unchanged_weights), ("tiny2d_ddp", _rank_gradient_dropped)])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, cell, fault):
    fault(monkeypatch)
    line = run_tiny(root, cell)
    assert line["correct"] is False, line["checks"]


def test_the_mmdit_control_fails_where_the_program_passes(root):
    """The fp8 reference in the program's place fails the tiny limits that
    the program's bf16 passes."""
    bench = harness.Bench(root)
    cell = bench.cell("tinymmdit_train")
    entry = bench.entry(cell["entry"])(bench.config(cell["config"]), cell, 4_000_000_321, "cpu")
    entry.setup()
    entry.release()
    ref = entry.reference_readings()
    prog = compare.train_numbers(entry.readings, ref)
    ctrl = compare.train_numbers(entry.reference_readings("fp8"), ref)
    assert all(c.ok for c in compare.checks(prog, cell["limits"])), prog
    assert not all(c.ok for c in compare.checks(ctrl, cell["limits"])), ctrl


# The five new span readers (``metrics/*_ms.py``), read as the others are
# in ``test_bench_spans.py``: device ms per step, summed by name.
NEW_METRICS = ["joint_attention_ms.train", "self_attention_ms.train", "adaln_ms.train",
               "flash_backward_ms.train", "allreduce_ms.train"]
CHILDREN = [("train.forward", 10.0, 50.0), ("train.backward", 30.0, 280.0),
            ("mmdit.joint_attention", 2.0, 40.0), ("mmdit.joint_attention", 2.0, 41.0),
            ("mmdit.self_attention", 1.0, 20.0), ("mmdit.adaln", 0.1, 1.5),
            ("mmdit.adaln", 0.1, 1.25), ("mmdit.adaln", 0.1, 0.25),
            ("flash.backward", 0.3, 60.0), ("flash.backward", 0.3, 62.0),
            ("train.allreduce", 0.5, 4.0)]


@pytest.mark.parametrize("metric,want", zip(NEW_METRICS, [81.0, 20.0, 3.0, 122.0, 4.0]))
def test_new_readers_per_step(monkeypatch, metric, want):
    spans = made_up([("train.step", 120.0, 340.0)] * 4, CHILDREN)
    assert read(metric, reading(True, 4), spans, monkeypatch) == pytest.approx(want)


@pytest.mark.parametrize("metric", NEW_METRICS)
def test_new_readers_read_none_where_they_cannot(monkeypatch, metric):
    """Roots not one per unit; no device time; no spans; a checkout before
    the spans (the parent has no ``train.allreduce``, ``flash.backward`` or
    ``mmdit.*``: nothing to read, nothing raised)."""
    r = reading(True, 4)
    assert read(metric, r, made_up([("train.step", 120.0, 340.0)] * 3, CHILDREN),
                monkeypatch) is None
    assert read(metric, r, made_up([("train.step", 120.0, None)] * 4,
                                   [(n, h, None) for n, h, _ in CHILDREN]), monkeypatch) is None
    assert read(metric, r, made_up([("train.step", 120.0, 340.0)] * 4, []), monkeypatch) is None
    monkeypatch.setitem(sys.modules, "fmdm_tpu_torch.utils.trace", None)
    assert harness.Bench(REPO).reader(metric).read(r) is None


def test_a_four_chip_cell_stays_within_the_benchmark_rule():
    """At most a quarter of the cells (or one) ask for 4 chips; every other
    cell takes one."""
    cells = json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]
    assert all(w["chips"] in (1, 4) for w in cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


@pytest.mark.parametrize("name", ["unet2d_flow_train_ddp4", "sd35m_mmdit_train_1024_b2"])
def test_a_new_cell_names_existing_files(name):
    """What ``test_bench_harness``'s check of every cell asks of the two
    cells: its entry, ``setup_s`` and another end-to-end metric, per-layer
    metrics that move one of them, each with a reader, and a configuration
    with its reference."""
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = harness.Bench(REPO)
    w = next(w for w in spec["workloads"] if w["name"] == name)
    cell = bench.cell(name)
    assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
    assert cell["chips"] == w["chips"] and len(w["why"]) <= 200
    assert (REPO / "benchmark" / "entries" / f"{cell['entry']}.py").exists()
    assert bench.entry(cell["entry"]) is not None
    cfg = bench.config(cell["config"])
    assert (REPO / "benchmark" / "reference" / f"{cfg['reference']}.py").exists()
    e2e = [m["name"] for m in bench.end_to_end(name)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = bench.per_layer(name)
    assert layer and all(m["moves"] in e2e for m in layer)
    for m in layer:
        assert bench.reader(m["name"]) is not None
    assert set(cell["limits"]) == {"grad_gap", "change_gap"}
