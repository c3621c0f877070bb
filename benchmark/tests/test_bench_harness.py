"""The harness without the card: the files BENCHMARK.json names, the import
guard, a run with no card, the result line's keys, new cells and metrics
found from files alone, and faults planted under the timed path that turn
``correct`` false."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import guard, harness
from benchmark.tests.tiny import REPO, run_tiny, tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


def test_benchmark_json_names_existing_files():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = harness.Bench(REPO)
    bdir = REPO / "benchmark"
    assert spec["paths"] == ["benchmark"] and spec["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= spec["run_seconds"] <= 51
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for c in spec["configs"]:
        assert NAME.match(c["name"]) and (REPO / c["file"]).exists()
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = bench.config(c["name"])
        assert (bdir / "reference" / f"{cfg['reference']}.py").exists()
        assert cfg["reduced"] == c["reduced"]
    for w in spec["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
        cell = bench.cell(w["name"])
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        assert cell["chips"] == w["chips"] == 1
        assert (bdir / "entries" / f"{cell['entry']}.py").exists()
        e2e = [m["name"] for m in bench.end_to_end(w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = bench.per_layer(w["name"])
        assert layer and all(m["moves"] in e2e for m in layer)
        for m in layer:
            assert bench.reader(m["name"]) is not None
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                    "higher")
    for m in spec["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= {w["name"] for w in spec["workloads"]}
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_every_data_file_parses():
    for sub in ("workloads", "configs"):
        for path in (REPO / "benchmark" / sub).glob("*.json"):
            data = json.loads(path.read_text())
            if sub == "workloads":
                assert {"config", "traffic", "entry", "chips", "why", "limits"} <= set(data)
                assert (REPO / "benchmark" / "configs" / f"{data['config']}.json").exists()


def test_guard_compares_whole_top_level_names():
    names = ["fmdm_tpu_torch", "fmdm_tpu_torch.ops", "jaxtyping", "jax", "jax.numpy",
             "fmdm_tpu", "fmdm_tpu.ops.conv", "flaxen", "jaxlib.xla_client"]
    assert guard.forbidden_modules(names) == ["fmdm_tpu", "fmdm_tpu.ops.conv", "jax",
                                              "jax.numpy", "jaxlib.xla_client"]


def test_a_run_loads_no_jax(root):
    """A whole tiny run in a fresh process, then the guard over its modules."""
    code = ("import sys, json; sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[2])\n"
            "from benchmark import harness, guard\n"
            "line = harness.run_cell(sys.argv[2], 'tiny2d_sample', 5, 0.2, False, device='cpu')\n"
            "print(json.dumps([line['correct'], guard.forbidden_modules()]))\n")
    out = subprocess.run([sys.executable, "-c", code, str(REPO), str(root)], capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, []]


def test_a_run_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, str(REPO / "benchmark" / "run.py"), "--workload",
                          "unet2d_flow_train_b16", "--seed", "1", "--seconds", "1", "--trace",
                          "0"], capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr


def test_a_run_without_the_program_fails(tmp_path):
    """A directory with only BENCHMARK.json and benchmark/ gives no result."""
    import shutil

    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import sys; sys.path.insert(0, sys.argv[1])\n"
            "from benchmark import harness\n"
            "harness.run_cell(sys.argv[1], 'unet2d_flow_sample_b32', 1, 0.1, False, device='cpu')\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and "fmdm_tpu_torch" in out.stderr


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_holds_the_contract_keys(root, trace):
    line = run_tiny(root, "tiny3d_train", trace=trace)
    keys = CONTRACT_KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == keys
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"train_samples_per_s", "train_step_ms_p90", "setup_s"}
        assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["checks"]) == {"grad_gap", "change_gap"}
    json.dumps(line)


NEW_ENTRY = '''"""A kind the harness does not know: the denoiser alone, called twice
per unit at one t, in f32; judged against the reference's forward."""

import time

import torch

from benchmark import build, compare, inputs
from benchmark.entries import BaseEntry, Window


class Entry(BaseEntry):
    kind = "forward_pair"
    forwards_per_unit = 2

    def setup(self):
        self.weights = build.weights(self.cfg, self.seed, self.device)
        self.model = build.program_model(self.cfg, self.weights, self.device)
        shape = (int(self.cell["batch"]), self.cfg["in_channels"], *self.cfg["spatial"])
        self.x = torch.randn(shape, generator=inputs.generator(self.seed, 1, self.device))
        self.t = torch.full((shape[0],), 0.5)
        self.setup_seconds = {}

    def window(self, seconds=None, units=None):
        start, n = time.perf_counter(), 0
        with torch.no_grad():
            while not (n >= units if units else n and time.perf_counter() - start >= seconds):
                self.out = [self.model(self.x, self.t) for _ in range(2)][-1]
                n += 1
        elapsed = time.perf_counter() - start
        return Window(units=n, seconds=elapsed, failed=0,
                      end_to_end={"forwards_per_s": 2 * n / elapsed})

    def failed(self, window):
        return int(not torch.isfinite(self.out).all())

    def release(self):
        del self.model

    def numbers(self):
        ref = build.reference_model(self.cfg, self.weights, self.device)
        with torch.no_grad():
            return compare.sample_numbers(self.out, ref(self.x, self.t))
'''


def test_new_cell_config_and_metric_are_found_from_files_alone(tmp_path):
    """A later change adds a configuration, a cell, an entry kind the harness
    does not know and a per-layer metric as new files plus BENCHMARK.json
    entries, and edits no file."""
    root = tiny_root(tmp_path)
    bdir = root / "benchmark"
    before = {p: p.read_bytes() for p in bdir.rglob("*") if p.is_file()}
    cfg = json.loads((bdir / "configs" / "tiny2d.json").read_text())
    cfg["model"]["unet"]["block_out_channels"] = [32, 64, 64]
    (bdir / "configs" / "tiny2d_wide.json").write_text(json.dumps(cfg))
    cell = json.loads((bdir / "workloads" / "tiny2d_sample.json").read_text())
    cell.update(config="tiny2d_wide", traffic="wide_sample", batch=2)
    (bdir / "workloads" / "tiny2d_wide_sample.json").write_text(json.dumps(cell))
    (bdir / "workloads" / "tiny2d_forward_pair.json").write_text(json.dumps(
        {"config": "tiny2d_wide", "traffic": "forward_pair", "entry": "forward_pair",
         "chips": 1, "batch": 2, "trace_units": 2, "why": "a new kind of entry",
         "limits": {"sample_err": 1e-4}}))
    (bdir / "entries" / "forward_pair.py").write_text(NEW_ENTRY)
    (bdir / "metrics" / "units_traced.py").write_text(
        '"""units_traced.sample: steps or calls in the traced window."""\n\n\n'
        "def read(r):\n    return float(r.units)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny2d_wide", "source": "https://arxiv.org/abs/2006.11239",
                            "file": "benchmark/configs/tiny2d_wide.json", "reduced": [],
                            "why": "a new configuration"})
    spec["workloads"] += [{"name": "tiny2d_wide_sample", "config": "tiny2d_wide",
                           "traffic": "wide_sample", "chips": 1, "why": "a new cell"},
                          {"name": "tiny2d_forward_pair", "config": "tiny2d_wide",
                           "traffic": "forward_pair", "chips": 1, "why": "a new entry kind"}]
    for m in spec["end_to_end"]:
        if m["name"] == "denoise_steps_per_s":
            m["workloads"].append("tiny2d_wide_sample")
    spec["end_to_end"].append({"name": "forwards_per_s", "unit": "forwards/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["tiny2d_forward_pair"]})
    spec["per_layer"] += [{"name": "units_traced.sample", "unit": "calls", "better": "higher",
                           "source": "program_counter", "layer": "entry",
                           "moves": "denoise_steps_per_s", "workloads": ["tiny2d_wide_sample"]},
                          {"name": "mfu.forward", "unit": "%", "better": "higher",
                           "source": "host_clock", "layer": "model step",
                           "moves": "forwards_per_s", "workloads": ["tiny2d_forward_pair"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    assert all(p.read_bytes() == data for p, data in before.items())
    line = run_tiny(root, "tiny2d_wide_sample", trace=True)
    assert line["correct"] and line["metrics"] == {"units_traced.sample": {"value": 2.0,
                                                                           "unit": "calls"}}
    line = run_tiny(root, "tiny2d_wide_sample")
    assert set(line["metrics"]) == {"denoise_steps_per_s", "setup_s"}
    line = run_tiny(root, "tiny2d_forward_pair", trace=True)
    assert line["correct"] and set(line["metrics"]) == {"mfu.forward"}
    assert line["attempted"] >= 3 and 0 < line["metrics"]["mfu.forward"]["value"] < 100
    line = run_tiny(root, "tiny2d_forward_pair")
    assert line["correct"] and set(line["metrics"]) == {"forwards_per_s", "setup_s"}


# Faults under the timed path, each of the kinds a cell can have (the
# exchange between chips does not exist on one chip): the run still prints
# its line, and ``correct`` is false.

def _unchanged_state(monkeypatch, kind):
    if kind == "train":
        monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    else:
        from fmdm_tpu_torch.schedulers.flow_match import FlowMatchEulerDiscreteScheduler

        monkeypatch.setattr(FlowMatchEulerDiscreteScheduler, "step",
                            lambda self, state, out, i, sample, ts, generator=None: (state,
                                                                                     sample))


def _half_batch(monkeypatch, kind):
    if kind == "train":
        from fmdm_tpu_torch.train.common import DenoiseTrainStep

        step = DenoiseTrainStep.step

        def half(self, batch, *, noise=None, t=None, generator=None):
            h = batch["target"].shape[0] // 2
            return step(self, {k: v[:h] for k, v in batch.items()}, noise=noise[:h], t=t[:h])

        monkeypatch.setattr(DenoiseTrainStep, "step", half)
    else:
        from fmdm_tpu_torch.sample.engine import SamplingEngine

        call = SamplingEngine.__call__

        def half(self, shape, generator=None, conditioning_batch=None, init_sample=None, **kw):
            h = shape[0] // 2
            out = call(self, (h,) + tuple(shape[1:]), generator,
                       conditioning_batch=conditioning_batch[:h], init_sample=init_sample[:h])
            return torch.cat([out, out.mean(dim=0, keepdim=True).expand_as(out)])[: shape[0]]

        monkeypatch.setattr(SamplingEngine, "__call__", half)


def _altered_answer(monkeypatch, kind):
    if kind == "train":
        from fmdm_tpu_torch.train.common import DenoiseTrainStep

        accumulate = DenoiseTrainStep._accumulate

        def altered(self, *args):
            out = accumulate(self, *args)
            next(self.model.parameters()).grad.mul_(1.5)   # one gradient, as produced
            return out

        monkeypatch.setattr(DenoiseTrainStep, "_accumulate", altered)
    else:
        from fmdm_tpu_torch.sample.engine import SamplingEngine

        call = SamplingEngine.__call__
        monkeypatch.setattr(SamplingEngine, "__call__",
                            lambda self, *a, **kw: call(self, *a, **kw) * 1.05)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch, _altered_answer])
@pytest.mark.parametrize("cell", ["tiny2d_train", "tiny2d_sample"])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, fault, cell):
    assert run_tiny(root, cell)["correct"] is True
    fault(monkeypatch, cell.split("_")[1])
    line = run_tiny(root, cell)
    assert line["correct"] is False, line["checks"]


@pytest.mark.card
def test_a_short_run_on_the_card_is_correct():
    out = subprocess.run([sys.executable, str(REPO / "benchmark" / "run.py"), "--workload",
                          "volume3d_sample_b8", "--seed", "7", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=1200, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
