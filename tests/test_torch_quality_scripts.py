"""The port's quality workflow, ``fmdm_tpu_torch/scripts/``, against the JAX
package's ``scripts/`` (loaded from their paths): the phantoms and the split
files bitwise equal from the same seed; the configs' ``training`` and
``model`` blocks equal but for the output paths; the 95% CI and the table
read from fixed CSVs; ``int8_quality_eval`` marking a variant done only once
its metrics exist; the pipeline's stage sequences, resume command and
the commands of its post-training stages; a convergence-curve snapshot facade; the latent root naming the port's
dataset class; each tool runnable as a module; and one sweep end to end on
the CPU: the flagship topology cut to two levels at 16², 1 epoch, 2 test
slices, 2 steps, both variants, every CLI in a subprocess.
"""

import csv
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fmdm_tpu_torch.scripts import (
    convergence_curve,
    deepcache_quality_frontier,
    flagship_quality_sweep as sweep,
    int8_quality_eval,
    latent_diffusion_sweep,
    r4_pipeline,
)
from tests.test_torch_run_dir import SMALL_UNET

REPO = Path(__file__).resolve().parents[1]
TOOLS = ["flagship_quality_sweep", "r4_pipeline", "convergence_curve",
         "deepcache_quality_frontier", "int8_quality_eval", "latent_diffusion_sweep"]


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_scripts_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_SWEEP = _jax_script("flagship_quality_sweep")


@pytest.mark.parametrize("seed,size", [(0, 256), (3, 64), (11, 96)])
def test_make_phantom_is_the_jax_scripts(seed, size):
    got_rng, want_rng = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(3):
        got = sweep.make_phantom(got_rng, size)
        want = JAX_SWEEP.make_phantom(want_rng, size)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)
    assert np.array_equal(got_rng.randn(4), want_rng.randn(4))


def test_gen_dataset_is_bitwise_the_jax_scripts(tmp_path):
    kw = dict(n_train_cases=2, n_test_cases=1, depth=3, seed=0)
    sweep.gen_dataset(tmp_path / "port", **kw)
    JAX_SWEEP.gen_dataset(tmp_path / "jax", **kw)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert len(files) == 2 + 2 * 3
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*") if p.is_file())
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel
    vol = np.load(tmp_path / "port" / "data" / "train_c1_ldct.npy")
    assert vol.shape == (3, 256, 256) and vol.min() >= 0.0 and vol.max() <= 4095.0


@pytest.mark.parametrize("variant", ["diffusion", "flow_matching"])
def test_write_config_is_the_jax_scripts(tmp_path, variant):
    for side in ("port", "jax"):
        (tmp_path / side).mkdir()
    got_path = sweep.write_config(tmp_path / "port", 300, variant, ckpt_every=50)
    want_path = JAX_SWEEP.write_config(tmp_path / "jax", 300, variant, ckpt_every=50)
    got, want = json.loads(got_path.read_text()), json.loads(want_path.read_text())
    for cfg, root in ((got, tmp_path / "port"), (want, tmp_path / "jax")):
        assert cfg["training"].pop("data_root") == str(root)
        assert cfg["training"].pop("output_dir") == str(root / "run")
    assert got == want
    assert got["training"]["mixed_precision"] == "bf16"
    assert got["training"]["train_batch_size"] == 16
    assert got_path.name == want_path.name
    assert ((tmp_path / "port" / "configs" / "dataset.json").read_text()
            == (REPO / "configs" / "LDCT" / "dataset.json").read_text())


def _write_eval(out: Path, psnrs, row=None) -> Path:
    exp = out / "evaluate_flowmatch_seed11"
    exp.mkdir(parents=True)
    row = row or {"samples": str(len(psnrs)), "psnr": f"{np.mean(psnrs):.6f}", "ssim": "0.987",
                  "model_samples_per_second": "12.5"}
    with open(exp / "eval_metrics.csv", "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=list(row))
        writer.writeheader()
        writer.writerow(row)
    with open(exp / "eval_metrics_per_image.csv", "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=["index", "psnr", "ssim"])
        writer.writeheader()
        for i, p in enumerate(psnrs):
            writer.writerow({"index": i, "psnr": p, "ssim": 0.9})
    return exp / "eval_metrics.csv"


def test_ci_and_table_from_fixed_csvs(tmp_path):
    psnrs = [48.0, 50.0, 51.0, 49.5, 52.5]
    metrics = _write_eval(tmp_path / "flow", psnrs)
    assert sweep.newest_metrics(tmp_path / "flow") == metrics
    row = sweep.read_metrics(metrics)
    ci = 1.96 * np.std(psnrs, ddof=1) / math.sqrt(len(psnrs))
    assert row["psnr_ci95"] == f"{ci:.3f}" == "1.473"
    assert row["psnr_mean_check"] == "50.200"
    ddpm = sweep.read_metrics(_write_eval(tmp_path / "ddpm", [30.0], {"psnr": "30.5",
                                                                      "ssim": "0.5"}))
    assert "psnr_ci95" not in ddpm  # one image: no dispersion
    assert sweep.format_table({"ddpm": ddpm, "flowmatch": row}).splitlines() == [
        "| sampler | PSNR (±95% CI) | SSIM | samples/s (model time) |",
        "|---|---|---|---|",
        "| flowmatch | 50.20 ± 1.47 | 0.987 | 12.5 |",
        "| ddpm | 30.50 | 0.500 | 0.0 |"]
    frontier = deepcache_quality_frontier.format_frontier(
        {"exact": row, "2_1_adaptive": dict(row, model_samples_per_second="25.0")})
    assert frontier.splitlines()[-1] == "| 2_1_adaptive | 50.20 ± 1.47 | 0.987 | 25.00 | 2.00x |"
    assert sweep.newest_metrics(tmp_path / "none") is None


def test_int8_eval_marks_done_only_once_metrics_exist(tmp_path, monkeypatch):
    calls = []

    def fake_sh(cmd, log=None):
        calls.append(cmd)
        out = Path(cmd[cmd.index("--output_dir") + 1])
        if len(calls) > 1:  # the first run exits 0 without metrics
            _write_eval(out, [40.0, 41.0])

    monkeypatch.setattr(int8_quality_eval, "sh", fake_sh)
    variants = [("flowmatch", "int8", "2:1:adaptive")]
    run_dir = tmp_path / "run_flow_run1"
    first = int8_quality_eval.evaluate(run_dir, variants, root=tmp_path, device="cpu")
    tag = "flowmatch_int8_dc2-1-adaptive"
    assert first == {} and not (tmp_path / "eval" / tag / "DONE").exists()
    cmd = calls[0]
    assert cmd[1:3] == ["-m", "fmdm_tpu_torch.run_model"]
    assert cmd[cmd.index("--quantize") + 1] == "int8"
    assert cmd[cmd.index("--deep_cache") + 1] == "2:1:adaptive"
    assert cmd[-2:] == ["--device", "cpu"]
    assert [cmd[cmd.index(f) + 1] for f in ("--num_samples", "--num_inference_steps", "--seed",
                                            "--batch_size")] == ["144", "50", "11", "16"]
    second = int8_quality_eval.evaluate(run_dir, variants, root=tmp_path, device="cpu")
    assert len(calls) == 2 and (tmp_path / "eval" / tag / "DONE").read_text() == "ok"
    assert second[tag]["psnr_ci95"] == "0.980"
    third = int8_quality_eval.evaluate(run_dir, variants, root=tmp_path, device="cpu")
    assert len(calls) == 2 and third == second
    assert [int8_quality_eval.variant_tag(*v) for v in
            int8_quality_eval.VARIANTS + int8_quality_eval.VARIANTS_COMPOSED] == [
        "flowmatch_bf16", "flowmatch_int8", "dpmsolverpp_bf16", "dpmsolverpp_int8",
        "flowmatch_bf16_dc2-1-adaptive", "flowmatch_int8_dc2-1-adaptive"]


def test_pipeline_stages_and_resume(tmp_path, monkeypatch):
    assert r4_pipeline.parse_stages(None) == [1, 2, 3, 4, 5, 6, 7]
    assert r4_pipeline.parse_stages("post") == [3, 4, 5, 6]
    assert r4_pipeline.parse_stages("3,1") == [3, 1]
    with pytest.raises(SystemExit):
        r4_pipeline.parse_stages("1,8")
    calls = []
    monkeypatch.setattr(r4_pipeline, "sh", lambda cmd, log=None: calls.append(list(cmd)))
    r4_pipeline.train_variant("flow_matching", 300, "flow", root=tmp_path, device="cpu")
    assert calls[-1][1:3] == ["-m", "fmdm_tpu_torch.train"] and "--resume" not in calls[-1]
    cfg = json.loads((tmp_path / "configs" / "flagship_sweep_flow_matching.json").read_text())
    assert cfg["training"]["save_model_epochs"] == 50
    assert cfg["training"]["output_dir"] == str(tmp_path / "run_flow_matching")
    run = tmp_path / "run_flow_matching_run1"
    run.mkdir()
    from fmdm_tpu_torch.utils.checkpoint import save_checkpoint

    save_checkpoint({"epoch": 150}, run / "flow_last.pt")
    assert r4_pipeline.trained_epochs(run, "flow") == 150
    r4_pipeline.train_variant("flow_matching", 300, "flow", root=tmp_path, device="cpu")
    assert calls[-1][-4:] == ["--device", "cpu", "--resume", str(run / "flow_last.pt")]
    cfg = json.loads((tmp_path / "configs" / "flagship_sweep_flow_matching.json").read_text())
    assert cfg["training"]["output_dir"] == str(run)
    save_checkpoint({"epoch": 300}, run / "flow_last.pt")
    n = len(calls)
    assert r4_pipeline.train_variant("flow_matching", 300, "flow", root=tmp_path) == run
    assert len(calls) == n


def test_pipeline_post_training_commands(tmp_path, monkeypatch):
    """``--stage 3,4,5`` in that order: the flow flagship resumed to 300
    epochs, then the sweep and the curve on the trained runs, each CLI
    given the device."""
    monkeypatch.setattr(r4_pipeline, "ROOT", tmp_path)
    monkeypatch.setattr(r4_pipeline, "_tail", lambda path, n=2500: None)
    calls = []
    monkeypatch.setattr(r4_pipeline, "sh", lambda cmd, log=None: calls.append(
        ([str(c) for c in cmd], log)))
    from fmdm_tpu_torch.utils.checkpoint import save_checkpoint

    for variant, prefix in (("flow_matching", "flow"), ("diffusion", "diff")):
        run = tmp_path / f"run_{variant}_run1"
        run.mkdir()
        save_checkpoint({"epoch": 100}, run / f"{prefix}_last.pt")
    r4_pipeline.main(["--stage", "3,4,5", "--device", "cpu"])
    (train, train_log), (sweep_cmd, sweep_log), (curve, curve_log) = calls
    assert train[1:3] == ["-m", "fmdm_tpu_torch.train"] and train_log.name == "train_flow_matching.log"
    assert train[-4:] == ["--device", "cpu", "--resume",
                          str(tmp_path / "run_flow_matching_run1" / "flow_last.pt")]
    assert sweep_cmd[2] == "fmdm_tpu_torch.scripts.flagship_quality_sweep"
    assert sweep_cmd[sweep_cmd.index("--root") + 1] == str(tmp_path)
    assert {"--skip-data", "--skip-train"} <= set(sweep_cmd)
    assert sweep_cmd[sweep_cmd.index("--num-samples") + 1] == "144"
    assert sweep_cmd[sweep_cmd.index("--aliases") + 1] == r4_pipeline.SWEEP_ALIASES
    assert curve[2] == "fmdm_tpu_torch.scripts.convergence_curve"
    assert curve[curve.index("--run") + 1] == str(tmp_path / "run_diffusion_run1")
    assert curve[curve.index("--num-samples") + 1] == "64"
    assert all(c[-2:] == ["--device", "cpu"] for c in (sweep_cmd, curve))
    assert (sweep_log.name, curve_log.name) == ("evals.log", "curve.log")


def test_curve_stages_a_snapshot_as_a_run_dir(tmp_path):
    run = tmp_path / "run_flow_matching_run1"
    (run / "epochs" / "epoch0050").mkdir(parents=True)
    (run / "train_config.json").write_text('{"training": {}}')
    (run / "flow_last.pt").write_bytes(b"last")
    (run / "epochs" / "epoch0050" / "epoch.pt").write_bytes(b"epoch 50")
    stage = convergence_curve.stage_epoch_dir(run, run / "epochs" / "epoch0050", tmp_path / "s")
    assert stage == tmp_path / "s" / "epoch0050"
    assert (stage / "flow_last.pt").read_bytes() == b"epoch 50"
    assert (stage / "train_config.json").read_text() == '{"training": {}}'
    assert convergence_curve.stage_epoch_dir(run, run / "epochs" / "epoch0050",
                                             tmp_path / "s") == stage


def test_latent_root_names_the_ports_dataset(tmp_path):
    from fmdm_tpu_torch.data.dataset_utils import _import_symbol
    from fmdm_tpu_torch.data.latent import LatentDataset

    jax_latent = _jax_script("latent_diffusion_sweep")
    got = json.loads(latent_diffusion_sweep.write_diff_config(
        tmp_path / "p", tmp_path / "p" / "latents", 300).read_text())
    want = json.loads(jax_latent.write_diff_config(
        tmp_path / "j", tmp_path / "j" / "latents", 300).read_text())
    for cfg, root in ((got, tmp_path / "p"), (want, tmp_path / "j")):
        assert cfg["training"].pop("data_root") == str(root / "latents")
        assert cfg["training"].pop("output_dir") == str(root / "diff_run")
    assert got == want
    spec = json.loads((tmp_path / "p" / "latents" / "dataset.json").read_text())
    assert spec == {"dataset_class": "fmdm_tpu_torch.data.latent:LatentDataset"}
    assert _import_symbol(spec["dataset_class"]) is LatentDataset
    got = json.loads(latent_diffusion_sweep.write_vae_config(
        tmp_path / "p", tmp_path / "px", 30).read_text())
    want = json.loads(jax_latent.write_vae_config(tmp_path / "j", tmp_path / "px", 30).read_text())
    assert got["training"].pop("output_dir") == str(tmp_path / "p" / "vae_run")
    want["training"].pop("output_dir")
    assert got == want


def test_tools_run_as_modules():
    code = ("import runpy, sys\n"
            f"for name in {TOOLS!r}:\n"
            "    sys.argv = [name, '--help']\n"
            "    try:\n"
            "        runpy.run_module('fmdm_tpu_torch.scripts.' + name, run_name='__main__')\n"
            "    except SystemExit as exc:\n"
            "        assert exc.code == 0, (name, exc.code)\n"
            "    print('ran', name)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("  --device DEVICE") == len(TOOLS)
    assert [line for line in out.stdout.splitlines() if line.startswith("ran ")] == [
        f"ran {name}" for name in TOOLS]


def test_sweep_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    configs = {}
    for variant, src in sweep.CONFIGS.items():
        cfg = json.loads(src.read_text())
        cfg["model"]["unet"] = dict(SMALL_UNET)
        cfg["training"].update(img_size=16, num_workers=0)
        configs[variant] = tmp_path / f"{variant}.json"
        configs[variant].write_text(json.dumps(cfg))
    monkeypatch.setattr(sweep, "CONFIGS", configs)
    root = tmp_path / "sweep"
    results = sweep.main(["--root", str(root), "--epochs", "1", "--train-cases", "1",
                          "--test-cases", "1", "--depth", "2", "--aliases", "flowmatch,ddpm",
                          "--num-samples", "2", "--steps", "2", "--jobs", "2",
                          "--device", "cpu"])
    assert sorted(results) == ["ddpm", "flowmatch"]
    for alias, row in results.items():
        assert row["samples"] == "2" and row["psnr_ci95"], alias
        assert math.isfinite(float(row["psnr"])) and math.isfinite(float(row["ssim"]))
    for variant, prefix in (("diffusion", "diff"), ("flow_matching", "flow")):
        (run,) = root.glob(f"run_{variant}_run*")
        assert (run / f"{prefix}_last.pt").exists()
        cfg = json.loads((run / "train_config.json").read_text())
        assert cfg["training"]["mixed_precision"] == "bf16"
        assert cfg["model"]["unet"]["block_out_channels"] == [16, 32]
    assert len((root / "test.txt").read_text().splitlines()) == 2
