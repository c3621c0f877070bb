"""The port's run_model against the JAX package's: ``evaluate``, ``decode``
(from ``start_step``), ``encode`` and ``debug_compare`` on one tiny run dir
per model type (a JAX checkpoint, which loads in both packages) over one
synthetic LDCT data root give the same outputs, with JAX's draws replayed
into the port (``init_noise``/``step_noise`` of the port's
``decode_diffusion_batch``, ``noise`` of ``encode_diffusion_batch``); the
CLI runs as ``python -m fmdm_tpu_torch.run_model --device cpu``, raises
without a card otherwise, and refuses what is not ported.

The UNet is the flagship's config cut to two levels of 16 and 32 channels
at 16² (as ``tests/test_torch_run_dir.py``). Held: the same CSV headers,
rows, ``sample_index`` and ``img_id``; ``mse`` within 1e-5 relative,
``psnr`` within 1e-4 dB, ``ssim`` within 1e-5; saved tensors within that
file's ``DECODE_TOL`` relative to their largest value (PNGs within one
grey level); the same experiment-dir name and ``run_config.json``.
"""

import copy
import csv
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fmdm_tpu import run_model as jrm
from fmdm_tpu.nn.module import unflatten_params as jax_unflatten
from fmdm_tpu.sample import diffusion_like as jdl
from fmdm_tpu.sample import diffusion_utils as jdu
from fmdm_tpu.sample import engine as jengine
from fmdm_tpu.sample import handlers as jhandlers
from fmdm_tpu.utils import checkpoint as jckpt
from fmdm_tpu_torch import run_model as trm
from fmdm_tpu_torch.data import base as tbase
from fmdm_tpu_torch.data.io import load_image
from fmdm_tpu_torch.sample import diffusion_like as tdl
from fmdm_tpu_torch.sample import diffusion_utils as tdu
from fmdm_tpu_torch.sample import handlers as thandlers
from tests.test_torch_denoise_train import few_torch_threads  # noqa: F401
from tests.test_torch_models import random_flat_params
from tests.test_torch_run_dir import DECODE_TOL, SMALL_UNET

REPO = Path(__file__).resolve().parents[1]
CONFIGS = {"diffusion": REPO / "configs" / "LDCT" / "LDCT_ddpm_diffusers_nd.json",
           "flow_matching": REPO / "configs" / "LDCT" / "LDCT_flow_matching_diffusers_nd.json"}
CKPT_NAMES = {"diffusion": "diff_last.pt", "flow_matching": "flow_last.pt"}
SIDE = 16
MSE_RTOL, PSNR_ATOL, SSIM_ATOL = 1e-5, 1e-4, 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A data root of two cases (3 slices each, case ids ``001``/``002``)
    and a run dir per model type pointing at it."""
    tmp = tmp_path_factory.mktemp("run_model")
    root = tmp / "data"
    (root / "vol").mkdir(parents=True)
    rng = np.random.default_rng(0)
    lines = []
    for case in ("001", "002"):
        for kind, scale in (("sdct", 1.0), ("ldct", 1.3)):
            vol = rng.uniform(-1000, 1500, (3, SIDE, SIDE)).astype(np.float32) * scale
            np.save(root / "vol" / f"{kind}_{case}.npy", vol)
        lines.append(f"{case}\tvol/sdct_{case}.npy\tvol/ldct_{case}.npy")
    (root / "test.txt").write_text("\n".join(lines) + "\n")
    (root / "dataset.json").write_text(json.dumps({
        "dataset_class": "datasets.ldct:LDCTDataset",
        "preprocess_kwargs": {"MIN_B": -1024, "MAX_B": 3072, "slope": 1.0, "intersept": -1024}}))
    dirs = {}
    for seed, (model_type, path) in enumerate(CONFIGS.items()):
        cfg = json.loads(path.read_text())
        cfg["model"]["unet"] = dict(SMALL_UNET)
        cfg["training"].update(data_root=str(root), img_size=SIDE)
        run = tmp / model_type
        run.mkdir()
        (run / "train_config.json").write_text(json.dumps(cfg))
        jm = jdu.DiffusionUNetFactory().build(cfg["model"]["unet"], "concatenate", 1)
        params = jax_unflatten(random_flat_params(jm, 20 + seed))
        jckpt.save_checkpoint({"model": params, "epoch": 1}, run / CKPT_NAMES[model_type])
        dirs[model_type] = run
    return dirs


@pytest.fixture
def replay(monkeypatch):
    """Record JAX's draws of each decode and encode, and feed them to the
    port's next call of the same function, in order. A JAX decode splits its
    key into the reference noise's and the engine's; the engine's into the
    start noise's and one per step of its (aligned) schedule."""
    monkeypatch.setattr(jdu, "_DP_SAMPLING", False)
    draws = {"decode": [], "encode": []}
    last = {}
    real_call, real_decode, real_encode = (jengine.SamplingEngine.__call__,
                                           jdl.decode_diffusion_batch, jdl.encode_diffusion_batch)

    def engine_call(engine, params, shape, rng, *args, **kw):
        last.update(n=len(engine.timesteps), stochastic=bool(engine.scheduler.needs_noise),
                    shape=tuple(shape))
        return real_call(engine, params, shape, rng, *args, **kw)

    def normal(key):
        return torch.from_numpy(np.array(jax.random.normal(key, last["shape"], jnp.float32)))

    def jax_decode(*args, **kw):
        out = real_decode(*args, **kw)
        k_ref, k_sample = jax.random.split(kw["rng"])
        k_init, k_steps = jax.random.split(k_sample)
        from_ref = kw.get("init_from_reference") and kw.get("reference_batch") is not None
        steps = ([normal(k) for k in jax.random.split(k_steps, last["n"])]
                 if last["stochastic"] else None)
        draws["decode"].append((normal(k_ref if from_ref else k_init), steps))
        return out

    def jax_encode(scheduler, targets, timesteps, rng):
        draws["encode"].append(torch.from_numpy(np.array(
            jax.random.normal(rng, targets.shape, jnp.float32))))
        return real_encode(scheduler, targets, timesteps, rng)

    real_port_decode, real_port_encode = tdl.decode_diffusion_batch, tdl.encode_diffusion_batch

    def port_decode(*args, **kw):
        init, steps = draws["decode"].pop(0)
        return real_port_decode(*args, init_noise=init, step_noise=steps, **kw)

    def port_encode(scheduler, targets, timesteps, generator):
        return real_port_encode(scheduler, targets, timesteps, noise=draws["encode"].pop(0))

    monkeypatch.setattr(jengine.SamplingEngine, "__call__", engine_call)
    monkeypatch.setattr(jdl, "decode_diffusion_batch", jax_decode)
    monkeypatch.setattr(jdl, "encode_diffusion_batch", jax_encode)
    monkeypatch.setattr(tdl, "decode_diffusion_batch", port_decode)
    monkeypatch.setattr(tdl, "encode_diffusion_batch", port_encode)
    yield draws
    assert not draws["decode"] and not draws["encode"], "a recorded draw was not replayed"


def _run_both(mode, model_type, run, tmp_path, **kw):
    """The JAX mode, then the port's on the CPU, each into its own output dir."""
    outs = {}
    for pkg, fn in (("jax", getattr(jdl, mode)), ("port", getattr(tdl, mode))):
        extra = {"device": "cpu"} if pkg == "port" else {}
        outs[pkg] = tmp_path / pkg
        fn(ckpt_dir=run, model_type=model_type, output_dir=str(outs[pkg]), **kw, **extra)
    return outs["jax"], outs["port"]


def _read_csv(path):
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    return rows[0], [dict(zip(rows[0], r)) for r in rows[1:]]


def _assert_metrics_close(got, want):
    assert float(got["mse"]) == pytest.approx(float(want["mse"]), rel=MSE_RTOL, abs=1e-12)
    assert float(got["psnr"]) == pytest.approx(float(want["psnr"]), abs=PSNR_ATOL)
    if want["ssim"]:
        assert float(got["ssim"]) == pytest.approx(float(want["ssim"]), abs=SSIM_ATOL)
    else:
        assert got["ssim"] == ""


def _assert_close(got, want, tol=DECODE_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))
    assert err <= tol, f"max|port-jax|/max|jax| = {err:.3e} > {tol:g}"


def _assert_same_files(jax_root: Path, port_root: Path):
    """The same saved files; tensors within the tolerance, PNGs within one
    grey level."""
    want = sorted(p.relative_to(jax_root) for p in jax_root.rglob("*") if p.is_file())
    got = sorted(p.relative_to(port_root) for p in port_root.rglob("*") if p.is_file())
    assert got == want and got
    for rel in want:
        a, b = port_root / rel, jax_root / rel
        if rel.suffix == ".png":
            diff = np.abs(load_image(a)["Image"].astype(int) - load_image(b)["Image"].astype(int))
            assert diff.max() <= 1, rel
        elif rel.suffix in (".npy", ".pt"):
            _assert_close(load_image(a)["Image"] if rel.suffix == ".npy" else torch.load(a).numpy(),
                          load_image(b)["Image"] if rel.suffix == ".npy" else torch.load(b).numpy())


@pytest.mark.parametrize("model_type,kw", [
    ("diffusion", dict(num_samples=5, batch_size=2, num_inference_steps=3, save=True,
                       save_input=True, save_conditioning=True)),
    ("flow_matching", dict(num_samples=4, batch_size=4, num_inference_steps=3)),
    ("diffusion", dict(batch_size=3, num_inference_steps=4, scheduler="ddim?eta=1.0",
                       last_n_steps=2)),
], ids=["ddpm", "flowmatch", "ddim-eta1-last2"])
def test_evaluate_matches_jax(runs, replay, tmp_path, model_type, kw):
    jax_out, port_out = _run_both("_run_evaluate", model_type, runs[model_type], tmp_path,
                                  seed=3, **kw)
    (jax_exp,), (port_exp,) = list(jax_out.iterdir()), list(port_out.iterdir())
    assert port_exp.name.split("_", 2)[2] == jax_exp.name.split("_", 2)[2]
    assert json.loads((port_exp / "run_config.json").read_text()) == \
        json.loads((jax_exp / "run_config.json").read_text())
    header, (got,) = _read_csv(port_exp / "eval_metrics.csv")
    want_header, (want,) = _read_csv(jax_exp / "eval_metrics.csv")
    assert header == want_header and got["samples"] == want["samples"]
    assert got["model_calls"] == want["model_calls"]
    _assert_metrics_close(got, want)
    header, got_rows = _read_csv(port_exp / "eval_metrics_per_image.csv")
    want_header, want_rows = _read_csv(jax_exp / "eval_metrics_per_image.csv")
    assert header == want_header and len(got_rows) == len(want_rows) == int(want["samples"])
    for g, w in zip(got_rows, want_rows):
        assert (g["sample_index"], g["img_id"], g["img_path"]) == \
            (w["sample_index"], w["img_id"], w["img_path"])
        _assert_metrics_close(g, w)
    if kw.get("save"):
        _assert_same_files(jax_exp / "samples", port_exp / "samples")
        assert {p.name for p in (port_exp / "samples").iterdir()} == \
            {"predicted", "input", "conditioning"}


@pytest.mark.parametrize("model_type,kw", [
    ("diffusion", dict(start_step=700, num_inference_steps=5, batch_size=4)),
    ("flow_matching", dict(last_n_steps=2, num_inference_steps=4, batch_size=3,
                           scheduler="dpmsolver++?algorithm_type=sde-dpmsolver++")),
], ids=["ddpm-start700", "flow-sde-dpmsolverpp-last2"])
def test_decode_matches_jax(runs, replay, tmp_path, model_type, kw):
    jax_out, port_out = _run_both("_run_decode", model_type, runs[model_type], tmp_path,
                                  seed=4, save=True, num_samples=4, **kw)
    _assert_same_files(jax_out, port_out)
    assert (port_out / "predicted").is_dir()


@pytest.mark.parametrize("model_type", ["diffusion", "flow_matching"])
def test_encode_matches_jax(runs, replay, tmp_path, model_type):
    jax_out, port_out = _run_both("_run_encode", model_type, runs[model_type], tmp_path,
                                  seed=5, save=True, timestep=600, batch_size=4)
    _assert_same_files(jax_out, port_out)


def test_encode_draws_its_timesteps_on_the_device(runs, tmp_path, monkeypatch):
    seen = []
    real = tdl.encode_diffusion_batch
    monkeypatch.setattr(tdl, "encode_diffusion_batch",
                        lambda s, x, t, g: seen.append(t) or real(s, x, t, g))
    tdl._run_encode(ckpt_dir=runs["diffusion"], model_type="diffusion", device="cpu",
                    output_dir=str(tmp_path), save=True, batch_size=4, seed=1)
    assert [len(t) for t in seen] == [4, 2]
    assert all(t.dtype == torch.int32 and 0 <= int(t.min()) and int(t.max()) < 1000 for t in seen)
    assert len(list(tmp_path.rglob("*.png"))) == 6


@pytest.mark.parametrize("model_type,kw", [
    ("diffusion", dict(num_inference_steps=3)),
    ("flow_matching", dict(num_inference_steps=3, start_step=500, num_samples=2)),
])
def test_debug_compare_matches_jax(runs, replay, tmp_path, model_type, kw):
    jax_out, port_out = _run_both("_run_debug_compare", model_type, runs[model_type], tmp_path,
                                  seed=6, **kw)
    got = json.loads((port_out / "stats.json").read_text())
    want = json.loads((jax_out / "stats.json").read_text())
    assert got.keys() == want.keys()
    assert got["timing"]["model_calls"] == want["timing"]["model_calls"] > 0
    for key, value in want.items():
        if isinstance(value, dict) and "present" in value:
            assert got[key]["present"] == value["present"] and \
                got[key].get("shape") == value.get("shape"), key
            for stat in ("min", "max", "mean", "std"):
                if stat in value:
                    assert got[key][stat] == pytest.approx(value[stat], rel=DECODE_TOL,
                                                           abs=DECODE_TOL), (key, stat)
        elif key != "timing":
            assert got[key] == value, key
    _assert_same_files(jax_out, port_out)


def test_cli_flags_modes_and_handlers_match_jax():
    assert trm.MODES == jrm.MODES and trm.HANDLER_REGISTRY.keys() == jrm.HANDLER_REGISTRY.keys()
    spec = {f: {k: v for k, v in kw.items() if k != "help"} for f, kw in trm._FLAG_SPEC}
    assert spec == {f: {k: v for k, v in kw.items() if k != "help"} for f, kw in jrm._FLAG_SPEC}
    for value in (None, "3", "3:2", "4:1:uniform", "auto", "auto:0.25"):
        assert trm._parse_deep_cache(value) == jrm._parse_deep_cache(value)
    for bad in ("3:1:sideways", "auto:-1"):
        with pytest.raises(ValueError):
            trm._parse_deep_cache(bad)
    public = {n for n in dir(jhandlers) if n[0].isupper() and n not in ("Any", "Dict", "Optional", "Path")}
    assert public <= set(dir(thandlers))
    with pytest.raises(ValueError, match="Unsupported"):
        trm._resolve_handler("gan")


def _cli(*args, cwd=REPO):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", "fmdm_tpu_torch.run_model", *map(str, args)],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_cli_runs_evaluate_and_build_tensor_cache_on_the_cpu(runs, tmp_path):
    run = runs["flow_matching"]
    out = _cli("--ckpt_dir", run, "--mode", "evaluate", "--device", "cpu", "--num_samples", 2,
               "--batch_size", 2, "--num_inference_steps", 2, "--output_dir", tmp_path / "eval")
    assert out.returncode == 0, out.stderr
    assert "Model throughput:" in out.stdout
    (exp,) = (tmp_path / "eval").iterdir()
    assert len(_read_csv(exp / "eval_metrics_per_image.csv")[1]) == 2
    cfg = json.loads((run / "train_config.json").read_text())
    cache_run = tmp_path / "cache_run"
    cache_run.mkdir()
    cfg["training"]["save_tensor_cache"] = True
    (cache_run / "train_config.json").write_text(json.dumps(cfg))
    out = _cli("--ckpt_dir", cache_run, "--mode", "build_tensor_cache", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    data_root = Path(cfg["training"]["data_root"])
    written = sorted((data_root / "cache_eval").rglob("*.pt"))
    assert len(written) == 12   # 6 samples x (SDCT, LDCT)


def test_build_tensor_cache_in_process_returns_after_the_writes(runs, tmp_path, monkeypatch):
    """The mode's files exist when ``main`` returns, though a background
    thread writes them (a caller in the same process reads them next)."""
    from fmdm_tpu_torch.data import dataset_utils

    real = dataset_utils.save_tensor_cache

    def slow_save(array, path):
        time.sleep(0.05)
        real(array, path)

    cfg = json.loads((runs["flow_matching"] / "train_config.json").read_text())
    root = tmp_path / "root"
    shutil.copytree(cfg["training"]["data_root"], root,
                    ignore=shutil.ignore_patterns("cache*"))
    cfg["training"].update(data_root=str(root), save_tensor_cache=True)
    cache_run = tmp_path / "cache_run"
    cache_run.mkdir()
    (cache_run / "train_config.json").write_text(json.dumps(cfg))
    monkeypatch.setattr(tbase, "save_tensor_cache", slow_save)
    trm.main(["--ckpt_dir", str(cache_run), "--mode", "build_tensor_cache", "--device", "cpu"])
    assert len(sorted((root / "cache_eval").rglob("*.pt"))) == 12


def test_cli_without_device_raises_without_a_card(runs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trm.main(["--ckpt_dir", str(runs["diffusion"]), "--mode", "evaluate"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdl._run_evaluate(ckpt_dir=runs["diffusion"], model_type="diffusion")


@pytest.mark.parametrize("flags,error,match", [
    # --latent_vae is ported: an unknown ?param raises as in JAX
    (["--latent_vae", "somewhere?bogus=1"], ValueError, "Unknown --latent_vae param 'bogus'"),
    # --deep_cache is ported: it raises where JAX's does, on a schedule it
    # does not know and on an auto budget in a mode without references
    (["--deep_cache", "3:1:sideways"], ValueError, "schedule"),
    (["--deep_cache", "auto", "--mode", "decode"], RuntimeError, "deep_cache auto"),
    # --quantize is ported: a mode outside JAX's choices is refused by argparse
    (["--quantize", "int4"], SystemExit, "2"),
], ids=["latent_vae", "deep_cache", "deep_cache_auto", "quantize"])
def test_unported_flags_raise(runs, flags, error, match):
    try:
        with pytest.raises(error, match=match):
            trm.main(["--ckpt_dir", str(runs["diffusion"]), "--mode", "evaluate", "--device",
                      "cpu", "--num_samples", "1", *flags])
    finally:
        tdu.set_deep_cache(None)
        tdu.set_quantize(None)


@pytest.mark.parametrize("mode", ["sample", "encode", "decode", "evaluate", "debug_compare"])
def test_vae_model_type_raises(runs, tmp_path, mode):
    """The vae model type's modes are ported: each runs on the CPU through
    the CLI's entry point on a KL-VAE run dir (``embed_dim`` 1, so decode
    takes the one-channel targets as latents) and writes its outputs."""
    from fmdm_tpu_torch.models.factories import VAEFactory
    from fmdm_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = json.loads((REPO / "configs" / "LDCT" / "LDCT_autoencoder_kl.json").read_text())
    cfg["model"].update(resolution=SIDE, base_ch=8, down_channels=[8, 16], num_res_blocks=1,
                        embed_dim=1, attn_heads=2, attn_dim_head=4)
    cfg["training"].update(
        data_root=json.loads((runs["diffusion"] / "train_config.json").read_text())[
            "training"]["data_root"], img_size=SIDE)
    run = tmp_path / "vae"
    run.mkdir()
    (run / "train_config.json").write_text(json.dumps(cfg))
    save_checkpoint({"model": VAEFactory().build(cfg["model"], device="cpu"), "epoch": 1},
                    run / "vae_last.pt")
    out = tmp_path / "out"
    save = ["--save"] if mode in ("sample", "encode", "decode") else []
    trm.main(["--ckpt_dir", str(run), "--mode", mode, "--device", "cpu", "--num_samples", "2",
              "--output_dir", str(out), *save])
    written = [p for p in out.rglob("*") if p.is_file()]
    assert written and (mode != "evaluate" or any(p.name == "eval_metrics.csv" for p in written))


def test_vae_build_tensor_cache_needs_no_model(runs, tmp_path):
    cfg = copy.deepcopy(json.loads((runs["diffusion"] / "train_config.json").read_text()))
    cfg["model"]["model_type"] = "vae"
    (tmp_path / "train_config.json").write_text(json.dumps(cfg))
    assert thandlers.VAEHandler(ckpt_dir=tmp_path, num_samples=3, seed=2).build_tensor_cache() == 3


def test_quantize_flag_decodes_through_the_int8_model(runs, tmp_path, capsys):
    """``--quantize int8`` in process: on the reduced run dir (16², 16 and 32
    channels) the policy keeps every conv float and the evaluate warns and
    matches the float one, as JAX's does; on a run dir of 64 channels at 32²
    the evaluate decodes through the quantized copy."""
    from fmdm_tpu_torch.ops.quant import is_quantized
    from fmdm_tpu_torch.utils.checkpoint import save_checkpoint

    def evaluate(run, out, *flags):
        trm.main(["--ckpt_dir", str(run), "--mode", "evaluate", "--device", "cpu",
                  "--num_samples", "2", "--batch_size", "2", "--num_inference_steps", "2",
                  "--output_dir", str(out), *flags])
        (exp,) = out.iterdir()
        return _read_csv(exp / "eval_metrics_per_image.csv")[1]

    try:
        want = evaluate(runs["diffusion"], tmp_path / "float")
        capsys.readouterr()
        got = evaluate(runs["diffusion"], tmp_path / "int8", "--quantize", "int8")
        assert "continuing with float weights" in capsys.readouterr().err   # the CLI's log
        assert [r["mse"] for r in got] == [r["mse"] for r in want]
        cfg = json.loads((runs["diffusion"] / "train_config.json").read_text())
        cfg["model"]["unet"] = dict(SMALL_UNET, sample_size=32, block_out_channels=[64, 64])
        # 32² samples from the 16² root (not its 16² tensor cache, which
        # another test of this file may have written)
        cfg["training"].update(img_size=32, use_tensor_cache=False)
        wide = tmp_path / "wide"
        wide.mkdir()
        (wide / "train_config.json").write_text(json.dumps(cfg))
        model = tdu.build_diffusion_model(cfg, generator=torch.Generator().manual_seed(5),
                                          device="cpu")
        save_checkpoint({"model": model, "epoch": 1}, wide / "diff_last.pt")
        tdu._QUANT_CACHE.clear()
        rows = evaluate(wide, tmp_path / "wide_int8", "--quantize", "int8")
        assert len(rows) == 2 and all(np.isfinite(float(r["mse"])) for r in rows)
        (source, qmodel), = tdu._QUANT_CACHE.values()
        assert is_quantized(qmodel) and not is_quantized(source)
    finally:
        tdu.set_quantize(None)
        tdu._QUANT_CACHE.clear()
