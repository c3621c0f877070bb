"""The port's VAE ``run_model`` modes and ``--latent_vae`` against the JAX
package's, on the CPU in f32.

A KL-VAE and a VQ-VAE run dir (the LDCT configs cut to two stages at 16²,
``embed_dim`` 1, so that ``decode`` can feed the dataset's one-channel
targets to the decoder as latents, as the JAX package does), each with a
JAX checkpoint of random weights (which loads in both packages), over the
synthetic LDCT root of ``tests/test_torch_run_model.py``. Held as that file
holds the diffusion modes: the same files, CSV headers, rows, indices and
ids; ``mse`` within 1e-5 relative, ``psnr`` within 1e-4 dB, ``ssim``
within 1e-5; saved tensors within ``DECODE_TOL`` of their largest value
(PNGs within one grey level); the same experiment-dir name and
``run_config.json``.

``evaluate --latent_vae <kl run>?scale=S`` runs that file's diffusion run
dir (its samples taken as latents) with JAX's draws replayed; an unknown
parameter raises in both packages; and the ``auto`` DeepCache probe scores
its candidates after the latent-to-pixel decode of both sides, choosing as
JAX chooses.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from fmdm_tpu.models.vae import VQVAE as JaxVQVAE
from fmdm_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from fmdm_tpu.nn.module import unflatten_params as jax_unflatten
from fmdm_tpu.sample import autoencoder_like as jae
from fmdm_tpu.sample import diffusion_like as jdl
from fmdm_tpu.sample import diffusion_utils as jdu
from fmdm_tpu.utils import checkpoint as jckpt
from fmdm_tpu_torch import run_model as trm
from fmdm_tpu_torch.sample import autoencoder_like as tae
from fmdm_tpu_torch.sample import diffusion_like as tdl
from fmdm_tpu_torch.sample import diffusion_utils as tdu
from tests.test_torch_deep_cache import (AUTO_STEPS, MODEL_CFG, TRAINING, _jax_init_noise,
                                         _targets, tiny)  # noqa: F401
from tests.test_torch_denoise_train import few_torch_threads  # noqa: F401
from tests.test_torch_models import random_flat_params
from tests.test_torch_run_model import (_assert_metrics_close, _assert_same_files, _read_csv,
                                        _run_both, replay, runs)  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SIDE = 16
SMALL = {"resolution": SIDE, "base_ch": 8, "down_channels": [8, 16], "num_res_blocks": 1,
         "z_channels": 4, "embed_dim": 1}
VAE_CONFIGS = {
    "kl": (REPO / "configs" / "LDCT" / "LDCT_autoencoder_kl.json",
           dict(SMALL, attn_heads=2, attn_dim_head=4)),
    "vq": (REPO / "configs" / "LDCT" / "LDCT_vqvae.json", dict(SMALL, codebook_size=16)),
}


def write_vae_run(run: Path, kind: str, data_root, seed: int) -> Path:
    """A VAE run dir of ``kind`` over ``data_root``: the config cut to
    ``SMALL`` and a JAX checkpoint of random weights."""
    path, cut = VAE_CONFIGS[kind]
    cfg = json.loads(path.read_text())
    cfg["model"].update(cut)
    cfg["training"].update(data_root=str(data_root), img_size=SIDE)
    run.mkdir(parents=True)
    (run / "train_config.json").write_text(json.dumps(cfg))
    kw = {k: v for k, v in cfg["model"].items() if k not in ("latent_type", "model_type")}
    jm = (JaxVQVAE if kind == "vq" else JaxAutoencoderKL)(**kw)
    flat = random_flat_params(jm, seed)
    if "codebook.ema_cluster_size" in flat:
        flat["codebook.ema_cluster_size"] = np.abs(flat["codebook.ema_cluster_size"])
    jckpt.save_checkpoint({"model": jax_unflatten(flat), "epoch": 1}, run / "vae_last.pt")
    return run


@pytest.fixture(scope="module")
def vae_runs(runs, tmp_path_factory):  # noqa: F811
    tmp = tmp_path_factory.mktemp("vae_runs")
    data_root = json.loads((runs["diffusion"] / "train_config.json").read_text())[
        "training"]["data_root"]
    return {kind: write_vae_run(tmp / kind, kind, data_root, 30 + i)
            for i, kind in enumerate(VAE_CONFIGS)}


def _run_modes(mode, run, tmp_path, **kw):
    """JAX's autoencoder mode, then the port's on the CPU, into output dirs
    of their own."""
    outs = {}
    for pkg, fn in (("jax", getattr(jae, mode)), ("port", getattr(tae, mode))):
        outs[pkg] = tmp_path / pkg
        fn(ckpt_dir=run, output_dir=str(outs[pkg]), **kw,
           **({"device": "cpu"} if pkg == "port" else {}))
    return outs["jax"], outs["port"]


def _assert_evaluate_dirs_match(jax_out: Path, port_out: Path):
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
    return jax_exp, port_exp


@pytest.mark.parametrize("kind", list(VAE_CONFIGS))
def test_evaluate_matches_jax(vae_runs, tmp_path, kind):
    jax_out, port_out = _run_modes("evaluate", vae_runs[kind], tmp_path, seed=3, num_samples=5,
                                   batch_size=2, save=True, save_input=True)
    jax_exp, port_exp = _assert_evaluate_dirs_match(jax_out, port_out)
    _assert_same_files(jax_exp / "samples", port_exp / "samples")


@pytest.mark.parametrize("kind", list(VAE_CONFIGS))
@pytest.mark.parametrize("mode,kw", [
    ("sample", dict(num_samples=4, batch_size=3, save_conditioning=True)),
    ("encode", dict(batch_size=4)),
    ("decode", dict(num_samples=3, batch_size=2, save_input=True)),
], ids=["sample", "encode", "decode"])
def test_saving_modes_match_jax(vae_runs, tmp_path, kind, mode, kw):
    jax_out, port_out = _run_modes(mode, vae_runs[kind], tmp_path, seed=4, save=True, **kw)
    if mode == "encode":   # into an experiment dir's samples, as evaluate saves
        (jax_exp,), (port_exp,) = list(jax_out.iterdir()), list(port_out.iterdir())
        assert port_exp.name.split("_", 2)[2] == jax_exp.name.split("_", 2)[2]
        jax_out, port_out = jax_exp / "samples", port_exp / "samples"
    _assert_same_files(jax_out, port_out)


@pytest.mark.parametrize("kind", list(VAE_CONFIGS))
def test_debug_compare_matches_jax(vae_runs, tmp_path, kind):
    jax_out, port_out = _run_modes("debug_compare", vae_runs[kind], tmp_path, seed=6,
                                   num_samples=2)
    got = json.loads((port_out / "stats.json").read_text())
    want = json.loads((jax_out / "stats.json").read_text())
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, float):
            assert got[key] == pytest.approx(value, rel=1e-5, abs=1e-6), key
        else:
            assert got[key] == value, key
    _assert_same_files(jax_out, port_out)


def test_vq_reconstruct_leaves_the_codebook_alone(vae_runs, tmp_path):
    from fmdm_tpu_torch.sample.vae_utils import build_vae_model, reconstruct_vae_batch
    from fmdm_tpu_torch.sample.sampling_utils import load_run_config

    model = build_vae_model(load_run_config(vae_runs["vq"]), device="cpu",
                            ckpt_path=vae_runs["vq"] / "vae_last.pt")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()   # even in train mode: reconstruct calls the forward with train=False
    with torch.no_grad():
        reconstruct_vae_batch(model, torch.rand(2, 1, SIDE, SIDE))
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


@pytest.mark.parametrize("scale", [None, 2.0], ids=["bare", "scale2"])
def test_evaluate_latent_vae_matches_jax(runs, vae_runs, replay, tmp_path, scale):  # noqa: F811
    """The diffusion run's samples and targets (one channel at 16²) taken
    as latents: both decoded through the KL-VAE (to 32²) before scoring."""
    latent_vae = str(vae_runs["kl"]) + ("" if scale is None else f"?scale={scale}")
    jax_out, port_out = _run_both("_run_evaluate", "diffusion", runs["diffusion"], tmp_path,
                                  seed=7, num_samples=3, batch_size=2, num_inference_steps=3,
                                  latent_vae=latent_vae, save=True)
    jax_exp, port_exp = _assert_evaluate_dirs_match(jax_out, port_out)
    _assert_same_files(jax_exp / "samples", port_exp / "samples")
    assert json.loads((port_exp / "run_config.json").read_text())["latent_vae"] == latent_vae


def test_decode_latent_vae_matches_jax(runs, vae_runs, replay, tmp_path):  # noqa: F811
    jax_out, port_out = _run_both("_run_decode", "diffusion", runs["diffusion"], tmp_path,
                                  seed=8, num_samples=2, batch_size=2, num_inference_steps=2,
                                  latent_vae=f"{vae_runs['vq']}?scale=0.5", save=True)
    _assert_same_files(jax_out, port_out)


def test_unknown_latent_vae_parameter_raises_in_both(runs, vae_runs, tmp_path,  # noqa: F811
                                                     monkeypatch):
    monkeypatch.setattr(jdu, "_DP_SAMPLING", False)
    bad = f"{vae_runs['kl']}?scale=2,shift=1"
    for pkg, fn in (("jax", jdl._run_decode), ("port", tdl._run_decode)):
        with pytest.raises(ValueError, match="Unknown --latent_vae param 'shift'"):
            fn(ckpt_dir=runs["diffusion"], model_type="diffusion", num_samples=1,
               latent_vae=bad, **({"device": "cpu"} if pkg == "port" else {}))


def test_auto_deep_cache_probe_decodes_both_sides(tiny, vae_runs, monkeypatch):  # noqa: F811
    """The probe's candidates cost, in pixels after the VAE decode, what
    they cost in JAX (JAX's start noise replayed); at budgets just above
    each cost both packages install the same candidate."""
    jm, params, tm = tiny
    targets = _targets()
    rng = jax.random.PRNGKey(58)
    noise = _jax_init_noise(rng, targets.shape)
    real_decode = tdu.decode_diffusion_batch
    monkeypatch.setattr(tdu, "decode_diffusion_batch",
                        lambda *a, **kw: real_decode(*a, init_noise=noise, **kw))
    jpost = jdl._load_latent_vae(f"{vae_runs['kl']}?scale=0.5")
    tpost = tdl._load_latent_vae(f"{vae_runs['kl']}?scale=0.5", torch.device("cpu"))
    assert tpost(targets).shape == (2, 1, 2 * SIDE, 2 * SIDE)

    def psnr(out):
        mse = float(np.mean((np.clip(jpost(np.asarray(out)), 0, 1)
                             - np.clip(jpost(targets), 0, 1)) ** 2))
        return 10 * np.log10(1 / max(mse, 1e-12))

    costs = {}
    try:
        for setting in (None,) + jdu._AUTO_CANDIDATES:
            jdu.set_deep_cache(setting)
            costs[setting] = psnr(jdu.decode_diffusion_batch(
                jm, params, TRAINING, MODEL_CFG, targets.shape, rng=rng,
                num_inference_steps=AUTO_STEPS))
        drops = {c: costs[None] - costs[c] for c in jdu._AUTO_CANDIDATES}
        assert len({round(d, 6) for d in drops.values()}) > 1
        for budget in sorted({d + 1e-3 for d in drops.values() if d + 1e-3 > 0}):
            expected = next(c for c in jdu._AUTO_CANDIDATES if drops[c] <= budget)
            jdu.set_deep_cache(("auto", budget))
            tdu.set_deep_cache(("auto", budget))
            chosen = (jdu.resolve_auto_deep_cache(jm, params, TRAINING, MODEL_CFG, targets,
                                                  rng=rng, num_inference_steps=AUTO_STEPS,
                                                  postprocess=jpost),
                      tdu.resolve_auto_deep_cache(tm, TRAINING, MODEL_CFG,
                                                  torch.from_numpy(targets),
                                                  num_inference_steps=AUTO_STEPS, device="cpu",
                                                  postprocess=tpost))
            assert chosen == (expected, expected), budget
    finally:
        jdu.set_deep_cache(None)
        tdu.set_deep_cache(None)
        tdu._ENGINE_CACHE.clear()


def test_cli_runs_the_vae_modes_on_the_cpu(vae_runs, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "fmdm_tpu_torch.run_model", "--ckpt_dir",
                          str(vae_runs["vq"]), "--mode", "evaluate", "--device", "cpu",
                          "--num_samples", "3", "--output_dir", str(tmp_path / "eval")],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "Model throughput:" in out.stdout and "Eval SSIM:" in out.stdout
    (exp,) = (tmp_path / "eval").iterdir()
    assert len(_read_csv(exp / "eval_metrics_per_image.csv")[1]) == 3
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.cuda, "is_available", lambda: False)
            trm.main(["--ckpt_dir", str(vae_runs["kl"]), "--mode", "evaluate"])
