"""Data parallelism of the port (``fmdm_tpu_torch/parallel/mesh.py``) on the
CPU, mirroring ``tests/test_multihost.py`` with two gloo processes.

Three clusters of two ranks, each with its own timeout:

- ``tests/torch_dp_worker.py``: over the mesh, one denoise step with a
  ragged batch whose valid counts differ per rank, a KL-VAE step with the
  GAN on (the discriminator's BatchNorm over the global batch) and a VQ-EMA
  step, each against one process on the global batch: the parameters (and
  the EMA shadow and codebook) within 1e-6 plus what AdamW's normalization
  makes of the gradients' difference; the denoise and VQ gradients within
  1e-6 of the model's largest; the GAN step's as ``tests/test_torch_gan.py``
  holds them. Each step also runs over the ranks on the JAX package's draws
  and is held against the JAX package's step on the same global batch
  sharded over two CPU devices, with the tolerances of the one-process
  tests against JAX (``test_torch_denoise_train.py``, ``test_torch_gan.py``,
  ``test_torch_vqvae.py``). Also equal batch counts per rank,
  ``broadcast_string``, the largest-of agreement, and the micro-batch
  tuning when one rank's trial runs out of memory.
- the training CLI under ``python -m torch.distributed.run`` with two ranks
  on the CPU (``orbax_async`` checkpoints), then a resume under torchrun's
  environment set by hand: one agreed ``_runN`` dir, written by rank 0
  alone, the same epoch loss logged by both ranks.

In process: ``SamplingEngine``, ``decode_diffusion_batch`` (with DeepCache
too) and the VAE engines' ``_make_dp_fn`` split over the device list
``["cpu", "cpu"]`` (ragged batches included) equal the unsplit run within
1e-5 of its largest value (the convolutions see another batch size); a
split decode equals the JAX package's decode over two CPU devices on the
same draws within ``test_torch_run_dir.py``'s 1e-4; an int8 model split
equals its shards' rows sampled alone, bitwise; ``broadcast_string``,
``pad_batch_to_multiple`` and ``create_mesh_for_batch`` held against
JAX's."""

import copy
import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fmdm_tpu.models.factories import DiffusionUNetFactory as JaxUNetFactory
from fmdm_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from fmdm_tpu.nn.module import flatten_params, unflatten_params
from fmdm_tpu.parallel import mesh as jmesh
from fmdm_tpu.sample import diffusion_utils as jdu
from fmdm_tpu.schedulers import DDPMScheduler as JaxDDPM
from fmdm_tpu.train import vae_impl as jvae
from fmdm_tpu.train.common import device_put_batch
from fmdm_tpu.train.common import make_denoise_train_step as jax_make_step
from fmdm_tpu_torch.models.factories import VAEFactory
from fmdm_tpu_torch.nn.layers import init_weights
from fmdm_tpu_torch.parallel import mesh as tmesh
from fmdm_tpu_torch.sample import autoencoder_like
from fmdm_tpu_torch.sample import diffusion_utils as tdu
from fmdm_tpu_torch.sample.engine import SamplingEngine, select_timesteps
from fmdm_tpu_torch.sample.vae_utils import (decode_vae_batch, encode_vae_batch,
                                             reconstruct_vae_batch)
from fmdm_tpu_torch.schedulers import build_scheduler
from fmdm_tpu_torch.utils import checkpoint as tckpt
from fmdm_tpu_torch.utils.weights import load_jax_params
from tests import torch_dp_worker as worker
from tests.test_torch_denoise_train import _gradient_reader
from tests.test_torch_denoise_train import few_torch_threads  # noqa: F401
from tests.test_torch_gan import GRAD_TOL as GAN_GRAD_TOL
from tests.test_torch_gan import LOSS_TOL as GAN_LOSS_TOL
from tests.test_torch_gan import _jax_gan_step_fns, disc_flat_params
from tests.test_torch_gan import _jax_step as jax_gan_step
from tests.test_torch_models import random_flat_params as unet_flat_params
from tests.test_torch_run_dir import DECODE_TOL, _cfg, _jax_model
from tests.test_torch_vae import random_flat_params as vae_flat_params
from tests.test_torch_vqvae import _jax_gen_grad
from tests.test_torch_vqvae import _jax_model as jax_vae_model
from tests.test_torch_vqvae import _jax_step as jax_vq_step
from tests.test_torch_train_cli import small_cfg, write_ldct_root
from tests.test_torch_train_vae_loop import VAE

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).parent / "torch_dp_worker.py"
TIMEOUT = 120   # seconds per process; FMDM_DIST_TIMEOUT bounds each collective
SPLIT_TOL = 1e-5
PARAM_GRAD_TOL = 1e-6


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(CUDA_VISIBLE_DEVICES="", FMDM_DIST_TIMEOUT="60", OMP_NUM_THREADS="2", **extra)
    return env


def _start_ranks(cmd, nproc: int = 2, **extra):
    """``cmd`` in ``nproc`` processes under torchrun's environment."""
    port = str(_free_port())
    return [subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True,
                             env=_env(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(nproc),
                                      MASTER_ADDR="127.0.0.1", MASTER_PORT=port, **extra))
            for r in range(nproc)]


def _finish_ranks(procs):
    """The processes' outputs, each one's return code checked."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return outs


def _run_ranks(cmd, nproc: int = 2):
    return _finish_ranks(_start_ranks(cmd, nproc))


def _result(out: str) -> dict:
    lines = [line for line in out.splitlines() if line.startswith("RESULT ")]
    assert lines, out[-2000:]
    return json.loads(lines[-1][len("RESULT "):])


class _NoPerceptual:
    """The GAN helpers' perceptual term, off (the workers' steps have none)."""

    def load_params(self):
        return None

    def __call__(self, params, rec, raw):
        return jnp.zeros((), jnp.float32)


def _jax_side():
    """(the workers' inputs, JAX's steps): each step's weights, global batch
    and the JAX package's draws, as the workers read them, and a function
    that runs the JAX package's steps on those global batches, each sharded
    over two CPU devices (the one-process tests' JAX steps)."""
    mesh = jmesh.create_mesh(2)
    shard = lambda a: jmesh.shard_batch(mesh, jnp.asarray(a))
    tree = lambda flat: unflatten_params({n: jnp.asarray(v) for n, v in flat.items()})
    rng = np.random.default_rng(20)
    inputs, steps = {}, {}

    jm = JaxUNetFactory().build(dict(worker.UNET), "concatenate", 1)
    flat = unet_flat_params(jm, 21)
    batch = {"target": rng.standard_normal((4, 1, 16, 16)).astype(np.float32),
             "image": rng.standard_normal((4, 1, 16, 16)).astype(np.float32),
             "valid": np.array([1.0, 1.0, 1.0, 0.0], np.float32)}
    key = jax.random.PRNGKey(22)
    k_noise, k_t = jax.random.split(key)   # the step's draws (one chunk)
    inputs["denoise"] = dict(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        weights={n: torch.from_numpy(v) for n, v in flat.items()},
        noise=torch.from_numpy(np.array(jax.random.normal(k_noise, (4, 1, 16, 16), jnp.float32))),
        t=torch.from_numpy(np.array(jax.random.randint(k_t, (4,), 0, worker.N_TRAIN))))

    def denoise():
        jstep = jax_make_step(jm, JaxDDPM.create(num_train_timesteps=worker.N_TRAIN),
                              _gradient_reader(), variant="diffusion",
                              conditioning_mode="concatenate", latent_norm=None)
        params = tree(flat)
        reader = _gradient_reader()
        _, st, loss_sum, count = jstep(params, reader.init(tree(flat)),
                                       device_put_batch(mesh, batch), key)
        return {"grads": flatten_params(st["g"]), "loss_sum": float(loss_sum),
                "count": float(count)}

    gcfg = worker.GAN_MODEL
    jk = JaxAutoencoderKL(**{k: v for k, v in gcfg.items() if k not in ("latent_type",
                                                                        "model_type")})
    jd = jk.make_discriminator()
    gflat, dflat = vae_flat_params(jk, 23), disc_flat_params(jd, 24)
    side = gcfg["resolution"] // 2
    gan = {"raw": rng.uniform(0.0, 1.0, (2, 1, 16, 16)).astype(np.float32),
           "valid": np.ones(2, np.float32),
           "noise": rng.standard_normal((2, gcfg["embed_dim"], side, side)).astype(np.float32)}
    inputs["gan"] = dict({k: torch.from_numpy(v) for k, v in gan.items()}, weights=gflat,
                         disc_weights=dflat)

    def gan_step():
        fns = _jax_gan_step_fns(jk, jd, dict(worker.GAN_STEP, perceptual_weight=0.0),
                                _NoPerceptual())
        m, count, g, dg = jax_gan_step(fns, tree(gflat), tree(dflat), shard(gan["raw"]),
                                       shard(gan["valid"]), shard(gan["noise"]),
                                       jnp.float32(worker.KL_SCALE), 1)
        return {"grads": flatten_params(g), "disc_grads": flatten_params(dg),
                "metrics": {k: float(v) for k, v in m.items()}, "count": float(count)}

    vcfg = worker.VQ_MODEL
    jv = jax_vae_model(vcfg)
    vflat = vae_flat_params(jv, 25)
    vflat["codebook.ema_cluster_size"] = np.abs(vflat["codebook.ema_cluster_size"])
    before = {n: t.numpy().copy() for n, t in load_jax_params(
        VAEFactory().build(vcfg, device="cpu"), vflat).state_dict().items()}
    vq = {"raw": rng.uniform(0.0, 1.0, (4, 1, 16, 16)).astype(np.float32),
          "valid": np.ones(4, np.float32),
          "noise": rng.standard_normal((4, vcfg["embed_dim"], side, side)).astype(np.float32)}
    inputs["vq"] = dict({k: torch.from_numpy(v) for k, v in vq.items()}, weights=vflat)

    def vq_step():
        gen_grad, is_ema = _jax_gen_grad(jv, worker.VQ_STEP)
        assert is_ema
        gen_p, ema_s = jvae._split_ema(tree(before), is_ema)
        m, count, g, ema = jax_vq_step(gen_grad, gen_p, ema_s, shard(vq["raw"]),
                                       shard(vq["valid"]), shard(vq["noise"]),
                                       jnp.float32(worker.KL_SCALE), 1)
        return {"grads": flatten_params(g), "metrics": {k: float(v) for k, v in m.items()},
                "count": float(count), "codebook": {k: np.asarray(v) for k, v in ema.items()}}

    return inputs, lambda: {"denoise": denoise(), "gan": gan_step(), "vq": vq_step()}


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """The workers' results: (per rank the RESULT json and the steps on
    JAX's draws, JAX's steps). JAX's steps run here while the ranks run."""
    tmp = tmp_path_factory.mktemp("dp")
    inputs, jax_steps = _jax_side()
    torch.save(inputs, tmp / "inputs.pt")
    procs = _start_ranks([sys.executable, str(WORKER)], FMDM_DP_INPUTS=str(tmp / "inputs.pt"),
                         FMDM_DP_OUT=str(tmp))
    try:
        want = jax_steps()
    finally:
        outs = _finish_ranks(procs)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return [_result(o) for o in outs], ranks, want


@pytest.fixture(scope="module")
def step_results(cluster):
    return cluster[0]


def test_ranks_agree_and_split_the_epoch(step_results):
    for rank, r in enumerate(step_results):
        assert r["rank"] == rank and r["process_count"] == 2 and r["mesh"] == ["cpu"]
        # 11 samples at batch 4 over 2 ranks: 6 each (padded), 2 batches each
        assert r["own_batches"] == r["most_batches"] == 2
        assert r["run_dir"] == "checkpoints/diffusion_run7"   # rank 0's string
        assert r["cut"] == "abcdefg"                            # JAX's cut at max_len
    for key in step_results[0]:
        if key not in ("rank", "tuned_accum"):
            assert step_results[0][key] == step_results[1][key], key


def test_a_trial_out_of_memory_on_one_rank_is_agreed(step_results):
    """Rank 1's first trial ran out of memory and it retried at twice the
    accumulation; rank 0's did not. Neither trial ran a collective, so the
    ranks took rank 1's accumulation and stepped together (a trial with
    collectives would have paired rank 0's agreement with rank 1's retry)."""
    assert [r["tuned_accum"] for r in step_results] == [1, 2]
    assert all(r["agreed_accum"] == 2 and r["agreed_count"] == 3.0 for r in step_results)


@pytest.mark.parametrize("kind", ["denoise", "denoise_ema", "gan", "gan_disc", "vq"])
def test_steps_over_ranks_equal_one_process_on_the_global_batch(step_results, kind):
    r = step_results[0]
    assert r[f"{kind}_param_excess"] <= 0.0
    if kind.startswith("gan"):
        assert r[f"{kind}_grad_excess"] <= 0.0
    else:
        assert r[f"{kind}_grad"] <= PARAM_GRAD_TOL
    head = kind.split("_")[0]
    if head == "denoise":
        assert r["denoise_loss"] <= PARAM_GRAD_TOL
        assert r["denoise_count"] == [3.0, 3.0]   # (1, 1) + (1, 0) valid
    else:
        metrics = r[f"{head}_metrics"]
        scale = max(abs(want) for _, want in metrics.values())
        for name, (got, want) in metrics.items():
            assert abs(got - want) <= PARAM_GRAD_TOL * scale, name
    if head == "vq":
        assert r["vq_codebook"] <= PARAM_GRAD_TOL and r["vq_codebook_moved"] > 1.0


def _assert_grads_close(got: dict, want: dict, rtol: float, atol_of, what) -> None:
    """Per tensor: ``rtol``, and the atol ``atol_of(the tensor's largest
    gradient, the model's largest)``. JAX's tree also holds (zero)
    gradients of BatchNorm's running statistics, which the port keeps
    without gradients."""
    want = {n: np.asarray(g) for n, g in want.items()}
    assert set(got) <= set(want), what
    assert all(".running_" in n for n in set(want) - set(got)), what
    want = {n: want[n] for n in got}
    model_max = max(float(np.abs(g).max()) for g in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w, rtol=rtol,
                                   atol=atol_of(float(np.abs(w).max()), model_max),
                                   err_msg=f"{what}: {name}")


# the one-process tests' gradient tolerances against JAX: rtol, atol
GRAD_TOLS = {
    # test_torch_denoise_train.py's _assert_grads_match
    "denoise": (1e-3, lambda top, model: 1e-4 * top + 1e-6 * model),
    # test_torch_gan.py's GRAD_TOL
    "gan": (GAN_GRAD_TOL[0], lambda top, model: max(GAN_GRAD_TOL[1] * top,
                                                    GAN_GRAD_TOL[2] * model)),
    # test_torch_vqvae.py's check_train_step
    "vq": (1e-3, lambda top, model: 1e-4 * top + 1e-8),
}


@pytest.mark.parametrize("kind", ["denoise", "gan", "vq"])
def test_steps_over_ranks_match_jax_on_the_global_batch(cluster, kind):
    """Each rank's step over the mesh on JAX's draws against the JAX
    package's step on the global batch over two CPU devices: the count and
    the summed losses, and the averaged gradients every rank applies, at the
    tolerances the one-process tests hold the port to against JAX."""
    _, ranks, want = cluster
    want = want[kind]
    for rank, out in enumerate(ranks):
        got = out[kind]
        assert got["count"] == want["count"] == {"denoise": 3.0, "gan": 2.0, "vq": 4.0}[kind]
        rtol, atol_of = GRAD_TOLS[kind]
        _assert_grads_close(got["grads"], want["grads"], rtol, atol_of, (rank, "G"))
        if kind == "denoise":
            assert got["loss_sum"] == pytest.approx(want["loss_sum"], rel=1e-5)
            continue
        for k, v in want["metrics"].items():
            assert got["metrics"][k] == pytest.approx(v, rel=GAN_LOSS_TOL, abs=1e-12), (rank, k)
        if kind == "gan":
            assert got["metrics"]["g_gan"] != 0 and got["metrics"]["d_gan"] > 0
            _assert_grads_close(got["disc_grads"], want["disc_grads"], rtol, atol_of,
                                (rank, "D"))
        else:
            for k, v in want["codebook"].items():
                np.testing.assert_allclose(got["codebook"][f"codebook.{k}"].numpy(), v, rtol=0,
                                           atol=1e-5 * float(np.abs(v).max()), err_msg=k)


# ---------------------------------------------------------------------------
# The training CLI under two ranks
# ---------------------------------------------------------------------------

def _epoch_losses(out: str):
    return re.findall(r"Diffusion Epoch (\d+) \| loss ([0-9.]+)", out)


def test_training_cli_over_two_ranks_writes_once_and_resumes(tmp_path):
    root = write_ldct_root(tmp_path / "data")
    cfg = small_cfg("diffusion", root, tmp_path / "ckpt" / "ddpm")
    cfg["training"].update(checkpoint_backend="orbax_async", save_images=False)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node", "2",
         "--master_addr", "127.0.0.1", "--master_port", str(_free_port()),
         "-m", "fmdm_tpu_torch.train", "--config", str(path), "--device", "cpu"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-4000:]
    logged = _epoch_losses(out.stdout + out.stderr)
    assert len(logged) == 2 and logged[0] == logged[1]   # both ranks, the global loss
    runs = sorted(p.name for p in (tmp_path / "ckpt").iterdir())
    assert runs == ["ddpm_run1"]   # one dir, allocated by rank 0 and adopted
    run = tmp_path / "ckpt" / "ddpm_run1"
    files = sorted(str(p.relative_to(run)) for p in run.rglob("*") if p.is_file())
    assert not [f for f in files if ".tmp" in f or ".old" in f]
    assert {"train_config.json", "metrics.csv"} <= set(files)
    lines = (run / "metrics.csv").read_text().splitlines()
    assert lines == ["epoch,train_loss", f"1,{float(logged[0][1]):.6f}"]
    for name in ("diff_last.pt", "diff_best.pt", "epochs/epoch0001/epoch.pt"):
        assert tckpt.load_checkpoint(run / name)["epoch"] == 1   # DCP directories
    # 6 samples over 2 ranks at batch 4: one step per epoch
    assert int(tckpt.load_checkpoint(run / "diff_last.pt")["optimizer"]["state"][0]["step"]) == 1

    cfg["training"].update(num_epochs=2, output_dir=str(run), checkpoint_backend="torch")
    path.write_text(json.dumps(cfg))
    outs = _run_ranks([sys.executable, "-m", "fmdm_tpu_torch.train", "--config", str(path),
                       "--device", "cpu", "--resume", str(run / "diff_last.pt")])
    resumed = [_epoch_losses(o) for o in outs]
    assert len(resumed[0]) == 1 and resumed[0] == resumed[1] and resumed[0][0][0] == "002"
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["ddpm_run1"]
    lines = (run / "metrics.csv").read_text().splitlines()
    assert lines[2] == f"2,{float(resumed[0][0][1]):.6f}" and len(lines) == 3
    payload = tckpt.load_checkpoint(run / "epochs" / "epoch0002" / "epoch.pt")
    assert payload["epoch"] == 2 and int(payload["optimizer"]["state"][0]["step"]) == 2
    assert (run / "diff_last.pt").is_file()   # the torch backend replaced the directory


# ---------------------------------------------------------------------------
# Sampling split over a device list, in one process
# ---------------------------------------------------------------------------

CPU2 = ("cpu", "cpu")


def _close(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.shape == want.shape
    err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
    assert err <= SPLIT_TOL, err


@pytest.mark.parametrize("scheduler,batch,deep_cache", [
    ("ddpm", 3, None),               # stochastic: the steps' noise drawn whole, then split
    ("dpm_multistep", 4, None),
    ("dpm_multistep", 4, (2, 1)),    # DeepCache: each shard keeps its cached feature
])
def test_sampling_engine_split_over_a_device_list(scheduler, batch, deep_cache):
    cfg = _cfg()
    model = tdu.build_diffusion_model(cfg, device="cpu")
    sched, _ = build_scheduler(dict(cfg["model"]["scheduler"], name=scheduler), cfg["training"])
    timesteps = select_timesteps(sched.set_timesteps(3))
    cond = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (batch, 1, 16, 16)).astype(np.float32))
    out = {}
    for name, mesh in (("one", None), ("split", tmesh.create_mesh(devices=CPU2))):
        engine = SamplingEngine(model, sched, timesteps, "concatenate", None,
                                deep_cache=deep_cache, device="cpu", mesh=mesh)
        timing = {}
        out[name] = engine((batch, 1, 16, 16), torch.Generator().manual_seed(5),
                           conditioning_batch=cond, timing=timing)
        assert timing["model_calls"] == 3
    assert engine.mesh is not None and len(engine._replicas_for_compute()) == 2
    assert len(SamplingEngine(model, sched, timesteps, "concatenate", None, device="cpu")
               ._replicas_for_compute()) == 1
    _close(out["split"], out["one"])


@pytest.mark.parametrize("deep_cache", [None, (2, 1, "adaptive")])
def test_decode_splits_through_the_sampling_mesh(monkeypatch, deep_cache):
    """``decode_diffusion_batch`` takes the mesh ``_sampling_mesh`` gives
    (here a device list: the CPU has no second card) and keys its engine
    cache on the card count; DeepCache composes with the split."""
    monkeypatch.setattr(tdu, "_ENGINE_CACHE", {})
    cfg = _cfg()
    model = tdu.build_diffusion_model(cfg, device="cpu")
    tdu.set_deep_cache(deep_cache)

    def decode():
        return tdu.decode_diffusion_batch(model, cfg["training"], cfg["model"], (2, 1, 16, 16),
                                          torch.rand(2, 1, 16, 16,
                                                     generator=torch.Generator().manual_seed(1)),
                                          generator=torch.Generator().manual_seed(0),
                                          num_inference_steps=3, device="cpu")

    try:
        one = decode()
        monkeypatch.setattr(tdu, "_sampling_mesh",
                            lambda b, d=None: tmesh.create_mesh_for_batch(b, CPU2))
        _close(decode(), one)
    finally:
        tdu.set_deep_cache(None)
    assert sorted(str(key[-2]) for key in tdu._ENGINE_CACHE) == ["2", "None"]


@pytest.mark.parametrize("override,batch,steps,stochastic", [
    ("ddim", 2, 5, False),
    (None, 4, 4, True),    # the config's DDPM: the steps' noise split too
])
def test_split_decode_matches_jax_over_two_devices(monkeypatch, override, batch, steps,
                                                   stochastic):
    """The JAX package's decode splits a batch over its CPU devices
    (``_sampling_mesh``: 2 of them at batch 2, 4 at batch 4); the port's
    over ``["cpu", "cpu"]``, on JAX's draws (as ``test_decode_matches_jax``
    replays them), within that test's tolerance."""
    monkeypatch.setattr(jdu, "_DP_SAMPLING", True)
    monkeypatch.setattr(tdu, "_ENGINE_CACHE", {})
    cfg = _cfg()
    jm = _jax_model(cfg)
    flat = unet_flat_params(jm, 13)
    model = tdu.build_diffusion_model(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in flat.items()})
    shape = (batch, 1, 16, 16)
    cond = np.random.default_rng(14).uniform(-1, 1, shape).astype(np.float32)
    key = jax.random.PRNGKey(15)
    training, model_cfg = cfg["training"], cfg["model"]
    want = np.asarray(jdu.decode_diffusion_batch(
        jm, unflatten_params(flat), training, model_cfg, shape, jnp.asarray(cond), rng=key,
        num_inference_steps=steps, scheduler_override=override))
    engine = next(reversed(jdu._ENGINE_CACHE.values()))
    assert engine.mesh is not None and engine.mesh.devices.size == batch

    _, k_sample = jax.random.split(key)
    k_init, k_steps = jax.random.split(k_sample)
    noise = lambda k: torch.from_numpy(np.array(jax.random.normal(k, shape, jnp.float32)))
    draws = [noise(k) for k in jax.random.split(k_steps, steps)] if stochastic else None
    monkeypatch.setattr(tdu, "_sampling_mesh",
                        lambda b, d=None: tmesh.create_mesh_for_batch(b, CPU2))
    got = tdu.decode_diffusion_batch(model, training, model_cfg, shape, torch.from_numpy(cond),
                                     num_inference_steps=steps, scheduler_override=override,
                                     init_noise=noise(k_init), step_noise=draws, device="cpu")
    (split,) = tdu._ENGINE_CACHE.values()
    assert split.mesh is not None and len(split.devices) == 2
    err = float(np.abs(got.numpy().astype(np.float64) - want).max() / np.abs(want).max())
    assert err <= DECODE_TOL, err


def test_int8_model_splits_as_its_shards_alone(monkeypatch):
    """``--quantize int8`` composes with the split: the decode's int8 model
    (convs of 64 channels at 32², which the policy quantizes) sampled over
    two shards equals each shard's rows sampled alone, bitwise (a shard's
    forward has the rows of the lone run; int8 rounding flips between batch
    sizes, so the unsplit batch of 2 is not the reference)."""
    monkeypatch.setattr(tdu, "_ENGINE_CACHE", {})
    cfg = _cfg()
    cfg["model"]["unet"].update(sample_size=32, block_out_channels=[64, 64])
    model = tdu.build_diffusion_model(cfg, device="cpu")
    shape = (2, 1, 32, 32)
    gen = torch.Generator().manual_seed(1)
    cond, init = torch.rand(shape, generator=gen), torch.randn(shape, generator=gen)
    tdu.set_quantize("int8")
    try:
        tdu.decode_diffusion_batch(model, cfg["training"], cfg["model"], shape, cond,
                                   num_inference_steps=3, device="cpu")
    finally:
        tdu.set_quantize(None)
    (_, qmodel), = tdu._QUANT_CACHE.values()
    assert any("Quantized" in type(m).__name__ for m in qmodel.modules())
    sched, _ = build_scheduler(cfg["model"]["scheduler"], cfg["training"])
    timesteps = select_timesteps(sched.set_timesteps(3))
    noise = [torch.randn(shape, generator=gen) for _ in timesteps]
    split = SamplingEngine(qmodel, sched, timesteps, "concatenate", None, device="cpu",
                           mesh=tmesh.create_mesh(devices=CPU2))(
        shape, conditioning_batch=cond, init_sample=init, step_noise=noise)
    alone = [SamplingEngine(qmodel, sched, timesteps, "concatenate", None, device="cpu")(
        (1, 1, 32, 32), conditioning_batch=cond[r], init_sample=init[r],
        step_noise=[n[r] for n in noise]) for r in (slice(0, 1), slice(1, 2))]
    assert torch.equal(split, torch.cat(alone))


@pytest.mark.parametrize("latent_type", ["kl", "vq"])
def test_vae_engines_split_over_a_device_list(latent_type):
    cfg = dict(VAE, latent_type=latent_type)
    if latent_type == "vq":
        cfg.update(codebook_size=16, quantizer_type="ema", embed_dim=4)
    model = VAEFactory().build(cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(1))
    model.eval()
    rng = np.random.default_rng(3)
    images = rng.uniform(0, 1, (3, 1, 16, 16)).astype(np.float32)   # ragged over 2
    mesh = tmesh.create_mesh(devices=CPU2)
    latents = encode_vae_batch(model, torch.from_numpy(images)).detach().numpy()
    for core, batch in ((encode_vae_batch, images), (decode_vae_batch, latents),
                        (reconstruct_vae_batch, images)):
        one = autoencoder_like._make_dp_fn(core, model, 3, torch.device("cpu"))(batch)
        split = autoencoder_like._make_dp_fn(core, model, 3, torch.device("cpu"), mesh)(batch)
        assert split.shape[0] == 3
        _close(split, one)


def test_helpers_match_jax():
    assert tmesh.broadcast_string("run/dir_run3") == jmesh.broadcast_string("run/dir_run3")
    assert tmesh.process_count() == jmesh.process_count() == 1
    assert tmesh.is_main_process() and jmesh.is_main_process()
    a = np.arange(30, dtype=np.float32).reshape(5, 3, 2)
    for arrays in (a, [a, a[:, :1]], (a, a * 2)):
        for multiple in (1, 2, 4, 5):
            got, got_real = tmesh.pad_batch_to_multiple(arrays, multiple)
            want, want_real = jmesh.pad_batch_to_multiple(arrays, multiple)
            assert got_real == want_real and type(got) is type(want)
            for g, w in zip(got if isinstance(got, (list, tuple)) else [got],
                            want if isinstance(want, (list, tuple)) else [want]):
                assert np.array_equal(g, w)
            t, t_real = tmesh.pad_batch_to_multiple(torch.from_numpy(a), multiple)
            assert t_real == 5 and np.array_equal(t.numpy(), jmesh.pad_batch_to_multiple(
                a, multiple)[0])

    eight = ["cpu"] * len(jax.local_devices())
    for batch in range(1, 13):
        assert (len(tmesh.create_mesh_for_batch(batch, eight).devices)
                == jmesh.create_mesh_for_batch(batch).devices.size), batch
    mesh = tmesh.create_mesh_for_batch(6, eight)
    assert mesh.size == 6 and mesh.axis_names == ("data",) and not tmesh.spans_processes(mesh)
    shards = tmesh.shard_batch(mesh, np.arange(12).reshape(6, 2))
    assert [s.tolist() for s in shards] == [[[2 * i, 2 * i + 1]] for i in range(6)]
    assert copy.deepcopy(mesh) is mesh
    host = tmesh.to_host({"a": torch.ones(2), "b": [torch.zeros(1)], "c": 3})
    assert host["c"] == 3 and host["a"].device.type == "cpu"
