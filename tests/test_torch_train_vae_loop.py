"""The port's KL-VAE training loop against the JAX package's, on the CPU.

A two-stage KL-VAE (8 and 16 channels, the mid attention kept) at 16² trains
on a few synthetic MNIST digits in both packages, validating on others: the
port starts from JAX's initial weights (``build_vae_model`` is wrapped to
record them) and its steps take the posterior noise JAX drew (the step
returned by ``autotune_grad_accum`` is wrapped to record its key: one
``split(key, n_chunks)`` key per chunk). Held as in
``tests/test_torch_train_loop.py``: the same run-dir files, ``metrics.csv``'s
columns and rows within 1e-5 relative, the best metric (the validation loss)
within 1e-5, the weights of ``vae_last.pt`` within 1e-5 of JAX's (the
attention's key biases to the summed rates). The KL anneal follows the
loop's counter, which restarts on resume as in JAX, while the rate follows
the optimizer's step. A visual grid of 4x5 with fewer than 20 samples raises
in both packages.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fmdm_tpu.nn.module import flatten_params as jax_flatten
from fmdm_tpu.train import vae_impl as jvae
from fmdm_tpu_torch.train import vae_impl as tvae
from fmdm_tpu_torch.utils import checkpoint as tckpt
from fmdm_tpu_torch.utils.evaluation import latent_shape
from tests.test_torch_denoise_train import few_torch_threads  # noqa: F401
from tests.test_torch_train_loop import (Recorder, assert_runs_match, read_metrics, run_files,
                                         tiny, truncate_to_epoch, write_cfg)

VAE = {"in_channels": 1, "out_channels": 1, "resolution": 16, "base_ch": 8,
       "down_channels": [8, 16], "num_res_blocks": 1, "attn_resolutions": [], "z_channels": 4,
       "embed_dim": 4, "dropout": 0.0, "use_attention": True, "spatial_dims": 2,
       "emb_channels": None, "use_scale_shift_norm": False, "double_z": True, "attn_heads": 2,
       "attn_dim_head": 8, "latent_type": "kl", "model_type": "vae", "norm_groups": 4}
# Adam's first update is the gradient's sign: an element whose gradient is
# near 0 may flip sign between the packages and move 2 * LR apart, so the
# rate stays at the config's 1e-4
LR = 1e-4


def vae_cfg(tmp: Path, **training) -> dict:
    return {"training": {"output_dir": str(tmp / "ckpt"), "epochs": 2, "batch_size": 4,
                         "learning_rate": LR, "weight_decay": 0.01, "kl_weight": 1e-2,
                         "kl_anneal_steps": 3, "reg_type": "kl", "recon_type": "l1",
                         "save_every": 1, "seed": 3, "img_size": 16, "save_images": True,
                         "visual_samples": 4, "num_workers": 0, **training},
            "model": dict(VAE)}


def vae_draws(args, accum):
    """The posterior noise of JAX's VAE step for its (raw, key) inputs."""
    raw, rng = args[5], args[7]
    chunk = max(1, -(-raw.shape[0] // accum))
    keys = jax.random.split(rng, accum)
    return np.concatenate([np.array(jax.random.normal(k, (chunk, *latent_shape(VAE)), jnp.float32))
                           for k in keys])


def replay_vae_steps(monkeypatch, draws, kl_scales):
    real = tvae.KLTrainStep.step

    def step(self, raw, valid, *, noise=None, generator=None, kl_scale=None, disc_active=False):
        kl_scales.append(kl_scale)
        return real(self, raw, valid, noise=torch.from_numpy(draws.pop(0)), kl_scale=kl_scale,
                    disc_active=disc_active)

    monkeypatch.setattr(tvae.KLTrainStep, "step", step)


def share_initial_weights(monkeypatch):
    initial = {}
    real = jvae.build_vae_model

    def jax_build(*args, **kw):
        model, params = real(*args, **kw)
        initial.update({k: np.array(v) for k, v in jax_flatten(params).items()})
        return model, params

    def port_build(cfg, flat_params=None, generator=None, device=None, ckpt_path=None):
        return real_port(cfg, flat_params=initial, device=device)

    real_port = tvae.build_vae_model
    monkeypatch.setattr(jvae, "build_vae_model", jax_build)
    monkeypatch.setattr(tvae, "build_vae_model", port_build)


def train_both(tmp, monkeypatch, cfg, *, resume=None, share=True):
    """JAX's train(), then the port's on JAX's draws (and, with ``share``,
    from JAX's initial weights); returns the run dirs and the KL scales the
    port's steps took."""
    recorder = Recorder(monkeypatch, vae_draws)
    if share:
        share_initial_weights(monkeypatch)
    kl_scales, runs = [], {}
    for pkg, lib in (("jax", jvae), ("port", tvae)):
        pkg_cfg = copy.deepcopy(cfg)
        if resume is None:
            pkg_cfg["training"]["output_dir"] = str(tmp / f"{pkg}_ckpt")
        else:
            pkg_cfg["training"]["output_dir"] = str(truncate_to_epoch(resume[0], tmp / f"{pkg}_resumed",
                                                                  resume[1]))
        path = write_cfg(tmp / f"{pkg}.json", pkg_cfg)
        if pkg == "port":
            replay_vae_steps(monkeypatch, recorder.draws, kl_scales)
        runs[pkg] = lib.train(tiny(pkg, tmp / "data"), path,
                              val_dataset=tiny(pkg, tmp / "data", train=False, n=6),
                              resume=None if resume is None else str(resume[2]),
                              **({"device": "cpu"} if pkg == "port" else {}))
    assert not recorder.draws, "a recorded draw was not replayed"
    return runs["jax"], runs["port"], kl_scales


def constant_rate(_step):
    return LR


@pytest.fixture(scope="module")
def vae_runs(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp("vae")
    cfg = vae_cfg(tmp)
    try:
        with pytest.MonkeyPatch.context() as mp:
            jax_run, port_run, kl_scales = train_both(tmp, mp, cfg)
    finally:
        torch.set_num_threads(threads)
    return {"tmp": tmp, "cfg": cfg, "jax": jax_run, "port": port_run, "kl": kl_scales}


def test_vae_train_matches_jax(vae_runs):
    jax_run, port_run = vae_runs["jax"], vae_runs["port"]
    assert_runs_match(jax_run, port_run, "vae_last.pt", constant_rate)
    head, rows = read_metrics(port_run)
    assert head == "epoch,loss,recon,kl,vq" and [r[0] for r in rows] == [1, 2]
    assert {"vae_best.pt", "epochs/epoch0002/epoch.pt", "epochs/epoch0002/gen.png",
            "epochs/epoch0001/recon.png", "epochs/epoch0001/input.png"} <= set(run_files(port_run))
    # the KL anneal over 3 steps by the loop's counter: 3 steps an epoch
    assert vae_runs["kl"] == pytest.approx([1e-2 * min(1.0, (s + 1) / 3) for s in range(6)])
    payload = tckpt.load_checkpoint(port_run / "vae_last.pt")
    assert payload["scheduler"] == {"last_epoch": 2} and int(
        payload["optimizer"]["state"][0]["step"]) == 6


def test_vae_best_follows_the_validation_loss(vae_runs):
    """vae_best.pt holds the epoch of the lowest validation loss, which
    differs from the train loss the CSV records."""
    jax_run, port_run = vae_runs["jax"], vae_runs["port"]
    best = {r: tckpt.load_checkpoint(r / "vae_best.pt") for r in (jax_run, port_run)}
    assert best[port_run]["epoch"] == best[jax_run]["epoch"]
    assert best[port_run]["best_metric"] == pytest.approx(best[jax_run]["best_metric"], rel=1e-5)
    _, rows = read_metrics(port_run)
    assert all(abs(best[port_run]["best_metric"] - r[1]) > 1e-6 for r in rows)


def test_vae_resume_of_a_jax_run_matches_jax(vae_runs, monkeypatch):
    """JAX's epoch-1 snapshot resumed by both: the rate continues from the
    optimizer's step 3, the KL anneal restarts at the loop's step 0."""
    tmp, cfg = vae_runs["tmp"], vae_runs["cfg"]
    snapshot = vae_runs["jax"] / "epochs" / "epoch0001" / "epoch.pt"
    jax_run, port_run, kl_scales = train_both(tmp / "resume", monkeypatch, cfg,
                                              resume=(vae_runs["jax"], 1, snapshot), share=False)
    assert_runs_match(jax_run, port_run, "vae_last.pt", constant_rate)
    assert kl_scales == pytest.approx([1e-2 * min(1.0, (s + 1) / 3) for s in range(3)])
    assert int(tckpt.load_checkpoint(port_run / "vae_last.pt")["optimizer"]["state"][0]["step"]) == 6


def test_vae_grid_of_20_needs_20_samples_in_both(tmp_path):
    """visual_samples 20 asks for a 4x5 grid; the 6 validation digits give
    6 images, and make_grid raises in both packages after the first epoch,
    whose metrics.csv has the same columns (no ``vq`` at codebook_weight 0)."""
    cfg = vae_cfg(tmp_path, visual_samples=20, epochs=1, codebook_weight=0.0)
    heads = []
    for pkg, lib in (("jax", jvae), ("port", tvae)):
        pkg_cfg = copy.deepcopy(cfg)
        pkg_cfg["training"]["output_dir"] = str(tmp_path / pkg)
        with pytest.raises(ValueError, match="Need at least 20 images"):
            lib.train(tiny(pkg, tmp_path / "data", n=4), write_cfg(tmp_path / f"{pkg}.json", pkg_cfg),
                      val_dataset=tiny(pkg, tmp_path / "data", train=False, n=6),
                      max_steps_per_epoch=1, **({"device": "cpu"} if pkg == "port" else {}))
        heads.append((tmp_path / f"{pkg}_run1" / "metrics.csv").read_text().splitlines()[0])
    assert heads == ["epoch,loss,recon,kl"] * 2


def test_vae_trial_leaves_no_trace():
    from fmdm_tpu_torch.models.factories import VAEFactory

    results = []
    raw, valid = torch.rand(3, 1, 16, 16), torch.tensor([1.0, 1.0, 0.0])
    for with_trial in (True, False):
        model = VAEFactory().build(VAE, device="cpu")
        from fmdm_tpu_torch.nn.layers import init_weights

        init_weights(model, torch.Generator().manual_seed(1))
        trainer = tvae.KLTrainStep(model, vae_cfg(Path("."))["training"])
        before = [p.detach().clone() for p in model.parameters()]
        if with_trial:
            trainer.n_chunks = 2
            trainer.trial(raw, valid, torch.Generator().manual_seed(0))
            trainer.n_chunks = 1
            assert all(torch.equal(p, b) for p, b in zip(model.parameters(), before))
            assert all(p.grad is None for p in model.parameters())
            assert not trainer.optimizer.state and trainer.global_step == 0
        gen = torch.Generator().manual_seed(4)
        sums, _ = trainer.step(raw, valid, generator=gen)
        results.append((sums["loss"], [p.detach() for p in model.parameters()], gen.get_state()))
    (la, pa, ga), (lb, pb, gb) = results
    assert torch.equal(la, lb) and torch.equal(ga, gb)
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
