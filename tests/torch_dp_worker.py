"""One rank of a two-process gloo cluster on the CPU, for
``tests/test_torch_data_parallel.py``: each rank runs the port's train steps
over the mesh on its rows of a global batch and, in the same process, one
process's step on the whole global batch (a model of its own, no mesh), and
prints ``RESULT <json>`` with the largest differences. Each step starts
from the weights in ``FMDM_DP_INPUTS`` (a ``torch.save`` file the test
writes), and each runs once more over the mesh on the JAX package's draws
(the noise, and the denoise step's t) from that file; those results go to
``FMDM_DP_OUT/rank<r>.pt``, which the test holds against the JAX package's
step on the global batch. The start-up trial of the micro-batch tuning
fails on rank 1 alone, and the ranks must still agree.

    FMDM_DP_INPUTS=inputs.pt FMDM_DP_OUT=out RANK=r WORLD_SIZE=2 LOCAL_RANK=r \\
        MASTER_ADDR=127.0.0.1 MASTER_PORT=p python tests/torch_dp_worker.py
"""

import copy
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from fmdm_tpu_torch.models.factories import DiffusionUNetFactory, VAEFactory  # noqa: E402
from fmdm_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from fmdm_tpu_torch.schedulers import DDPMScheduler  # noqa: E402
from fmdm_tpu_torch.train.common import (agree_grad_accum, autotune_grad_accum,  # noqa: E402
                                         epoch_batches, make_adamw, make_denoise_train_step)
from fmdm_tpu_torch.train.vae_impl import VAETrainStep  # noqa: E402
from fmdm_tpu_torch.utils.weights import load_jax_params  # noqa: E402

LR = 1e-4
UNET = {"unet_impl": "diffusers_nd", "sample_size": 16, "in_channels": 1, "out_channels": 1,
        "layers_per_block": 1, "block_out_channels": [16, 32], "norm_num_groups": 8,
        "down_block_types": ["DownBlock2D", "AttnDownBlock2D"],
        "up_block_types": ["AttnUpBlock2D", "UpBlock2D"]}
# the KL-VAE's topology in two 64-wide stages, its PatchGAN head (BatchNorm)
GAN_MODEL = {"in_channels": 1, "out_channels": 1, "resolution": 16, "base_ch": 64,
             "down_channels": [64, 64], "num_res_blocks": 1, "attn_resolutions": [],
             "z_channels": 4, "embed_dim": 4, "dropout": 0.0, "use_attention": True,
             "spatial_dims": 2, "double_z": True, "attn_heads": 2, "attn_dim_head": 8,
             "latent_type": "kl", "model_type": "vae"}
GAN_STEP = {"learning_rate": LR, "weight_decay": 0.0, "epochs": 2, "kl_weight": 1e-2,
            "recon_type": "l1", "gan_weight": 0.5, "gan_start": 0, "disc_lr": 2e-4, "seed": 4}
VQ_MODEL = {"in_channels": 1, "out_channels": 1, "resolution": 16, "base_ch": 64,
            "down_channels": [64, 64], "num_res_blocks": 1, "attn_resolutions": [],
            "z_channels": 16, "embed_dim": 16, "dropout": 0.0, "use_attention": False,
            "spatial_dims": 2, "latent_type": "vq", "model_type": "vae", "codebook_size": 32,
            "vq_beta": 0.25, "vq_ema_decay": 0.99, "vq_ema_eps": 1e-5, "quantizer_type": "ema"}
VQ_STEP = {"learning_rate": LR, "weight_decay": 0.01, "epochs": 2, "codebook_weight": 1.0,
           "recon_type": "l1"}
KL_SCALE = 1e-2   # the KL weight of the steps on JAX's draws
N_TRAIN = 50      # the denoise scheduler's timesteps


# the averaged gradients of a GAN step as tests/test_torch_gan.py holds them:
# rtol, and atol as a share of the tensor's largest gradient or of the model's
# (the discriminators' BatchNorm over near-constant reconstructions amplifies
# rounding), whichever is larger
GAN_GRAD_TOL = (1e-3, 5e-4, 1e-5)
PARAM_TOL = 1e-6


def state(module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def grads(module) -> dict:
    return {n: p.grad.detach().clone() for n, p in module.named_parameters() if p.grad is not None}


def adam_first_update(g: torch.Tensor, lr: float) -> torch.Tensor:
    """AdamW's first step on gradient ``g`` (bias-corrected moments g, g²),
    the decay aside: lr g / (|g| + eps)."""
    g = g.double()
    return lr * g / (g.abs() + 1e-8)


def compare(got: dict, want: dict, got_g: dict, want_g: dict, lr: float, prefix: str,
            gan: bool = False) -> dict:
    """The parameters after one step within PARAM_TOL plus what Adam's
    normalization makes of the gradients' difference (a gradient at the
    noise floor may flip a +-lr update); the gradients' largest difference
    over the model's largest gradient (or, for a GAN step, the excess over
    GAN_GRAD_TOL)."""
    model_max = max(float(g.abs().max()) for g in want_g.values())
    excess = max(float(((got[n] - want[n]).abs().double() - PARAM_TOL
                        - (adam_first_update(got_g[n], lr)
                           - adam_first_update(want_g[n], lr)).abs()).max())
                 for n in want_g)
    out = {f"{prefix}_param_excess": excess,
           f"{prefix}_grad": max(float((got_g[n] - want_g[n]).abs().max())
                                 for n in want_g) / model_max}
    if gan:
        rtol, share, floor = GAN_GRAD_TOL
        out[f"{prefix}_grad_excess"] = max(
            float(((got_g[n] - want_g[n]).abs() - rtol * want_g[n].abs()
                   - max(share * float(want_g[n].abs().max()), floor * model_max)).max())
            for n in want_g)
    return out


def denoise_step(weights: dict, mesh=None):
    """The model with ``weights`` and its step (the EMA starts from them)."""
    model = DiffusionUNetFactory().build(dict(UNET), "concatenate", 1, device="cpu")
    model.load_state_dict(weights)
    optimizer, schedule = make_adamw(model.parameters(), LR, 1e-2, 0, 10)
    return model, make_denoise_train_step(
        model, DDPMScheduler.create(num_train_timesteps=N_TRAIN), optimizer, schedule,
        variant="diffusion", conditioning_mode="concatenate", latent_norm=None, ema_decay=0.9,
        device="cpu", mesh=mesh)


def denoise(mesh, rank: int, inputs: dict, jax_out: dict) -> dict:
    """A DDPM step at 2 samples per rank, valid (1, 1) on rank 0 and (1, 0)
    on rank 1 (a ragged last batch), against one process on the 4; then
    over the mesh on JAX's noise and t, into ``jax_out``."""
    d = inputs["denoise"]
    full = {"target": d["target"], "image": d["image"], "valid": d["valid"]}
    mine = slice(2 * rank, 2 * rank + 2)
    out = {}
    for name in ("ref", "dp", "jax"):
        m, step = denoise_step(d["weights"], None if name == "ref" else mesh)
        rows = slice(None) if name == "ref" else mine
        batch = {k: v[rows] for k, v in full.items()}
        if name == "jax":
            loss_sum, count = step.step(batch, noise=d["noise"][rows], t=d["t"][rows])
            jax_out["denoise"] = {"grads": grads(m), "loss_sum": float(loss_sum),
                                  "count": float(count)}
            continue
        loss_sum, count = step.step(batch, generator=torch.Generator().manual_seed(11))
        out[name] = (state(m), grads(m), float(loss_sum), float(count),
                     {n: e.clone() for n, e in step.ema_state_dict().items()})
    (ref, g_ref, l_ref, c_ref, e_ref), (dp, g_dp, l_dp, c_dp, e_dp) = out["ref"], out["dp"]
    res = compare(dp, ref, g_dp, g_ref, LR, "denoise")
    res.update(compare(e_dp, e_ref, g_dp, g_ref, LR, "denoise_ema"))
    res.update(denoise_loss=abs(l_dp - l_ref) / abs(l_ref), denoise_count=[c_dp, c_ref])
    return res


def autotune(mesh, rank: int, inputs: dict) -> dict:
    """The start-up micro-batch tuning over the ranks: rank 1's first trial
    fails as out of memory after its forward and backward, rank 0's does
    not. The trials issue no collective, so the ranks stay in step, agree on
    rank 1's accumulation, and take a step together."""
    d = inputs["denoise"]
    batch = {k: d[k][2 * rank:2 * rank + 2] for k in ("target", "image", "valid")}
    _, step = denoise_step(d["weights"], mesh)
    failed = []

    def build(accum: int):
        step.grad_accum = accum
        return step

    def trial(st, accum: int) -> None:
        st.trial(batch, torch.Generator().manual_seed(0))
        if rank == 1 and not failed:
            failed.append(accum)
            raise torch.OutOfMemoryError("out of memory (planted on rank 1)")

    tuned, step = autotune_grad_accum(build, trial, batch_size=2, grad_accum=1)
    agreed, step = agree_grad_accum(tuned, build, mesh)
    _, count = step.step(batch, generator=torch.Generator().manual_seed(11))
    return {"tuned_accum": tuned, "agreed_accum": agreed, "agreed_count": float(count)}


def vae_step(kind: str, cfg: dict, training: dict, per_rank: int, mesh, rank: int,
             inputs: dict, jax_out: dict) -> dict:
    """One VAE step at ``per_rank`` samples per rank against one process on
    the global batch: G's (and D's) parameters and gradients, an EMA
    codebook, the metrics; then over the mesh on JAX's noise, into
    ``jax_out``."""
    v = inputs[kind]
    raw, valid = v["raw"], v["valid"]
    mine = slice(per_rank * rank, per_rank * (rank + 1))
    out = {}
    for name in ("ref", "dp", "jax"):
        m = load_jax_params(VAEFactory().build(cfg, device="cpu"), v["weights"])
        start = state(m)
        trainer = VAETrainStep(m, training, mesh=None if name == "ref" else mesh)
        d = trainer.discriminator
        active = d is not None
        if active:
            load_jax_params(d, v["disc_weights"])
        rows = slice(None) if name == "ref" else mine
        if name == "jax":
            sums, count = trainer.step(raw[rows], valid[rows], noise=v["noise"][rows],
                                       kl_scale=KL_SCALE, disc_active=active)
            jax_out[kind] = {"grads": grads(m), "disc_grads": grads(d) if active else {},
                             "metrics": {k: float(x) for k, x in sums.items()},
                             "count": float(count),
                             "codebook": {k: t for k, t in state(m).items()
                                          if k.startswith("codebook.")}}
            continue
        sums, count = trainer.step(raw[rows], valid[rows],
                                   generator=torch.Generator().manual_seed(13),
                                   disc_active=active)
        out[name] = (state(m), grads(m), {k: float(x) for k, x in sums.items()}, float(count),
                     state(d) if active else {}, grads(d) if active else {})
    (p_ref, g_ref, s_ref, c_ref, d_ref, dg_ref) = out["ref"]
    (p_dp, g_dp, s_dp, c_dp, d_dp, dg_dp) = out["dp"]
    gan = bool(d_ref)
    res = compare(p_dp, p_ref, g_dp, g_ref, training["learning_rate"], kind, gan)
    res[f"{kind}_metrics"] = {k: [s_dp[k], s_ref[k]] for k in s_ref}
    res[f"{kind}_count"] = [c_dp, c_ref]
    codebook = [k for k in p_ref if k.startswith("codebook.")]
    if codebook:
        res[f"{kind}_codebook"] = max(float((p_dp[k] - p_ref[k]).abs().max()) for k in codebook)
        res[f"{kind}_codebook_moved"] = max(float((p_ref[k] - start[k]).abs().max())
                                            for k in codebook)
    if gan:
        res.update(compare(d_dp, d_ref, dg_dp, dg_ref, training["disc_lr"], f"{kind}_disc", gan))
    return res


def main() -> None:
    torch.set_num_threads(2)
    mesh_lib.maybe_initialize_distributed("cpu")
    rank = mesh_lib.process_index()
    mesh = mesh_lib.create_data_mesh(2, "cpu")
    result = {"rank": rank, "process_count": mesh_lib.process_count(),
              "mesh": [str(d) for d in mesh.devices]}
    # every rank yields as many batches of an epoch of 11 samples at batch 4
    samples = [{"target": np.full((1, 2, 2), i, np.float32)} for i in range(11)]
    own = sum(1 for _ in epoch_batches(samples, 4, shuffle=True, seed=3, epoch=1,
                                       process_index=rank, process_count=2, num_workers=0))
    result["own_batches"] = own
    result["most_batches"] = mesh_lib.agree_max(own, mesh)
    result["run_dir"] = mesh_lib.broadcast_string("checkpoints/diffusion_run7" if rank == 0
                                                  else "elsewhere")
    result["cut"] = mesh_lib.broadcast_string("abcdefghij" if rank == 0 else "", max_len=7)
    inputs = torch.load(os.environ["FMDM_DP_INPUTS"], weights_only=False)
    jax_out = {}
    result.update(autotune(mesh, rank, inputs))
    result.update(denoise(mesh, rank, inputs, jax_out))
    result.update(vae_step("gan", GAN_MODEL, GAN_STEP, 1, mesh, rank, inputs, jax_out))
    result.update(vae_step("vq", VQ_MODEL, VQ_STEP, 2, mesh, rank, inputs, jax_out))
    mesh_lib.destroy_distributed()
    torch.save(jax_out, Path(os.environ["FMDM_DP_OUT"]) / f"rank{rank}.pt")
    print("RESULT " + json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
