"""One rank of a gloo cluster on the CPU for the parallel strategies' tests
(``tests/test_torch_sequence_parallel.py``, ``tests/test_torch_fsdp_tp.py``,
``tests/test_torch_collective_stats.py``), in the pattern of
``tests/torch_dp_worker.py``: the test writes the weights, the global
batches and the JAX package's draws to ``FMDM_PAR_INPUTS`` and starts the
ranks; each rank runs the cases of ``FMDM_PAR_MODE`` and rank 0 saves what
the test compares to ``FMDM_PAR_OUT/result.pt``.

- ``seq`` (2 ranks): the rank form of the ring (both impls, f32 and bf16,
  out and gradients gathered whole), ``sdpa``'s routing over a rank mesh
  (the all-to-all each way), the denoise and VAE steps under
  ``sequence_parallel: 2``, and ``train()`` under it (the routing cleared
  when it returns);
- ``fsdp_tp`` (4 ranks): the denoise steps under ``fsdp``,
  ``tensor_parallel: 2`` (data 2 x model 2) and both, the VAE's under
  ``fsdp`` and ``tensor_parallel: 2``, each parameter's placement and each
  rank's state bytes, a one-process step on the global batch,
  ``train()`` one epoch under each flag (its run dirs checked by the test),
  and the denoise run under both flags resumed for a second epoch beside
  two epochs straight;
- ``collectives`` (2 ranks): one denoise step under each strategy inside
  ``torch.profiler``, its collectives parsed.

    FMDM_PAR_MODE=seq FMDM_PAR_INPUTS=inputs.pt FMDM_PAR_OUT=out RANK=r WORLD_SIZE=2 \\
        LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p python tests/torch_parallel_worker.py
"""

import json
import os
import sys
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from fmdm_tpu_torch.models.factories import DiffusionUNetFactory, VAEFactory  # noqa: E402
from fmdm_tpu_torch.ops import attention as attention_ops  # noqa: E402
from fmdm_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from fmdm_tpu_torch.parallel.sequence import ring_attention  # noqa: E402
from fmdm_tpu_torch.schedulers import DDPMScheduler  # noqa: E402
from fmdm_tpu_torch.train.common import (DenoiseTrainStep, local_tensor,  # noqa: E402
                                         make_adamw, make_denoise_train_step, parallel_plan,
                                         state_bytes)
from fmdm_tpu_torch.train.vae_impl import VAETrainStep  # noqa: E402
from fmdm_tpu_torch.utils.weights import load_jax_params  # noqa: E402

LR = 1e-4
N_TRAIN = 50
KL_SCALE = 1e-2
ROWS = 4   # the global batch
UNET = {"unet_impl": "diffusers_nd", "sample_size": 16, "in_channels": 1, "out_channels": 1,
        "layers_per_block": 1, "block_out_channels": [16, 32], "norm_num_groups": 8,
        "down_block_types": ["DownBlock2D", "AttnDownBlock2D"],
        "up_block_types": ["AttnUpBlock2D", "UpBlock2D"]}
# the KL-VAE's topology in two 64-wide stages (mid attention at 8² = 64
# tokens) and its PatchGAN head (BatchNorm)
VAE = {"in_channels": 1, "out_channels": 1, "resolution": 16, "base_ch": 64,
       "down_channels": [64, 64], "num_res_blocks": 1, "attn_resolutions": [],
       "z_channels": 4, "embed_dim": 4, "dropout": 0.0, "use_attention": True,
       "spatial_dims": 2, "double_z": True, "attn_heads": 2, "attn_dim_head": 8,
       "latent_type": "kl", "model_type": "vae"}
VAE_STEP = {"learning_rate": LR, "weight_decay": 0.0, "epochs": 2, "kl_weight": 1e-2,
            "recon_type": "l1", "gan_weight": 0.5, "gan_start": 0, "disc_lr": 2e-4, "seed": 4}
MIN_TOKENS = 16   # the attention calls of both models (64 tokens) take the ring
TIMEOUT = 240   # seconds for a cluster; FMDM_DIST_TIMEOUT bounds each collective
STRATEGIES = {"sp": {"sequence_parallel": 2, "sequence_parallel_min_tokens": MIN_TOKENS},
              "fsdp": {"fsdp": True}, "tp": {"tensor_parallel": 2},
              "tp_fsdp": {"tensor_parallel": 2, "fsdp": True}, "dp": {}}


def rank() -> int:
    return mesh_lib.process_index()


def whole(plan, model) -> dict:
    """Every parameter's gradient whole (a collective)."""
    return {name: plan.whole(model, name, p.grad).detach().clone()
            for name, p in model.named_parameters() if p.grad is not None}


def params_whole(plan, model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in plan.full_model_state(model).items()}


def placements(model) -> dict:
    """name -> (FSDP's shard dim or None, this rank's shape)."""
    out = {}
    for name, p in model.named_parameters():
        dim = None
        if hasattr(p, "placements"):
            dim = next((pl.dim for pl in p.placements if hasattr(pl, "dim")), None)
        out[name] = (dim, tuple(local_tensor(p).shape))
    return out


def my_rows(plan, n: int = ROWS) -> slice:
    index, count = plan.rows
    per = n // count
    return slice(index * per, (index + 1) * per)


def denoise_step(weights, mesh=None):
    model = DiffusionUNetFactory().build(dict(UNET), "concatenate", 1, device="cpu")
    model.load_state_dict(weights)
    optimizer, schedule = make_adamw(model.parameters(), LR, 1e-2, 0, 10)
    step = make_denoise_train_step(
        model, DDPMScheduler.create(num_train_timesteps=N_TRAIN), optimizer, schedule,
        variant="diffusion", conditioning_mode="concatenate", latent_norm=None, ema_decay=0.9,
        device="cpu", mesh=mesh)
    return model, step


def run_denoise(kind: str, inputs: dict, profile: bool = False) -> dict:
    """One denoise step under ``kind`` on this rank's rows of JAX's draws."""
    d = inputs["denoise"]
    plan = parallel_plan(dict(STRATEGIES[kind]), 2, torch.device("cpu"))
    try:
        model, step = denoise_step(d["weights"], plan.batch_mesh)
        step.reduce_grads = plan.reduce_grads
        (step.optimizer,), (step.ema,) = plan.shard([model], [step.optimizer], [step.ema])
        rows = my_rows(plan)
        batch = {k: d[k][rows] for k in ("target", "image", "valid")}
        if profile:
            from torch.profiler import ProfilerActivity, profile as prof_ctx

            from fmdm_tpu_torch.parallel.collective_stats import parse_collectives, trace_events

            with prof_ctx(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
                step.step(batch, noise=d["noise"][rows], t=d["t"][rows])
            events = trace_events(prof)
            return {"collectives": parse_collectives(events),
                    "hops": sum(1 for e in events if e.get("name") == "ring hop"),
                    "param_bytes": sum(local_tensor(p).numel() * 4 for p in model.parameters()),
                    "rings": sum(1 for e in events if e.get("name") == "ring attention")}
        loss_sum, count = step.step(batch, noise=d["noise"][rows], t=d["t"][rows])
        return {"grads": whole(plan, model), "params": params_whole(plan, model),
                "ema": plan.full_ema(model, step.ema), "loss_sum": float(loss_sum),
                "count": float(count), "placements": placements(model),
                "bytes": state_bytes(model, step.optimizer), "rows": [rows.start, rows.stop]}
    finally:
        attention_ops.clear_sequence_parallel()


def run_vae(kind: str, inputs: dict) -> dict:
    """One KL-VAE + GAN step under ``kind`` on this rank's rows."""
    v = inputs["vae"]
    plan = parallel_plan(dict(STRATEGIES[kind]), 2, torch.device("cpu"), vae=True)
    try:
        model = load_jax_params(VAEFactory().build(dict(VAE), device="cpu"), v["weights"])
        trainer = VAETrainStep(model, VAE_STEP, mesh=plan.batch_mesh)
        load_jax_params(trainer.discriminator, v["disc_weights"])
        trainer.shard(plan)
        rows = my_rows(plan)
        sums, count = trainer.step(v["raw"][rows], v["valid"][rows], noise=v["noise"][rows],
                                   kl_scale=KL_SCALE, disc_active=True)
        disc = trainer.discriminator
        return {"grads": whole(plan, model), "disc_grads": whole(plan, disc),
                "params": params_whole(plan, model), "disc_params": params_whole(plan, disc),
                "metrics": {k: float(x) for k, x in sums.items()}, "count": float(count),
                "placements": placements(model), "disc_placements": placements(disc),
                "bytes": state_bytes(model, trainer.optimizer)
                + state_bytes(disc, trainer.disc_optimizer)}
    finally:
        attention_ops.clear_sequence_parallel()


def one_process(inputs: dict) -> dict:
    """The steps of one process on the global batch, on the same draws."""
    d, v = inputs["denoise"], inputs["vae"]
    model, step = denoise_step(d["weights"])
    loss_sum, count = step.step({k: d[k] for k in ("target", "image", "valid")},
                                noise=d["noise"], t=d["t"])
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    out = {"denoise": {"grads": grads, "params": {k: t.clone() for k, t in
                                                  model.state_dict().items()},
                       "ema": step.ema_state_dict(), "loss_sum": float(loss_sum),
                       "count": float(count)}}
    model = load_jax_params(VAEFactory().build(dict(VAE), device="cpu"), v["weights"])
    trainer = VAETrainStep(model, VAE_STEP)
    load_jax_params(trainer.discriminator, v["disc_weights"])
    sums, count = trainer.step(v["raw"], v["valid"], noise=v["noise"], kl_scale=KL_SCALE,
                               disc_active=True)
    disc = trainer.discriminator
    out["vae"] = {"grads": {n: p.grad.clone() for n, p in model.named_parameters()},
                  "disc_grads": {n: p.grad.clone() for n, p in disc.named_parameters()
                                 if p.grad is not None},
                  "params": {k: t.clone() for k, t in model.state_dict().items()},
                  "disc_params": {k: t.clone() for k, t in disc.state_dict().items()},
                  "metrics": {k: float(x) for k, x in sums.items()}, "count": float(count)}
    return out


def gather_tokens(x: torch.Tensor, group, n: int) -> torch.Tensor:
    from fmdm_tpu_torch.parallel.tp import _gather

    return _gather(x.detach().float(), x.dim() - 2, group, n)


def run_rings(inputs: dict) -> dict:
    """The rank form of the ring on each case: out, dq, dk, dv whole."""
    mesh = mesh_lib.create_dp_sp_mesh_global(2, 2, "cpu")
    group, n, me = mesh.group("seq"), 2, mesh.coordinate("seq")
    out = {}
    for name, case in inputs["rings"].items():
        dtype = torch.bfloat16 if case["dtype"] == "bf16" else torch.float32
        shard = lambda x: x.chunk(n, dim=-2)[me].to(dtype).contiguous().requires_grad_()
        q, k, v = (shard(case[key]) for key in ("q", "k", "v"))
        o = ring_attention(q, k, v, group=group, impl=case["impl"])
        o.backward(case["g"].chunk(n, dim=-2)[me].to(dtype))
        out[name] = {key: gather_tokens(t, group, n)
                     for key, t in (("out", o), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad))}
    return out


def run_routing(inputs: dict) -> dict:
    """``sdpa`` under a rank mesh's context: each rank's rows through the
    all-to-all, the ring and back; the output and q's gradient."""
    r = inputs["routing"]
    mesh = mesh_lib.create_dp_sp_mesh_global(2, 2, "cpu")
    per = r["q"].shape[0] // 2
    rows = slice(rank() * per, (rank() + 1) * per)
    q = r["q"][rows].clone().requires_grad_()
    attention_ops.set_sequence_parallel(mesh, "seq", min_tokens=MIN_TOKENS)
    try:
        out = attention_ops.sdpa(q, r["k"][rows], r["v"][rows])
        out.backward(r["g"][rows])
        # fewer tokens than min_tokens: the local path
        short = attention_ops.sdpa(q[..., :8, :], q[..., :8, :], q[..., :8, :])
    finally:
        attention_ops.clear_sequence_parallel()
    group = mesh.group("seq")
    from fmdm_tpu_torch.parallel.tp import _gather

    return {"out": _gather(out.detach(), 0, group, 2), "dq": _gather(q.grad, 0, group, 2),
            "short": _gather(short.detach(), 0, group, 2)}


def run_train(kind: str, vae: bool, out_dir: Path, epochs: int = 1, name: str = "",
              resume: str = None) -> dict:
    """``train()`` under ``kind`` over the synthetic LDCT root, ``epochs``
    epochs into ``out_dir/<model>/<kind><name>`` (or continuing the run dir
    of the checkpoint ``resume``)."""
    from fmdm_tpu_torch.train import denoise_lib, vae_impl
    from fmdm_tpu_torch.train.__main__ import build_train_val_datasets

    model = "vae" if vae else "ddpm"
    cfg = json.loads(Path(os.environ["FMDM_PAR_CONFIGS"]).read_text())[model]
    output = Path(resume).parent if resume else out_dir / model / f"{kind}{name}"
    cfg["training"].update(STRATEGIES[kind], output_dir=str(output),
                           **{"epochs" if vae else "num_epochs": epochs})
    path = out_dir / f"cfg_{model}_{kind}{name}_{epochs}_{rank()}.json"
    path.write_text(json.dumps(cfg))
    train_ds, val_ds = build_train_val_datasets(cfg)
    trials = []
    step_cls = VAETrainStep if vae else DenoiseTrainStep
    real_trial = step_cls.trial

    def counted_trial(self, *args, **kwargs):
        trials.append(self)
        return real_trial(self, *args, **kwargs)

    with mock.patch.object(step_cls, "trial", counted_trial):
        if vae:
            run = vae_impl.train(train_ds, path, val_dataset=val_ds, resume=resume, device="cpu")
        else:
            run = denoise_lib.train(train_ds, path, val_dataset=val_ds, resume=resume,
                                    variant="diffusion", device="cpu")
    return {"run": str(run), "context_after": attention_ops.get_sequence_parallel() is not None,
            "trials": len(trials)}


def run_cluster(mode: str, nproc: int, tmp: Path, inputs: dict, jax_steps, **extra):
    """Start the ranks of ``mode``, run JAX's steps meanwhile, and return
    (rank 0's results, JAX's steps)."""
    import socket
    import subprocess

    torch.save(inputs, tmp / "inputs.pt")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(CUDA_VISIBLE_DEVICES="", FMDM_DIST_TIMEOUT="60", OMP_NUM_THREADS="2",
               WORLD_SIZE=str(nproc), LOCAL_WORLD_SIZE=str(nproc), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=port, FMDM_PAR_MODE=mode, FMDM_PAR_INPUTS=str(tmp / "inputs.pt"),
               FMDM_PAR_OUT=str(tmp), **extra)
    procs = [subprocess.Popen([sys.executable, __file__], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(nproc)]
    outs = []
    try:
        want = jax_steps() if jax_steps is not None else None
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return torch.load(tmp / "result.pt", weights_only=False), want


def main() -> None:
    torch.set_num_threads(2)
    mesh_lib.maybe_initialize_distributed("cpu")
    mode = os.environ["FMDM_PAR_MODE"]
    inputs = torch.load(os.environ["FMDM_PAR_INPUTS"], weights_only=False)
    out_dir = Path(os.environ["FMDM_PAR_OUT"])
    result = {"world": mesh_lib.process_count()}
    if mode == "seq":
        result["rings"] = run_rings(inputs)
        result["routing"] = run_routing(inputs)
        result["denoise"] = {"sp": run_denoise("sp", inputs)}
        result["vae"] = {"sp": run_vae("sp", inputs)}
        result["train"] = {f"{'vae' if vae else 'ddpm'}_sp": run_train("sp", vae, out_dir)
                           for vae in (False, True)}
        if rank() == 0:
            result["one_process"] = one_process(inputs)
    elif mode == "fsdp_tp":
        result["denoise"] = {k: run_denoise(k, inputs) for k in ("fsdp", "tp", "tp_fsdp")}
        result["vae"] = {k: run_vae(k, inputs) for k in ("fsdp", "tp")}
        result["train"] = {f"{'vae' if vae else 'ddpm'}_{k}": run_train(k, vae, out_dir)
                           for k in ("fsdp", "tp", "tp_fsdp") for vae in (False, True)
                           if not (vae and k == "tp_fsdp")}
        # two epochs straight, and the one-epoch run resumed for a second:
        # the whole state is cut from the checkpoint's and gathered back
        one = Path(result["train"]["ddpm_tp_fsdp"]["run"])
        result["resume"] = {
            "straight": run_train("tp_fsdp", False, out_dir, epochs=2, name="_straight"),
            "resumed": run_train("tp_fsdp", False, out_dir, epochs=2,
                                 resume=str(one / "diff_last.pt"))}
        if rank() == 0:
            result["one_process"] = one_process(inputs)
    else:
        result["collectives"] = {k: run_denoise(k, inputs, profile=True)
                                 for k in ("dp", "fsdp", "tp", "sp")}
    me = rank()
    mesh_lib.destroy_distributed()
    if me == 0:
        torch.save(result, out_dir / "result.pt")
    print("DONE", me, flush=True)


if __name__ == "__main__":
    main()
