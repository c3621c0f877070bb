"""
The trainer of DDPM diffusion and flow matching (counterpart of
``fmdm_tpu/train/denoise_lib.py``): the config's set-up
(:func:`build_denoise_trainer`), the run loop (:func:`train`) and visuals
from a checkpoint (:func:`debug_visual_only`).

    run_dir = train(dataset, "configs/LDCT/LDCT_ddpm_diffusers_nd.json", val_dataset=val)
    train(dataset, cfg_path, resume="RUN/diff_last.pt")   # training.output_dir = RUN

The run dir is the JAX package's: ``train_config.json`` (written once),
``metrics.csv`` (``epoch,train_loss``), ``{diff|flow}_last.pt`` every
``checkpoint_every_epochs`` and at the last epoch, with ``{prefix}_best.pt``
and ``epochs/epochXXXX/epoch.pt`` as hardlink mirrors of it ("best" is
judged at checkpoint granularity), and
``visuals/epochXXXX_{input,output,target}.png`` (``.npy`` without Pillow),
decoded from the EMA weights when ``ema_decay`` is set. A resumed run
(``resume``, or ``training.resume`` unless it is "none") restores the
model, the optimizer (the port's own state or the JAX package's
``optax.adamw`` state) and with it the learning rate's step, the EMA (or a
copy of the live weights when the checkpoint has none), the epoch and
``best_metric``.

The loop moves each host batch to the device once, keeps one step in
flight (the loss of step i is read while step i + 1 runs), and draws each
step's noise and t from a ``torch.Generator`` on the device seeded with
``seed + 17`` (the JAX package's ``PRNGKey(seed + 17)``). That generator's
state goes into every checkpoint (``rng_state``), so a resumed run draws
what the uninterrupted run would have (the JAX package restarts its key);
a checkpoint without it starts the generator from its seed. The visuals of
epoch ``e`` draw from a generator of their own, seeded with
``(seed + 17) * 100003 + e``. ``training.profile_dir`` traces the first
epoch with ``torch.profiler`` into a Chrome trace there.
``training.checkpoint_backend`` selects the checkpoints' backend
(``utils/checkpoint.py``); pending async writes are flushed before a resume
reads a checkpoint and when the run ends.

Under ``torchrun`` (one rank per card, ``parallel/mesh.py``) the ranks train
one model on the global batch: rank 0 allocates the run dir and every rank
adopts it; each rank reads its stride of the epoch's order; the step's loss,
count and gradients are the global batch's, so every rank logs the same
epoch loss and takes the same "best" decision; only rank 0 writes the
checkpoints, ``metrics.csv``, the visuals and the progress bar. The
optimizer takes ``epochs * ceil(ceil(N / P) / batch_size)`` steps.

``training.sequence_parallel``, ``tensor_parallel`` (with or without
``fsdp``) and ``fsdp`` choose the strategy (``train/common.py``'s
:func:`parallel_plan`, JAX :132-188): the step is the same global-batch
step under each. Under tensor parallelism the P / tp ranks of a ``model``
line share their rows, so the global batch is (P / tp) * batch_size and N
is strided over P / tp. With the model cut (tensor parallelism, FSDP) every
rank gathers the checkpoint's state whole and rank 0 writes it, and the
visuals decode on rank 0 from a whole copy. The routing that
``sequence_parallel`` installs is cleared when :func:`train` returns.
"""

from __future__ import annotations

import contextlib
import logging
import math
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fmdm_tpu_torch.device import DeviceArg, resolve_device
from fmdm_tpu_torch.models.factories import DiffusionUNetFactory
from fmdm_tpu_torch.nn.layers import init_weights
from fmdm_tpu_torch.ops import attention as attention_ops
from fmdm_tpu_torch.parallel import mesh as mesh_lib
from fmdm_tpu_torch.sample.diffusion_utils import (
    build_diffusion_model,
    decode_diffusion_batch,
    prepare_diffusion_visual_batch,
)
from fmdm_tpu_torch.schedulers.base import Scheduler
from fmdm_tpu_torch.schedulers.registry import build_scheduler, resolve_conditioning_mode
from fmdm_tpu_torch.train.common import (
    LOG_FORMAT,
    VARIANTS,
    DenoiseTrainStep,
    batch_to_device,
    generator_state,
    host_batches,
    make_adamw,
    make_denoise_train_step,
    parallel_plan,
    profile_epoch,
    restore_generator,
    resume_path,
    run_dir_for,
    state_bytes,
    steps_per_epoch,
    tune_grad_accum,
    weights_swapped,
    with_progress,
)
from fmdm_tpu_torch.utils import checkpoint as ckpt_utils
from fmdm_tpu_torch.utils import config as config_utils
from fmdm_tpu_torch.utils.evaluation import make_grid, save_image, select_visual_indices
from fmdm_tpu_torch.utils.summary import summarize_model

PREFIXES = {"diffusion": "diff", "flow_matching": "flow"}
CONDITIONED = ("concatenate", "attention")


def build_denoise_trainer(cfg: Dict[str, Any], *, variant: str, num_samples: int,
                          device: DeviceArg = None, mesh: Optional[mesh_lib.DataMesh] = None
                          ) -> Tuple[torch.nn.Module, Scheduler, DenoiseTrainStep]:
    """(model, scheduler, train step) of a ``{training, model}`` config for
    ``variant`` ("diffusion" or "flow_matching") over a dataset of
    ``num_samples``, on ``device`` (CUDA by default), over the ranks of
    ``mesh`` when it spans them. The UNet's weights are drawn from
    ``training.seed`` (rank 0's on every rank); the optimizer is AdamW at the
    cosine-warmup rate over ``epochs * ceil(num_samples / batch_size)``
    steps, where ``num_samples`` is one rank's share."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}; got '{variant}'")
    device = resolve_device(device)
    if "model" not in cfg:
        raise ValueError("Config does not declare a 'model' section.")
    model_block = cfg["model"]
    model_type = str(model_block.get("model_type", "")).lower()
    if model_type != variant:
        raise ValueError(f"Expected model_type '{variant}', got '{model_type}'.")
    training_cfg = cfg["training"]

    batch_size = training_cfg.get("train_batch_size")
    batch_size = int(training_cfg.get("batch_size", 4) if batch_size is None else batch_size)
    epochs = int(training_cfg.get("num_epochs", training_cfg.get("epochs", 1)))
    conditioning_mode = resolve_conditioning_mode(
        training_cfg.get("conditioning") or model_block.get("conditioning"))
    mixed = str(training_cfg.get("mixed_precision", "no")).lower()
    compute_dtype = torch.bfloat16 if mixed in {"fp16", "bf16", "true"} else torch.float32

    unet_cfg = model_block.get("unet", {})
    channels = int(training_cfg.get("channels", unet_cfg.get("out_channels", 1)))
    model = DiffusionUNetFactory().build(unet_cfg, conditioning_mode, channels, device=device)
    init_weights(model, torch.Generator().manual_seed(int(training_cfg.get("seed") or 0)))
    mesh_lib.replicate(mesh, model)
    scheduler, _ = build_scheduler(model_block.get("scheduler", {}), training_cfg)

    num_train_steps = epochs * math.ceil(num_samples / batch_size)
    optimizer, schedule = make_adamw(
        model.parameters(), float(training_cfg.get("learning_rate", 1e-4)),
        float(training_cfg.get("weight_decay", 0.0)),
        int(training_cfg.get("lr_warmup_steps", 500)), num_train_steps)
    step = make_denoise_train_step(
        model, scheduler, optimizer, schedule, variant=variant,
        conditioning_mode=conditioning_mode, latent_norm=training_cfg.get("latent_norm"),
        grad_accum=max(1, int(training_cfg.get("gradient_accumulation_steps", 1))),
        compute_dtype=compute_dtype, remat=bool(training_cfg.get("remat", False)),
        ema_decay=float(training_cfg.get("ema_decay", 0.0) or 0.0), device=device, mesh=mesh,
        t_sampling=training_cfg.get("t_sampling", "uniform"),
        timestep_input=training_cfg.get("timestep_input", "discrete"))
    return model, scheduler, step


def _probe_batch(dataset, batch_size: int, conditioned: bool) -> Dict[str, np.ndarray]:
    """A full batch of copies of the first sample, for the start-up trial."""
    sample = dataset[0]
    probe = {"target": np.stack([np.asarray(sample["target"], np.float32)] * batch_size),
             "image": None, "valid": np.ones((batch_size,), np.float32)}
    if conditioned and sample.get("image") is not None:
        probe["image"] = np.stack([np.asarray(sample["image"], np.float32)] * batch_size)
    return probe


def _save_visuals(vis: np.ndarray, inputs: np.ndarray, targets: np.ndarray,
                  paths: Sequence[Path]) -> None:
    rows = max(1, int(math.sqrt(vis.shape[0])))
    cols = max(1, vis.shape[0] // rows)
    for array, path in zip((inputs, vis, targets), paths):
        save_image(make_grid(array, rows, cols), path)


# ---------------------------------------------------------------------------
# The run loop
# ---------------------------------------------------------------------------

def train(dataset, json_path, val_dataset=None, resume: Optional[str] = None, *,
          variant: str = "diffusion", max_steps_per_epoch: Optional[int] = None,
          device: DeviceArg = None) -> Path:
    """Train ``variant`` from the config at ``json_path`` on ``dataset``
    (visuals from ``val_dataset`` when given) on ``device`` (CUDA by
    default); returns the run dir."""
    try:
        return _train(dataset, json_path, val_dataset, resume, variant=variant,
                      max_steps_per_epoch=max_steps_per_epoch, device=device)
    finally:
        # sequence_parallel's routing is bound to the training mesh
        attention_ops.clear_sequence_parallel()


def _train(dataset, json_path, val_dataset, resume, *, variant: str,
           max_steps_per_epoch: Optional[int], device: DeviceArg) -> Path:
    prefix = PREFIXES[variant]
    logging.basicConfig(level=logging.INFO, format=LOG_FORMAT, force=True)
    cfg = config_utils.load_json_config(json_path)
    if "model" not in cfg:
        raise ValueError("Config does not declare a 'model' section.")
    model_block = cfg["model"]
    model_type = str(model_block.get("model_type", "")).lower()
    if model_type != variant:
        raise ValueError(f"Expected model_type '{variant}', got '{model_type}'.")
    training_cfg = cfg["training"]
    mesh_lib.maybe_initialize_distributed(device)
    device = mesh_lib.rank_device(device) if mesh_lib.group_active() else resolve_device(device)
    main = mesh_lib.is_main_process()
    logging.info("%s on %s", mesh_lib.describe_group(), device)
    ckpt_utils.set_checkpoint_backend(str(training_cfg.get("checkpoint_backend", "torch")))
    config_utils.set_seed(training_cfg.get("seed"))
    seed = int(training_cfg.get("seed") or 0)

    batch_size = config_utils.resolve_batch_size(training_cfg, "train_batch_size",
                                                 training_cfg.get("batch_size", 4))
    epochs = int(training_cfg.get("num_epochs", training_cfg.get("epochs", 1)))
    save_model_epochs = int(training_cfg.get("save_model_epochs", training_cfg.get("save_every", 5)))
    checkpoint_every = int(training_cfg.get("checkpoint_every_epochs", 1))
    if checkpoint_every > 1 and save_model_epochs % checkpoint_every != 0:
        logging.warning(
            "save_model_epochs=%d is finer than checkpoint_every_epochs=%d: "
            "epoch snapshots are only written on gather epochs (every %d), so "
            "off-cadence snapshots will be skipped.",
            save_model_epochs, checkpoint_every, checkpoint_every,
        )
    ema_decay = float(training_cfg.get("ema_decay", 0.0) or 0.0)
    output_dir = run_dir_for(training_cfg, cfg, f"checkpoints/{variant}", resume)

    plan = parallel_plan(training_cfg, batch_size, device)
    mesh = plan.world
    start = time.perf_counter()
    model, _, trainer = build_denoise_trainer(
        cfg, variant=variant, num_samples=math.ceil(len(dataset) / plan.rows[1]),
        device=device, mesh=plan.batch_mesh)
    trainer.reduce_grads = plan.reduce_grads
    logging.info("Built the %s model on %s in %.3f s", variant, device, time.perf_counter() - start)
    if main:
        summarize_model(model, model_block, training_cfg, name=variant)
    conditioned = trainer.conditioning_mode in CONDITIONED

    probe = _probe_batch(dataset, batch_size, conditioned)

    def _build_step(accum: int) -> DenoiseTrainStep:
        trainer.grad_accum = accum
        return trainer

    def _trial(step: DenoiseTrainStep, _accum: int) -> None:
        # a generator of its own: the loop's draws are untouched; the whole
        # model, no ring
        with attention_ops.sequence_parallel_scope(None):
            step.trial(batch_to_device(probe, device), torch.Generator(device).manual_seed(0))

    trainer = tune_grad_accum(
        plan, _build_step, _trial, batch_size=batch_size, grad_accum=trainer.grad_accum,
        allow_microbatching=bool(training_cfg.get("allow_microbatching", True)),
        what=f"{variant} train step")

    visual_enabled = bool(training_cfg.get("save_images", False)) and main
    visual_every = int(training_cfg.get("save_images_every", 10))
    visual_targets = visual_cond = None
    if visual_enabled:
        eval_source = val_dataset if val_dataset is not None else dataset
        visual_targets, visual_cond = prepare_diffusion_visual_batch(
            eval_source, int(training_cfg.get("visual_samples", 8)), seed=training_cfg.get("seed"))
        if conditioned and visual_cond is None:
            logging.warning("%s config requested conditioning but dataset samples did not "
                            "expose 'image'.", variant.capitalize())

    metrics_path = output_dir / "metrics.csv"
    if main and not metrics_path.exists():
        metrics_path.write_text("epoch,train_loss\n")

    generator = torch.Generator(device).manual_seed(seed + 17)
    start_epoch, best_metric = 1, float("inf")
    resume_flag = resume_path(resume, training_cfg)
    if resume_flag:
        ckpt_utils.flush_checkpoint_writes()
        payload = ckpt_utils.load_checkpoint(resume_flag)
        model.load_state_dict(payload["model"], strict=True)
        if payload.get("optimizer") is not None:
            trainer.global_step = ckpt_utils.load_optimizer_state(
                trainer.optimizer, payload["optimizer"], model)
        if ema_decay:
            ema_tree = payload.get("ema")
            trainer.ema = [
                (ema_tree[name].to(p.device, p.dtype) if ema_tree is not None else p.detach()).clone()
                for name, p in model.named_parameters()]
        restore_generator(generator, payload.get("rng_state"))
        start_epoch = int(payload.get("epoch", 0)) + 1
        best_metric = float(payload.get("best_metric", float("inf")))
        logging.info("Resumed from %s at epoch %d (optimizer step %d)", resume_flag, start_epoch,
                     trainer.global_step)
    (trainer.optimizer,), (trainer.ema,) = plan.shard([model], [trainer.optimizer], [trainer.ema])
    if plan.sharded:
        logging.info("Parallel strategy %s: %d bytes of parameters and optimizer state on this "
                     "rank", plan.kind, state_bytes(model, trainer.optimizer))

    n_batches = steps_per_epoch(len(dataset), batch_size, plan.rows[1])
    for epoch in range(start_epoch, epochs + 1):
        epoch_loss, num_samples, n_steps, data_wait = 0.0, 0, 0, 0.0
        t0 = time.perf_counter()
        pending: List[Tuple[torch.Tensor, torch.Tensor]] = []

        def _drain_one() -> None:
            nonlocal epoch_loss, num_samples
            ls, ct = pending.pop(0)
            epoch_loss += float(ls)
            num_samples += int(ct)

        with profile_epoch(training_cfg.get("profile_dir") if epoch == start_epoch else None,
                           device):
            batch_iter = with_progress(
                host_batches(dataset, batch_size, training_cfg, seed=seed, epoch=epoch,
                             device=device, rows=plan.rows), n_batches, f"Train {epoch}/{epochs}")
            batches = iter(batch_iter)
            while True:
                t_wait = time.perf_counter()
                batch = next(batches, None)
                data_wait += time.perf_counter() - t_wait
                if batch is None:
                    break
                if not conditioned:
                    batch = dict(batch, image=None)
                loss_sum, count = trainer.step(batch_to_device(batch, device), generator=generator)
                # one step in flight: read step i - 1's loss while step i runs
                pending.append((loss_sum, count))
                if len(pending) > 1:
                    _drain_one()
                n_steps += 1
                if hasattr(batch_iter, "set_postfix"):
                    batch_iter.set_postfix(loss=f"{epoch_loss / max(num_samples, 1):.4f}")
                if max_steps_per_epoch is not None and n_steps >= max_steps_per_epoch:
                    break
            while pending:
                _drain_one()
        steps_s = time.perf_counter() - t0

        avg_loss = epoch_loss / max(num_samples, 1)
        logging.info("%s Epoch %03d | loss %.6f | %.3f samples/s", variant.capitalize(), epoch,
                     avg_loss, num_samples / max(steps_s, 1e-9))

        ckpt_s = vis_s = 0.0
        saving = epoch % checkpoint_every == 0 or epoch == epochs
        # with the model cut, every rank gathers its part of the state
        model_state = plan.full_model_state(model) if saving else None
        optimizer_state = plan.full_optimizer_state(model, trainer.optimizer) if saving else None
        ema_state = plan.full_ema(model, trainer.ema) if saving and ema_decay else None
        if main and saving:
            # "best" at checkpoint granularity: an unsaved epoch never lowers it
            improved = avg_loss < best_metric
            best_metric = min(best_metric, avg_loss)
            state = {"model": model_state, "optimizer": optimizer_state,
                     "lr_scheduler": {"last_epoch": epoch}, "scaler": None, "epoch": epoch,
                     "best_metric": best_metric, "rng_state": generator_state(generator)}
            if ema_decay:
                state["ema"] = ema_state
            mirrors = []
            if improved:
                mirrors.append(output_dir / f"{prefix}_best.pt")
            if epoch % save_model_epochs == 0 or epoch == epochs:
                mirrors.append(output_dir / "epochs" / f"epoch{epoch:04d}" / "epoch.pt")
            t_ckpt = time.perf_counter()
            ckpt_utils.save_checkpoint_with_mirrors(state, output_dir / f"{prefix}_last.pt", mirrors)
            ckpt_s = time.perf_counter() - t_ckpt
            if improved:
                logging.info("New best %s loss %.6f -> %s", variant, best_metric,
                             output_dir / f"{prefix}_best.pt")

        visual_epoch = epoch % visual_every == 0 or epoch == epochs
        vis_model, vis_ema = model, trainer.ema
        if plan.sharded and bool(training_cfg.get("save_images", False)) and visual_epoch:
            # rank 0 decodes alone, from a whole copy every rank gathers
            whole, whole_ema = plan.full_model_state(model), (
                plan.full_ema(model, trainer.ema) if ema_decay else None)
            if main:
                vis_model = build_diffusion_model(cfg, device=device)
                vis_model.load_state_dict(whole)
                vis_ema = [whole_ema[n].to(device) for n, _ in vis_model.named_parameters()] \
                    if ema_decay else None
        if visual_targets is not None and visual_epoch:
            t_vis = time.perf_counter()
            vis_gen = torch.Generator(device).manual_seed((seed + 17) * 100003 + epoch)
            with weights_swapped(vis_model, vis_ema) if ema_decay else contextlib.nullcontext():
                outputs = decode_diffusion_batch(
                    vis_model, training_cfg, model_block, tuple(visual_targets.shape),
                    visual_cond if conditioned else None, generator=vis_gen, device=device)
            vis = np.clip(outputs.cpu().numpy(), 0.0, 1.0)
            targets = visual_targets.numpy()
            inputs = visual_cond.numpy() if visual_cond is not None else targets
            _save_visuals(vis, inputs, targets,
                          [output_dir / "visuals" / f"epoch{epoch:04d}_{kind}.png"
                           for kind in ("input", "output", "target")])
            vis_s = time.perf_counter() - t_vis

        if main:
            with metrics_path.open("a") as handle:
                handle.write(f"{epoch},{avg_loss:.6f}\n")
        logging.info("Epoch %03d timing | %d steps in %.3f s (%.3f s waiting for data) | "
                     "checkpoint %.3f s | visuals %.3f s | optimizer step %d", epoch, n_steps,
                     steps_s, data_wait, ckpt_s, vis_s, trainer.global_step)
    ckpt_utils.flush_checkpoint_writes()
    mesh_lib.agree_max(0, mesh)  # no rank returns before rank 0's writes landed
    return output_dir


def debug_visual_only(dataset, json_path, ckpt_path, *, output_dir=None,
                      visual_samples: int = 10, seed: Optional[int] = None,
                      variant: str = "diffusion", device: DeviceArg = None) -> Path:
    """Load a checkpoint and write the train loop's visuals only, with each
    sample's target, output and conditioning through the dataset's writer;
    the draws come from a generator on ``device`` seeded with ``seed``."""
    from fmdm_tpu_torch.data.dataset_utils import save_output_tensor

    logging.basicConfig(level=logging.INFO, format=LOG_FORMAT, force=True)
    cfg = config_utils.load_json_config(json_path)
    model_block = cfg.get("model")
    if model_block is None:
        raise ValueError("Config does not declare a 'model' section.")
    if str(model_block.get("model_type", "")).lower() != variant:
        raise ValueError(f"Expected model_type '{variant}'.")
    device = resolve_device(device)
    training_cfg = cfg["training"]
    conditioned = resolve_conditioning_mode(
        training_cfg.get("conditioning") or model_block.get("conditioning")) in CONDITIONED
    use_seed = seed if seed is not None else training_cfg.get("seed")
    config_utils.set_seed(use_seed)

    model = build_diffusion_model(cfg, ckpt_path=Path(ckpt_path), device=device)
    output_root = Path(output_dir) if output_dir is not None else (
        Path(training_cfg.get("output_dir", f"checkpoints/{variant}")) / "debug_train_like")
    output_root.mkdir(parents=True, exist_ok=True)

    indices = select_visual_indices_list(dataset, int(visual_samples), use_seed)
    visual_targets, visual_cond = prepare_diffusion_visual_batch(dataset, int(visual_samples),
                                                                 seed=use_seed)
    if conditioned and visual_cond is None:
        logging.warning("Config requested conditioning but dataset samples did not expose 'image'.")
    outputs = decode_diffusion_batch(
        model, training_cfg, model_block, tuple(visual_targets.shape),
        visual_cond if conditioned else None,
        generator=torch.Generator(device).manual_seed(int(use_seed or 0)), device=device)
    vis = np.clip(outputs.cpu().numpy(), 0.0, 1.0)
    targets = visual_targets.numpy()
    cond = visual_cond.numpy() if visual_cond is not None else None
    _save_visuals(vis, cond if cond is not None else targets, targets,
                  [output_root / f"grid_{kind}.png" for kind in ("input", "output", "target")])

    for b, idx in enumerate(indices):
        row = dataset.data[idx] if hasattr(dataset, "data") else None
        if row is None:
            break
        save_output_tensor(dataset, row, dataset.target_key, targets[b], output_root / "target")
        save_output_tensor(dataset, row, dataset.target_key, vis[b], output_root / "generated")
        if getattr(dataset, "conditioning_key", None) is not None and cond is not None:
            save_output_tensor(dataset, row, dataset.conditioning_key, cond[b],
                               output_root / "conditioning")

    logging.info("Debug visual-only generation completed for %d samples. Output: %s",
                 len(indices), output_root)
    print(f"Debug visual-only generation completed for {len(indices)} samples.")
    print(f"Output directory: {output_root}")
    return output_root


def select_visual_indices_list(dataset, count, seed):
    return select_visual_indices(dataset, count, seed=seed)
