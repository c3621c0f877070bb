"""
Set-up of the denoising trainer for DDPM diffusion and flow matching
(counterpart of the set-up in ``fmdm_tpu/train/denoise_lib.py:62-215``): the
config's ``training`` and ``model`` sections resolved into the UNet, its
scheduler and its train step.

    model, scheduler, step = build_denoise_trainer(cfg, variant="diffusion",
                                                   num_samples=len(dataset))
    loss_sum, count = step.step({"target": x0, "image": cond, "valid": valid},
                                generator=gen)

The run loop (run directories, CSVs, checkpoints, visuals, resume) and the
data layer are not ported yet; nor are FSDP, tensor and sequence
parallelism, which raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from fmdm_tpu_torch.device import DeviceArg, resolve_device
from fmdm_tpu_torch.models.factories import DiffusionUNetFactory
from fmdm_tpu_torch.nn.layers import init_weights
from fmdm_tpu_torch.schedulers.base import Scheduler
from fmdm_tpu_torch.schedulers.registry import build_scheduler, resolve_conditioning_mode
from fmdm_tpu_torch.train.common import VARIANTS, DenoiseTrainStep, make_adamw, make_denoise_train_step


def _refuse_unported(training_cfg: Dict[str, Any]) -> None:
    unported = {
        "fsdp": bool(training_cfg.get("fsdp", False)),
        "tensor_parallel > 1": int(training_cfg.get("tensor_parallel", 1) or 1) > 1,
        "sequence_parallel > 1": int(training_cfg.get("sequence_parallel", 1) or 1) > 1,
    }
    refused = [name for name, on in unported.items() if on]
    if refused:
        raise NotImplementedError(f"denoise training with {', '.join(refused)} is not ported yet")


def build_denoise_trainer(cfg: Dict[str, Any], *, variant: str, num_samples: int,
                          device: DeviceArg = None
                          ) -> Tuple[torch.nn.Module, Scheduler, DenoiseTrainStep]:
    """(model, scheduler, train step) of a ``{training, model}`` config for
    ``variant`` ("diffusion" or "flow_matching") over a dataset of
    ``num_samples``, on ``device`` (CUDA by default). The UNet's weights are
    drawn from ``training.seed``; the optimizer is AdamW at the cosine-warmup
    rate over ``epochs * ceil(num_samples / batch_size)`` steps."""
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
    _refuse_unported(training_cfg)

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
        ema_decay=float(training_cfg.get("ema_decay", 0.0) or 0.0), device=device)
    return model, scheduler, step
