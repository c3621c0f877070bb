"""
The denoising train step of the diffusion and flow-matching UNets and its
optimizer (counterpart of ``fmdm_tpu/train/common.py:30-46,189-332``).

One step on a batch ``{"target", "image", "valid"}`` (x0, the conditioning
images or None, the (B,) validity mask):

- the batch is cut into ``n_chunks = ceil(B / chunk)`` chunks of
  ``chunk = ceil(B / grad_accum)`` rows; the last is padded with zero rows
  of valid 0;
- per chunk, diffusion draws t ~ U{0..N-1}, noises x0 with the scheduler's
  ``add_noise`` and regresses the noise; flow matching draws t ~ U(0, 1),
  takes x_t = (1 - t) x0 + t eps, regresses eps - x0 and gives the model
  (t (N - 1)) truncated to int32;
- the loss is the per-sample mean of squares of the f32 prediction's error,
  summed over the valid rows (``loss_sum``) and divided by max(count, 1);
  with one chunk its gradient is applied as it is, with several each
  chunk's gradient is weighted by its count and the sum divided by
  max(total count, 1);
- ``torch.optim.AdamW`` (b1 0.9, b2 0.999, eps 1e-8, decoupled decay on
  every parameter) applies it at the rate of the step's schedule, which is
  ``optax.adamw``'s update; then the EMA shadow weights, if any, follow
  ``e += (1 - decay) (p - e)``.

Noise and t are drawn from a ``torch.Generator`` on the step's device, or
given as tensors covering the padded batch. ``remat`` recomputes the model's
forward in the backward (``torch.utils.checkpoint``), as ``jax.checkpoint``
does. On CUDA the UNet's forward runs K1 and K2; their backwards are the
autograd of their plain versions, as in JAX. The mesh is not ported.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from fmdm_tpu_torch.device import DeviceArg, resolve_device
from fmdm_tpu_torch.sample.engine import normalize_latent_conditioning, prepare_attention_context
from fmdm_tpu_torch.schedulers.base import Scheduler

VARIANTS = ("diffusion", "flow_matching")


def cosine_warmup_schedule(base_lr: float, num_warmup_steps: int,
                           num_training_steps: int) -> Callable[[int], float]:
    """Per-step rate of diffusers' ``get_cosine_schedule_with_warmup``: linear
    from 0 over the warmup, then half a cosine down to 0."""

    def schedule(step: int) -> float:
        if step < num_warmup_steps:
            return base_lr * step / max(1.0, num_warmup_steps)
        progress = (step - num_warmup_steps) / max(1.0, num_training_steps - num_warmup_steps)
        return base_lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * progress)))

    return schedule


def make_adamw(params: Iterable[nn.Parameter], base_lr: float, weight_decay: float,
               num_warmup_steps: int, num_training_steps: int):
    """``torch.optim.AdamW`` with torch's defaults (decay on every parameter)
    and its cosine-warmup rate: (optimizer, schedule)."""
    optimizer = torch.optim.AdamW(params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=weight_decay)
    return optimizer, cosine_warmup_schedule(base_lr, num_warmup_steps, num_training_steps)


def _pad_rows(a: Optional[torch.Tensor], rows: int) -> Optional[torch.Tensor]:
    if a is None or a.shape[0] == rows:
        return a
    return torch.cat([a, a.new_zeros((rows - a.shape[0],) + a.shape[1:])])


class DenoiseTrainStep:
    """One optimizer step of a denoising UNet under a scheduler (see the
    module's docstring). ``step`` returns ``(loss_sum, count)`` and leaves
    ``p.grad`` holding the averaged gradient that was applied."""

    def __init__(self, model: nn.Module, scheduler: Scheduler, optimizer: torch.optim.Optimizer,
                 lr_schedule: Callable[[int], float], *, variant: str,
                 conditioning_mode: Optional[str], latent_norm: Optional[str],
                 grad_accum: int = 1, compute_dtype: torch.dtype = torch.float32,
                 remat: bool = False, ema_decay: float = 0.0, device: DeviceArg = None):
        if variant not in VARIANTS:
            raise ValueError(f"variant must be one of {VARIANTS}; got '{variant}'")
        decay = float(ema_decay or 0.0)
        if decay and not 0.0 < decay < 1.0:
            raise ValueError(f"ema_decay must be in (0, 1), got {decay}")
        self.device = resolve_device(device)
        params = list(model.parameters())
        if any(p.device.type != self.device.type for p in params):
            raise ValueError(f"the model's parameters must be on {self.device}")
        self.model = model
        self.scheduler = scheduler
        self.optimizer = optimizer
        self.lr_schedule = lr_schedule
        self.variant = variant
        self.conditioning_mode = conditioning_mode
        self.latent_norm = latent_norm
        self.grad_accum = max(1, int(grad_accum))
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.ema_decay = decay
        # shadow weights start as a copy of the live parameters
        self.ema = [p.detach().clone() for p in params] if decay else None
        self.global_step = 0

    def _draw_t(self, rows: int, generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.variant == "diffusion":
            return torch.randint(0, self.scheduler.num_train_timesteps, (rows,),
                                 generator=generator, device=self.device, dtype=torch.int32)
        return torch.rand((rows,), generator=generator, device=self.device, dtype=torch.float32)

    def _model(self, x: torch.Tensor, t: torch.Tensor, ctx: Optional[torch.Tensor]) -> torch.Tensor:
        if self.remat:
            return checkpoint(self.model, x, t, use_reentrant=False, context_ca=ctx)
        return self.model(x, t, context_ca=ctx)

    def chunk_loss(self, x0: torch.Tensor, cond: Optional[torch.Tensor], valid: torch.Tensor,
                   noise: torch.Tensor, t: torch.Tensor):
        """(masked mean loss, loss_sum, count) of one chunk with its noise and t."""
        n_train = self.scheduler.num_train_timesteps
        if self.variant == "diffusion":
            noisy = self.scheduler.add_noise(x0, noise, t)
            target, model_t = noise, t
        else:
            tb = t.reshape((-1,) + (1,) * (x0.dim() - 1))
            noisy = (1.0 - tb) * x0 + tb * noise
            target = noise - x0
            model_t = (t * (n_train - 1)).to(torch.int32)

        model_input = noisy.to(self.compute_dtype)
        ctx = None
        if self.conditioning_mode == "concatenate" and cond is not None:
            model_input = torch.cat([model_input, cond.to(self.compute_dtype)], dim=1)
        elif self.conditioning_mode == "attention" and cond is not None:
            ctx = prepare_attention_context(normalize_latent_conditioning(cond, self.latent_norm))
            ctx = ctx.to(self.compute_dtype)

        pred = self._model(model_input, model_t, ctx).float()
        per_sample = torch.square(pred - target).mean(dim=tuple(range(1, x0.dim())))
        loss_sum = (per_sample * valid).sum()
        count = valid.sum()
        return loss_sum / torch.clamp(count, min=1.0), loss_sum, count

    def step(self, batch: Dict[str, Optional[torch.Tensor]], *,
             noise: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """One optimizer step on ``batch``. ``noise`` ((rows, *x0.shape[1:]))
        and ``t`` ((rows,), int for diffusion, f32 in [0, 1) for flow
        matching) cover the padded batch of ``rows = n_chunks * chunk``; what
        is not given is drawn per chunk, noise first, from ``generator``."""
        dev = self.device
        x0 = batch["target"].to(dev, torch.float32)
        cond = batch.get("image")
        cond = None if cond is None else cond.to(dev, torch.float32)
        valid = batch["valid"].to(dev, torch.float32)
        chunk = max(1, math.ceil(x0.shape[0] / self.grad_accum))
        n_chunks = math.ceil(x0.shape[0] / chunk)
        rows = n_chunks * chunk
        x0, cond, valid = (_pad_rows(a, rows) for a in (x0, cond, valid))
        if noise is not None and tuple(noise.shape) != tuple(x0.shape):
            raise ValueError(f"noise is {tuple(noise.shape)}; the padded batch is {tuple(x0.shape)}")
        if t is not None and tuple(t.shape) != (rows,):
            raise ValueError(f"t is {tuple(t.shape)}; the padded batch has {rows} rows")

        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss_sum = torch.zeros((), device=dev)
        count = torch.zeros((), device=dev)
        for i in range(n_chunks):
            sl = slice(i * chunk, (i + 1) * chunk)
            nz = noise[sl].to(dev) if noise is not None else torch.randn(
                x0[sl].shape, generator=generator, device=dev, dtype=torch.float32)
            tt = t[sl].to(dev) if t is not None else self._draw_t(chunk, generator)
            loss, chunk_sum, chunk_count = self.chunk_loss(
                x0[sl], None if cond is None else cond[sl], valid[sl], nz, tt)
            # one chunk: the masked mean's gradient as it is; several: each
            # weighted by its count, the sum divided by the total below
            (loss if n_chunks == 1 else loss * chunk_count).backward()
            loss_sum = loss_sum + chunk_sum.detach()
            count = count + chunk_count
        if n_chunks > 1:
            divisor = torch.clamp(count, min=1.0)
            for p in self.model.parameters():
                if p.grad is not None:
                    p.grad.div_(divisor)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_schedule(self.global_step)
        self.optimizer.step()
        if self.ema is not None:
            with torch.no_grad():
                torch._foreach_lerp_(self.ema, [p.detach() for p in self.model.parameters()],
                                     1.0 - self.ema_decay)
        self.global_step += 1
        return loss_sum, count

    def ema_state_dict(self) -> Dict[str, torch.Tensor]:
        """The shadow weights under the model's parameter names (the ``ema``
        entry of a checkpoint), or {} without EMA."""
        if self.ema is None:
            return {}
        return {name: e for (name, _), e in zip(self.model.named_parameters(), self.ema)}


def make_denoise_train_step(model: nn.Module, scheduler: Scheduler,
                            optimizer: torch.optim.Optimizer, lr_schedule: Callable[[int], float],
                            *, variant: str, conditioning_mode: Optional[str],
                            latent_norm: Optional[str], grad_accum: int = 1,
                            compute_dtype: torch.dtype = torch.float32, mesh=None,
                            remat: bool = False, ema_decay: float = 0.0,
                            device: DeviceArg = None) -> DenoiseTrainStep:
    """The train step of ``model`` (its parameters on ``device``, CUDA by
    default) with ``optimizer`` at ``lr_schedule``'s rate; see
    :class:`DenoiseTrainStep`."""
    if mesh is not None:
        raise NotImplementedError("make_denoise_train_step: the device mesh is not ported yet")
    return DenoiseTrainStep(model, scheduler, optimizer, lr_schedule, variant=variant,
                            conditioning_mode=conditioning_mode, latent_norm=latent_norm,
                            grad_accum=grad_accum, compute_dtype=compute_dtype, remat=remat,
                            ema_decay=ema_decay, device=device)
