"""
Plain reference of the denoising train step: the loss of flow matching
(x_t = (1 - t) x0 + t eps, the model at int(t (N - 1)) regressing eps - x0)
or of DDPM (x_t = sqrt(acp_t) x0 + sqrt(1 - acp_t) eps at integer t,
regressing eps), each the batch mean of the per-sample mean squared error,
in f32; its gradient; and AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled
decay) at the rate of a linear warm-up and half a cosine.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn as nn

from benchmark.reference.sampling import alphas_cumprod

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def cosine_rate(step: int, base_lr: float, warmup: int, total: int) -> float:
    if step < warmup:
        return base_lr * step / max(1.0, warmup)
    progress = (step - warmup) / max(1.0, total - warmup)
    return base_lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * progress)))


def denoise_loss(model: nn.Module, variant: str, x0, cond, noise, t,
                 num_train: int = 1000) -> torch.Tensor:
    x0, noise = x0.float(), noise.float()
    shape = (-1,) + (1,) * (x0.dim() - 1)
    if variant == "flow_matching":
        tb = t.float().reshape(shape)
        noisy = (1.0 - tb) * x0 + tb * noise
        target = noise - x0
        model_t = (t.float() * (num_train - 1)).long()
    elif variant == "diffusion":
        acp = torch.as_tensor(alphas_cumprod(num_train), dtype=torch.float32,
                              device=x0.device)[t.long()].reshape(shape)
        noisy = torch.sqrt(acp) * x0 + torch.sqrt(1.0 - acp) * noise
        target, model_t = noise, t.long()
    else:
        raise ValueError(f"unknown variant {variant!r}")
    pred = model(torch.cat([noisy, cond.float()], dim=1), model_t).float()
    return torch.square(pred - target).mean(dim=tuple(range(1, x0.dim()))).mean()


class AdamW:
    """AdamW over named f32 parameters, one tensor at a time."""

    def __init__(self, params: Dict[str, nn.Parameter], weight_decay: float = 0.0):
        self.params = params
        self.weight_decay = weight_decay
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, lr: float) -> None:
        self.count += 1
        c1, c2 = 1 - BETAS[0] ** self.count, 1 - BETAS[1] ** self.count
        for name, p in self.params.items():
            if p.grad is None:
                continue
            g = p.grad
            self.m[name].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
            self.v[name].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
            p.mul_(1 - lr * self.weight_decay)
            p.sub_(lr * (self.m[name] / c1) / (torch.sqrt(self.v[name] / c2) + ADAM_EPS))


def train_steps(model: nn.Module, variant: str, batches: Sequence[dict], *, base_lr: float,
                weight_decay: float, warmup: int, total: int, start_step: int) -> dict:
    """Run one optimizer step per batch (``x0``, ``cond``, ``noise``, ``t``)
    from the model's current weights. Returns the readings the check
    compares: each step's loss, each parameter's first gradient norm, each
    parameter's norm of change over all the steps, and each parameter's
    element count."""
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    opt = AdamW(params, weight_decay)
    losses: List[float] = []
    first_grad: Dict[str, float] = {}
    for i, b in enumerate(batches):
        for p in params.values():
            p.grad = None
        loss = denoise_loss(model, variant, b["x0"], b["cond"], b["noise"], b["t"])
        loss.backward()
        losses.append(loss.detach().item())
        if i == 0:
            first_grad = {k: float(p.grad.norm()) if p.grad is not None else 0.0
                          for k, p in params.items()}
        opt.step(cosine_rate(start_step + i, base_lr, warmup, total))
    change = {k: float((p.detach() - start[k]).norm()) for k, p in params.items()}
    return {"losses": losses, "first_grad": first_grad, "change": change,
            "sizes": {k: p.numel() for k, p in params.items()}}


def median(values) -> float:
    return float(np.median(np.asarray(list(values), dtype=np.float64)))
