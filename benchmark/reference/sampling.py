"""
Plain reference samplers: flow-matching Euler (diffusers'
``FlowMatchEulerDiscreteScheduler``, shift 1) and DPM-Solver++ of order 2
(diffusers' ``DPMSolverMultistepScheduler``: midpoint, epsilon prediction,
linspace spacing, a zero final sigma and so a first-order last step), over
a linear beta schedule. Schedules and coefficients in float64 on the host;
the sample in float32; the model called on [x, conditioning].
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

Model = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def alphas_cumprod(num_train: int = 1000, beta_start: float = 1e-4,
                   beta_end: float = 0.02) -> np.ndarray:
    return np.cumprod(1.0 - np.linspace(beta_start, beta_end, num_train, dtype=np.float64))


def flow_timesteps(steps: int, num_train: int = 1000) -> np.ndarray:
    """sigma * N from 1 down to 1/N, as float32 (what the model is given)."""
    return np.linspace(float(num_train), 1.0, steps, dtype=np.float64).astype(np.float32)


def dpm_timesteps(steps: int, num_train: int = 1000) -> np.ndarray:
    return np.linspace(0, num_train - 1, steps + 1).round()[::-1][:-1].astype(np.int64)


@torch.no_grad()
def flow_euler(model: Model, noise: torch.Tensor, cond: torch.Tensor, steps: int,
               num_train: int = 1000, stop: int = None) -> torch.Tensor:
    """x_{i+1} = x_i + (sigma_{i+1} - sigma_i) v(x_i, t_i), sigma_steps = 0;
    the first ``stop`` steps of the schedule only, when given."""
    ts = flow_timesteps(steps, num_train)
    sigmas = np.append(ts.astype(np.float64) / num_train, 0.0)
    x = noise.float()
    for i, t in enumerate(ts[:stop]):
        tt = torch.full((x.shape[0],), float(t), device=x.device)
        v = model(torch.cat([x, cond.float()], dim=1), tt).float()
        x = x + float(sigmas[i + 1] - sigmas[i]) * v
    return x


@torch.no_grad()
def dpm_solver_pp2(model: Model, noise: torch.Tensor, cond: torch.Tensor, steps: int,
                   num_train: int = 1000, stop: int = None) -> torch.Tensor:
    """DPM-Solver++(2M): x0 = (x - sigma_t eps) / alpha_t; the first order
    step (sigma_t / sigma_s) x - alpha_t (e^-h - 1) x0, then the midpoint
    correction - 0.5 alpha_t (e^-h - 1) (x0 - x0_prev) / r from the second
    step on, except the last. The first ``stop`` steps only, when given."""
    acp = alphas_cumprod(num_train)
    ts = dpm_timesteps(steps, num_train)
    sig = np.append(np.sqrt((1.0 - acp[ts]) / acp[ts]), 0.0)
    alpha = 1.0 / np.sqrt(sig ** 2 + 1.0)
    sigma = sig * alpha
    lam = np.log(alpha) - np.log(np.maximum(sigma, 1e-10))
    x = noise.float()
    prev = None
    for i, t in enumerate(ts[:stop]):
        tt = torch.full((x.shape[0],), int(t), device=x.device, dtype=torch.long)
        eps = model(torch.cat([x, cond.float()], dim=1), tt).float()
        x0 = (x - sigma[i] * eps) / alpha[i]
        h = lam[i + 1] - lam[i]
        phi = math.expm1(-h)
        new = (sigma[i + 1] / sigma[i]) * x - alpha[i + 1] * phi * x0
        if prev is not None and i < len(ts) - 1:
            r = (lam[i] - lam[i - 1]) / h
            new = new - 0.5 * alpha[i + 1] * phi * (x0 - prev) / r
        x, prev = new, x0
    return x


SAMPLERS = {"flow_euler": flow_euler, "dpm_solver_pp2": dpm_solver_pp2}
