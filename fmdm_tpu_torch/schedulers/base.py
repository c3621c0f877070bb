"""
Scheduler core (counterpart of ``fmdm_tpu/schedulers/base.py:31-212``).

The JAX schedulers are stateless step functions inside one ``lax.scan``; the
port keeps the same surface and drives it from a Python loop:

  sched = DPMSolverMultistepScheduler.create(num_train_timesteps=1000, ...)
  timesteps = sched.set_timesteps(50)            # numpy array, host side
  state = sched.init_state(timesteps, sample)    # multistep history
  state, prev = sched.step(state, model_output, i, sample, timesteps)

``i`` is the position in the selected-timestep array, a Python int.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def make_beta_schedule(schedule: str, num_train_timesteps: int, beta_start: float,
                       beta_end: float) -> np.ndarray:
    """Beta schedules with diffusers semantics (float64, host side)."""
    if schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    if schedule == "scaled_linear":
        return np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64) ** 2
    if schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

        betas = [min(1 - alpha_bar((i + 1) / num_train_timesteps) / alpha_bar(i / num_train_timesteps), 0.999)
                 for i in range(num_train_timesteps)]
        return np.array(betas, dtype=np.float64)
    raise ValueError(f"Unknown beta schedule '{schedule}'")


def spaced_timesteps_leading(num_train: int, num_inference: int) -> np.ndarray:
    """'leading' spacing (diffusers DDPM/DDIM default): descending int array."""
    step_ratio = num_train // num_inference
    t = (np.arange(0, num_inference) * step_ratio).round()[::-1].copy()
    return t.astype(np.int64)


def spaced_timesteps_linspace(num_train: int, num_inference: int) -> np.ndarray:
    """'linspace' spacing (DPM-Solver/UniPC default)."""
    return np.linspace(0, num_train - 1, num_inference + 1).round()[::-1][:-1].copy().astype(np.int64)


def spaced_timesteps_trailing(num_train: int, num_inference: int) -> np.ndarray:
    """'trailing' spacing (diffusers): descending from num_train-1."""
    step_ratio = num_train / num_inference
    return np.arange(num_train, 0, -step_ratio).round().astype(np.int64) - 1


def spaced_timesteps(spacing: str, num_train: int, num_inference: int, steps_offset: int = 0,
                     ddim_conventions: bool = False) -> np.ndarray:
    """Dispatch on diffusers ``timestep_spacing``; ``steps_offset`` applies to
    'leading' only. ``ddim_conventions`` selects the DDPM/DDIM family (n
    points) over the DPM-Solver/UniPC family (n+1 points, last dropped) for
    'linspace' and 'leading'; 'trailing' is the same in both."""
    if spacing == "linspace":
        if ddim_conventions:
            return np.linspace(0, num_train - 1, num_inference).round()[::-1].copy().astype(np.int64)
        return spaced_timesteps_linspace(num_train, num_inference)
    if spacing == "leading":
        if ddim_conventions:
            return spaced_timesteps_leading(num_train, num_inference) + int(steps_offset)
        ratio = num_train // (num_inference + 1)
        t = (np.arange(0, num_inference + 1) * ratio).round()[::-1][:-1].copy()
        return t.astype(np.int64) + int(steps_offset)
    if spacing == "trailing":
        return spaced_timesteps_trailing(num_train, num_inference)
    raise ValueError(f"Unknown timestep_spacing '{spacing}' (diffusers surface: "
                     f"linspace, leading, trailing)")


def check_unimplemented_kwargs(name: str, extra: Dict[str, Any], recognized: frozenset) -> None:
    """A diffusers parameter we recognize but have not implemented would change
    the numerics: refuse it. Unknown keys are dropped with a warning."""
    for key in extra:
        if key in recognized:
            raise NotImplementedError(
                f"{name}: diffusers parameter '{key}' is recognized but not implemented here; "
                f"refusing to run with silently different numerics.")
        logging.warning("%s: ignoring unknown scheduler parameter '%s'", name, key)


@dataclasses.dataclass(frozen=True)
class Scheduler:
    """Base scheduler: a frozen dataclass of host-side tables and config."""

    num_train_timesteps: int = 1000
    # initial-noise magnitude (diffusers API): 1.0 for VP schedulers
    init_noise_sigma: float = 1.0

    @classmethod
    def create(cls, num_train_timesteps: int = 1000, **params) -> "Scheduler":
        raise NotImplementedError

    def set_timesteps(self, num_inference_steps: int) -> np.ndarray:
        raise NotImplementedError

    def init_state(self, timesteps: np.ndarray, sample: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """Multistep history for the step loop; default: empty."""
        return {}

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def step(self, state: Dict[str, Any], model_output: torch.Tensor, index: int,
             sample: torch.Tensor, timesteps: np.ndarray,
             generator: Optional[torch.Generator] = None) -> Tuple[Dict[str, Any], torch.Tensor]:
        raise NotImplementedError

    def scale_model_input(self, sample: torch.Tensor, index: int, timesteps) -> torch.Tensor:
        """Pre-model input scaling; identity for the variance-preserving schedulers."""
        return sample

    def align_sliced_timesteps(self, timesteps: np.ndarray) -> np.ndarray:
        """Nearest suffix of a sliced schedule the scheduler can start from;
        identity for memoryless/VP schedulers."""
        return timesteps

    def init_noise_scale(self, timesteps: np.ndarray) -> float:
        """Magnitude for pure-noise initialization given the selected timesteps."""
        return float(self.init_noise_sigma)

    @property
    def needs_noise(self) -> bool:
        """Whether step() draws random noise."""
        return False


def dynamic_threshold(x0: torch.Tensor, ratio: float, max_value: float) -> torch.Tensor:
    """Imagen-style dynamic thresholding (diffusers ``_threshold_sample``):
    per-sample quantile s of |x0| at ``ratio``, clamped to [1, max_value]; x0
    is clipped to [-s, s] and divided by s. Computed in f32."""
    b = x0.shape[0]
    xf = x0.float()
    s = torch.quantile(xf.abs().reshape(b, -1), ratio, dim=1)
    s = torch.clamp(s, 1.0, max_value).reshape((b,) + (1,) * (x0.dim() - 1))
    return (torch.maximum(torch.minimum(xf, s), -s) / s).to(x0.dtype)
