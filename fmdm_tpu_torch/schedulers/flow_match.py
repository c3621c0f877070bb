"""
FlowMatchEulerDiscrete scheduler (counterpart of
``fmdm_tpu/schedulers/flow_match.py:37-107``), diffusers
``FlowMatchEulerDiscreteScheduler`` with a static shift:

  sigma(t) = t / num_train;  with shift s: sigma <- s*sigma / (1 + (s-1)*sigma)
  x_sigma  = (1 - sigma) * x0 + sigma * noise
  step:      x_prev = x + (sigma_next - sigma) * v,   v = model(x, t)

Timesteps live in shifted-sigma space (``set_timesteps`` returns
shifted sigma * N), so ``step`` and ``add_noise`` recover sigma by a plain
f32 division. The step is deterministic.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from fmdm_tpu_torch.schedulers.base import Scheduler, check_unimplemented_kwargs

# diffusers ctor params recognized but not implemented: refused
_UNIMPLEMENTED = frozenset({
    "use_dynamic_shifting", "base_shift", "max_shift", "base_image_seq_len",
    "max_image_seq_len", "invert_sigmas", "shift_terminal", "time_shift_type",
    "use_karras_sigmas", "use_exponential_sigmas", "use_beta_sigmas",
    "stochastic_sampling",
})


@dataclasses.dataclass(frozen=True)
class FlowMatchEulerDiscreteScheduler(Scheduler):
    num_train_timesteps: int = 1000
    shift: float = 1.0

    @classmethod
    def create(cls, num_train_timesteps: int = 1000, shift: float = 1.0,
               **extra) -> "FlowMatchEulerDiscreteScheduler":
        check_unimplemented_kwargs(cls.__name__, extra, _UNIMPLEMENTED)
        return cls(num_train_timesteps=num_train_timesteps, shift=shift)

    def _shift_sigma(self, sigma: float) -> float:
        if self.shift == 1.0:
            return sigma
        return self.shift * sigma / (1 + (self.shift - 1) * sigma)

    def sigma_for_timestep(self, t: torch.Tensor) -> torch.Tensor:
        """f32 sigma of timesteps that came from ``set_timesteps`` (already
        shifted): a plain division, never the shift map again."""
        return t.float() / self.num_train_timesteps

    # -- forward process (scale_noise in diffusers) ---------------------------
    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        sigma = self.sigma_for_timestep(t)
        sigma = sigma.reshape(sigma.shape + (1,) * (x0.dim() - sigma.dim())).to(x0.dtype)
        return (1.0 - sigma) * x0 + sigma * noise

    # -- reverse process -------------------------------------------------------
    def set_timesteps(self, num_inference_steps: int) -> np.ndarray:
        # diffusers: timesteps = linspace(sigma_max*N, sigma_min*N, steps)
        n_train = self.num_train_timesteps
        timesteps = np.linspace(self._shift_sigma(1.0) * n_train,
                                self._shift_sigma(1.0 / n_train) * n_train,
                                num_inference_steps, dtype=np.float64)
        return timesteps.astype(np.float32)

    def step(
        self,
        state: Dict[str, Any],
        model_output: torch.Tensor,
        index: int,
        sample: torch.Tensor,
        timesteps: np.ndarray,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Dict[str, Any], torch.Tensor]:
        # sigma per selected step from the timestep values themselves (a
        # sliced schedule works too), with a final sigma of 0
        sigmas = torch.as_tensor(np.asarray(timesteps), dtype=torch.float32) / self.num_train_timesteps
        sigmas = torch.cat([sigmas, torch.zeros(1)])
        delta = float(sigmas[index + 1] - sigmas[index])
        prev = sample.float() + delta * model_output.float()
        return state, prev.to(sample.dtype)
