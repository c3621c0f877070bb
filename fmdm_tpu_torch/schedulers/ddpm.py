"""
DDPM scheduler, ancestral sampling (counterpart of
``fmdm_tpu/schedulers/ddpm.py:30-164``), diffusers ``DDPMScheduler``
semantics: epsilon / sample / v prediction, dynamic thresholding before
``clip_sample``, ``fixed_small`` and ``fixed_large`` variance, noise added
only while t > 0, linspace / leading / trailing spacing with the DDIM
conventions.

Every scalar coefficient is computed in float32 from the f32 table of
``alphas_cumprod``, as the JAX version computes it; the sample math runs in
f32. ``step`` draws its noise from ``generator`` or takes it as ``noise``
(f32, the sample's shape); it raises with neither, as JAX raises without
``rng``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from fmdm_tpu_torch.schedulers.base import (
    Scheduler,
    broadcast_to_sample,
    check_unimplemented_kwargs,
    dynamic_threshold,
    make_beta_schedule,
    spaced_timesteps,
)

# diffusers.DDPMScheduler ctor params recognized but not implemented: refused
_UNIMPLEMENTED = frozenset({"trained_betas", "rescale_betas_zero_snr"})

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class DDPMScheduler(Scheduler):
    num_train_timesteps: int = 1000
    alphas_cumprod: np.ndarray = None
    betas: np.ndarray = None
    clip_sample: bool = True
    clip_sample_range: float = 1.0
    variance_type: str = "fixed_small"
    prediction_type: str = "epsilon"
    thresholding: bool = False
    dynamic_thresholding_ratio: float = 0.995
    sample_max_value: float = 1.0
    timestep_spacing: str = "leading"
    steps_offset: int = 0
    num_inference_steps: Optional[int] = None

    @classmethod
    def create(
        cls,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.0001,
        beta_end: float = 0.02,
        beta_schedule: str = "linear",
        clip_sample: bool = True,
        clip_sample_range: float = 1.0,
        variance_type: str = "fixed_small",
        prediction_type: str = "epsilon",
        thresholding: bool = False,
        dynamic_thresholding_ratio: float = 0.995,
        sample_max_value: float = 1.0,
        timestep_spacing: str = "leading",
        steps_offset: int = 0,
        **extra,
    ) -> "DDPMScheduler":
        check_unimplemented_kwargs(cls.__name__, extra, _UNIMPLEMENTED)
        if variance_type not in ("fixed_small", "fixed_large"):
            raise NotImplementedError(
                f"DDPMScheduler: variance_type '{variance_type}' is part of the diffusers "
                f"surface but not implemented here; use 'fixed_small' or 'fixed_large'")
        if timestep_spacing not in ("linspace", "leading", "trailing"):
            raise ValueError(f"Unknown timestep_spacing '{timestep_spacing}'")
        betas = make_beta_schedule(beta_schedule, num_train_timesteps, beta_start, beta_end)
        return cls(
            num_train_timesteps=num_train_timesteps,
            alphas_cumprod=np.cumprod(1.0 - betas),
            betas=betas,
            clip_sample=clip_sample,
            clip_sample_range=clip_sample_range,
            variance_type=variance_type,
            prediction_type=prediction_type,
            thresholding=thresholding,
            dynamic_thresholding_ratio=dynamic_thresholding_ratio,
            sample_max_value=sample_max_value,
            timestep_spacing=timestep_spacing,
            steps_offset=steps_offset,
        )

    # -- forward process ----------------------------------------------------
    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """sqrt(acp[t]) x0 + sqrt(1 - acp[t]) noise, acp gathered in f32 at
        integer t and the coefficients cast to x0's dtype."""
        acp = torch.as_tensor(self.alphas_cumprod, dtype=_F32, device=x0.device)[t.long()]
        return (broadcast_to_sample(torch.sqrt(acp), x0) * x0
                + broadcast_to_sample(torch.sqrt(1.0 - acp), x0) * noise)

    # -- reverse process ------------------------------------------------------
    def set_timesteps(self, num_inference_steps: int) -> np.ndarray:
        object.__setattr__(self, "num_inference_steps", num_inference_steps)
        return spaced_timesteps(self.timestep_spacing, self.num_train_timesteps,
                                num_inference_steps, self.steps_offset, ddim_conventions=True)

    @property
    def needs_noise(self) -> bool:
        return True

    def step(
        self,
        state: Dict[str, Any],
        model_output: torch.Tensor,
        index: int,
        sample: torch.Tensor,
        timesteps: np.ndarray,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[Dict[str, Any], torch.Tensor]:
        if noise is None and generator is None:
            raise ValueError("DDPMScheduler.step requires a generator or a noise tensor "
                             "(ancestral sampling).")
        acp = torch.as_tensor(self.alphas_cumprod, dtype=_F32)
        n = len(timesteps)
        t = int(timesteps[index])
        # prev_t follows diffusers: t - num_train // num_inference
        step_ratio = self.num_train_timesteps // (n if self.num_inference_steps is None
                                                  else self.num_inference_steps)
        prev_t = t - step_ratio

        alpha_prod_t = acp[t]
        alpha_prod_prev = acp[prev_t] if prev_t >= 0 else torch.ones((), dtype=_F32)
        beta_prod_t = 1.0 - alpha_prod_t
        beta_prod_prev = 1.0 - alpha_prod_prev
        current_alpha = alpha_prod_t / alpha_prod_prev
        current_beta = 1.0 - current_alpha

        x32 = sample.float()
        eps32 = model_output.float()
        if self.prediction_type == "epsilon":
            pred_x0 = (x32 - float(torch.sqrt(beta_prod_t)) * eps32) / float(torch.sqrt(alpha_prod_t))
        elif self.prediction_type == "sample":
            pred_x0 = eps32
        elif self.prediction_type == "v_prediction":
            pred_x0 = float(torch.sqrt(alpha_prod_t)) * x32 - float(torch.sqrt(beta_prod_t)) * eps32
        else:
            raise ValueError(f"Unknown prediction_type '{self.prediction_type}'")

        if self.thresholding:
            # diffusers order: thresholding takes precedence over clip_sample
            pred_x0 = dynamic_threshold(pred_x0, self.dynamic_thresholding_ratio,
                                        self.sample_max_value)
        elif self.clip_sample:
            pred_x0 = torch.clamp(pred_x0, -self.clip_sample_range, self.clip_sample_range)

        pred_x0_coeff = torch.sqrt(alpha_prod_prev) * current_beta / beta_prod_t
        current_coeff = torch.sqrt(current_alpha) * beta_prod_prev / beta_prod_t
        prev_sample = float(pred_x0_coeff) * pred_x0 + float(current_coeff) * x32

        if self.variance_type == "fixed_large":
            variance = torch.clamp(current_beta, min=1e-20)
        else:
            variance = torch.clamp(beta_prod_prev / beta_prod_t * current_beta, min=1e-20)
        if noise is None:
            noise = torch.randn(sample.shape, generator=generator, device=sample.device, dtype=_F32)
        sigma = float(torch.sqrt(variance)) if t > 0 else 0.0
        prev_sample = prev_sample + sigma * noise.float()
        return state, prev_sample.to(sample.dtype)
