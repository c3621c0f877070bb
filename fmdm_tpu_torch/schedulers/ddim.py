"""
DDIM scheduler (counterpart of ``fmdm_tpu/schedulers/ddim.py:28-159``),
diffusers ``DDIMScheduler`` semantics: eta 0 (deterministic) or eta > 0
(ancestral blend), epsilon / sample / v prediction, dynamic thresholding
before ``clip_sample``, ``use_clipped_model_output``, ``set_alpha_to_one``,
linspace / leading / trailing spacing with the DDIM conventions.

Every scalar coefficient is computed in float32 from the f32 table of
``alphas_cumprod``, as the JAX version computes it; the sample math runs in
f32. With eta > 0, ``step`` draws its noise from ``generator`` or takes it as
``noise`` (f32, the sample's shape) and raises with neither, as JAX raises
without ``rng``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from fmdm_tpu_torch.schedulers.base import (
    Scheduler,
    check_unimplemented_kwargs,
    dynamic_threshold,
    make_beta_schedule,
    spaced_timesteps,
)

# diffusers.DDIMScheduler ctor params recognized but not implemented: refused
_UNIMPLEMENTED = frozenset({"trained_betas", "rescale_betas_zero_snr"})

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class DDIMScheduler(Scheduler):
    num_train_timesteps: int = 1000
    alphas_cumprod: np.ndarray = None
    final_alpha_cumprod: float = 1.0
    clip_sample: bool = True
    clip_sample_range: float = 1.0
    prediction_type: str = "epsilon"
    eta: float = 0.0
    use_clipped_model_output: bool = False
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
        set_alpha_to_one: bool = True,
        prediction_type: str = "epsilon",
        eta: float = 0.0,
        use_clipped_model_output: bool = False,
        thresholding: bool = False,
        dynamic_thresholding_ratio: float = 0.995,
        sample_max_value: float = 1.0,
        timestep_spacing: str = "leading",
        steps_offset: int = 0,
        **extra,
    ) -> "DDIMScheduler":
        check_unimplemented_kwargs(cls.__name__, extra, _UNIMPLEMENTED)
        if timestep_spacing not in ("linspace", "leading", "trailing"):
            raise ValueError(f"Unknown timestep_spacing '{timestep_spacing}'")
        betas = make_beta_schedule(beta_schedule, num_train_timesteps, beta_start, beta_end)
        alphas_cumprod = np.cumprod(1.0 - betas)
        return cls(
            num_train_timesteps=num_train_timesteps,
            alphas_cumprod=alphas_cumprod,
            final_alpha_cumprod=1.0 if set_alpha_to_one else float(alphas_cumprod[0]),
            clip_sample=clip_sample,
            clip_sample_range=clip_sample_range,
            prediction_type=prediction_type,
            eta=eta,
            use_clipped_model_output=use_clipped_model_output,
            thresholding=thresholding,
            dynamic_thresholding_ratio=dynamic_thresholding_ratio,
            sample_max_value=sample_max_value,
            timestep_spacing=timestep_spacing,
            steps_offset=steps_offset,
        )

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        acp = torch.as_tensor(self.alphas_cumprod, dtype=_F32, device=x0.device)[t.long()]
        shape = acp.shape + (1,) * (x0.dim() - acp.dim())
        return torch.sqrt(acp).reshape(shape) * x0 + torch.sqrt(1 - acp).reshape(shape) * noise

    def set_timesteps(self, num_inference_steps: int) -> np.ndarray:
        object.__setattr__(self, "num_inference_steps", num_inference_steps)
        return spaced_timesteps(self.timestep_spacing, self.num_train_timesteps,
                                num_inference_steps, self.steps_offset, ddim_conventions=True)

    @property
    def needs_noise(self) -> bool:
        return self.eta > 0

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
        if self.eta > 0 and noise is None and generator is None:
            raise ValueError("DDIMScheduler.step with eta > 0 requires a generator or a noise "
                             "tensor.")
        acp = torch.as_tensor(self.alphas_cumprod, dtype=_F32)
        num_inference = self.num_inference_steps or len(timesteps)
        t = int(timesteps[index])
        prev_t = t - self.num_train_timesteps // num_inference
        alpha_prod_t = acp[t]
        alpha_prod_prev = acp[prev_t] if prev_t >= 0 else torch.tensor(self.final_alpha_cumprod,
                                                                       dtype=_F32)
        beta_prod_t = 1.0 - alpha_prod_t
        sqrt_a, sqrt_b = float(torch.sqrt(alpha_prod_t)), float(torch.sqrt(beta_prod_t))

        x32 = sample.float()
        out32 = model_output.float()
        if self.prediction_type == "epsilon":
            pred_x0 = (x32 - sqrt_b * out32) / sqrt_a
            eps = out32
        elif self.prediction_type == "sample":
            pred_x0 = out32
            eps = (x32 - sqrt_a * pred_x0) / sqrt_b
        elif self.prediction_type == "v_prediction":
            pred_x0 = sqrt_a * x32 - sqrt_b * out32
            eps = sqrt_a * out32 + sqrt_b * x32
        else:
            raise ValueError(f"Unknown prediction_type '{self.prediction_type}'")

        if self.thresholding:
            # diffusers order: thresholding takes precedence over clip_sample
            pred_x0 = dynamic_threshold(pred_x0, self.dynamic_thresholding_ratio,
                                        self.sample_max_value)
        elif self.clip_sample:
            pred_x0 = torch.clamp(pred_x0, -self.clip_sample_range, self.clip_sample_range)
        if self.use_clipped_model_output:
            # eps re-derived from the (possibly clipped) x0 only on request,
            # as diffusers' step(..., use_clipped_model_output=True)
            eps = (x32 - sqrt_a * pred_x0) / sqrt_b

        # sigma_t for eta > 0 (ancestral blend)
        variance = (1 - alpha_prod_prev) / (1 - alpha_prod_t) * (1 - alpha_prod_t / alpha_prod_prev)
        std_dev = self.eta * torch.sqrt(torch.clamp(variance, min=0.0))
        dir_coef = torch.sqrt(torch.clamp(1.0 - alpha_prod_prev - std_dev ** 2, min=0.0))
        prev_sample = float(torch.sqrt(alpha_prod_prev)) * pred_x0 + float(dir_coef) * eps
        if self.eta > 0:
            if noise is None:
                noise = torch.randn(sample.shape, generator=generator, device=sample.device,
                                    dtype=_F32)
            prev_sample = prev_sample + float(std_dev) * noise.float()
        return state, prev_sample.to(sample.dtype)
