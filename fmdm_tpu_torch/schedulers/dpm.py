"""
DPM-Solver multistep scheduler (counterpart of
``fmdm_tpu/schedulers/dpm.py:43-402``), diffusers
``DPMSolverMultistepScheduler`` semantics for orders 1 and 2, algorithms
'dpmsolver++' and 'dpmsolver', midpoint and heun solvers, linspace / leading /
trailing spacing, lower_order_final, euler_at_final, final sigma zero or
sigma_min, and epsilon / sample / v prediction.

Not ported (``create`` raises ``NotImplementedError``): Karras sigmas,
order 3 and 'sde-dpmsolver++'.

The sigma tables and every scalar coefficient are computed in float32, as the
JAX version computes them (``dpm.py:217-218``); the sample math runs in f32.
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

# diffusers ctor params that are recognized but not implemented: refused
_UNIMPLEMENTED = frozenset({
    "trained_betas", "use_lu_lambdas", "use_exponential_sigmas",
    "use_beta_sigmas", "use_flow_sigmas", "flow_shift", "lambda_min_clipped",
    "variance_type", "rescale_betas_zero_snr",
})

_F32 = torch.float32


def _f32(value) -> torch.Tensor:
    return torch.as_tensor(value, dtype=_F32)


@dataclasses.dataclass(frozen=True)
class DPMSolverMultistepScheduler(Scheduler):
    num_train_timesteps: int = 1000
    alphas_cumprod: np.ndarray = None
    solver_order: int = 2
    algorithm_type: str = "dpmsolver++"
    solver_type: str = "midpoint"
    prediction_type: str = "epsilon"
    lower_order_final: bool = True
    euler_at_final: bool = False
    clip_sample: bool = False
    clip_sample_range: float = 1.0
    thresholding: bool = False
    dynamic_thresholding_ratio: float = 0.995
    sample_max_value: float = 1.0
    timestep_spacing: str = "linspace"
    steps_offset: int = 0
    # None -> diffusers-compatible auto: "zero" for 'dpmsolver++', "sigma_min"
    # for the eps-space 'dpmsolver' (which rejects zero)
    final_sigmas_type: Optional[str] = None
    num_inference_steps: Optional[int] = None

    @classmethod
    def create(
        cls,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.0001,
        beta_end: float = 0.02,
        beta_schedule: str = "linear",
        solver_order: int = 2,
        algorithm_type: str = "dpmsolver++",
        solver_type: str = "midpoint",
        prediction_type: str = "epsilon",
        lower_order_final: bool = True,
        euler_at_final: bool = False,
        clip_sample: bool = False,
        clip_sample_range: float = 1.0,
        thresholding: bool = False,
        dynamic_thresholding_ratio: float = 0.995,
        sample_max_value: float = 1.0,
        use_karras_sigmas: bool = False,
        timestep_spacing: str = "linspace",
        steps_offset: int = 0,
        final_sigmas_type: Optional[str] = None,
        **extra,
    ) -> "DPMSolverMultistepScheduler":
        check_unimplemented_kwargs(cls.__name__, extra, _UNIMPLEMENTED)
        if use_karras_sigmas:
            raise NotImplementedError("DPMSolverMultistepScheduler: Karras sigmas are not ported yet")
        if solver_order == 3:
            raise NotImplementedError("DPMSolverMultistepScheduler: solver_order=3 is not ported yet")
        if algorithm_type == "sde-dpmsolver++":
            raise NotImplementedError("DPMSolverMultistepScheduler: 'sde-dpmsolver++' is not ported yet")
        if solver_order not in (1, 2):
            raise ValueError(f"solver_order must be 1, 2 or 3 (diffusers surface); got {solver_order}")
        if algorithm_type not in ("dpmsolver", "dpmsolver++"):
            raise ValueError(f"Unknown algorithm_type '{algorithm_type}'")
        if solver_type not in ("midpoint", "heun"):
            raise ValueError(f"solver_type must be 'midpoint' or 'heun' (diffusers surface); "
                             f"got '{solver_type}'")
        if timestep_spacing not in ("linspace", "leading", "trailing"):
            raise ValueError(f"Unknown timestep_spacing '{timestep_spacing}'")
        if thresholding and algorithm_type == "dpmsolver":
            raise ValueError("thresholding=True does not work with algorithm_type 'dpmsolver' "
                             "(diffusers parity); use 'dpmsolver++'")
        if final_sigmas_type is not None:
            if final_sigmas_type not in ("zero", "sigma_min"):
                raise ValueError(f"Unknown final_sigmas_type '{final_sigmas_type}'")
            if final_sigmas_type == "zero" and algorithm_type == "dpmsolver":
                raise ValueError("final_sigmas_type='zero' is not supported with "
                                 "algorithm_type 'dpmsolver' (diffusers parity)")
        betas = make_beta_schedule(beta_schedule, num_train_timesteps, beta_start, beta_end)
        return cls(
            num_train_timesteps=num_train_timesteps,
            alphas_cumprod=np.cumprod(1.0 - betas),
            solver_order=solver_order,
            algorithm_type=algorithm_type,
            solver_type=solver_type,
            prediction_type=prediction_type,
            lower_order_final=lower_order_final,
            euler_at_final=euler_at_final,
            clip_sample=clip_sample,
            clip_sample_range=clip_sample_range,
            thresholding=thresholding,
            dynamic_thresholding_ratio=dynamic_thresholding_ratio,
            sample_max_value=sample_max_value,
            timestep_spacing=timestep_spacing,
            steps_offset=steps_offset,
            final_sigmas_type=final_sigmas_type,
        )

    # -- forward process ----------------------------------------------------
    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        acp = torch.as_tensor(self.alphas_cumprod, dtype=_F32, device=x0.device)[t]
        shape = acp.shape + (1,) * (x0.dim() - acp.dim())
        return torch.sqrt(acp).reshape(shape) * x0 + torch.sqrt(1 - acp).reshape(shape) * noise

    # -- reverse process ------------------------------------------------------
    def set_timesteps(self, num_inference_steps: int) -> np.ndarray:
        object.__setattr__(self, "num_inference_steps", num_inference_steps)
        return spaced_timesteps(self.timestep_spacing, self.num_train_timesteps,
                                num_inference_steps, self.steps_offset)

    def init_state(self, timesteps: np.ndarray, sample: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        if sample is None:
            raise ValueError("DPMSolverMultistepScheduler.init_state needs a sample template")
        return {"prev_m": torch.zeros(sample.shape, dtype=_F32, device=sample.device),
                "order_count": 0}

    def _final_sigmas_type_resolved(self) -> str:
        if self.final_sigmas_type is not None:
            return self.final_sigmas_type
        return "sigma_min" if self.algorithm_type == "dpmsolver" else "zero"

    def sigmas_for(self, timesteps: np.ndarray) -> torch.Tensor:
        """f32 sigma at each selected timestep, plus the trailing final sigma."""
        acp = _f32(self.alphas_cumprod)[torch.as_tensor(np.asarray(timesteps), dtype=torch.long)]
        sigmas = torch.sqrt((1.0 - acp) / acp)
        if self._final_sigmas_type_resolved() == "sigma_min":
            a0 = _f32(self.alphas_cumprod[0])
            final = torch.sqrt((1.0 - a0) / a0)[None]
        else:
            final = torch.zeros((1,), dtype=_F32)
        return torch.cat([sigmas, final])

    @staticmethod
    def _alpha_sigma(sigma: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        alpha_t = 1.0 / torch.sqrt(sigma ** 2 + 1.0)
        return alpha_t, sigma * alpha_t

    def _convert_model_output(self, model_output, sample, sigma):
        """epsilon/sample/v -> x0 (dpmsolver++) or eps (dpmsolver)."""
        alpha_t, sigma_t = (float(v) for v in self._alpha_sigma(sigma))
        if self.prediction_type == "epsilon":
            x0 = (sample - sigma_t * model_output) / alpha_t
            eps = model_output
        elif self.prediction_type == "sample":
            x0 = model_output
            eps = (sample - alpha_t * x0) / sigma_t
        elif self.prediction_type == "v_prediction":
            x0 = alpha_t * sample - sigma_t * model_output
            eps = alpha_t * model_output + sigma_t * sample
        else:
            raise ValueError(f"Unknown prediction_type '{self.prediction_type}'")
        if self.thresholding:
            x0 = dynamic_threshold(x0, self.dynamic_thresholding_ratio, self.sample_max_value)
        elif self.clip_sample:
            x0 = torch.clamp(x0, -self.clip_sample_range, self.clip_sample_range)
        return eps if self.algorithm_type == "dpmsolver" else x0

    def _use_first_order(self, index: int, n: int, order_count: int) -> bool:
        if self.solver_order == 1 or order_count < 1:
            return True
        # diffusers forces a first-order FINAL step under euler_at_final,
        # lower_order_final with n < 15, or a zero final sigma (the ++ default)
        final_sigma_zero = self._final_sigmas_type_resolved() == "zero"
        return index == n - 1 and (self.euler_at_final or final_sigma_zero
                                   or (self.lower_order_final and n < 15))

    def step(
        self,
        state: Dict[str, Any],
        model_output: torch.Tensor,
        index: int,
        sample: torch.Tensor,
        timesteps: np.ndarray,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Dict[str, Any], torch.Tensor]:
        n = len(timesteps)
        sigmas = self.sigmas_for(timesteps)
        sigma_s0, sigma_t, sigma_s1 = sigmas[index], sigmas[index + 1], sigmas[max(index - 1, 0)]

        x32 = sample.float()
        m0 = self._convert_model_output(model_output.float(), x32, sigma_s0)

        alpha_t, sigma_t_ = self._alpha_sigma(sigma_t)
        alpha_s0, sigma_s0_ = self._alpha_sigma(sigma_s0)
        alpha_s1, sigma_s1_ = self._alpha_sigma(sigma_s1)
        tiny = _f32(1e-10)
        lam_t = torch.log(alpha_t) - torch.log(torch.maximum(sigma_t_, tiny))
        lam_s0 = torch.log(alpha_s0) - torch.log(torch.maximum(sigma_s0_, tiny))
        lam_s1 = torch.log(alpha_s1) - torch.log(torch.maximum(sigma_s1_, tiny))
        h = lam_t - lam_s0
        safe_h = h if float(h) != 0.0 else _f32(1.0)

        if self.algorithm_type == "dpmsolver++":
            # x_t = (sigma_t/sigma_s0) x - alpha_t (e^{-h} - 1) D0
            ratio = sigma_t_ / torch.maximum(sigma_s0_, tiny)
            phi = torch.expm1(-h)
            first = float(ratio) * x32 - float(alpha_t * phi) * m0
        else:
            # dpmsolver (eps space): x_t = (alpha_t/alpha_s0) x - sigma_t (e^{h} - 1) D0
            ratio = alpha_t / alpha_s0
            phi = torch.expm1(h)
            first = float(ratio) * x32 - float(sigma_t_ * phi) * m0

        order_count = state["order_count"]
        if self._use_first_order(index, n, order_count):
            prev_sample = first
        else:
            r0 = (lam_s0 - lam_s1) / safe_h
            d1 = (m0 - state["prev_m"]) / float(r0 if float(r0) != 0.0 else _f32(1.0))
            heun = self.solver_type == "heun"
            if self.algorithm_type == "dpmsolver++":
                # midpoint: - 0.5 alpha_t (e^{-h}-1) D1; heun: + alpha_t ((e^{-h}-1)/h + 1) D1
                coef = alpha_t * (phi / safe_h + 1.0) if heun else -(0.5 * alpha_t * phi)
            else:
                # midpoint: - 0.5 sigma_t (e^{h}-1) D1; heun: - sigma_t ((e^{h}-1)/h - 1) D1
                coef = -(sigma_t_ * (phi / safe_h - 1.0)) if heun else -(0.5 * sigma_t_ * phi)
            prev_sample = first + float(coef) * d1

        new_state = {"prev_m": m0, "order_count": min(order_count + 1, self.solver_order)}
        return new_state, prev_sample.to(sample.dtype)
