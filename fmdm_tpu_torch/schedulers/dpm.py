"""
DPM-Solver multistep scheduler (counterpart of
``fmdm_tpu/schedulers/dpm.py:43-402``), diffusers
``DPMSolverMultistepScheduler`` semantics: orders 1, 2 and 3, algorithms
'dpmsolver++', 'dpmsolver' and 'sde-dpmsolver++' (orders 1-2), midpoint and
heun solvers, Karras sigmas, linspace / leading / trailing spacing,
lower_order_final, euler_at_final, final sigma zero or sigma_min, and
epsilon / sample / v prediction.

The sigma tables and every scalar coefficient are computed in float32, as the
JAX version computes them (``dpm.py:200-224``); the sample math runs in f32.
'sde-dpmsolver++' draws each step's noise from ``generator`` or takes it as
``noise`` (f32, the sample's shape), and raises with neither.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from fmdm_tpu_torch.schedulers.base import (
    Scheduler,
    alpha_sigma,
    check_unimplemented_kwargs,
    dynamic_threshold,
    f32,
    karras_timesteps,
    log_snr,
    make_beta_schedule,
    nonzero_or_one,
    spaced_timesteps,
    step_sigmas,
)

# diffusers ctor params that are recognized but not implemented: refused
_UNIMPLEMENTED = frozenset({
    "trained_betas", "use_lu_lambdas", "use_exponential_sigmas",
    "use_beta_sigmas", "use_flow_sigmas", "flow_shift", "lambda_min_clipped",
    "variance_type", "rescale_betas_zero_snr",
})

_F32 = torch.float32


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
    use_karras_sigmas: bool = False
    timestep_spacing: str = "linspace"
    steps_offset: int = 0
    # None -> diffusers-compatible auto: "zero" for the x0-space algorithms,
    # "sigma_min" for the eps-space 'dpmsolver' (which rejects zero)
    final_sigmas_type: Optional[str] = None
    num_inference_steps: Optional[int] = None
    # per-step sigmas stashed by set_timesteps under use_karras_sigmas (they
    # are no longer a function of the rounded integer timesteps)
    _karras_sigmas: Optional[np.ndarray] = None

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
        if solver_order not in (1, 2, 3):
            raise ValueError(f"solver_order must be 1, 2 or 3 (diffusers surface); got {solver_order}")
        if algorithm_type not in ("dpmsolver", "dpmsolver++", "sde-dpmsolver++"):
            raise ValueError(f"Unknown algorithm_type '{algorithm_type}'")
        if solver_type not in ("midpoint", "heun"):
            raise ValueError(f"solver_type must be 'midpoint' or 'heun' (diffusers surface); "
                             f"got '{solver_type}'")
        if timestep_spacing not in ("linspace", "leading", "trailing"):
            raise ValueError(f"Unknown timestep_spacing '{timestep_spacing}'")
        if solver_order == 3 and algorithm_type == "sde-dpmsolver++":
            raise ValueError("sde-dpmsolver++ supports solver_order <= 2 (as in diffusers)")
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
            use_karras_sigmas=use_karras_sigmas,
            timestep_spacing=timestep_spacing,
            steps_offset=steps_offset,
            final_sigmas_type=final_sigmas_type,
        )

    # -- forward process ----------------------------------------------------
    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        acp = torch.as_tensor(self.alphas_cumprod, dtype=_F32, device=x0.device)[t]
        shape = acp.shape + (1,) * (x0.dim() - acp.dim())
        return torch.sqrt(acp).reshape(shape) * x0 + torch.sqrt(1 - acp).reshape(shape) * noise

    @property
    def needs_noise(self) -> bool:
        return self.algorithm_type == "sde-dpmsolver++"

    # -- reverse process ------------------------------------------------------
    def set_timesteps(self, num_inference_steps: int) -> np.ndarray:
        object.__setattr__(self, "num_inference_steps", num_inference_steps)
        timesteps = spaced_timesteps(self.timestep_spacing, self.num_train_timesteps,
                                     num_inference_steps, self.steps_offset)
        karras = None
        if self.use_karras_sigmas:
            # step() reads the continuous sigmas, stashed
            timesteps, karras = karras_timesteps(self.alphas_cumprod, num_inference_steps)
        object.__setattr__(self, "_karras_sigmas", karras)
        return timesteps

    def init_state(self, timesteps: np.ndarray, sample: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        if sample is None:
            raise ValueError("DPMSolverMultistepScheduler.init_state needs a sample template")
        state = {"prev_m": torch.zeros(sample.shape, dtype=_F32, device=sample.device),
                 "order_count": 0}
        if self.solver_order >= 3:
            state["prev_m2"] = torch.zeros(sample.shape, dtype=_F32, device=sample.device)
        return state

    def _final_sigmas_type_resolved(self) -> str:
        if self.final_sigmas_type is not None:
            return self.final_sigmas_type
        return "sigma_min" if self.algorithm_type == "dpmsolver" else "zero"

    def sigmas_for(self, timesteps: np.ndarray) -> torch.Tensor:
        """f32 sigma at each selected timestep, plus the trailing final sigma."""
        return step_sigmas(self.alphas_cumprod, timesteps,
                           self._final_sigmas_type_resolved() == "sigma_min",
                           self.use_karras_sigmas, self._karras_sigmas)

    def _convert_model_output(self, model_output, sample, sigma):
        """epsilon/sample/v -> x0 (dpmsolver++, sde-dpmsolver++) or eps (dpmsolver)."""
        alpha_t, sigma_t = (float(v) for v in alpha_sigma(sigma))
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

    def _order(self, index: int, n: int, order_count: int) -> int:
        """The order of step ``index`` of ``n``: warm-up from 1, and diffusers'
        forced lower orders at the end of the schedule."""
        order = min(order_count + 1, self.solver_order)
        if order == 1:
            return 1
        # a first-order FINAL step under euler_at_final, lower_order_final with
        # n < 15, or a zero final sigma (the default of the x0-space algorithms)
        final_sigma_zero = self._final_sigmas_type_resolved() == "zero"
        short = self.lower_order_final and n < 15
        if index == n - 1 and (self.euler_at_final or final_sigma_zero or short):
            return 1
        if order == 3 and short and index == n - 2:
            return 2
        return order

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
        sde = self.algorithm_type == "sde-dpmsolver++"
        if sde and noise is None and generator is None:
            raise ValueError("sde-dpmsolver++ step requires a generator or a noise tensor.")
        n = len(timesteps)
        sigmas = self.sigmas_for(timesteps)
        sigma_s0, sigma_t = sigmas[index], sigmas[index + 1]

        x32 = sample.float()
        m0 = self._convert_model_output(model_output.float(), x32, sigma_s0)

        alpha_t, sigma_t_ = alpha_sigma(sigma_t)
        alpha_s0, sigma_s0_ = alpha_sigma(sigma_s0)
        tiny = f32(1e-10)
        lam_t, lam_s0 = log_snr(sigma_t), log_snr(sigma_s0)
        lam_s1 = log_snr(sigmas[max(index - 1, 0)])
        h = lam_t - lam_s0
        safe_h = nonzero_or_one(h)

        if self.algorithm_type == "dpmsolver++":
            # x_t = (sigma_t/sigma_s0) x - alpha_t (e^{-h} - 1) D0
            phi = torch.expm1(-h)
            first = float(sigma_t_ / torch.maximum(sigma_s0_, tiny)) * x32 - float(alpha_t * phi) * m0
        elif sde:
            # x_t = (sigma_t/sigma_s0) e^{-h} x + sigma_t sqrt(1-e^{-2h}) z + alpha_t (1-e^{-2h}) D0
            if noise is None:
                noise = torch.randn(sample.shape, generator=generator, device=sample.device,
                                    dtype=_F32)
            phi = -torch.expm1(-2.0 * h)
            ratio = (sigma_t_ / torch.maximum(sigma_s0_, tiny)) * torch.exp(-h)
            base = float(ratio) * x32 + float(sigma_t_ * torch.sqrt(torch.clamp(phi, min=0.0))) * noise.float()
            first = base + float(alpha_t * phi) * m0
        else:
            # dpmsolver (eps space): x_t = (alpha_t/alpha_s0) x - sigma_t (e^{h} - 1) D0
            phi = torch.expm1(h)
            first = float(alpha_t / alpha_s0) * x32 - float(sigma_t_ * phi) * m0

        order_count = state["order_count"]
        order = self._order(index, n, order_count)
        heun = self.solver_type == "heun"
        if order == 1:
            prev_sample = first
        elif order == 2:
            r0 = (lam_s0 - lam_s1) / safe_h
            d1 = (m0 - state["prev_m"]) / float(nonzero_or_one(r0))
            if self.algorithm_type == "dpmsolver++":
                # midpoint: - 0.5 alpha_t (e^{-h}-1) D1; heun: + alpha_t ((e^{-h}-1)/h + 1) D1
                coef = alpha_t * (phi / safe_h + 1.0) if heun else -(0.5 * alpha_t * phi)
            elif sde:
                # midpoint: + 0.5 alpha_t (1-e^{-2h}) D1; heun: + alpha_t ((1-e^{-2h})/(-2h) + 1) D1
                coef = alpha_t * (phi / (-2.0 * safe_h) + 1.0) if heun else 0.5 * alpha_t * phi
            else:
                # midpoint: - 0.5 sigma_t (e^{h}-1) D1; heun: - sigma_t ((e^{h}-1)/h - 1) D1
                coef = -(sigma_t_ * (phi / safe_h - 1.0)) if heun else -(0.5 * sigma_t_ * phi)
            prev_sample = first + float(coef) * d1
        else:
            # third order (diffusers multistep_dpm_solver_third_order_update)
            lam_s2 = log_snr(sigmas[max(index - 2, 0)])
            r0 = (lam_s0 - lam_s1) / safe_h
            r1 = (lam_s1 - lam_s2) / safe_h
            rsum = float(nonzero_or_one(r0 + r1))
            d1_0 = (m0 - state["prev_m"]) / float(nonzero_or_one(r0))
            d1_1 = (state["prev_m"] - state["prev_m2"]) / float(nonzero_or_one(r1))
            d1 = d1_0 + float(r0 / rsum) * (d1_0 - d1_1)
            d2 = (d1_0 - d1_1) / rsum
            if self.algorithm_type == "dpmsolver++":
                c1 = alpha_t * (phi / safe_h + 1.0)
                c2 = alpha_t * ((phi + h) / safe_h ** 2 - 0.5)
                prev_sample = first + float(c1) * d1 - float(c2) * d2
            else:
                c1 = sigma_t_ * (phi / safe_h - 1.0)
                c2 = sigma_t_ * ((phi - h) / safe_h ** 2 - 0.5)
                prev_sample = first - float(c1) * d1 - float(c2) * d2

        new_state = {"prev_m": m0, "order_count": min(order_count + 1, self.solver_order)}
        if self.solver_order >= 3:
            new_state["prev_m2"] = state["prev_m"]
        return new_state, prev_sample.to(sample.dtype)

