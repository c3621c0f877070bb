"""
UniPC multistep scheduler (counterpart of
``fmdm_tpu/schedulers/unipc.py:69-361``), diffusers
``UniPCMultistepScheduler`` semantics: the bh1 and bh2 variants, predictor
and corrector at orders 1-3, predict_x0, Karras sigmas, lower_order_final,
linspace / leading / trailing spacing, final sigma zero or sigma_min.

The state carries the last three converted model outputs, the pre-predictor
sample (for the corrector), the warm-up count and the order the previous
predictor used (the corrector of step i runs at that order, as diffusers'
``self.this_order``). The R-matrix solves of diffusers are the JAX version's
closed forms in f32 (``_solve2``/``_solve3``, a Cramer solve), not float64 or
``torch.linalg.solve``, which would round otherwise. Every scalar is f32; the
sample math runs in f32.
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

# diffusers.UniPCMultistepScheduler ctor params recognized but not implemented
_UNIMPLEMENTED = frozenset({
    "trained_betas", "disable_corrector", "solver_p",
    "use_exponential_sigmas", "use_beta_sigmas", "use_flow_sigmas",
    "flow_shift", "rescale_betas_zero_snr",
})

_F32 = torch.float32


def _solve2(r1, r2, b1, b2):
    """[[1,1],[r1,r2]] @ [x0,x1] = [b1,b2] (f32 scalars)."""
    den = nonzero_or_one(r2 - r1)
    return (b1 * r2 - b2) / den, (b2 - b1 * r1) / den


def _solve3(r1, r2, b1, b2, b3):
    """[[1,1,1],[r1,r2,1],[r1^2,r2^2,1]] @ x = [b1,b2,b3] by Cramer's rule (f32)."""
    a11, a12, a13 = 1.0, 1.0, 1.0
    a21, a22, a23 = r1, r2, 1.0
    a31, a32, a33 = r1 * r1, r2 * r2, 1.0

    def det(m11, m12, m13, m21, m22, m23, m31, m32, m33):
        return (m11 * (m22 * m33 - m23 * m32)
                - m12 * (m21 * m33 - m23 * m31)
                + m13 * (m21 * m32 - m22 * m31))

    d = nonzero_or_one(det(a11, a12, a13, a21, a22, a23, a31, a32, a33))
    x0 = det(b1, a12, a13, b2, a22, a23, b3, a32, a33) / d
    x1 = det(a11, b1, a13, a21, b2, a23, a31, b3, a33) / d
    x2 = det(a11, a12, b1, a21, a22, b2, a31, a32, b3) / d
    return x0, x1, x2


@dataclasses.dataclass(frozen=True)
class UniPCMultistepScheduler(Scheduler):
    num_train_timesteps: int = 1000
    alphas_cumprod: np.ndarray = None
    solver_order: int = 2
    predict_x0: bool = True
    prediction_type: str = "epsilon"
    lower_order_final: bool = True
    solver_type: str = "bh2"
    clip_sample: bool = False
    clip_sample_range: float = 1.0
    thresholding: bool = False
    dynamic_thresholding_ratio: float = 0.995
    sample_max_value: float = 1.0
    use_karras_sigmas: bool = False
    timestep_spacing: str = "linspace"
    steps_offset: int = 0
    final_sigmas_type: str = "zero"
    num_inference_steps: Optional[int] = None
    _karras_sigmas: Optional[np.ndarray] = None

    @classmethod
    def create(
        cls,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.0001,
        beta_end: float = 0.02,
        beta_schedule: str = "linear",
        solver_order: int = 2,
        predict_x0: bool = True,
        prediction_type: str = "epsilon",
        lower_order_final: bool = True,
        solver_type: str = "bh2",
        clip_sample: bool = False,
        clip_sample_range: float = 1.0,
        thresholding: bool = False,
        dynamic_thresholding_ratio: float = 0.995,
        sample_max_value: float = 1.0,
        use_karras_sigmas: bool = False,
        timestep_spacing: str = "linspace",
        steps_offset: int = 0,
        final_sigmas_type: str = "zero",
        **extra,
    ) -> "UniPCMultistepScheduler":
        check_unimplemented_kwargs(cls.__name__, extra, _UNIMPLEMENTED)
        if solver_order not in (1, 2, 3):
            raise ValueError(f"UniPC solver_order must be 1, 2 or 3 (diffusers surface); got {solver_order}")
        if solver_type not in ("bh1", "bh2"):
            raise ValueError(f"UniPC solver_type must be 'bh1' or 'bh2'; got '{solver_type}'")
        if timestep_spacing not in ("linspace", "leading", "trailing"):
            raise ValueError(f"Unknown timestep_spacing '{timestep_spacing}'")
        if final_sigmas_type not in ("zero", "sigma_min"):
            raise ValueError(f"Unknown final_sigmas_type '{final_sigmas_type}'")
        betas = make_beta_schedule(beta_schedule, num_train_timesteps, beta_start, beta_end)
        return cls(
            num_train_timesteps=num_train_timesteps,
            alphas_cumprod=np.cumprod(1.0 - betas),
            solver_order=solver_order,
            predict_x0=predict_x0,
            prediction_type=prediction_type,
            lower_order_final=lower_order_final,
            solver_type=solver_type,
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

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        acp = torch.as_tensor(self.alphas_cumprod, dtype=_F32, device=x0.device)[t.long()]
        shape = acp.shape + (1,) * (x0.dim() - acp.dim())
        return torch.sqrt(acp).reshape(shape) * x0 + torch.sqrt(1 - acp).reshape(shape) * noise

    def set_timesteps(self, num_inference_steps: int) -> np.ndarray:
        object.__setattr__(self, "num_inference_steps", num_inference_steps)
        timesteps = spaced_timesteps(self.timestep_spacing, self.num_train_timesteps,
                                     num_inference_steps, self.steps_offset)
        karras = None
        if self.use_karras_sigmas:  # the DPM-Solver remap
            timesteps, karras = karras_timesteps(self.alphas_cumprod, num_inference_steps)
        object.__setattr__(self, "_karras_sigmas", karras)
        return timesteps

    def init_state(self, timesteps: np.ndarray, sample: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        if sample is None:
            raise ValueError("UniPCMultistepScheduler.init_state needs a sample template")
        z = torch.zeros(sample.shape, dtype=_F32, device=sample.device)
        state = {"m_s0": z, "m_s1": z, "last_sample": z, "order_count": 0, "prev_this_order": 1}
        if self.solver_order >= 3:
            state["m_s2"] = z
        return state

    def sigmas_for(self, timesteps: np.ndarray) -> torch.Tensor:
        """f32 sigma at each selected timestep, plus the trailing final sigma."""
        return step_sigmas(self.alphas_cumprod, timesteps, self.final_sigmas_type == "sigma_min",
                           self.use_karras_sigmas, self._karras_sigmas)

    def _convert(self, model_output, sample, sigma):
        alpha_t, sigma_t = (float(v) for v in alpha_sigma(sigma))
        if self.prediction_type == "epsilon":
            x0 = (sample - sigma_t * model_output) / alpha_t
            eps = model_output
        elif self.prediction_type == "sample":
            x0, eps = model_output, (sample - alpha_t * model_output) / sigma_t
        elif self.prediction_type == "v_prediction":
            x0 = alpha_t * sample - sigma_t * model_output
            eps = alpha_t * model_output + sigma_t * sample
        else:
            raise ValueError(f"Unknown prediction_type '{self.prediction_type}'")
        if self.thresholding:
            x0 = dynamic_threshold(x0, self.dynamic_thresholding_ratio, self.sample_max_value)
        elif self.clip_sample:
            x0 = torch.clamp(x0, -self.clip_sample_range, self.clip_sample_range)
        return x0 if self.predict_x0 else eps

    def _b_coeffs(self, h):
        """(h_phi_1, B_h, b1, b2, b3) of the diffusers b-vector recursion."""
        hh = -h if self.predict_x0 else h
        h_phi_1 = torch.expm1(hh)
        B_h = hh if self.solver_type == "bh1" else torch.expm1(hh)
        h_phi_k = h_phi_1 / hh - 1.0
        b1 = h_phi_k * 1.0 / B_h
        h_phi_k = h_phi_k / hh - 0.5
        b2 = h_phi_k * 2.0 / B_h
        h_phi_k = h_phi_k / hh - 1.0 / 6.0
        b3 = h_phi_k * 6.0 / B_h
        return h_phi_1, B_h, b1, b2, b3

    def _base(self, sample, m, sigma_to, sigma_from, h_phi_1, B_h):
        """The order-1 move of ``sample`` from sigma_from to sigma_to with the
        converted output ``m``, and the coefficient of the higher-order terms."""
        alpha_to, sigma_to_ = alpha_sigma(sigma_to)
        alpha_from, sigma_from_ = alpha_sigma(sigma_from)
        if self.predict_x0:
            ratio = sigma_to_ / torch.maximum(sigma_from_, f32(1e-10))
            return (float(ratio) * sample - float(alpha_to * h_phi_1) * m,
                    alpha_to * B_h)
        return (float(alpha_to / alpha_from) * sample - float(sigma_to_ * h_phi_1) * m,
                sigma_to_ * B_h)

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
        order = self.solver_order
        sigmas = self.sigmas_for(timesteps)
        sigma_s0, sigma_t = sigmas[index], sigmas[index + 1]
        lam = [log_snr(sigmas[max(index - k, 0)]) for k in range(4)]  # s0, s-1, s-2, s-3
        lam_t = log_snr(sigma_t)

        x32 = sample.float()
        m_t = self._convert(model_output.float(), x32, sigma_s0)
        m_s0, m_s1 = state["m_s0"], state["m_s1"]
        m_s2 = state.get("m_s2", m_s1)
        order_count = state["order_count"]

        # corrector: refine the arrived sample with m_t, over s_{-1} -> s_0 at
        # the order the previous predictor used (diffusers' self.this_order);
        # m_t stays as converted from the sample before the corrector
        x_cur = x32
        if order_count > 0:
            hc = lam[0] - lam[1]
            safe_hc = nonzero_or_one(hc)
            r1c = (lam[2] - lam[1]) / safe_hc
            r2c = (lam[3] - lam[1]) / safe_hc
            h_phi_1c, B_hc, b1c, b2c, b3c = self._b_coeffs(hc)
            xc_, coeff_c = self._base(state["last_sample"], m_s0, sigma_s0,
                                      sigmas[max(index - 1, 0)], h_phi_1c, B_hc)
            d1_t = m_t - m_s0
            corrector_order = min(state["prev_this_order"], order)
            if corrector_order == 1:
                x_cur = xc_ - float(coeff_c) * (0.5 * d1_t)
            elif corrector_order == 2:
                rho0, rho1 = _solve2(r1c, f32(1.0), b1c, b2c)
                d1s0 = (m_s1 - m_s0) / float(nonzero_or_one(r1c))
                x_cur = xc_ - float(coeff_c) * (float(rho0) * d1s0 + float(rho1) * d1_t)
            else:
                rho0, rho1, rho2 = _solve3(r1c, r2c, b1c, b2c, b3c)
                d1s0 = (m_s1 - m_s0) / float(nonzero_or_one(r1c))
                d1s1 = (m_s2 - m_s0) / float(nonzero_or_one(r2c))
                x_cur = xc_ - float(coeff_c) * (float(rho0) * d1s0 + float(rho1) * d1s1
                                                + float(rho2) * d1_t)

        # predictor: advance s_0 -> t
        this_order = min(order_count + 1, order)
        if self.lower_order_final:
            this_order = min(this_order, n - index)
        hp = lam_t - lam[0]
        safe_hp = nonzero_or_one(hp)
        h_phi_1p, B_hp, b1p, b2p, _ = self._b_coeffs(hp)
        xp_, coeff_p = self._base(x_cur, m_t, sigma_t, sigma_s0, h_phi_1p, B_hp)
        if this_order == 1:
            prev_sample = xp_
        else:
            r1p = (lam[1] - lam[0]) / safe_hp
            d1s0 = (m_s0 - m_t) / float(nonzero_or_one(r1p))
            if this_order == 2:
                # diffusers hardcodes rhos_p = [0.5] at order 2
                prev_sample = xp_ - float(coeff_p) * (0.5 * d1s0)
            else:
                r2p = (lam[2] - lam[0]) / safe_hp
                rho0, rho1 = _solve2(r1p, r2p, b1p, b2p)
                d1s1 = (m_s1 - m_t) / float(nonzero_or_one(r2p))
                prev_sample = xp_ - float(coeff_p) * (float(rho0) * d1s0 + float(rho1) * d1s1)

        new_state = {"m_s0": m_t, "m_s1": m_s0, "last_sample": x_cur,
                     "order_count": min(order_count + 1, order), "prev_this_order": this_order}
        if order >= 3:
            new_state["m_s2"] = m_s1
        return new_state, prev_sample.to(sample.dtype)
