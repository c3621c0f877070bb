"""
DPMSolverSDEScheduler (counterpart of ``fmdm_tpu/schedulers/dpm_sde.py``):
the stochastic second-order (midpoint) ancestral solver of k-diffusion's
``sample_dpmpp_sde``, as diffusers' ``DPMSolverSDEScheduler`` packages it.

- ``set_timesteps(n)`` returns an interleaved float schedule of 2n-1 calls:
  main timesteps at even positions, log-sigma midpoints at odd ones. The
  model runs at every entry, so n steps cost 2n-1 model calls.
- Each main-to-main advance is an ancestral pair: the even call moves the
  sample to the midpoint sigma and stores the pair's start sample; the odd
  call completes the move from the stored start with the midpoint's
  denoisement. Noise enters with the ancestral ``sigma_up``.
- Samples live at scale ``x0 + sigma * eps``: ``scale_model_input`` divides
  by sqrt(sigma² + 1) and ``init_noise_sigma`` is sigma_max.

Every per-call scalar is computed host side in float64 into flat tables
indexed by the call's position (``_sigma_call``, ``_blend_a``, ``_blend_b``,
``_noise_up``, ``_is_second``), then held in f32 as JAX holds them. A sliced
schedule (``start_step``/``last_n_steps``) is a suffix of the calls: position
i reads table entry i + ``_offset``. ``step`` draws one z per call from
``generator`` or takes it as ``noise`` (f32, the sample's shape), and raises
with neither.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from fmdm_tpu_torch.schedulers.base import Scheduler, check_unimplemented_kwargs, make_beta_schedule

# diffusers.DPMSolverSDEScheduler ctor params recognized but not implemented.
# noise_sampler_seed selects a noise stream, not an update rule, and is
# accepted as a no-op, as the JAX version accepts it.
_UNIMPLEMENTED = frozenset({"trained_betas", "timestep_spacing", "steps_offset"})

_F32 = torch.float32


def _sigma_to_t(sigma: np.ndarray, log_sigmas: np.ndarray) -> np.ndarray:
    """Fractional training timestep whose log-sigma interpolates to
    ``sigma`` (diffusers ``_sigma_to_t``)."""
    log_sigma = np.log(np.asarray(sigma, np.float64))
    dists = log_sigma[..., None] - log_sigmas[None, :]
    low_idx = np.cumsum((dists >= 0), axis=-1).argmax(axis=-1).clip(max=log_sigmas.shape[0] - 2)
    high_idx = low_idx + 1
    low, high = log_sigmas[low_idx], log_sigmas[high_idx]
    w = np.clip((low - log_sigma) / (low - high), 0, 1)
    return (1 - w) * low_idx + w * high_idx


def _karras_sigmas(in_sigmas: np.ndarray, rho: float = 7.0) -> np.ndarray:
    sigma_min, sigma_max = in_sigmas[-1], in_sigmas[0]
    ramp = np.linspace(0, 1, len(in_sigmas))
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    return (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho


def _ancestral(frm: float, to: float) -> Tuple[float, float, float]:
    """(a, b, up) of the ancestral move frm -> to: prev = a X + b denoised + up z."""
    up = min(to, np.sqrt(to**2 * (frm**2 - to**2) / frm**2))
    down = np.sqrt(to**2 - up**2)
    return down / frm, -np.expm1(np.log(down) - np.log(frm)), up


@dataclasses.dataclass(frozen=True)
class DPMSolverSDEScheduler(Scheduler):
    num_train_timesteps: int = 1000
    alphas_cumprod: np.ndarray = None
    prediction_type: str = "epsilon"
    use_karras_sigmas: bool = False
    s_noise: float = 1.0
    num_inference_steps: Optional[int] = None
    init_noise_sigma: float = 1.0
    # set_timesteps adds the per-call tables as attributes (not fields, as in
    # JAX): _sigma_call, _blend_a, _blend_b, _noise_up, _is_second, _full_len

    @classmethod
    def create(
        cls,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.0001,
        beta_end: float = 0.02,
        beta_schedule: str = "linear",
        prediction_type: str = "epsilon",
        use_karras_sigmas: bool = False,
        s_noise: float = 1.0,
        noise_sampler_seed: Optional[int] = None,  # accepted no-op (see above)
        **extra,
    ) -> "DPMSolverSDEScheduler":
        check_unimplemented_kwargs(cls.__name__, extra, _UNIMPLEMENTED)
        betas = make_beta_schedule(beta_schedule, num_train_timesteps, beta_start, beta_end)
        return cls(
            num_train_timesteps=num_train_timesteps,
            alphas_cumprod=np.cumprod(1.0 - betas),
            prediction_type=prediction_type,
            use_karras_sigmas=use_karras_sigmas,
            s_noise=s_noise,
        )

    # -- schedule construction -----------------------------------------------
    def _train_sigmas(self) -> np.ndarray:
        acp = np.asarray(self.alphas_cumprod, np.float64)
        return np.sqrt((1.0 - acp) / acp)

    def set_timesteps(self, num_inference_steps: int) -> np.ndarray:
        n = int(num_inference_steps)
        object.__setattr__(self, "num_inference_steps", n)
        sigmas_train = self._train_sigmas()
        log_sigmas = np.log(sigmas_train)

        # 'linspace' over float training timesteps, sigma interpolated at each
        timesteps_f = np.linspace(0, self.num_train_timesteps - 1, n, dtype=np.float64)[::-1].copy()
        sigmas = np.interp(timesteps_f, np.arange(self.num_train_timesteps), sigmas_train)
        if self.use_karras_sigmas:
            sigmas = _karras_sigmas(sigmas)
            timesteps_f = _sigma_to_t(sigmas, log_sigmas)

        # log-sigma midpoints of each consecutive main pair
        t_main = -np.log(sigmas)
        t_mid = t_main[:-1] + 0.5 * (t_main[1:] - t_main[:-1])
        sig_mid = np.exp(-t_mid)

        # interleave: [t0, m0, t1, m1, ..., t_{n-1}] (2n-1 calls)
        calls = 2 * n - 1
        interleaved = np.empty((calls,), np.float64)
        interleaved[0::2] = timesteps_f
        interleaved[1::2] = _sigma_to_t(sig_mid, log_sigmas)

        sigma_call = np.empty((calls,), np.float64)  # the sigma the model sees
        blend_a = np.zeros((calls,), np.float64)     # prev = a X + b denoised + up z
        blend_b = np.ones((calls,), np.float64)
        noise_up = np.zeros((calls,), np.float64)
        is_second = np.zeros((calls,), bool)
        sigma_call[0::2] = sigmas
        sigma_call[1::2] = sig_mid
        is_second[1::2] = True
        for m in range(n - 1):
            # even call: ancestral move s_m -> midpoint; odd call: from the
            # stored start, the full move s_m -> s_{m+1}
            blend_a[2 * m], blend_b[2 * m], noise_up[2 * m] = _ancestral(sigmas[m], sig_mid[m])
            blend_a[2 * m + 1], blend_b[2 * m + 1], noise_up[2 * m + 1] = _ancestral(
                sigmas[m], sigmas[m + 1])
        # the final call (sigma_next = 0) lands on the denoisement: a=0, b=1, up=0

        for name, table in (("_sigma_call", sigma_call), ("_blend_a", blend_a),
                            ("_blend_b", blend_b), ("_noise_up", noise_up)):
            object.__setattr__(self, name, table.astype(np.float32))
        object.__setattr__(self, "_is_second", is_second)
        object.__setattr__(self, "_full_len", calls)
        object.__setattr__(self, "init_noise_sigma", float(sigmas[0]))
        return interleaved.astype(np.float32)

    def _offset(self, timesteps) -> int:
        # a sliced schedule keeps a suffix: position i reads entry i + offset
        return self._full_len - len(timesteps)

    def align_sliced_timesteps(self, timesteps: np.ndarray) -> np.ndarray:
        """Trim a leading midpoint call, so that a sliced schedule starts on a
        first-order call, which stores the anchor its second-order call reads."""
        timesteps = np.asarray(timesteps)
        if self._offset(timesteps) % 2 == 1 and timesteps.shape[0] > 1:
            timesteps = timesteps[1:]
        return timesteps

    def init_noise_scale(self, timesteps: np.ndarray) -> float:
        """Pure noise enters a sliced schedule at its first call's sigma."""
        return float(self._sigma_call[self._offset(timesteps)])

    # -- engine API -------------------------------------------------------------
    @property
    def needs_noise(self) -> bool:
        return True

    def init_state(self, timesteps: np.ndarray, sample: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        if sample is None:
            raise ValueError("DPMSolverSDEScheduler.init_state needs a sample template")
        return {"stored": torch.zeros(sample.shape, dtype=_F32, device=sample.device)}

    def scale_model_input(self, sample: torch.Tensor, index: int, timesteps) -> torch.Tensor:
        sigma = torch.tensor(self._sigma_call[index + self._offset(timesteps)], dtype=_F32)
        return sample / float(torch.sqrt(sigma ** 2 + 1.0))

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        sigmas_train = torch.as_tensor(self._train_sigmas(), dtype=_F32, device=x0.device)
        sigma = sigmas_train[t.long()]
        return x0 + sigma.reshape(sigma.shape + (1,) * (x0.dim() - sigma.dim())) * noise

    def _denoised(self, model_output: torch.Tensor, sample: torch.Tensor, sigma: torch.Tensor):
        if self.prediction_type == "epsilon":
            return sample - float(sigma) * model_output
        if self.prediction_type == "v_prediction":
            return (model_output * float(-sigma / torch.sqrt(sigma ** 2 + 1.0))
                    + sample / float(sigma ** 2 + 1.0))
        if self.prediction_type == "sample":
            return model_output
        raise ValueError(f"Unknown prediction_type '{self.prediction_type}'")

    def step(
        self,
        state: Dict[str, Any],
        model_output: torch.Tensor,
        index: int,
        sample: torch.Tensor,
        timesteps,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[Dict[str, Any], torch.Tensor]:
        if noise is None and generator is None:
            raise ValueError("DPMSolverSDEScheduler.step requires a generator or a noise tensor.")
        j = index + self._offset(timesteps)
        sigma = torch.tensor(self._sigma_call[j], dtype=_F32)
        x32 = sample.float()
        denoised = self._denoised(model_output.float(), x32, sigma)
        # first-order calls act on (and store) the incoming sample; second-
        # order calls act on the pair's stored start sample
        anchor = state["stored"] if self._is_second[j] else x32
        if noise is None:
            noise = torch.randn(sample.shape, generator=generator, device=sample.device, dtype=_F32)
        up = torch.tensor(self.s_noise, dtype=_F32) * torch.tensor(self._noise_up[j], dtype=_F32)
        prev = (float(self._blend_a[j]) * anchor + float(self._blend_b[j]) * denoised
                + float(up) * noise.float())
        return {"stored": anchor}, prev
