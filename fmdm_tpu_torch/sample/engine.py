"""
The denoising loop (counterpart of ``fmdm_tpu/sample/engine.py:32-117,124-408``).

The JAX engine compiles the reverse process into one ``lax.scan``; here it is
a Python loop over the selected timesteps. The model computes in
``compute_dtype`` (bf16 on the serving path) while the sample and the
scheduler math stay in f32. ``start_step``/``last_n_steps`` filtering happens
host-side on the timestep array. A stochastic scheduler (``needs_noise``)
draws each step's noise from a generator on the engine's device, where JAX
splits one key per step, or takes it from the caller (``step_noise``), so a
run can replay another run's draws. A sigma-space scheduler (DPM-SDE) scales
each model input and the initial noise at the position of the sliced
schedule (``scale_model_input``, ``init_noise_scale``). Not ported: the device
mesh and DeepCache.
"""

from __future__ import annotations

import copy
import math
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from fmdm_tpu_torch.device import DeviceArg, resolve_device
from fmdm_tpu_torch.ops.kernels import build
from fmdm_tpu_torch.schedulers.base import Scheduler


def align_conditioning(condition: Optional[torch.Tensor], target_batch: int) -> Optional[torch.Tensor]:
    """Repeat a conditioning batch up to ``target_batch`` rows and cut it there."""
    if condition is None:
        return None
    if condition.shape[0] == target_batch:
        return condition
    repeats = math.ceil(target_batch / condition.shape[0])
    if repeats > 1:
        condition = torch.cat([condition] * repeats, dim=0)
    return condition[:target_batch]


def normalize_latent_conditioning(condition: Optional[torch.Tensor], mode: Optional[str]) -> Optional[torch.Tensor]:
    """Per-sample 'standardize' (unbiased std, as torch's .std()) or 'minmax'."""
    if condition is None:
        return None
    mode_value = str(mode or "none").lower()
    if mode_value in {"none", "false", "off"}:
        return condition
    eps = 1e-6
    dims = tuple(range(2, condition.dim()))
    if mode_value == "standardize":
        mean = condition.mean(dim=dims, keepdim=True)
        std = condition.std(dim=dims, keepdim=True, unbiased=True)
        return (condition - mean) / (std + eps)
    if mode_value == "minmax":
        minv = condition.amin(dim=dims, keepdim=True)
        maxv = condition.amax(dim=dims, keepdim=True)
        return (condition - minv) / (maxv - minv + eps)
    raise ValueError(f"Unknown latent_norm mode: {mode}")


def prepare_attention_context(condition: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if condition is None:
        return None
    if condition.dim() >= 3:
        return condition
    raise ValueError(f"Unsupported conditioning shape for attention: {tuple(condition.shape)}")


def select_timesteps(timesteps: np.ndarray, start_step: Optional[int] = None,
                     last_n_steps: Optional[int] = None) -> np.ndarray:
    """Host-side start_step/last_n filtering."""
    if start_step is not None:
        start_step = int(start_step)
        if start_step < 0:
            raise ValueError("start_step must be >= 0.")
        timesteps = timesteps[timesteps <= start_step]
    if last_n_steps is not None:
        last_n_steps = int(last_n_steps)
        if last_n_steps <= 0:
            raise ValueError("last_n_steps must be > 0.")
        timesteps = timesteps[-last_n_steps:]
    if timesteps.size == 0:
        raise ValueError("No timesteps selected after applying start_step/last_n_steps.")
    return timesteps


def step_generator(generator: Optional[torch.Generator], device: torch.device) -> torch.Generator:
    """The generator a stochastic scheduler's steps draw from: ``generator``
    when it lives on ``device``, else a new one on ``device`` seeded by a
    draw from ``generator`` (from torch's default generator when it is None)."""
    if generator is not None and generator.device.type == device.type and \
            (device.index is None or generator.device.index == device.index):
        return generator
    seed = torch.randint(2**62, (), generator=generator,
                         device=None if generator is None else generator.device)
    return torch.Generator(device=device).manual_seed(int(seed))


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SamplingEngine:
    """Runs the reverse process of one (model, scheduler, timesteps,
    conditioning mode) configuration on one device.

    The model is moved to the device and cast to ``compute_dtype`` once, at
    the first call, and that copy is reused (the caller's module is left as it
    is unless it already has that device and dtype; either way the engine
    puts it in eval mode)."""

    def __init__(
        self,
        model: nn.Module,
        scheduler: Scheduler,
        timesteps: np.ndarray,
        conditioning_mode: Optional[str] = None,
        latent_norm: Optional[str] = None,
        compute_dtype: Optional[torch.dtype] = None,
        *,
        device: DeviceArg = None,
    ):
        self.device = resolve_device(device)
        self.model = model
        self.scheduler = scheduler
        self.timesteps = np.asarray(scheduler.align_sliced_timesteps(np.asarray(timesteps)))
        self.conditioning_mode = conditioning_mode
        self.latent_norm = latent_norm
        self.compute_dtype = compute_dtype
        self._compute_model: Optional[nn.Module] = None

    def _model_for_compute(self) -> nn.Module:
        if self._compute_model is None:
            param = next(self.model.parameters())
            dtype = self.compute_dtype or param.dtype
            model = self.model
            if param.device != self.device or param.dtype != dtype:
                model = copy.deepcopy(model).to(device=self.device, dtype=dtype)
            self._compute_model = model.eval()
        return self._compute_model

    def __call__(
        self,
        sample_shape: Tuple[int, ...],
        generator: Optional[torch.Generator] = None,
        conditioning_batch: Optional[torch.Tensor] = None,
        init_sample: Optional[torch.Tensor] = None,
        timing: Optional[Dict[str, Any]] = None,
        step_noise: Optional[Sequence[torch.Tensor]] = None,
    ) -> torch.Tensor:
        """Sample ``sample_shape`` from pure noise (drawn with ``generator``,
        which must live on the engine's device) or from ``init_sample``. A
        stochastic scheduler's steps draw from :func:`step_generator`, or take
        ``step_noise[i]`` at step i (one tensor per selected timestep).

        ``timing`` receives ``model_seconds`` (device-synchronized seconds of
        the step loop; set-up, the kernel build and host-to-device copies are
        outside it) and ``model_calls``."""
        model = self._model_for_compute()
        scheduler, device = self.scheduler, self.device
        if init_sample is not None:
            current = init_sample.to(device)
        else:
            current = torch.randn(sample_shape, generator=generator, device=device,
                                  dtype=torch.float32) * scheduler.init_noise_scale(self.timesteps)
        cond = None
        if conditioning_batch is not None:
            cond = align_conditioning(conditioning_batch.to(device), current.shape[0])
            if self.conditioning_mode == "attention":
                cond = prepare_attention_context(normalize_latent_conditioning(cond, self.latent_norm))
            if self.compute_dtype is not None:
                cond = cond.to(self.compute_dtype)
        step_gen = None
        if step_noise is not None:
            if not scheduler.needs_noise or len(step_noise) != len(self.timesteps):
                raise ValueError(f"step_noise: {len(step_noise)} tensors for a "
                                 f"{'stochastic' if scheduler.needs_noise else 'deterministic'} "
                                 f"scheduler of {len(self.timesteps)} steps")
        elif scheduler.needs_noise:
            step_gen = step_generator(generator, device)
        int_t = np.issubdtype(self.timesteps.dtype, np.integer)
        t_all = torch.as_tensor(self.timesteps, device=device,
                                dtype=torch.int32 if int_t else torch.float32)
        if device.type == "cuda":
            build.library()  # first-call kernel build stays outside the timed window
        _synchronize(device)

        start = time.perf_counter()
        with torch.no_grad():
            state = scheduler.init_state(self.timesteps, current)
            x = current
            for i in range(len(self.timesteps)):
                model_input = scheduler.scale_model_input(x, i, self.timesteps)
                if self.compute_dtype is not None:
                    model_input = model_input.to(self.compute_dtype)
                ctx = None
                if self.conditioning_mode == "concatenate" and cond is not None:
                    model_input = torch.cat([model_input, cond], dim=1)
                elif self.conditioning_mode == "attention" and cond is not None:
                    ctx = cond
                pred = model(model_input, t_all[i].expand(x.shape[0]), context_ca=ctx).float()
                if step_noise is None:
                    state, x = scheduler.step(state, pred, i, x, self.timesteps, generator=step_gen)
                else:
                    state, x = scheduler.step(state, pred, i, x, self.timesteps,
                                              noise=step_noise[i].to(device))
        _synchronize(device)
        if timing is not None:
            timing["model_seconds"] = timing.get("model_seconds", 0.0) + (time.perf_counter() - start)
            timing["model_calls"] = timing.get("model_calls", 0) + len(self.timesteps)
        return x


def sample_with_scheduler(
    model: nn.Module,
    scheduler: Scheduler,
    num_inference_steps: int,
    sample_shape: Tuple[int, ...],
    generator: Optional[torch.Generator] = None,
    conditioning_mode: Optional[str] = None,
    conditioning_batch: Optional[torch.Tensor] = None,
    latent_norm: Optional[str] = None,
    timing: Optional[Dict[str, Any]] = None,
    start_step: Optional[int] = None,
    last_n_steps: Optional[int] = None,
    init_sample: Optional[torch.Tensor] = None,
    *,
    device: DeviceArg = None,
) -> torch.Tensor:
    """One-shot facade over :class:`SamplingEngine`."""
    timesteps = select_timesteps(scheduler.set_timesteps(num_inference_steps), start_step, last_n_steps)
    engine = SamplingEngine(model, scheduler, timesteps, conditioning_mode, latent_norm, device=device)
    return engine(sample_shape, generator, conditioning_batch=conditioning_batch,
                  init_sample=init_sample, timing=timing)
