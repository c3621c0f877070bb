"""
The denoising loop (counterpart of ``fmdm_tpu/sample/engine.py:32-117,124-408``).

The JAX engine compiles the reverse process into one ``lax.scan``; here it is
a Python loop over the selected timesteps. The model computes in
``compute_dtype`` (bf16 on the serving path) while the sample and the
scheduler math stay in f32. ``start_step``/``last_n_steps`` filtering happens
host-side on the timestep array. A stochastic scheduler (``needs_noise``)
draws each step's noise from a generator on the engine's device, where JAX
splits one key per step, or takes it from the caller (``step_noise``), so a
run can replay another run's draws. Under the "text" conditioning mode the
conditioning batch is a pair (tokens, pooled vector), handed to every model
call as ``context_ca`` (Stable Diffusion 3's transformer). A sigma-space scheduler (DPM-SDE) scales
each model input and the initial noise at the position of the sliced
schedule (``scale_model_input``, ``init_noise_scale``).

Under DeepCache (``deep_cache=(interval, depth[, schedule])``) the steps that
:func:`deep_cache_refresh_mask` marks run the full UNet and keep the feature
entering its shallow up blocks; the others run only the shallow levels and
splice that feature back in (``UNetDiffusersND.forward``). The cached
feature stays in the compute dtype. Interval 1 runs every step in full and
equals the uncached engine.

Over a one-process mesh of several cards (``mesh``, ``parallel/mesh.py``)
the engine keeps one replica of the model per card, copied at the first
call and reused, and splits every model call's batch over the cards; the
start noise and a stochastic scheduler's noise are drawn for the whole
batch and the scheduler steps the whole batch on the first card (a few
elementwise ops), so each sample equals the one-card sample. The shards'
forwards are issued from one Python loop with no synchronization inside
it: CUDA launches are asynchronous, so the cards overlap without threads.
Under DeepCache each shard keeps its own cached feature.

The engine scopes ``sdpa``'s sequence-parallel routing to its own mesh for
the whole call (JAX :283-301): over a one-process ``("data", "seq")`` mesh
(``parallel/mesh.py::create_dp_sp_mesh``) the batch is split over the data
rows and each row's attention at >= 512 tokens (or a caller's ``min_tokens``
set for this very mesh) runs the ring over that row's devices; over any
other mesh, or none, no routing is in force, so a trainer's process-global
context never reaches the engine's model calls.
"""

from __future__ import annotations

import contextlib
import copy
import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from fmdm_tpu_torch.device import DeviceArg, resolve_device
from fmdm_tpu_torch.ops.kernels import build
from fmdm_tpu_torch.ops import attention as attention_ops
from fmdm_tpu_torch.parallel.mesh import DataMesh, Mesh2D, replicate
from fmdm_tpu_torch.schedulers.base import Scheduler
from fmdm_tpu_torch.utils.trace import span


def map_conditioning(fn, condition):
    """``fn`` over a conditioning: None, a tensor, or a tuple of tensors (a
    text conditioning: tokens and pooled vector), each mapped."""
    if condition is None:
        return None
    if isinstance(condition, tuple):
        return tuple(fn(c) for c in condition)
    return fn(condition)


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


def deep_cache_refresh_mask(n: int, interval: int, schedule: str = "adaptive",
                            warm_frac: float = 0.15, tail_frac: float = 0.10) -> np.ndarray:
    """Which of ``n`` steps run the full UNet under DeepCache.

    'uniform': every ``interval``-th step (classic DeepCache). 'adaptive': the
    uniform backbone plus always-full head and tail windows (15% and 10% of
    the steps), where the deep features change fastest. Step 0 is always
    full: it fills the cache."""
    mask = np.zeros((n,), bool)
    mask[::max(1, int(interval))] = True
    if schedule == "adaptive":
        mask[:max(1, int(round(n * warm_frac)))] = True
        mask[n - max(1, int(round(n * tail_frac))):] = True
    elif schedule != "uniform":
        raise ValueError(f"Unknown deep_cache schedule '{schedule}'")
    mask[0] = True
    return mask


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


def shard_plan(mesh, device: torch.device):
    """(the shards' devices, each shard's sequence-parallel context) of an
    engine over ``mesh``: a ``("data", "seq")`` mesh splits over its data
    rows, each with the ring over its row (``min_tokens`` 512, or the
    current context's when it was set for this mesh); a data mesh splits
    over its devices, and no mesh is one shard on ``device``; neither has a
    context."""
    if isinstance(mesh, Mesh2D):
        if mesh.axis_names != ("data", "seq") or mesh.spans_ranks:
            raise ValueError(f"an engine splits over a one-process data or (data, seq) mesh; "
                             f"got {mesh.axis_names}")
        current = attention_ops.get_sequence_parallel()
        min_tokens = current[2] if current is not None and current[0] is mesh else 512
        return ([row[0] for row in mesh.devices],
                [(mesh, "seq", min_tokens, r) for r in range(mesh.shape[0])])
    devices = tuple(mesh.devices) if mesh is not None else (device,)
    return list(devices), [None] * len(devices)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def on_device(device: torch.device):
    """The block's launches on ``device`` (a no-op off CUDA)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class SamplingEngine:
    """Runs the reverse process of one (model, scheduler, timesteps,
    conditioning mode) configuration on one device.

    The model is moved to the device and cast to ``compute_dtype`` once, at
    the first call, and that copy is reused (the caller's module is left as it
    is unless it already has that device and dtype; either way the engine
    puts it in eval mode). With a ``mesh`` of several cards the batch is
    split over them (see the module's docstring); the engine's device is the
    mesh's first."""

    def __init__(
        self,
        model: nn.Module,
        scheduler: Scheduler,
        timesteps: np.ndarray,
        conditioning_mode: Optional[str] = None,
        latent_norm: Optional[str] = None,
        compute_dtype: Optional[torch.dtype] = None,
        *,
        deep_cache: Optional[Tuple] = None,
        device: DeviceArg = None,
        mesh: Optional[DataMesh] = None,
    ):
        self.mesh = mesh if isinstance(mesh, Mesh2D) or (
            mesh is not None and len(mesh.devices) > 1) else None
        devices, self._contexts = shard_plan(self.mesh, None)   # refreshed per call
        self.device = resolve_device(devices[0] if self.mesh is not None else device)
        # one shard per device: the mesh's, else the engine's own
        self.devices = tuple(devices) if self.mesh is not None else (self.device,)
        self.model = model
        self.scheduler = scheduler
        self.timesteps = np.asarray(scheduler.align_sliced_timesteps(np.asarray(timesteps)))
        self.conditioning_mode = conditioning_mode
        self.latent_norm = latent_norm
        self.compute_dtype = compute_dtype
        # (interval, depth[, schedule]) or None
        self.deep_cache = tuple(deep_cache) if deep_cache else None
        self._compute_model: Optional[nn.Module] = None
        self._replicas: Optional[List[nn.Module]] = None

    def _replicas_for_compute(self) -> List[nn.Module]:
        """One compute model per shard's device, copied once."""
        if self._replicas is None:
            mesh = DataMesh(self.devices) if len(self.devices) > 1 else None
            self._replicas = replicate(mesh, self._model_for_compute())
        return self._replicas

    def _forward(self, model_input: torch.Tensor, t_b: torch.Tensor,
                 cond_parts: Optional[List[torch.Tensor]], i: int, refresh, depth,
                 caches: List[Any]) -> torch.Tensor:
        """One model call, its batch split over the shards' devices (one
        shard without a mesh); the prediction on the engine's device."""
        preds = []
        parts = model_input.tensor_split(len(self.devices))
        t_parts = t_b.tensor_split(len(self.devices))
        for s, (device, model) in enumerate(zip(self.devices, self._replicas_for_compute())):
            with on_device(device), attention_ops.sequence_parallel_scope(self._contexts[s]):
                x = parts[s].to(device, non_blocking=True)
                ctx = None
                if cond_parts is not None and self.conditioning_mode == "concatenate":
                    x = torch.cat([x, cond_parts[s]], dim=1)
                elif cond_parts is not None and self.conditioning_mode in ("attention", "text"):
                    ctx = cond_parts[s]
                t_s = t_parts[s].to(device, non_blocking=True)
                if refresh is None:
                    pred = model(x, t_s, context_ca=ctx)
                elif refresh[i]:
                    pred, caches[s] = model(x, t_s, context_ca=ctx, cache_depth=depth,
                                            return_deep_feature=True)
                else:
                    pred = model(x, t_s, context_ca=ctx, deep_cache=caches[s], cache_depth=depth)
            preds.append(pred)
        if len(preds) == 1:
            return preds[0]
        return torch.cat([p.to(self.device, non_blocking=True) for p in preds])

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
        replicas = self._replicas_for_compute()
        scheduler, device = self.scheduler, self.device
        _, self._contexts = shard_plan(self.mesh, device)
        if init_sample is not None:
            current = init_sample.to(device)
        else:
            current = torch.randn(sample_shape, generator=generator, device=device,
                                  dtype=torch.float32) * scheduler.init_noise_scale(self.timesteps)
        cond = map_conditioning(lambda c: align_conditioning(c.to(device), current.shape[0]),
                                conditioning_batch)
        if cond is not None:
            if self.conditioning_mode == "attention":
                cond = prepare_attention_context(normalize_latent_conditioning(cond, self.latent_norm))
            if self.compute_dtype is not None:
                cond = map_conditioning(lambda c: c.to(self.compute_dtype), cond)
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
        refresh = depth = None
        if self.deep_cache is not None:
            interval, depth = int(self.deep_cache[0]), int(self.deep_cache[1])
            schedule = self.deep_cache[2] if len(self.deep_cache) > 2 else "adaptive"
            refresh = deep_cache_refresh_mask(len(self.timesteps), interval, schedule)
        cond_parts = None
        if cond is not None:
            n = len(replicas)
            cond_parts = [map_conditioning(lambda c: c.tensor_split(n)[s].to(d), cond)
                          for s, d in enumerate(self.devices)]
        caches = [None] * len(replicas)
        if device.type == "cuda":
            build.library()  # first-call kernel build stays outside the timed window
        _synchronize(device)

        start = time.perf_counter()
        with torch.no_grad(), span("sample.call"):
            state = scheduler.init_state(self.timesteps, current)
            x = current
            for i in range(len(self.timesteps)):
                with span("sample.model"):
                    model_input = scheduler.scale_model_input(x, i, self.timesteps)
                    if self.compute_dtype is not None:
                        model_input = model_input.to(self.compute_dtype)
                    t_b = t_all[i].expand(x.shape[0])
                    pred = self._forward(model_input, t_b, cond_parts, i, refresh, depth, caches)
                    pred = pred.float()
                with span("sample.scheduler"):
                    if step_noise is None:
                        state, x = scheduler.step(state, pred, i, x, self.timesteps,
                                                  generator=step_gen)
                    else:
                        state, x = scheduler.step(state, pred, i, x, self.timesteps,
                                                  noise=step_noise[i].to(device))
        for d in self.devices:
            _synchronize(d)
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
