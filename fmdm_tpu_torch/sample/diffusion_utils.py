"""
Diffusion and flow model construction and batch encode/decode (counterpart
of ``fmdm_tpu/sample/diffusion_utils.py``): the UNet built from a run's
config with its checkpoint loaded (legacy key remap, the EMA tree on
request), forward noising, and reverse sampling with a scheduler override,
``start_step``/``last_n_steps`` and ``init_from_reference``.

    cfg = load_run_config(run_dir)
    model = build_diffusion_model(cfg, resolve_checkpoint(run_dir, "diffusion"))
    x = decode_diffusion_batch(model, cfg["training"], cfg["model"], (4, 1, 256, 256),
                               cond, scheduler_override="unipc?solver_order=3")

Sampling engines are cached per configuration (FIFO, at most 8), keyed by
the model, which weights it holds, the scheduler's fingerprint, the selected
timesteps, the conditioning, the batch shape and the device.

Not ported yet, and refused rather than ignored: DeepCache
(``set_deep_cache``, ROADMAP Queue 1 item 6), int8 inference
(``set_quantize``, item 11) and data-parallel sampling over several cards
(``set_dp_sampling``, item 10).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from fmdm_tpu_torch.device import DeviceArg, resolve_device
from fmdm_tpu_torch.models.factories import DiffusionUNetFactory
from fmdm_tpu_torch.nn.layers import init_weights
from fmdm_tpu_torch.sample.engine import SamplingEngine, select_timesteps
from fmdm_tpu_torch.schedulers import build_scheduler, resolve_conditioning_mode, resolve_scheduler_override
from fmdm_tpu_torch.utils.checkpoint import flatten_params, load_checkpoint
from fmdm_tpu_torch.utils.evaluation import select_visual_indices

_LEGACY_RENAMES = (
    (".query.", ".to_q."),
    (".key.", ".to_k."),
    (".value.", ".to_v."),
    (".proj_attn.", ".to_out.0."),
    (".conv1.weight", ".conv1.conv.weight"),
    (".conv1.bias", ".conv1.conv.bias"),
    (".conv2.weight", ".conv2.conv.weight"),
    (".conv2.bias", ".conv2.conv.bias"),
    (".time_emb_proj.weight", ".emb_layers.weight"),
    (".time_emb_proj.bias", ".emb_layers.bias"),
    (".conv_shortcut.weight", ".skip_connection.conv.weight"),
    (".conv_shortcut.bias", ".skip_connection.conv.bias"),
    (".downsamplers.0.conv.weight", ".downsamplers.0.op.conv.weight"),
    (".downsamplers.0.conv.bias", ".downsamplers.0.op.conv.bias"),
    (".upsamplers.0.conv.weight", ".upsamplers.0.conv.conv.weight"),
    (".upsamplers.0.conv.bias", ".upsamplers.0.conv.conv.bias"),
)


def remap_legacy_unet_keys(state_dict: Dict[str, object]) -> Dict[str, object]:
    """Diffusers/legacy UNet key names -> this repo's names."""
    remapped = {}
    for key, value in state_dict.items():
        for old, new in _LEGACY_RENAMES:
            key = key.replace(old, new)
        remapped[key] = value
    return remapped


def load_legacy_unet_state(expected: Dict[str, torch.Tensor], state: Dict[str, object],
                           strict_shapes: bool = True) -> Dict[str, torch.Tensor]:
    """A shape-checked partial load: ``state``'s remapped keys over the
    ``expected`` state dict, strict about shapes and keys unless told not to.
    Returns the merged state dict."""
    state = remap_legacy_unet_keys(state)
    converted: Dict[str, torch.Tensor] = {}
    shape_mismatch, unexpected = [], []
    for key, value in state.items():
        if key not in expected:
            unexpected.append(key)
            continue
        value = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.asarray(value))
        if tuple(value.shape) != tuple(expected[key].shape):
            shape_mismatch.append(f"{key}: ckpt={tuple(value.shape)} model={tuple(expected[key].shape)}")
            continue
        converted[key] = value
    missing = [key for key in expected if key not in converted]
    if strict_shapes and shape_mismatch:
        msg = "Legacy load failed due to shape mismatches:\n" + "\n".join(shape_mismatch[:20])
        if len(shape_mismatch) > 20:
            msg += f"\n... and {len(shape_mismatch) - 20} more"
        raise RuntimeError(msg)
    merged = dict(expected)
    merged.update(converted)
    if strict_shapes and (missing or unexpected):
        details = [f"{name}={len(keys)}" for name, keys in (("missing", missing),
                                                             ("unexpected", unexpected)) if keys]
        raise RuntimeError("Legacy load key mismatch after conversion (" + ", ".join(details) + "). "
                           "Architecture/config likely differs from the source checkpoint.")
    return merged


# Sample from the EMA shadow weights (run_model --use_ema): module-level, as
# in the JAX package, beside the fixed signature of the sampling functions.
_USE_EMA = False


def set_use_ema(enabled: bool) -> None:
    global _USE_EMA
    _USE_EMA = bool(enabled)


def _checkpoint_state(ckpt_path: str) -> Dict[str, object]:
    """The flat weights a checkpoint file holds: the EMA tree under
    ``set_use_ema(True)``, else ``model`` (or a bare state dict)."""
    if ckpt_path.endswith(".safetensors"):
        if _USE_EMA:
            raise ValueError("--use_ema is unsupported for flat .safetensors checkpoints "
                             "(no 'ema' tree).")
        from safetensors.torch import load_file

        return dict(load_file(ckpt_path))
    payload = load_checkpoint(ckpt_path)
    if _USE_EMA:
        tree = payload.get("ema")
        if not tree:
            raise ValueError(f"--use_ema requested but checkpoint {ckpt_path} carries no 'ema' "
                             "tree (train with training.ema_decay > 0).")
        return tree
    tree = payload.get("model", payload)
    return {k: v for k, v in flatten_params(tree).items()
            if isinstance(v, (torch.Tensor, np.ndarray))}


def build_diffusion_model(cfg: dict, ckpt_path=None, generator: Optional[torch.Generator] = None,
                          *, device: DeviceArg = None) -> nn.Module:
    """The UNet of a ``{training, model}`` config on ``device`` (CUDA by
    default), in eval mode, with the checkpoint's weights (a ``.pt`` payload's
    ``model`` or ``ema``, a bare state dict, or a ``.safetensors`` file)
    loaded; without a checkpoint its weights are drawn from ``generator``
    (default: one seeded by ``training.seed``)."""
    training_cfg = cfg["training"]
    model_cfg = cfg["model"].get("unet", {})
    conditioning_mode = resolve_conditioning_mode(
        training_cfg.get("conditioning") or cfg["model"].get("conditioning"))
    channels = int(training_cfg.get("channels", model_cfg.get("out_channels", 1)))
    model = DiffusionUNetFactory().build(model_cfg, conditioning_mode, channels, device=device)
    init_weights(model, generator if generator is not None
                 else torch.Generator().manual_seed(int(training_cfg.get("seed") or 0)))
    model.weights_source = None
    if ckpt_path is not None:
        ckpt_path = str(ckpt_path)
        state = _checkpoint_state(ckpt_path)
        expected = model.state_dict()
        exact = set(state) == set(expected) and all(
            tuple(np.shape(state[k])) == tuple(expected[k].shape) for k in state)
        if exact and not bool(model_cfg.get("load_legacy", False)):
            merged = {k: torch.as_tensor(v) for k, v in state.items()}
        else:
            merged = load_legacy_unet_state(
                expected, state, strict_shapes=bool(model_cfg.get("legacy_strict_shapes", True)))
        model.load_state_dict(merged, strict=True)
        model.weights_source = (ckpt_path, "ema" if _USE_EMA else "model")
    return model.eval()


def encode_diffusion_batch(scheduler, targets: torch.Tensor, timesteps: torch.Tensor,
                           generator: Optional[torch.Generator] = None,
                           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Forward noising of ``targets`` at ``timesteps``, the noise drawn from
    ``generator`` (on the targets' device) or given."""
    if noise is None:
        noise = torch.randn(targets.shape, generator=generator, device=targets.device,
                            dtype=torch.float32)
    return scheduler.add_noise(targets, noise, timesteps)


def set_deep_cache(value) -> None:
    """DeepCache is not ported yet (ROADMAP Queue 1 item 6): anything but
    None raises."""
    if value:
        raise NotImplementedError("deep_cache is not ported yet (ROADMAP Queue 1 item 6)")


def set_quantize(mode: Optional[str]) -> None:
    """int8 inference is not ported yet (ROADMAP Queue 1 item 11): anything
    but None raises."""
    if mode is not None and mode not in ("int8", "int8+linear"):
        raise ValueError(f"--quantize supports 'int8' or 'int8+linear', got '{mode}'")
    if mode is not None:
        raise NotImplementedError(f"--quantize {mode} is not ported yet (ROADMAP Queue 1 item 11)")


# Data-parallel sampling: as in the JAX package, on by default, and a no-op
# on one device. Over several cards it is not ported yet (ROADMAP Queue 1
# item 10): decoding on CUDA with more than one card visible raises, unless
# it is turned off.
_DP_SAMPLING = True


def set_dp_sampling(enabled: bool) -> None:
    global _DP_SAMPLING
    _DP_SAMPLING = bool(enabled)


# FIFO-capped: each entry pins a SamplingEngine and its model (a copy of the
# weights when the model lives on another device or dtype; 455 MB for the
# flagship in f32)
_ENGINE_CACHE: Dict[Tuple, SamplingEngine] = {}
_ENGINE_CACHE_MAX = 8


def _scheduler_fingerprint(scheduler) -> Tuple:
    """Hashable view of a scheduler's configuration: two schedulers of one
    class can differ by '?k=v' overrides, by the tables some constructor
    parameters live in only (hashed by content), and by state that
    set_timesteps stashes (Karras sigmas)."""
    if not dataclasses.is_dataclass(scheduler):
        return (id(scheduler),)
    items = []
    for f in dataclasses.fields(scheduler):
        v = getattr(scheduler, f.name)
        if isinstance(v, (int, float, str, bool, frozenset, tuple, type(None))):
            items.append((f.name, v))
        elif hasattr(v, "tobytes"):
            items.append((f.name, (type(v).__name__, tuple(getattr(v, "shape", ()) or ()),
                                   str(getattr(v, "dtype", "")), hash(v.tobytes()))))
        else:
            items.append((f.name, (type(v).__name__, id(v))))
    return tuple(items)


def _weights_key(model: nn.Module) -> Tuple:
    """Which weights ``model`` holds: the checkpoint tree it was built from,
    and the in-place version counters of its parameters (a load_state_dict
    or an optimizer step bumps them), so a cached engine never serves a copy
    of stale weights."""
    return (getattr(model, "weights_source", None),
            sum(p._version for p in model.parameters()))


def decode_diffusion_batch(
    model: nn.Module,
    training_cfg: dict,
    model_cfg: dict,
    batch_shape: Tuple[int, ...],
    conditioning_batch: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    timing: Optional[dict] = None,
    num_inference_steps: Optional[int] = None,
    start_step: Optional[int] = None,
    last_n_steps: Optional[int] = None,
    reference_batch: Optional[torch.Tensor] = None,
    init_from_reference: bool = False,
    scheduler_override: Optional[str] = None,
    *,
    init_noise: Optional[torch.Tensor] = None,
    step_noise: Optional[Sequence[torch.Tensor]] = None,
    device: DeviceArg = None,
) -> torch.Tensor:
    """Reverse sampling of ``batch_shape`` on ``device`` (CUDA by default)
    with the config's scheduler, or ``scheduler_override`` ("<alias>?k=v")
    merged into its params.

    Random draws come from ``generator``, which lives on ``device`` (default:
    a generator there seeded 0): first the noise added to ``reference_batch``
    at the first selected timestep under ``init_from_reference``, then the
    pure-noise start, then a stochastic scheduler's steps. ``init_noise``
    (the unscaled start noise, or the noise added to the reference) and
    ``step_noise`` (one tensor per selected step) replace those draws, so a
    run can replay another run's noise."""
    device = resolve_device(device)
    if _DP_SAMPLING and device.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError("data-parallel sampling over several cards is not ported yet "
                                  "(ROADMAP Queue 1 item 10); call set_dp_sampling(False)")
    scheduler_cfg = dict(model_cfg.get("scheduler", {}))
    override_cfg = resolve_scheduler_override(scheduler_override)
    if override_cfg is not None:
        scheduler_cfg["name"] = override_cfg["name"]
        scheduler_cfg["params"] = {**scheduler_cfg.get("params", {}), **override_cfg.get("params", {})}
    scheduler, num_inference = build_scheduler(scheduler_cfg, training_cfg)
    if num_inference_steps is not None:
        num_inference = int(num_inference_steps)
    timesteps = select_timesteps(scheduler.set_timesteps(num_inference), start_step, last_n_steps)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)

    conditioning_mode = resolve_conditioning_mode(
        training_cfg.get("conditioning") or model_cfg.get("conditioning"))
    latent_norm = training_cfg.get("latent_norm")
    cache_key = (
        id(model), _weights_key(model), scheduler.__class__.__name__,
        _scheduler_fingerprint(scheduler), tuple(np.asarray(timesteps).tolist()),
        conditioning_mode, str(latent_norm), tuple(batch_shape), str(device),
    )
    engine = _ENGINE_CACHE.get(cache_key)
    if engine is None:
        engine = SamplingEngine(model, scheduler, timesteps, conditioning_mode, latent_norm,
                                device=device)
        while len(_ENGINE_CACHE) >= _ENGINE_CACHE_MAX:
            _ENGINE_CACHE.pop(next(iter(_ENGINE_CACHE)))
        _ENGINE_CACHE[cache_key] = engine

    init_sample = None
    if init_from_reference and reference_batch is not None:
        reference = torch.as_tensor(reference_batch).to(device)
        t0 = torch.full((reference.shape[0],), timesteps[0].item(), device=device,
                        dtype=torch.int32 if np.issubdtype(timesteps.dtype, np.integer)
                        else torch.float32)
        noise = init_noise.to(device) if init_noise is not None else torch.randn(
            reference.shape, generator=generator, device=device, dtype=torch.float32)
        init_sample = engine.scheduler.add_noise(reference, noise, t0)
    elif init_noise is not None:
        init_sample = init_noise.to(device) * engine.scheduler.init_noise_scale(engine.timesteps)
    return engine(tuple(batch_shape), generator, conditioning_batch=conditioning_batch,
                  init_sample=init_sample, timing=timing, step_noise=step_noise)


def warn_attention_conditioning_shape(conditioning_batch, model_cfg: dict) -> bool:
    """Warn (and return True) when attention conditioning's channels differ
    from the UNet's ``cross_attention_dim``."""
    if conditioning_batch is None or np.ndim(conditioning_batch) < 2:
        return False
    unet_cfg = model_cfg.get("unet", {}) if isinstance(model_cfg, dict) else {}
    expected = unet_cfg.get("cross_attention_dim")
    if expected is None:
        return False
    actual = int(np.shape(conditioning_batch)[1])
    if actual != int(expected):
        logging.warning(
            "Attention conditioning has %d channels, but model unet.cross_attention_dim is %d. "
            "This often means the evaluation split is pointing at pixel conditioning instead "
            "of the expected latent conditioning.", actual, int(expected))
        return True
    return False


def prepare_diffusion_visual_batch(dataset, count: int, seed: Optional[int] = None):
    """A fixed seeded batch of targets and, where every sample has one, its
    conditioning, as CPU f32 tensors."""
    targets, conditioning = [], []
    for idx in select_visual_indices(dataset, count, seed=seed):
        sample = dataset[idx]
        targets.append(np.asarray(sample["target"], dtype=np.float32))
        conditioning.append(sample.get("image"))
    target_batch = torch.from_numpy(np.stack(targets, axis=0))
    cond_batch = None
    if conditioning and all(c is not None for c in conditioning):
        cond_batch = torch.from_numpy(np.stack([np.asarray(c, np.float32) for c in conditioning]))
    return target_batch, cond_batch
