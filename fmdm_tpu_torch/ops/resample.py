"""
Resampling primitives, channels-first (counterpart of
``fmdm_tpu/ops/resample.py:27-100``): nearest upsampling, average and max
pooling, and the linear resize of the perceptual loss.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

SizeArg = Union[int, Tuple[int, ...]]

_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _normalize(value: SizeArg, nd: int) -> Tuple[int, ...]:
    if isinstance(value, int):
        return (value,) * nd
    return tuple(int(v) for v in value)


def upsample_nearest(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Nearest-neighbour x``scale`` upsampling of all spatial dims of
    (N, C, *S), as a reshape + broadcast."""
    shape = tuple(x.shape)
    expanded = x.reshape(shape[:2] + tuple(v for s in shape[2:] for v in (s, 1)))
    target = shape[:2] + tuple(v for s in shape[2:] for v in (s, scale))
    return expanded.expand(target).reshape(shape[:2] + tuple(s * scale for s in shape[2:]))


def avg_pool_nd(
    x: torch.Tensor,
    kernel_size: SizeArg = 2,
    stride: Optional[SizeArg] = None,
    padding: SizeArg = 0,
) -> torch.Tensor:
    """Average pooling with torch AvgPoolNd semantics (count includes padding)."""
    return _AVG_POOL[x.dim() - 2](
        x, kernel_size, stride if stride is not None else kernel_size, padding,
        count_include_pad=True)


def max_pool_nd(
    x: torch.Tensor,
    kernel_size: SizeArg = 2,
    stride: Optional[SizeArg] = None,
    padding: SizeArg = 0,
) -> torch.Tensor:
    """Max pooling of (N, C, *S) over windows padded with -inf (the lowest
    integer for integer dtypes), as ``lax.reduce_window(max)`` pads
    (counterpart of ``fmdm_tpu/ops/resample.py:62-90``)."""
    nd = x.dim() - 2
    k = _normalize(kernel_size, nd)
    s = _normalize(stride if stride is not None else kernel_size, nd)
    p = _normalize(padding, nd)
    if any(p):
        fill = float("-inf") if x.is_floating_point() else torch.iinfo(x.dtype).min
        x = F.pad(x, [v for pi in reversed(p) for v in (pi, pi)], value=fill)
    return _MAX_POOL[nd](x, k, s)


def _linear_weights(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """(in_size, out_size) weights of a linear (triangle-kernel) resize
    along one axis: ``jax.image.compute_weight_mat`` with antialiasing (the
    kernel widened by the downsampling factor), in f32."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    dist = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32, device=device)[:, None])
    weights = torch.clamp(1.0 - dist.abs() / kernel_scale, min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def resize_bilinear(x: torch.Tensor, size: Tuple[int, ...]) -> torch.Tensor:
    """Linear resize of every spatial dim of (N, C, *S) to ``size``, as
    ``jax.image.resize(method="linear"/"bilinear"/"trilinear")`` computes it
    (counterpart of ``fmdm_tpu/ops/resample.py:93-100``): one weight matrix
    per resized axis, antialiased when it downsamples, contracted in turn.
    ``F.interpolate`` antialiases only in 2-D and rounds otherwise."""
    if x.dim() - 2 != len(size):
        raise ValueError(f"size {tuple(size)} does not match the {x.dim() - 2} spatial dims")
    for axis, out_size in enumerate(size, start=2):
        in_size = x.shape[axis]
        if in_size == out_size:
            continue
        weights = _linear_weights(in_size, int(out_size), x.device).to(x.dtype)
        x = torch.movedim(torch.movedim(x, axis, -1) @ weights, -1, axis)
    return x
