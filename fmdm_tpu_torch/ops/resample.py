"""
Resampling primitives, channels-first (counterpart of
``fmdm_tpu/ops/resample.py:27-59``).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

SizeArg = Union[int, Tuple[int, ...]]

_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


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
