"""
API-parity wrappers for reference symbols (counterpart of
``fmdm_tpu/nn/compat.py``):

- ``QKVAttention`` / ``LinearQKVAttention``: modules over the port's ``sdpa``
  and ``linear_attention``;
- ``TimestepBlock`` / ``ContextBlock``: marker base classes for blocks called
  as ``forward(x, emb)`` and ``forward(x, context)``;
- ``AvgPoolND`` / ``MaxPoolND``: module envelopes of the pooling ops;
- ``zero_module``: zeroes a module's parameters in place and returns it;
- ``build_resblock_*``: ``ResBlockND`` with a fixed norm and activation.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from fmdm_tpu_torch.nn.blocks import ResBlockND
from fmdm_tpu_torch.ops.attention import linear_attention, sdpa
from fmdm_tpu_torch.ops.resample import avg_pool_nd, max_pool_nd


class TimestepBlock(nn.Module):
    """Marker: a block called as ``forward(x, emb)``."""


class ContextBlock(nn.Module):
    """Marker: a block called as ``forward(x, context)``."""


class QKVAttention(nn.Module):
    """Scaled dot-product attention of (..., T, d) q, k, v through ``sdpa``
    (its kernels on CUDA). ``efficient_attn`` and ``dropout`` are accepted
    as in JAX, where both paths are the one fused attention."""

    def __init__(self, efficient_attn: bool = True, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return sdpa(q, k, v)


class LinearQKVAttention(nn.Module):
    """O(N) softmax-factored linear attention."""

    def __init__(self, dropout: float = 0.0, eps: float = 1e-6):
        super().__init__()
        self.eps = eps

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return linear_attention(q, k, v, eps=self.eps)


class _PoolND(nn.Module):
    def __init__(self, spatial_dims: int, kernel_size=2, stride=None, padding=0):
        super().__init__()
        if spatial_dims not in (1, 2, 3):
            raise ValueError("spatial_dims must be 1, 2 or 3")
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding


class AvgPoolND(_PoolND):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return avg_pool_nd(x, self.kernel_size, self.stride, self.padding)


class MaxPoolND(_PoolND):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool_nd(x, self.kernel_size, self.stride, self.padding)


@torch.no_grad()
def zero_module(module: nn.Module) -> nn.Module:
    """Zero every parameter of ``module`` in place; returns ``module``."""
    for p in module.parameters():
        p.zero_()
    return module


def build_resblock_gn_silu(**kwargs) -> ResBlockND:
    return ResBlockND(norm_type="gn", act="silu", **kwargs)


def build_resblock_gn_swish(**kwargs) -> ResBlockND:
    return ResBlockND(norm_type="gn", act="swish", **kwargs)


def build_resblock_rmsnorm_silu(**kwargs) -> ResBlockND:
    return ResBlockND(norm_type="rmsnorm", act="silu", **kwargs)


def build_resblock_rmsnorm_swish(**kwargs) -> ResBlockND:
    return ResBlockND(norm_type="rmsnorm", act="swish", **kwargs)
