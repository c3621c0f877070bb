"""
Plain layers of the reference UNets, frozen here so that a change to the
program cannot change the yardstick. Parameter names follow the program's
state dict (``conv1.conv.weight``, ``to_out.0.weight``, ``qkv.weight``...), so
one dict of weights loads into both; the arithmetic is
``benchmark/reference/ops.py``'s, in f32.

The ResBlock is the one of DDPM (Ho et al. 2020) as diffusers and the
LDCT configs write it: GroupNorm, SiLU, 3x3 conv; the time embedding added
(after a SiLU) or, under FiLM, applied as ``(1 + scale), shift`` after the
second GroupNorm; GroupNorm, SiLU, 3x3 conv; a 1x1 conv on the skip where
the width changes. A tuple input (the decoder's [hidden, skip]) is
concatenated first.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.ops import Ops


def safe_groups(channels: int, groups: int = 32) -> int:
    """The largest divisor of ``channels`` that is at most ``groups``."""
    g = min(groups, channels)
    while channels % g:
        g -= 1
    return g


class Conv(nn.Module):
    def __init__(self, ops: Ops, dims: int, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: Optional[int] = None):
        super().__init__()
        self.ops, self.stride = ops, stride
        self.padding = kernel // 2 if padding is None else padding
        self.weight = nn.Parameter(torch.empty((cout, cin) + (kernel,) * dims))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        return self.ops.conv(x, self.weight, self.bias, self.stride, self.padding)


class ConvND(nn.Module):
    """A conv nested under ``conv`` (the program's naming)."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        self.conv = Conv(*args, **kwargs)

    def forward(self, x):
        return self.conv(x)


class Linear(nn.Module):
    def __init__(self, ops: Ops, cin: int, cout: int):
        super().__init__()
        self.ops = ops
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        return self.ops.linear(x, self.weight, self.bias)


class GroupNorm(nn.Module):
    def __init__(self, ops: Ops, groups: int, channels: int, eps: float = 1e-5):
        super().__init__()
        self.ops, self.groups, self.eps = ops, groups, eps
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x, *, act: bool = False, scale=None, shift=None, kernel: bool = False):
        return self.ops.group_norm(x, self.weight, self.bias, self.groups, self.eps, act=act,
                                   scale=scale, shift=shift, kernel=kernel)


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool) -> torch.Tensor:
    """Sinusoidal embedding of (N,) timesteps: frequencies
    exp(-ln(10000) i / half), [sin, cos] (or [cos, sin] flipped), f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)] if flip_sin_to_cos
                    else [torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


class ResBlock(nn.Module):
    def __init__(self, ops: Ops, dims: int, cin: int, cout: int, emb: int, *, film: bool,
                 act_before_proj: bool, groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.film, self.act_before_proj = film, act_before_proj
        self.norm1 = GroupNorm(ops, safe_groups(cin, groups), cin, eps)
        self.conv1 = ConvND(ops, dims, cin, cout, 3)
        self.emb_layers = Linear(ops, emb, 2 * cout if film else cout)
        self.norm2 = GroupNorm(ops, safe_groups(cout, groups), cout, eps)
        self.conv2 = ConvND(ops, dims, cout, cout, 3)
        self.skip_connection = nn.Identity() if cin == cout else ConvND(ops, dims, cin, cout, 1)

    def forward(self, x: Union[torch.Tensor, Sequence[torch.Tensor]], emb: torch.Tensor):
        if isinstance(x, (tuple, list)):
            x = torch.cat(list(x), dim=1)
        h = self.conv1(self.norm1(x, act=True, kernel=True))
        e = self.emb_layers(F.silu(emb) if self.act_before_proj else emb)
        scale = shift = None
        if self.film:
            scale, shift = e.chunk(2, dim=1)
        else:
            h = h + e.reshape(e.shape + (1,) * (h.dim() - 2))
        h = self.conv2(self.norm2(h, act=True, scale=scale, shift=shift, kernel=True))
        return self.skip_connection(x) + h


class DiffusersAttention(nn.Module):
    """Self-attention over the flattened positions with diffusers' naming:
    GroupNorm, to_q / to_k / to_v, heads of ``channels // heads`` features,
    to_out.0, the residual."""

    def __init__(self, ops: Ops, channels: int, heads: int, groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.ops, self.heads = ops, heads
        self.group_norm = GroupNorm(ops, math.gcd(channels, groups), channels, eps)
        self.to_q = Linear(ops, channels, channels)
        self.to_k = Linear(ops, channels, channels)
        self.to_v = Linear(ops, channels, channels)
        self.to_out = nn.ModuleList([Linear(ops, channels, channels)])

    def forward(self, hidden):
        b, c = hidden.shape[:2]
        x = self.group_norm(hidden.reshape(b, c, -1)).transpose(1, 2)

        def heads(t):
            return t.reshape(b, -1, self.heads, c // self.heads).transpose(1, 2)

        out = self.ops.attention(heads(self.to_q(x)), heads(self.to_k(x)), heads(self.to_v(x)))
        out = self.to_out[0](out.transpose(1, 2).reshape(b, -1, c))
        return out.transpose(1, 2).reshape(hidden.shape) + hidden


class SpatialSelfAttention(nn.Module):
    """Self-attention of the EfficientUNet: GroupNorm, a 1x1 conv to q, k, v
    read as (b, heads, T, 3 d) by a plain reshape (not a transpose), softmax
    or linear attention, a 1x1 conv out, the residual."""

    def __init__(self, ops: Ops, dim: int, heads: int, dim_head: int, linear: bool):
        super().__init__()
        self.ops, self.heads, self.linear = ops, heads, linear
        self.inner = heads * dim_head
        self.norm = GroupNorm(ops, math.gcd(dim, 32), dim)
        self.qkv = Conv(ops, 1, dim, 3 * self.inner, 1, padding=0)
        self.proj_out = Conv(ops, 1, self.inner, dim, 1, padding=0)

    def forward(self, x):
        b, c = x.shape[:2]
        flat = x.reshape(b, c, -1)
        qkv = self.qkv(self.norm(flat))
        q, k, v = qkv.reshape(b, self.heads, qkv.shape[-1], -1).chunk(3, dim=-1)
        h = self.ops.linear_attention(q, k, v) if self.linear else self.ops.attention(q, k, v)
        return (flat + self.proj_out(h.reshape(b, self.inner, -1))).reshape(x.shape)


class Downsample(nn.Module):
    def __init__(self, ops: Ops, dims: int, channels: int):
        super().__init__()
        self.op = ConvND(ops, dims, channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, ops: Ops, dims: int, channels: int):
        super().__init__()
        self.conv = ConvND(ops, dims, channels, channels, 3)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))
