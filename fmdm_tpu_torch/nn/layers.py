"""
Core parameterized layers (counterpart of ``fmdm_tpu/nn/layers.py:39-255``).

Parameter names and nesting match the JAX trees, which already use torch
layouts: ``Conv`` holds ``weight``/``bias`` at its own level, ``ConvND`` nests
a ``Conv`` under ``conv``, ``ConvTransposeND`` a ``ConvTranspose`` (weight
(in, out, *k)) under ``convT``. Initializers follow torch's defaults, as the JAX
ones do: U(±1/√fan_in) for conv/linear weights and biases, ones/zeros for
GroupNorm. :func:`init_weights` re-draws every parameter of a model from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from fmdm_tpu_torch.device import DeviceArg, resolve_device
from fmdm_tpu_torch.ops.conv import conv_nd, conv_transpose_nd
from fmdm_tpu_torch.ops.norm import group_norm, safe_num_groups

SizeArg = Union[int, Tuple[int, ...]]


def _tupled(value: SizeArg, nd: int) -> Tuple[int, ...]:
    if isinstance(value, int):
        return (value,) * nd
    return tuple(int(v) for v in value)


def make_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation by the reference's accepted names."""
    name = name.lower()
    if name in ("silu", "swish"):
        return F.silu
    if name == "relu":
        return F.relu
    if name == "gelu":
        return F.gelu
    if name == "tanh":
        return torch.tanh
    raise ValueError(f"Unsupported activation '{name}'")


@torch.no_grad()
def _uniform_(param: torch.Tensor, bound: float, generator: Optional[torch.Generator]) -> None:
    """U(-bound, bound), drawn on the CPU (where the generator lives) and copied."""
    if param.is_meta:
        return
    draw = torch.empty(param.shape, dtype=param.dtype).uniform_(-bound, bound, generator=generator)
    param.copy_(draw)


class Linear(nn.Module):
    """y = x Wᵀ + b with torch weight layout (out, in).

    The product runs in the input dtype with f32 accumulation; the bias is
    added after it, in the input dtype, as ``linear_nd`` does in JAX."""

    def __init__(self, in_features: int, out_features: int, *, device: DeviceArg = None):
        super().__init__()
        device = resolve_device(device)
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = 1.0 / math.sqrt(max(self.in_features, 1))
        _uniform_(self.weight, bound, generator)
        _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype)) + self.bias.to(x.dtype)


class Conv(nn.Module):
    """Bare ND conv, params ``weight``/``bias`` at this level (torch ConvNd)."""

    def __init__(
        self,
        spatial_dims: int,
        in_channels: int,
        out_channels: int,
        kernel_size: SizeArg = 3,
        stride: SizeArg = 1,
        padding: Optional[SizeArg] = None,
        zero_init: bool = False,
        *,
        device: DeviceArg = None,
    ):
        super().__init__()
        if spatial_dims not in (1, 2, 3):
            raise ValueError("spatial_dims must be 1, 2 or 3")
        device = resolve_device(device)
        kernel = _tupled(kernel_size, spatial_dims)
        if padding is None:
            padding = tuple(k // 2 for k in kernel)
        self.stride = stride
        self.padding = padding
        self.zero_init = zero_init
        self.fan_in = in_channels * int(math.prod(kernel))
        self.weight = nn.Parameter(torch.empty((out_channels, in_channels) + kernel, device=device))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = 1.0 / math.sqrt(max(self.fan_in, 1))
        for p in (self.weight, self.bias):
            if self.zero_init:
                nn.init.zeros_(p)
            else:
                _uniform_(p, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nd(x, self.weight, self.bias, stride=self.stride, padding=self.padding)


class ConvND(nn.Module):
    """Reference-style envelope: params nest under ``conv``."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        self.conv = Conv(*args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class ConvTranspose(nn.Module):
    """Bare ND transposed conv with torch's (in, out, *k) weight layout."""

    def __init__(
        self,
        spatial_dims: int,
        in_channels: int,
        out_channels: int,
        kernel_size: SizeArg = 2,
        stride: SizeArg = 2,
        padding: SizeArg = 0,
        output_padding: SizeArg = 0,
        *,
        device: DeviceArg = None,
    ):
        super().__init__()
        device = resolve_device(device)
        kernel = _tupled(kernel_size, spatial_dims)
        self.stride = stride
        self.padding = padding
        self.output_padding = output_padding
        # torch's fan_in for a transposed conv: weight.size(1) * prod(kernel)
        self.fan_in = out_channels * int(math.prod(kernel))
        self.weight = nn.Parameter(torch.empty((in_channels, out_channels) + kernel, device=device))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = 1.0 / math.sqrt(max(self.fan_in, 1))
        _uniform_(self.weight, bound, generator)
        _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_transpose_nd(x, self.weight, self.bias, stride=self.stride,
                                 padding=self.padding, output_padding=self.output_padding)


class ConvTransposeND(nn.Module):
    """Reference-style envelope: params nest under ``convT``."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        self.convT = ConvTranspose(*args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convT(x)


class GroupNorm(nn.Module):
    """GroupNorm with f32 statistics (``ops/norm.py::group_norm``)."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5, *,
                 device: DeviceArg = None):
        super().__init__()
        device = resolve_device(device)
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, num_groups=self.num_groups, eps=self.eps)


def make_group_norm(channels: int, groups: int = 32, eps: float = 1e-5, *,
                    device: DeviceArg = None) -> GroupNorm:
    """GroupNorm with the divisor fallback of ``safe_num_groups``."""
    return GroupNorm(safe_num_groups(channels, groups), channels, eps=eps, device=device)


def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every parameter of ``module`` from ``generator`` (a CPU
    generator, e.g. ``torch.Generator().manual_seed(seed)``), in module
    order, and a VQ codebook's buffers with it."""
    from fmdm_tpu_torch.nn.vae_modules import VectorQuantizer, VectorQuantizerEMA

    for m in module.modules():
        if isinstance(m, (Linear, Conv, ConvTranspose, GroupNorm, VectorQuantizer,
                          VectorQuantizerEMA)):
            m.reset_parameters(generator)
    return module
