"""
Core parameterized layers (counterpart of ``fmdm_tpu/nn/layers.py:39-297``).

Parameter names and nesting match the JAX trees, which already use torch
layouts: ``Conv`` holds ``weight``/``bias`` at its own level, ``ConvND`` nests
a ``Conv`` under ``conv``, ``ConvTransposeND`` a ``ConvTranspose`` (weight
(in, out, *k)) under ``convT``. Initializers follow torch's defaults, as the JAX
ones do: U(±1/√fan_in) for conv/linear weights and biases, ones/zeros for
GroupNorm. :func:`init_weights` re-draws every parameter of a model from an
explicit ``torch.Generator``.

``Conv`` and ``Linear`` also run quantized: int8 inference replaces their
``weight`` by a :class:`fmdm_tpu_torch.ops.quant.QuantizedConvWeight` /
``QuantizedLinearWeight`` module (``utils/quantize.py``), and ``conv_nd`` /
``linear_nd`` dispatch on its type, as the JAX functions dispatch on the
leaf's.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from fmdm_tpu_torch.device import DeviceArg, resolve_device
from fmdm_tpu_torch.ops.conv import conv_nd, conv_transpose_nd
from fmdm_tpu_torch.ops.norm import group_norm, rms_norm_nd, safe_num_groups
from fmdm_tpu_torch.ops.quant import QuantizedLinearWeight, linear_qdq

SizeArg = Union[int, Tuple[int, ...]]


def _tupled(value: SizeArg, nd: int) -> Tuple[int, ...]:
    if isinstance(value, int):
        return (value,) * nd
    return tuple(int(v) for v in value)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def make_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation by the reference's accepted names; "gelu" is the tanh
    approximation, ``jax.nn.gelu``'s default."""
    name = name.lower()
    if name in ("silu", "swish"):
        return F.silu
    if name == "relu":
        return F.relu
    if name == "gelu":
        return _gelu_tanh
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


def linear_nd(x: torch.Tensor, weight, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x Wᵀ + b with torch's (out, in) weight layout, the bias added in
    the input dtype. ``weight`` may be a ``QuantizedLinearWeight``: then the
    product is the int8 GEMM of ``linear_qdq`` (W8A8, int32 accumulation)."""
    if isinstance(weight, QuantizedLinearWeight):
        y = linear_qdq(x, weight)
    else:
        y = F.linear(x, weight.to(x.dtype))
    return y if bias is None else y + bias.to(x.dtype)


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
        return linear_nd(x, self.weight, self.bias)


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


class RMSNormND(nn.Module):
    """RMSNorm over all non-batch dims with a per-channel scale
    (``ops/norm.py::rms_norm_nd``)."""

    def __init__(self, channels: int, eps: float = 1e-6, *, device: DeviceArg = None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=resolve_device(device)))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.ones_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm_nd(x, self.weight, eps=self.eps)


class BatchNorm(nn.Module):
    """BatchNorm over (N, C, *spatial) as the JAX package computes it: batch
    statistics in train mode, the stored ``running_mean``/``running_var`` in
    eval mode, which it NEVER updates (they stay 0 and 1 for a whole run;
    ``momentum`` is accepted and unused). The formula in f32 with the biased
    variance, ``(x - mean) * rsqrt(var + eps) * weight + bias``, one cast back.

    The running statistics are parameters that need no gradient: they keep
    the JAX tree's names and order (weight, bias, running_mean,
    running_var), count as leaves of an optax state, and ``torch.optim``
    skips them (their ``.grad`` stays None), as Adam's zero update leaves
    them in JAX. ``torch.nn.BatchNorm*d`` would update them.

    With ``mesh`` set to a data mesh over ranks (the train steps set it), the
    batch statistics are the global batch's, as in JAX's global mesh: the
    per-channel sums are all-reduced, differentiably, as ``SyncBatchNorm``
    reduces them."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.1, *,
                 device: DeviceArg = None):
        super().__init__()
        device = resolve_device(device)
        self.eps = eps
        self.momentum = momentum
        self.mesh = None
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.running_mean = nn.Parameter(torch.zeros(channels, device=device), requires_grad=False)
        self.running_var = nn.Parameter(torch.ones(channels, device=device), requires_grad=False)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for p, value in ((self.weight, 1.0), (self.bias, 0.0), (self.running_mean, 0.0),
                         (self.running_var, 1.0)):
            p.fill_(value)

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.float()
        if train and self.mesh is not None:
            from fmdm_tpu_torch.parallel.mesh import all_reduce_sum_autograd

            dims = (0,) + tuple(range(2, x.dim()))
            n = xf.numel() // xf.shape[1] * self.mesh.process_count
            mean = all_reduce_sum_autograd(xf.sum(dim=dims), self.mesh) / n
            var = all_reduce_sum_autograd(
                torch.square(xf - mean.reshape(shape)).sum(dim=dims), self.mesh) / n
        elif train:
            dims = (0,) + tuple(range(2, x.dim()))
            mean = xf.mean(dim=dims)
            var = torch.square(xf - mean.reshape(shape)).mean(dim=dims)
        else:
            mean, var = self.running_mean, self.running_var
        out = (xf - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + self.eps)
        return (out * self.weight.reshape(shape) + self.bias.reshape(shape)).to(x.dtype)


class Sequential(nn.Sequential):
    """``nn.Sequential`` with the integer child names of the JAX container;
    ``forward(x, train=)`` passes ``train`` to its BatchNorms only."""

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        for module in self:
            x = module(x, train=train) if isinstance(module, BatchNorm) else module(x)
        return x


class Activation(nn.Module):
    """A parameter-free activation by name, so a Sequential's numbering
    matches the reference's."""

    def __init__(self, name: str = "silu"):
        super().__init__()
        self.fn = make_activation(name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every parameter of ``module`` from ``generator`` (a CPU
    generator, e.g. ``torch.Generator().manual_seed(seed)``), in module
    order, and a VQ codebook's buffers with it."""
    from fmdm_tpu_torch.nn.vae_modules import VectorQuantizer, VectorQuantizerEMA

    for m in module.modules():
        if isinstance(m, (Linear, Conv, ConvTranspose, GroupNorm, RMSNormND, BatchNorm,
                          VectorQuantizer, VectorQuantizerEMA)):
            m.reset_parameters(generator)
    return module
