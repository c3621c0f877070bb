"""
N-dimensional convolution and transposed convolution (counterpart of
``fmdm_tpu/ops/conv.py:45-141``).

Channels-first tensors (N, C, *spatial), torch-layout weights (OI + spatial
for ``conv_nd``, IO + spatial for ``conv_transpose_nd``) and integer padding
that defaults to k//2 per dim. The JAX package leaves convolutions to XLA,
so the port leaves them to cuDNN through ``F.conv1d/2d/3d`` and
``F.conv_transpose1d/2d/3d``. A ``QuantizedConvWeight`` weight takes the
int8 path of ``ops/quant.py`` (W8A8: the input quantized with the weight's
static scale, im2col and an int8 GEMM with exact int32 accumulation, one f32
dequantization), as JAX's ``conv_nd`` dispatches on the weight's type
(``fmdm_tpu/ops/conv.py:73-84``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from fmdm_tpu_torch.ops.quant import (QuantizedConvWeight, dequant_scale, int8_conv_accumulate,
                                      quantize_activation)

SizeArg = Union[int, Tuple[int, ...], Sequence[int]]

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


def _normalize(value: SizeArg, nd: int) -> Tuple[int, ...]:
    if isinstance(value, int):
        return (value,) * nd
    value = tuple(int(v) for v in value)
    if len(value) != nd:
        raise ValueError(f"Expected {nd} entries, got {value}")
    return value


def conv_nd(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    stride: SizeArg = 1,
    padding: Optional[SizeArg] = None,
    dilation: SizeArg = 1,
    groups: int = 1,
) -> torch.Tensor:
    """Channels-first ND convolution with torch padding semantics.

    x: (N, C_in, *spatial); weight: (C_out, C_in//groups, *kernel).
    ``padding=None`` defaults to k//2 per dim. The convolution runs in the
    input dtype; the bias is added afterwards in the output dtype, as the
    JAX version does. A ``QuantizedConvWeight`` runs the int8 path.
    """
    nd = x.dim() - 2
    if nd not in _CONV:
        raise ValueError(f"conv_nd supports 1-3 spatial dims, got {nd}")
    kernel = weight.shape[2:]
    if padding is None:
        padding = tuple(k // 2 for k in kernel)
    else:
        padding = _normalize(padding, nd)
    stride, dilation = _normalize(stride, nd), _normalize(dilation, nd)
    if isinstance(weight, QuantizedConvWeight):
        acc = int8_conv_accumulate(quantize_activation(x, weight.act_scale), weight.qweight,
                                   stride=stride, padding=padding, dilation=dilation,
                                   groups=groups)
        out = (acc.float() * dequant_scale(weight, nd)).to(x.dtype)
    else:
        out = _CONV[nd](x, weight.to(x.dtype), None, stride=stride, padding=padding,
                        dilation=dilation, groups=groups)
    if bias is not None:
        out = out + bias.to(out.dtype).reshape((1, -1) + (1,) * nd)
    return out


def conv_transpose_nd(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    stride: SizeArg = 2,
    padding: SizeArg = 0,
    output_padding: SizeArg = 0,
) -> torch.Tensor:
    """Channels-first ND transposed convolution with torch semantics.

    x: (N, C_in, *spatial); weight: (C_in, C_out, *kernel).
    out_spatial = (in-1)*stride - 2*padding + kernel + output_padding. The
    bias is added afterwards in the output dtype, as ``conv_nd`` does."""
    nd = x.dim() - 2
    if nd not in _CONV_T:
        raise ValueError(f"conv_transpose_nd supports 1-3 spatial dims, got {nd}")
    out = _CONV_T[nd](
        x, weight.to(x.dtype), None,
        stride=_normalize(stride, nd), padding=_normalize(padding, nd),
        output_padding=_normalize(output_padding, nd),
    )
    if bias is not None:
        out = out + bias.to(out.dtype).reshape((1, -1) + (1,) * nd)
    return out
