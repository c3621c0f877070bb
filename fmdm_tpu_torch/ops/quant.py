"""
Post-training int8 (W8A8) quantization primitives for inference
(counterpart of ``fmdm_tpu/ops/quant.py``).

Scheme (symmetric W8A8, as in the JAX package):

- weights: per-output-channel absmax / 127 scales (1.0 where a channel is
  all zeros), rounded half to even and clipped to ±127;
- activations: one static per-tensor scale from calibration
  (``utils/quantize.py``), applied as ``x · (1 / act_scale)``: the reciprocal
  first, then the multiply, which is bitwise the JAX order;
- accumulation in int32, exact, then ``acc · (wscale · act_scale)`` in f32
  with the scales' product formed first (``dequant_scale``), cast to the
  input dtype.

:class:`QuantizedConvWeight` and :class:`QuantizedLinearWeight` are small
modules that take the place of a ``Conv``'s or ``Linear``'s ``weight``, so
the quantized module's path is the JAX tree's quantized leaf path
(``....conv.weight``) and its state dict reads ``....conv.weight.qweight``,
``.wscale``, ``.act_scale``. ``.to(dtype)`` leaves them alone (int8 stays
int8, the scales stay f32), as JAX's ``cast_floating`` passes the bundles
through.

The int8 product is a library GEMM, as JAX's is stock XLA
(``lax.conv_general_dilated`` / ``dot_general`` with an int32 result), not
a Pallas kernel: a convolution is lowered to im2col (a strided view of the
padded int8 input, copied once) and ``torch._int_mm`` (cuBLASLt's int8
tensor-core GEMM on the card). ``torch._int_mm`` on CUDA takes more than 16
rows and inner and outer sizes that are multiples of 8, so
:func:`int8_matmul` pads with zeros where a shape misses them, on every
device, and slices the result back. Inference only: nothing here has a
backward.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

# torch._int_mm's CUDA rules: rows > 16, inner and outer sizes multiples of 8
_MIN_ROWS = 17
_ALIGN = 8
# an im2col buffer larger than this is built and multiplied a batch chunk at a time
IM2COL_CHUNK_BYTES = 2 << 30


class QuantizedWeight(nn.Module):
    """An int8 weight and its dequantization scales: ``qweight`` (int8),
    ``wscale`` (f32, one per output channel), ``act_scale`` (f32 scalar, the
    static input-activation scale)."""

    def __init__(self, qweight: torch.Tensor, wscale: torch.Tensor, act_scale: torch.Tensor):
        super().__init__()
        if qweight.dtype != torch.int8:
            raise TypeError(f"qweight must be int8, got {qweight.dtype}")
        self.register_buffer("qweight", qweight)
        self.register_buffer("wscale", wscale.to(device=qweight.device, dtype=torch.float32))
        self.register_buffer("act_scale", torch.as_tensor(act_scale, dtype=torch.float32)
                             .to(qweight.device).reshape(()))

    @property
    def shape(self) -> torch.Size:
        return self.qweight.shape

    def _apply(self, fn, recurse=True):
        # .to(dtype) / .half() cast every floating buffer: keep the scales'
        # f32 values, taking only the device fn gave them
        scales = {name: self._buffers[name] for name in ("wscale", "act_scale")}
        super()._apply(fn, recurse)
        for name, value in scales.items():
            self._buffers[name] = value.to(self._buffers[name].device)
        return self

    def extra_repr(self) -> str:
        return f"shape={tuple(self.qweight.shape)}, act_scale={float(self.act_scale):.6g}"


class QuantizedConvWeight(QuantizedWeight):
    """An int8 conv weight, (C_out, C_in // groups, *kernel) in torch's
    layout, and its scales."""


class QuantizedLinearWeight(QuantizedWeight):
    """An int8 (out_features, in_features) Linear weight and its scales."""


def quantize_conv_weight(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 quantization: (qweight int8, wscale
    f32 (C_out,)) with ``weight ≈ qweight · wscale[:, None, ...]``."""
    w = weight.detach().float()
    absmax = w.abs().amax(dim=tuple(range(1, w.dim())))
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by its
    # reciprocal, one ulp off the true quotient JAX and the CPU take
    wscale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                         torch.ones_like(absmax))
    q = torch.round(w / wscale.reshape((-1,) + (1,) * (w.dim() - 1)))
    return q.clamp(-127, 127).to(torch.int8), wscale


def quantize_activation(x: torch.Tensor, act_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor int8 quantization with a static scale."""
    inv = 1.0 / torch.as_tensor(act_scale, dtype=torch.float32, device=x.device)
    return torch.round(x.float() * inv).clamp(-127, 127).to(torch.int8)


def dequant_scale(qw: QuantizedWeight, nd: int) -> torch.Tensor:
    """The combined (1, C_out, 1, ...) f32 dequantization factor."""
    return (qw.wscale * qw.act_scale).reshape((1, -1) + (1,) * nd)


def _act_scale(act_absmax: float) -> torch.Tensor:
    # a Python double rounded once to f32, as jnp.float32(...) does
    return torch.tensor(max(float(act_absmax), 1e-8) / 127.0, dtype=torch.float32)


def make_quantized(weight: torch.Tensor, act_absmax: float) -> QuantizedConvWeight:
    """A float conv weight and its calibrated input absmax as a
    QuantizedConvWeight on the weight's device."""
    qweight, wscale = quantize_conv_weight(weight)
    return QuantizedConvWeight(qweight, wscale, _act_scale(act_absmax))


def make_quantized_linear(weight: torch.Tensor, act_absmax: float) -> QuantizedLinearWeight:
    """A float (out, in) Linear weight and its calibrated input absmax as a
    QuantizedLinearWeight (per-output-channel scales, as for convs)."""
    qweight, wscale = quantize_conv_weight(weight)
    return QuantizedLinearWeight(qweight, wscale, _act_scale(act_absmax))


def _pad_to(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of int8 ``a`` (M, K) and ``b`` (K, N) through
    ``torch._int_mm``, zero-padded to its CUDA rules (M > 16, K and N
    multiples of 8) where the shape misses them. ``b`` is best the
    transpose of a contiguous (N, K) weight (column-major), as cuBLASLt's
    int8 GEMM takes it."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, _MIN_ROWS), _pad_to(k, _ALIGN), _pad_to(n, _ALIGN)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b.t(), (0, kp - k, 0, np_ - n)).t()
    out = torch._int_mm(a.contiguous(), b)
    return out[:m, :n] if (mp, np_) != (m, n) else out


def im2col_int8(xq: torch.Tensor, kernel: Sequence[int], stride: Sequence[int],
                padding: Sequence[int], dilation: Sequence[int]
                ) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """The patches of an int8 (N, C, *spatial) input as an (N · prod(out),
    C · prod(kernel)) matrix, channel-major within a row as the weight's
    (C, *kernel) flattening is; and the output's spatial shape. Built from
    strided views of the zero-padded input (``Tensor.unfold`` per dim, a
    dilation as a step over the window), copied once."""
    nd = xq.dim() - 2
    pads = []
    for p in reversed(padding):
        pads += [p, p]
    patches = F.pad(xq, pads) if any(padding) else xq
    for d in range(nd):
        window = dilation[d] * (kernel[d] - 1) + 1
        patches = patches.unfold(2 + d, window, stride[d])
        if dilation[d] > 1:
            patches = patches[..., ::dilation[d]]
    out_spatial = tuple(patches.shape[2:2 + nd])
    # (N, C, *out, *k) -> (N, *out, C, *k)
    perm = (0,) + tuple(range(2, 2 + nd)) + (1,) + tuple(range(2 + nd, 2 + 2 * nd))
    n, c = xq.shape[:2]
    cols = patches.permute(perm).reshape(n * math.prod(out_spatial), c * math.prod(kernel))
    return cols, out_spatial


def int8_conv_accumulate(xq: torch.Tensor, qweight: torch.Tensor, *, stride: Sequence[int],
                         padding: Sequence[int], dilation: Sequence[int],
                         groups: int = 1) -> torch.Tensor:
    """The exact int32 accumulators (N, C_out, *out) of an int8 convolution:
    im2col and :func:`int8_matmul` per group, a batch chunk at a time when
    the im2col buffer would pass ``IM2COL_CHUNK_BYTES``."""
    nd = xq.dim() - 2
    kernel = tuple(qweight.shape[2:])
    n, c = xq.shape[:2]
    c_out = qweight.shape[0]
    k_len = c // groups * math.prod(kernel)
    w = qweight.reshape(groups, c_out // groups, k_len)
    out_spatial = tuple((size + 2 * p - d * (k - 1) - 1) // s + 1 for size, k, s, p, d in
                        zip(xq.shape[2:], kernel, stride, padding, dilation))
    step = max(1, IM2COL_CHUNK_BYTES // max(1, math.prod(out_spatial) * c * math.prod(kernel)))
    chunks = []
    for start in range(0, n, step):
        cols, _ = im2col_int8(xq[start:start + step], kernel, stride, padding, dilation)
        if groups == 1:
            acc = int8_matmul(cols, w[0].t())
        else:
            cols = cols.reshape(cols.shape[0], groups, k_len)
            acc = torch.cat([int8_matmul(cols[:, g], w[g].t()) for g in range(groups)], dim=1)
        chunks.append(acc.reshape((-1,) + out_spatial + (c_out,)))
    acc = chunks[0] if len(chunks) == 1 else torch.cat(chunks)
    return acc.permute((0, nd + 1) + tuple(range(1, nd + 1))).contiguous()


def linear_qdq(x: torch.Tensor, qw: QuantizedLinearWeight) -> torch.Tensor:
    """y = dequant(int8(x) @ qweightᵀ): the last axis of ``x`` contracted with
    int32 accumulation, the combined (wscale · act_scale) factor broadcast
    over the output features."""
    xq = quantize_activation(x, qw.act_scale)
    acc = int8_matmul(xq.reshape(-1, x.shape[-1]), qw.qweight.t())
    acc = acc.reshape(x.shape[:-1] + (qw.qweight.shape[0],))
    return (acc.float() * (qw.wscale * qw.act_scale)).to(x.dtype)


def is_quantized(model: nn.Module) -> bool:
    """Whether any of ``model``'s modules is a quantized weight."""
    return any(isinstance(m, QuantizedWeight) for m in model.modules())


def quantized_paths(model: nn.Module) -> list:
    """The dotted paths of ``model``'s quantized weights (``....weight``),
    the JAX tree's quantized leaf paths."""
    return [name for name, m in model.named_modules() if isinstance(m, QuantizedWeight)]
