"""
The plain operations of the reference models, and the two things the
benchmark asks of them besides their values.

Every operation runs in float32 (TF32 off, which the caller sets) unless the
``Ops`` object says ``precision="fp8"``: then each operand of a product (a
convolution's input and weight, a linear layer's, the attention's q, k, v and
probabilities) is rounded to float8 e4m3 with one scale per tensor (its
largest magnitude onto e4m3's 448), and its gradient to e5m2 likewise, and
they are multiplied in float32. That is the
control of the correctness check: the reference put in the program's place
one precision below the bf16 the configurations state.

With a ``recorder`` (a list), every product and every GroupNorm appends an
:class:`Op` with its shapes, so the benchmark counts operations and bytes on
the reference's own shapes (run on the ``meta`` device, no memory and no
time), never on the program's modules.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
import torch.nn.functional as F

FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}  # largest finite values
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@dataclasses.dataclass
class Op:
    """One operation of a forward pass, by shape.

    ``kind``: "conv", "linear", "attention" (softmax), "linear_attention",
    "group_norm". ``macs``: multiply-adds of the forward. ``x``, ``w``, ``y``:
    elements of the input, weight and output (q+k+v and o for attention).
    ``grad_input``: whether the input needs a gradient (a backward computes
    dX only then). ``kernel``: the GroupNorm + SiLU of a ResBlock, which the
    program runs in its K1 kernel; ``film``: with a FiLM scale and shift.
    ``side``: elements of a FiLM's scale and shift. ``tokens``/``keys``/
    ``head_dim``: an attention's T, S and d."""

    kind: str
    macs: int = 0
    x: int = 0
    w: int = 0
    y: int = 0
    grad_input: bool = False
    kernel: bool = False
    film: bool = False
    channels: int = 0
    side: int = 0
    tokens: int = 0
    keys: int = 0
    head_dim: int = 0


def fp8_round(t: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """``t`` rounded to a float8 type under one per-tensor scale (its largest
    magnitude onto the type's largest value), back in f32."""
    t = t.float()
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX[dtype]
    return (t / scale).to(dtype).float() * scale


class _FP8Operand(torch.autograd.Function):
    """An operand in e4m3 forward; its gradient in e5m2 backward (the usual
    fp8 training recipe, each tensor with its own scale)."""

    @staticmethod
    def forward(ctx, t):
        return fp8_round(t)

    @staticmethod
    def backward(ctx, grad):
        return fp8_round(grad, torch.float8_e5m2)


class Ops:
    """The reference's arithmetic: f32 or the fp8 control; optionally
    recording each operation's shapes."""

    def __init__(self, precision: str = "f32", recorder: Optional[List[Op]] = None):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision must be f32 or fp8, got {precision!r}")
        self.precision = precision
        self.recorder = recorder

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        return _FP8Operand.apply(t) if self.precision == "fp8" and t.device.type != "meta" else t

    def _record(self, op: Op) -> None:
        if self.recorder is not None:
            self.recorder.append(op)

    def conv(self, x, weight, bias, stride: int = 1, padding: int = 0) -> torch.Tensor:
        nd = x.dim() - 2
        y = _CONV[nd](self.operand(x), self.operand(weight), None, stride=stride, padding=padding)
        self._record(Op("conv", macs=weight[0].numel() * y.numel(), x=x.numel(), w=weight.numel(),
                        y=y.numel(), grad_input=x.requires_grad))
        return y + bias.float().reshape((1, -1) + (1,) * nd)

    def linear(self, x, weight, bias) -> torch.Tensor:
        y = F.linear(self.operand(x), self.operand(weight))
        self._record(Op("linear", macs=weight.shape[1] * y.numel(), x=x.numel(), w=weight.numel(),
                        y=y.numel(), grad_input=x.requires_grad))
        return y + bias.float()

    def attention(self, q, k, v) -> torch.Tensor:
        """softmax(q kᵀ / √d) v over (..., T, d)."""
        t, s, d = q.shape[-2], k.shape[-2], q.shape[-1]
        rows = q.numel() // (t * d)
        scores = torch.matmul(self.operand(q), self.operand(k).transpose(-1, -2)) / math.sqrt(d)
        probs = torch.softmax(scores, dim=-1)
        out = torch.matmul(self.operand(probs), self.operand(v))
        self._record(Op("attention", macs=rows * t * s * (d + v.shape[-1]),
                        x=q.numel() + k.numel() + v.numel(), y=out.numel(),
                        grad_input=q.requires_grad, tokens=t, keys=s, head_dim=d))
        return out

    def linear_attention(self, q, k, v, eps: float = 1e-6) -> torch.Tensor:
        """Keys softmaxed over tokens, queries over features, the context
        kᵀ v normalized by each feature's key mass."""
        k_soft = torch.softmax(k.float(), dim=-2)
        q_soft = torch.softmax(q.float(), dim=-1)
        context = torch.einsum("...nd,...ne->...de", self.operand(k_soft), self.operand(v))
        context = context / (k_soft.sum(dim=-2)[..., :, None] + eps)
        out = torch.einsum("...nd,...de->...ne", self.operand(q_soft), self.operand(context))
        n, d, e = k.shape[-2], k.shape[-1], v.shape[-1]
        rows = k.numel() // (n * d)
        self._record(Op("linear_attention", macs=2 * rows * n * d * e,
                        x=q.numel() + k.numel() + v.numel(), y=out.numel(),
                        grad_input=q.requires_grad, tokens=n, keys=n, head_dim=d))
        return out

    def group_norm(self, x, weight, bias, groups: int, eps: float, *, act: bool = False,
                   scale=None, shift=None, kernel: bool = False) -> torch.Tensor:
        """GroupNorm in f32 (two-pass statistics), then an optional FiLM
        ``y (1 + scale) + shift`` with (N, C) scale and shift, then an
        optional SiLU. ``kernel`` marks the calls the program sends to K1."""
        y = F.group_norm(x.float(), groups, weight.float(), bias.float(), eps)
        if scale is not None:
            shape = tuple(scale.shape) + (1,) * (x.dim() - 2)
            y = y * (1 + scale.float().reshape(shape)) + shift.float().reshape(shape)
        self._record(Op("group_norm", x=x.numel(), y=x.numel(), w=2 * x.shape[1],
                        channels=x.shape[1], kernel=kernel, film=scale is not None,
                        side=0 if scale is None else scale.numel() + shift.numel()))
        return F.silu(y) if act else y
