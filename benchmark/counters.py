"""
Operations and bytes of a cell's work, counted on the reference model's own
shapes (``benchmark/reference/ops.py`` records every product and GroupNorm
of a forward run on the ``meta`` device), and the least time each kernel
class could take for them at the published peaks (``peaks.py``).

Rules, for a step in the cell's compute dtype:

- a product (convolution, linear, attention) costs 2 FLOPs per
  multiply-add; its backward computes the weight's (or K's and V's)
  gradient always and the input's only where the input needs one, each as
  many multiply-adds as the forward; nothing recomputed is counted;
- a kernel call moves each input byte once and each output byte once:
  a convolution x, w and y; its dgrad dy, w and dx; its wgrad x, dy, dw;
  an attention q, k, v and o, and its backward q, k, v, o, do, dq, dk, dv;
  a K1 call x, y, the affine in f32 and a FiLM's scale and shift;
- a call's least time is the larger of its FLOPs over the dtype's product
  peak and its bytes over the HBM rate.

Which attention calls a kernel takes follows the program's routing rule
as it was when the benchmark was written: K2 at T = S < 1024 with d <= 64,
the flash kernels (K3 forward, K4 + K5 backward) at T >= 1024.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

import torch

from benchmark import peaks
from benchmark.reference.ops import Op, Ops


def build_reference(cfg: dict, ops: Ops, device) -> torch.nn.Module:
    """The configuration's reference model (``reference/<cfg["reference"]>.py``)
    with uninitialized weights on ``device``."""
    module = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    with torch.device("meta"):
        model = module.build(ops, cfg["model"], cfg["in_channels"], cfg["channels"])
    return model if device == "meta" else model.to_empty(device=device)


def record_forward(cfg: dict, batch: int, train: bool) -> List[Op]:
    """The ops of one forward of the reference at ``batch``, on ``meta``;
    with ``train`` the weights need gradients, as in a train step."""
    recorder: List[Op] = []
    model = build_reference(cfg, Ops(recorder=recorder), "meta")
    model.requires_grad_(train)
    x = torch.empty((batch, cfg["in_channels"], *cfg["spatial"]), device="meta")
    t = torch.zeros((batch,), device="meta")
    with torch.set_grad_enabled(train):
        model(x, t)
    return recorder


def product_flops(op: Op, train: bool) -> float:
    """FLOPs of one product op over a forward (and its backward under ``train``)."""
    if op.kind not in ("conv", "linear", "attention", "linear_attention"):
        return 0.0
    fwd = 2.0 * op.macs
    if not train:
        return fwd
    if op.kind in ("attention", "linear_attention"):
        return fwd + 2.0 * fwd
    return fwd + fwd * (2 if op.grad_input else 1)


def flops(ops: List[Op], train: bool) -> float:
    return sum(product_flops(op, train) for op in ops)


def _seconds(op_flops: float, elems: float, dtype: str) -> float:
    return max(op_flops / peaks.PRODUCT_FLOPS[dtype],
               elems * peaks.DTYPE_BYTES[dtype] / peaks.HBM_BYTES)


def conv_bound_s(ops: List[Op], train: bool, dtype: str) -> float:
    """Least seconds of the convolutions of one forward (and backward)."""
    total = 0.0
    for op in ops:
        if op.kind != "conv":
            continue
        total += _seconds(2.0 * op.macs, op.x + op.w + op.y, dtype)
        if train:
            total += _seconds(2.0 * op.macs, op.x + op.y + op.w, dtype)          # wgrad
            if op.grad_input:
                total += _seconds(2.0 * op.macs, op.y + op.w + op.x, dtype)      # dgrad
    return total


def k1_bound_s(ops: List[Op], dtype: str) -> float:
    """Least seconds of the K1 calls of one forward: bytes alone (the
    backward is the plain autograd of the reference, not K1)."""
    e = peaks.DTYPE_BYTES[dtype]
    moved = sum((op.x + op.y + op.side) * e + op.w * 4 for op in ops
                if op.kind == "group_norm" and op.kernel)
    return moved / peaks.HBM_BYTES


def attention_route(op: Op) -> str:
    if op.kind != "attention":
        return ""
    if op.tokens == op.keys and op.tokens < 1024 and op.head_dim <= 64:
        return "k2"
    if op.tokens >= 1024:
        return "flash"
    return ""


def attention_bound_s(ops: List[Op], route: str, backward: bool, dtype: str) -> float:
    """Least seconds of the attention calls that ``route`` takes: the
    forward, and with ``backward`` the backward too."""
    total = 0.0
    for op in ops:
        if attention_route(op) != route:
            continue
        total += _seconds(2.0 * op.macs, op.x + op.y, dtype)
        if backward:
            total += _seconds(4.0 * op.macs, 2 * op.x + 2 * op.y, dtype)
    return total
