"""
K2: softmax attention at small T (self-attention, T <= 1024, d <= 64).

Replaces the Pallas TPU kernel
``fmdm_tpu/ops/pallas/flash_attention.py::_mha_packed_kernel`` (:436-449,
entry ``mha_small_t`` :499-523) with the CUDA kernel in
``fmdm_tpu_torch/csrc/small_t_attention.cu``. At the flagship's shapes (64
heads x d=8 at T=256 and T=64) the T² exponentials per head bound it in bf16
and the products (3xTF32) in f32. Both products run on the tensor cores: one
warp per 16 query rows of a head, K and V staged through shared memory, the
T x T scores only in registers. Two passes over K (row max, then exp and PV)
keep the TPU kernel's rounding: P is rounded to V's dtype against the final
row max.

:func:`small_t_attention` launches the kernel for CUDA tensors and takes the
plain version, :func:`small_t_attention_reference`, only for CPU tensors. The
backward goes through the plain version's autograd, as ``_mha_packed_bwd_rule``
recomputes the reference VJP.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from fmdm_tpu_torch.ops.kernels import build

K2 = build.KernelRecord(
    name="K2 small_t_attention",
    source="fmdm_tpu_torch/csrc/small_t_attention.cu",
    replaces="fmdm_tpu/ops/pallas/flash_attention.py:436",
)

MAX_T = 1024
MAX_HEAD_DIM = 64
_MAX_ROWS = 64  # query rows per block: kMaxWarps in small_t_attention.cu x 16
_DTYPES = (torch.float32, torch.bfloat16)


def _default_scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def small_t_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: Optional[float] = None
) -> torch.Tensor:
    """Plain version over (..., T, d): f32 logits from the input dtype times
    the scale, f32 softmax, P rounded to V's dtype before PV, PV in f32,
    divided by the f32 row sum, cast to q's dtype."""
    scale = _default_scale(q, scale)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype)


@functools.lru_cache(maxsize=1)
def _entry():
    fn = build.library().fmdm_small_t_attention
    P = ctypes.c_void_p
    fn.argtypes = [ctypes.c_int, P, P, P, P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_int, ctypes.c_int, P]
    fn.restype = ctypes.c_int
    return fn


def _validate(q, k, v) -> None:
    """Raise on anything the kernel does not take (checked on every device,
    so the CPU runs hold the callers to the kernel's contract)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape or not t.is_contiguous():
            raise ValueError(
                f"small_t_attention: q, k, v must be contiguous tensors of one shape, dtype "
                f"and device; {name} is {tuple(t.shape)} {t.dtype} on {t.device}, "
                f"q is {tuple(q.shape)} {q.dtype} on {q.device}")
    if q.dtype not in _DTYPES or q.dim() < 2:
        raise ValueError(f"small_t_attention: need f32/bf16 (..., T, d); got {tuple(q.shape)} {q.dtype}")
    t, d = q.shape[-2], q.shape[-1]
    bh = q.numel() // max(t * d, 1)
    if not (1 <= t <= MAX_T and 1 <= d <= MAX_HEAD_DIM):
        raise ValueError(f"small_t_attention: takes T <= {MAX_T} and d <= {MAX_HEAD_DIM}; "
                         f"got T={t}, d={d}")
    if bh > build.MAX_GRID_Y:
        raise ValueError(f"small_t_attention: {bh} heads exceed {build.MAX_GRID_Y}")


def _launch(q, k, v, scale: float) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (inputs validated)."""
    t, d = q.shape[-2], q.shape[-1]
    bh = q.numel() // (t * d)
    out = torch.empty_like(q)
    if bh == 0:
        return out
    rows = min(_MAX_ROWS, 16 * math.ceil(t / 16))
    index = q.device.index if q.device.index is not None else torch.cuda.current_device()
    status = _entry()(
        index, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        bh, t, d, float(scale), rows, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check_status(status, K2.name)
    K2.launches += 1
    return out


class _SmallTAttention(torch.autograd.Function):
    """Kernel forward; backward through the plain version's autograd."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _launch(q, k, v, scale)

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
            out = small_t_attention_reference(*leaves, scale=ctx.scale)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad) if wanted else ())
        return tuple(next(grads) if t.requires_grad else None for t in leaves) + (None,)


def small_t_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: Optional[float] = None
) -> torch.Tensor:
    """Self-attention softmax(q kᵀ · scale) v over contiguous (..., T, d).

    CUDA tensors go through kernel K2 (or raise); CPU tensors take the plain
    version."""
    scale = _default_scale(q, scale)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"small_t_attention: unsupported device {q.device}")
    _validate(q, k, v)
    if q.device.type == "cpu":
        return small_t_attention_reference(q, k, v, scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _SmallTAttention.apply(q, k, v, scale)
    return _launch(q, k, v, scale)
