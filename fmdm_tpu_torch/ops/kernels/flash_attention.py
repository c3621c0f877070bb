"""
K3, K4, K5: flash attention forward and backward at long T.

Replaces the Pallas TPU kernels of ``fmdm_tpu/ops/pallas/flash_attention.py``
with the CUDA kernels in ``fmdm_tpu_torch/csrc/`` (``flash_attention.cu``,
``flash_backward_dkv.cu``, ``flash_backward_dq.cu``; ``flash.cuh`` holds what
they share):

- K3, ``_flash_fwd_kernel`` (:35-62): ``flash_forward`` returns ``out`` and
  ``lse = m + log l``, with the scale folded into q before the dot (:37);
- K4, ``_flash_bwd_dkv_kernel`` (:143-171): dK and dV, one KV tile per block
  looping over the Q tiles;
- K5, ``_flash_bwd_dq_kernel`` (:174-193): dQ, one Q tile per block looping
  over the KV tiles.

At the VAE's mid attention (B, 4, 1024, 64) in f32 the operations bound all
three, and all three run every product on the tensor cores in 3xTF32 (three
TF32 products per f32 product, which keeps f32 accuracy). The T x T scores
stay on chip in both directions; the backward recomputes
p = exp(scale * q kᵀ - lse) from the saved lse, in K4 and again in K5.
``flash_forward`` and ``flash_backward`` have the signatures of
``flash_forward_partials`` and ``flash_backward_chunk`` (:297, :328), the
per-chunk entry points of the ring (``parallel/sequence.py``), which reshape
to (-1, T, d) and call them: K3 on every forward hop, K4 and K5 on every
backward hop.

Each wrapper launches its kernel for CUDA tensors (or raises) and takes the
plain version only for CPU tensors: :func:`flash_attention_reference` (the
scores materialised, f32 softmax) and :func:`flash_backward_reference` (the
XLA formulation of :268-280). Any Tq and Tk are taken, the ragged tails
masked, and head dims up to 128.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from fmdm_tpu_torch.ops.kernels import build
from fmdm_tpu_torch.utils import trace

_CSRC = "fmdm_tpu_torch/csrc/"
K3 = build.KernelRecord(name="K3 flash_forward", source=_CSRC + "flash_attention.cu",
                        replaces="fmdm_tpu/ops/pallas/flash_attention.py:35")
K4 = build.KernelRecord(name="K4 flash_backward_dkv", source=_CSRC + "flash_backward_dkv.cu",
                        replaces="fmdm_tpu/ops/pallas/flash_attention.py:143")
K5 = build.KernelRecord(name="K5 flash_backward_dq", source=_CSRC + "flash_backward_dq.cu",
                        replaces="fmdm_tpu/ops/pallas/flash_attention.py:174")

MAX_HEAD_DIM = 128
DEFAULT_BLOCK_K = 512   # the JAX kernels' KV tile (:32), kept for their block rule
_LANES = 128
_DTYPES = (torch.float32, torch.bfloat16)

Tensor = torch.Tensor


def flash_attention_reference(q: Tensor, k: Tensor, v: Tensor,
                              scale: float) -> Tuple[Tensor, Tensor]:
    """Plain K3 over (..., Tq, d) / (..., Tk, d): f32 scores from q·scale,
    f32 softmax, out cast to q's dtype; lse (..., Tq, 1) in f32."""
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v.float()) / l
    return out.to(q.dtype), m + torch.log(l)


def _backward_reference(q, k, v, dout, lse, delta, scale: float):
    """The XLA formulation (flash_attention.py:268-280) with delta given."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), dout.float()
    p = torch.exp(torch.matmul(qf * scale, kf.transpose(-1, -2)) - lse)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    ds = p * (torch.matmul(gf, vf.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _delta(out: Tensor, dout: Tensor) -> Tensor:
    """rowsum(dO ∘ O) in f32 from O as stored, (..., Tq, 1)."""
    return (dout.float() * out.float()).sum(dim=-1, keepdim=True)


def flash_backward_reference(q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor,
                             dout: Tensor, scale: float) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain K4+K5: (dq, dk, dv) with the T x T probabilities materialised
    from the saved lse."""
    return _backward_reference(q, k, v, dout, lse.float(), _delta(out, dout), scale)


@functools.lru_cache(maxsize=None)
def _entry(name: str, n_pointers: int):
    fn = getattr(build.library(), name)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [I] + [P] * n_pointers + [I, I, I, I, ctypes.c_float, I, P]
    fn.restype = ctypes.c_int
    return fn


def _validate(name: str, q: Tensor, k: Tensor, v: Tensor, **same_as_q: Tensor) -> None:
    """Raise on anything the kernels do not take (checked on every device, so
    the CPU runs hold the callers to the kernels' contract)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dtype not in _DTYPES or q.dim() < 2:
        raise ValueError(f"{name}: need f32/bf16 (..., T, d) tensors; got q {tuple(q.shape)} {q.dtype}")
    d = q.shape[-1]
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: takes head dims 1..{MAX_HEAD_DIM}; got d={d}")
    kv_shape = q.shape[:-2] + (k.shape[-2], d)
    tensors = dict(q=(q, q.shape), k=(k, kv_shape), v=(v, kv_shape),
                   **{n: (t, q.shape) for n, t in same_as_q.items()})
    for n, (t, shape) in tensors.items():
        if t.device != q.device or t.dtype != q.dtype or t.shape != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: {n} must be a contiguous {tuple(shape)} {q.dtype} tensor on {q.device} "
                f"(k and v share q's leading dims and head dim); got {tuple(t.shape)} {t.dtype} "
                f"on {t.device}")
    bh = q.numel() // max(q.shape[-2] * d, 1)
    if bh > build.MAX_GRID_Y or q.shape[-2] < 1 or k.shape[-2] < 1:
        raise ValueError(f"{name}: need 1 <= T and batch*heads <= {build.MAX_GRID_Y}; "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)}")


def _check_rows(name: str, q: Tensor, **rows: Tensor) -> None:
    shape = q.shape[:-1] + (1,)
    for n, t in rows.items():
        if t.device != q.device or t.dtype != torch.float32 or t.shape != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be a contiguous {tuple(shape)} float32 tensor on "
                             f"{q.device}; got {tuple(t.shape)} {t.dtype} on {t.device}")


def _geometry(q: Tensor, k: Tensor):
    tq, d = q.shape[-2], q.shape[-1]
    return q.numel() // (tq * d), tq, k.shape[-2], d


def _launch(record: build.KernelRecord, entry: str, q: Tensor, inputs, outputs,
            k: Tensor, scale: float) -> None:
    bh, tq, tk, d = _geometry(q, k)
    pointers = [t.data_ptr() for t in inputs + outputs]
    index = q.device.index if q.device.index is not None else torch.cuda.current_device()
    status = _entry(entry, len(pointers))(
        index, *pointers, bh, tq, tk, d, float(scale), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check_status(status, record.name)
    record.launches += 1


def flash_forward(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tuple[Tensor, Tensor]:
    """(out, lse) of softmax(q kᵀ · scale) v over contiguous (..., Tq, d) /
    (..., Tk, d); lse is (..., Tq, 1) f32. Kernel K3 on CUDA, the plain
    version on the CPU. Not differentiable: see :func:`flash_attention`."""
    _validate("flash_forward", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:-1] + (1,), dtype=torch.float32, device=q.device)
    _launch(K3, "fmdm_flash_forward", q, [q, k, v], [out, lse], k, scale)
    return out, lse


def flash_backward_dkv(q: Tensor, k: Tensor, v: Tensor, dout: Tensor, lse: Tensor,
                       delta: Tensor, scale: float) -> Tuple[Tensor, Tensor]:
    """(dk, dv) from the saved lse and delta = rowsum(dO ∘ O), both
    (..., Tq, 1) f32. Kernel K4 on CUDA, the plain version on the CPU."""
    _validate("flash_backward_dkv", q, k, v, dout=dout)
    _check_rows("flash_backward_dkv", q, lse=lse, delta=delta)
    if q.device.type == "cpu":
        return _backward_reference(q, k, v, dout, lse, delta, scale)[1:]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(K4, "fmdm_flash_backward_dkv", q, [q, k, v, dout, lse, delta], [dk, dv], k, scale)
    return dk, dv


def flash_backward_dq(q: Tensor, k: Tensor, v: Tensor, dout: Tensor, lse: Tensor,
                      delta: Tensor, scale: float) -> Tensor:
    """dq from the saved lse and delta. Kernel K5 on CUDA, the plain version
    on the CPU."""
    _validate("flash_backward_dq", q, k, v, dout=dout)
    _check_rows("flash_backward_dq", q, lse=lse, delta=delta)
    if q.device.type == "cpu":
        return _backward_reference(q, k, v, dout, lse, delta, scale)[0]
    dq = torch.empty_like(q)
    _launch(K5, "fmdm_flash_backward_dq", q, [q, k, v, dout, lse, delta], [dq], k, scale)
    return dq


def flash_backward(q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor, dout: Tensor,
                   scale: float) -> Tuple[Tensor, Tensor, Tensor]:
    """(dq, dk, dv) against the saved (out, lse): delta in f32 from O as
    stored, then K4 and K5."""
    _validate("flash_backward", q, k, v, out=out, dout=dout)
    delta = _delta(out, dout)
    dk, dv = flash_backward_dkv(q, k, v, dout, lse, delta, scale)
    return flash_backward_dq(q, k, v, dout, lse, delta, scale), dk, dv


class _FlashAttention(torch.autograd.Function):
    """K3 forward saving (q, k, v, out, lse), never the scores; K4 and K5
    backward, under the span ``flash.backward``."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        with trace.span("flash.backward"):
            return flash_backward(q, k, v, out, lse, dout.contiguous(), ctx.scale) + (None,)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, scale: Optional[float] = None) -> Tensor:
    """softmax(q kᵀ · scale) v over contiguous (..., Tq, d) / (..., Tk, d),
    differentiable: K3 forward, K4 and K5 backward on CUDA; the plain
    versions on the CPU."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    return _FlashAttention.apply(q, k, v, scale)


# ---------------------------------------------------------------------------
# The ring's per-chunk entry points (JAX :286-371)
# ---------------------------------------------------------------------------

def pick_block_k(tk: int, cap: int = DEFAULT_BLOCK_K) -> int:
    """Largest KV block <= cap that divides tk (JAX's block rule); tk itself
    when tk <= cap or when nothing divides it."""
    if tk <= cap:
        return tk
    for cand in (cap, 384, 256, 128):
        if cand <= cap and tk % cand == 0:
            return cand
    return tk


def _as_3d(x: Tensor, t: int, d: int) -> Tensor:
    return x.reshape((-1, t, d)).contiguous()


def flash_forward_partials(q: Tensor, k: Tensor, v: Tensor,
                           scale: float) -> Tuple[Tensor, Tensor]:
    """(out, lse) of one KV chunk over (..., T, d): out in q's dtype, lse
    (..., Tq, 1) f32, the normalized flash partials that two chunks combine
    exactly with lse' = logaddexp(lse_a, lse_b). Kernel K3 on CUDA (which
    takes any Tq and Tk), the plain version on the CPU. Not differentiable:
    the ring has its own backward."""
    lead, (tq, d), tk = q.shape[:-2], q.shape[-2:], k.shape[-2]
    out, lse = flash_forward(_as_3d(q, tq, d), _as_3d(k, tk, d), _as_3d(v, tk, v.shape[-1]),
                             float(scale))
    return out.reshape(lead + (tq, v.shape[-1])), lse.reshape(lead + (tq, 1))


def _backward_chunk_einsum(q, k, v, out, lse, g, scale: float):
    """JAX's XLA branch of the chunk backward (:357-366)."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    p = torch.exp(torch.einsum("bqd,bkd->bqk", qf * scale, kf) - lse)
    dv = torch.einsum("bqk,bqd->bkd", p, gf).to(v.dtype)
    dp = torch.einsum("bqd,bkd->bqk", gf, vf)
    ds = p * (dp - _delta(out, g))
    dq = (torch.einsum("bqk,bkd->bqd", ds, kf) * scale).to(q.dtype)
    dk = (torch.einsum("bqk,bqd->bkd", ds, qf) * scale).to(k.dtype)
    return dq, dk, dv


def flash_backward_chunk(q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor,
                         g: Tensor, scale: float) -> Tuple[Tensor, Tensor, Tensor]:
    """(dq, dk, dv) of one KV chunk against the GLOBAL (out, lse) of the
    whole attention: p = exp(q kᵀ · scale - lse) are the chunk's globally
    normalized probabilities and delta = rowsum(g ∘ out) comes from the
    global out, so the results are the chunk's exact contributions.

    Branches: a CUDA tensor always takes K4 + K5 (the kernels take ragged
    T); on the CPU a chunk with ``pick_block_k(tk) % 128 == 0`` takes their
    plain versions and any other chunk JAX's einsum formulation, the shapes
    JAX sends to its Pallas kernels and to XLA respectively."""
    lead, (tq, d), tk, dv_ = q.shape[:-2], q.shape[-2:], k.shape[-2], v.shape[-1]
    q3, k3, v3 = _as_3d(q, tq, d), _as_3d(k, tk, d), _as_3d(v, tk, dv_)
    out3, g3 = _as_3d(out, tq, dv_), _as_3d(g, tq, dv_)
    lse3 = _as_3d(lse.float(), tq, 1)
    bk = pick_block_k(tk)
    if q.device.type == "cuda" or (tk % bk == 0 and bk % _LANES == 0):
        dq, dk, dv = flash_backward(q3, k3, v3, out3, lse3, g3, float(scale))
    else:
        _validate("flash_backward_chunk", q3, k3, v3, out=out3, dout=g3)
        dq, dk, dv = _backward_chunk_einsum(q3, k3, v3, out3, lse3, g3, float(scale))
    return (dq.reshape(lead + (tq, d)), dk.reshape(lead + (tk, d)),
            dv.reshape(lead + (tk, dv_)))
