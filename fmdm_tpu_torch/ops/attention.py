"""
Attention primitives (counterpart of ``fmdm_tpu/ops/attention.py:126-189``).

``sdpa_xla`` is the plain formulation, including the JAX package's bf16
scores contract. ``sdpa`` chooses its route from the shapes, before any
launch:

- a CPU tensor takes ``sdpa_xla``;
- CUDA self-attention with T == S < 1024 and d <= 64 goes to kernel K2
  (``ops/kernels/small_t_attention.py``);
- a CUDA call with Tq >= 1024, d <= 128 and k, v of q's head dim goes to the
  flash kernels, K3 forward and K4/K5 backward
  (``ops/kernels/flash_attention.py``). JAX tests only Tq (:164);
- every other CUDA call (cross-attention with Tq < 1024, self-attention with
  d > 64 at T < 1024, d > 128 at Tq >= 1024) takes ``sdpa_xla`` in stock
  PyTorch, as JAX computes it with stock XLA where no Pallas kernel takes
  the call (:162-173). No kernel is replaced by it.

Sequence-parallel routing (JAX :36-125): while a context is set
(:func:`set_sequence_parallel`, or :class:`sequence_parallel_scope`), ``sdpa``
sends a call whose token counts are >= ``min_tokens`` and divisible by the
``seq`` axis through the ring (``parallel/sequence.py``); other calls stay
local. JAX's dp x sp layout keeps the convolutions' batch sharded over both
axes and lets GSPMD reshard rows to tokens at the attention; the port does
it explicitly:

- rank form (a ``Mesh2D`` over ranks): an ``all_to_all`` inside the ``seq``
  group turns each rank's rows x T tokens into the group's rows x T / sp
  tokens, the ring runs over the group, and the inverse ``all_to_all``
  brings each rank its rows back, all differentiable;
- one-process form (a ``Mesh2D`` of devices, as the sampling engines hold
  it): the call's tokens are cut over the devices of the context's data
  row, the ring runs over them, and the shards are concatenated back.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from fmdm_tpu_torch.ops.kernels import build
from fmdm_tpu_torch.ops.kernels import flash_attention as flash
from fmdm_tpu_torch.ops.kernels import small_t_attention as small_t
from fmdm_tpu_torch.ops.kernels.flash_attention import flash_attention
from fmdm_tpu_torch.ops.kernels.small_t_attention import small_t_attention

FLASH_MIN_TOKENS = 1024  # from here on the JAX package uses flash attention (K3)

# (mesh, axis, min_tokens[, data row of a one-process mesh]) or None
_SEQ_PARALLEL = None


def set_sequence_parallel(mesh, axis: str = "seq", min_tokens: int = 512) -> None:
    """Route ``sdpa`` through ring attention over ``mesh``'s ``axis`` for
    token counts that are >= min_tokens and divisible by the axis size."""
    global _SEQ_PARALLEL
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no '{axis}' axis (axes: {mesh.axis_names})")
    _SEQ_PARALLEL = (mesh, axis, int(min_tokens))


def clear_sequence_parallel() -> None:
    global _SEQ_PARALLEL
    _SEQ_PARALLEL = None


def get_sequence_parallel():
    return _SEQ_PARALLEL


class sequence_parallel_scope:
    """Temporarily install ``ctx`` ((mesh, axis, min_tokens[, row]) or None)
    as the routing, restoring the previous value on exit: the sampling
    engines scope it to their own mesh, so that a trainer's process-global
    routing never reaches a model call over other devices."""

    def __init__(self, ctx):
        self._ctx = ctx

    def __enter__(self):
        global _SEQ_PARALLEL
        self._prev = _SEQ_PARALLEL
        _SEQ_PARALLEL = self._ctx

    def __exit__(self, *exc):
        global _SEQ_PARALLEL
        _SEQ_PARALLEL = self._prev
        return False


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable ``all_to_all`` of a tensor whose dim 0 is the group
    size: block i goes to the group's rank i."""
    from torch.distributed.nn.functional import all_to_all_single

    return all_to_all_single(torch.empty_like(x), x.contiguous(), group=group)


def _maybe_ring_sdpa(q, k, v, scale):
    """The ring over the context's ``seq`` axis when it divides the token
    dims; None => the caller takes the local path."""
    from fmdm_tpu_torch.parallel.sequence import ring_attention, sequence_parallel_sdpa

    mesh, axis, min_tokens = _SEQ_PARALLEL[:3]
    n = mesh.axis_size(axis)
    if n <= 1 or q.dim() < 3:
        return None
    t, s = q.shape[-2], k.shape[-2]
    if t < min_tokens or t % n != 0 or s % n != 0:
        return None  # e.g. short cross-attention context: stay local
    if mesh.spans_ranks:
        group = mesh.group(axis)
        # rows x T tokens -> the group's rows x T / n tokens
        to_tokens = lambda x: _all_to_all(torch.stack(x.chunk(n, dim=-2)), group).flatten(0, 1)
        out = ring_attention(to_tokens(q), to_tokens(k), to_tokens(v), group=group, scale=scale)
        back = _all_to_all(out.unflatten(0, (n, q.shape[0])), group)
        return torch.cat(back.unbind(0), dim=-2)
    row = _SEQ_PARALLEL[3] if len(_SEQ_PARALLEL) > 3 else 0
    return sequence_parallel_sdpa(q, k, v, devices=mesh.devices[row], scale=scale)


def sdpa_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q kᵀ · scale) v over the last two dims with f32 accumulation.

    Under bf16 inputs the scores are rounded to bf16 before the softmax (the
    softmax arithmetic itself stays f32), as ``sdpa_xla`` does in JAX; f32
    inputs take the exact path."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    dtype = q.dtype
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if dtype == torch.bfloat16:
        logits = logits.to(dtype)
        m = logits.amax(dim=-1, keepdim=True)
        unnorm = torch.exp((logits - m).float())
        weights = (unnorm / unnorm.sum(dim=-1, keepdim=True)).to(dtype)
    else:
        weights = torch.softmax(logits, dim=-1).to(dtype)
    return torch.matmul(weights.float(), v.float()).to(dtype)


def kernel_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Which route ``sdpa`` takes for these CUDA tensors: "K2", "flash" (K3
    forward, K4/K5 backward) or "sdpa_xla", from shapes and dtypes alone."""
    t, s, d = q.shape[-2], k.shape[-2], q.shape[-1]
    if q.dtype not in (torch.float32, torch.bfloat16) or not q.dtype == k.dtype == v.dtype:
        return "sdpa_xla"
    heads = q.numel() // max(t * d, 1)
    if heads > build.MAX_GRID_Y:
        return "sdpa_xla"
    if t < FLASH_MIN_TOKENS:
        if q.shape == k.shape == v.shape and d <= small_t.MAX_HEAD_DIM:
            return "K2"
        return "sdpa_xla"
    if d <= flash.MAX_HEAD_DIM and k.shape == v.shape == q.shape[:-2] + (s, d):
        return "flash"
    return "sdpa_xla"


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         scale: Optional[float] = None) -> torch.Tensor:
    """Scaled dot-product attention over (..., T, d) / (..., S, d) / (..., S, d_v)."""
    if _SEQ_PARALLEL is not None:
        out = _maybe_ring_sdpa(q, k, v, scale)
        if out is not None:
            return out
    if q.device.type == "cpu":
        return sdpa_xla(q, k, v, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"sdpa: unsupported device {q.device}")
    route = kernel_route(q, k, v)
    if route == "K2":
        return small_t_attention(q.contiguous(), k.contiguous(), v.contiguous(), scale=scale)
    if route == "flash":
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), scale=scale)
    return sdpa_xla(q, k, v, scale=scale)


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     eps: float = 1e-6) -> torch.Tensor:
    """O(N) softmax-factored linear attention: k softmaxed over tokens, q over
    features, context = kᵀ v normalized by the per-feature key mass."""
    dtype = q.dtype
    k_soft = torch.softmax(k.float(), dim=-2)
    q_soft = torch.softmax(q.float(), dim=-1)
    context = torch.einsum("...nd,...ne->...de", k_soft, v.float())
    context = context / (k_soft.sum(dim=-2)[..., :, None] + eps)
    return torch.einsum("...nd,...de->...ne", q_soft, context).to(dtype)
