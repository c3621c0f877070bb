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

The ring and sequence-parallel routing of the JAX module are not ported.
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
