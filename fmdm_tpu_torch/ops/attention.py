"""
Attention primitives (counterpart of ``fmdm_tpu/ops/attention.py:126-189``).

``sdpa_xla`` is the plain formulation, including the JAX package's bf16
scores contract. ``sdpa`` dispatches:

- a CPU tensor takes ``sdpa_xla``;
- CUDA self-attention with T == S < 1024 (and d <= 64) goes to kernel K2
  (``ops/kernels/small_t_attention.py``);
- a CUDA call with Tq >= 1024 goes to the flash kernels, K3 forward and K4/K5
  backward (``ops/kernels/flash_attention.py``), which raise on what they do
  not take (d > 128, k and v of another head dim). JAX tests only Tq (:164);
- any other CUDA call raises ``NotImplementedError``.

The ring and sequence-parallel routing of the JAX module are not ported.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from fmdm_tpu_torch.ops.kernels.flash_attention import flash_attention
from fmdm_tpu_torch.ops.kernels.small_t_attention import MAX_HEAD_DIM, small_t_attention

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


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         scale: Optional[float] = None) -> torch.Tensor:
    """Scaled dot-product attention over (..., T, d) / (..., S, d) / (..., S, d_v)."""
    if q.device.type == "cpu":
        return sdpa_xla(q, k, v, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"sdpa: unsupported device {q.device}")
    t, s = q.shape[-2], k.shape[-2]
    if t == s and t < FLASH_MIN_TOKENS and q.shape == k.shape == v.shape \
            and q.shape[-1] <= MAX_HEAD_DIM:
        return small_t_attention(q.contiguous(), k.contiguous(), v.contiguous(), scale=scale)
    if t >= FLASH_MIN_TOKENS:
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), scale=scale)
    raise NotImplementedError(
        f"sdpa on CUDA: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} is neither "
        f"self-attention with T < {FLASH_MIN_TOKENS} and d <= {MAX_HEAD_DIM} (kernel K2) nor "
        f"Tq >= {FLASH_MIN_TOKENS} (kernels K3-K5); no kernel of the port takes it.")


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
