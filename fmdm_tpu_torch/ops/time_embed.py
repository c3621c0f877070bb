"""
Sinusoidal timestep embeddings (counterpart of
``fmdm_tpu/ops/time_embed.py:18-36``), with the diffusers semantics: half-dim
exponent scaled by 1/max(half - freq_shift, 1), sin||cos concat, optional
flip to cos||sin and zero padding of an odd dim.
"""

from __future__ import annotations

import math

import torch


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    max_period: int = 10000,
    *,
    flip_sin_to_cos: bool = True,
    freq_shift: int = 0,
) -> torch.Tensor:
    """timesteps: (N,) -> (N, dim) float32 positional embeddings."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / max(half - freq_shift, 1)
    args = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    embedding = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if flip_sin_to_cos:
        embedding = torch.cat([embedding[:, half:], embedding[:, :half]], dim=-1)
    if dim % 2:
        embedding = torch.cat([embedding, torch.zeros_like(embedding[:, :1])], dim=-1)
    return embedding
