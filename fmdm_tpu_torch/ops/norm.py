"""
Group normalization for channels-first ND tensors (counterpart of
``fmdm_tpu/ops/norm.py:18-136``).

Statistics are taken in float32 whatever the input dtype, with the JAX
package's ONE-pass variance: E[x²] - mean², clamped at 0 (``norm.py:27-46``).
This formulation is also the plain version of the statistics of kernel K1
(``ops/kernels/group_norm.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def safe_num_groups(channels: int, groups: int = 32) -> int:
    """Largest divisor of ``channels`` that is <= groups."""
    num_groups = min(groups, channels)
    while channels % num_groups != 0 and num_groups > 1:
        num_groups -= 1
    return num_groups


def group_norm_stats(x: torch.Tensor, num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, group) f32 mean and variance in one pass (sum and sum of
    squares), variance clamped at 0. Returns two (N, G) tensors."""
    n = x.shape[0]
    xf = x.float().reshape(n, num_groups, -1)
    m = xf.shape[2]
    s1 = xf.sum(dim=2)
    s2 = (xf * xf).sum(dim=2)
    mean = s1 / m
    var = torch.clamp(s2 / m - mean * mean, min=0.0)
    return mean, var


def _normalize_affine_f32(x, mean, var, weight, bias, num_groups: int, eps: float) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * weight + bias, all in f32."""
    n, c = x.shape[0], x.shape[1]
    spatial = x.shape[2:]
    mean = mean.reshape(n, num_groups, 1, 1)
    var = var.reshape(n, num_groups, 1, 1)
    xf = x.float().reshape(n, num_groups, c // num_groups, -1)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    xf = xf.reshape(n, c, *spatial)
    if weight is not None:
        shape = (1, c) + (1,) * len(spatial)
        xf = xf * weight.float().reshape(shape)
        if bias is not None:
            xf = xf + bias.float().reshape(shape)
    return xf


def group_norm_f32(
    x: torch.Tensor,
    weight: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    *,
    num_groups: int,
    eps: float = 1e-5,
) -> torch.Tensor:
    """GroupNorm over (N, C, *spatial), returned in float32 (not cast back)."""
    mean, var = group_norm_stats(x, num_groups)
    return _normalize_affine_f32(x, mean, var, weight, bias, num_groups, eps)


def group_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    *,
    num_groups: int,
    eps: float = 1e-5,
) -> torch.Tensor:
    """GroupNorm over (N, C, *spatial), cast back to the input dtype."""
    return group_norm_f32(x, weight, bias, num_groups=num_groups, eps=eps).to(x.dtype)


def group_norm_parts(
    parts: Sequence[torch.Tensor],
    weight: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    *,
    num_groups: int,
    eps: float = 1e-5,
) -> torch.Tensor:
    """GroupNorm over a channel-concat of ``parts``, statistics reduced per
    part (per channel, so a group may straddle a part boundary). Numerically
    ``group_norm(torch.cat(parts, 1), ...)``; returns the normalized
    concatenated tensor."""
    n = parts[0].shape[0]
    c_total = sum(p.shape[1] for p in parts)
    if c_total % num_groups != 0:
        raise ValueError(f"channels {c_total} not divisible by groups {num_groups}")
    cg = c_total // num_groups
    m_spatial = 1
    for s in parts[0].shape[2:]:
        m_spatial *= s

    s1_parts, s2_parts = [], []
    for p in parts:
        pf = p.float().reshape(n, p.shape[1], -1)
        s1_parts.append(pf.sum(dim=2))
        s2_parts.append((pf * pf).sum(dim=2))
    s1 = torch.cat(s1_parts, dim=1).reshape(n, num_groups, cg)
    s2 = torch.cat(s2_parts, dim=1).reshape(n, num_groups, cg)
    m = cg * m_spatial
    mean = s1.sum(dim=2) / m
    var = torch.clamp(s2.sum(dim=2) / m - mean * mean, min=0.0)

    x = torch.cat(list(parts), dim=1)
    return _normalize_affine_f32(x, mean, var, weight, bias, num_groups, eps).to(x.dtype)


def rms_norm_nd(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over ALL non-batch dims (not per channel or group) with a
    per-channel scale, in f32, cast back to the input dtype."""
    xf = x.float()
    dims = tuple(range(1, x.dim()))
    rms = torch.sqrt(torch.mean(torch.square(xf), dim=dims, keepdim=True) + eps)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return (weight.float().reshape(shape) * xf / rms).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor], bias: Optional[torch.Tensor], *,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the trailing dim: biased variance and rsqrt(var + eps)
    in f32, one rounding to the input dtype at the end."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
