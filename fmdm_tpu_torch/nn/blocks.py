"""
Reusable blocks (counterpart of ``fmdm_tpu/nn/blocks.py``): ``ResBlockND``
(:42-169), ``SpatialSelfAttention`` (:176-203, softmax and linear),
``SpatialCrossAttention`` (:206-260), ``DiffusersAttentionND`` with
``_ToOut`` (:262-357), ``UpsampleND``/``DownsampleND`` (:364-394) and
``PoolND``/``UnPoolND`` (:397-435). Parameter paths match the JAX trees:
norm1, conv1.conv, emb_layers, norm2, conv2.conv, skip_connection[.conv];
norm, qkv, proj_out; norm, context_norm, q_proj, kv_proj, proj_out;
group_norm, to_q, to_k, to_v, to_out.0; conv.conv; op.conv; down.conv;
up.convT.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from fmdm_tpu_torch.device import DeviceArg, resolve_device
from fmdm_tpu_torch.nn.layers import (Conv, ConvND, ConvTransposeND, GroupNorm, Linear,
                                      RMSNormND, make_activation, make_group_norm)
from fmdm_tpu_torch.ops.attention import linear_attention, sdpa
from fmdm_tpu_torch.ops.kernels.group_norm import group_norm_act
from fmdm_tpu_torch.ops.resample import avg_pool_nd, upsample_nearest


class ResBlockND(nn.Module):
    """Residual block with optional timestep conditioning (FiLM or additive).

    GroupNorm(+FiLM)+SiLU goes through kernel K1 on CUDA. An input given as a
    tuple of parts (the decoder's [hidden, skip]) is concatenated first, which
    the skip connection needs anyway, and K1 normalizes the concatenation:
    numerically the JAX ``group_norm_parts`` path. ``norm_type="rmsnorm"``
    (``RMSNormND``, eps 1e-6 whatever ``norm_eps`` says, as in JAX) takes the
    plain path: norm, the optional FiLM, the activation; no K1."""

    def __init__(
        self,
        channels: int,
        emb_channels: Optional[int],
        dropout: float,
        out_channels: Optional[int] = None,
        use_conv: bool = False,
        use_scale_shift_norm: bool = False,
        spatial_dims: int = 2,
        norm_type: str = "gn",
        act: str = "silu",
        norm_groups: int = 32,
        norm_eps: float = 1e-5,
        zero_init_last_conv: bool = True,
        emb_activation_before_proj: bool = False,
        add_embedding_to_hidden: bool = False,
        *,
        device: DeviceArg = None,
    ):
        super().__init__()
        device = resolve_device(device)
        if emb_channels is None and use_scale_shift_norm:
            raise ValueError("use_scale_shift_norm requires emb_channels to be provided.")
        self.channels = channels
        self.out_channels = out_channels or channels
        self.dropout_rate = dropout
        self.use_scale_shift_norm = use_scale_shift_norm and emb_channels is not None
        self.uses_embedding = emb_channels is not None
        self.emb_activation_before_proj = emb_activation_before_proj
        self.add_embedding_to_hidden = add_embedding_to_hidden

        self.act = make_activation(act)
        self.norm1 = self._make_norm(norm_type, channels, norm_groups, norm_eps, device)
        self.conv1 = ConvND(spatial_dims, channels, self.out_channels, 3, padding=1, device=device)
        if self.uses_embedding:
            self.emb_layers = Linear(
                emb_channels,
                2 * self.out_channels if self.use_scale_shift_norm else self.out_channels,
                device=device,
            )
        self.norm2 = self._make_norm(norm_type, self.out_channels, norm_groups, norm_eps, device)
        self.conv2 = ConvND(spatial_dims, self.out_channels, self.out_channels, 3, padding=1,
                            zero_init=zero_init_last_conv, device=device)

        if self.out_channels == channels:
            self.skip_connection = nn.Identity()
        elif use_conv:
            self.skip_connection = ConvND(spatial_dims, channels, self.out_channels, 3, padding=1,
                                          device=device)
        else:
            self.skip_connection = ConvND(spatial_dims, channels, self.out_channels, 1, device=device)

    @staticmethod
    def _make_norm(norm_type: str, channels: int, norm_groups: int, norm_eps: float,
                   device: torch.device) -> nn.Module:
        norm_type = norm_type.lower()
        if norm_type == "gn":
            return make_group_norm(channels, groups=norm_groups, eps=norm_eps, device=device)
        if norm_type == "rmsnorm":
            return RMSNormND(channels, device=device)
        raise ValueError(f"Unsupported norm_type '{norm_type}'")

    def _gn_act(self, norm: nn.Module, x: torch.Tensor, scale=None, shift=None) -> torch.Tensor:
        """Norm(+FiLM)+act; through K1 for a GroupNorm with SiLU."""
        if isinstance(norm, GroupNorm) and self.act is F.silu:
            return group_norm_act(x, norm.weight, norm.bias, num_groups=norm.num_groups,
                                  eps=norm.eps, act=True, scale=scale, shift=shift)
        h = norm(x)
        if scale is not None:
            nd = x.dim() - 2
            h = h * (1 + scale.reshape(scale.shape + (1,) * nd)) + shift.reshape(shift.shape + (1,) * nd)
        return self.act(h)

    def forward(self, x: Union[torch.Tensor, Sequence[torch.Tensor]],
                emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        if isinstance(x, (tuple, list)):
            x = torch.cat(list(x), dim=1)
        h = self.conv1(self._gn_act(self.norm1, x))

        scale = shift = None
        if self.uses_embedding:
            if emb is None:
                raise ValueError("ResBlockND expects `emb` when emb_channels is set.")
            e = self.act(emb) if self.emb_activation_before_proj else emb
            emb_out = self.emb_layers(e).to(h.dtype)
            if self.use_scale_shift_norm:
                scale, shift = (t.contiguous() for t in emb_out.chunk(2, dim=1))  # (N, C) each
            elif self.add_embedding_to_hidden:
                h = h + emb_out.reshape(emb_out.shape + (1,) * (h.dim() - emb_out.dim()))

        h = self._gn_act(self.norm2, h, scale=scale, shift=shift)
        h = F.dropout(h, self.dropout_rate, training=self.training)
        h = self.conv2(h)
        return self.skip_connection(x) + h


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(b, heads·width, T) read as (b, heads, T, width): the reference's raw
    reshape, not a transpose."""
    return t.reshape(t.shape[0], heads, t.shape[-1], -1)


class SpatialSelfAttention(nn.Module):
    """Flatten-spatial multi-head self-attention with a residual and a
    zero-initialized output projection. Params: norm, qkv (Conv1d), proj_out
    (Conv1d).

    The head split and merge are the reference's raw reshapes, not
    transposes: (b, 3·inner, T) is read as (b, heads, T, 3·head_dim) and split
    on the last axis, and (b, heads, T, head_dim) is read back as
    (b, inner, T). Softmax attention goes through ``sdpa`` (K2 at T < 1024,
    the flash kernels at T >= 1024 on CUDA); ``use_linear`` takes the plain
    ``linear_attention``, as JAX computes it with stock XLA."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 64,
                 use_linear: bool = False, *,
                 device: DeviceArg = None):
        super().__init__()
        device = resolve_device(device)
        self.dim = dim
        self.heads = heads
        self.inner_dim = dim_head * heads
        self.use_linear = use_linear
        self.norm = GroupNorm(max(1, math.gcd(dim, 32)), dim, device=device)
        self.qkv = Conv(1, dim, self.inner_dim * 3, kernel_size=1, padding=0, device=device)
        self.proj_out = Conv(1, self.inner_dim, dim, kernel_size=1, padding=0, zero_init=True,
                             device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        spatial = x.shape[2:]
        x_flat = x.reshape(b, c, -1)  # (b, c, T)
        qkv = self.qkv(self.norm(x_flat))  # (b, 3*inner, T)
        q, k, v = _split_heads(qkv, self.heads).chunk(3, dim=-1)
        h = linear_attention(q, k, v) if self.use_linear else sdpa(q, k, v)
        return (x_flat + self.proj_out(h.reshape(b, self.inner_dim, -1))).reshape(b, c, *spatial)


class SpatialCrossAttention(nn.Module):
    """x attends to a flattened context. Params: norm, context_norm, q_proj,
    kv_proj, proj_out (Conv1d each, the last zero-initialized).

    The context is (b, context_dim, S) or (b, S, context_dim), or (b,
    context_dim, *spatial) flattened. The head splits are the reference's raw
    reshapes. Softmax attention goes through ``sdpa``: a query shorter than
    1024 tokens against another length takes its plain route, ``sdpa_xla``,
    as in JAX."""

    def __init__(self, dim: int, context_dim: int, heads: int = 4, dim_head: int = 64,
                 use_linear: bool = False, *, device: DeviceArg = None):
        super().__init__()
        device = resolve_device(device)
        self.dim = dim
        self.context_dim = context_dim
        self.heads = heads
        self.inner_dim = dim_head * heads
        self.use_linear = use_linear
        self.norm = GroupNorm(max(1, math.gcd(dim, 32)), dim, device=device)
        self.context_norm = GroupNorm(max(1, math.gcd(context_dim, 32)), context_dim,
                                      device=device)
        self.q_proj = Conv(1, dim, self.inner_dim, kernel_size=1, padding=0, device=device)
        self.kv_proj = Conv(1, context_dim, self.inner_dim * 2, kernel_size=1, padding=0,
                            device=device)
        self.proj_out = Conv(1, self.inner_dim, dim, kernel_size=1, padding=0, zero_init=True,
                             device=device)

    def _context_flat(self, context: Optional[torch.Tensor]) -> torch.Tensor:
        if context is None:
            raise ValueError("SpatialCrossAttention requires a non-empty context tensor.")
        if context.dim() == 3:
            if context.shape[1] == self.context_dim:
                return context
            if context.shape[-1] == self.context_dim:
                return context.transpose(1, 2)
        elif context.shape[1] == self.context_dim:
            return context.reshape(context.shape[0], self.context_dim, -1)
        raise ValueError(f"Context channels mismatch: expected {self.context_dim}, "
                         f"got {tuple(context.shape)}.")

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = self._context_flat(context)
        b, c = x.shape[:2]
        spatial = x.shape[2:]
        x_flat = x.reshape(b, c, -1)
        q = _split_heads(self.q_proj(self.norm(x_flat)), self.heads)
        k, v = _split_heads(self.kv_proj(self.context_norm(ctx)), self.heads).chunk(2, dim=-1)
        h = linear_attention(q, k, v) if self.use_linear else sdpa(q, k, v)
        return (x_flat + self.proj_out(h.reshape(b, self.inner_dim, -1))).reshape(b, c, *spatial)


class _ToOut(nn.Module):
    """The reference's ModuleList([Linear, Dropout]) under ``to_out``."""

    def __init__(self, channels: int, dropout: float, *, device: DeviceArg = None):
        super().__init__()
        self.add_module("0", Linear(channels, channels, device=device))
        self.dropout_rate = dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._modules["0"](x)
        return F.dropout(x, self.dropout_rate, training=self.training)


class DiffusersAttentionND(nn.Module):
    """Diffusers-style attention with to_q/to_k/to_v/to_out naming."""

    def __init__(
        self,
        channels: int,
        heads: int = 1,
        context_dim: Optional[int] = None,
        norm_num_groups: int = 32,
        eps: float = 1e-5,
        dropout: float = 0.0,
        *,
        device: DeviceArg = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.channels = channels
        self.heads = max(1, heads)
        self.head_dim = channels // self.heads
        self.context_dim = int(context_dim) if context_dim is not None else None
        self.group_norm = GroupNorm(max(1, math.gcd(channels, norm_num_groups)), channels,
                                    eps=eps, device=device)
        self.to_q = Linear(channels, channels, device=device)
        if self.context_dim is None:
            self.to_k = Linear(channels, channels, device=device)
            self.to_v = Linear(channels, channels, device=device)
        else:
            self.context_norm = GroupNorm(max(1, math.gcd(self.context_dim, norm_num_groups)),
                                          self.context_dim, eps=eps, device=device)
            self.to_k = Linear(self.context_dim, channels, device=device)
            self.to_v = Linear(self.context_dim, channels, device=device)
        self.to_out = _ToOut(channels, dropout, device=device)

    def _context_tokens(self, context: Optional[torch.Tensor]) -> torch.Tensor:
        if context is None:
            raise ValueError("DiffusersAttentionND cross-attention requires a non-empty context tensor.")
        if context.dim() == 3:
            if context.shape[1] == self.context_dim:
                ctx = context
            elif context.shape[-1] == self.context_dim:
                ctx = context.transpose(1, 2)
            else:
                raise ValueError(
                    f"Context channels mismatch: expected {self.context_dim}, got {tuple(context.shape)}.")
        else:
            if context.shape[1] != self.context_dim:
                raise ValueError(
                    f"Context channels mismatch: expected {self.context_dim}, got {tuple(context.shape)}.")
            ctx = context.reshape(context.shape[0], context.shape[1], -1)
        return self.context_norm(ctx).transpose(1, 2)

    def forward(self, hidden_states: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, c = hidden_states.shape[:2]
        spatial = hidden_states.shape[2:]
        x = self.group_norm(hidden_states.reshape(b, c, -1)).transpose(1, 2)  # (B, T, C)
        kv_source = x if self.context_dim is None else self._context_tokens(context)

        def split_heads(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(b, -1, self.heads, self.head_dim).transpose(1, 2)

        out = sdpa(split_heads(self.to_q(x)), split_heads(self.to_k(kv_source)),
                   split_heads(self.to_v(kv_source)))
        out = self.to_out(out.transpose(1, 2).reshape(b, -1, c))
        # back to channels-first, contiguous: the next block's kernels take
        # contiguous (N, C, *spatial) tensors only
        return out.transpose(1, 2).reshape(b, c, *spatial).contiguous() + hidden_states


class UpsampleND(nn.Module):
    """Nearest x2 upsample + optional 3x3 conv. Params: conv.conv.*"""

    def __init__(self, spatial_dims: int, channels: int, use_conv: bool = True, *,
                 device: DeviceArg = None):
        super().__init__()
        self.use_conv = use_conv
        if use_conv:
            self.conv = ConvND(spatial_dims, channels, channels, kernel_size=3, padding=1,
                               device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = upsample_nearest(x, 2)
        return self.conv(x) if self.use_conv else x


class DownsampleND(nn.Module):
    """Stride-2 conv or 2x average-pool downsample. Params: op.conv.*"""

    def __init__(self, spatial_dims: int, channels: int, use_conv: bool = True, *,
                 device: DeviceArg = None):
        super().__init__()
        self.use_conv = use_conv
        if use_conv:
            self.op = ConvND(spatial_dims, channels, channels, kernel_size=3, stride=2, padding=1,
                             device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x) if self.use_conv else avg_pool_nd(x, 2, 2)


class PoolND(nn.Module):
    """Patchify: a conv with kernel = stride = ``pool_factor``. Params: down.conv.*"""

    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int, pool_factor=2, *,
                 device: DeviceArg = None):
        super().__init__()
        self.down = ConvND(spatial_dims, in_channels, out_channels, kernel_size=pool_factor,
                           stride=pool_factor, padding=0, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(x)


class UnPoolND(nn.Module):
    """Unpatchify: a transposed conv with kernel = stride = ``pool_factor``.
    Params: up.convT.*"""

    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int, pool_factor=2, *,
                 device: DeviceArg = None):
        super().__init__()
        self.up = ConvTransposeND(spatial_dims, in_channels, out_channels,
                                  kernel_size=pool_factor, stride=pool_factor, padding=0,
                                  device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.up(x)
