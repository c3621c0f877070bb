"""
EfficientUNetND — the ND UNet with optional linear attention,
cross-attention and input patchify pooling (counterpart of
``fmdm_tpu/models/unet_efficient.py:36-220``).

``TimestepEmbedSequential`` routes ``emb`` to the ``ResBlockND`` children and
``context`` to the ``SpatialCrossAttention`` children. The time MLP of
4 x model_channels is ``time_embed.0``/``time_embed.2``; the encoder has
``num_res_blocks`` levels per ``channel_mult`` entry with self-attention at the
``attention_resolutions`` downsample factors; the middle is ResBlock,
softmax self-attention (never linear), optional cross-attention, ResBlock;
the decoder concatenates a skip before each block's first ResBlock; the head
``out`` is GroupNorm, SiLU and a zero-initialized conv (or a conv and the
``unpool`` transposed conv when ``pool_factor`` > 1).

Every ResBlock's two GroupNorm+SiLU go through kernel K1 on CUDA (FiLM on
``norm2`` under ``use_scale_shift_norm``), and the middle self-attention
through ``sdpa`` (K2 at T < 1024). The head's GroupNorm and SiLU stay plain,
as the flagship's ``conv_norm_out`` does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from fmdm_tpu_torch.device import DeviceArg, resolve_device
from fmdm_tpu_torch.models.unet_diffusers import normalize_timesteps
from fmdm_tpu_torch.nn.blocks import (
    DownsampleND,
    PoolND,
    ResBlockND,
    SpatialCrossAttention,
    SpatialSelfAttention,
    UnPoolND,
    UpsampleND,
)
from fmdm_tpu_torch.nn.layers import ConvND, Linear, make_group_norm
from fmdm_tpu_torch.ops.time_embed import timestep_embedding


class TimestepEmbedSequential(nn.Sequential):
    """Sequential that routes ``emb`` to ResBlockND children and ``context``
    to SpatialCrossAttention children."""

    def forward(self, x, emb=None, context=None):
        for layer in self:
            if isinstance(layer, ResBlockND):
                x = layer(x, emb)
            elif isinstance(layer, SpatialCrossAttention):
                x = layer(x, context)
            else:
                x = layer(x)
        return x


class EfficientUNetND(nn.Module):
    def __init__(
        self,
        spatial_dims: int,
        in_channels: int,
        model_channels: int,
        out_channels: int,
        num_res_blocks: int,
        attention_resolutions: Sequence[int],
        dropout: float = 0.0,
        channel_mult: Tuple[int, ...] = (1, 2, 3, 4),
        conv_resample: bool = True,
        dim_head: int = 64,
        num_heads: int = 4,
        use_linear_attn: bool = True,
        use_scale_shift_norm: bool = True,
        pool_factor: int = 1,
        cross_attention_resolutions: Optional[Sequence[int]] = None,
        cross_attention_dim: int = 4,
        cross_attention_in_middle: bool = False,
        emb_activation_before_proj: bool = False,
        *,
        device: DeviceArg = None,
    ):
        super().__init__()
        if spatial_dims not in (1, 2, 3):
            raise ValueError("spatial_dims must be 1, 2 or 3")
        device = resolve_device(device)
        self.spatial_dims = spatial_dims
        self.in_channels = in_channels
        self.model_channels = model_channels
        self.out_channels = out_channels
        self.attention_resolutions = tuple(attention_resolutions)
        self.cross_attention_resolutions = tuple(cross_attention_resolutions or ())
        self.cross_attention_in_middle = cross_attention_in_middle
        self.pool_factor = pool_factor

        time_embed_dim = model_channels * 4
        self.time_embed = nn.Sequential(
            Linear(model_channels, time_embed_dim, device=device),
            nn.SiLU(),
            Linear(time_embed_dim, time_embed_dim, device=device),
        )

        if pool_factor > 1:
            self.pool = PoolND(spatial_dims, in_channels, model_channels, pool_factor,
                               device=device)
            start_channels = model_channels
        else:
            self.pool = nn.Identity()
            start_channels = in_channels

        def resblock(ch, out_ch=None):
            return ResBlockND(channels=ch, emb_channels=time_embed_dim, dropout=dropout,
                              out_channels=out_ch, use_scale_shift_norm=use_scale_shift_norm,
                              spatial_dims=spatial_dims,
                              emb_activation_before_proj=emb_activation_before_proj,
                              device=device)

        def self_attn(ch, linear):
            return SpatialSelfAttention(ch, heads=num_heads, dim_head=dim_head, use_linear=linear,
                                        device=device)

        def cross_attn(ch, linear):
            return SpatialCrossAttention(ch, context_dim=cross_attention_dim, heads=num_heads,
                                         dim_head=dim_head, use_linear=linear, device=device)

        # --- encoder ---
        self.input_blocks = nn.ModuleList([TimestepEmbedSequential(
            ConvND(spatial_dims, start_channels, model_channels, 3, padding=1, device=device))])
        input_block_chans = [model_channels]
        ch = model_channels
        ds = 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [resblock(ch, mult * model_channels)]
                ch = mult * model_channels
                if ds in self.attention_resolutions:
                    layers.append(self_attn(ch, use_linear_attn))
                if ds in self.cross_attention_resolutions:
                    layers.append(cross_attn(ch, use_linear_attn))
                self.input_blocks.append(TimestepEmbedSequential(*layers))
                input_block_chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(TimestepEmbedSequential(
                    DownsampleND(spatial_dims, ch, use_conv=conv_resample, device=device)))
                input_block_chans.append(ch)
                ds *= 2

        # --- middle (its self-attention is never linear) ---
        middle_layers = [resblock(ch), self_attn(ch, False)]
        if cross_attention_in_middle or ds in self.cross_attention_resolutions:
            middle_layers.append(cross_attn(ch, False))
        middle_layers.append(resblock(ch))
        self.middle_block = TimestepEmbedSequential(*middle_layers)

        # --- decoder ---
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [resblock(ch + input_block_chans.pop(), model_channels * mult)]
                ch = model_channels * mult
                if ds in self.attention_resolutions:
                    layers.append(self_attn(ch, use_linear_attn))
                if ds in self.cross_attention_resolutions:
                    layers.append(cross_attn(ch, use_linear_attn))
                if level and i == num_res_blocks:
                    layers.append(UpsampleND(spatial_dims, ch, use_conv=conv_resample,
                                             device=device))
                    ds //= 2
                self.output_blocks.append(TimestepEmbedSequential(*layers))

        # --- output head ---
        pooled = pool_factor > 1
        self.out = nn.Sequential(
            make_group_norm(ch, groups=32, device=device),
            nn.SiLU(),
            ConvND(spatial_dims, model_channels, model_channels if pooled else out_channels, 3,
                   padding=1, zero_init=not pooled, device=device),
        )
        self.unpool = (UnPoolND(spatial_dims, model_channels, out_channels, pool_factor,
                                device=device) if pooled else nn.Identity())

    def forward(
        self,
        x: torch.Tensor,
        t,
        context: Optional[torch.Tensor] = None,
        context_ca: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if context_ca is not None and not (self.cross_attention_resolutions
                                           or self.cross_attention_in_middle):
            raise ValueError("context_ca provided but cross-attention is disabled.")
        if context is not None:
            x = torch.cat([x, context], dim=1)

        t = normalize_timesteps(t, x.shape[0], x.device)
        t_feat = timestep_embedding(t, self.model_channels, flip_sin_to_cos=False,
                                    freq_shift=0).to(x.dtype)
        emb = self.time_embed(t_feat)

        h = self.pool(x)
        hs = []
        for block in self.input_blocks:
            h = block(h, emb, context_ca)
            hs.append(h)
        h = self.middle_block(h, emb, context_ca)
        for block in self.output_blocks:
            # the leading ResBlockND concatenates (h, skip) and normalizes it
            h = block((h, hs.pop()), emb, context_ca)
        return self.unpool(self.out(h))
