"""
UNetDiffusersND — diffusers-``UNet2DModel``-compatible ND UNet (counterpart of
``fmdm_tpu/models/unet_diffusers.py:25-255``): conv_in (bare conv), the
TimestepEmbedding MLP (linear_1/linear_2), down/mid/up compat blocks chosen by
their type strings, center_input_sample, positional time embedding with
flip_sin_to_cos/freq_shift, the diffusers skip bookkeeping, and the
GN -> SiLU -> conv_out head.

The DeepCache split of the JAX model (``deep_cache``, ``cache_depth``,
``return_deep_feature``) is not ported: passing it raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from fmdm_tpu_torch.device import DeviceArg, resolve_device
from fmdm_tpu_torch.nn.layers import Conv, Linear, make_group_norm
from fmdm_tpu_torch.nn.unet_blocks import DownBlock2DCompat, UNetMidBlock2DCompat, UpBlock2DCompat
from fmdm_tpu_torch.ops.time_embed import timestep_embedding


class TimestepEmbedding(nn.Module):
    """Two-layer timestep MLP."""

    def __init__(self, in_channels: int, out_channels: int, *, device: DeviceArg = None):
        super().__init__()
        self.linear_1 = Linear(in_channels, out_channels, device=device)
        self.linear_2 = Linear(out_channels, out_channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


def normalize_timesteps(t, batch: int, device: torch.device) -> torch.Tensor:
    """Scalar/0-d/1-d timesteps -> (B,) on ``device``."""
    t = torch.as_tensor(t, device=device)
    if t.dim() == 0:
        t = t[None]
    return t.expand(batch)


class UNetDiffusersND(nn.Module):
    def __init__(
        self,
        spatial_dims: int = 2,
        sample_size=None,
        in_channels: int = 3,
        out_channels: int = 3,
        center_input_sample: bool = False,
        time_embedding_type: str = "positional",
        freq_shift: int = 0,
        flip_sin_to_cos: bool = True,
        down_block_types: Sequence[str] = ("DownBlock2D", "AttnDownBlock2D", "AttnDownBlock2D", "AttnDownBlock2D"),
        mid_block_type: Optional[str] = "UNetMidBlock2D",
        up_block_types: Sequence[str] = ("AttnUpBlock2D", "AttnUpBlock2D", "AttnUpBlock2D", "UpBlock2D"),
        block_out_channels: Sequence[int] = (224, 448, 672, 896),
        layers_per_block: int = 2,
        downsample_padding: int = 1,
        dropout: float = 0.0,
        attention_head_dim: int = 8,
        norm_num_groups: int = 32,
        norm_eps: float = 1e-5,
        resnet_time_scale_shift: str = "default",
        add_attention: bool = True,
        cross_attention_dim: Optional[int] = None,
        *,
        device: DeviceArg = None,
        **_kwargs,
    ):
        super().__init__()
        device = resolve_device(device)
        if time_embedding_type != "positional":
            raise ValueError("UNetDiffusersND currently supports positional time embedding only for strict compat.")
        self.center_input_sample = center_input_sample
        self.sample_size = sample_size
        self.flip_sin_to_cos = flip_sin_to_cos
        self.freq_shift = freq_shift
        self.block_out_channels = tuple(block_out_channels)
        self.cross_attention_dim = int(cross_attention_dim) if cross_attention_dim is not None else None
        self.has_mid = mid_block_type is not None
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.spatial_dims = spatial_dims

        time_embed_dim = self.block_out_channels[0] * 4
        self.time_proj_dim = self.block_out_channels[0]
        self.conv_in = Conv(spatial_dims, in_channels, self.block_out_channels[0], kernel_size=3,
                            padding=1, device=device)
        self.time_embedding = TimestepEmbedding(self.time_proj_dim, time_embed_dim, device=device)

        common = dict(spatial_dims=spatial_dims, temb_channels=time_embed_dim, eps=norm_eps,
                      groups=norm_num_groups, dropout=dropout,
                      time_scale_shift=resnet_time_scale_shift,
                      attention_head_dim=attention_head_dim, device=device)

        self.down_blocks = nn.ModuleList()
        output_channel = self.block_out_channels[0]
        for i, down_block_type in enumerate(down_block_types):
            input_channel = output_channel
            output_channel = self.block_out_channels[i]
            if down_block_type not in {"DownBlock2D", "AttnDownBlock2D", "CrossAttnDownBlock2D"}:
                raise ValueError(f"Unsupported down block type in compat model: {down_block_type}")
            self.down_blocks.append(DownBlock2DCompat(
                num_layers=layers_per_block,
                in_channels=input_channel,
                out_channels=output_channel,
                add_downsample=i != len(self.block_out_channels) - 1,
                with_attention=down_block_type in {"AttnDownBlock2D", "CrossAttnDownBlock2D"},
                cross_attention_dim=self.cross_attention_dim if down_block_type == "CrossAttnDownBlock2D" else None,
                **common,
            ))

        if self.has_mid:
            self.mid_block = UNetMidBlock2DCompat(
                in_channels=self.block_out_channels[-1],
                add_attention=add_attention,
                cross_attention_dim=self.cross_attention_dim if mid_block_type == "UNetMidBlock2DCrossAttn" else None,
                **common,
            )

        self.up_blocks = nn.ModuleList()
        reversed_channels = list(reversed(self.block_out_channels))
        output_channel = reversed_channels[0]
        for i, up_block_type in enumerate(up_block_types):
            prev_output_channel = output_channel
            output_channel = reversed_channels[i]
            input_channel = reversed_channels[min(i + 1, len(self.block_out_channels) - 1)]
            if up_block_type not in {"UpBlock2D", "AttnUpBlock2D", "CrossAttnUpBlock2D"}:
                raise ValueError(f"Unsupported up block type in compat model: {up_block_type}")
            self.up_blocks.append(UpBlock2DCompat(
                num_layers=layers_per_block + 1,
                in_channels=input_channel,
                out_channels=output_channel,
                prev_output_channel=prev_output_channel,
                add_upsample=i != len(self.block_out_channels) - 1,
                with_attention=up_block_type in {"AttnUpBlock2D", "CrossAttnUpBlock2D"},
                cross_attention_dim=self.cross_attention_dim if up_block_type == "CrossAttnUpBlock2D" else None,
                **common,
            ))

        self.conv_norm_out = make_group_norm(self.block_out_channels[0], groups=norm_num_groups,
                                             eps=norm_eps, device=device)
        self.conv_out = Conv(spatial_dims, self.block_out_channels[0], out_channels, kernel_size=3,
                             padding=1, device=device)

    def forward(
        self,
        x: torch.Tensor,
        t,
        context: Optional[torch.Tensor] = None,
        context_ca: Optional[torch.Tensor] = None,
        deep_cache: Optional[torch.Tensor] = None,
        cache_depth: Optional[int] = None,
        return_deep_feature: bool = False,
    ) -> torch.Tensor:
        if deep_cache is not None or cache_depth is not None or return_deep_feature:
            raise NotImplementedError("UNetDiffusersND: the DeepCache split is not ported yet")
        if context is not None:
            x = torch.cat([x, context], dim=1)
        if self.center_input_sample:
            x = 2 * x - 1.0

        t = normalize_timesteps(t, x.shape[0], x.device)
        t_emb = timestep_embedding(
            t, self.time_proj_dim, max_period=10000,
            flip_sin_to_cos=self.flip_sin_to_cos, freq_shift=self.freq_shift,
        ).to(x.dtype)
        emb = self.time_embedding(t_emb)

        sample = self.conv_in(x)
        down_block_res_samples = (sample,)
        for block in self.down_blocks:
            sample, res_samples = block(sample, emb, context=context_ca)
            down_block_res_samples += res_samples

        if self.has_mid:
            sample = self.mid_block(sample, emb, context=context_ca)
        for up_block in self.up_blocks:
            n_res = len(up_block.resnets)
            res_samples = down_block_res_samples[-n_res:]
            down_block_res_samples = down_block_res_samples[:-n_res]
            sample = up_block(sample, res_samples, emb, context=context_ca)

        sample = F.silu(self.conv_norm_out(sample))
        return self.conv_out(sample)
