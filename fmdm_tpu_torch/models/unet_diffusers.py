"""
UNetDiffusersND — diffusers-``UNet2DModel``-compatible ND UNet (counterpart of
``fmdm_tpu/models/unet_diffusers.py:25-255``): conv_in (bare conv), the
TimestepEmbedding MLP (linear_1/linear_2), down/mid/up compat blocks chosen by
their type strings, center_input_sample, positional time embedding with
flip_sin_to_cos/freq_shift, the diffusers skip bookkeeping, the
GN -> SiLU -> conv_out head, and the DeepCache split (``cache_depth``,
``return_deep_feature``, ``deep_cache``; ``forward``'s docstring).
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
    ):
        """The full forward, or one side of the DeepCache split (the deep
        levels' output changes slowly across adjacent denoising steps, so it
        can be cached while the shallow high-resolution levels are
        recomputed):

        - ``return_deep_feature=True`` with ``cache_depth=D``: the full
          forward and the feature entering up block ``n_up - D``, returned
          as ``(out, feature)``;
        - ``deep_cache=<that feature>`` with ``cache_depth=D``: only
          ``conv_in``, down blocks ``0..D-1`` and up blocks ``n_up-D..``,
          the cached feature spliced in place of the skipped deep levels.

        With a feature captured at the same (x, t) the spliced forward
        reproduces the full forward."""
        n_up = len(self.up_blocks)
        shallow_only = deep_cache is not None
        if (shallow_only or return_deep_feature) and not (
                cache_depth is not None and 1 <= cache_depth < n_up):
            raise ValueError(f"cache_depth must be in [1, {n_up - 1}]")
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
        for block in self.down_blocks[:cache_depth] if shallow_only else self.down_blocks:
            sample, res_samples = block(sample, emb, context=context_ca)
            down_block_res_samples += res_samples

        deep_feature = None
        first_up = 0
        if shallow_only:
            # skip the deep down blocks, the mid block and the deep up
            # blocks; keep only the skips the shallow up blocks pop (the
            # deepest shallow down block's downsampler feeds a skipped one)
            sample = deep_cache
            first_up = n_up - cache_depth
            needed = sum(len(self.up_blocks[i].resnets) for i in range(first_up, n_up))
            down_block_res_samples = down_block_res_samples[:needed]
        elif self.has_mid:
            sample = self.mid_block(sample, emb, context=context_ca)
        for i in range(first_up, n_up):
            if return_deep_feature and not shallow_only and i == n_up - cache_depth:
                deep_feature = sample
            up_block = self.up_blocks[i]
            n_res = len(up_block.resnets)
            res_samples = down_block_res_samples[-n_res:]
            down_block_res_samples = down_block_res_samples[:-n_res]
            sample = up_block(sample, res_samples, emb, context=context_ca)

        sample = F.silu(self.conv_norm_out(sample))
        sample = self.conv_out(sample)
        if return_deep_feature:
            return sample, deep_feature
        return sample
