"""
Plain reference of the diffusers-layout UNet (``UNet2DModel``: DDPM's
architecture) at a config's ``model.unet`` block: conv_in; a two-layer time
MLP over a flipped sinusoidal embedding of ``block_out_channels[0]``
features; per level ``layers_per_block`` ResBlocks (time embedding added
after a SiLU), self-attention after each in ``AttnDownBlock2D`` levels, a
stride-2 conv between levels; a middle of ResBlock, attention, ResBlock;
per level ``layers_per_block + 1`` ResBlocks over [hidden, skip], attention
in ``AttnUpBlock2D`` levels, nearest x2 and a conv between levels;
GroupNorm, SiLU, conv_out. Heads of ``attention_head_dim`` features.
Covers the layouts the benchmark's configurations use: no cross-attention,
no DeepCache split, ``resnet_time_scale_shift`` "default".
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.layers import (ConvND, Conv, DiffusersAttention, Downsample, GroupNorm,
                                        Linear, ResBlock, Upsample, safe_groups,
                                        timestep_embedding)
from benchmark.reference.ops import Ops


class TimeMLP(nn.Module):
    def __init__(self, ops: Ops, cin: int, cout: int):
        super().__init__()
        self.linear_1 = Linear(ops, cin, cout)
        self.linear_2 = Linear(ops, cout, cout)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class Level(nn.Module):
    """A down or up level: ``resnets``, ``attentions``, and ``downsamplers`` /
    ``upsamplers``."""

    def __init__(self, resnets, attentions, resample_name=None, resample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        self.has_attention = bool(attentions)
        self.resample_name = resample_name
        if resample is not None:
            setattr(self, resample_name, nn.ModuleList([resample]))

    def resample(self, x):
        if self.resample_name is None:
            return x
        return getattr(self, self.resample_name)[0](x)


class UNet2D(nn.Module):
    def __init__(self, ops: Ops, unet: dict, in_channels: int, out_channels: int):
        super().__init__()
        widths = list(unet["block_out_channels"])
        layers = int(unet.get("layers_per_block", 2))
        head_dim = int(unet.get("attention_head_dim", 8))
        groups, eps = int(unet.get("norm_num_groups", 32)), float(unet.get("norm_eps", 1e-5))
        dims = int(unet.get("spatial_dims", 2))
        emb = 4 * widths[0]
        self.time_dim = widths[0]
        self.conv_in = Conv(ops, dims, in_channels, widths[0], 3)
        self.time_embedding = TimeMLP(ops, widths[0], emb)

        def res(cin, cout):
            return ResBlock(ops, dims, cin, cout, emb, film=False, act_before_proj=True,
                            groups=groups, eps=eps)

        def attn(ch):
            return DiffusersAttention(ops, ch, max(1, ch // head_dim), groups, eps)

        self.down_blocks = nn.ModuleList()
        ch = widths[0]
        for i, kind in enumerate(unet["down_block_types"]):
            cin, ch = ch, widths[i]
            with_attn = kind == "AttnDownBlock2D"
            last = i == len(widths) - 1
            self.down_blocks.append(Level(
                [res(cin if j == 0 else ch, ch) for j in range(layers)],
                [attn(ch) for _ in range(layers)] if with_attn else [],
                None if last else "downsamplers", None if last else Downsample(ops, dims, ch)))
        top = widths[-1]
        self.mid_block = Level([res(top, top), res(top, top)], [attn(top)])
        self.up_blocks = nn.ModuleList()
        rev = widths[::-1]
        out_ch = rev[0]
        for i, kind in enumerate(unet["up_block_types"]):
            prev, out_ch = out_ch, rev[i]
            skip_in = rev[min(i + 1, len(widths) - 1)]
            with_attn = kind == "AttnUpBlock2D"
            last = i == len(widths) - 1
            self.up_blocks.append(Level(
                [res((prev if j == 0 else out_ch) + (skip_in if j == layers else out_ch), out_ch)
                 for j in range(layers + 1)],
                [attn(out_ch) for _ in range(layers + 1)] if with_attn else [],
                None if last else "upsamplers", None if last else Upsample(ops, dims, out_ch)))
        self.conv_norm_out = GroupNorm(ops, safe_groups(widths[0], groups), widths[0], eps)
        self.conv_out = Conv(ops, dims, widths[0], out_channels, 3)

    def forward(self, x, t):
        t = t.reshape(-1).expand(x.shape[0])
        emb = self.time_embedding(timestep_embedding(t, self.time_dim, flip_sin_to_cos=True))
        h = self.conv_in(x)
        skips = [h]
        for level in self.down_blocks:
            for j, resnet in enumerate(level.resnets):
                h = resnet(h, emb)
                if level.has_attention:
                    h = level.attentions[j](h)
                skips.append(h)
            if level.resample_name is not None:
                h = level.resample(h)
                skips.append(h)
        h = self.mid_block.resnets[0](h, emb)
        h = self.mid_block.attentions[0](h)
        h = self.mid_block.resnets[1](h, emb)
        for level in self.up_blocks:
            for j, resnet in enumerate(level.resnets):
                h = resnet((h, skips.pop()), emb)
                if level.has_attention:
                    h = level.attentions[j](h)
            h = level.resample(h)
        return self.conv_out(self.conv_norm_out(h, act=True))


def build(ops: Ops, model_cfg: dict, in_channels: int, out_channels: int) -> nn.Module:
    return UNet2D(ops, model_cfg["unet"], in_channels, out_channels)
