"""
Plain reference of the EfficientUNet (Imagen's U-Net as the LDCT configs
write it, here over volumes) at a config's ``model.unet`` block: a time MLP
of 4 x ``model_channels`` over an unflipped sinusoidal embedding; an input
conv; per level of ``channel_mult`` ``num_res_blocks`` FiLM ResBlocks,
linear self-attention after each at the ``attention_resolutions``
downsample factors, a stride-2 conv between levels; a middle of ResBlock,
softmax self-attention, ResBlock; per level ``num_res_blocks + 1`` ResBlocks
over [hidden, skip] with the same attentions, nearest x2 and a conv between
levels; GroupNorm, SiLU, conv. Covers the layouts the benchmark's
configurations use: no cross-attention, no pooling.
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.layers import (ConvND, Downsample, GroupNorm, Linear, ResBlock,
                                        SpatialSelfAttention, Upsample, safe_groups,
                                        timestep_embedding)
from benchmark.reference.ops import Ops


class Block(nn.Sequential):
    """Layers applied in turn; ResBlocks also take the time embedding."""

    def forward(self, x, emb):
        for layer in self:
            x = layer(x, emb) if isinstance(layer, ResBlock) else layer(x)
        return x


class UNet3D(nn.Module):
    def __init__(self, ops: Ops, unet: dict, in_channels: int, out_channels: int):
        super().__init__()
        dims = int(unet.get("spatial_dims", 2))
        mc = int(unet["model_channels"])
        mult = list(unet["channel_mult"])
        n_res = int(unet["num_res_blocks"])
        attn_at = set(unet.get("attention_resolutions", []))
        heads, dim_head = int(unet["num_heads"]), int(unet["dim_head"])
        linear = bool(unet.get("use_linear_attn", True))
        film = bool(unet.get("use_scale_shift_norm", True))
        emb = 4 * mc
        self.model_channels = mc
        self.time_embed = nn.Sequential(Linear(ops, mc, emb), nn.SiLU(), Linear(ops, emb, emb))

        def res(cin, cout):
            return ResBlock(ops, dims, cin, cout, emb, film=film, act_before_proj=False)

        def attn(ch, lin):
            return SpatialSelfAttention(ops, ch, heads, dim_head, lin)

        self.input_blocks = nn.ModuleList([Block(ConvND(ops, dims, in_channels, mc, 3))])
        chans, ch, ds = [mc], mc, 1
        for level, m in enumerate(mult):
            for _ in range(n_res):
                layers = [res(ch, m * mc)]
                ch = m * mc
                if ds in attn_at:
                    layers.append(attn(ch, linear))
                self.input_blocks.append(Block(*layers))
                chans.append(ch)
            if level != len(mult) - 1:
                self.input_blocks.append(Block(Downsample(ops, dims, ch)))
                chans.append(ch)
                ds *= 2
        self.middle_block = Block(res(ch, ch), attn(ch, False), res(ch, ch))
        self.output_blocks = nn.ModuleList()
        for level, m in list(enumerate(mult))[::-1]:
            for i in range(n_res + 1):
                layers = [res(ch + chans.pop(), mc * m)]
                ch = mc * m
                if ds in attn_at:
                    layers.append(attn(ch, linear))
                if level and i == n_res:
                    layers.append(Upsample(ops, dims, ch))
                    ds //= 2
                self.output_blocks.append(Block(*layers))
        self.out = nn.Sequential(GroupNorm(ops, safe_groups(ch, 32), ch), nn.SiLU(),
                                 ConvND(ops, dims, mc, out_channels, 3))

    def forward(self, x, t):
        t = t.reshape(-1).expand(x.shape[0])
        emb = self.time_embed(timestep_embedding(t, self.model_channels, flip_sin_to_cos=False))
        hs = []
        h = x
        for block in self.input_blocks:
            h = block(h, emb)
            hs.append(h)
        h = self.middle_block(h, emb)
        for block in self.output_blocks:
            h = block((h, hs.pop()), emb)
        norm, _, conv = self.out
        return conv(F.silu(norm(h)))


def build(ops: Ops, model_cfg: dict, in_channels: int, out_channels: int) -> nn.Module:
    return UNet3D(ops, model_cfg["unet"], in_channels, out_channels)
