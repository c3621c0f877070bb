"""
Diffusers-compatible UNet down/up/mid blocks (counterpart of
``fmdm_tpu/nn/unet_blocks.py:22-208``): resnets / attentions / downsamplers /
upsamplers ModuleLists, ResBlocks built with the diffusers-matching flags
(zero_init_last_conv=False, emb_activation_before_proj=True,
add_embedding_to_hidden=True), ``out_channels // attention_head_dim`` heads.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from fmdm_tpu_torch.device import DeviceArg, resolve_device
from fmdm_tpu_torch.nn.blocks import DiffusersAttentionND, DownsampleND, ResBlockND, UpsampleND


def _make_resblock(spatial_dims, in_ch, out_ch, temb, dropout, eps, groups, time_scale_shift,
                   device):
    return ResBlockND(
        spatial_dims=spatial_dims,
        channels=in_ch,
        emb_channels=temb,
        out_channels=out_ch,
        dropout=dropout,
        use_conv=False,
        use_scale_shift_norm=(time_scale_shift == "scale_shift"),
        norm_type="gn",
        norm_groups=groups,
        norm_eps=eps,
        zero_init_last_conv=False,
        emb_activation_before_proj=True,
        add_embedding_to_hidden=True,
        device=device,
    )


def _make_attention(channels, attention_head_dim, cross_attention_dim, eps, groups, device):
    return DiffusersAttentionND(
        channels, heads=max(1, channels // max(attention_head_dim, 1)),
        context_dim=cross_attention_dim, eps=eps, norm_num_groups=groups, device=device,
    )


class DownBlock2DCompat(nn.Module):
    def __init__(
        self,
        spatial_dims: int,
        num_layers: int,
        in_channels: int,
        out_channels: int,
        temb_channels: int,
        add_downsample: bool,
        eps: float,
        groups: int,
        dropout: float,
        time_scale_shift: str,
        with_attention: bool = False,
        attention_head_dim: int = 8,
        cross_attention_dim: Optional[int] = None,
        *,
        device: DeviceArg = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.with_attention = with_attention
        self.add_downsample = add_downsample
        self.resnets = nn.ModuleList()
        if with_attention:
            self.attentions = nn.ModuleList()
        ch = in_channels
        for _ in range(num_layers):
            self.resnets.append(_make_resblock(spatial_dims, ch, out_channels, temb_channels,
                                               dropout, eps, groups, time_scale_shift, device))
            if with_attention:
                self.attentions.append(_make_attention(out_channels, attention_head_dim,
                                                       cross_attention_dim, eps, groups, device))
            ch = out_channels
        if add_downsample:
            self.downsamplers = nn.ModuleList([DownsampleND(spatial_dims, out_channels,
                                                            use_conv=True, device=device)])

    def forward(self, hidden_states: torch.Tensor, temb: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        output_states = ()
        for idx, resnet in enumerate(self.resnets):
            hidden_states = resnet(hidden_states, temb)
            if self.with_attention:
                hidden_states = self.attentions[idx](hidden_states, context=context)
            output_states = output_states + (hidden_states,)
        if self.add_downsample:
            hidden_states = self.downsamplers[0](hidden_states)
            output_states = output_states + (hidden_states,)
        return hidden_states, output_states


class UpBlock2DCompat(nn.Module):
    def __init__(
        self,
        spatial_dims: int,
        num_layers: int,
        in_channels: int,
        out_channels: int,
        prev_output_channel: int,
        temb_channels: int,
        add_upsample: bool,
        eps: float,
        groups: int,
        dropout: float,
        time_scale_shift: str,
        with_attention: bool = False,
        attention_head_dim: int = 8,
        cross_attention_dim: Optional[int] = None,
        *,
        device: DeviceArg = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.with_attention = with_attention
        self.add_upsample = add_upsample
        self.resnets = nn.ModuleList()
        if with_attention:
            self.attentions = nn.ModuleList()
        for i in range(num_layers):
            res_skip_channels = in_channels if i == num_layers - 1 else out_channels
            resnet_in_channels = prev_output_channel if i == 0 else out_channels
            self.resnets.append(_make_resblock(
                spatial_dims, resnet_in_channels + res_skip_channels, out_channels,
                temb_channels, dropout, eps, groups, time_scale_shift, device))
            if with_attention:
                self.attentions.append(_make_attention(out_channels, attention_head_dim,
                                                       cross_attention_dim, eps, groups, device))
        if add_upsample:
            self.upsamplers = nn.ModuleList([UpsampleND(spatial_dims, out_channels,
                                                        use_conv=True, device=device)])

    def forward(self, hidden_states: torch.Tensor, res_hidden_states_tuple, temb: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        for idx, resnet in enumerate(self.resnets):
            res_hidden_states = res_hidden_states_tuple[-1]
            res_hidden_states_tuple = res_hidden_states_tuple[:-1]
            # [hidden, skip] order; the ResBlock concatenates the parts
            hidden_states = resnet((hidden_states, res_hidden_states), temb)
            if self.with_attention:
                hidden_states = self.attentions[idx](hidden_states, context=context)
        if self.add_upsample:
            hidden_states = self.upsamplers[0](hidden_states)
        return hidden_states


class UNetMidBlock2DCompat(nn.Module):
    def __init__(
        self,
        spatial_dims: int,
        in_channels: int,
        temb_channels: int,
        eps: float,
        groups: int,
        dropout: float,
        time_scale_shift: str,
        add_attention: bool = True,
        attention_head_dim: int = 8,
        cross_attention_dim: Optional[int] = None,
        *,
        device: DeviceArg = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.add_attention = add_attention
        self.resnets = nn.ModuleList([
            _make_resblock(spatial_dims, in_channels, in_channels, temb_channels, dropout, eps,
                           groups, time_scale_shift, device)
            for _ in range(2)
        ])
        if add_attention:
            self.attentions = nn.ModuleList([_make_attention(
                in_channels, attention_head_dim, cross_attention_dim, eps, groups, device)])

    def forward(self, hidden_states: torch.Tensor, temb: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        hidden_states = self.resnets[0](hidden_states, temb)
        if self.add_attention:
            hidden_states = self.attentions[0](hidden_states, context=context)
        return self.resnets[1](hidden_states, temb)
