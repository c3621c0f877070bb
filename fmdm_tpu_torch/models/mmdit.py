"""
Stable Diffusion 3's rectified-flow transformer, MMDiT (Esser et al.,
"Scaling Rectified Flow Transformers for High-Resolution Image Synthesis",
arXiv 2403.03206), with SD3.5's MMDiT-X blocks: diffusers'
``SD3Transformer2DModel`` with its ``state_dict`` names and its
``transformer/config.json`` keys, so that a published checkpoint loads.

Forward on a latent z (B, C, H, W), timesteps t (B,) and the text
conditioning ``context_ca = (tokens (B, S, joint_attention_dim), pooled (B,
pooled_projection_dim))``:

    x    = PatchEmbed(z)                       (B, HW / p², D), D = heads x head_dim
    temb = MLP_t(sinusoid_256(t)) + MLP_p(pooled)
    c    = Linear(tokens)                      (B, S, D)
    x, c = block_i(x, c, temb)                 i = 0 .. num_layers - 1
    y    = Linear(LN(x) (1 + scale) + shift)   (scale, shift) = Linear(SiLU(temb))
    out  = unpatchify(y)                       (B, C_out, H, W)

Block i is a dual (MMDiT-X) block for i in ``dual_attention_layers`` and
the last block drops the text stream (``nn/transformer_blocks.py``). t is
taken as the model's timestep as it is: a flow-matching trainer or sampler
hands it 1000 sigma. The weights are f32 and every product runs in the
input's dtype (bf16 on the card's train path).

Departures from diffusers: the RMSNorm of q and k returns the input's dtype;
no ``joint_attention_kwargs``, skip layers, ControlNet residuals or IP
adapters; the layers' initial values are torch's defaults (adaLN and the
output projection are not zeroed), since the port's runs start from drawn
or loaded weights.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from fmdm_tpu_torch.device import DeviceArg, resolve_device
from fmdm_tpu_torch.nn.layers import Linear
from fmdm_tpu_torch.nn.transformer_blocks import (AdaLayerNormContinuous,
                                                  CombinedTimestepTextProjEmbeddings,
                                                  JointTransformerBlock, PatchEmbed, unpatchify)

__all__ = ["SD3Transformer2DModel"]


class SD3Transformer2DModel(nn.Module):
    """The MMDiT of ``transformer/config.json``'s keys (see the module's
    docstring), with SD3.5's RMS-normed queries and keys (SD3's plain ones
    are not ported)."""

    def __init__(self, *, sample_size: int = 128, patch_size: int = 2, in_channels: int = 16,
                 num_layers: int = 24, attention_head_dim: int = 64,
                 num_attention_heads: int = 24, joint_attention_dim: int = 4096,
                 caption_projection_dim: int = 1536, pooled_projection_dim: int = 2048,
                 out_channels: Optional[int] = None, pos_embed_max_size: int = 384,
                 dual_attention_layers: Sequence[int] = (), device: DeviceArg = None):
        super().__init__()
        device = resolve_device(device)
        dim = num_attention_heads * attention_head_dim
        if caption_projection_dim != dim:
            raise ValueError(f"caption_projection_dim {caption_projection_dim} must equal "
                             f"num_attention_heads x attention_head_dim = {dim}")
        self.patch_size = patch_size
        self.out_channels = out_channels or in_channels
        self.pos_embed = PatchEmbed(in_channels, dim, patch_size, pos_embed_max_size,
                                    base_size=sample_size // patch_size, device=device)
        self.time_text_embed = CombinedTimestepTextProjEmbeddings(dim, pooled_projection_dim,
                                                                  device=device)
        self.context_embedder = Linear(joint_attention_dim, caption_projection_dim,
                                       device=device)
        dual = set(int(i) for i in dual_attention_layers)
        self.transformer_blocks = nn.ModuleList([
            JointTransformerBlock(dim, num_attention_heads, attention_head_dim, dual=i in dual,
                                  context_last=i == num_layers - 1, device=device)
            for i in range(num_layers)])
        self.norm_out = AdaLayerNormContinuous(dim, device=device)
        self.proj_out = Linear(dim, patch_size * patch_size * self.out_channels, device=device)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context_ca: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        if context_ca is None:
            raise ValueError("the MMDiT needs its text conditioning: context_ca=(tokens, pooled)")
        tokens, pooled = context_ca
        h, w = x.shape[-2] // self.patch_size, x.shape[-1] // self.patch_size
        t = torch.as_tensor(t, device=x.device).reshape(-1).expand(x.shape[0])
        hidden = self.pos_embed(x)
        temb = self.time_text_embed(t, pooled.to(x.dtype))
        context = self.context_embedder(tokens.to(x.dtype))
        for block in self.transformer_blocks:
            hidden, context = block(hidden, context, temb)
        hidden = self.proj_out(self.norm_out(hidden, temb))
        return unpatchify(hidden, h, w, self.patch_size, self.out_channels)

