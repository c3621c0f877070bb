"""
The blocks of a rectified-flow transformer (Stable Diffusion 3's MMDiT and
SD3.5's MMDiT-X; Esser et al., arXiv 2403.03206), named as diffusers names
them, so that one ``state_dict`` loads in both:

- :class:`PatchEmbed` (``pos_embed``): a stride-p convolution to the width,
  the tokens flattened row-major, plus the centre crop of a fixed 2-D sin-cos
  table of ``max_size`` x ``max_size`` positions (a persistent buffer,
  ``pos_embed.pos_embed``), and :func:`unpatchify`;
- :class:`CombinedTimestepTextProjEmbeddings` (``time_text_embed``):
  MLP(sinusoid_256(t)) + MLP(pooled text);
- :func:`modulate` and the adaptive norms: LayerNorm without affine (eps
  1e-6), ``LN(x) (1 + scale) + shift``; :class:`AdaLayerNormZero` (6 chunks:
  shift, scale, gate, shift, scale, gate), :class:`AdaLayerNormZeroX` (9: the
  same and a third shift, scale, gate for the second attention, on the same
  ``LN(x)``) and :class:`AdaLayerNormContinuous` (2 chunks, scale first);
- :class:`JointAttention`: q, k, v of each stream by its own linears, a
  learned RMSNorm over the head dim on q and k of each stream, one
  non-causal attention over the image tokens followed by the text tokens,
  the output split back, ``to_out`` for the image stream and ``to_add_out``
  for the text stream (absent where the text stream ends); without a second
  stream it is the image-only attention of MMDiT-X's dual blocks;
- :class:`FeedForward`: Linear, tanh-GELU, Linear (``net.0.proj``, ``net.2``).

Every linear is the port's ``Linear`` (the product in the input's dtype, f32
weights cast to it); the attention is ``ops/attention.py::sdpa``, so on the
card the flash kernels (K3 forward, K4 + K5 backward) take every call at
1024 tokens or more. LayerNorm is ``F.layer_norm`` (f32 statistics, one
rounding); RMSNorm computes in f32 and rounds once; a modulation and a gated
residual are one ``addcmul`` each, in the stream's dtype.
Departures from diffusers: the weights stay f32 and are cast per product
(diffusers casts the model); the RMSNorm's output takes the input's dtype
(diffusers' f32-weighted RMSNorm returns f32).

Spans (``utils/trace.py``): ``mmdit.adaln`` around each LayerNorm and its
modulation, ``mmdit.joint_attention`` around a joint attention from the
projections to the output projections, ``mmdit.self_attention`` around an
image-only attention.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from fmdm_tpu_torch.device import DeviceArg, resolve_device
from fmdm_tpu_torch.nn.layers import Conv, Linear
from fmdm_tpu_torch.ops.attention import sdpa
from fmdm_tpu_torch.ops.time_embed import timestep_embedding
from fmdm_tpu_torch.utils import trace

LN_EPS = 1e-6


def sincos_table_2d(dim: int, grid: int, base_size: int,
                    device: DeviceArg = "cpu") -> torch.Tensor:
    """diffusers' ``get_2d_sincos_pos_embed(dim, grid, base_size)`` (its
    ``interpolation_scale`` 1, as SD3 builds it) as (grid², dim) f32,
    row-major positions: the first half of the features encodes the column,
    the second the row, each as [sin, cos] of pos / 10000^(i / (dim / 4)),
    pos = index / (grid / base_size) in f32, the products in f64."""
    coords = torch.arange(grid, dtype=torch.float32, device=device) / (grid / base_size)
    rows, cols = torch.meshgrid(coords, coords, indexing="ij")
    omega = 1.0 / 10000 ** (torch.arange(dim // 4, dtype=torch.float64, device=device)
                            / (dim / 4.0))

    def one_axis(pos: torch.Tensor) -> torch.Tensor:
        out = pos.reshape(-1, 1).double() * omega
        return torch.cat([torch.sin(out), torch.cos(out)], dim=1)

    return torch.cat([one_axis(cols), one_axis(rows)], dim=1).float()


def crop_table(table: torch.Tensor, max_size: int, height: int, width: int) -> torch.Tensor:
    """The centre crop (top = (max_size - height) // 2, likewise left) of a
    (1, max_size², dim) table, as (1, height * width, dim)."""
    if height > max_size or width > max_size:
        raise ValueError(f"{height}x{width} patches exceed the table's {max_size}x{max_size}")
    top, left = (max_size - height) // 2, (max_size - width) // 2
    grid = table.reshape(1, max_size, max_size, -1)[:, top:top + height, left:left + width]
    return grid.reshape(1, height * width, -1)


class PatchEmbed(nn.Module):
    """(B, C, H, W) -> (B, HW / p², dim): the patch convolution (``proj``)
    plus the cropped position table (``pos_embed``), summed in f32 and
    rounded once to the input's dtype."""

    def __init__(self, in_channels: int, dim: int, patch_size: int, max_size: int,
                 base_size: int, *, device: DeviceArg = None):
        super().__init__()
        device = resolve_device(device)
        self.patch_size, self.max_size = patch_size, max_size
        self.proj = Conv(2, in_channels, dim, patch_size, stride=patch_size, padding=0,
                         device=device)
        if device.type == "meta":
            table = torch.empty((max_size * max_size, dim), device=device)
        else:
            table = sincos_table_2d(dim, max_size, base_size, device=device)
        self.register_buffer("pos_embed", table.unsqueeze(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2] // self.patch_size, x.shape[-1] // self.patch_size
        tokens = self.proj(x).flatten(2).transpose(1, 2)
        return (tokens + crop_table(self.pos_embed, self.max_size, h, w)).to(x.dtype)


def unpatchify(y: torch.Tensor, height: int, width: int, patch_size: int,
               channels: int) -> torch.Tensor:
    """(B, hw, p² C) tokens of (p, p, C) patches -> (B, C, h p, w p)."""
    b = y.shape[0]
    y = y.reshape(b, height, width, patch_size, patch_size, channels)
    return torch.einsum("nhwpqc->nchpwq", y).reshape(b, channels, height * patch_size,
                                                    width * patch_size)


class MLPEmbedding(nn.Module):
    """Linear, SiLU, Linear (diffusers' ``TimestepEmbedding`` and
    ``PixArtAlphaTextProjection`` alike)."""

    def __init__(self, in_features: int, dim: int, *, device: DeviceArg = None):
        super().__init__()
        self.linear_1 = Linear(in_features, dim, device=device)
        self.linear_2 = Linear(dim, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class CombinedTimestepTextProjEmbeddings(nn.Module):
    """temb = MLP_t(sinusoid_256(t)) + MLP_p(pooled): the sinusoid is
    diffusers' ``Timesteps(256, flip_sin_to_cos=True,
    downscale_freq_shift=0)`` in f32, cast to the pooled vector's dtype."""

    def __init__(self, dim: int, pooled_dim: int, freq_dim: int = 256, *,
                 device: DeviceArg = None):
        super().__init__()
        self.freq_dim = freq_dim
        self.timestep_embedder = MLPEmbedding(freq_dim, dim, device=device)
        self.text_embedder = MLPEmbedding(pooled_dim, dim, device=device)

    def forward(self, t: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
        freqs = timestep_embedding(t, self.freq_dim, flip_sin_to_cos=True, freq_shift=0)
        return self.timestep_embedder(freqs.to(pooled.dtype)) + self.text_embedder(pooled)


def modulate(normed: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """normed (1 + scale) + shift with (B, D) scale and shift."""
    return torch.addcmul(shift[:, None], normed, 1 + scale[:, None])


def layer_norm(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last dim, no affine, eps 1e-6."""
    return F.layer_norm(x, (x.shape[-1],), eps=LN_EPS)


class _AdaLayerNorm(nn.Module):
    """SiLU(temb) -> Linear(dim, chunks x dim), read in chunks."""

    def __init__(self, dim: int, chunks: int, *, device: DeviceArg = None):
        super().__init__()
        self.chunks = chunks
        self.linear = Linear(dim, chunks * dim, device=device)

    def params(self, temb: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.linear(F.silu(temb)).chunk(self.chunks, dim=1)


class AdaLayerNormZero(_AdaLayerNorm):
    """(mod(x, scale_msa, shift_msa), gate_msa, shift_mlp, scale_mlp, gate_mlp)."""

    def __init__(self, dim: int, *, device: DeviceArg = None):
        super().__init__(dim, 6, device=device)

    def forward(self, x: torch.Tensor, temb: torch.Tensor):
        shift, scale, gate, shift_mlp, scale_mlp, gate_mlp = self.params(temb)
        with trace.span("mmdit.adaln"):
            h = modulate(layer_norm(x), scale, shift)
        return h, gate, shift_mlp, scale_mlp, gate_mlp


class AdaLayerNormZeroX(_AdaLayerNorm):
    """SD3.5's: AdaLayerNormZero's five, then mod(x, scale_msa2, shift_msa2)
    on the same LN(x) and gate_msa2."""

    def __init__(self, dim: int, *, device: DeviceArg = None):
        super().__init__(dim, 9, device=device)

    def forward(self, x: torch.Tensor, temb: torch.Tensor):
        shift, scale, gate, shift_mlp, scale_mlp, gate_mlp, shift2, scale2, gate2 = \
            self.params(temb)
        with trace.span("mmdit.adaln"):
            normed = layer_norm(x)
            h, h2 = modulate(normed, scale, shift), modulate(normed, scale2, shift2)
        return h, gate, shift_mlp, scale_mlp, gate_mlp, h2, gate2


class AdaLayerNormContinuous(_AdaLayerNorm):
    """mod(x, scale, shift) with (scale, shift) = Linear(SiLU(temb)), scale first."""

    def __init__(self, dim: int, *, device: DeviceArg = None):
        super().__init__(dim, 2, device=device)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        scale, shift = self.params(temb)
        return adaln(x, scale, shift)


def adaln(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """mod(x, scale, shift) under the ``mmdit.adaln`` span."""
    with trace.span("mmdit.adaln"):
        return modulate(layer_norm(x), scale, shift)


class HeadRMSNorm(nn.Module):
    """RMSNorm over the last (head) dim with a learned scale (``weight``,
    ones at start), in f32, rounded once to the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device: DeviceArg = None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=resolve_device(device)))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.ones_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        rms = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)
        return (xf * rms * self.weight.float()).to(x.dtype)


class JointAttention(nn.Module):
    """Attention over the image tokens, joined by the text tokens where
    ``context_dim`` is given (see the module's docstring). ``context_out``
    False leaves out ``to_add_out`` (the last block, where the text stream
    ends)."""

    def __init__(self, dim: int, heads: int, head_dim: int, *, joint: bool,
                 context_out: bool = True, device: DeviceArg = None):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim, self.joint = heads, head_dim, joint
        self.to_q = Linear(dim, inner, device=device)
        self.to_k = Linear(dim, inner, device=device)
        self.to_v = Linear(dim, inner, device=device)
        self.to_out = nn.ModuleList([Linear(inner, dim, device=device)])
        self.norm_q, self.norm_k = (HeadRMSNorm(head_dim, device=device) for _ in range(2))
        if joint:
            self.add_q_proj = Linear(dim, inner, device=device)
            self.add_k_proj = Linear(dim, inner, device=device)
            self.add_v_proj = Linear(dim, inner, device=device)
            self.norm_added_q, self.norm_added_k = (HeadRMSNorm(head_dim, device=device)
                                                    for _ in range(2))
            self.to_add_out = Linear(inner, dim, device=device) if context_out else None

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[0], x.shape[1], self.heads, self.head_dim)

    def _qkv(self, x, to_q, to_k, to_v, norm_q, norm_k):
        """q, k, v as (B, T, heads, head_dim), q and k normed."""
        return (norm_q(self._heads(to_q(x))), norm_k(self._heads(to_k(x))),
                self._heads(to_v(x)))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None):
        with trace.span("mmdit.joint_attention" if self.joint else "mmdit.self_attention"):
            parts = [self._qkv(x, self.to_q, self.to_k, self.to_v, self.norm_q, self.norm_k)]
            if self.joint:
                parts.append(self._qkv(context, self.add_q_proj, self.add_k_proj,
                                       self.add_v_proj, self.norm_added_q, self.norm_added_k))
            q, k, v = ((torch.cat(ts, dim=1) if self.joint else ts[0]).transpose(1, 2)
                       for ts in zip(*parts))
            out = sdpa(q, k, v, scale=1.0 / math.sqrt(self.head_dim))
            out = out.transpose(1, 2).flatten(2)
            n = x.shape[1]
            image = self.to_out[0](out[:, :n])
            if not self.joint:
                return image
            text = self.to_add_out(out[:, n:]) if self.to_add_out is not None else None
            return image, text


class _GELUProj(nn.Module):
    def __init__(self, dim: int, inner: int, *, device: DeviceArg = None):
        super().__init__()
        self.proj = Linear(dim, inner, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.proj(x), approximate="tanh")


class FeedForward(nn.Module):
    """Linear(dim, mult dim), tanh-GELU, Linear(mult dim, dim)."""

    def __init__(self, dim: int, mult: int = 4, *, device: DeviceArg = None):
        super().__init__()
        self.net = nn.ModuleList([_GELUProj(dim, mult * dim, device=device), nn.Identity(),
                                  Linear(mult * dim, dim, device=device)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.net:
            x = layer(x)
        return x


def gated(x: torch.Tensor, gate: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x + gate y with a (B, D) gate."""
    return torch.addcmul(x, gate[:, None], y)


class JointTransformerBlock(nn.Module):
    """One MMDiT block (diffusers' ``JointTransformerBlock``): adaLN-Zero on
    both streams (adaLN-Zero-X on the image stream with ``dual``), the joint
    attention, for ``dual`` a second image-only attention, and a feed-forward
    per stream; with ``context_last`` the text stream takes the continuous
    adaLN and stops here (the block returns None for it)."""

    def __init__(self, dim: int, heads: int, head_dim: int, *, dual: bool, context_last: bool,
                 device: DeviceArg = None):
        super().__init__()
        self.dual, self.context_last = dual, context_last
        self.norm1 = (AdaLayerNormZeroX if dual else AdaLayerNormZero)(dim, device=device)
        self.norm1_context = (AdaLayerNormContinuous if context_last else AdaLayerNormZero)(
            dim, device=device)
        self.attn = JointAttention(dim, heads, head_dim, joint=True,
                                   context_out=not context_last, device=device)
        self.attn2 = JointAttention(dim, heads, head_dim, joint=False,
                                    device=device) if dual else None
        self.ff = FeedForward(dim, device=device)
        self.ff_context = None if context_last else FeedForward(dim, device=device)

    def forward(self, x: torch.Tensor, context: torch.Tensor, temb: torch.Tensor):
        if self.dual:
            h, gate, shift_mlp, scale_mlp, gate_mlp, h2, gate2 = self.norm1(x, temb)
        else:
            h, gate, shift_mlp, scale_mlp, gate_mlp = self.norm1(x, temb)
        if self.context_last:
            g = self.norm1_context(context, temb)
        else:
            g, c_gate, c_shift_mlp, c_scale_mlp, c_gate_mlp = self.norm1_context(context, temb)
        a_x, a_c = self.attn(h, g)
        x = gated(x, gate, a_x)
        if self.dual:
            x = gated(x, gate2, self.attn2(h2))
        x = gated(x, gate_mlp, self.ff(adaln(x, scale_mlp, shift_mlp)))
        if self.context_last:
            return x, None
        context = gated(context, c_gate, a_c)
        context = gated(context, c_gate_mlp,
                        self.ff_context(adaln(context, c_scale_mlp, c_shift_mlp)))
        return x, context
