"""
VAE building blocks (counterpart of ``fmdm_tpu/nn/vae_modules.py:29-282``):
the SD-style hierarchical ``Encoder`` and ``Decoder`` and the
``DiagonalGaussian`` posterior. Parameter paths match the JAX trees: conv_in,
downs.N.blocks.M / downs.N.attns.M / downs.N.down, mid_block1 / mid_attn /
mid_block2, norm_out, conv_out; ups mirror-ordered (ups.0 is the shallowest
stage, run last).

``norm_out`` + SiLU goes through kernel K1 with ``act=True``: the JAX
``silu(GroupNorm(h))``, the same function in f32. The mid attention runs the
flash kernels (K3, K4/K5 in training) at T >= 1024. The vector quantizers
(``VectorQuantizer``, ``VectorQuantizerEMA``, :288-424) are plain PyTorch,
as they are plain XLA in the JAX package. So are the GAN discriminators
(``PatchDiscriminator``, ``MagvitDiscriminatorND``, :425-490): convolutions
(cuDNN on the card), the JAX package's BatchNorm and LeakyReLU(0.2).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from fmdm_tpu_torch.device import DeviceArg, resolve_device
from fmdm_tpu_torch.nn.blocks import DownsampleND, ResBlockND, SpatialSelfAttention, UpsampleND
from fmdm_tpu_torch.nn.layers import BatchNorm, ConvND, GroupNorm, Sequential
from fmdm_tpu_torch.ops.kernels.group_norm import group_norm_act


class _Stage(nn.Module):
    """Per-stage holder: ``blocks``, ``attns`` and the resample child
    (``down`` or ``up``), as the reference names them."""

    def __init__(self, blocks: Sequence[nn.Module], attns: Sequence[nn.Module],
                 resample: Optional[nn.Module], resample_name: str):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.attns = nn.ModuleList(attns)
        self.resample_name = resample_name if resample is not None else None
        if resample is not None:
            self.add_module(resample_name, resample)

    def forward(self, x: torch.Tensor, emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i, block in enumerate(self.blocks):
            x = block(x, emb)
            if i < len(self.attns):
                x = self.attns[i](x)
        if self.resample_name is not None:
            x = self._modules[self.resample_name](x)
        return x


def _build_attention_layer(channels: int, attn_heads, attn_dim_head, *,
                           device: DeviceArg = None) -> SpatialSelfAttention:
    heads = attn_heads if attn_heads is not None else 1
    if attn_dim_head is not None:
        dim_head = attn_dim_head
    elif heads == 1:
        dim_head = channels
    else:
        dim_head = max(1, channels // heads)
    return SpatialSelfAttention(dim=channels, heads=heads, dim_head=dim_head, device=device)


def _norm_out_act(norm: GroupNorm, h: torch.Tensor) -> torch.Tensor:
    """silu(norm_out(h)) through K1."""
    return group_norm_act(h, norm.weight, norm.bias, num_groups=norm.num_groups, eps=norm.eps,
                          act=True)


def _zero_emb(emb_channels: Optional[int], x: torch.Tensor) -> Optional[torch.Tensor]:
    if emb_channels is None:
        return None
    return torch.zeros((x.shape[0], emb_channels), dtype=x.dtype, device=x.device)


def _channels(down_channels, base_ch: int, ch_mult) -> Tuple[int, ...]:
    return tuple(down_channels) if down_channels is not None else tuple(base_ch * m for m in ch_mult)


class Encoder(nn.Module):
    def __init__(
        self,
        in_channels: int = 3,
        base_ch: int = 128,
        ch_mult: Tuple[int, ...] = (1, 2, 4, 4),
        down_channels: Optional[Tuple[int, ...]] = None,
        num_res_blocks: int = 2,
        attn_resolutions: Tuple[int, ...] = (),
        resolution: int = 256,
        z_channels: int = 4,
        dropout: float = 0.0,
        use_attention: bool = True,
        attn_heads: Optional[int] = None,
        attn_dim_head: Optional[int] = None,
        double_z: bool = True,
        spatial_dims: int = 2,
        emb_channels: Optional[int] = None,
        use_scale_shift_norm: bool = False,
        norm_groups: Optional[int] = None,
        block_factory=None,
        *,
        device: DeviceArg = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.double_z = double_z
        self.z_channels = z_channels
        self.emb_channels = emb_channels
        use_ssn = use_scale_shift_norm and emb_channels is not None
        if emb_channels is None and use_scale_shift_norm:
            raise ValueError("use_scale_shift_norm requires emb_channels to be provided.")
        factory = block_factory or ResBlockND

        channels = _channels(down_channels, base_ch, ch_mult)
        self.conv_in = ConvND(spatial_dims, in_channels, base_ch, 3, padding=1, device=device)

        curr_res = resolution
        in_ch = base_ch
        stages = []
        for idx, out_ch in enumerate(channels):
            blocks, attns = [], []
            for _ in range(num_res_blocks):
                blocks.append(factory(
                    channels=in_ch, emb_channels=emb_channels, dropout=dropout,
                    out_channels=out_ch, use_conv=False,
                    use_scale_shift_norm=use_ssn, spatial_dims=spatial_dims, device=device,
                ))
                in_ch = out_ch
                if use_attention and curr_res in tuple(attn_resolutions):
                    attns.append(_build_attention_layer(in_ch, attn_heads, attn_dim_head,
                                                        device=device))
            down = None
            if idx != len(channels) - 1:
                down = DownsampleND(spatial_dims, in_ch, use_conv=True, device=device)
                curr_res //= 2
            stages.append(_Stage(blocks, attns, down, "down"))
        self.downs = nn.ModuleList(stages)

        def mid_block():
            return ResBlockND(channels=in_ch, emb_channels=emb_channels, dropout=dropout,
                              out_channels=in_ch, use_conv=False, use_scale_shift_norm=use_ssn,
                              spatial_dims=spatial_dims, device=device)

        self.mid_block1 = mid_block()
        self.mid_attn = (_build_attention_layer(in_ch, attn_heads, attn_dim_head, device=device)
                         if use_attention else nn.Identity())
        self.mid_block2 = mid_block()

        groups = norm_groups if norm_groups is not None else max(1, math.gcd(in_ch, 32))
        self.norm_out = GroupNorm(groups, in_ch, device=device)
        self.out_channels = 2 * z_channels if double_z else z_channels
        self.conv_out = ConvND(spatial_dims, in_ch, self.out_channels, 3, padding=1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        emb = _zero_emb(self.emb_channels, x)
        h = self.conv_in(x)
        for stage in self.downs:
            h = stage(h, emb)
        h = self.mid_block1(h, emb)
        h = self.mid_attn(h)
        h = self.mid_block2(h, emb)
        return self.conv_out(_norm_out_act(self.norm_out, h))


class Decoder(nn.Module):
    def __init__(
        self,
        out_ch: int = 3,
        base_ch: int = 128,
        ch_mult: Tuple[int, ...] = (1, 2, 4, 4),
        down_channels: Optional[Tuple[int, ...]] = None,
        num_res_blocks: int = 2,
        attn_resolutions: Tuple[int, ...] = (),
        resolution: int = 256,
        z_channels: int = 4,
        dropout: float = 0.0,
        use_attention: bool = True,
        attn_heads: Optional[int] = None,
        attn_dim_head: Optional[int] = None,
        tanh_out: bool = False,
        spatial_dims: int = 2,
        emb_channels: Optional[int] = None,
        use_scale_shift_norm: bool = False,
        norm_groups: Optional[int] = None,
        block_factory=None,
        *,
        device: DeviceArg = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.tanh_out = tanh_out
        self.emb_channels = emb_channels
        use_ssn = use_scale_shift_norm and emb_channels is not None
        if emb_channels is None and use_scale_shift_norm:
            raise ValueError("use_scale_shift_norm requires emb_channels to be provided.")
        factory = block_factory or ResBlockND

        channels = _channels(down_channels, base_ch, ch_mult)
        lowest_res = resolution // (2 ** (len(channels) - 1))
        block_in = channels[-1]
        self.conv_in = ConvND(spatial_dims, z_channels, block_in, 3, padding=1, device=device)

        def mid_block(ch):
            return ResBlockND(channels=ch, emb_channels=emb_channels, dropout=dropout,
                              out_channels=ch, use_conv=False, use_scale_shift_norm=use_ssn,
                              spatial_dims=spatial_dims, device=device)

        self.mid_block1 = mid_block(block_in)
        self.mid_attn = (_build_attention_layer(block_in, attn_heads, attn_dim_head, device=device)
                         if use_attention else nn.Identity())
        self.mid_block2 = mid_block(block_in)

        # built deepest first but inserted at index 0, so ups[0] is the
        # shallowest stage and the forward runs reversed(ups)
        stages = []
        in_ch = block_in
        curr_res = lowest_res
        for idx, out_ch_stage in enumerate(reversed(channels)):
            blocks, attns = [], []
            for _ in range(num_res_blocks + 1):
                blocks.append(factory(
                    channels=in_ch, emb_channels=emb_channels, dropout=dropout,
                    out_channels=out_ch_stage, use_conv=False,
                    use_scale_shift_norm=use_ssn, spatial_dims=spatial_dims, device=device,
                ))
                in_ch = out_ch_stage
                if use_attention and curr_res in tuple(attn_resolutions):
                    attns.append(_build_attention_layer(in_ch, attn_heads, attn_dim_head,
                                                        device=device))
            up = None
            if idx != len(channels) - 1:
                up = UpsampleND(spatial_dims, in_ch, use_conv=True, device=device)
                curr_res *= 2
            stages.insert(0, _Stage(blocks, attns, up, "up"))
        self.ups = nn.ModuleList(stages)
        self.final_channels = out_ch

        groups = norm_groups if norm_groups is not None else max(1, math.gcd(in_ch, 32))
        self.norm_out = GroupNorm(groups, in_ch, device=device)
        self.conv_out = ConvND(spatial_dims, in_ch, out_ch, 3, padding=1, device=device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        emb = _zero_emb(self.emb_channels, z)
        h = self.conv_in(z)
        h = self.mid_block1(h, emb)
        h = self.mid_attn(h)
        h = self.mid_block2(h, emb)
        for stage in reversed(self.ups):
            h = stage(h, emb)
        h = self.conv_out(_norm_out_act(self.norm_out, h))
        return torch.tanh(h) if self.tanh_out else h


class DiagonalGaussian:
    """q(z|x) from the moment tensor (mean and log-variance stacked on dim 1);
    logvar clamped to [-30, 20]."""

    def __init__(self, parameters: torch.Tensor, deterministic: bool = False):
        mu, logvar = parameters.chunk(2, dim=1)
        self.mu = mu
        self.logvar = torch.clamp(logvar, -30.0, 20.0)
        self.deter = deterministic
        if deterministic:
            self.std = torch.zeros_like(mu)
            self.var = torch.zeros_like(mu)
        else:
            self.std = torch.exp(0.5 * self.logvar)
            self.var = torch.exp(self.logvar)

    def sample(self, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """mu + std · noise, with ``noise`` given or drawn from ``generator``
        (a generator on mu's device)."""
        if self.deter:
            return self.mu
        if noise is None:
            noise = torch.randn(self.mu.shape, generator=generator, dtype=self.mu.dtype,
                                device=self.mu.device)
        return self.mu + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mu

    def kl(self, other: Optional["DiagonalGaussian"] = None, reduce_dims=None) -> torch.Tensor:
        if self.deter:
            return torch.zeros((1,), dtype=self.mu.dtype, device=self.mu.device)
        if reduce_dims is None:
            reduce_dims = tuple(range(1, self.mu.dim()))
        if other is None:
            return 0.5 * torch.sum(self.mu ** 2 + self.var - 1.0 - self.logvar, dim=tuple(reduce_dims))
        return 0.5 * torch.sum(
            (self.mu - other.mu) ** 2 / other.var + self.var / other.var - 1.0 - self.logvar
            + other.logvar,
            dim=tuple(reduce_dims),
        )

    def nll(self, x: torch.Tensor, reduce_dims=None) -> torch.Tensor:
        if reduce_dims is None:
            reduce_dims = tuple(range(1, self.mu.dim()))
        logtwopi = math.log(2.0 * math.pi)
        return 0.5 * torch.sum(logtwopi + self.logvar + (x - self.mu) ** 2 / self.var,
                               dim=tuple(reduce_dims))


# ---------------------------------------------------------------------------
# Vector quantizers
# ---------------------------------------------------------------------------

class QuantizerOutput(NamedTuple):
    quantized: torch.Tensor        # straight-through: z's values replaced, z's gradient
    vq_loss: torch.Tensor
    perplexity: torch.Tensor
    codes: torch.Tensor            # (N, *spatial) indices into the codebook
    new_state: Optional[Dict[str, torch.Tensor]]  # the EMA buffers' update, or None


def _nearest_codes(flat_z: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
    """Index of each row's nearest code, by ‖z‖² + ‖e‖² − 2 z·Eᵀ (the JAX
    package's formula, term for term; ``argmin`` takes the first minimum)."""
    z_sq = torch.sum(flat_z ** 2, dim=1, keepdim=True)
    e_sq = torch.sum(embedding ** 2, dim=1)
    distances = z_sq + e_sq - (2.0 * flat_z) @ embedding.T
    return torch.argmin(distances, dim=1)


def _quantize(z: torch.Tensor, embedding: torch.Tensor, eps: float):
    """(rows of z channels-last, indices, quantized z, counts per code,
    perplexity) of z (N, C, *spatial) against ``embedding`` (K, C)."""
    z_last = torch.movedim(z, 1, -1)
    flat_z = z_last.reshape(-1, z_last.shape[-1])
    indices = _nearest_codes(flat_z, embedding)
    quantized = torch.movedim(F.embedding(indices, embedding).reshape(z_last.shape), -1, 1)
    counts = torch.bincount(indices, minlength=embedding.shape[0]).to(z.dtype)
    avg_probs = counts / flat_z.shape[0]
    perplexity = torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + eps)))
    return flat_z, indices.reshape(z_last.shape[:-1]), quantized, counts, perplexity


class VectorQuantizer(nn.Module):
    """The classic VQ-VAE quantizer: the codebook ``embedding`` (K, D) is a
    parameter, trained by the codebook loss (counterpart of
    ``fmdm_tpu/nn/vae_modules.py:317-345``)."""

    def __init__(self, num_embeddings: int, embedding_dim: int, commitment_cost: float = 0.25,
                 *, device: DeviceArg = None):
        super().__init__()
        device = resolve_device(device)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.commitment_cost = commitment_cost
        self.embedding = nn.Parameter(torch.empty(num_embeddings, embedding_dim, device=device))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if not self.embedding.is_meta:
            self.embedding.copy_(torch.randn(self.embedding.shape, generator=generator))

    def forward(self, z: torch.Tensor, *, train: bool = False) -> QuantizerOutput:
        _, codes, quantized, _, perplexity = _quantize(z, self.embedding.to(z.dtype), 1e-5)
        commitment_loss = torch.mean((quantized.detach() - z) ** 2)
        codebook_loss = torch.mean((quantized - z.detach()) ** 2)
        vq_loss = codebook_loss + self.commitment_cost * commitment_loss
        return QuantizerOutput(z + (quantized - z).detach(), vq_loss, perplexity, codes, None)


class VectorQuantizerEMA(nn.Module):
    """The EMA-codebook quantizer (counterpart of
    ``fmdm_tpu/nn/vae_modules.py:362-424``). ``embedding``,
    ``ema_cluster_size`` and ``ema_w`` are persistent buffers: in the state
    dict, in no optimizer. In a train-mode call with ``decay > 0`` the
    update of all three is computed from this call's codes and returned in
    ``new_state``; the caller applies it (:meth:`apply_update`). The per-code
    counts and sums are ``bincount`` and ``index_add_`` over the rows, where
    the JAX package multiplies by the one-hot matrix: the same sums, without
    the (rows x K) matrix. With ``mesh`` set to a data mesh over ranks (the
    train step sets it), both are summed over the ranks before the update,
    so every rank's codebook follows the global batch's codes."""

    def __init__(self, num_embeddings: int, embedding_dim: int, commitment_cost: float = 0.25,
                 decay: float = 0.99, eps: float = 1e-5, *, device: DeviceArg = None):
        super().__init__()
        device = resolve_device(device)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.commitment_cost = commitment_cost
        self.decay = decay
        self.eps = eps
        self.mesh = None
        self.register_buffer("embedding", torch.empty(num_embeddings, embedding_dim, device=device))
        self.register_buffer("ema_cluster_size", torch.empty(num_embeddings, device=device))
        self.register_buffer("ema_w", torch.empty(num_embeddings, embedding_dim, device=device))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """A N(0, 1) codebook, no counts, and ``ema_w`` a copy of it."""
        if self.embedding.is_meta:
            return
        self.embedding.copy_(torch.randn(self.embedding.shape, generator=generator))
        self.ema_cluster_size.zero_()
        self.ema_w.copy_(self.embedding)

    @torch.no_grad()
    def apply_update(self, new_state: Dict[str, torch.Tensor]) -> None:
        for name, value in new_state.items():
            getattr(self, name).copy_(value)

    def forward(self, z: torch.Tensor, *, train: bool = False) -> QuantizerOutput:
        flat_z, codes, quantized, counts, perplexity = _quantize(
            z, self.embedding.to(z.dtype), self.eps)
        new_state = None
        if train and self.decay > 0.0:
            with torch.no_grad():
                dw = torch.zeros_like(self.ema_w).index_add_(0, codes.reshape(-1),
                                                             flat_z.detach().to(self.ema_w.dtype))
                if self.mesh is not None:
                    from fmdm_tpu_torch.parallel.mesh import all_reduce_sum

                    counts = all_reduce_sum(counts.clone(), self.mesh)
                    dw = all_reduce_sum(dw, self.mesh)
                ema_cluster_size = (self.ema_cluster_size * self.decay
                                    + counts.to(self.ema_cluster_size.dtype) * (1 - self.decay))
                ema_w = self.ema_w * self.decay + dw * (1 - self.decay)
                n = torch.sum(ema_cluster_size)
                cluster_size = ((ema_cluster_size + self.eps)
                                / (n + self.num_embeddings * self.eps) * n)
                new_state = {"embedding": ema_w / cluster_size[:, None],
                             "ema_cluster_size": ema_cluster_size, "ema_w": ema_w}
        commitment_loss = torch.mean((quantized.detach() - z) ** 2)
        vq_loss = self.commitment_cost * commitment_loss
        return QuantizerOutput(z + (quantized - z).detach(), vq_loss, perplexity, codes, new_state)


# ---------------------------------------------------------------------------
# Discriminators
# ---------------------------------------------------------------------------

class _LeakyReLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(x, 0.2)


def _discriminator_layers(spatial_dims: int, in_channels: int, ch: int, deep: Tuple[int, int],
                          last: Tuple[int, int], device: torch.device) -> Sequential:
    """A 4-wide stride-2 conv and LeakyReLU, three (conv, BatchNorm,
    LeakyReLU) stages doubling the width, and a one-channel conv: ``deep``
    is the (stride, padding) of the fourth conv, ``last`` the (kernel,
    padding) of the last."""
    if spatial_dims not in (1, 2, 3):
        raise ValueError("spatial_dims must be 1, 2 or 3")
    layers = [ConvND(spatial_dims, in_channels, ch, 4, 2, 1, device=device), _LeakyReLU()]
    for c_in, c_out, (stride, pad) in ((ch, ch * 2, (2, 1)), (ch * 2, ch * 4, (2, 1)),
                                       (ch * 4, ch * 8, deep)):
        layers += [ConvND(spatial_dims, c_in, c_out, 4, stride, pad, device=device),
                   BatchNorm(c_out, device=device), _LeakyReLU()]
    layers.append(ConvND(spatial_dims, ch * 8, 1, last[0], 1, last[1], device=device))
    return Sequential(*layers)


class PatchDiscriminator(nn.Module):
    """The 4-down-conv PatchGAN head; parameters under ``model.N`` (conv
    ``model.0/2/5/8/11.conv``, BatchNorm ``model.3/6/9``).
    ``forward(x, train=)`` passes ``train`` to the BatchNorms only."""

    def __init__(self, in_channels: int = 1, base_channels: int = 64, spatial_dims: int = 2, *,
                 device: DeviceArg = None):
        super().__init__()
        self.model = _discriminator_layers(spatial_dims, in_channels, base_channels, (2, 1),
                                           (3, 1), resolve_device(device))

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        return self.model(x, train=train)


class MagvitDiscriminatorND(nn.Module):
    """The MAGVIT-style 5-conv discriminator: the fourth conv keeps the
    resolution, the last is a 4-wide conv without padding."""

    def __init__(self, in_channels: int = 3, base_channels: int = 64, spatial_dims: int = 2, *,
                 device: DeviceArg = None):
        super().__init__()
        self.model = _discriminator_layers(spatial_dims, in_channels, base_channels, (1, 1),
                                           (4, 0), resolve_device(device))

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        return self.model(x, train=train)


class MagvitDiscriminator(MagvitDiscriminatorND):
    def __init__(self, in_channels: int = 3, base_channels: int = 64, *,
                 device: DeviceArg = None):
        super().__init__(in_channels=in_channels, base_channels=base_channels, spatial_dims=2,
                         device=device)
