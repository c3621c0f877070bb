"""
VAE model assemblies (counterpart of ``fmdm_tpu/models/vae.py:35-143``):
``AutoencoderKL`` with the SD latent scale (0.18215). Parameter paths match
the JAX tree: encoder, decoder, quant_conv, post_quant_conv.

``encode`` returns a :class:`DiagonalGaussian`; the forward samples the
posterior from an explicit noise tensor or a ``torch.Generator``. ``VQVAE``
(counterpart of :146-258) quantizes through the ``codebook``.
``make_discriminator(device=)`` builds the GAN step's discriminator on the
decoder's output channels: a ``PatchDiscriminator`` for ``AutoencoderKL``,
the ``discriminator_type``'s ('patchgan'/'default' or 'magvit') for
``VQVAE``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from fmdm_tpu_torch.device import DeviceArg, resolve_device
from fmdm_tpu_torch.nn.blocks import ResBlockND
from fmdm_tpu_torch.nn.layers import ConvND
from fmdm_tpu_torch.nn.vae_modules import (Decoder, DiagonalGaussian, Encoder,
                                            MagvitDiscriminatorND, PatchDiscriminator,
                                            VectorQuantizer, VectorQuantizerEMA)

LATENT_SCALE: float = 0.18215


class BaseAutoencoder(nn.Module):
    """Range mapping between images in [0, 1] and the model's [-1, 1]."""

    @staticmethod
    def image_to_model_range(x: torch.Tensor) -> torch.Tensor:
        return x * 2.0 - 1.0

    @staticmethod
    def model_to_image_range(x: torch.Tensor) -> torch.Tensor:
        return (x + 1.0) / 2.0

    @staticmethod
    def raw_output_to_image(x: torch.Tensor, recon_type: str = "l1") -> torch.Tensor:
        if recon_type in ("bce", "bce_focal", "focal"):
            return torch.sigmoid(x)
        return (x + 1.0) / 2.0


class AutoencoderKL(BaseAutoencoder):
    def __init__(
        self,
        in_channels: int = 3,
        out_channels: int = 3,
        resolution: int = 256,
        base_ch: int = 128,
        ch_mult: Tuple[int, ...] = (1, 2, 4, 4),
        down_channels: Optional[Tuple[int, ...]] = None,
        num_res_blocks: int = 2,
        attn_resolutions: Tuple[int, ...] = (),
        z_channels: int = 4,
        embed_dim: int = 4,
        dropout: float = 0.0,
        use_attention: bool = True,
        attn_heads: int = 4,
        attn_dim_head: int = 64,
        spatial_dims: int = 2,
        emb_channels: Optional[int] = None,
        use_scale_shift_norm: bool = False,
        norm_groups: Optional[int] = None,
        codebook_size: Optional[int] = None,
        num_embeddings: Optional[int] = None,
        ckpt_path: Optional[str] = None,
        double_z: bool = True,
        block_factory=None,
        block_norm_type: str = "gn",
        block_act: str = "silu",
        *,
        device: DeviceArg = None,
        **_unused,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.spatial_dims = spatial_dims
        self.out_channels = out_channels
        if block_factory is None and (block_norm_type != "gn" or block_act != "silu"):
            def block_factory(**kwargs):
                return ResBlockND(norm_type=block_norm_type, act=block_act, **kwargs)

        common = dict(
            base_ch=base_ch, ch_mult=tuple(ch_mult),
            down_channels=tuple(down_channels) if down_channels is not None else None,
            num_res_blocks=num_res_blocks, attn_resolutions=tuple(attn_resolutions),
            resolution=resolution, z_channels=z_channels, dropout=dropout,
            use_attention=use_attention, attn_heads=attn_heads, attn_dim_head=attn_dim_head,
            spatial_dims=spatial_dims, emb_channels=emb_channels,
            use_scale_shift_norm=use_scale_shift_norm, norm_groups=norm_groups,
            block_factory=block_factory, device=device,
        )
        self.encoder = Encoder(in_channels=in_channels, double_z=double_z, **common)
        self.decoder = Decoder(out_ch=out_channels, tanh_out=False, **common)
        self.quant_conv = ConvND(spatial_dims, 2 * z_channels, 2 * embed_dim, 1, padding=0,
                                 device=device)
        self.post_quant_conv = ConvND(spatial_dims, embed_dim, z_channels, 1, padding=0,
                                      device=device)
        self.embed_dim = embed_dim
        self.num_embeddings = num_embeddings
        self.codebook_size = codebook_size
        self.ckpt_path = ckpt_path

    def make_discriminator(self, *, device: DeviceArg = None) -> PatchDiscriminator:
        return PatchDiscriminator(in_channels=self.decoder.final_channels,
                                  spatial_dims=self.spatial_dims, device=device)

    def encode(self, x: torch.Tensor, normalize: bool = False):
        """The posterior q(z|x), or its mode times ``LATENT_SCALE`` when
        ``normalize``."""
        posterior = DiagonalGaussian(self.quant_conv(self.encoder(x)))
        if normalize:
            return posterior.mode() * LATENT_SCALE
        return posterior

    def decode(self, z: torch.Tensor, denorm: bool = False) -> torch.Tensor:
        if denorm:
            z = z / LATENT_SCALE
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x: torch.Tensor, sample_posterior: bool = True,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """(reconstruction, posterior). A sampled posterior takes ``noise``
        (the latent's shape) or draws it from ``generator``."""
        posterior = self.encode(x)
        z = posterior.sample(noise, generator) if sample_posterior else posterior.mode()
        return self.decode(z), posterior


class VQVAE(BaseAutoencoder):
    """The VQ autoencoder (counterpart of ``fmdm_tpu/models/vae.py:146-258``):
    encoder (no double z), ``quant_conv`` to ``embed_dim``, the ``codebook``
    (``quantizer_type`` "ema" or "classic"/"vq"), ``post_quant_conv`` and the
    decoder. ``forward(x, train=)`` returns ``(rec, aux)`` with ``vq_loss``,
    ``perplexity``, ``codes`` and ``ema_update`` (the EMA buffers' update of
    a train-mode call, which the trainer applies, else None)."""

    def __init__(
        self,
        in_channels: int = 3,
        out_channels: int = 3,
        resolution: int = 256,
        base_ch: int = 128,
        ch_mult: Tuple[int, ...] = (1, 2, 4, 4),
        down_channels: Optional[Tuple[int, ...]] = None,
        num_res_blocks: int = 2,
        attn_resolutions: Tuple[int, ...] = (),
        z_channels: int = 4,
        embed_dim: int = 4,
        dropout: float = 0.0,
        use_attention: bool = True,
        attn_heads: int = 4,
        attn_dim_head: int = 64,
        spatial_dims: int = 2,
        emb_channels: Optional[int] = None,
        use_scale_shift_norm: bool = False,
        ckpt_path: Optional[str] = None,
        codebook_size: int = 1024,
        vq_beta: float = 0.25,
        vq_ema_decay: float = 0.99,
        vq_ema_eps: float = 1e-5,
        quantizer_type: str = "ema",
        discriminator_type: str = "patchgan",
        block_factory=None,
        block_norm_type: str = "gn",
        block_act: str = "silu",
        *,
        device: DeviceArg = None,
        **_unused,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.spatial_dims = spatial_dims
        self.out_channels = out_channels
        self.quantizer_type = str(quantizer_type).lower()
        self.discriminator_type = (str(discriminator_type).lower()
                                   if discriminator_type is not None else "patchgan")
        if block_factory is None and (block_norm_type != "gn" or block_act != "silu"):
            def block_factory(**kwargs):
                return ResBlockND(norm_type=block_norm_type, act=block_act, **kwargs)

        common = dict(
            base_ch=base_ch, ch_mult=tuple(ch_mult),
            down_channels=tuple(down_channels) if down_channels is not None else None,
            num_res_blocks=num_res_blocks, attn_resolutions=tuple(attn_resolutions),
            resolution=resolution, z_channels=z_channels, dropout=dropout,
            use_attention=use_attention, attn_heads=attn_heads, attn_dim_head=attn_dim_head,
            spatial_dims=spatial_dims, emb_channels=emb_channels,
            use_scale_shift_norm=use_scale_shift_norm, block_factory=block_factory,
            device=device,
        )
        self.encoder = Encoder(in_channels=in_channels, double_z=False, **common)
        self.decoder = Decoder(out_ch=out_channels, tanh_out=False, **common)
        self.quant_conv = ConvND(spatial_dims, z_channels, embed_dim, 1, padding=0, device=device)
        self.post_quant_conv = ConvND(spatial_dims, embed_dim, z_channels, 1, padding=0,
                                      device=device)
        self.embed_dim = embed_dim
        self.ckpt_path = ckpt_path
        if self.quantizer_type in {"classic", "vq"}:
            self.codebook = VectorQuantizer(codebook_size, embed_dim, commitment_cost=vq_beta,
                                            device=device)
        elif self.quantizer_type == "ema":
            self.codebook = VectorQuantizerEMA(codebook_size, embed_dim, commitment_cost=vq_beta,
                                               decay=vq_ema_decay, eps=vq_ema_eps, device=device)
        else:
            raise ValueError(
                f"Unknown quantizer_type '{self.quantizer_type}'. Expected 'classic' or 'ema'.")

    def make_discriminator(self, *, device: DeviceArg = None) -> nn.Module:
        if self.discriminator_type in {"patchgan", "default"}:
            return PatchDiscriminator(in_channels=self.decoder.final_channels,
                                      spatial_dims=self.spatial_dims, device=device)
        if self.discriminator_type == "magvit":
            return MagvitDiscriminatorND(in_channels=self.decoder.final_channels,
                                         spatial_dims=self.spatial_dims, device=device)
        raise ValueError(
            f"Unknown discriminator_type '{self.discriminator_type}'. Expected 'patchgan' or "
            f"'magvit'.")

    def encode(self, x: torch.Tensor, normalize: bool = False) -> torch.Tensor:
        """``quant_conv``'s output (before quantization), times
        ``LATENT_SCALE`` when ``normalize``."""
        quant_in = self.quant_conv(self.encoder(x))
        return quant_in * LATENT_SCALE if normalize else quant_in

    def decode(self, z: torch.Tensor, denorm: bool = False) -> torch.Tensor:
        if denorm:
            z = z / LATENT_SCALE
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x: torch.Tensor, *, train: bool = False):
        out = self.codebook(self.encode(x), train=train)
        rec = self.decode(out.quantized)
        return rec, {"vq_loss": out.vq_loss, "perplexity": out.perplexity, "codes": out.codes,
                     "ema_update": out.new_state}
