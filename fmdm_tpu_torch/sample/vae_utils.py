"""
VAE construction and batch encode/decode/reconstruct, KL and VQ
(counterpart of ``fmdm_tpu/sample/vae_utils.py:21-65``).

Weights come from a checkpoint file of either package (its ``model`` entry
or a bare state dict), from a flat JAX parameter dict (``load_jax_params``),
or are drawn from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from fmdm_tpu_torch.device import DeviceArg
from fmdm_tpu_torch.models.factories import VAEFactory
from fmdm_tpu_torch.nn.layers import init_weights
from fmdm_tpu_torch.nn.vae_modules import DiagonalGaussian
from fmdm_tpu_torch.utils.checkpoint import load_model_params
from fmdm_tpu_torch.utils.weights import load_jax_params


def build_vae_model(cfg: Dict[str, Any], flat_params: Optional[Mapping[str, np.ndarray]] = None,
                    generator: Optional[torch.Generator] = None, device: DeviceArg = None,
                    ckpt_path=None):
    """The VAE of a ``{training, model}`` config dict, with the weights of
    ``ckpt_path`` or ``flat_params`` loaded (every parameter present at its
    shape; a checkpoint's extra entries are ignored, as in the JAX package)
    or, without them, drawn from ``generator`` (a CPU generator; by default
    one seeded with ``training.seed``)."""
    model = VAEFactory().build(cfg["model"], device=device)
    if ckpt_path is not None:
        params = load_model_params(ckpt_path, expected=model)
        model.load_state_dict({k: params[k] for k in model.state_dict()}, strict=True)
        return model
    if flat_params is not None:
        return load_jax_params(model, flat_params)
    if generator is None:
        seed = int(cfg.get("training", {}).get("seed") or 0)
        generator = torch.Generator().manual_seed(seed)
    return init_weights(model, generator)


def encode_vae_batch(model, batch: torch.Tensor) -> torch.Tensor:
    """Images in [0, 1] -> latents: a KL model's posterior mode, a VQ
    model's ``quant_conv`` output (before quantization)."""
    out = model.encode(model.image_to_model_range(batch))
    return out.mode() if isinstance(out, DiagonalGaussian) else out


def decode_vae_batch(model, latents: torch.Tensor, recon_type: str = "l1") -> torch.Tensor:
    """Latents -> images in [0, 1]."""
    rec = model.decode(latents)
    return torch.clamp(model.raw_output_to_image(rec, recon_type=recon_type), 0.0, 1.0)


def reconstruct_raw(model, inputs: torch.Tensor):
    """``(rec, aux)`` of a model-range batch: a KL model's forward at the
    posterior's mode, a VQ model's forward with ``train=False``."""
    if hasattr(model, "codebook"):
        return model(inputs)
    return model(inputs, sample_posterior=False)


def reconstruct_vae_batch(model, batch: torch.Tensor, recon_type: str = "l1") -> torch.Tensor:
    """Images -> reconstructed images in [0, 1], through the posterior's mode
    (KL) or the codebook in eval mode (VQ: no EMA update)."""
    rec, _ = reconstruct_raw(model, model.image_to_model_range(batch))
    return torch.clamp(model.raw_output_to_image(rec, recon_type=recon_type), 0.0, 1.0)
