"""
Losses of VAE training (counterpart of ``fmdm_tpu/nn/losses.py``): the
VGG16-features perceptual loss, the hinge GAN losses, the VQ regularizer and
the focal / bce-focal reconstruction losses.

The perceptual loss is on only when ``FMDM_VGG16_WEIGHTS`` (or
``weights_path``) names an existing ``.npz`` of torchvision's VGG16
``state_dict`` (``features.N.weight``/``features.N.bias``); otherwise it is 0,
as in the JAX package. Its VGG weights are frozen and belong to the loss, not
to the model being trained: they are in no optimizer and no checkpoint.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from fmdm_tpu_torch.device import DeviceArg, resolve_device
from fmdm_tpu_torch.nn.layers import Conv
from fmdm_tpu_torch.ops.resample import max_pool_nd, resize_bilinear

# VGG16 "features": conv widths and "M" for a 2x2 max pool, in torchvision's
# index order (each conv is followed by its ReLU)
_VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
              512, 512, 512, "M"]


class _MaxPool(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool_nd(x, 2, 2)


class _ReLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x)


def _build_vgg16_features(num_layers: int, device: torch.device) -> nn.Sequential:
    """The first ``num_layers`` entries of VGG16's ``features``."""
    layers, in_ch = [], 3
    for v in _VGG16_CFG:
        if v == "M":
            layers.append(_MaxPool())
        else:
            layers.append(Conv(2, in_ch, v, kernel_size=3, padding=1, device=device))
            layers.append(_ReLU())
            in_ch = v
    return nn.Sequential(*layers[:num_layers])


class PerceptualLoss(nn.Module):
    """Weighted L1 between VGG16 features of the reconstruction and the
    target at ``layers`` (torchvision indices of ``features``, the ReLU
    outputs 3, 8, 15, 22 by default); grey inputs are tiled to 3 channels and,
    with ``resize``, resized to 224². Enabled only when the weights file
    exists (random VGG features are meaningless)."""

    def __init__(self, resize: bool = False, layers: Tuple[int, ...] = (3, 8, 15, 22),
                 layer_weights: Iterable[float] = (1.0, 1.0, 1.0, 1.0),
                 weights_path: Optional[str] = None, *, device: DeviceArg = None):
        super().__init__()
        device = resolve_device(device)
        self.resize = resize
        self.layer_indices = set(layers)
        self.layer_weights = list(layer_weights)
        self.max_layer = max(layers) if layers else -1
        path = weights_path or os.environ.get("FMDM_VGG16_WEIGHTS")
        self.enabled = bool(path) and os.path.exists(path or "")
        self.weights_path = path
        self.features = None
        if self.enabled:
            self.features = _build_vgg16_features(self.max_layer + 1, device)
            self._load(path)
            self.features.requires_grad_(False)

    def _load(self, path: str) -> None:
        """``features.N.weight``/``bias`` of the ``.npz`` (OIHW) into the
        convs this loss runs; other keys are ignored."""
        raw = np.load(path)
        wanted = self.features.state_dict()
        missing = [k for k in wanted if f"features.{k}" not in raw.files]
        if missing:
            raise KeyError(f"{path} lacks VGG16 weights {missing[:4]}")
        self.features.load_state_dict(
            {k: torch.from_numpy(np.array(raw[f"features.{k}"], np.float32)) for k in wanted},
            strict=True)

    def forward(self, recon: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if not self.enabled:
            return torch.zeros((), dtype=recon.dtype, device=recon.device)
        if recon.shape[1] == 1:
            reps = (1, 3) + (1,) * (recon.dim() - 2)
            recon, target = recon.repeat(reps), target.repeat(reps)
        if self.resize:
            recon = resize_bilinear(recon, (224, 224))
            target = resize_bilinear(target, (224, 224))
        # the target's features need no graph
        with torch.no_grad():
            target_features, t = {}, target
            for idx, layer in enumerate(self.features):
                t = layer(t)
                if idx in self.layer_indices:
                    target_features[idx] = t
        loss = torch.zeros((), dtype=torch.float32, device=recon.device)
        weight_iter = iter(self.layer_weights)
        r = recon
        for idx, layer in enumerate(self.features):
            r = layer(r)
            if idx in self.layer_indices:
                loss = loss + next(weight_iter, 1.0) * torch.mean(torch.abs(r - target_features[idx]))
        return loss


# ---------------------------------------------------------------------------
# GAN, VQ and focal losses (plain functions)
# ---------------------------------------------------------------------------

def discriminator_hinge_loss(real_pred: torch.Tensor, fake_pred: torch.Tensor) -> torch.Tensor:
    return torch.mean(F.relu(1.0 - real_pred)) + torch.mean(F.relu(1.0 + fake_pred))


def generator_hinge_loss(fake_pred: torch.Tensor) -> torch.Tensor:
    return -torch.mean(fake_pred)


def vq_regularizer(latents: torch.Tensor) -> torch.Tensor:
    """The squared batch-and-space mean of the latents plus their variance."""
    spatial = tuple(range(2, latents.dim()))
    mean = torch.mean(latents, dim=(0, *spatial), keepdim=True)
    var = torch.mean((latents - mean) ** 2)
    return torch.mean(mean ** 2) + var


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    return loss


def focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25,
               gamma: float = 2.0, reduction: str = "mean") -> torch.Tensor:
    prob = torch.sigmoid(logits)
    ce = _bce_with_logits(logits, targets)
    p_t = prob * targets + (1 - prob) * (1 - targets)
    alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
    return _reduce(alpha_t * (1 - p_t) ** gamma * ce, reduction)


def bce_focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25,
                   gamma: float = 2.0, reduction: str = "mean") -> torch.Tensor:
    bce = _reduce(_bce_with_logits(logits, targets), reduction)
    return bce + focal_loss(logits, targets, alpha=alpha, gamma=gamma, reduction=reduction)


def write_surrogate_vgg16(path, seed: int) -> str:
    """Write an ``.npz`` of VGG16 ``features`` weights in torchvision's key
    names and OIHW layout, drawn from ``seed`` (N(0, 2/fan_in) weights,
    N(0, 0.01²) biases), for checks of the perceptual path where the
    pretrained file is not available. Returns the path."""
    rng = np.random.default_rng(seed)
    arrays, in_ch, idx = {}, 3, 0
    for v in _VGG16_CFG:
        if v == "M":
            idx += 1
            continue
        fan_in = in_ch * 9
        arrays[f"features.{idx}.weight"] = (rng.standard_normal((v, in_ch, 3, 3))
                                            * np.sqrt(2.0 / fan_in)).astype(np.float32)
        arrays[f"features.{idx}.bias"] = (0.01 * rng.standard_normal(v)).astype(np.float32)
        in_ch, idx = v, idx + 2
    np.savez(path, **arrays)
    return str(path)
