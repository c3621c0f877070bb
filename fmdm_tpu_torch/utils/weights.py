"""
Carry weights from the JAX package's parameter trees into the port's modules.

The JAX trees use torch layouts and torch ``state_dict`` names, so a flat
``{dotted name: numpy array}`` dict (what ``fmdm_tpu.nn.module.flatten_params``
gives, converted with ``np.asarray``) loads key for key.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn


def _to_tensor(value) -> torch.Tensor:
    array = np.asarray(value)
    if array.dtype.name == "bfloat16":  # numpy has no bf16 of its own
        return torch.from_numpy(array.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(array, copy=True))


def state_dict_from_jax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``{dotted name: numpy array}`` -> a torch state dict (CPU tensors)."""
    return {name: _to_tensor(value) for name, value in flat.items()}


def load_jax_params(model: nn.Module, flat: Mapping[str, np.ndarray]) -> nn.Module:
    """Load a flat JAX parameter dict into ``model`` with ``strict=True``."""
    model.load_state_dict(state_dict_from_jax(flat), strict=True)
    return model
