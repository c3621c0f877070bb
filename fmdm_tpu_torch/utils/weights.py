"""
Carry weights from the JAX package's parameter trees into the port's modules.

The JAX trees use torch layouts and torch ``state_dict`` names, so a flat
``{dotted name: numpy array}`` dict (what ``fmdm_tpu.nn.module.flatten_params``
gives, converted with ``np.asarray``) loads key for key: a model's, and a
discriminator's (its BatchNorms' running statistics included).

A quantized JAX tree holds ``QuantizedConvWeight`` / ``QuantizedLinearWeight``
bundles at ``<module>.weight``; such a leaf (anything with ``qweight``,
``wscale`` and ``act_scale``, read by duck typing: the port never imports
JAX) turns the port's module at that path into its int8 counterpart with the
same int8 weight and scales, so both packages then run the same int8 forward.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from fmdm_tpu_torch.ops.quant import QuantizedConvWeight, QuantizedLinearWeight

_BUNDLE = ("qweight", "wscale", "act_scale")


def _to_tensor(value) -> torch.Tensor:
    array = np.asarray(value)
    if array.dtype.name == "bfloat16":  # numpy has no bf16 of its own
        return torch.from_numpy(array.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(array, copy=True))


def _is_bundle(value) -> bool:
    return all(hasattr(value, name) for name in _BUNDLE)


def state_dict_from_jax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``{dotted name: numpy array or quantized bundle}`` -> a torch state
    dict (CPU tensors); a bundle's three arrays under ``<name>.qweight``,
    ``.wscale`` and ``.act_scale``."""
    out: Dict[str, torch.Tensor] = {}
    for name, value in flat.items():
        if _is_bundle(value):
            out.update({f"{name}.{part}": _to_tensor(getattr(value, part)) for part in _BUNDLE})
        else:
            out[name] = _to_tensor(value)
    return out


@torch.no_grad()
def load_jax_params(model: nn.Module, flat: Mapping[str, np.ndarray]) -> nn.Module:
    """Load a flat JAX parameter dict into ``model`` with ``strict=True``,
    first making each module that holds a quantized bundle in ``flat`` int8
    (in place)."""
    for name, value in flat.items():
        if not _is_bundle(value):
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        kind = (QuantizedLinearWeight if type(value).__name__ == "QuantizedLinearWeight"
                else QuantizedConvWeight)
        held = getattr(owner, leaf)
        device = held.qweight.device if isinstance(held, nn.Module) else held.device
        bundle = kind(*(_to_tensor(getattr(value, part)).to(device) for part in _BUNDLE))
        delattr(owner, leaf)
        setattr(owner, leaf, bundle)
    model.load_state_dict(state_dict_from_jax(flat), strict=True)
    return model
