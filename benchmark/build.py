"""
What both entries build from a configuration: the weights (``inputs.py``,
from the seed, on the device), the program's model with those weights, and
the reference model with the same.

The program's model is built on the ``meta`` device and then given storage
on the run's device, so that nothing is drawn on the host: the weights are
the benchmark's own draw, loaded by name.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark import counters, inputs
from benchmark.reference.ops import Ops

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def weight_shapes(cfg: dict) -> Dict[str, tuple]:
    model = counters.build_reference(cfg, Ops(), "meta")
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return inputs.draw_weights(weight_shapes(cfg), seed, device)


def program_model(cfg: dict, weights: Dict[str, torch.Tensor], device) -> torch.nn.Module:
    from fmdm_tpu_torch.models.factories import DiffusionUNetFactory

    model = DiffusionUNetFactory().build(cfg["model"]["unet"], conditioning=cfg["conditioning"],
                                         channels=cfg["channels"], device="meta")
    model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model


def reference_model(cfg: dict, weights: Dict[str, torch.Tensor], device,
                    precision: str = "f32") -> torch.nn.Module:
    model = counters.build_reference(cfg, Ops(precision), device)
    model.load_state_dict(weights, strict=True)
    return model


def f32_reference_numerics() -> None:
    """TF32 off: the reference's float32 is float32. cuDNN picks its
    convolutions by timing them (the reference runs after the window; its
    f32 convolutions at a few rows took cuDNN's slow FFT path otherwise)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
