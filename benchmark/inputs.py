"""
What a run makes from ``--seed``, on the run's device, in a few large
calls: the weights of a model, a pool of LDCT-like batches, and the noise
and timesteps of each step or call. The same seed gives the same inputs;
both the program and the reference are handed them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

SEED_MOD = 2 ** 63 - 1
LOW_DOSE_NOISE = 0.2   # white noise of the conditioning slice, on [-1, 1] images


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of draws of a run."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + stream) % SEED_MOD)


def draw_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """f32 weights for a state dict's ``shapes``, from one uniform draw:
    U(±1/√fan_in) for a weight of two or more dims and for the bias beside
    it; 1 + U(±0.1) for a 1-D weight (a norm's scale) and U(±0.1) for a bias
    with no such weight (a norm's shift). Layers the program starts at zero
    get random values too, so that every layer shapes the output."""
    names = list(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    scale, offset = [], []
    for name in names:
        shape = shapes[name]
        stem = name.rsplit(".", 1)[0]
        sibling = shapes.get(stem + ".weight")
        if len(shape) >= 2:
            scale.append(1.0 / math.sqrt(math.prod(shape[1:])))
            offset.append(0.0)
        elif name.endswith(".bias") and sibling is not None and len(sibling) >= 2:
            scale.append(1.0 / math.sqrt(math.prod(sibling[1:])))
            offset.append(0.0)
        else:
            scale.append(0.1)
            offset.append(1.0 if name.endswith(".weight") else 0.0)
    counts = torch.tensor(sizes, device=device)
    flat = torch.rand(sum(sizes), generator=generator(seed, 0, device), device=device)
    flat = (flat * 2 - 1) * torch.tensor(scale, device=device).repeat_interleave(counts) \
        + torch.tensor(offset, device=device).repeat_interleave(counts)
    return {n: t.reshape(shapes[n]) for n, t in zip(names, flat.split(sizes))}


def ldct_pool(n_batches: int, batch: int, spatial: Sequence[int], seed: int,
              device) -> List[Dict[str, torch.Tensor]]:
    """``n_batches`` batches of (x0, cond), one channel each, in [-1, 1]:
    x0 a smooth random field (a coarse grid at 1/16 of the size, or 2 along
    a short axis, interpolated up), the conditioning x0 plus white noise of
    ``LOW_DOSE_NOISE``, clipped: a full-dose slice and its low-dose pair."""
    gen = generator(seed, 1, device)
    coarse = [max(2, s // 16) for s in spatial]
    n = n_batches * batch
    field = torch.randn((n, 1, *coarse), generator=gen, device=device)
    mode = "bilinear" if len(spatial) == 2 else "trilinear"
    x0 = torch.tanh(F.interpolate(field, size=tuple(spatial), mode=mode, align_corners=False))
    cond = torch.clamp(x0 + LOW_DOSE_NOISE * torch.randn(x0.shape, generator=gen, device=device),
                       -1.0, 1.0)
    return [{"x0": a, "cond": c} for a, c in zip(x0.split(batch), cond.split(batch))]
