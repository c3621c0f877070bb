"""
The comparisons that decide ``correct``. Each compared number has its
limit in the cell's workload file (``limits``); a number that is not
finite, or above its limit, makes the run not correct.

Train cells (the program's first three steps against the reference's from
the same weights on the same batches, noise and t):

- ``loss_gap``: |loss - reference loss| / |reference loss| of the first
  step, read and not compared: on the H100 the fp8 control and a half
  batch read about what the program's bf16 reads (no upper reading). The later
  steps' losses carry more noise: Adam's first update moves every weight
  by the rate whatever its gradient, so weights whose gradient is at
  rounding level take either sign in bf16;
- ``grad_gap``: the first gradient's norm per parameter, the program's read
  from its optimizer's first moment after one step (m = (1 - b1) g):
  the worst |norm - reference norm| over the larger of the reference norm
  and the median parameter's, over the parameters of more than one
  element. The one-element bias of the one-channel output conv is left
  out: its gradient is the batch's mean residual, a sum that nearly
  cancels, and the bf16 prediction's own offset moved it by up to 23% of
  itself on sound seeds;
- ``change_gap``: the same of each parameter's change over the steps,
  leaving out also the parameters whose reference gradient is under a
  thousandth of the median parameter's (they move under Adam by rounding
  alone, as a key's bias under softmax does).

Sample cells (rows of one finished call against the reference's sample
from the same noise and conditioning):

- ``sample_err``: the worst row's ||x - reference|| / ||reference||.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import torch

from benchmark.reference.training import median

GRAD_FLOOR = 1e-3   # of the median parameter's reference gradient


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def _worst(got: Dict[str, float], ref: Dict[str, float], names) -> float:
    names = list(names)
    floor = median(ref[n] for n in names)
    return max(abs(got[n] - ref[n]) / max(ref[n], floor, 1e-30) for n in names)


def worst_leaves(got: Dict[str, float], ref: Dict[str, float], names, top: int = 5) -> list:
    """The ``top`` parameters by gap, as (gap, name, program norm, reference
    norm), for looking into a reading."""
    names = list(names)
    floor = median(ref[n] for n in names)
    gaps = [(abs(got[n] - ref[n]) / max(ref[n], floor, 1e-30), n, got[n], ref[n]) for n in names]
    return sorted(gaps, reverse=True)[:top]


def train_numbers(got: dict, ref: dict) -> Dict[str, float]:
    """The compared numbers of a train cell (``got`` the program's readings,
    ``ref`` the reference's; ``ref["sizes"]`` the parameters' element
    counts)."""
    loss_gap = abs(got["losses"][0] - ref["losses"][0]) / max(abs(ref["losses"][0]), 1e-30)
    names = [n for n in ref["first_grad"] if ref["sizes"][n] > 1]
    grad_gap = _worst(got["first_grad"], ref["first_grad"], names)
    floor = GRAD_FLOOR * median(ref["first_grad"][n] for n in ref["first_grad"])
    moved = [n for n in names if ref["first_grad"][n] >= floor]
    change_gap = _worst(got["change"], ref["change"], moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}


def sample_numbers(got: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    got, ref = got.float().flatten(1), ref.float().flatten(1)
    err = (got - ref).norm(dim=1) / ref.norm(dim=1).clamp(min=1e-30)
    return {"sample_err": float(err.max())}


def checks(numbers: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"the comparison gives no {sorted(missing)}")
    return [Check(name, float(numbers[name]), float(limits[name])) for name in limits]
