"""The loops that drive one entry of the program over a run's window, one
module per entry kind (``<kind>.py`` with a class ``Entry``, a subclass of
``BaseEntry``): ``setup`` (after it, ``setup_seconds`` names its parts),
``window``, ``failed`` (units of the window whose output is not finite,
read after it), ``release``, ``numbers`` (the compared numbers), and what
the per-layer readers count the work of a unit by: ``train``,
``forwards_per_unit`` and ``ops``."""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from benchmark import counters
from benchmark.reference.ops import Op


@dataclasses.dataclass
class Window:
    units: int                      # steps or calls completed
    seconds: float                  # host seconds, ending on a synchronize
    failed: int                     # units whose output is not finite
    end_to_end: Dict[str, float]    # the entry's end-to-end metrics
    notes: Dict[str, float] = dataclasses.field(default_factory=dict)   # printed, not reported


class BaseEntry:
    train = False    # a unit runs the backward of its forwards too

    def __init__(self, cfg: dict, cell: dict, seed: int, device):
        self.cfg, self.cell, self.seed, self.device = cfg, cell, seed, torch.device(device)

    @property
    def forwards_per_unit(self) -> int:
        return 1

    def ops(self) -> List[Op]:
        """The products and GroupNorms of one forward at the cell's batch,
        counted on the reference's shapes."""
        return counters.record_forward(self.cfg, int(self.cell["batch"]), self.train)
