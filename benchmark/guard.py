"""
The check that a run loaded no JAX and no module of the JAX package.
Module names are compared by their top-level name (the part before the
first dot) as a whole word, so ``fmdm_tpu_torch`` is not ``fmdm_tpu``.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "fmdm_tpu")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    names = list(sys.modules) if names is None else names
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})
