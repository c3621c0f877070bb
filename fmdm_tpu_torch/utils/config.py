"""
Config IO, run-dir allocation, seeding and batch-size helpers (counterpart of
``fmdm_tpu/utils/config.py``): ``load_json_config`` records the file's path
under ``__config_path__``, ``allocate_run_dir`` picks the next ``_runN``,
``resolve_batch_size`` honours the ``train_*`` and plain aliases.
"""

from __future__ import annotations

import json
import random
import re
from pathlib import Path
from typing import Optional

import numpy as np
import torch


def load_json_config(path) -> dict:
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Config not found: {path}")
    with path.open("r") as fh:
        cfg = json.load(fh)
    if isinstance(cfg, dict):
        cfg["__config_path__"] = str(path)
    return cfg


def save_json_config(path, cfg: dict) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as fh:
        json.dump(cfg, fh, indent=2)


def allocate_run_dir(base) -> Path:
    """checkpoints/mnist -> checkpoints/mnist_run1, _run2, ..."""
    base = Path(base)
    parent, stem = base.parent, base.name
    parent.mkdir(parents=True, exist_ok=True)
    pattern = re.compile(rf"^{re.escape(stem)}_run(\d+)$")
    existing = [int(m.group(1)) for entry in parent.iterdir() if entry.is_dir()
                for m in [pattern.match(entry.name)] if m]
    return parent / f"{stem}_run{max(existing) + 1 if existing else 1}"


def set_seed(seed: Optional[int]) -> None:
    """Seed Python's, numpy's and torch's global generators. The port's
    sampling and training functions take explicit ``torch.Generator``s and
    draw nothing from these."""
    if seed is None:
        return
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def resolve_batch_size(training_cfg: dict, key: str, fallback: int) -> int:
    alt = key.replace("train_", "") if key.startswith("train_") else key
    value = training_cfg.get(key)
    if value is None:
        value = training_cfg.get(alt, fallback)
    return int(value)


def resolve_string_none(value):
    """Normalize the permissive string "None" convention."""
    if isinstance(value, str) and value.lower() == "none":
        return None
    return value
