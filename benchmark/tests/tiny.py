"""A copy of the benchmark with tiny cells beside the real ones, for the CPU
tests: the same reference, entries and readers at widths a test run holds.

``tiny_root(tmp)`` copies ``BENCHMARK.json`` and ``benchmark/`` into ``tmp``
and adds the configurations ``tiny2d`` and ``tiny3d`` and the cells
``tiny2d_train``, ``tiny3d_train``, ``tiny2d_sample`` and ``tiny3d_sample``
(batch 4, 16x16 slices or 4x8x8 volumes, 4 sampling steps) with limits set
from the program's readings at that size on the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]

TINY_UNETS = {
    "tiny2d": ("ldct_unet2d_flow", {"block_out_channels": [32, 32, 64], "layers_per_block": 1,
                                    "down_block_types": ["DownBlock2D", "AttnDownBlock2D",
                                                         "DownBlock2D"],
                                    "up_block_types": ["UpBlock2D", "AttnUpBlock2D",
                                                       "UpBlock2D"]}, [16, 16]),
    "tiny3d": ("volume3d_efficientunet", {"model_channels": 32, "num_res_blocks": 1,
                                          "channel_mult": [1, 2], "attention_resolutions": [2],
                                          "num_heads": 2, "dim_head": 8}, [4, 8, 8]),
}
# the program's readings at these sizes on the CPU (bf16 against the f32
# reference) stay under a third of these limits
TINY_LIMITS = {"train": {"grad_gap": 0.06, "change_gap": 0.15},
               "sample": {"sample_err": 0.015}}
TINY_CELLS = {"tiny2d_train": ("unet2d_flow_train_b16", "tiny2d"),
              "tiny3d_train": ("volume3d_train_b4", "tiny3d"),
              "tiny2d_sample": ("unet2d_flow_sample_b32", "tiny2d"),
              "tiny3d_sample": ("volume3d_sample_b8", "tiny3d")}


def tiny_root(tmp: Path) -> Path:
    root = Path(tmp) / "checkout"
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    bdir = root / "benchmark"
    for name, (base, unet, spatial) in TINY_UNETS.items():
        cfg = json.loads((bdir / "configs" / f"{base}.json").read_text())
        cfg["model"]["unet"].update(unet)
        cfg["spatial"] = spatial
        (bdir / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, (base, cfg) in TINY_CELLS.items():
        cell = json.loads((bdir / "workloads" / f"{base}.json").read_text())
        cell.update(config=cfg, batch=4, judged_rows=2, trace_units=2,
                    limits=TINY_LIMITS[cell["entry"]])
        if "steps" in cell:
            cell["steps"] = 4
        (bdir / "workloads" / f"{name}.json").write_text(json.dumps(cell))
        spec["workloads"].append({"name": name, "config": cfg, "traffic": cell["traffic"],
                                  "chips": 1, "why": "a tiny copy for the CPU tests"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if base in m.get("workloads", []):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def run_tiny(root: Path, cell: str, seed: int = 4_000_000_123, seconds: float = 0.5,
             trace: bool = False) -> dict:
    from benchmark import harness

    torch.manual_seed(0)
    return harness.run_cell(root, cell, seed, seconds, trace, device="cpu")
