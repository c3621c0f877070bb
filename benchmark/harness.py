"""
One run of one cell: what ``benchmark/run.py`` does after parsing its
arguments.

Everything is found by name from ``BENCHMARK.json`` at the checkout's root:
the cell's file ``benchmark/workloads/<cell>.json`` names its configuration
(``benchmark/configs/<config>.json``, with the reference model beside it in
``benchmark/reference/``) and its entry kind (``benchmark/entries/<kind>.py``);
each per-layer metric ``<stem>.<suffix>`` is read by
``benchmark/metrics/<stem>.py``. Adding a cell, a configuration, an entry
kind or a metric adds files and entries and edits none.

A run: set-up (the entry's, counted in ``setup_s`` from the process's start),
the window (``--seconds``), with ``--trace 1`` then ``trace_units`` steps or
calls under ``torch.profiler``, the peak memory read, the program's state
freed, the reference's comparison, the check that no JAX module was loaded,
and the result's line.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from benchmark import compare, guard
from benchmark.reference.ops import Op


@dataclasses.dataclass
class TraceReading:
    """What a per-layer metric's reader is given: the untraced window, the
    traced one, and the cell's work counted on the reference's shapes."""

    train: bool                   # a unit runs the backward of its forwards
    forwards_per_unit: int        # model forwards per unit (step or call)
    timed_units: int              # units of the untraced window
    timed_s: float                # its host seconds
    units: int                    # units traced
    window_s: float               # the traced window's host seconds
    busy_s: float
    kernel_s: Dict[str, float]    # device seconds per kernel name
    class_s: Dict[str, float]     # device seconds per kernel class (devtrace.classify)
    ops: List[Op]                 # one forward at the cell's batch
    dtype: str
    peak_bytes: int               # max_memory_allocated over both windows


def read_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.spec = read_json(self.root / "BENCHMARK.json")
        self.dir = self.root / "benchmark"

    def cell(self, name: str) -> dict:
        listed = {w["name"]: w for w in self.spec["workloads"]}
        if name not in listed:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        cell = read_json(self.dir / "workloads" / f"{name}.json")
        cell["name"] = name
        return cell

    def config(self, name: str) -> dict:
        return read_json(self.dir / "configs" / f"{name}.json")

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.spec["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        return [m for m in self.spec["per_layer"] if cell in m["workloads"]]

    def _load(self, sub: str, stem: str):
        path = self.dir / sub / f"{stem}.py"
        if not path.exists():
            raise FileNotFoundError(f"no {path}")
        spec = importlib.util.spec_from_file_location(
            f"benchmark_{sub}_" + stem.replace("-", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def reader(self, metric: str):
        """The module that reads ``metric``: ``metrics/<stem>.py`` for the
        name ``<stem>.<suffix>``."""
        return self._load("metrics", metric.split(".", 1)[0])

    def entry(self, kind: str):
        """The class ``Entry`` of ``entries/<kind>.py``."""
        return self._load("entries", kind).Entry


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: Optional[float] = None) -> dict:
    """One run of cell ``name``; returns the result's line as a dict, the
    compared numbers last under ``checks``."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = Bench(root)
    cell = bench.cell(name)
    cfg = bench.config(cell["config"])
    cuda = torch.device(device).type == "cuda"
    entry = bench.entry(cell["entry"])(cfg, cell, seed, device)
    t_entry = time.perf_counter()
    entry.setup()
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    print(f"set-up {setup_s:.3f} s: {t_entry - t_start:.3f} s to the entry's set-up, then "
          + ", ".join(f"{k} {v:.3f} s" for k, v in entry.setup_seconds.items()), file=sys.stderr)

    timed = entry.window(seconds=seconds)
    timed.failed = entry.failed(timed)
    print(f"window {timed.units} units in {timed.seconds:.3f} s: "
          + ", ".join(f"{k} {v:.4f}" for k, v in timed.notes.items()), file=sys.stderr)
    windows = [timed]
    prof = None
    if trace:
        # then the traced window, the device's activity only: on one H100,
        # recording every host op too slowed the flagship's traced train
        # step from 452 to 500 ms (388 ms untraced)
        activity = torch.profiler.ProfilerActivity.CUDA if cuda else \
            torch.profiler.ProfilerActivity.CPU
        with torch.profiler.profile(activities=[activity]) as prof:
            traced = entry.window(units=int(cell["trace_units"]))
        traced.failed = entry.failed(traced)
        windows.append(traced)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    memory_peak = max(setup_peak, peak) if cuda else 0
    entry.release()

    metrics: Dict[str, dict] = {}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name() if cuda else "cpu",
                   "count": int(cell["chips"]), "memory_peak_bytes": int(memory_peak)}
    if cuda:
        device_info["power_limit_w"] = power_limit_w()
    breakdown = None
    if trace:
        from benchmark.devtrace import Trace

        tr = Trace(prof)
        busy = tr.device_busy_s()
        device_info.update(busy_s=busy, window_s=traced.seconds)
        breakdown = tr.breakdown(traced.seconds)
        reading = TraceReading(train=entry.train, forwards_per_unit=entry.forwards_per_unit,
                               timed_units=timed.units, timed_s=timed.seconds,
                               units=traced.units, window_s=traced.seconds, busy_s=busy,
                               kernel_s=tr.kernel_seconds(), class_s=tr.class_seconds(),
                               ops=entry.ops(), dtype=cfg["compute_dtype"], peak_bytes=int(peak))
        for m in bench.per_layer(name):
            value = bench.reader(m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(timed.end_to_end, setup_s=setup_s)
        for m in bench.end_to_end(name):
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}

    checks = compare.checks(entry.numbers(), cell["limits"])
    failed = sum(w.failed for w in windows)
    line = {"correct": all(c.ok for c in checks) and failed == 0,
            "attempted": sum(w.units for w in windows), "failed": failed, "metrics": metrics,
            "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return line


def main(root: Path, args, t_start: float) -> int:
    """The command line's run: the card first, the guard last."""
    bench = Bench(root)
    chips = int(bench.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    line = run_cell(root, args.workload, args.seed, float(args.seconds), bool(args.trace),
                    device="cuda", t_start=t_start)
    bad = guard.forbidden_modules()
    if bad:
        print(f"the run loaded modules of JAX or of the JAX package: {bad}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
