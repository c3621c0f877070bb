"""
The sample entry: ``SamplingEngine.__call__`` of the port
(``fmdm_tpu_torch/sample/engine.py``), called back to back by one caller,
as ``evaluate`` calls it. Every call starts from a new noise draw and takes
the next conditioning batch of the pool. The model computes in the
configuration's dtype (the engine is handed the model already in it), the
scheduler in f32.

Set-up warms the cell's shapes with one short call (the first
``warm_steps`` timesteps through the same model and scheduler), not a
whole call. After the window one finished call, drawn from the seed, is
judged: rows drawn from the seed, one from each equal slice of the batch,
against the reference sampler from the same noise and conditioning.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import build, compare, inputs
from benchmark.entries import BaseEntry, Window
from benchmark.reference import sampling


class Entry(BaseEntry):
    kind = "sample"

    def __init__(self, cfg: dict, cell: dict, seed: int, device):
        super().__init__(cfg, cell, seed, device)
        self.calls: List[tuple] = []

    @property
    def forwards_per_unit(self) -> int:
        return int(self.cell["steps"])

    def setup(self) -> None:
        from fmdm_tpu_torch.sample.engine import SamplingEngine
        from fmdm_tpu_torch.schedulers.registry import build_scheduler

        cfg, cell, dev = self.cfg, self.cell, self.device
        start = time.perf_counter()
        dtype = build.DTYPES[cfg["compute_dtype"]]
        self.weights = build.weights(cfg, self.seed, dev)
        self.model = build.program_model(cfg, self.weights, dev).to(dtype)
        scheduler, _ = build_scheduler(cell["scheduler"], {})
        timesteps = scheduler.set_timesteps(int(cell["steps"]))
        self.shape = (int(cell["batch"]), int(cfg["channels"]), *cfg["spatial"])
        self.pool = inputs.ldct_pool(cell["pool_batches"], cell["batch"], cfg["spatial"],
                                     self.seed, dev)
        self.gen = inputs.generator(self.seed, 2, dev)
        build.synchronize(dev)
        built = time.perf_counter()
        kw = dict(conditioning_mode=cfg["conditioning"], compute_dtype=dtype, device=dev)
        warm = SamplingEngine(self.model, scheduler, timesteps[: int(cell["warm_steps"])], **kw)
        warm(self.shape, conditioning_batch=self.pool[0]["cond"],
             init_sample=torch.randn(self.shape, generator=inputs.generator(self.seed, 3, dev),
                                     device=dev))
        del warm
        self.engine = SamplingEngine(self.model, scheduler, timesteps, **kw)
        self.setup_seconds = {"build": built - start, "warm-up call": time.perf_counter() - built}

    def window(self, seconds: Optional[float] = None, units: Optional[int] = None) -> Window:
        """Whole calls until ``seconds`` have passed (or ``units`` calls)."""
        build.synchronize(self.device)
        start = time.perf_counter()
        n = 0
        while True:
            noise = torch.randn(self.shape, generator=self.gen, device=self.device)
            slot = len(self.calls) % len(self.pool)
            out = self.engine(self.shape, conditioning_batch=self.pool[slot]["cond"],
                              init_sample=noise)
            self.calls.append((noise, slot, out))
            n += 1
            if (n >= units) if units else (time.perf_counter() - start >= seconds):
                break
        build.synchronize(self.device)
        elapsed = time.perf_counter() - start
        work = n * int(self.cell["steps"]) * self.shape[0]
        return Window(units=n, seconds=elapsed, failed=0,
                      end_to_end={"denoise_steps_per_s": work / elapsed})

    def failed(self, window: Window) -> int:
        """Calls of the window whose sample is not finite (read after it)."""
        return sum(int(not torch.isfinite(out).all())
                   for _, _, out in self.calls[-window.units:])

    def release(self) -> None:
        del self.engine, self.model
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judged(self):
        """(call index, rows) drawn from the seed among the finished calls."""
        rng = np.random.RandomState(self.seed % 2**32)
        call = int(rng.randint(len(self.calls)))
        k, b = int(self.cell["judged_rows"]), self.shape[0]
        edges = np.linspace(0, b, k + 1).astype(int)
        rows = [int(rng.randint(lo, hi)) for lo, hi in zip(edges[:-1], edges[1:])]
        return call, rows

    def reference_rows(self, call: int, rows, precision: str = "f32") -> torch.Tensor:
        noise, slot, _ = self.calls[call]
        if self.device.type == "cuda":
            build.f32_reference_numerics()
        model = build.reference_model(self.cfg, self.weights, self.device, precision)
        sampler = sampling.SAMPLERS[self.cell["reference_sampler"]]
        with torch.no_grad():
            out = sampler(model, noise[rows], self.pool[slot]["cond"][rows], int(self.cell["steps"]))
        del model
        return out

    def numbers(self) -> Dict[str, float]:
        call, rows = self.judged()
        got = self.calls[call][2][rows]
        return compare.sample_numbers(got, self.reference_rows(call, rows))
