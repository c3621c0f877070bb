"""
The train entry: ``DenoiseTrainStep.step`` of the port
(``fmdm_tpu_torch/train/common.py``), driven as ``denoise_lib``'s loop
drives it: one caller, one step in flight (step i - 1's loss is read while
step i runs), batches already on the device.

Set-up builds the one train step object (the model with the run's weights,
AdamW past its warm-up at the configuration's rate, the scheduler) and
runs its first ``checked_steps`` steps through the window's own call and
feed, on pool batches that all differ. It keeps what the check compares:
each step's loss, each parameter's first gradient as the optimizer holds
it after one step, and each parameter's change over those steps. The same
object then runs the window. Every step draws new noise and t.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import build, compare, inputs
from benchmark.entries import BaseEntry, Window
from benchmark.reference import training

BETA1 = training.BETAS[0]


class Entry(BaseEntry):
    kind = "train"
    train = True

    def __init__(self, cfg: dict, cell: dict, seed: int, device):
        super().__init__(cfg, cell, seed, device)
        self.steps = 0

    def setup(self) -> None:
        from fmdm_tpu_torch.schedulers.registry import build_scheduler
        from fmdm_tpu_torch.train.common import make_adamw, make_denoise_train_step

        cfg, cell, dev = self.cfg, self.cell, self.device
        opt = cfg["optimizer"]
        start = time.perf_counter()
        self.weights = build.weights(cfg, self.seed, dev)
        self.model = build.program_model(cfg, self.weights, dev)
        scheduler, _ = build_scheduler(cfg["model"]["scheduler"], {})
        optimizer, rate = make_adamw(self.model.parameters(), opt["learning_rate"],
                                     opt["weight_decay"], opt["lr_warmup_steps"],
                                     opt["num_training_steps"])
        self.optimizer = optimizer
        self.trainer = make_denoise_train_step(
            self.model, scheduler, optimizer, rate, variant=cfg["variant"],
            conditioning_mode=cfg["conditioning"], latent_norm=None,
            compute_dtype=build.DTYPES[cfg["compute_dtype"]], device=dev)
        self.trainer.global_step = int(opt["start_step"])
        self.pool = inputs.ldct_pool(cell["pool_batches"], cell["batch"], cfg["spatial"],
                                     self.seed, dev)
        self.valid = torch.ones((cell["batch"],), device=dev)
        self.gen = inputs.generator(self.seed, 2, dev)
        self.checked: List[Dict[str, torch.Tensor]] = []
        build.synchronize(dev)
        built = time.perf_counter()
        readings: Dict = {"losses": []}
        for i in range(int(cell["checked_steps"])):
            loss_sum, count, fed = self._launch_step()
            self.checked.append(fed)
            readings["losses"].append(float(loss_sum) / max(float(count), 1.0))
            if i == 0:
                readings["first_grad"] = self._first_grad()
        readings["change"] = self._change()
        self.readings = readings
        self.setup_seconds = {"build": built - start,
                              "checked steps": time.perf_counter() - built}

    def _launch_step(self):
        """One step of the window's loop on the next pool batch, with new
        noise and t; returns its (loss_sum, count) and what it was fed."""
        b = self.pool[self.steps % len(self.pool)]
        rows = b["x0"].shape[0]
        noise = torch.randn(b["x0"].shape, generator=self.gen, device=self.device)
        if self.cfg["variant"] == "diffusion":
            t = torch.randint(0, int(self.cfg["model"]["scheduler"]["num_train_timesteps"]),
                              (rows,), generator=self.gen, device=self.device)
        else:
            t = torch.rand((rows,), generator=self.gen, device=self.device)
        loss_sum, count = self.trainer.step(
            {"target": b["x0"], "image": b["cond"], "valid": self.valid}, noise=noise, t=t)
        self.steps += 1
        return loss_sum, count, {"x0": b["x0"], "cond": b["cond"], "noise": noise, "t": t}

    def _first_grad(self) -> Dict[str, float]:
        names, norms = [], []
        for name, p in self.model.named_parameters():
            state = self.optimizer.state.get(p, {})
            names.append(name)
            norms.append(state["exp_avg"].norm() / (1 - BETA1) if "exp_avg" in state
                         else torch.zeros((), device=self.device))
        return dict(zip(names, torch.stack(norms).tolist()))

    def _change(self) -> Dict[str, float]:
        named = list(self.model.named_parameters())
        norms = torch.stack([(p.detach() - self.weights[n]).norm() for n, p in named])
        return dict(zip([n for n, _ in named], norms.tolist()))

    def window(self, seconds: Optional[float] = None, units: Optional[int] = None) -> Window:
        """Steps until ``seconds`` have passed at a loss read (or ``units``
        steps); each step timed as the interval between consecutive reads."""
        build.synchronize(self.device)
        start = time.perf_counter()
        reads: List[float] = []
        losses: List[float] = []
        pending = None
        n = 0
        while True:
            loss_sum, count, _ = self._launch_step()
            n += 1
            if pending is not None:
                losses.append(float(pending[0]) / max(float(pending[1]), 1.0))
                reads.append(time.perf_counter())
            pending = (loss_sum, count)
            if (n >= units) if units else (reads and reads[-1] - start >= seconds):
                break
        losses.append(float(pending[0]) / max(float(pending[1]), 1.0))
        build.synchronize(self.device)
        elapsed = time.perf_counter() - start
        batch = int(self.cell["batch"])
        intervals = np.diff(reads) if len(reads) > 1 else np.array([elapsed / n])
        # how the pace moves inside the window: step intervals' quartiles,
        # and the rate over each third of the steps
        notes = {f"step_ms_p{q}": float(np.percentile(intervals, q)) * 1e3 for q in (25, 50, 75)}
        notes.update({f"samples_per_s_third{i + 1}": batch / float(part.mean())
                      for i, part in enumerate(np.array_split(intervals, 3)) if len(part)})
        return Window(units=n, seconds=elapsed, failed=sum(not math.isfinite(x) for x in losses),
                      end_to_end={"train_samples_per_s": n * batch / elapsed,
                                  "train_step_ms_p90": float(np.percentile(intervals, 90)) * 1e3},
                      notes=notes)

    def failed(self, window: Window) -> int:
        return window.failed

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        del self.trainer, self.model, self.optimizer
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_readings(self, precision: str = "f32", half_batch: bool = False) -> dict:
        """The reference's readings of the checked steps from the same
        weights and feed; ``half_batch`` feeds it the first half of each
        batch only (a fault the check must catch)."""
        cfg, opt = self.cfg, self.cfg["optimizer"]
        if self.device.type == "cuda":
            build.f32_reference_numerics()
        model = build.reference_model(cfg, self.weights, self.device, precision)
        feed = self.checked if not half_batch else [
            {k: v[: v.shape[0] // 2] for k, v in b.items()} for b in self.checked]
        out = training.train_steps(model, cfg["variant"], feed, base_lr=opt["learning_rate"],
                                   weight_decay=opt["weight_decay"],
                                   warmup=opt["lr_warmup_steps"],
                                   total=opt["num_training_steps"],
                                   start_step=int(opt["start_step"]))
        del model
        return out

    def numbers(self) -> Dict[str, float]:
        return compare.train_numbers(self.readings, self.reference_readings())
