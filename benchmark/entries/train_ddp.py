"""
The data-parallel train entry: ``DenoiseTrainStep.step`` of the port over
``chips`` ranks of one host, one card each (NCCL; gloo on the CPU), each
rank feeding ``batch`` rows of a global batch of ``chips x batch``, as
``python -m torch.distributed.run`` runs the port's trainer: each rank
joins through ``maybe_initialize_distributed``, builds its mesh with
``create_data_mesh`` and its step with ``make_denoise_train_step(mesh=)``.

Rank 0 is the harness's process and drives ``entries/train.py``'s loop;
it starts ranks 1 .. chips - 1 as processes of this file. Before each step
rank 0 broadcasts one small command over a gloo group of its own (the host
alone: no stream waits on it), "step" or "exit", and the workers follow.
Every collective has the process group's timeout (``collective_timeout_s``
of the cell, through ``FMDM_DIST_TIMEOUT``), so a rank that hangs fails the
run. Every rank draws the same weights, the same global pool of LDCT-like
batches and each step's global noise and t from the seed, and takes its
rows.

``train_samples_per_s`` counts the global batch. The check compares rank
0's readings (its optimizer's first moment holds the gradient summed over
the ranks, its weights the common ones) with the reference's single-process
steps on the global batch, its loss and gradient summed over blocks of
``batch`` rows.
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

if __name__ == "__main__":   # a worker rank: the checkout's root heads the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import build, inputs  # noqa: E402
from benchmark.entries import Window, train  # noqa: E402
from benchmark.reference import training  # noqa: E402

STEP, EXIT = 1, 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _module_root(name: str) -> str:
    """The directory a worker imports package ``name`` from, as this process does."""
    return str(Path(importlib.import_module(name).__file__).resolve().parents[1])


class Entry(train.Entry):
    rank = 0
    workers: List[subprocess.Popen] = ()

    @property
    def world(self) -> int:
        return int(self.cell["chips"])

    def setup(self) -> None:
        start = time.perf_counter()
        if self.rank == 0:
            self.port = free_port()
            if self.device.type == "cuda":
                from fmdm_tpu_torch.ops.kernels import build as kernels

                kernels.library()   # built once, before the workers load it
            self.workers = [self._start_worker(r) for r in range(1, self.world)]
            try:
                self._join()
            except BaseException:
                for proc in self.workers:
                    proc.kill()
                raise
        else:
            self._join()
        joined = time.perf_counter()
        self._build()
        build.synchronize(self.device)
        built = time.perf_counter()
        if self.rank:
            return
        readings: Dict = {"losses": []}
        for i in range(int(self.cell["checked_steps"])):
            loss_sum, count, fed = self._launch_step()
            self.checked.append(fed)
            readings["losses"].append(float(loss_sum) / max(float(count), 1.0))
            if i == 0:
                readings["first_grad"] = self._first_grad()
        readings["change"] = self._change()
        self.readings = readings
        self.setup_seconds = {"ranks joined": joined - start, "build": built - joined,
                              "checked steps": time.perf_counter() - built}

    def _join(self) -> None:
        """This rank in the process group (torchrun's environment set for
        the call only), its control group and its mesh."""
        import torch.distributed as dist

        from fmdm_tpu_torch.parallel import mesh as mesh_lib

        env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(self.port), "RANK": str(self.rank),
               "LOCAL_RANK": str(self.rank), "WORLD_SIZE": str(self.world),
               "FMDM_DIST_TIMEOUT": str(self.cell["collective_timeout_s"])}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            self.device = mesh_lib.rank_device(None if self.device.type == "cuda" else "cpu")
            mesh_lib.maybe_initialize_distributed(self.device)
            self.control = dist.new_group(backend="gloo", timeout=mesh_lib.timeout())
            self.mesh = mesh_lib.create_data_mesh(int(self.cell["batch"]), self.device)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    def _start_worker(self, rank: int) -> subprocess.Popen:
        args = {"cfg": self.cfg, "cell": self.cell, "seed": self.seed,
                "device": self.device.type, "rank": rank, "port": self.port}
        paths = [_module_root("fmdm_tpu_torch"), _module_root("benchmark")]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            paths + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        return subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                 json.dumps(args)], env=env, stdout=2)

    def _build(self) -> None:
        """The weights, model, optimizer and step of this rank; the global
        pool; the generator of the steps' draws."""
        from fmdm_tpu_torch.schedulers.registry import build_scheduler
        from fmdm_tpu_torch.train.common import make_adamw, make_denoise_train_step

        cfg, cell, dev = self.cfg, self.cell, self.device
        opt = cfg["optimizer"]
        self.weights = build.weights(cfg, self.seed, dev)
        self.model = build.program_model(cfg, self.weights, dev)
        scheduler, _ = build_scheduler(cfg["model"]["scheduler"], {})
        self.optimizer, rate = make_adamw(self.model.parameters(), opt["learning_rate"],
                                          opt["weight_decay"], opt["lr_warmup_steps"],
                                          opt["num_training_steps"])
        self.trainer = make_denoise_train_step(
            self.model, scheduler, self.optimizer, rate, variant=cfg["variant"],
            conditioning_mode=cfg["conditioning"], latent_norm=None,
            compute_dtype=build.DTYPES[cfg["compute_dtype"]], device=dev, mesh=self.mesh)
        self.trainer.global_step = int(opt["start_step"])
        rows = int(cell["batch"])
        self.pool = inputs.ldct_pool(cell["pool_batches"], rows * self.world, cfg["spatial"],
                                     self.seed, dev)
        self.rows = slice(self.rank * rows, (self.rank + 1) * rows)
        self.valid = torch.ones((rows,), device=dev)
        self.gen = inputs.generator(self.seed, 2, dev)
        self.checked = []

    def _command(self, command: Optional[int] = None) -> int:
        """Rank 0 sends ``command``; every other rank receives it."""
        import torch.distributed as dist

        box = torch.tensor([STEP if command is None else command], dtype=torch.int64)
        dist.broadcast(box, src=0, group=self.control)
        return int(box)

    def _launch_step(self):
        """One step of every rank on the next global pool batch, with new
        noise and t; returns (loss_sum, count) over the ranks and the global
        feed."""
        if self.rank == 0:
            self._command(STEP)
        b = self.pool[self.steps % len(self.pool)]
        noise = torch.randn(b["x0"].shape, generator=self.gen, device=self.device)
        if self.cfg["variant"] == "diffusion":
            t = torch.randint(0, int(self.cfg["model"]["scheduler"]["num_train_timesteps"]),
                              (noise.shape[0],), generator=self.gen, device=self.device)
        else:
            t = torch.rand((noise.shape[0],), generator=self.gen, device=self.device)
        r = self.rows
        loss_sum, count = self.trainer.step(
            {"target": b["x0"][r], "image": b["cond"][r], "valid": self.valid},
            noise=noise[r], t=t[r])
        self.steps += 1
        return loss_sum, count, {"x0": b["x0"], "cond": b["cond"], "noise": noise, "t": t}

    def serve(self) -> None:
        """A worker's loop: a step per "step", until "exit"."""
        while self._command() == STEP:
            self._launch_step()
        build.synchronize(self.device)

    def window(self, seconds: Optional[float] = None, units: Optional[int] = None) -> Window:
        out = super().window(seconds=seconds, units=units)
        out.end_to_end["train_samples_per_s"] *= self.world
        return out

    def release(self) -> None:
        """The workers sent home, the groups closed on every rank together
        (NCCL's shutdown waits for every rank, so rank 0 closes before it
        waits for the workers), the workers waited for, this rank's program
        freed."""
        import torch.distributed as dist

        self._command(EXIT)
        dist.destroy_process_group()
        for proc in self.workers:
            if proc.wait(timeout=float(self.cell["collective_timeout_s"])) != 0:
                raise RuntimeError(f"a worker rank exited with {proc.returncode}")
        super().release()

    def reference_readings(self, precision: str = "f32", half_batch: bool = False) -> dict:
        """The reference's steps on the global batches (``half_batch``: their
        first halves), each step's loss and gradient summed over blocks of
        ``batch`` rows, each block weighted by its share of the rows."""
        cfg, opt = self.cfg, self.cfg["optimizer"]
        if self.device.type == "cuda":
            build.f32_reference_numerics()
        model = build.reference_model(cfg, self.weights, self.device, precision)
        feed = self.checked if not half_batch else [
            {k: v[: v.shape[0] // 2] for k, v in b.items()} for b in self.checked]
        params = dict(model.named_parameters())
        start = {k: p.detach().clone() for k, p in params.items()}
        adam = training.AdamW(params, opt["weight_decay"])
        block = int(self.cell["batch"])
        losses, first_grad = [], {}
        for i, b in enumerate(feed):
            for p in params.values():
                p.grad = None
            rows = b["x0"].shape[0]
            total = 0.0
            for lo in range(0, rows, block):
                part = {k: v[lo:lo + block] for k, v in b.items()}
                share = part["x0"].shape[0] / rows
                loss = training.denoise_loss(model, cfg["variant"], part["x0"], part["cond"],
                                             part["noise"], part["t"]) * share
                loss.backward()
                total += loss.detach().item()
            losses.append(total)
            if i == 0:
                first_grad = {k: float(p.grad.norm()) if p.grad is not None else 0.0
                              for k, p in params.items()}
            adam.step(training.cosine_rate(int(opt["start_step"]) + i, opt["learning_rate"],
                                           opt["lr_warmup_steps"], opt["num_training_steps"]))
        change = {k: float((p.detach() - start[k]).norm()) for k, p in params.items()}
        del model
        gc.collect()
        return {"losses": losses, "first_grad": first_grad, "change": change,
                "sizes": {k: p.numel() for k, p in params.items()}}


def worker(args: dict) -> int:
    torch.set_num_threads(2)
    entry = Entry(args["cfg"], args["cell"], args["seed"], args["device"])
    entry.rank, entry.port = int(args["rank"]), int(args["port"])
    entry.setup()
    entry.serve()
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(worker(json.loads(sys.argv[1])))
