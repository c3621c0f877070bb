"""
The denoising train step of the diffusion and flow-matching UNets and its
optimizer (counterpart of ``fmdm_tpu/train/common.py:30-46,189-332``), the
host-side batching of the training loops (``:53-186``), the start-up
micro-batch tuning (``:346-397``) and the helpers the denoise and VAE run
loops share (run dir, host batches, resume path, the generator's state in
a checkpoint, the first epoch's profile).

One step on a batch ``{"target", "image", "valid"}`` (x0, the conditioning
images or None, the (B,) validity mask):

- the batch is cut into ``n_chunks = ceil(B / chunk)`` chunks of
  ``chunk = ceil(B / grad_accum)`` rows; the last is padded with zero rows
  of valid 0;
- per chunk, diffusion draws t ~ U{0..N-1}, noises x0 with the scheduler's
  ``add_noise`` and regresses the noise; flow matching draws t ~ U(0, 1)
  (``t_sampling`` "uniform") or sigmoid(N(0, 1)) (``t_sampling``
  "logit_normal", Esser et al.'s rf/lognorm(0.00, 1.00)), takes
  x_t = (1 - t) x0 + t eps, regresses eps - x0 and gives the model
  (t (N - 1)) truncated to int32 (``timestep_input`` "discrete") or the
  continuous t N (``timestep_input`` "continuous", as Stable Diffusion 3);
- the loss is the per-sample mean of squares of the f32 prediction's error,
  summed over the valid rows (``loss_sum``) and divided by max(count, 1);
  with one chunk its gradient is applied as it is, with several each
  chunk's gradient is weighted by its count and the sum divided by
  max(total count, 1);
- ``torch.optim.AdamW`` (b1 0.9, b2 0.999, eps 1e-8, decoupled decay on
  every parameter) applies it at the rate of the step's schedule, which is
  ``optax.adamw``'s update; then the EMA shadow weights, if any, follow
  ``e += (1 - decay) (p - e)``.

The conditioning is the batch's ``image`` (``conditioning_mode``
"concatenate": stacked on the model's input channels; "attention": the
cross-attention context), or its ``text``, a pair (tokens (B, S, D),
pooled (B, P)) handed to the model as ``context_ca`` ("text": Stable
Diffusion 3's transformer). Noise and t are drawn from a
``torch.Generator`` on the step's device, or given as tensors covering the
padded batch. ``remat`` recomputes the model's
forward in the backward (``torch.utils.checkpoint``), as ``jax.checkpoint``
does. On CUDA the UNet's forward runs K1 and K2; K1's backward is a kernel
too, K2's the autograd of its plain version, as in JAX.

Over P ranks (``mesh``, one rank per card under ``torchrun``) one step is
one step of one process on the global batch, the ranks' batches
concatenated in rank order, as JAX's global mesh makes it: the valid count
is summed over the ranks first, each rank backpropagates its chunks' loss
sums divided by the global count, and the gradients are summed over the
ranks (one all-reduce per dtype of a flat buffer, the span
``train.allreduce``), so unequal valid counts
(a ragged last batch) weigh each sample once. Each rank draws the global
chunk's noise and t from its generator, seeded alike on every rank, and
keeps its own rows; ``(loss_sum, count)`` are the global ones on every
rank. Gradient accumulation chunks each rank's local batch: the summed
gradient is the same, but the chunk boundaries (and so the draws of a
step with several chunks) are per rank.

The trainers choose among JAX's parallel strategies in one place
(:func:`parallel_plan`, JAX ``train/denoise_lib.py:132-188`` and
``train/vae_impl.py:232-283``): sequence parallelism (the ring at the
attention, the batch over every rank), tensor parallelism with or without
FSDP, FSDP, or plain data parallelism. A :class:`ParallelPlan` cuts the
model, its optimizer's moments and the EMA after the run has loaded what it
resumes from (:meth:`ParallelPlan.shard`), and gathers them whole for a
checkpoint (:meth:`ParallelPlan.full_model_state`): one checkpoint file
loads in both packages, whatever the strategy. The start-up trial runs on
the whole model, before it is cut, with no collective and no ring, and only
where the plan does not cut the model (:func:`tune_grad_accum`).
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from fmdm_tpu_torch.device import DeviceArg, resolve_device
from fmdm_tpu_torch.parallel import mesh as mesh_lib
from fmdm_tpu_torch.sample.engine import (map_conditioning, normalize_latent_conditioning,
                                          prepare_attention_context)
from fmdm_tpu_torch.schedulers.base import Scheduler
from fmdm_tpu_torch.utils import config as config_utils
from fmdm_tpu_torch.utils import trace

VARIANTS = ("diffusion", "flow_matching")
T_SAMPLINGS = ("uniform", "logit_normal")
TIMESTEP_INPUTS = ("discrete", "continuous")


def cosine_warmup_schedule(base_lr: float, num_warmup_steps: int,
                           num_training_steps: int) -> Callable[[int], float]:
    """Per-step rate of diffusers' ``get_cosine_schedule_with_warmup``: linear
    from 0 over the warmup, then half a cosine down to 0."""

    def schedule(step: int) -> float:
        if step < num_warmup_steps:
            return base_lr * step / max(1.0, num_warmup_steps)
        progress = (step - num_warmup_steps) / max(1.0, num_training_steps - num_warmup_steps)
        return base_lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * progress)))

    return schedule


def make_adamw(params: Iterable[nn.Parameter], base_lr: float, weight_decay: float,
               num_warmup_steps: int, num_training_steps: int):
    """``torch.optim.AdamW`` with torch's defaults (decay on every parameter)
    and its cosine-warmup rate: (optimizer, schedule)."""
    optimizer = torch.optim.AdamW(params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=weight_decay)
    return optimizer, cosine_warmup_schedule(base_lr, num_warmup_steps, num_training_steps)


# ---------------------------------------------------------------------------
# Host-side batching
# ---------------------------------------------------------------------------

def _stack_key(samples: List[dict], key: str) -> Optional[np.ndarray]:
    values = [s.get(key) for s in samples]
    if any(v is None for v in values):
        return None
    return np.stack([np.asarray(v, dtype=np.float32) for v in values], axis=0)


def _finalize(samples: List[dict], batch_size: int, pad_to_full: bool) -> Dict[str, Optional[np.ndarray]]:
    """Stack samples into ``{"target", "image", "valid"}``; a short batch is
    edge-padded (its last sample repeated) to ``batch_size`` with ``valid``
    0 on the padding rows."""
    target = _stack_key(samples, "target")
    image = _stack_key(samples, "image")
    valid = np.ones((len(samples),), dtype=np.float32)
    if pad_to_full and len(samples) < batch_size:
        pad = batch_size - len(samples)
        target = np.concatenate([target, np.repeat(target[-1:], pad, axis=0)], axis=0)
        if image is not None:
            image = np.concatenate([image, np.repeat(image[-1:], pad, axis=0)], axis=0)
        valid = np.concatenate([valid, np.zeros((pad,), np.float32)])
    return {"target": target, "image": image, "valid": valid}


def prefetch(iterator, depth: int = 2):
    """Run ``iterator`` on a background thread, ``depth`` items ahead, so
    sample loading and stacking overlap the card's work. An exception of the
    producer is raised in the consumer."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    err: list = []

    def producer():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as exc:  # propagate into the consumer
            err.append(exc)
        finally:
            q.put(sentinel)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item


def _default_fetch_workers() -> int:
    return min(8, os.cpu_count() or 1)


def cfg_num_workers(training_cfg: Dict[str, Any]) -> Optional[int]:
    """training.num_workers -> fetch-thread count; absent/None means auto."""
    value = training_cfg.get("num_workers")
    if value in (None, "None", ""):
        return None
    return int(value)


def epoch_order(n: int, *, shuffle: bool, seed: int, epoch: int, process_index: int = 0,
                process_count: int = 1) -> np.ndarray:
    """The sample order of one epoch on one process: a permutation drawn
    from ``RandomState(seed * 100003 + epoch)``, padded to a multiple of
    ``process_count`` with its leading indices, then strided by process."""
    order = np.arange(n)
    if shuffle:
        rng = np.random.RandomState((seed or 0) * 100003 + epoch)
        rng.shuffle(order)
    if process_count > 1 and n % process_count != 0:
        # every process yields the same number of batches
        pad = process_count - n % process_count
        order = np.concatenate([order, order[:pad]])
    return order[process_index::process_count]


def epoch_batches(
    dataset,
    batch_size: int,
    *,
    shuffle: bool,
    seed: int,
    epoch: int,
    pad_to_full: bool = True,
    process_index: int = 0,
    process_count: int = 1,
    num_workers: Optional[int] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield {'target', 'image', 'valid'} numpy batches of a static batch
    size in :func:`epoch_order`.

    ``num_workers`` threads fetch a batch's samples concurrently, which needs
    a thread-safe ``dataset.__getitem__``. With ``num_workers=None`` (auto)
    a dataset that declares ``thread_safe_getitem = True`` (the BaseDataset
    family) gets ``min(8, cpu_count)`` threads and any other the serial
    path; an explicit count always wins. 0 = serial. Batch contents and
    order are the same at any worker count."""
    order = epoch_order(len(dataset), shuffle=shuffle, seed=seed, epoch=epoch,
                        process_index=process_index, process_count=process_count)
    if num_workers is None:
        workers = (_default_fetch_workers()
                   if getattr(dataset, "thread_safe_getitem", False) else 0)
    else:
        workers = int(num_workers)
    pool = None
    if workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="fetch")
    try:
        yield from _batches_over(dataset, order, batch_size, pad_to_full, pool)
    finally:
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)


def _batches_over(dataset, order, batch_size, pad_to_full, pool) -> Iterator[Dict[str, np.ndarray]]:
    for start in range(0, len(order), batch_size):
        idx = order[start : start + batch_size]
        if pool is not None:
            samples = list(pool.map(lambda i: dataset[int(i)], idx))
        else:
            samples = [dataset[int(i)] for i in idx]
        yield _finalize(samples, batch_size, pad_to_full)


def batch_to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, Optional[torch.Tensor]]:
    """A host batch (numpy arrays, or pinned CPU tensors) on ``device``, in
    one copy per array; pinned tensors copy asynchronously."""
    out = {}
    for key, value in batch.items():
        if value is None:
            out[key] = None
            continue
        tensor = torch.as_tensor(value)
        out[key] = tensor.to(device, non_blocking=tensor.is_pinned())
    return out


def _pad_rows(a: Optional[torch.Tensor], rows: int) -> Optional[torch.Tensor]:
    if a is None or a.shape[0] == rows:
        return a
    return torch.cat([a, a.new_zeros((rows - a.shape[0],) + a.shape[1:])])


class DenoiseTrainStep:
    """One optimizer step of a denoising UNet under a scheduler (see the
    module's docstring). ``step`` returns ``(loss_sum, count)`` and leaves
    ``p.grad`` holding the averaged gradient that was applied."""

    def __init__(self, model: nn.Module, scheduler: Scheduler, optimizer: torch.optim.Optimizer,
                 lr_schedule: Callable[[int], float], *, variant: str,
                 conditioning_mode: Optional[str], latent_norm: Optional[str],
                 grad_accum: int = 1, compute_dtype: torch.dtype = torch.float32,
                 remat: bool = False, ema_decay: float = 0.0, device: DeviceArg = None,
                 mesh: Optional["mesh_lib.DataMesh"] = None, t_sampling: str = "uniform",
                 timestep_input: str = "discrete"):
        if variant not in VARIANTS:
            raise ValueError(f"variant must be one of {VARIANTS}; got '{variant}'")
        if t_sampling not in T_SAMPLINGS or timestep_input not in TIMESTEP_INPUTS:
            raise ValueError(f"t_sampling must be one of {T_SAMPLINGS} and timestep_input one of "
                             f"{TIMESTEP_INPUTS}; got '{t_sampling}', '{timestep_input}'")
        if variant == "diffusion" and (t_sampling, timestep_input) != ("uniform", "discrete"):
            raise ValueError("diffusion draws integer timesteps: t_sampling and timestep_input "
                             "apply to flow matching only")
        decay = float(ema_decay or 0.0)
        if decay and not 0.0 < decay < 1.0:
            raise ValueError(f"ema_decay must be in (0, 1), got {decay}")
        self.device = resolve_device(device)
        params = list(model.parameters())
        if any(p.device.type != self.device.type for p in params):
            raise ValueError(f"the model's parameters must be on {self.device}")
        self.model = model
        self.scheduler = scheduler
        self.optimizer = optimizer
        self.lr_schedule = lr_schedule
        self.variant = variant
        self.t_sampling = t_sampling
        self.timestep_input = timestep_input
        self.conditioning_mode = conditioning_mode
        self.latent_norm = latent_norm
        self.grad_accum = max(1, int(grad_accum))
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.ema_decay = decay
        # shadow weights start as a copy of the live parameters
        self.ema = [local_tensor(p).detach().clone() for p in params] if decay else None
        self.global_step = 0
        # a mesh over ranks, else None (one process)
        self.mesh = mesh if mesh_lib.spans_processes(mesh) else None
        # False where FSDP reduce-scatters the gradients itself
        self.reduce_grads = True

    def _draw_t(self, rows: int, generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.variant == "diffusion":
            return torch.randint(0, self.scheduler.num_train_timesteps, (rows,),
                                 generator=generator, device=self.device, dtype=torch.int32)
        if self.t_sampling == "logit_normal":
            return torch.sigmoid(torch.randn((rows,), generator=generator, device=self.device,
                                             dtype=torch.float32))
        return torch.rand((rows,), generator=generator, device=self.device, dtype=torch.float32)

    def _model(self, x: torch.Tensor, t: torch.Tensor, ctx: Optional[torch.Tensor]) -> torch.Tensor:
        if self.remat:
            return checkpoint(self.model, x, t, use_reentrant=False, context_ca=ctx)
        return self.model(x, t, context_ca=ctx)

    def chunk_loss(self, x0: torch.Tensor, cond: Optional[torch.Tensor], valid: torch.Tensor,
                   noise: torch.Tensor, t: torch.Tensor):
        """(masked mean loss, loss_sum, count) of one chunk with its noise and t."""
        n_train = self.scheduler.num_train_timesteps
        if self.variant == "diffusion":
            noisy = self.scheduler.add_noise(x0, noise, t)
            target, model_t = noise, t
        else:
            tb = t.reshape((-1,) + (1,) * (x0.dim() - 1))
            noisy = (1.0 - tb) * x0 + tb * noise
            target = noise - x0
            model_t = (t * n_train if self.timestep_input == "continuous"
                       else (t * (n_train - 1)).to(torch.int32))

        model_input = noisy.to(self.compute_dtype)
        ctx = None
        if self.conditioning_mode == "concatenate" and cond is not None:
            model_input = torch.cat([model_input, cond.to(self.compute_dtype)], dim=1)
        elif self.conditioning_mode == "attention" and cond is not None:
            ctx = prepare_attention_context(normalize_latent_conditioning(cond, self.latent_norm))
            ctx = ctx.to(self.compute_dtype)
        elif self.conditioning_mode == "text":
            ctx = map_conditioning(lambda c: c.to(self.compute_dtype), cond)

        pred = self._model(model_input, model_t, ctx).float()
        per_sample = torch.square(pred - target).mean(dim=tuple(range(1, x0.dim())))
        loss_sum = (per_sample * valid).sum()
        count = valid.sum()
        return loss_sum / torch.clamp(count, min=1.0), loss_sum, count

    def step(self, batch: Dict[str, Optional[torch.Tensor]], *,
             noise: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """One optimizer step on ``batch``. ``noise`` ((rows, *x0.shape[1:]))
        and ``t`` ((rows,), int for diffusion, f32 in [0, 1) for flow
        matching) cover the padded batch of ``rows = n_chunks * chunk``; what
        is not given is drawn per chunk, noise first, from ``generator``."""
        with trace.span("train.step"):
            loss_sum, count = self._accumulate(batch, noise, t, generator)
            if self.mesh is not None and self.reduce_grads:
                with trace.span("train.allreduce"):
                    mesh_lib.all_reduce_grads(list(self.model.parameters()), self.mesh)
            with trace.span("train.optimizer"):
                for group in self.optimizer.param_groups:
                    group["lr"] = self.lr_schedule(self.global_step)
                self.optimizer.step()
            if self.ema is not None:
                with torch.no_grad():
                    torch._foreach_lerp_(
                        self.ema, [local_tensor(p).detach() for p in self.model.parameters()],
                        1.0 - self.ema_decay)
        self.global_step += 1
        return loss_sum, count

    def trial(self, batch: Dict[str, Optional[torch.Tensor]], generator: torch.Generator) -> None:
        """The forward and backward of one step on ``batch`` at the current
        ``grad_accum``, drawing from ``generator``, then the gradients freed:
        the optimizer, the rate's step and the EMA are left as they were.
        It runs as one process's step, with no collective, so that ranks
        whose trials fail differently cannot issue mismatched collectives;
        the ranks agree afterwards (:func:`agree_grad_accum`)."""
        mesh, self.mesh = self.mesh, None
        try:
            self._accumulate(batch, None, None, generator)
        finally:
            self.mesh = mesh
            self.optimizer.zero_grad(set_to_none=True)
            if self.device.type == "cuda":
                torch.cuda.empty_cache()

    def _accumulate(self, batch, noise, t, generator) -> Tuple[torch.Tensor, torch.Tensor]:
        """The chunks' forwards and backwards: ``p.grad`` holds the averaged
        gradient; returns (loss_sum, count)."""
        dev = self.device
        x0 = batch["target"].to(dev, torch.float32)
        cond = batch.get("text" if self.conditioning_mode == "text" else "image")
        cond = map_conditioning(lambda c: c.to(dev, torch.float32), cond)
        valid = batch["valid"].to(dev, torch.float32)
        chunk = max(1, math.ceil(x0.shape[0] / self.grad_accum))
        n_chunks = math.ceil(x0.shape[0] / chunk)
        rows = n_chunks * chunk
        x0, valid = (_pad_rows(a, rows) for a in (x0, valid))
        cond = map_conditioning(lambda c: _pad_rows(c, rows), cond)
        if noise is not None and tuple(noise.shape) != tuple(x0.shape):
            raise ValueError(f"noise is {tuple(noise.shape)}; the padded batch is {tuple(x0.shape)}")
        if t is not None and tuple(t.shape) != (rows,):
            raise ValueError(f"t is {tuple(t.shape)}; the padded batch has {rows} rows")

        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        if self.mesh is not None:
            return self._accumulate_over_ranks(x0, cond, valid, noise, t, generator, chunk)
        loss_sum = torch.zeros((), device=dev)
        count = torch.zeros((), device=dev)
        for i in range(n_chunks):
            sl = slice(i * chunk, (i + 1) * chunk)
            nz = noise[sl].to(dev) if noise is not None else torch.randn(
                x0[sl].shape, generator=generator, device=dev, dtype=torch.float32)
            tt = t[sl].to(dev) if t is not None else self._draw_t(chunk, generator)
            with trace.span("train.forward"):
                loss, chunk_sum, chunk_count = self.chunk_loss(
                    x0[sl], map_conditioning(lambda c: c[sl], cond), valid[sl], nz, tt)
            # one chunk: the masked mean's gradient as it is; several: each
            # weighted by its count, the sum divided by the total below
            with trace.span("train.backward"):
                (loss if n_chunks == 1 else loss * chunk_count).backward()
            loss_sum = loss_sum + chunk_sum.detach()
            count = count + chunk_count
        if n_chunks > 1:
            divisor = torch.clamp(count, min=1.0)
            for p in self.model.parameters():
                if p.grad is not None:
                    p.grad.div_(divisor)
        return loss_sum, count

    def _accumulate_over_ranks(self, x0, cond, valid, noise, t, generator, chunk):
        """:meth:`_accumulate` over the mesh's ranks: each chunk's loss sum
        over the global valid count, the draws the global chunk's (this
        rank's rows); returns the global (loss_sum, count)."""
        mesh, dev = self.mesh, self.device
        count = mesh_lib.all_reduce_sum(valid.sum(), mesh)
        divisor = torch.clamp(count, min=1.0)
        loss_sum = torch.zeros((), device=dev)
        for i in range(x0.shape[0] // chunk):
            sl = slice(i * chunk, (i + 1) * chunk)
            global_rows = (chunk * mesh.process_count,)
            nz = noise[sl].to(dev) if noise is not None else mesh_lib.rows_of(torch.randn(
                global_rows + tuple(x0.shape[1:]), generator=generator, device=dev,
                dtype=torch.float32), mesh)
            tt = t[sl].to(dev) if t is not None else mesh_lib.rows_of(
                self._draw_t(global_rows[0], generator), mesh)
            with trace.span("train.forward"):
                _, chunk_sum, _ = self.chunk_loss(
                    x0[sl], map_conditioning(lambda c: c[sl], cond), valid[sl], nz, tt)
            with trace.span("train.backward"):
                (chunk_sum / divisor).backward()
            loss_sum = loss_sum + chunk_sum.detach()
        return mesh_lib.all_reduce_sum(loss_sum, mesh), count

    def ema_state_dict(self) -> Dict[str, torch.Tensor]:
        """The shadow weights under the model's parameter names (the ``ema``
        entry of a checkpoint), or {} without EMA."""
        if self.ema is None:
            return {}
        return {name: e for (name, _), e in zip(self.model.named_parameters(), self.ema)}


def make_denoise_train_step(model: nn.Module, scheduler: Scheduler,
                            optimizer: torch.optim.Optimizer, lr_schedule: Callable[[int], float],
                            *, variant: str, conditioning_mode: Optional[str],
                            latent_norm: Optional[str], grad_accum: int = 1,
                            compute_dtype: torch.dtype = torch.float32, mesh=None,
                            remat: bool = False, ema_decay: float = 0.0,
                            device: DeviceArg = None, t_sampling: str = "uniform",
                            timestep_input: str = "discrete") -> DenoiseTrainStep:
    """The train step of ``model`` (its parameters on ``device``, CUDA by
    default) with ``optimizer`` at ``lr_schedule``'s rate, over the ranks of
    ``mesh`` when it spans them; see :class:`DenoiseTrainStep`."""
    check_train_mesh(mesh)
    return DenoiseTrainStep(model, scheduler, optimizer, lr_schedule, variant=variant,
                            conditioning_mode=conditioning_mode, latent_norm=latent_norm,
                            grad_accum=grad_accum, compute_dtype=compute_dtype, remat=remat,
                            ema_decay=ema_decay, device=device, mesh=mesh,
                            t_sampling=t_sampling, timestep_input=timestep_input)


def check_train_mesh(mesh) -> None:
    """A train step's mesh: None, or a :class:`DataMesh` of one card per
    process (several cards in one process are not a train mesh: run one
    rank per card under torchrun)."""
    if mesh is None:
        return
    if not isinstance(mesh, mesh_lib.DataMesh):
        raise TypeError(f"mesh must be a fmdm_tpu_torch.parallel.DataMesh, got "
                        f"{type(mesh).__name__}")
    if len(mesh.devices) != 1:
        raise ValueError(f"a train step takes one card per process, got {len(mesh.devices)}; "
                         f"run one rank per card under torch.distributed.run")


# ---------------------------------------------------------------------------
# The parallel strategies of the trainers
# ---------------------------------------------------------------------------

def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of an FSDP ``DTensor``, a plain tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


class ParallelPlan:
    """How a trainer spreads one model over the ranks (see the module's
    docstring): ``kind`` is "dp", "sp", "tp", "fsdp" or "tp_fsdp";
    ``batch_mesh`` the :class:`DataMesh` a step reduces its batch over (None
    in one process); ``world`` the mesh of every rank; ``rows`` this rank's
    (index, count) among the global batch's row blocks."""

    def __init__(self, kind: str, world, batch_mesh, mesh2d=None):
        self.kind = kind
        self.world = world
        self.batch_mesh = batch_mesh
        self.mesh2d = mesh2d
        self.rows = mesh_lib.data_rows(mesh2d)
        self._tp = {}   # id(model) -> its TensorParallel
        self.sharded = False

    @property
    def reduce_grads(self) -> bool:
        return self.kind not in ("fsdp", "tp_fsdp")

    @property
    def cuts_model(self) -> bool:
        """Whether :meth:`shard` cuts the parameters over the ranks (FSDP,
        tensor parallelism, both)."""
        return self.batch_mesh is not None and self.kind not in ("dp", "sp")

    def shard(self, models: Sequence[nn.Module], optimizers: Sequence[Optional[torch.optim.Optimizer]],
              emas: Sequence[Optional[List[torch.Tensor]]] = ()):
        """Cut each model (in place) and map its optimizer's moments and EMA
        (whole tensors, as a resume loaded them) onto its shards. Returns
        (optimizers, emas): FSDP's parameters are new objects, so its
        optimizers are rebuilt over them with the state moved across."""
        emas = list(emas) + [None] * (len(models) - len(emas))
        if not self.cuts_model:
            return list(optimizers), emas
        from fmdm_tpu_torch.parallel import fsdp as fsdp_lib
        from fmdm_tpu_torch.parallel import tp as tp_lib

        out_opt, out_ema = [], []
        for model, optimizer, ema in zip(models, optimizers, emas):
            names = [n for n, _ in model.named_parameters()]
            state = ({name: optimizer.state.get(p, {}) for name, p in model.named_parameters()}
                     if optimizer is not None else {})
            full = dict(zip(names, ema)) if ema is not None else {}
            tp = None
            if self.kind in ("tp", "tp_fsdp"):
                specs = fsdp_lib.fsdp_tp_param_specs(model, *self.mesh2d.shape)
                tp = tp_lib.TensorParallel(model, self.mesh2d)
                if self.kind == "tp_fsdp":
                    fsdp_lib.shard_params_fsdp(model, self.mesh2d.device_mesh, specs)
            else:
                specs = fsdp_lib.fsdp_param_specs(model, self.batch_mesh.process_count)
                fsdp_lib.shard_params_fsdp(model, mesh_lib.create_fsdp_device_mesh(
                    self.batch_mesh.devices[0]), specs)
            self._tp[id(model)] = tp
            params = dict(model.named_parameters())

            def place(name, whole):
                cut = tp.local(name, whole) if tp is not None else whole
                return fsdp_lib.local(params[name], cut)

            if optimizer is not None:
                rebuilt = type(optimizer)(params.values())
                for group, old in zip(rebuilt.param_groups, optimizer.param_groups):
                    group.update({k: v for k, v in old.items() if k != "params"})
                for name, st in state.items():
                    rebuilt.state[params[name]] = {
                        k: place(name, v) if torch.is_tensor(v) and v.dim() > 0 else v
                        for k, v in st.items()}
                optimizer = rebuilt
            out_opt.append(optimizer)
            out_ema.append([local_tensor(place(name, full[name])).clone() for name in names]
                           if ema is not None else None)
        self.sharded = True
        return out_opt, out_ema

    def whole(self, model: nn.Module, name: str, t: torch.Tensor) -> torch.Tensor:
        """A tensor placed as ``model``'s parameter ``name`` gathered whole
        (a collective when the model is cut)."""
        from fmdm_tpu_torch.parallel import fsdp as fsdp_lib

        t = fsdp_lib.full(t)
        tp = self._tp.get(id(model))
        return tp.full(name, t) if tp is not None else t

    def full_model_state(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """The whole state dict (a collective every rank runs when the
        model is cut, gathered to the host; the model's own otherwise)."""
        if not self.sharded:
            return model.state_dict()
        return {name: self.whole(model, name, t).detach().cpu()
                for name, t in model.state_dict().items()}

    def full_optimizer_state(self, model: nn.Module, optimizer):
        """The optimizer's ``state_dict`` with whole moments (a collective
        every rank runs when the model is cut), None without an optimizer."""
        if optimizer is None:
            return None
        if not self.sharded:
            return optimizer.state_dict()
        names = [n for n, _ in model.named_parameters()]
        sd = optimizer.state_dict()
        sd["state"] = {i: {k: self.whole(model, names[i], v).detach().cpu()
                           if torch.is_tensor(v) and v.dim() > 0 else v for k, v in st.items()}
                       for i, st in sd["state"].items()}
        return sd

    def full_ema(self, model: nn.Module, ema: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The EMA shadow weights whole, by parameter name."""
        from torch.distributed.tensor import DTensor

        out = {}
        for (name, p), e in zip(model.named_parameters(), ema):
            if isinstance(p, DTensor):
                e = DTensor.from_local(e, p.device_mesh, p.placements, shape=p.shape,
                                       stride=p.stride())
            out[name] = self.whole(model, name, e).detach().cpu() if self.sharded else e
        return out


def state_bytes(model: nn.Module, *optimizers) -> int:
    """Bytes of this rank's parameters and optimizer state (its shards
    under FSDP and tensor parallelism)."""
    tensors = [local_tensor(p) for p in model.parameters()]
    for optimizer in optimizers:
        if optimizer is not None:
            tensors += [local_tensor(v) for st in optimizer.state.values() for v in st.values()
                        if torch.is_tensor(v)]
    return sum(t.numel() * t.element_size() for t in tensors)


def parallel_plan(training_cfg: Dict[str, Any], batch_size: int, device: torch.device, *,
                  vae: bool = False) -> ParallelPlan:
    """The strategy of a config's ``training`` section (JAX's branches, its
    two ValueErrors kept): ``sequence_parallel`` > 1 (installs the
    ring's routing, with ``sequence_parallel_min_tokens``),
    ``tensor_parallel`` > 1 with ``fsdp`` (the denoise trainer only; the
    VAE's takes tensor parallelism alone, as JAX's does), ``tensor_parallel``
    > 1, ``fsdp``, else data parallelism. Without a process group a ``seq``
    or ``model`` axis over the one device raises, as JAX's meshes do."""
    from fmdm_tpu_torch.ops import attention as attention_ops

    tp = int(training_cfg.get("tensor_parallel", 1) or 1)
    sp = int(training_cfg.get("sequence_parallel", 1) or 1)
    fsdp = bool(training_cfg.get("fsdp", False))
    if vae and sp > 1 and tp > 1:
        raise ValueError("sequence_parallel composes with plain DP only (set tensor_parallel=1)")
    if not vae and sp > 1 and (tp > 1 or fsdp):
        raise ValueError("sequence_parallel composes with plain DP only "
                         "(set tensor_parallel=1, fsdp=false)")
    group = mesh_lib.group_active()
    world = mesh_lib.create_data_mesh(batch_size, device) if group else None
    if sp > 1:
        mesh = (mesh_lib.create_dp_sp_mesh_global(batch_size, sp, device) if group
                else mesh_lib.create_dp_sp_mesh(batch_size, sp, devices=[device]))
        attention_ops.set_sequence_parallel(
            mesh, "seq", min_tokens=int(training_cfg.get("sequence_parallel_min_tokens", 512)))
        return ParallelPlan("sp", world, mesh.batch_mesh(), mesh)
    if tp > 1:
        mesh = mesh_lib.create_dp_tp_mesh_global(batch_size, tp, device, devices=[device])
        return ParallelPlan("tp_fsdp" if fsdp and not vae else "tp", world, mesh.batch_mesh(),
                            mesh)
    return ParallelPlan("fsdp" if fsdp and group else "dp", world, world)


# ---------------------------------------------------------------------------
# Run-loop helpers of the denoise and VAE loops
# ---------------------------------------------------------------------------

LOG_FORMAT = "%(asctime)s | %(levelname)s | %(message)s"


def run_dir_for(training_cfg: Dict[str, Any], cfg: Dict[str, Any], default: str,
                resume) -> Path:
    """The run's output dir: a fresh ``_runN`` beside ``training.output_dir``
    unless resuming (then the dir itself); ``train_config.json`` is written
    there once. Under a process group rank 0 allocates the dir and writes,
    and every rank adopts its name (``broadcast_string``)."""
    base_output_dir = Path(training_cfg.get("output_dir", default))
    main = mesh_lib.is_main_process()
    output_dir = (config_utils.allocate_run_dir(base_output_dir)
                  if resume is None and main else base_output_dir)
    output_dir = Path(mesh_lib.broadcast_string(str(output_dir)))
    training_cfg["output_dir"] = str(output_dir)
    if main:
        output_dir.mkdir(parents=True, exist_ok=True)
        cfg_path = output_dir / "train_config.json"
        if not cfg_path.exists():
            config_utils.save_json_config(cfg_path, cfg)
    return output_dir


def host_batches(dataset, batch_size: int, training_cfg: Dict[str, Any], *, seed: int,
                 epoch: int, device: torch.device, shuffle: bool = True,
                 rows: Optional[Tuple[int, int]] = None):
    """This process's host batches of one epoch (:func:`epoch_order` strided
    over the ranks, or over ``rows`` = (index, count) of the row blocks):
    ``training.data_loader: "grain"`` takes the ``DataLoader`` with worker
    processes (pinned batches on CUDA), anything else the threaded
    ``epoch_batches`` behind a prefetch thread."""
    index, count = rows if rows is not None else (mesh_lib.process_index(),
                                                 mesh_lib.process_count())
    ranks = {"process_index": index, "process_count": count}
    if str(training_cfg.get("data_loader", "threads")).lower() == "grain":
        from fmdm_tpu_torch.data.grain_pipeline import grain_epoch_batches

        return grain_epoch_batches(dataset, batch_size, shuffle=shuffle, seed=seed, epoch=epoch,
                                   num_workers=cfg_num_workers(training_cfg) or 0,
                                   pin_memory=device.type == "cuda", **ranks)
    return prefetch(epoch_batches(dataset, batch_size, shuffle=shuffle, seed=seed, epoch=epoch,
                                  num_workers=cfg_num_workers(training_cfg), **ranks))


def steps_per_epoch(num_samples: int, batch_size: int, row_blocks: Optional[int] = None) -> int:
    """Optimizer steps per epoch: this process's batches, over
    ``ceil(num_samples / row_blocks)`` samples (default: one block per rank;
    every rank steps in lockstep on the global batch)."""
    blocks = mesh_lib.process_count() if row_blocks is None else row_blocks
    return math.ceil(math.ceil(num_samples / blocks) / batch_size)


def tune_grad_accum(plan: ParallelPlan, build_step: Callable[[int], Any],
                    trial_step: Callable[[Any, int], None], *, batch_size: int,
                    grad_accum: int, allow_microbatching: bool, what: str) -> Any:
    """The step at the accumulation every rank takes. Where ``plan`` cuts
    the model the configured accumulation is kept: a trial of the uncut
    model would refuse a model that fits the card only when cut, and a
    trial of the cut one issues collectives that one rank's out-of-memory
    error would leave unmatched. Elsewhere :func:`autotune_grad_accum`, the
    ranks then taking the largest (:func:`agree_grad_accum`)."""
    if plan.cuts_model:
        logging.info("Parallel strategy %s: keeping gradient_accumulation_steps=%d (no start-up "
                     "trial of a model cut over the ranks)", plan.kind, grad_accum)
        return build_step(max(1, int(grad_accum)))
    accum, _ = autotune_grad_accum(build_step, trial_step, batch_size=batch_size,
                                   grad_accum=grad_accum,
                                   allow_microbatching=allow_microbatching, what=what)
    return agree_grad_accum(accum, build_step, plan.world)[1]


def agree_grad_accum(accum: int, build_step: Callable[[int], Any], mesh) -> Tuple[int, Any]:
    """The accumulation every rank takes: the largest of the ranks' tuned
    ones (the smallest micro-batch), the step rebuilt where it grew."""
    agreed = mesh_lib.agree_max(accum, mesh)
    if agreed != accum:
        logging.warning("Another rank tuned gradient_accumulation_steps=%d; taking it.", agreed)
    return agreed, build_step(agreed)


def with_progress(batches, total: int, desc: str):
    """tqdm over ``batches`` where tqdm is installed (off on a non-TTY and
    on every rank but 0)."""
    try:
        from tqdm import tqdm
    except ImportError:
        return batches
    return tqdm(batches, total=total, desc=desc, leave=False, dynamic_ncols=True,
                disable=None if mesh_lib.is_main_process() else True)


def resume_path(resume, training_cfg: Dict[str, Any]) -> Optional[Path]:
    """``resume``, else ``training.resume`` unless it is "none"."""
    if resume:
        return Path(resume)
    from_cfg = training_cfg.get("resume")
    if isinstance(from_cfg, str) and from_cfg.lower() != "none":
        return Path(from_cfg)
    return None


def generator_state(generator: torch.Generator) -> Dict[str, Any]:
    return {"device": generator.device.type, "state": generator.get_state()}


def restore_generator(generator: torch.Generator, saved) -> None:
    """Continue ``generator`` from a checkpoint's ``rng_state`` when it was
    saved from a generator of the same device type."""
    if not saved:
        return
    if saved.get("device") != generator.device.type:
        logging.warning("The checkpoint's generator state is from a %s generator; the %s "
                        "generator starts from its seed.", saved.get("device"),
                        generator.device.type)
        return
    generator.set_state(saved["state"])


@contextlib.contextmanager
def profile_epoch(profile_dir, device: torch.device):
    """``torch.profiler`` over the block, its Chrome trace written to
    ``profile_dir/trace.json`` (the port's spans in it, ``utils/trace.py``,
    above the ops they launched); a no-op without ``profile_dir``."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        yield
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
    trace.clear()  # the trace holds the spans; the process keeps none
    logging.info("Wrote the first epoch's trace to %s", out / "trace.json")


@contextlib.contextmanager
def weights_swapped(model: torch.nn.Module, tensors: Sequence[torch.Tensor]):
    """``model`` with its parameters set to ``tensors`` inside the block,
    the live values restored bitwise after it."""
    params = list(model.parameters())
    live = [p.detach().clone() for p in params]
    with torch.no_grad():
        for p, t in zip(params, tensors):
            p.copy_(t)
    try:
        yield model
    finally:
        with torch.no_grad():
            for p, t in zip(params, live):
                p.copy_(t)


# ---------------------------------------------------------------------------
# Start-up micro-batch tuning
# ---------------------------------------------------------------------------

def is_memory_error(err: BaseException) -> bool:
    """Does this exception read as device-memory exhaustion? A
    ``torch.OutOfMemoryError``, or an error whose text says so (the JAX
    package's tags, and cuBLAS's and cuDNN's allocation failures)."""
    if isinstance(err, torch.OutOfMemoryError):
        return True
    text = f"{type(err).__name__}: {err}".lower()
    return any(tag in text for tag in (
        "resource_exhausted", "out of memory", "exceeds the hbm", "hbm capacity",
        "memory space hbm", "allocating", "oom", "alloc_failed",
    )) and not isinstance(err, (TypeError, ValueError))


def autotune_grad_accum(
    build_step: Callable[[int], Any],
    trial_step: Callable[[Any, int], None],
    *,
    batch_size: int,
    grad_accum: int,
    allow_microbatching: bool = True,
    what: str = "train step",
) -> Tuple[int, Any]:
    """Pick the largest micro-batch that fits at start-up: build the step
    for the configured accumulation and run ``trial_step`` (one forward and
    backward of a probe batch that changes no state); on memory exhaustion
    halve the micro-batch (raising the accumulation) until it fits or the
    micro-batch is 1. Only under ``allow_microbatching``; any other error
    is raised. Returns (grad_accum, step)."""
    accum = max(1, int(grad_accum))
    while True:
        step = build_step(accum)
        try:
            trial_step(step, accum)
            if accum != max(1, int(grad_accum)):
                logging.warning(
                    "Auto-tuned %s to gradient_accumulation_steps=%d "
                    "(micro-batch %d) to fit device memory.",
                    what, accum, -(-batch_size // accum),
                )
            return accum, step
        except Exception as err:  # noqa: BLE001 - classified below
            chunk = -(-batch_size // accum)
            if not (allow_microbatching and is_memory_error(err)) or chunk <= 1:
                raise
            new_chunk = max(1, chunk // 2)
            accum = min(batch_size, -(-batch_size // new_chunk))
            logging.warning(
                "%s does not fit with micro-batch %d (%s); retrying with "
                "micro-batch %d (accum=%d).",
                what, chunk, type(err).__name__, new_chunk, accum,
            )
