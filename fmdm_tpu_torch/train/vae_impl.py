"""
The VAE trainer (counterpart of ``fmdm_tpu/train/vae_impl.py``): the train
and eval steps of the KL and VQ recipes with the GAN loss (the closure at
:297-453), their learning-rate schedules (``_make_lr_schedule``, :57-82),
the run loop (:func:`train`, :127-669) and visuals from a checkpoint
(:func:`debug_visual_only`).

One step: the batch is wrap-padded to ``n_chunks`` equal chunks, the padded
rows masked out of the reconstruction loss (``valid`` = 0) and of the counts;
each chunk's loss is the reconstruction loss (L1, MSE, or bce / focal /
bce-focal on the logits) over its valid rows, plus ``perceptual_weight``
times the VGG16 perceptual loss, plus ``kl_scale`` times the mean KL of the
posterior (KL) or ``codebook_weight`` times the quantizer's loss (VQ), the
last two over all its rows; the gradients are summed with each chunk's
valid count as weight, divided by the total count, and applied by
``torch.optim.AdamW`` (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay),
which is ``optax.adamw``'s update. The posterior is sampled from an explicit
noise tensor or a ``torch.Generator``.

The GAN loss (``gan_weight > 0``): the model's discriminator
(``make_discriminator``), drawn from a generator seeded ``seed + 1`` (JAX's
``PRNGKey(seed + 1)``), has an AdamW of its own at the constant rate
``disc_lr`` (else ``learning_rate``), b1 0.9, b2 0.999, eps 1e-8, no weight
decay. While the gate is on (``global_step >= gan_start_steps`` when that
is set, else ``epoch >= gan_start``), each chunk's generator loss adds
``gan_weight`` times the generator hinge loss of D(reconstruction), taken
with D's parameters frozen, so that none of its gradient reaches D (as in
JAX); then D's hinge loss on the real chunk and the detached reconstruction
accumulates D's gradients. Both come from the parameters before the update;
with several chunks both are averaged over the valid counts, BatchNorm's
batch statistics are per chunk, and the generator and D step once each.
The eval step takes ``g_gan`` with D's stored (never updated) running
statistics and ``d_gan`` with batch statistics, as JAX does.

An EMA codebook's buffers are not parameters: they are updated from each
chunk's codes, kept out of AdamW, and saved with the weights in the
checkpoint's ``model``, as the JAX package merges them back.

The run dir is the JAX package's: ``train_config.json``, ``metrics.csv``
(``epoch`` and the train averages of ``loss``, ``recon`` and the
conditional ``kl``, ``vq``, ``perceptual``, ``g_gan``/``d_gan`` columns),
``vae_last.pt`` every ``checkpoint_every_epochs`` and at the last epoch,
``vae_best.pt`` (by the validation loss when there is a validation set) and
``epochs/epochXXXX/epoch.pt`` every ``save_every`` as hardlink mirrors, and
on those epochs ``epochs/epochXXXX/{input,recon,gen}.png``. Two counters
are kept apart as in the JAX package: the learning rate follows the
optimizer's step (restored on resume), the KL anneal the loop's own step
(0 at the start of every run, resumed or not). Each step's posterior noise
comes from a generator on the device seeded with ``seed + 23`` (the JAX
package's ``PRNGKey(seed + 23)``), whose state each checkpoint keeps; the
generated visuals of epoch ``e`` draw from one seeded with
``(seed + 23) * 100003 + e``.

D's parameters are saved under ``extra_state["disc_params"]`` and its
optimizer under ``disc_optimizer``; a resume reads them from the port's
checkpoints and from the JAX package's (the flattened pytrees by leaf
position, its ``optax.adamw`` at a constant rate with 2n + 1 leaves).

On CUDA the mid attention's forward runs K3 and its backward K4 and K5; K1's
forward and backward are kernels.

Over P ranks (``mesh``, one rank per card under ``torchrun``) a step is one
step of one process on the global batch, as JAX's global mesh makes it:
every reduction over the batch axis is over the global batch. The
reconstruction loss divides by the chunk's global valid count; the terms
that are means over the rows (the KL, the codebook and commitment terms, the
perceptual loss, the hinge losses) enter at 1/P of each rank's mean, so
their sum over the ranks is the global mean; each rank backpropagates its
part weighted by the global count, and the gradients (G's and D's) are
summed over the ranks. The discriminators' BatchNorm takes the global
batch's statistics, and an EMA codebook the global counts and sums. The
posterior noise of a chunk is drawn for the global chunk from a generator
seeded alike on every rank, each rank keeping its rows. The metrics are the
global ones on every rank, and the GAN gate, a function of the epoch and the
step, opens on every rank alike. Validation runs each rank's stride of the
validation set through the same reductions. Rank 0 alone writes.

``training.sequence_parallel``, ``tensor_parallel`` and ``fsdp`` choose the
strategy for the generator and the discriminator alike (``train/common.py``'s
:func:`parallel_plan`, JAX :232-283; the VAE composes neither
``sequence_parallel`` with ``fsdp``, which it ignores as JAX does, nor
``tensor_parallel`` with ``fsdp``, where tensor parallelism wins). An EMA
codebook's statistics and BatchNorm's statistics stay whole on every rank.
With the model cut every rank gathers the checkpoint's state whole, rank 0
writes it and draws the visuals from a whole copy; the routing that
``sequence_parallel`` installs is off for the visuals and cleared when
:func:`train` returns.
"""

from __future__ import annotations

import logging
import math
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from fmdm_tpu_torch.device import DeviceArg, resolve_device
from fmdm_tpu_torch.nn.layers import BatchNorm, init_weights
from fmdm_tpu_torch.nn.losses import (PerceptualLoss, _bce_with_logits, bce_focal_loss,
                                      discriminator_hinge_loss, generator_hinge_loss)
from fmdm_tpu_torch.nn.vae_modules import VectorQuantizerEMA
from fmdm_tpu_torch.ops import attention as attention_ops
from fmdm_tpu_torch.parallel import mesh as mesh_lib
from fmdm_tpu_torch.sample.vae_utils import build_vae_model, reconstruct_raw
from fmdm_tpu_torch.train import common as loop
from fmdm_tpu_torch.train.common import batch_to_device, epoch_batches
from fmdm_tpu_torch.utils import checkpoint as ckpt_utils
from fmdm_tpu_torch.utils import config as config_utils
from fmdm_tpu_torch.utils.evaluation import (latent_shape, make_grid, prepare_eval_batch,
                                             save_image, select_visual_indices)
from fmdm_tpu_torch.utils.summary import summarize_model

Metrics = Dict[str, torch.Tensor]


def make_lr_schedule(base_lr: float, cfg: Mapping[str, Any], epochs: int,
                     steps_per_epoch: int) -> Callable[[int], float]:
    """StepLR / CosineAnnealingLR / ExponentialLR stepped per epoch, as a
    function of the optimizer step."""
    sched_cfg = cfg.get("scheduler")
    if not sched_cfg:
        return lambda step: base_lr
    name = (sched_cfg.get("name") or "").lower()
    params = sched_cfg.get("params", {})
    spe = max(1, steps_per_epoch)
    if name == "steplr":
        step_size = int(params.get("step_size", 1))
        gamma = float(params.get("gamma", 0.1))
        return lambda step: base_lr * gamma ** (int(step) // (step_size * spe))
    if name == "cosineannealinglr":
        t_max = int(params.get("T_max", epochs))
        eta_min = float(params.get("eta_min", 0.0))
        return lambda step: eta_min + (base_lr - eta_min) * 0.5 * (
            1 + math.cos(math.pi * min(step / spe, t_max) / t_max))
    if name == "exponentiallr":
        gamma = float(params.get("gamma", 0.9))
        return lambda step: base_lr * gamma ** (int(step) // spe)
    if name == "":
        return lambda step: base_lr
    raise ValueError(f"Unsupported scheduler '{name}'.")


def kl_scale_at(kl_weight: float, kl_anneal_steps: int, global_step: int) -> float:
    """The KL weight of a step, annealed linearly over ``kl_anneal_steps``."""
    if kl_anneal_steps > 0:
        return kl_weight * min(1.0, max(1, global_step + 1) / max(1, kl_anneal_steps))
    return kl_weight


def recon_loss(rec: torch.Tensor, rec_img: torch.Tensor, raw: torch.Tensor,
               valid: torch.Tensor, recon_type: str,
               count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reconstruction loss over the valid rows (JAX :297-310): L1 or
    squared error of the image ``rec_img``, or the bce / focal / bce-focal
    loss of the logits ``rec``, against ``raw``; divided by ``count`` (the
    global batch's valid count) when given, else by ``valid``'s."""
    mask = valid.reshape((-1,) + (1,) * (raw.dim() - 1))
    denom = torch.clamp(valid.sum() if count is None else count,
                        min=1.0) * math.prod(raw.shape[1:])
    if recon_type == "l1":
        return (torch.abs(rec_img - raw) * mask).sum() / denom
    if recon_type == "mse":
        return (torch.square(rec_img - raw) * mask).sum() / denom
    if recon_type == "bce":
        return (_bce_with_logits(rec, raw) * mask).sum() / denom
    if recon_type in ("focal", "bce_focal"):
        per = bce_focal_loss(rec, raw, alpha=0.25, gamma=2.0, reduction="none")
        return (per * mask).sum() / denom
    raise ValueError(f"Unsupported recon_type '{recon_type}'.")


class VAETrainStep:
    """Train and eval steps of an ``AutoencoderKL`` or a ``VQVAE`` under a
    config's ``training`` section (learning_rate, weight_decay, kl_weight,
    kl_anneal_steps, codebook_weight, perceptual_weight, recon_type,
    gradient_accumulation_steps, scheduler, gan_weight, gan_start,
    gan_start_steps, disc_lr, seed).

    The perceptual term compares the reconstructed image with the input
    through a frozen VGG16 (:class:`PerceptualLoss` with ``resize``), on
    only when its weights file is there. A VQ model's term is
    ``codebook_weight`` times its ``vq_loss``; an EMA codebook's buffers are
    updated after each chunk from that chunk's codes (padded rows included,
    as in the JAX package), so chunk k quantizes with chunk k - 1's
    codebook. With ``gan_weight > 0`` it holds the ``discriminator`` and its
    ``disc_optimizer``; a step or eval with ``disc_active`` adds the GAN
    terms (see the module's docstring). A ``mesh`` over ranks makes both
    steps the global batch's (the module's docstring; the discriminator's
    parameters are set to rank 0's)."""

    def __init__(self, model: torch.nn.Module, training_cfg: Mapping[str, Any], *,
                 steps_per_epoch: int = 1, n_chunks: Optional[int] = None,
                 mesh: Optional[mesh_lib.DataMesh] = None):
        loop.check_train_mesh(mesh)
        # a mesh over ranks, else None (one process)
        self.mesh = mesh if mesh_lib.spans_processes(mesh) else None
        # False where FSDP reduce-scatters the gradients itself
        self.reduce_grads = True
        self.model = model
        self.recon_type = str(training_cfg.get("recon_type", "l1"))
        self.kl_weight = float(training_cfg.get("kl_weight", 0.0))
        self.kl_anneal_steps = int(training_cfg.get("kl_anneal_steps", 0))
        self.is_vq = hasattr(model, "codebook")
        reg_type = str(training_cfg.get("reg_type", "kl")).lower()
        # the codebook term counts only for a VQ model or reg_type "vq" (JAX :201-203)
        self.codebook_weight = (float(training_cfg.get("codebook_weight", 1.0))
                                if self.is_vq or reg_type == "vq" else 0.0)
        self.perceptual_weight = float(training_cfg.get("perceptual_weight", 0.0))
        self.perceptual = None
        if self.perceptual_weight > 0:
            self.perceptual = PerceptualLoss(resize=True,
                                             device=next(model.parameters()).device)
            if not self.perceptual.enabled:
                logging.warning("PerceptualLoss disabled: no VGG16 weights available "
                                "(FMDM_VGG16_WEIGHTS unset); contributes 0.")
        self.n_chunks = max(1, int(n_chunks if n_chunks is not None
                                   else training_cfg.get("gradient_accumulation_steps", 1)))
        lr = float(training_cfg.get("learning_rate", 1e-4))
        self.lr_schedule = make_lr_schedule(lr, training_cfg, int(training_cfg.get("epochs", 1)),
                                            steps_per_epoch)
        self.optimizer = torch.optim.AdamW(
            model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=float(training_cfg.get("weight_decay", 0.0)))
        self.global_step = 0
        self.gan_weight = float(training_cfg.get("gan_weight", 0.0))
        self.gan_start = int(training_cfg.get("gan_start", 0))
        start_steps = training_cfg.get("gan_start_steps")
        self.gan_start_steps = int(start_steps) if start_steps is not None else None
        self.discriminator = self.disc_optimizer = None
        self._disc_trainable: List[torch.nn.Parameter] = []
        if self.gan_weight > 0:
            seed = int(training_cfg.get("seed") or 0)
            self.discriminator = init_weights(
                model.make_discriminator(device=next(model.parameters()).device),
                torch.Generator().manual_seed(seed + 1))
            self._disc_trainable = [p for p in self.discriminator.parameters() if p.requires_grad]
            disc_lr = training_cfg.get("disc_lr")
            self.disc_optimizer = torch.optim.AdamW(
                self.discriminator.parameters(), lr=float(disc_lr) if disc_lr is not None else lr,
                betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
            mesh_lib.replicate(self.mesh, self.discriminator)
        modules = list(model.modules()) + (list(self.discriminator.modules())
                                           if self.discriminator is not None else [])
        # the modules whose reductions over the batch follow the step's mesh
        self._mesh_modules = [m for m in modules if isinstance(m, (BatchNorm, VectorQuantizerEMA))]
        self._use_mesh(self.mesh)

    def shard(self, plan: "loop.ParallelPlan") -> None:
        """Cut the generator and the discriminator with ``plan``, their
        optimizers' moments with them (after a resume has loaded them)."""
        models = [self.model] + ([self.discriminator] if self.discriminator is not None else [])
        optimizers, _ = plan.shard(models, [self.optimizer, self.disc_optimizer][:len(models)])
        self.optimizer = optimizers[0]
        if self.discriminator is not None:
            self.disc_optimizer = optimizers[1]
            self._disc_trainable = [p for p in self.discriminator.parameters() if p.requires_grad]
        self.reduce_grads = plan.reduce_grads

    def _use_mesh(self, mesh: Optional[mesh_lib.DataMesh]) -> None:
        self.mesh = mesh
        for m in self._mesh_modules:
            m.mesh = mesh

    def disc_is_active(self, epoch: int, global_step: int) -> bool:
        """The GAN gate (JAX :85-92): off without a discriminator or weight;
        else from ``gan_start_steps`` loop steps when that is set, else from
        epoch ``gan_start``."""
        if self.discriminator is None or self.gan_weight <= 0:
            return False
        if self.gan_start_steps is not None:
            return global_step >= self.gan_start_steps
        return epoch >= self.gan_start

    def kl_scale(self) -> float:
        return kl_scale_at(self.kl_weight, self.kl_anneal_steps, self.global_step)

    def losses(self, raw: torch.Tensor, valid: torch.Tensor, kl_scale: float, *,
               train: bool, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None, disc_active: bool = False,
               count: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Metrics, Optional[Dict[str, torch.Tensor]], torch.Tensor]:
        """Total loss, its parts, an EMA codebook's update (else None) and the
        reconstructed image, on one chunk of images in [0, 1]. With
        ``disc_active`` the generator's GAN term uses D's batch statistics
        in ``train`` mode and its running statistics otherwise. Over ranks
        (``count`` the chunk's global valid count) each part is this rank's
        share of the global batch's: the parts summed over the ranks are
        the global losses."""
        model = self.model
        zero = raw.new_zeros(())
        inputs = model.image_to_model_range(raw)
        new_ema = None
        share = 1.0 / self.mesh.process_count if self.mesh is not None else None
        if self.is_vq:
            rec, aux = model(inputs, train=train)
            vq_term, kl_term, new_ema = aux["vq_loss"], zero, aux["ema_update"]
        elif self.mesh is not None and train and noise is None:
            # the global chunk's posterior noise, this rank's rows
            posterior = model.encode(inputs)
            global_shape = (posterior.mu.shape[0] * self.mesh.process_count,) + tuple(
                posterior.mu.shape[1:])
            noise = mesh_lib.rows_of(torch.randn(global_shape, generator=generator,
                                                 dtype=posterior.mu.dtype,
                                                 device=posterior.mu.device), self.mesh)
            rec = model.decode(posterior.sample(noise))
            vq_term, kl_term = zero, posterior.kl().mean()
        else:
            rec, posterior = model(inputs, sample_posterior=train, noise=noise,
                                   generator=generator)
            vq_term, kl_term = zero, posterior.kl().mean()
        rec_img = model.raw_output_to_image(rec, self.recon_type)
        recon = recon_loss(rec, rec_img, raw, valid, self.recon_type, count)
        perc = self.perceptual(rec_img, raw) if self.perceptual is not None else zero
        if share is not None:
            vq_term, kl_term, perc = vq_term * share, kl_term * share, perc * share
        total = (recon + self.perceptual_weight * perc + kl_scale * kl_term
                 + self.codebook_weight * vq_term)
        metrics = {"loss": total, "recon": recon, "kl": kl_term, "vq": vq_term,
                   "perceptual": perc}
        if self.discriminator is not None:
            g_gan = (generator_hinge_loss(self.discriminator(rec_img, train=train))
                     if disc_active else zero)
            if share is not None:
                g_gan = g_gan * share
            total = total + self.gan_weight * g_gan
            metrics.update(loss=total, g_gan=g_gan)
        return total, metrics, new_ema, rec_img

    def disc_loss(self, rec_img: torch.Tensor, raw: torch.Tensor) -> torch.Tensor:
        """D's hinge loss on real images and the detached reconstruction,
        with batch statistics (over ranks, this rank's share)."""
        loss = discriminator_hinge_loss(self.discriminator(raw, train=True),
                                        self.discriminator(rec_img.detach(), train=True))
        return loss if self.mesh is None else loss / self.mesh.process_count

    def _global_metrics(self, metrics: Metrics) -> Metrics:
        """The ranks' shares of each metric summed: the global values."""
        keys = list(metrics)
        stacked = mesh_lib.all_reduce_sum(
            torch.stack([metrics[k].detach().float() for k in keys]), self.mesh)
        return dict(zip(keys, stacked.unbind()))

    def step(self, raw: torch.Tensor, valid: torch.Tensor, *,
             noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             kl_scale: Optional[float] = None,
             disc_active: bool = False) -> Tuple[Metrics, torch.Tensor]:
        """One optimizer step on a batch (B, C, *spatial) with its (B,) valid
        mask, at ``kl_scale`` (default: annealed by this step's own count).
        ``noise``, when given, covers the padded batch: (n_chunks ·
        ceil(B / n_chunks), embed_dim, *latent). Returns the metrics summed
        with the valid counts as weights, and the count; ``p.grad`` holds the
        averaged gradient that was applied (D's too, when ``disc_active``,
        and then D steps as well)."""
        sums, count = self._accumulate(raw, valid, noise, generator,
                                       self.kl_scale() if kl_scale is None else kl_scale,
                                       disc_active)
        if self.mesh is not None and self.reduce_grads:
            mesh_lib.all_reduce_grads(list(self.model.parameters()) + self._disc_trainable,
                                      self.mesh)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_schedule(self.global_step)
        self.optimizer.step()
        if disc_active:
            self.disc_optimizer.step()
        self.global_step += 1
        return sums, count

    def trial(self, raw: torch.Tensor, valid: torch.Tensor, generator: torch.Generator) -> None:
        """The forward and backward of one step at the current ``n_chunks``
        (with the GAN terms when there is a discriminator), drawing from
        ``generator``, then the gradients freed and an EMA codebook
        restored: the optimizers and the rate's step are left as they
        were. It runs as one process's step, with no collective (see
        :meth:`DenoiseTrainStep.trial`)."""
        buffers = {k: b.clone() for k, b in self.model.named_buffers()}
        mesh = self.mesh
        self._use_mesh(None)
        try:
            self._accumulate(raw, valid, None, generator, self.kl_scale(),
                             self.discriminator is not None)
        finally:
            self._use_mesh(mesh)
            self.optimizer.zero_grad(set_to_none=True)
            if self.disc_optimizer is not None:
                self.disc_optimizer.zero_grad(set_to_none=True)
            with torch.no_grad():
                for k, b in self.model.named_buffers():
                    b.copy_(buffers[k])
            del buffers
            if raw.device.type == "cuda":
                torch.cuda.empty_cache()

    def _accumulate(self, raw, valid, noise, generator, kl_scale,
                    disc_active: bool) -> Tuple[Metrics, torch.Tensor]:
        n = self.n_chunks
        chunk = max(1, -(-raw.shape[0] // n))
        pad = n * chunk - raw.shape[0]
        if pad:
            # wrapped rows: masked out of the loss and the counts, but seen
            # by the unmasked terms and an EMA codebook's statistics
            wrap = torch.arange(pad, device=raw.device) % raw.shape[0]
            raw = torch.cat([raw, raw[wrap]])
            valid = torch.cat([valid, valid.new_zeros(pad)])
        if noise is not None and noise.shape[0] != n * chunk:
            raise ValueError(f"noise covers {noise.shape[0]} rows; the padded batch has {n * chunk}")
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        if self.disc_optimizer is not None:
            self.disc_optimizer.zero_grad(set_to_none=True)
        if self.mesh is not None:
            return self._accumulate_over_ranks(raw, valid, noise, generator, kl_scale,
                                               disc_active, chunk)
        sums: Metrics = {}
        count = valid.new_zeros(())
        for i in range(n):
            rows = slice(i * chunk, (i + 1) * chunk)
            vc = valid[rows]
            # D frozen through the generator's loss: its g_gan gradient
            # never reaches D's parameters
            self._set_disc_grad(False)
            total, metrics, new_ema, rec_img = self.losses(
                raw[rows], vc, kl_scale, train=True,
                noise=None if noise is None else noise[rows], generator=generator,
                disc_active=disc_active)
            self._set_disc_grad(True)
            c = vc.sum()
            (total * c).backward()
            if self.discriminator is not None:
                d_gan = raw.new_zeros(())
                if disc_active:
                    d_gan = self.disc_loss(rec_img, raw[rows])
                    (d_gan * c).backward()
                metrics["d_gan"] = d_gan
            if new_ema is not None:
                self.model.codebook.apply_update(new_ema)
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v.detach() * c
            count = count + c
        divisor = torch.clamp(count, min=1.0)
        for p in self.model.parameters():
            if p.grad is not None:
                p.grad.div_(divisor)
        for p in self._disc_trainable:
            if p.grad is not None:
                p.grad.div_(divisor)
        return sums, count

    def _accumulate_over_ranks(self, raw, valid, noise, generator, kl_scale,
                               disc_active: bool, chunk: int) -> Tuple[Metrics, torch.Tensor]:
        """:meth:`_accumulate` over the mesh's ranks: each chunk's shares
        weighted by its global valid count; returns the global metric sums
        and count."""
        n = self.n_chunks
        counts = mesh_lib.all_reduce_sum(valid.reshape(n, chunk).sum(dim=1), self.mesh)
        sums: Metrics = {}
        for i in range(n):
            rows = slice(i * chunk, (i + 1) * chunk)
            c = counts[i]
            self._set_disc_grad(False)
            total, metrics, new_ema, rec_img = self.losses(
                raw[rows], valid[rows], kl_scale, train=True,
                noise=None if noise is None else noise[rows], generator=generator,
                disc_active=disc_active, count=c)
            self._set_disc_grad(True)
            (total * c).backward()
            if self.discriminator is not None:
                d_gan = raw.new_zeros(())
                if disc_active:
                    d_gan = self.disc_loss(rec_img, raw[rows])
                    (d_gan * c).backward()
                metrics["d_gan"] = d_gan
            if new_ema is not None:
                self.model.codebook.apply_update(new_ema)
            for k, v in self._global_metrics(metrics).items():
                sums[k] = sums.get(k, 0.0) + v * c
        count = counts.sum()
        divisor = torch.clamp(count, min=1.0)
        for p in list(self.model.parameters()) + self._disc_trainable:
            if p.grad is not None:
                p.grad.div_(divisor)
        return sums, count

    def _set_disc_grad(self, on: bool) -> None:
        for p in self._disc_trainable:
            p.requires_grad_(on)

    @torch.no_grad()
    def eval(self, raw: torch.Tensor, valid: torch.Tensor,
             kl_scale: Optional[float] = None,
             disc_active: bool = False) -> Tuple[Metrics, torch.Tensor]:
        """The losses at the posterior's mode (KL) or with the codebook in
        eval mode (VQ), summed with the valid count as weight, and the
        count; with ``disc_active``, ``g_gan`` on D's running statistics and
        ``d_gan`` on batch statistics (JAX :441-453)."""
        self.model.eval()
        count = valid.sum()
        if self.mesh is not None:
            count = mesh_lib.all_reduce_sum(count, self.mesh)
        _, metrics, _, rec_img = self.losses(raw, valid,
                                             self.kl_scale() if kl_scale is None else kl_scale,
                                             train=False, disc_active=disc_active,
                                             count=None if self.mesh is None else count)
        if self.discriminator is not None:
            metrics["d_gan"] = (self.disc_loss(rec_img, raw) if disc_active
                                else raw.new_zeros(()))
        if self.mesh is not None:
            metrics = self._global_metrics(metrics)
        return {k: v * count for k, v in metrics.items()}, count


# the name the KL recipe's callers use
KLTrainStep = VAETrainStep


# ---------------------------------------------------------------------------
# The run loop
# ---------------------------------------------------------------------------

# every loss a VAE recipe reports; those the KL recipe has no term for are 0
LOSS_KEYS = ("loss", "recon", "kl", "perceptual", "g_gan", "d_gan", "vq")


def _metric_columns(training_cfg: Mapping[str, Any]) -> List[str]:
    """metrics.csv's columns after ``epoch``, by the config (JAX :182-191)."""
    reg_type = str(training_cfg.get("reg_type", "kl")).lower()
    keys = ["loss", "recon"]
    if reg_type == "kl" or float(training_cfg.get("kl_weight", 0.0)) > 0:
        keys.append("kl")
    if reg_type == "vq" or float(training_cfg.get("codebook_weight", 1.0)) > 0:
        keys.append("vq")
    if float(training_cfg.get("perceptual_weight", 0.0)) > 0:
        keys.append("perceptual")
    if float(training_cfg.get("gan_weight", 0.0)) > 0:
        keys.extend(["g_gan", "d_gan"])
    return keys


def _add_metrics(totals: Dict[str, float], metrics: Metrics) -> None:
    for k, v in metrics.items():
        totals[k] += float(v)


def _grid_shape(count: int) -> Tuple[int, int]:
    if count >= 20:
        return 4, 5
    rows = max(1, int(math.sqrt(count)))
    return rows, max(1, count // rows)


def train(dataset, json_path, val_dataset=None, resume: Optional[str] = None, *,
          max_steps_per_epoch: Optional[int] = None, device: DeviceArg = None) -> Path:
    """Train the VAE of the config at ``json_path`` on ``dataset``,
    validating on ``val_dataset`` when given, on ``device`` (CUDA by
    default); returns the run dir."""
    try:
        return _train(dataset, json_path, val_dataset, resume,
                      max_steps_per_epoch=max_steps_per_epoch, device=device)
    finally:
        # sequence_parallel's routing is bound to the training mesh
        attention_ops.clear_sequence_parallel()


def _train(dataset, json_path, val_dataset, resume, *, max_steps_per_epoch: Optional[int],
           device: DeviceArg) -> Path:
    logging.basicConfig(level=logging.INFO, format=loop.LOG_FORMAT, force=True)
    cfg = config_utils.load_json_config(json_path)
    training_cfg = cfg["training"]
    mesh_lib.maybe_initialize_distributed(device)
    device = mesh_lib.rank_device(device) if mesh_lib.group_active() else resolve_device(device)
    main = mesh_lib.is_main_process()
    logging.info("%s on %s", mesh_lib.describe_group(), device)
    config_utils.set_seed(training_cfg.get("seed"))
    seed = int(training_cfg.get("seed") or 0)
    ckpt_utils.set_checkpoint_backend(str(training_cfg.get("checkpoint_backend", "torch")))

    batch_size = int(training_cfg.get("batch_size", 4))
    epochs = int(training_cfg.get("epochs", 1))
    recon_type = training_cfg.get("recon_type", "l1")
    kl_weight = float(training_cfg.get("kl_weight", 0.0))
    kl_anneal_steps = int(training_cfg.get("kl_anneal_steps", 0))
    save_every = int(training_cfg.get("save_every", 1))
    checkpoint_every = int(training_cfg.get("checkpoint_every_epochs", 1))
    if checkpoint_every > 1 and save_every % checkpoint_every != 0:
        logging.warning(
            "save_every=%d is finer than checkpoint_every_epochs=%d: epoch "
            "snapshots are only written on gather epochs (every %d), so "
            "off-cadence snapshots will be skipped.",
            save_every, checkpoint_every, checkpoint_every,
        )
    output_dir = loop.run_dir_for(training_cfg, cfg, "checkpoints/vae", resume)

    best_metric = float("inf")
    metrics_path = output_dir / "metrics.csv"
    metrics_keys = _metric_columns(training_cfg)
    if main and not metrics_path.exists():
        metrics_path.write_text("epoch," + ",".join(metrics_keys) + "\n")

    plan = loop.parallel_plan(training_cfg, batch_size, device, vae=True)
    mesh = plan.world
    start = time.perf_counter()
    model = build_vae_model(cfg, device=device)
    mesh_lib.replicate(mesh, model)
    logging.info("Built the VAE on %s in %.3f s", device, time.perf_counter() - start)
    model_cfg = cfg.get("model", {})
    if main:
        summarize_model(model, model_cfg, training_cfg, name="vae")
    steps_per_epoch = loop.steps_per_epoch(len(dataset), batch_size, plan.rows[1])
    trainer = VAETrainStep(model, training_cfg, steps_per_epoch=steps_per_epoch,
                           mesh=plan.batch_mesh)

    logging.info(
        "Data: train_samples=%d%s | batch_size=%d | grad_accum=%d | epochs=%d",
        len(dataset), f", val_samples={len(val_dataset)}" if val_dataset is not None else "",
        batch_size, trainer.n_chunks, epochs,
    )

    sample_count = int(training_cfg.get("visual_samples", 20))
    visual_enabled = bool(training_cfg.get("save_images", True)) and main
    visual_every = int(training_cfg.get("save_images_every", 1))
    sample_dataset = val_dataset if val_dataset is not None else dataset
    sample_batch = prepare_eval_batch(sample_dataset, sample_count, seed=training_cfg.get("seed"))
    latent = latent_shape(model_cfg)

    probe = np.stack([np.asarray(dataset[0]["target"], np.float32)] * batch_size)

    def _build_step(accum: int) -> VAETrainStep:
        trainer.n_chunks = accum
        return trainer

    def _trial(step: VAETrainStep, _accum: int) -> None:
        # a generator of its own: the loop's draws are untouched; the whole
        # model, no ring
        with attention_ops.sequence_parallel_scope(None):
            step.trial(torch.from_numpy(probe).to(device), torch.ones(batch_size, device=device),
                       torch.Generator(device).manual_seed(0))

    trainer = loop.tune_grad_accum(
        plan, _build_step, _trial, batch_size=batch_size, grad_accum=trainer.n_chunks,
        allow_microbatching=bool(training_cfg.get("allow_microbatching", True)),
        what="vae train step")

    generator = torch.Generator(device).manual_seed(seed + 23)
    start_epoch = 1
    resume_flag = loop.resume_path(resume, training_cfg)
    if resume_flag:
        ckpt_utils.flush_checkpoint_writes()
    if resume_flag and resume_flag.exists():
        payload = ckpt_utils.load_checkpoint(resume_flag)
        model.load_state_dict(payload["model"], strict=True)
        if payload.get("optimizer") is not None:
            trainer.global_step = ckpt_utils.load_optimizer_state(
                trainer.optimizer, payload["optimizer"], model)
        if trainer.discriminator is not None:
            if payload.get("extra_state") is not None:
                ckpt_utils.load_disc_params(trainer.discriminator, payload["extra_state"])
            if payload.get("disc_optimizer") is not None:
                disc_step = ckpt_utils.load_optimizer_state(
                    trainer.disc_optimizer, payload["disc_optimizer"], trainer.discriminator,
                    constant_rate=True)
                logging.info("Resumed the discriminator and its optimizer (step %d)", disc_step)
        loop.restore_generator(generator, payload.get("rng_state"))
        best_metric = float(payload.get("best_metric", best_metric))
        start_epoch = int(payload.get("epoch", 0)) + 1
        logging.info("Resumed from %s (epoch %d, optimizer step %d)", resume_flag,
                     start_epoch - 1, trainer.global_step)
    trainer.shard(plan)
    if plan.sharded:
        logging.info("Parallel strategy %s: %d bytes of parameters and optimizer state on this "
                     "rank", plan.kind, loop.state_bytes(model, trainer.optimizer) + (
                         loop.state_bytes(trainer.discriminator, trainer.disc_optimizer)
                         if trainer.discriminator is not None else 0))

    # the KL anneal's counter: the loop's steps in this run
    global_step = 0
    for epoch in range(start_epoch, epochs + 1):
        totals = dict.fromkeys(LOSS_KEYS, 0.0)
        num_samples, n_steps, data_wait = 0, 0, 0.0
        pending: List[Tuple[Metrics, torch.Tensor]] = []
        t_epoch = time.perf_counter()
        batch_iter = loop.with_progress(
            loop.host_batches(dataset, batch_size, training_cfg, seed=seed, epoch=epoch,
                              device=device, rows=plan.rows), steps_per_epoch,
            f"VAE {epoch}/{epochs}")
        batches = iter(batch_iter)
        while True:
            t_wait = time.perf_counter()
            batch = next(batches, None)
            data_wait += time.perf_counter() - t_wait
            if batch is None:
                break
            placed = batch_to_device({"target": batch["target"], "valid": batch["valid"]}, device)
            m, count = trainer.step(placed["target"], placed["valid"], generator=generator,
                                    kl_scale=kl_scale_at(kl_weight, kl_anneal_steps, global_step),
                                    disc_active=trainer.disc_is_active(epoch, global_step))
            # one step in flight: read step i - 1's metrics while step i runs
            pending.append((m, count))
            if len(pending) > 1:
                pm, pc = pending.pop(0)
                _add_metrics(totals, pm)
                num_samples += int(pc)
            global_step += 1
            n_steps += 1
            if hasattr(batch_iter, "set_postfix"):
                batch_iter.set_postfix(loss=f"{totals['loss'] / max(num_samples, 1):.4f}")
            if max_steps_per_epoch is not None and n_steps >= max_steps_per_epoch:
                break
        for pm, pc in pending:
            _add_metrics(totals, pm)
            num_samples += int(pc)
        steps_s = time.perf_counter() - t_epoch

        averaged = {k: v / max(1, num_samples) for k, v in totals.items()}
        logging.info(
            "Epoch %03d | loss %.6f (recon %.6f, perc %.6f, kl %.6f, vq %.6f, g_gan %.6f, "
            "d_gan %.6f) | %.3f samples/s", epoch, averaged["loss"], averaged["recon"],
            averaged["perceptual"], averaged["kl"], averaged["vq"], averaged["g_gan"],
            averaged["d_gan"], num_samples / max(steps_s, 1e-9))

        val_s = 0.0
        val_avg = None
        if val_dataset is not None:
            t_val = time.perf_counter()
            val_totals = dict.fromkeys(LOSS_KEYS, 0.0)
            val_samples = 0
            kl_scale = kl_scale_at(kl_weight, kl_anneal_steps, global_step)
            disc_active = trainer.disc_is_active(epoch, global_step)
            for batch in epoch_batches(val_dataset, batch_size, shuffle=False, seed=seed,
                                       epoch=epoch, process_index=plan.rows[0],
                                       process_count=plan.rows[1]):
                placed = batch_to_device({"target": batch["target"], "valid": batch["valid"]},
                                         device)
                m, count = trainer.eval(placed["target"], placed["valid"], kl_scale, disc_active)
                _add_metrics(val_totals, m)
                val_samples += int(count)
            val_avg = {k: v / max(1, val_samples) for k, v in val_totals.items()}
            val_s = time.perf_counter() - t_val
            logging.info(
                "Epoch %03d | val_loss %.6f (recon %.6f, perc %.6f, kl %.6f, vq %.6f, "
                "g_gan %.6f, d_gan %.6f)", epoch, val_avg["loss"], val_avg["recon"],
                val_avg["perceptual"], val_avg["kl"], val_avg["vq"], val_avg["g_gan"],
                val_avg["d_gan"])

        current_metric = val_avg["loss"] if val_avg is not None else averaged["loss"]
        ckpt_s = vis_s = 0.0
        saving = epoch % checkpoint_every == 0 or epoch == epochs
        saved = main and saving
        should_save = saved and (epoch % save_every == 0 or epoch == epochs)
        epoch_dir = output_dir / "epochs" / f"epoch{epoch:04d}"
        disc = trainer.discriminator
        # with the model cut, every rank gathers its part of the state
        model_state = plan.full_model_state(model) if saving else None
        if saved:
            # "best" at checkpoint granularity: an unsaved epoch never lowers it
            improved = current_metric < best_metric
            best_metric = min(best_metric, current_metric)
        gathered = {}
        if saving:
            gathered["optimizer"] = plan.full_optimizer_state(model, trainer.optimizer)
            if disc is not None:
                gathered["disc_optimizer"] = plan.full_optimizer_state(disc, trainer.disc_optimizer)
                gathered["disc_params"] = {k: v.detach().cpu()
                                           for k, v in plan.full_model_state(disc).items()}
        if saved:
            state = {"model": model_state, "optimizer": gathered["optimizer"],
                     "disc_optimizer": gathered.get("disc_optimizer"),
                     "scheduler": {"last_epoch": epoch}, "scaler": None, "epoch": epoch,
                     "best_metric": best_metric, "rng_state": loop.generator_state(generator)}
            if disc is not None:
                state["extra_state"] = {"disc_params": gathered["disc_params"]}
            mirrors = ([output_dir / "vae_best.pt"] if improved else []) + (
                [epoch_dir / "epoch.pt"] if should_save else [])
            t_ckpt = time.perf_counter()
            ckpt_utils.save_checkpoint_with_mirrors(state, output_dir / "vae_last.pt", mirrors)
            ckpt_s = time.perf_counter() - t_ckpt
            if improved:
                logging.info("New best (%.6f) -> %s", best_metric, output_dir / "vae_best.pt")
            if should_save:
                logging.info("Saved epoch checkpoint: %s", epoch_dir / "epoch.pt")

        if main:
            with metrics_path.open("a") as handle:
                handle.write(",".join([f"{epoch}"] + [f"{averaged[k]:.6f}" for k in metrics_keys])
                             + "\n")

        visual_epoch = (saving and (epoch % save_every == 0 or epoch == epochs)
                        and bool(training_cfg.get("save_images", True))
                        and (epoch % visual_every == 0 or epoch == epochs))
        vis_model = model
        if plan.sharded and visual_epoch:
            # rank 0 draws alone, from a whole copy every rank gathers
            whole = model_state if model_state is not None else plan.full_model_state(model)
            if main:
                vis_model = build_vae_model(cfg, device=device)
                vis_model.load_state_dict(whole)
        if should_save and visual_enabled and visual_epoch:
            t_vis = time.perf_counter()
            vis_gen = torch.Generator(device).manual_seed((seed + 23) * 100003 + epoch)
            vis_model.eval()
            with torch.no_grad(), attention_ops.sequence_parallel_scope(None):
                rec, _ = reconstruct_raw(
                    vis_model,
                    vis_model.image_to_model_range(torch.from_numpy(sample_batch).to(device)))
                rec_vis = vis_model.raw_output_to_image(rec, recon_type=recon_type).cpu().numpy()
                noise = torch.randn((sample_count, *latent), generator=vis_gen, device=device)
                gen = vis_model.raw_output_to_image(vis_model.decode(noise), recon_type=recon_type)
                gen_vis = np.clip(gen.cpu().numpy(), 0, 1)
            rows, cols = _grid_shape(sample_count)
            save_image(make_grid(np.clip(sample_batch, 0.0, 1.0), rows, cols),
                       epoch_dir / "input.png")
            save_image(make_grid(np.clip(rec_vis, 0, 1), rows, cols), epoch_dir / "recon.png")
            save_image(make_grid(gen_vis, rows, cols), epoch_dir / "gen.png")
            vis_s = time.perf_counter() - t_vis
        logging.info("Epoch %03d timing | %d steps in %.3f s (%.3f s waiting for data) | "
                     "validation %.3f s | checkpoint %.3f s | visuals %.3f s | optimizer step %d",
                     epoch, n_steps, steps_s, data_wait, val_s, ckpt_s, vis_s, trainer.global_step)
    ckpt_utils.flush_checkpoint_writes()
    mesh_lib.agree_max(0, mesh)  # no rank returns before rank 0's writes landed
    return output_dir


def debug_visual_only(dataset, json_path, ckpt_path, *, output_dir=None,
                      visual_samples: int = 10, seed: Optional[int] = None,
                      device: DeviceArg = None) -> Path:
    """Load a checkpoint and write the reconstructions of a seeded pick of
    samples: grids and each sample's target and output through the
    dataset's writer."""
    from fmdm_tpu_torch.data.dataset_utils import save_output_tensor

    logging.basicConfig(level=logging.INFO, format=loop.LOG_FORMAT, force=True)
    cfg = config_utils.load_json_config(json_path)
    model_cfg = cfg.get("model", {})
    if str(model_cfg.get("model_type", "")).lower() != "vae":
        raise ValueError(f"Expected model_type 'vae', got '{model_cfg.get('model_type')}'.")
    training_cfg = cfg["training"]
    use_seed = seed if seed is not None else training_cfg.get("seed")
    config_utils.set_seed(use_seed)
    device = resolve_device(device)
    model = build_vae_model(cfg, device=device, ckpt_path=Path(ckpt_path)).eval()
    recon_type = training_cfg.get("recon_type", "l1")

    out_root = Path(output_dir) if output_dir is not None else (
        Path(training_cfg.get("output_dir", "checkpoints/vae")) / "debug_train_like")
    out_root.mkdir(parents=True, exist_ok=True)

    indices = select_visual_indices(dataset, int(visual_samples), seed=use_seed)
    batch = np.stack([np.asarray(dataset[idx]["target"], np.float32) for idx in indices])
    with torch.no_grad():
        rec, _ = reconstruct_raw(model, model.image_to_model_range(torch.from_numpy(batch).to(device)))
        rec_vis = np.clip(model.raw_output_to_image(rec, recon_type=recon_type).cpu().numpy(),
                          0.0, 1.0)
    input_vis = np.clip(batch, 0.0, 1.0)

    rows = max(1, int(math.sqrt(rec_vis.shape[0])))
    cols = max(1, rec_vis.shape[0] // rows)
    save_image(make_grid(input_vis, rows, cols), out_root / "grid_input.png")
    save_image(make_grid(rec_vis, rows, cols), out_root / "grid_output.png")
    save_image(make_grid(input_vis, rows, cols), out_root / "grid_target.png")

    for b, idx in enumerate(indices):
        if not hasattr(dataset, "data"):
            break
        row = dataset.data[idx]
        save_output_tensor(dataset, row, dataset.target_key, input_vis[b], out_root / "target")
        save_output_tensor(dataset, row, dataset.target_key, rec_vis[b], out_root / "generated")
        if getattr(dataset, "conditioning_key", None) is not None and dataset[idx].get("image") is not None:
            save_output_tensor(dataset, row, dataset.conditioning_key,
                               np.asarray(dataset[idx]["image"]), out_root / "conditioning")

    logging.info("VAE debug visual-only generation completed for %d samples. Output: %s",
                 len(indices), out_root)
    print(f"VAE debug visual-only generation completed for {len(indices)} samples.")
    print(f"Output directory: {out_root}")
    return out_root
