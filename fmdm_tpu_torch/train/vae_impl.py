"""
The KL autoencoder's train and eval steps (counterpart of the closure in
``fmdm_tpu/train/vae_impl.py:297-451`` for ``reg_type: "kl"``) and its
learning-rate schedules (``_make_lr_schedule``, :57-82).

One step: the batch is wrap-padded to ``n_chunks`` equal chunks, the padded
rows masked out of the reconstruction loss (``valid`` = 0) and of the counts;
each chunk's loss is L1 (or MSE) over its valid rows plus ``kl_scale`` times
the mean KL of the posterior over all its rows; the gradients are summed with
each chunk's valid count as weight, divided by the total count, and applied
by ``torch.optim.AdamW`` (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay),
which is ``optax.adamw``'s update. The posterior is sampled from an explicit
noise tensor or a ``torch.Generator``.

On CUDA the mid attention's forward runs K3 and its backward K4 and K5; K1's
backward recomputes its plain version. Perceptual and GAN losses, the VQ
recipe, the mesh, FSDP, tensor and sequence parallelism raise
``NotImplementedError``. The run loop (run directories, CSVs, checkpoints,
data) is not ported yet.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

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


def recon_loss(rec_img: torch.Tensor, raw: torch.Tensor, valid: torch.Tensor,
               recon_type: str) -> torch.Tensor:
    """Mean L1 or squared error over the valid rows."""
    mask = valid.reshape((-1,) + (1,) * (raw.dim() - 1))
    denom = torch.clamp(valid.sum(), min=1.0) * math.prod(raw.shape[1:])
    if recon_type == "l1":
        return (torch.abs(rec_img - raw) * mask).sum() / denom
    if recon_type == "mse":
        return (torch.square(rec_img - raw) * mask).sum() / denom
    if recon_type in ("bce", "focal", "bce_focal"):
        raise NotImplementedError(f"recon_type '{recon_type}' is not ported yet")
    raise ValueError(f"Unsupported recon_type '{recon_type}'.")


def _refuse_unported(training_cfg: Mapping[str, Any]) -> None:
    unported = {
        "perceptual_weight > 0": float(training_cfg.get("perceptual_weight", 0.0)) > 0,
        "gan_weight > 0": float(training_cfg.get("gan_weight", 0.0)) > 0,
        "reg_type 'vq'": str(training_cfg.get("reg_type", "kl")).lower() != "kl",
        "fsdp": bool(training_cfg.get("fsdp", False)),
        "tensor_parallel > 1": int(training_cfg.get("tensor_parallel", 1) or 1) > 1,
        "sequence_parallel > 1": int(training_cfg.get("sequence_parallel", 1) or 1) > 1,
        f"recon_type '{training_cfg.get('recon_type')}'":
            str(training_cfg.get("recon_type", "l1")) not in ("l1", "mse"),
    }
    refused = [name for name, on in unported.items() if on]
    if refused:
        raise NotImplementedError(f"VAE training with {', '.join(refused)} is not ported yet")


class KLTrainStep:
    """Train and eval steps of an ``AutoencoderKL`` under a config's
    ``training`` section (learning_rate, weight_decay, kl_weight,
    kl_anneal_steps, recon_type, gradient_accumulation_steps, scheduler)."""

    def __init__(self, model: torch.nn.Module, training_cfg: Mapping[str, Any], *,
                 steps_per_epoch: int = 1, n_chunks: Optional[int] = None):
        _refuse_unported(training_cfg)
        self.model = model
        self.recon_type = str(training_cfg.get("recon_type", "l1"))
        self.kl_weight = float(training_cfg.get("kl_weight", 0.0))
        self.kl_anneal_steps = int(training_cfg.get("kl_anneal_steps", 0))
        self.n_chunks = max(1, int(n_chunks if n_chunks is not None
                                   else training_cfg.get("gradient_accumulation_steps", 1)))
        lr = float(training_cfg.get("learning_rate", 1e-4))
        self.lr_schedule = make_lr_schedule(lr, training_cfg, int(training_cfg.get("epochs", 1)),
                                            steps_per_epoch)
        self.optimizer = torch.optim.AdamW(
            model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=float(training_cfg.get("weight_decay", 0.0)))
        self.global_step = 0

    def kl_scale(self) -> float:
        return kl_scale_at(self.kl_weight, self.kl_anneal_steps, self.global_step)

    def losses(self, raw: torch.Tensor, valid: torch.Tensor, kl_scale: float, *,
               train: bool, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Metrics]:
        """Total loss and its parts on one chunk of images in [0, 1]."""
        model = self.model
        rec, posterior = model(model.image_to_model_range(raw), sample_posterior=train,
                               noise=noise, generator=generator)
        kl_term = posterior.kl().mean()
        recon = recon_loss(model.raw_output_to_image(rec, self.recon_type), raw, valid,
                           self.recon_type)
        total = recon + kl_scale * kl_term
        return total, {"loss": total, "recon": recon, "kl": kl_term}

    def step(self, raw: torch.Tensor, valid: torch.Tensor, *,
             noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> Tuple[Metrics, torch.Tensor]:
        """One optimizer step on a batch (B, C, *spatial) with its (B,) valid
        mask. ``noise``, when given, covers the padded batch: (n_chunks ·
        ceil(B / n_chunks), embed_dim, *latent). Returns the metrics summed
        with the valid counts as weights, and the count; ``p.grad`` holds the
        averaged gradient that was applied."""
        n = self.n_chunks
        chunk = max(1, -(-raw.shape[0] // n))
        pad = n * chunk - raw.shape[0]
        if pad:
            wrap = torch.arange(pad, device=raw.device) % raw.shape[0]
            raw = torch.cat([raw, raw[wrap]])
            valid = torch.cat([valid, valid.new_zeros(pad)])
        if noise is not None and noise.shape[0] != n * chunk:
            raise ValueError(f"noise covers {noise.shape[0]} rows; the padded batch has {n * chunk}")
        kl_scale = self.kl_scale()
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        sums: Metrics = {}
        count = valid.new_zeros(())
        for i in range(n):
            rows = slice(i * chunk, (i + 1) * chunk)
            vc = valid[rows]
            total, metrics = self.losses(raw[rows], vc, kl_scale, train=True,
                                         noise=None if noise is None else noise[rows],
                                         generator=generator)
            c = vc.sum()
            (total * c).backward()
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v.detach() * c
            count = count + c
        divisor = torch.clamp(count, min=1.0)
        for p in self.model.parameters():
            if p.grad is not None:
                p.grad.div_(divisor)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_schedule(self.global_step)
        self.optimizer.step()
        self.global_step += 1
        return sums, count

    @torch.no_grad()
    def eval(self, raw: torch.Tensor, valid: torch.Tensor) -> Tuple[Metrics, torch.Tensor]:
        """The losses at the posterior's mode, summed with the valid count as
        weight, and the count."""
        self.model.eval()
        _, metrics = self.losses(raw, valid, self.kl_scale(), train=False)
        count = valid.sum()
        return {k: v * count for k, v in metrics.items()}, count
