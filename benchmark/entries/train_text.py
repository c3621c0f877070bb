"""
The text-conditioned train entry: ``DenoiseTrainStep.step`` of the port on
Stable Diffusion 3's transformer, driven as ``entries/train.py`` drives the
UNets (one caller, one step in flight, batches on the device), with the
text conditioning (``conditioning`` "text": a pair of tokens and pooled
vector per sample), t drawn as the configuration says (``t_sampling``) and
the model given the timestep the configuration says (``timestep_input``).

Set-up draws the weights (every parameter by ``inputs.draw_weights``'s
rule, the position table computed by the reference), builds the program
through the factory (``unet_impl`` "sd3_mmdit"), draws a pool of (latent,
tokens, pooled) from the seed in place of the VAE's and the text encoders'
outputs, runs the ``checked_steps`` and keeps what the check compares, as
the UNets' entry does. The weights then wait in host memory, so that the
window holds on the card only what training holds. The reference
(``reference/mmdit.py``) runs its own flow loss on the same feed.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from benchmark import build, counters, inputs
from benchmark.entries import train
from benchmark.reference import mmdit
from benchmark.reference.ops import Op, Ops


def draw_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The parameters drawn from the seed, and the position table."""
    model = counters.build_reference(cfg, Ops(), "meta")
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    weights = inputs.draw_weights(shapes, seed, device)
    unet = cfg["model"]["unet"]
    dim = int(unet["num_attention_heads"]) * int(unet["attention_head_dim"])
    weights["pos_embed.pos_embed"] = mmdit.pos_table(
        dim, int(unet["pos_embed_max_size"]), int(unet["sample_size"]) // int(unet["patch_size"]),
        device)
    return weights


def text_pool(cfg: dict, n_batches: int, batch: int, seed: int, device) -> List[dict]:
    """``n_batches`` batches of latents (batch, C, H, W), text tokens
    (batch, S, joint_attention_dim) and pooled vectors (batch,
    pooled_projection_dim), each element N(0, 1)."""
    unet, gen = cfg["model"]["unet"], inputs.generator(seed, 1, device)
    n = n_batches * batch
    x0 = torch.randn((n, int(cfg["channels"]), *cfg["spatial"]), generator=gen, device=device)
    tokens = torch.randn((n, int(cfg["context_tokens"]), int(unet["joint_attention_dim"])),
                         generator=gen, device=device)
    pooled = torch.randn((n, int(unet["pooled_projection_dim"])), generator=gen, device=device)
    return [{"x0": a, "tokens": c, "pooled": p}
            for a, c, p in zip(x0.split(batch), tokens.split(batch), pooled.split(batch))]


class Entry(train.Entry):
    def setup(self) -> None:
        from fmdm_tpu_torch.models.factories import DiffusionUNetFactory
        from fmdm_tpu_torch.schedulers.registry import build_scheduler
        from fmdm_tpu_torch.train.common import make_adamw, make_denoise_train_step

        cfg, cell, dev = self.cfg, self.cell, self.device
        opt = cfg["optimizer"]
        start = time.perf_counter()
        self.weights = draw_weights(cfg, self.seed, dev)
        self.model = DiffusionUNetFactory().build(cfg["model"]["unet"], cfg["conditioning"],
                                                  cfg["channels"], device="meta")
        self.model.to_empty(device=dev)
        self.model.load_state_dict(self.weights, strict=True)
        scheduler, _ = build_scheduler(cfg["model"]["scheduler"], {})
        self.optimizer, rate = make_adamw(self.model.parameters(), opt["learning_rate"],
                                          opt["weight_decay"], opt["lr_warmup_steps"],
                                          opt["num_training_steps"])
        self.trainer = make_denoise_train_step(
            self.model, scheduler, self.optimizer, rate, variant=cfg["variant"],
            conditioning_mode=cfg["conditioning"], latent_norm=None,
            compute_dtype=build.DTYPES[cfg["compute_dtype"]], device=dev,
            t_sampling=cfg["t_sampling"], timestep_input=cfg["timestep_input"])
        self.trainer.global_step = int(opt["start_step"])
        self.pool = text_pool(cfg, cell["pool_batches"], cell["batch"], self.seed, dev)
        self.valid = torch.ones((cell["batch"],), device=dev)
        self.gen = inputs.generator(self.seed, 2, dev)
        self.checked = []
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
        self.weights = {k: v.cpu() for k, v in self.weights.items()}
        self.setup_seconds = {"build": built - start,
                              "checked steps": time.perf_counter() - built}

    def _launch_step(self):
        b = self.pool[self.steps % len(self.pool)]
        rows = b["x0"].shape[0]
        noise = torch.randn(b["x0"].shape, generator=self.gen, device=self.device)
        t = (torch.sigmoid(torch.randn((rows,), generator=self.gen, device=self.device))
             if self.cfg["t_sampling"] == "logit_normal"
             else torch.rand((rows,), generator=self.gen, device=self.device))
        loss_sum, count = self.trainer.step(
            {"target": b["x0"], "text": (b["tokens"], b["pooled"]), "valid": self.valid},
            noise=noise, t=t)
        self.steps += 1
        return loss_sum, count, dict(b, noise=noise, t=t)

    def reference_readings(self, precision: str = "f32", half_batch: bool = False) -> dict:
        opt = self.cfg["optimizer"]
        if self.device.type == "cuda":
            build.f32_reference_numerics()
        model = build.reference_model(self.cfg, self.weights, self.device, precision)
        feed = self.checked if not half_batch else [
            {k: v[: v.shape[0] // 2] for k, v in b.items()} for b in self.checked]
        out = mmdit.train_steps(model, feed, self.weights, base_lr=opt["learning_rate"],
                                weight_decay=opt["weight_decay"], warmup=opt["lr_warmup_steps"],
                                total=opt["num_training_steps"], start_step=int(opt["start_step"]))
        del model
        return out

    def ops(self) -> List[Op]:
        """One forward at the cell's batch on the reference's shapes, the
        text tokens and pooled vector beside the latent."""
        cfg, batch = self.cfg, int(self.cell["batch"])
        unet = cfg["model"]["unet"]
        recorder: List[Op] = []
        model = counters.build_reference(cfg, Ops(recorder=recorder), "meta")
        model.requires_grad_(True)
        meta = dict(device="meta")
        with torch.enable_grad():
            model(torch.empty((batch, cfg["in_channels"], *cfg["spatial"]), **meta),
                  torch.zeros((batch,), **meta),
                  torch.empty((batch, cfg["context_tokens"], unet["joint_attention_dim"]), **meta),
                  torch.empty((batch, unet["pooled_projection_dim"]), **meta))
        return recorder

