"""
Where the time of the flagship's denoise train step goes, on one CUDA card.

    python -m fmdm_tpu_torch.train.profile_denoise [--batch 8] [--steps 3] [--seed 0] [--trace FILE]

Builds the trainer of ``configs/LDCT/LDCT_ddpm_diffusers_nd.json`` through
``build_denoise_trainer`` (DDPM, concatenate conditioning, AdamW at the
cosine-warmup rate, weights drawn from the config's seed), in f32 with TF32
off as the config trains (``mixed_precision: "no"``). Runs its step on
synthetic batches of ``--batch`` 256² slices once to warm up, then
``--steps`` times under ``torch.profiler``. Prints the window per step
(host clock, ended by a synchronize), the device busy time (the union of the
kernels' intervals on the device timeline) and idle share, and the device
time per class:

- a kernel launched under the backward node of K1's or K2's autograd
  function (``_GroupNormActBackward``, ``_SmallTAttentionBackward``: the
  plain version's forward recomputed, then its autograd) counts as that
  kernel's plain backward, and the kernels of each are listed by name;
- every other kernel is classed by its name as ``sample/profile_sample.py``
  classes it, so K1's and K2's forward kernels stand apart.

Then the top kernels, the convolutions' FLOPs against the f32 peak, and one
JSON line. The card's name and power limit are printed beside them.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Optional

import torch

from fmdm_tpu_torch.sample.profile_sample import (
    card, classify, conv_flops, device_busy_ms, device_time_by_class, print_breakdown)
from fmdm_tpu_torch.train.denoise_lib import build_denoise_trainer

CONFIG = Path(__file__).resolve().parents[2] / "configs" / "LDCT" / "LDCT_ddpm_diffusers_nd.json"
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores, NVIDIA data sheet

# autograd nodes whose kernels make up a kernel's plain backward
BACKWARD_NODES = (("K1 plain backward", "_GroupNormActBackward"),
                  ("K2 plain backward", "_SmallTAttentionBackward"))


def backward_origin(event) -> Optional[str]:
    """The plain backward an event runs under (from its CPU ancestors), if any."""
    node = event
    while node is not None:
        for label, fragment in BACKWARD_NODES:
            if fragment in node.name:
                return label
        node = node.cpu_parent
    return None


def device_time_by_origin(prof):
    """Device ms per class and per (class, kernel name) of a finished
    ``torch.profiler`` run, each kernel taken from the CPU event that
    launched it: under a node of ``BACKWARD_NODES`` it is that plain
    backward's, else the class of its name."""
    by_class, by_kernel = defaultdict(float), defaultdict(float)
    for event in prof.events():
        if event.device_type != torch.autograd.DeviceType.CPU or not event.kernels:
            continue
        origin = backward_origin(event)
        for kernel in event.kernels:
            label = origin or classify(kernel.name)
            by_class[label] += kernel.duration / 1e3
            by_kernel[(label, kernel.name)] += kernel.duration / 1e3
    return by_class, by_kernel


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--trace", default=None, help="write a chrome trace here")
    args = parser.parse_args()

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = json.loads(CONFIG.read_text())
    model, _, trainer = build_denoise_trainer(cfg, variant="diffusion", num_samples=args.batch)
    # past the warmup, where the rate is the config's learning rate
    trainer.global_step = int(cfg["training"]["lr_warmup_steps"])
    gen = torch.Generator("cuda").manual_seed(args.seed)
    shape = (args.batch, 1, 256, 256)
    batch = {"target": torch.rand(shape, generator=gen, device="cuda") * 2 - 1,
             "image": torch.rand(shape, generator=gen, device="cuda") * 2 - 1,
             "valid": torch.ones(args.batch, device="cuda")}

    def step():
        trainer.step(batch, generator=gen)

    name = card()
    print(f"card: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    flops, handles = conv_flops(model)
    step()  # warm-up: the kernel build, cuDNN plans; counts one forward's conv FLOPs
    for h in handles:
        h.remove()
    conv_work = 3 * flops["flops"]  # forward, dgrad and wgrad
    torch.cuda.synchronize()

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        start = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - start) * 1e3
    busy_ms = device_busy_ms(prof)
    by_name, _ = device_time_by_class(prof)
    by_class, by_kernel = device_time_by_origin(prof)
    n = args.steps
    print(f"flagship denoise train step f32, batch {args.batch}: window {window_ms / n:.3f} ms per "
          f"step ({args.batch * n / window_ms * 1e3:.2f} images/s under the profiler), device busy "
          f"{busy_ms / n:.3f} ms, idle {100 * (1 - busy_ms / window_ms):.1f}%; kernel times summed "
          f"{sum(by_name.values()) / n:.3f} ms, {sum(by_class.values()) / n:.3f} ms of them "
          f"traced to the op that launched them [{name}]")
    print("device time by class (K1 and K2 plain backwards by the autograd node they ran under):")
    print_breakdown(by_class, {kernel: ms for (_, kernel), ms in by_kernel.items()}, n, "step")
    for label, _ in BACKWARD_NODES:
        kernels = sorted(((ms, k) for (lab, k), ms in by_kernel.items() if lab == label), reverse=True)
        print(f"{label}: {by_class.get(label, 0.0) / n:.3f} ms per step in {len(kernels)} kernel "
              f"names:")
        for ms, kernel in kernels[:12]:
            print(f"  {ms / n:9.3f} ms per step  {kernel[:110]}")
    conv_ms = by_class.get("convolution", 0.0) / n
    rate = conv_work / max(conv_ms, 1e-9) / 1e9
    print(f"convolutions: {conv_work / 1e12:.3f} TFLOP per step (3x the forward's), {rate:.1f} "
          f"TFLOP/s = {100 * rate * 1e12 / F32_OPS_PER_S:.1f}% of the f32 peak [{name}]")
    if args.trace:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)
    print(json.dumps({
        "card": name, "batch": args.batch, "steps": n, "ms_per_step": window_ms / n,
        "busy_ms_per_step": busy_ms / n, "idle_share": 1 - busy_ms / window_ms,
        "ms_per_step_by_class": {k: v / n for k, v in by_class.items()},
        "conv_tflop_per_step": conv_work / 1e12,
    }))


if __name__ == "__main__":
    main()
