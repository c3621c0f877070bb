"""
Where the time of the KL-VAE's train step and reconstruct goes, on one CUDA
card.

    python -m fmdm_tpu_torch.train.profile_vae [--batch 4] [--steps 3] [--seed 0] [--trace DIR]

Builds the KL-VAE of ``configs/LDCT/LDCT_autoencoder_kl.json`` at its
published widths (weights drawn from ``--seed``), in f32 with TF32 off. Runs
the train step (L1 + KL, AdamW) and then ``reconstruct_vae_batch`` at
``--batch``, each once to warm up and ``--steps`` times under
``torch.profiler``. Prints, for each, the window per step or call, the device
busy time (the union of the kernels' intervals on the device timeline) and
idle share, the device time per kernel class (as
``sample/profile_sample.py`` classifies it), the top kernels, the
convolutions' FLOPs against the f32 peak, and one JSON line. The card's name
and power limit are printed beside them.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from fmdm_tpu_torch.sample.profile_sample import (
    card, conv_flops, device_busy_ms, device_time_by_class, print_breakdown)
from fmdm_tpu_torch.sample.vae_utils import build_vae_model, reconstruct_vae_batch
from fmdm_tpu_torch.train.vae_impl import KLTrainStep

CONFIG = Path(__file__).resolve().parents[2] / "configs" / "LDCT" / "LDCT_autoencoder_kl.json"
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores, NVIDIA data sheet


def _profile(fn, steps: int):
    """Run ``fn`` once, then ``steps`` times under the profiler; returns the
    profile and the window in ms (host clock, ended by a synchronize)."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        start = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - start) * 1e3
    return prof, window_ms


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--trace", default=None,
                        help="write a chrome trace of each run into this directory")
    args = parser.parse_args()

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = json.loads(CONFIG.read_text())
    model = build_vae_model(cfg, generator=torch.Generator().manual_seed(args.seed))
    trainer = KLTrainStep(model, cfg["training"])
    gen = torch.Generator("cuda").manual_seed(args.seed)
    images = torch.rand((args.batch, 1, 256, 256), generator=gen, device="cuda")
    valid = torch.ones(args.batch, device="cuda")

    def reconstruct():
        with torch.no_grad():
            reconstruct_vae_batch(model, images)

    name = card()
    print(f"card: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    # forward convolution FLOPs of one reconstruct (also the train step's
    # forward; its backward adds about twice that for dgrad and wgrad)
    flops, handles = conv_flops(model)
    model.eval()
    reconstruct()
    for h in handles:
        h.remove()
    fwd_flops = flops["flops"]

    result = {"card": name, "batch": args.batch, "steps": args.steps}
    runs = (("train step", lambda: trainer.step(images, valid, generator=gen), 3 * fwd_flops),
            ("reconstruct", reconstruct, fwd_flops))
    for label, fn, conv_work in runs:
        prof, window_ms = _profile(fn, args.steps)
        by_class, by_kernel = device_time_by_class(prof)
        busy_ms = device_busy_ms(prof)
        print(f"KL-VAE f32, batch {args.batch}, {label}: window {window_ms / args.steps:.3f} ms per "
              f"{label}, device busy {busy_ms / args.steps:.3f} ms (kernel times summed "
              f"{sum(by_class.values()) / args.steps:.3f} ms), idle "
              f"{100 * (1 - busy_ms / window_ms):.1f}% [{name}]")
        if args.trace:
            path = Path(args.trace) / f"{label.replace(' ', '_')}.json"
            path.parent.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(path))
        print_breakdown(by_class, by_kernel, args.steps, label)
        conv_ms = by_class.get("convolution", 0.0) / args.steps
        rate = conv_work / max(conv_ms, 1e-9) / 1e9
        print(f"convolutions: {conv_work / 1e12:.3f} TFLOP per {label}, {rate:.1f} TFLOP/s = "
              f"{100 * rate * 1e12 / F32_OPS_PER_S:.1f}% of the f32 peak [{name}]")
        result[label] = {
            "ms": window_ms / args.steps, "busy_ms": busy_ms / args.steps,
            "idle_share": 1 - busy_ms / window_ms, "conv_tflop": conv_work / 1e12,
            "ms_by_class": {k: v / args.steps for k, v in by_class.items()},
        }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
