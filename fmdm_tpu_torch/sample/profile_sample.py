"""
Where the time of the sampling step goes, on one CUDA card.

    python -m fmdm_tpu_torch.sample.profile_sample [--batch 8] [--steps 5] [--seed 0]
        [--trace sample_trace.json]

Builds the flagship (``model.unet`` of ``configs/LDCT/LDCT_ddpm_diffusers_nd.json``,
concatenate conditioning, random weights from ``--seed``), runs DPM-Solver++
(order 2) in bf16 through ``SamplingEngine`` over the first ``--steps`` of
the 50-step schedule once to warm up, then once under ``torch.profiler``.
Prints the device time per kernel class (the port's kernels, convolution,
matrix product, optimizer, elementwise and copies, other), the share of the
window the device was idle (busy time is the union of the kernels' intervals
on the device timeline), the convolutions' FLOPs against the bf16 peak,
and one JSON line with the same numbers. The card's name and power limit are
printed beside them. ``train/profile_vae.py`` and ``train/profile_denoise.py``
reuse the breakdown.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from collections import defaultdict
from pathlib import Path

import torch

from fmdm_tpu_torch.models.factories import DiffusionUNetFactory
from fmdm_tpu_torch.nn.layers import Conv, init_weights
from fmdm_tpu_torch.sample.engine import SamplingEngine
from fmdm_tpu_torch.schedulers import DPMSolverMultistepScheduler

CONFIG = Path(__file__).resolve().parents[2] / "configs" / "LDCT" / "LDCT_ddpm_diffusers_nd.json"
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16, NVIDIA data sheet

# kernel-name fragments -> class, first match wins
CLASSES = (
    ("K1 group_norm_act", ("gn_cluster", "gn_stats", "gn_apply")),
    ("K2 small_t_attention", ("small_t_attention",)),
    ("K3 flash_forward", ("flash_fwd",)),
    ("K4 flash_backward_dkv", ("flash_bwd_dkv",)),
    ("K5 flash_backward_dq", ("flash_bwd_dq",)),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "implicit", "nchwToNhwc", "nhwcToNchw",
                     "xmma", "cudnn", "fft", "pointwise_mult_and_sum_complex", "region_transform")),
    ("matrix product", ("gemm", "cublas", "cutlass")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("elementwise and copies", ("elementwise", "vectorized", "copy", "CatArray", "cat_", "fill",
                                "reduce", "index")),
)


def classify(name: str) -> str:
    lowered = name.lower()
    for label, fragments in CLASSES:
        if any(f.lower() in lowered for f in fragments):
            return label
    return "other"


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def conv_flops(model: torch.nn.Module):
    """Count 2*MACs of every Conv forward through hooks; returns (counter, handles)."""
    total = {"flops": 0}

    def hook(module, inputs, output):
        k = module.weight[0].numel()  # C_in/groups * prod(kernel)
        total["flops"] += 2 * k * output.numel()

    return total, [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, Conv)]


def device_time_by_class(prof):
    """Device ms per kernel class and per kernel name of a finished
    ``torch.profiler`` run: two dicts. Annotated ranges on the device's
    timeline (``Optimizer.step#AdamW.step``) span kernels and are skipped."""
    by_class, by_kernel = defaultdict(float), defaultdict(float)
    for event in prof.key_averages():
        if event.device_type != torch.autograd.DeviceType.CUDA \
                or getattr(event, "is_user_annotation", False):
            continue
        by_class[classify(event.key)] += event.self_device_time_total / 1e3
        by_kernel[event.key] += event.self_device_time_total / 1e3
    return by_class, by_kernel


def device_busy_ms(prof) -> float:
    """Device busy ms of a finished ``torch.profiler`` run: the union of its
    kernels' and copies' intervals on the device timeline, so intervals that
    overlap (several streams) count once."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    busy_us, covered = 0.0, float("-inf")
    for start, end in spans:
        if end > covered:
            busy_us += end - max(start, covered)
            covered = end
    return busy_us / 1e3


def print_breakdown(by_class, by_kernel, units: int, unit: str) -> float:
    """Print device ms per ``unit`` by class, as shares of the summed kernel
    time, and the top kernels."""
    total_ms = sum(by_class.values())
    if total_ms == 0.0:
        print("the profiler recorded no device time: no breakdown")
    for label, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {label:24s} {ms / units:9.3f} ms per {unit}  {100 * ms / max(total_ms, 1e-9):5.1f}%")
    print("top kernels:")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {ms / units:9.3f} ms per {unit}  {classify(name):22s} {name[:110]}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--trace", default=None, help="write a chrome trace here")
    args = parser.parse_args()

    cfg = json.loads(CONFIG.read_text())["model"]["unet"]
    model = DiffusionUNetFactory().build(cfg, conditioning="concatenate", channels=1)
    init_weights(model, torch.Generator().manual_seed(args.seed))
    scheduler = DPMSolverMultistepScheduler.create(
        num_train_timesteps=1000, algorithm_type="dpmsolver++", solver_order=2,
        beta_start=0.0001, beta_end=0.02)
    timesteps = scheduler.set_timesteps(50)[: args.steps]
    engine = SamplingEngine(model, scheduler, timesteps, conditioning_mode="concatenate",
                            compute_dtype=torch.bfloat16)
    shape = (args.batch, 1, 256, 256)
    cond = torch.full(shape, 0.5, device="cuda")
    gen = torch.Generator("cuda").manual_seed(args.seed)
    engine(shape, gen, conditioning_batch=cond)  # warm-up: build, cast, cuDNN plans

    flops, handles = conv_flops(engine._compute_model)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    timing = {}
    with torch.profiler.profile(activities=activities) as prof:
        engine(shape, gen, conditioning_batch=cond, timing=timing)
    for h in handles:
        h.remove()
    window_ms = timing["model_seconds"] * 1e3

    by_class, by_kernel = device_time_by_class(prof)
    busy_ms = device_busy_ms(prof)
    name = card()
    print(f"card: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"flagship bf16, batch {args.batch}, {args.steps} DPM++ steps: window {window_ms:.3f} ms "
          f"({window_ms / args.steps:.3f} ms per step), device busy {busy_ms:.3f} ms (kernel "
          f"times summed {sum(by_class.values()):.3f} ms), idle "
          f"{100 * (1 - busy_ms / window_ms):.1f}% [{name}]")
    print_breakdown(by_class, by_kernel, args.steps, "step")
    conv_ms = by_class.get("convolution", 0.0)
    conv_tflops = flops["flops"] / max(conv_ms, 1e-9) / 1e9
    print(f"convolutions: {flops['flops'] / args.steps / 1e12:.3f} TFLOP per step, "
          f"{conv_tflops:.1f} TFLOP/s = {100 * conv_tflops * 1e12 / BF16_OPS_PER_S:.1f}% "
          f"of the bf16 peak [{name}]")
    if args.trace:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)
    print(json.dumps({
        "card": name, "batch": args.batch, "steps": args.steps,
        "ms_per_step": window_ms / args.steps, "busy_ms_per_step": busy_ms / args.steps,
        "idle_share": 1 - busy_ms / window_ms,
        "ms_per_step_by_class": {k: v / args.steps for k, v in by_class.items()},
        "conv_tflop_per_step": flops["flops"] / args.steps / 1e12,
    }))


if __name__ == "__main__":
    main()
