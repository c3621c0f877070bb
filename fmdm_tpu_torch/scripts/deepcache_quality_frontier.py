"""
DeepCache quality-throughput frontier at flagship scale (counterpart of the
JAX package's ``scripts/deepcache_quality_frontier.py``).

Runs ``python -m fmdm_tpu_torch.run_model --mode evaluate`` on a trained
flagship run for the exact path and a grid of ``--deep_cache`` settings
(interval x {uniform, adaptive}) and prints the PSNR/throughput frontier as
a markdown table:

    python -m fmdm_tpu_torch.scripts.deepcache_quality_frontier --ckpt_dir RUN \\
        [--root DIR] [--num-samples 32] [--scheduler ddpm] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

from fmdm_tpu_torch.scripts.flagship_quality_sweep import (
    REPO,
    evaluate_cmd,
    newest_metrics,
    read_metrics,
    run,
)

VARIANTS = [None, "2:1:uniform", "2:1:adaptive", "3:1:uniform", "3:1:adaptive",
            "4:1:adaptive", "5:1:adaptive"]


def frontier(ckpt_dir: Path, root: Path, *, num_samples: int, scheduler: str = "ddpm",
             steps: int = 50, device: Optional[str] = None,
             variants: Sequence[Optional[str]] = VARIANTS) -> dict:
    """``{tag: metrics row}`` of ``evaluate`` under each DeepCache variant
    (``None`` is the exact path, tagged ``exact``)."""
    root.mkdir(parents=True, exist_ok=True)
    results = {}
    for variant in variants:
        tag = "exact" if variant is None else variant.replace(":", "_")
        out = root / tag
        out.mkdir(parents=True, exist_ok=True)
        extra = [] if variant is None else ["--deep_cache", variant]
        run(evaluate_cmd(ckpt_dir, scheduler, out, num_samples=num_samples, steps=steps,
                         device=device, extra=extra),
            root / f"eval_{tag}.log")
        metrics = newest_metrics(out)
        if metrics is None:
            print(f"!! no eval_metrics.csv for {tag}")
            continue
        results[tag] = read_metrics(metrics)
        print(tag, results[tag], flush=True)
    return results


def format_frontier(results: dict) -> str:
    lines = ["| deep_cache | PSNR (±95% CI) | SSIM | model samples/s | speedup |",
             "|---|---|---|---|---|"]
    base = float(results.get("exact", {}).get("model_samples_per_second", 0) or 0)
    for tag, row in results.items():
        sps = float(row.get("model_samples_per_second", 0) or 0)
        speed = f"{sps / base:.2f}x" if base else "-"
        ci = f" ± {float(row['psnr_ci95']):.2f}" if row.get("psnr_ci95") else ""
        lines.append(f"| {tag} | {float(row['psnr']):.2f}{ci} | "
                     f"{float(row.get('ssim', 0) or 0):.3f} | {sps:.2f} | {speed} |")
    return "\n".join(lines)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="DeepCache quality-throughput frontier.")
    ap.add_argument("--ckpt_dir", type=Path, required=True)
    ap.add_argument("--root", type=Path, default=REPO / ".scratch" / "deepcache_frontier")
    ap.add_argument("--num-samples", type=int, default=32)
    ap.add_argument("--scheduler", default="ddpm")
    ap.add_argument("--device", default=None,
                    help="passed to run_model: the card by default, 'cpu' for the CPU")
    args = ap.parse_args(argv)
    results = frontier(args.ckpt_dir.resolve(), args.root.resolve(),
                       num_samples=args.num_samples, scheduler=args.scheduler,
                       device=args.device)
    print("\n" + format_frontier(results), flush=True)
    return results


if __name__ == "__main__":
    main()
