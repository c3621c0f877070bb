"""
Quality-vs-epochs convergence curve of a flagship run (counterpart of the
JAX package's ``scripts/convergence_curve.py``).

For every epoch snapshot in ``<run>/epochs/epochXXXX/epoch.pt`` (the port's
trainer writes one every ``save_model_epochs``), stage a minimal run dir
(``train_config.json`` + a hard link of the snapshot as ``{prefix}_last.pt``)
and run ``python -m fmdm_tpu_torch.run_model --mode evaluate`` for each
sampler alias; print a markdown table of PSNR per (epoch, sampler):

    python -m fmdm_tpu_torch.scripts.convergence_curve --run RUN \\
        [--aliases 'ddim,dpmsolver++,dpmsolver++?thresholding=true'] \\
        [--num-samples 64] [--out DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

from fmdm_tpu_torch.scripts.flagship_quality_sweep import (
    alias_tag,
    evaluate_cmd,
    newest_metrics,
    read_metrics,
    run,
)

DEFAULT_ALIASES = "ddim,dpmsolver++,dpmsolver++?thresholding=true"


def stage_epoch_dir(run_dir: Path, epoch_dir: Path, staging: Path) -> Path:
    """A run-dir facade for one snapshot: config copy + checkpoint hard link."""
    stage = staging / epoch_dir.name
    stage.mkdir(parents=True, exist_ok=True)
    cfg = stage / "train_config.json"
    if not cfg.exists():
        cfg.write_text((run_dir / "train_config.json").read_text())
    prefix = next((cand for cand in ("diff", "flow", "vae")
                   if (run_dir / f"{cand}_last.pt").exists()), "diff")
    link = stage / f"{prefix}_last.pt"
    if not link.exists():
        os.link(epoch_dir / "epoch.pt", link)
    return stage


def epoch_of(epoch_dir: Path) -> int:
    return int(epoch_dir.name.replace("epoch", ""))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Quality-vs-epochs convergence curve of a run.")
    ap.add_argument("--run", type=Path, required=True)
    ap.add_argument("--aliases", default=DEFAULT_ALIASES)
    ap.add_argument("--num-samples", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--epochs", default=None,
                    help="comma list of snapshot epochs to use (default: all)")
    ap.add_argument("--device", default=None,
                    help="passed to run_model: the card by default, 'cpu' for the CPU")
    args = ap.parse_args(argv)
    run_dir = args.run.resolve()
    out_root = (args.out or (run_dir / "convergence")).resolve()
    out_root.mkdir(parents=True, exist_ok=True)

    epoch_dirs = sorted((run_dir / "epochs").glob("epoch*"))
    if args.epochs:
        wanted = {int(e) for e in args.epochs.split(",")}
        epoch_dirs = [d for d in epoch_dirs if epoch_of(d) in wanted]
    if not epoch_dirs:
        raise SystemExit(f"no epoch snapshots under {run_dir}/epochs")

    aliases = args.aliases.split(",")
    results = {}  # (epoch, alias) -> row
    for epoch_dir in epoch_dirs:
        epoch = epoch_of(epoch_dir)
        stage = stage_epoch_dir(run_dir, epoch_dir, out_root / "staging")
        for alias in aliases:
            tag = f"e{epoch:04d}_" + alias_tag(alias).replace("?", "_").replace("=", "-")
            out = out_root / tag
            out.mkdir(parents=True, exist_ok=True)
            run(evaluate_cmd(stage, alias, out, num_samples=args.num_samples, steps=args.steps,
                             batch_size=args.batch_size, seed=args.seed, device=args.device),
                out_root / f"{tag}.log")
            metrics = newest_metrics(out)
            if metrics is None:
                raise SystemExit(f"no eval_metrics.csv for epoch {epoch} alias {alias}")
            results[(epoch, alias)] = read_metrics(metrics)
            print(epoch, alias, results[(epoch, alias)]["psnr"], flush=True)

    print("\n| epoch | " + " | ".join(f"{a} PSNR (±95% CI) | {a} SSIM" for a in aliases) + " |")
    print("|" + "---|" * (2 * len(aliases) + 1))
    for epoch_dir in epoch_dirs:
        epoch = epoch_of(epoch_dir)
        cells = []
        for a in aliases:
            row = results.get((epoch, a))
            ci = f" ± {float(row['psnr_ci95']):.2f}" if row and row.get("psnr_ci95") else ""
            cells.append(f"{float(row['psnr']):.2f}{ci} | {float(row['ssim']):.3f}"
                         if row else "- | -")
        print(f"| {epoch} | " + " | ".join(cells) + " |", flush=True)
    (out_root / "curve.json").write_text(json.dumps(
        {f"{e}:{a}": r for (e, a), r in results.items()}, indent=1))
    return results


if __name__ == "__main__":
    main()
