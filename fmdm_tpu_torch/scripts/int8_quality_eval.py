"""
W8A8 int8 post-training quantization: the flagship-scale quality delta
(counterpart of the JAX package's ``scripts/int8_quality_eval.py``).

Measures what ``run_model --quantize int8`` costs in PSNR/SSIM at the metric
of record: the 256² concatenate-conditioned flow-matching flagship evaluated
through ``python -m fmdm_tpu_torch.run_model --mode evaluate``, exact vs
int8, same checkpoint / seed / protocol (144 samples, 50 steps, seed 11).
Restart-safe: state lives under ``.scratch/torch_int8_eval``, training
resumes from the run's ``flow_last.pt``, and a variant counts as done only
once its ``eval_metrics.csv`` exists. Stages:

  1. synthetic flagship dataset (16 train / 6 test cases, 256², 24 slices)
  2. flow-matching flagship training, 300 epochs
  3. evaluate {flowmatch, dpmsolver++} x {exact, int8}
  4. serving composition: flowmatch x {exact, int8} x DeepCache 2:1:adaptive
  5. DeepCache's quality budget ``auto:0.5`` under int8, and ``int8+linear``

    python -m fmdm_tpu_torch.scripts.int8_quality_eval [--stage N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence, Tuple

from fmdm_tpu_torch.scripts.flagship_quality_sweep import (
    REPO,
    evaluate_cmd,
    gen_dataset,
    module_cmd,
    newest_metrics,
    read_metrics,
    write_config,
)
from fmdm_tpu_torch.scripts.r4_pipeline import sh, trained_epochs

ROOT = REPO / ".scratch" / "torch_int8_eval"
EPOCHS = 300
PREFIX = "flow"

Variant = Tuple[str, Optional[str], Optional[str]]  # (alias, --quantize, --deep_cache)
VARIANTS = [
    ("flowmatch", None, None),
    ("flowmatch", "int8", None),
    ("dpmsolver++", None, None),
    ("dpmsolver++", "int8", None),
]
VARIANTS_COMPOSED = [
    ("flowmatch", None, "2:1:adaptive"),
    ("flowmatch", "int8", "2:1:adaptive"),
]
VARIANTS_R5 = [
    ("flowmatch", "int8", "auto:0.5"),
    ("flowmatch", "int8+linear", None),
]


def resolve_run_dir(root: Path = ROOT) -> Path:
    """The newest run under ``root`` (the trainer suffixes ``_runN``)."""
    cands = sorted((d for d in root.glob("run_flow*") if (d / "train_config.json").exists()),
                   key=lambda d: d.stat().st_mtime)
    return cands[-1] if cands else root / "run_flow"


def train_flow(root: Path = ROOT, device: Optional[str] = None) -> Path:
    run_dir = resolve_run_dir(root)
    done = trained_epochs(run_dir if run_dir.exists() else None, PREFIX)
    if done >= EPOCHS:
        print(f"[train] already at epoch {done} — skip", flush=True)
        return run_dir
    cfg = write_config(root, EPOCHS, "flow_matching", ckpt_every=100)
    j = json.loads(cfg.read_text())
    j["training"]["output_dir"] = str(run_dir)
    cfg.write_text(json.dumps(j, indent=2))
    cmd = module_cmd("fmdm_tpu_torch.train", "--config", cfg, device=device)
    if done > 0:
        cmd += ["--resume", str(run_dir / f"{PREFIX}_last.pt")]
        print(f"[train] resuming from epoch {done}", flush=True)
    sh(cmd, root / "train_flow.log")
    return resolve_run_dir(root)


def variant_tag(alias: str, quant: Optional[str], deep_cache: Optional[str]) -> str:
    tag = alias.replace("+", "p") + ("_" + quant.replace("+", "_") if quant else "_bf16")
    return tag + ("_dc" + deep_cache.replace(":", "-") if deep_cache else "")


def evaluate(run_dir: Path, variants: Sequence[Variant] = VARIANTS, *, root: Path = ROOT,
             num_samples: int = 144, steps: int = 50, device: Optional[str] = None) -> dict:
    """``{tag: metrics row}`` of ``evaluate`` per variant. A variant whose
    ``DONE`` marker exists is read, not run again; the marker is written only
    once ``eval_metrics.csv`` exists, so a run that exits 0 without metrics
    is retried on the next call."""
    results = {}
    for alias, quant, deep_cache in variants:
        tag = variant_tag(alias, quant, deep_cache)
        out = root / "eval" / tag
        marker = out / "DONE"
        if not marker.exists():
            extra = (["--quantize", quant] if quant else []) + (
                ["--deep_cache", deep_cache] if deep_cache else [])
            sh(evaluate_cmd(run_dir, alias, out, num_samples=num_samples, steps=steps,
                            device=device, extra=extra),
               root / f"eval_{tag}.log")
        metrics = newest_metrics(out)
        if metrics is None:
            print(f"WARNING: {tag}: run_model produced NO eval_metrics.csv under {out} "
                  f"— variant left un-DONE for retry", flush=True)
            continue
        if not marker.exists():
            marker.write_text("ok")
        row = results[tag] = read_metrics(metrics)
        print(f"{tag}: psnr={row.get('psnr')} ssim={row.get('ssim')} "
              f"ci95={row.get('psnr_ci95')}", flush=True)
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="int8 quality delta of the flow flagship.")
    ap.add_argument("--stage", type=int, default=0, help="run only this stage (default: all)")
    ap.add_argument("--device", default=None,
                    help="passed to the CLIs: the card by default, 'cpu' for the CPU")
    args = ap.parse_args(argv)

    def want(n):
        return args.stage == 0 or args.stage == n

    ROOT.mkdir(parents=True, exist_ok=True)
    results = {}
    if want(1) and not (ROOT / "train.txt").exists():
        print("=== [1/5] dataset", flush=True)
        gen_dataset(ROOT, n_train_cases=16, n_test_cases=6)
    run_dir = resolve_run_dir()
    if want(2):
        print("=== [2/5] flow-matching flagship (300 epochs)", flush=True)
        run_dir = train_flow(device=args.device)
    if want(3):
        print("=== [3/5] exact vs int8 evals", flush=True)
        results.update(evaluate(run_dir, VARIANTS, device=args.device))
    if want(4):
        print("=== [4/5] serving composition: int8 x DeepCache 2:1:adaptive", flush=True)
        results.update(evaluate(run_dir, VARIANTS_COMPOSED, device=args.device))
    if want(5):
        print("=== [5/5] DeepCache auto budget under int8, int8+linear", flush=True)
        results.update(evaluate(run_dir, VARIANTS_R5, device=args.device))
    print("=== int8 quality eval complete", flush=True)
    return results


if __name__ == "__main__":
    main()
