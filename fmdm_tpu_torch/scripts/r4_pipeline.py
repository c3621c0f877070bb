"""
The flagship quality pipeline, restart-safe (counterpart of the JAX
package's ``scripts/r4_pipeline.py`` and ``r4_post_training_pipeline.sh``).

State lives under ``.scratch/torch_r4/`` (gitignored); a training stage
resumes from its run's newest ``*_last.pt``, so an interruption costs at
most one checkpoint cadence, not the run. Stages:

  1. synthetic flagship dataset (16 train / 6 test cases, 256², 24 slices)
  2. diffusion flagship training, 800 epochs, snapshots every 100
  3. flow-matching flagship training, 300 epochs, snapshots every 50
  4. 12-alias sampler-quality sweep at 144 eval samples
  5. convergence curve (the diffusion run's snapshots x 3 samplers, 64
     samples)
  6. latent-diffusion chain sweep
  7. EMA continuation: resume the diffusion flagship +200 epochs with
     ``training.ema_decay=0.999``, then evaluate live vs ``--use_ema``
     weights (ddim / dpmsolver++ / thresholded, 144 samples)

    python -m fmdm_tpu_torch.scripts.r4_pipeline [--stage N[,M...] | --stage post] [--device cpu]

Without ``--stage`` stages 1-7 run; ``--stage 3,4`` runs those in that
order; ``--stage post`` is the post-training order (3, 4, 5, 6): the flow
flagship, the sweep, the curve, the latent chain.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Optional

from fmdm_tpu_torch.scripts.flagship_quality_sweep import (
    REPO,
    alias_tag,
    evaluate_cmd,
    gen_dataset,
    module_cmd,
    newest_metrics,
    read_metrics,
    run,
    write_config,
)

ROOT = REPO / ".scratch" / "torch_r4"
PREFIXES = {"diffusion": "diff", "flow_matching": "flow"}
SNAPSHOT_EVERY = {"diffusion": 100, "flow_matching": 50}
POST_TRAINING = [3, 4, 5, 6]
ALL_STAGES = [1, 2, 3, 4, 5, 6, 7]
SWEEP_ALIASES = (
    "ddpm,ddim,dpmsolver1,dpmsolver2,dpmsolver++,dpmsolversde,unipc,flowmatch,"
    "dpmsolver++?thresholding=true,unipc?thresholding=true,"
    "dpmsolver++?use_karras_sigmas=true,dpmsolver++?solver_type=heun"
)
EMA_ALIASES = ("ddim", "dpmsolver++", "dpmsolver++?thresholding=true")


def sh(cmd, log: Optional[Path] = None) -> None:
    """Run ``cmd``, its output appended to ``log``; exit if it fails."""
    run(cmd, log, mode="a")


def latest_run_dir(variant: str, root: Path = ROOT) -> Optional[Path]:
    cands = sorted(root.glob(f"run_{variant}*"), key=lambda p: p.stat().st_mtime)
    return cands[-1] if cands else None


def trained_epochs(run_dir: Optional[Path], prefix: str) -> int:
    """Highest epoch recorded in the run's last-checkpoint payload."""
    if run_dir is None:
        return 0
    from fmdm_tpu_torch.utils.checkpoint import load_checkpoint

    last = run_dir / f"{prefix}_last.pt"
    if not last.exists():
        return 0
    try:
        return int(load_checkpoint(last).get("epoch", 0))
    except Exception:  # a torn or foreign file: train from the start
        return 0


def train_variant(variant: str, epochs: int, prefix: str, *, root: Path = ROOT,
                  ckpt_every: Optional[int] = None, device: Optional[str] = None) -> Path:
    """Train ``variant`` to ``epochs``, resuming from the newest run's
    ``{prefix}_last.pt``; returns the run dir."""
    run_dir = latest_run_dir(variant, root)
    done = trained_epochs(run_dir, prefix)
    if done >= epochs:
        print(f"[{variant}] already trained to epoch {done} — skip", flush=True)
        return run_dir
    cfg = write_config(root, epochs, variant, ckpt_every=ckpt_every or SNAPSHOT_EVERY[variant])
    j = json.loads(cfg.read_text())
    j["training"]["output_dir"] = str(run_dir or (root / f"run_{variant}"))
    cfg.write_text(json.dumps(j, indent=2))
    cmd = module_cmd("fmdm_tpu_torch.train", "--config", cfg, device=device)
    if run_dir is not None and done > 0:
        cmd += ["--resume", str(run_dir / f"{prefix}_last.pt")]
        print(f"[{variant}] resuming from epoch {done}", flush=True)
    sh(cmd, root / f"train_{variant}.log")
    return latest_run_dir(variant, root)


def parse_stages(spec: Optional[str]) -> List[int]:
    """``None`` -> stages 1-7; ``post`` -> the post-training order; else a
    comma list of stage numbers, run in the order given."""
    if not spec:
        return list(ALL_STAGES)
    if spec == "post":
        return list(POST_TRAINING)
    stages = [int(s) for s in spec.split(",")]
    unknown = [s for s in stages if s not in ALL_STAGES]
    if unknown:
        raise SystemExit(f"unknown stage(s) {unknown}; stages are {ALL_STAGES}")
    return stages


def _tail(path: Path, n: int = 2500) -> None:
    print(path.read_text()[-n:], flush=True)


def ema_continuation(root: Path, device: Optional[str]) -> None:
    """Stage 7: the diffusion run +200 epochs at ``ema_decay`` 0.999, then
    live vs EMA weights under three samplers."""
    run_dir = latest_run_dir("diffusion", root)
    if run_dir is None:
        raise SystemExit("stage 7 needs the stage-2 diffusion run")
    done = trained_epochs(run_dir, "diff")
    if done < 1000:
        cfg = write_config(root, 1000, "diffusion", ckpt_every=100)
        j = json.loads(cfg.read_text())
        j["training"]["output_dir"] = str(run_dir)
        j["training"]["ema_decay"] = 0.999
        ema_cfg = cfg.with_name("flagship_ema_continuation.json")
        ema_cfg.write_text(json.dumps(j, indent=2))
        sh(module_cmd("fmdm_tpu_torch.train", "--config", ema_cfg,
                      "--resume", run_dir / "diff_last.pt", device=device),
           root / "train_ema.log")
    else:
        print(f"[ema] already trained to epoch {done} — skip", flush=True)
    for alias in EMA_ALIASES:
        for ema_flag in (False, True):
            tag = alias_tag(alias).replace("?", "_").replace("=", "-")
            tag += "_ema" if ema_flag else "_live"
            out = root / "ema_eval" / tag
            sh(evaluate_cmd(run_dir, alias, out, num_samples=144, device=device,
                            extra=["--use_ema"] if ema_flag else []),
               root / f"ema_eval_{tag}.log")
            metrics = newest_metrics(out)
            if metrics is not None:
                row = read_metrics(metrics)
                print(f"{tag}: psnr={row.get('psnr')} ssim={row.get('ssim')} "
                      f"ci95={row.get('psnr_ci95')}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="The flagship quality pipeline, restart-safe.")
    ap.add_argument("--stage", default=None,
                    help="stage number(s) to run, comma-separated, or 'post' (default: 1-7)")
    ap.add_argument("--device", default=None,
                    help="passed to the CLIs: the card by default, 'cpu' for the CPU")
    args = ap.parse_args(argv)
    root = ROOT
    root.mkdir(parents=True, exist_ok=True)
    device = args.device
    dev_args = ["--device", device] if device else []

    for stage in parse_stages(args.stage):
        if stage == 1:
            if not (root / "train.txt").exists():
                print("=== [1/7] dataset", flush=True)
                gen_dataset(root, n_train_cases=16, n_test_cases=6)
        elif stage == 2:
            print("=== [2/7] diffusion flagship (800 epochs)", flush=True)
            train_variant("diffusion", 800, "diff", root=root, device=device)
        elif stage == 3:
            print("=== [3/7] flow-matching flagship (300 epochs)", flush=True)
            train_variant("flow_matching", 300, "flow", root=root, device=device)
        elif stage == 4:
            print("=== [4/7] 12-alias sweep, 144 samples", flush=True)
            sh(module_cmd("fmdm_tpu_torch.scripts.flagship_quality_sweep", "--root", root,
                          "--skip-data", "--skip-train", "--num-samples", 144,
                          "--aliases", SWEEP_ALIASES, *dev_args), root / "evals.log")
            _tail(root / "evals.log")
        elif stage == 5:
            print("=== [5/7] convergence curve", flush=True)
            sh(module_cmd("fmdm_tpu_torch.scripts.convergence_curve",
                          "--run", latest_run_dir("diffusion", root), "--num-samples", 64,
                          "--out", root / "curve", *dev_args), root / "curve.log")
            _tail(root / "curve.log")
        elif stage == 6:
            print("=== [6/7] latent-diffusion sweep", flush=True)
            sh(module_cmd("fmdm_tpu_torch.scripts.latent_diffusion_sweep",
                          "--root", root.parent / "torch_latent_sweep", "--pixel-root", root,
                          *dev_args), root / "latent_sweep.log")
            _tail(root / "latent_sweep.log")
        elif stage == 7:
            print("=== [7/7] EMA continuation (+200 epochs at ema_decay=0.999)", flush=True)
            ema_continuation(root, device)
    print("=== pipeline complete", flush=True)


if __name__ == "__main__":
    main()
