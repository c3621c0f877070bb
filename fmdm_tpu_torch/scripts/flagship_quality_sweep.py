"""
Flagship-scale sampler-quality sweep (counterpart of the JAX package's
``scripts/flagship_quality_sweep.py``).

Generates a synthetic LDCT-shaped dataset (256² ellipse phantoms in HU
range, low-dose = high-dose + structured noise), trains the flagship 256²
concatenate-conditioned UNet through ``python -m fmdm_tpu_torch.train``,
then runs ``python -m fmdm_tpu_torch.run_model --mode evaluate`` for every
scheduler alias (``--jobs`` of them at a time: the card holds several), and
prints a markdown table of PSNR (with its 95% CI), SSIM and model samples/s
per alias:

    python -m fmdm_tpu_torch.scripts.flagship_quality_sweep --root .scratch/sweep \\
        [--epochs 30] [--skip-train] [--aliases ddpm,ddim,...] [--device cpu]

The phantoms are the JAX script's, bit for bit, from the same seed.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

REPO = Path(__file__).resolve().parents[2]
CONFIGS = {"diffusion": REPO / "configs/LDCT/LDCT_ddpm_diffusers_nd.json",
           "flow_matching": REPO / "configs/LDCT/LDCT_flow_matching_diffusers_nd.json"}

ALIASES = ["ddpm", "ddim", "dpmsolver1", "dpmsolver2", "dpmsolver++",
           "dpmsolversde", "unipc", "flowmatch"]


def make_phantom(rng: np.random.RandomState, size=256) -> np.ndarray:
    """CT-like slice in raw pixel units (HU = px - 1024): water-ish ellipse
    body with random internal structures on an air background."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cy, cx = size / 2 + rng.uniform(-10, 10), size / 2 + rng.uniform(-10, 10)
    ry, rx = rng.uniform(0.30, 0.42) * size, rng.uniform(0.34, 0.46) * size
    body = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) <= 1.0
    img = np.zeros((size, size), np.float32)            # air: 0 -> -1024 HU
    img[body] = 1024.0 + rng.uniform(-40, 40)           # ~water
    for _ in range(rng.randint(4, 9)):                  # organs/lesions/bone
        oy = cy + rng.uniform(-0.5, 0.5) * ry
        ox = cx + rng.uniform(-0.5, 0.5) * rx
        orr = rng.uniform(0.03, 0.18) * size
        dens = rng.choice([rng.uniform(900, 1100), rng.uniform(1300, 2800)])
        blob = (((yy - oy) / orr) ** 2 + ((xx - ox) / (orr * rng.uniform(0.6, 1.6))) ** 2) <= 1.0
        img[blob & body] = dens
    return img


def gen_dataset(root: Path, n_train_cases=16, n_test_cases=6, depth=24, seed=0):
    """``root/data/{split}_c{i}_{sdct,ldct}.npy`` volumes of ``depth``
    phantoms each and the ``train.txt`` / ``test.txt`` split files."""
    data = root / "data"
    data.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    rows_train, rows_test = [], []
    for split, n_cases, rows in (("train", n_train_cases, rows_train),
                                 ("test", n_test_cases, rows_test)):
        for c in range(n_cases):
            sdct = np.stack([make_phantom(rng) for _ in range(depth)])
            # low-dose: quantum mottle ~ sqrt(signal) + streaks
            noise = rng.randn(*sdct.shape).astype(np.float32) * (30.0 + 0.05 * sdct)
            ldct = np.clip(sdct + noise, 0.0, 4095.0).astype(np.float32)
            sp, lp = f"data/{split}_c{c}_sdct.npy", f"data/{split}_c{c}_ldct.npy"
            np.save(root / sp, sdct)
            np.save(root / lp, ldct)
            rows.append(f"{split.upper()}C{c}\t{sp}\t{lp}")
    (root / "train.txt").write_text("Case\tSDCT\tLDCT\n" + "\n".join(rows_train) + "\n")
    (root / "test.txt").write_text("Case\tSDCT\tLDCT\n" + "\n".join(rows_test) + "\n")


def write_config(root: Path, epochs: int, variant: str = "diffusion",
                 ckpt_every: int = 50) -> Path:
    """The flagship config of ``variant`` (``CONFIGS``) with the sweep's
    training overrides at ``root/configs/flagship_sweep_{variant}.json``,
    with ``dataset.json`` beside it."""
    base = json.loads(CONFIGS[variant].read_text())
    base["training"].update({
        "data_root": str(root),
        "output_dir": str(root / "run"),
        "train_batch_size": 16, "batch_size": 16, "eval_batch_size": 16,
        "num_epochs": epochs,
        "mixed_precision": "bf16",
        "num_inference_steps": 50,
        "save_images": False,
        "save_model_epochs": ckpt_every,
        "lr_warmup_steps": 500,
        "use_tensor_cache": True,
        "save_tensor_cache": True,
        "checkpoint_every_epochs": ckpt_every,
        "visual_every": 1000,
    })
    # the dataset.json walk needs a copy in an ancestor of the config
    cfg_dir = root / "configs"
    cfg_dir.mkdir(exist_ok=True)
    (cfg_dir / "dataset.json").write_text((REPO / "configs/LDCT/dataset.json").read_text())
    path = cfg_dir / f"flagship_sweep_{variant}.json"
    path.write_text(json.dumps(base, indent=2))
    return path


def module_cmd(module: str, *args, device: Optional[str] = None) -> List[str]:
    """``python -m module args`` with ``--device`` when one is given."""
    cmd = [sys.executable, "-m", module, *map(str, args)]
    return cmd + ["--device", device] if device else cmd


def _env() -> Dict[str, str]:
    """The environment of a child CLI: the repo importable from any cwd."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    return env


def run(cmd: Sequence, log: Optional[Path], mode: str = "w") -> None:
    """Run ``cmd`` with its output in ``log`` (written with ``mode``; the
    console when ``None``); exit with the log's tail if it fails."""
    cmd = list(map(str, cmd))
    print("+", " ".join(cmd), flush=True)
    if log is None:
        rc = subprocess.call(cmd, env=_env())
    else:
        with open(log, mode) as fh:
            rc = subprocess.call(cmd, stdout=fh, stderr=subprocess.STDOUT, env=_env())
    if rc != 0:
        if log is not None and Path(log).exists():
            print(Path(log).read_text()[-3000:])
        raise SystemExit(f"command failed rc={rc}: {cmd}")


def evaluate_cmd(ckpt_dir: Path, alias: str, out: Path, *, num_samples: int, steps: int = 50,
                 batch_size: int = 16, seed: int = 11, device: Optional[str] = None,
                 extra: Sequence = ()) -> List[str]:
    """``run_model --mode evaluate`` of ``ckpt_dir`` under ``alias`` into ``out``."""
    return module_cmd("fmdm_tpu_torch.run_model", "--ckpt_dir", ckpt_dir, "--mode", "evaluate",
                      "--scheduler", alias, "--num_inference_steps", steps,
                      "--num_samples", num_samples, "--batch_size", batch_size,
                      "--output_dir", out, "--seed", seed, *extra, device=device)


def newest_metrics(out: Path) -> Optional[Path]:
    """The newest ``eval_metrics.csv`` under ``out``."""
    found = sorted(out.glob("**/eval_metrics.csv"), key=lambda p: p.stat().st_mtime)
    return found[-1] if found else None


def read_metrics(metrics: Path) -> Dict[str, str]:
    """The last row of an ``eval_metrics.csv``, with ``psnr_ci95`` (1.96
    standard errors of the per-image PSNRs) and ``psnr_mean_check`` from the
    ``eval_metrics_per_image.csv`` beside it when it holds two images or more."""
    with open(metrics) as fh:
        row = list(csv.DictReader(fh))[-1]
    per_img = metrics.parent / "eval_metrics_per_image.csv"
    if per_img.exists():
        with open(per_img) as fh:
            vals = [float(r["psnr"]) for r in csv.DictReader(fh) if r.get("psnr")]
        if len(vals) > 1:
            row["psnr_ci95"] = f"{1.96 * float(np.std(vals, ddof=1)) / np.sqrt(len(vals)):.3f}"
            row["psnr_mean_check"] = f"{float(np.mean(vals)):.3f}"
    return row


def format_table(results: Dict[str, Dict[str, str]]) -> str:
    """The markdown table of ``{alias: metrics row}``, best PSNR first."""
    lines = ["| sampler | PSNR (±95% CI) | SSIM | samples/s (model time) |", "|---|---|---|---|"]
    for alias, row in sorted(results.items(), key=lambda kv: -float(kv[1].get("psnr", 0))):
        ci = f" ± {float(row['psnr_ci95']):.2f}" if row.get("psnr_ci95") else ""
        lines.append(f"| {alias} | {float(row['psnr']):.2f}{ci} | "
                     f"{float(row.get('ssim', 0) or 0):.3f} "
                     f"| {float(row.get('model_samples_per_second', 0)):.1f} |")
    return "\n".join(lines)


def alias_tag(alias: str) -> str:
    return alias.replace("+", "p")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=REPO / ".scratch" / "flagship_sweep")
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--flow-epochs", type=int, default=None,
                    help="epochs for the flow_matching variant (default: --epochs)")
    ap.add_argument("--train-cases", type=int, default=16)
    ap.add_argument("--test-cases", type=int, default=6)
    ap.add_argument("--depth", type=int, default=24, help="slices per phantom volume")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="checkpoint/snapshot cadence in epochs")
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--skip-data", action="store_true")
    ap.add_argument("--aliases", default=",".join(ALIASES))
    ap.add_argument("--num-samples", type=int, default=32)
    ap.add_argument("--steps", type=int, default=50, help="inference steps per evaluate")
    ap.add_argument("--jobs", type=int, default=1,
                    help="trainings, then evaluations, run this many at a time")
    ap.add_argument("--device", default=None,
                    help="passed to the CLIs: the card by default, 'cpu' for the CPU")
    return ap


def main(argv=None) -> Dict[str, Dict[str, str]]:
    args = build_parser().parse_args(argv)
    root = args.root.resolve()
    root.mkdir(parents=True, exist_ok=True)

    if not args.skip_data:
        gen_dataset(root, n_train_cases=args.train_cases, n_test_cases=args.test_cases,
                    depth=args.depth)
        print("dataset generated", flush=True)

    # Two trained models: the diffusion (eps) flagship serves the diffusion
    # aliases; flowmatch needs a velocity-target model, so the flow-matching
    # config trains its own.
    aliases = args.aliases.split(",")
    variants = [v for v in ("diffusion", "flow_matching")
                if (any(a != "flowmatch" for a in aliases) if v == "diffusion"
                    else "flowmatch" in aliases)]

    def train(variant: str) -> None:
        epochs = (args.flow_epochs if variant == "flow_matching"
                  and args.flow_epochs is not None else args.epochs)
        cfg = write_config(root, epochs, variant, ckpt_every=args.ckpt_every)
        json_cfg = json.loads(cfg.read_text())
        json_cfg["training"]["output_dir"] = str(root / f"run_{variant}")
        cfg.write_text(json.dumps(json_cfg, indent=2))
        if not args.skip_train:
            run(module_cmd("fmdm_tpu_torch.train", "--config", cfg, device=args.device),
                root / f"train_{variant}.log")

    with ThreadPoolExecutor(args.jobs) as pool:
        list(pool.map(train, variants))
    ckpt_dirs = {}
    for variant in variants:
        candidates = sorted(root.glob(f"run_{variant}*"), key=lambda p: p.stat().st_mtime)
        ckpt_dirs[variant] = candidates[-1] if candidates else root / f"run_{variant}"
        print("ckpt_dir:", variant, ckpt_dirs[variant], flush=True)

    def evaluate(alias: str) -> Optional[Dict[str, str]]:
        ckpt_dir = ckpt_dirs["flow_matching" if alias == "flowmatch" else "diffusion"]
        out = root / "eval" / alias_tag(alias)
        out.mkdir(parents=True, exist_ok=True)
        run(evaluate_cmd(ckpt_dir, alias, out, num_samples=args.num_samples, steps=args.steps,
                         device=args.device),
            root / f"eval_{alias_tag(alias)}.log")
        metrics = newest_metrics(out)
        if metrics is None:
            print(f"!! no eval_metrics.csv for {alias}")
            return None
        row = read_metrics(metrics)
        print(alias, row, flush=True)
        return row

    with ThreadPoolExecutor(args.jobs) as pool:
        rows = list(pool.map(evaluate, aliases))
    results = {alias: row for alias, row in zip(aliases, rows) if row is not None}
    print("\n" + format_table(results), flush=True)
    return results


if __name__ == "__main__":
    main()
