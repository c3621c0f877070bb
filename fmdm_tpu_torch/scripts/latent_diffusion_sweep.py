"""
Latent-diffusion chain sweep (counterpart of the JAX package's
``scripts/latent_diffusion_sweep.py``). The full chain, through the port's
CLIs:

  1. train an AutoencoderKL on synthetic 256² LDCT phantoms
     (``python -m fmdm_tpu_torch.train``)
  2. encode every slice to latents (posterior mode), scale to ~unit std,
     write a ``LatentDataset`` root (``fmdm_tpu_torch/data/latent.py``)
  3. train a latent-space denoiser, concatenate-conditioned on the LDCT
     latent (``python -m fmdm_tpu_torch.train``)
  4. sweep ddim / dpmsolver++ / unipc through ``python -m
     fmdm_tpu_torch.run_model --mode evaluate --latent_vae '<vae_run>?scale=S'``
     (denoise in latent space -> VAE decode -> pixel PSNR/SSIM)

It also reports the VAE's own reconstruction PSNR (the chain's ceiling):

    python -m fmdm_tpu_torch.scripts.latent_diffusion_sweep --root DIR \\
        [--pixel-root .scratch/torch_r4] [--vae-epochs 30] [--diff-epochs 300] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

import numpy as np

from fmdm_tpu_torch.scripts.flagship_quality_sweep import (
    REPO,
    evaluate_cmd,
    gen_dataset,
    module_cmd,
    newest_metrics,
    read_metrics,
    run,
)

ALIASES = ["ddim", "dpmsolver++", "unipc"]
EMBED_DIM = 4
PREPROCESS = {"MIN_B": -1024, "MAX_B": 3072, "slope": 1.0, "intersept": -1024}


def write_vae_config(root: Path, pixel_root: Path, epochs: int) -> Path:
    cfg = {
        "training": {
            "data_root": str(pixel_root),
            "output_dir": str(root / "vae_run"),
            "batch_size": 16, "train_batch_size": 16,
            "epochs": epochs, "num_epochs": epochs,
            "learning_rate": 1e-4, "weight_decay": 0.0,
            "kl_weight": 1e-6, "reg_type": "kl", "recon_type": "l1",
            # perceptual and GAN off: keep the brief run clean
            "perceptual_weight": 0.0, "gan_weight": 0.0,
            "save_every": max(1, epochs), "checkpoint_every_epochs": max(1, epochs),
            "save_images": False, "seed": 42,
            "slice_count": 1, "img_size": 256, "load_ldct": True,
            "use_tensor_cache": True, "save_tensor_cache": True,
            "mixed_precision": "bf16",
        },
        "model": {
            "in_channels": 1, "out_channels": 1, "resolution": 256,
            "base_ch": 64, "down_channels": [64, 128, 256, 256],
            "num_res_blocks": 2, "attn_resolutions": [], "z_channels": EMBED_DIM,
            "embed_dim": EMBED_DIM, "dropout": 0.0, "use_attention": True,
            "spatial_dims": 2, "double_z": True, "latent_type": "kl",
            "model_type": "vae",
        },
    }
    cfg_dir = root / "configs"
    cfg_dir.mkdir(parents=True, exist_ok=True)
    (cfg_dir / "dataset.json").write_text((REPO / "configs/LDCT/dataset.json").read_text())
    path = cfg_dir / "vae.json"
    path.write_text(json.dumps(cfg, indent=2))
    return path


def write_diff_config(root: Path, latent_root: Path, epochs: int) -> Path:
    cfg = {
        "training": {
            "data_root": str(latent_root),
            "output_dir": str(root / "diff_run"),
            "train_batch_size": 32, "batch_size": 32, "eval_batch_size": 32,
            "num_epochs": epochs,
            "learning_rate": 1e-4, "weight_decay": 0.0,
            "lr_warmup_steps": 200,
            "scheduler": "ddpm", "num_train_timesteps": 1000,
            "num_inference_steps": 50,
            "conditioning": "concatenate",
            "channels": EMBED_DIM, "img_size": 32,
            "save_model_epochs": max(1, epochs),
            "checkpoint_every_epochs": max(1, epochs),
            "mixed_precision": "bf16", "seed": 7,
            "save_images": False,
            "use_tensor_cache": False,
        },
        "model": {
            "unet": {
                "unet_impl": "diffusers_nd",
                "sample_size": 32,
                "in_channels": EMBED_DIM, "out_channels": EMBED_DIM,
                "layers_per_block": 2,
                "block_out_channels": [128, 256, 256],
                "down_block_types": ["DownBlock2D", "AttnDownBlock2D", "DownBlock2D"],
                "up_block_types": ["UpBlock2D", "AttnUpBlock2D", "UpBlock2D"],
            },
            "scheduler": {"name": "ddpm", "num_train_timesteps": 1000,
                          "num_inference_steps": 50,
                          "params": {"beta_start": 0.0001, "beta_end": 0.02}},
            "model_type": "diffusion",
        },
    }
    cfg_dir = latent_root / "configs"
    cfg_dir.mkdir(parents=True, exist_ok=True)
    # at the data root's top: run_model's dataset builder falls back to
    # <data_root>/dataset.json when the run dir's config walk finds nothing
    (latent_root / "dataset.json").write_text(json.dumps(
        {"dataset_class": "fmdm_tpu_torch.data.latent:LatentDataset"}))
    path = cfg_dir / "latent_diffusion.json"
    path.write_text(json.dumps(cfg, indent=2))
    return path


def newest_run(base: Path) -> Path:
    cands = sorted(base.parent.glob(base.name + "*"), key=lambda p: p.stat().st_mtime)
    if not cands:
        raise SystemExit(f"no run dir under {base}*")
    return cands[-1]


def _load_vae(vae_run: Path, device: Optional[str]):
    from fmdm_tpu_torch.device import resolve_device
    from fmdm_tpu_torch.sample.sampling_utils import load_run_config, resolve_checkpoint
    from fmdm_tpu_torch.sample.vae_utils import build_vae_model

    dev = resolve_device(device)
    cfg = load_run_config(vae_run)
    model = build_vae_model(cfg, ckpt_path=resolve_checkpoint(vae_run, "vae"), device=dev)
    return model.eval(), dev


def encode_latents(vae_run: Path, pixel_root: Path, latent_root: Path,
                   device: Optional[str] = None, batch_size: int = 16) -> float:
    """Encode every (SDCT, LDCT) slice pair to latents; returns the stored
    scale S (stored = raw * S, S = 1/std of the raw train target latents)."""
    import torch

    from fmdm_tpu_torch.data.ldct import LDCTDataset
    from fmdm_tpu_torch.sample.vae_utils import encode_vae_batch

    model, dev = _load_vae(vae_run, device)

    def encode(arrays) -> np.ndarray:
        with torch.no_grad():
            return encode_vae_batch(model, torch.from_numpy(np.stack(arrays)).to(dev)).cpu().numpy()

    data_dir = latent_root / "data"
    data_dir.mkdir(parents=True, exist_ok=True)
    scale = None
    for split in ("train", "test"):
        ds = LDCTDataset(str(pixel_root), train=(split == "train"), img_size=256,
                         load_ldct=True, use_tensor_cache=False, preprocess_kwargs=PREPROCESS)
        targets, conds = [], []
        for i in range(len(ds)):
            s = ds[i]
            targets.append(np.asarray(s["target"], np.float32))
            conds.append(np.asarray(s["image"], np.float32))
        bs = batch_size
        z_t = np.concatenate([encode(targets[lo:lo + bs]) for lo in range(0, len(targets), bs)])
        z_c = np.concatenate([encode(conds[lo:lo + bs]) for lo in range(0, len(conds), bs)])
        if scale is None:  # from the train targets only
            scale = float(1.0 / max(np.std(z_t), 1e-6))
        lines = []
        for i in range(len(targets)):
            tp, cp = f"data/{split}_{i}_t.npy", f"data/{split}_{i}_c.npy"
            np.save(latent_root / tp, (z_t[i] * scale).astype(np.float32))
            np.save(latent_root / cp, (z_c[i] * scale).astype(np.float32))
            lines.append(f"{split.upper()}{i}\t{tp}\t{cp}")
        (latent_root / f"{split}.txt").write_text(
            "Case\ttarget\tconditioning\n" + "\n".join(lines) + "\n")
    (latent_root / "latent_scale.json").write_text(json.dumps({"scale": scale}))
    print(f"encoded latents, scale={scale:.4f}", flush=True)
    return scale


def vae_recon_psnr(vae_run: Path, pixel_root: Path, n: int = 64,
                   device: Optional[str] = None) -> float:
    """The chain's ceiling: the VAE's mean reconstruction PSNR over the
    first ``n`` test slices."""
    import torch

    from fmdm_tpu_torch.data.ldct import LDCTDataset
    from fmdm_tpu_torch.sample.vae_utils import reconstruct_vae_batch

    model, dev = _load_vae(vae_run, device)
    ds = LDCTDataset(str(pixel_root), train=False, img_size=256, use_tensor_cache=False,
                     preprocess_kwargs=PREPROCESS)
    psnrs = []
    stop = min(n, len(ds))
    for lo in range(0, stop, 16):
        batch = np.stack([np.asarray(ds[i]["target"], np.float32)
                          for i in range(lo, min(lo + 16, stop))])
        with torch.no_grad():
            rec = reconstruct_vae_batch(model, torch.from_numpy(batch).to(dev)).cpu().numpy()
        mse = np.mean((rec - batch) ** 2, axis=(1, 2, 3))
        psnrs.extend(10.0 * np.log10(1.0 / np.clip(mse, 1e-12, None)))
    return float(np.mean(psnrs))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Latent-diffusion chain sweep.")
    ap.add_argument("--root", type=Path, default=REPO / ".scratch" / "torch_latent_sweep")
    ap.add_argument("--pixel-root", type=Path, default=None,
                    help="existing phantom dataset root (default: generate fresh)")
    ap.add_argument("--vae-epochs", type=int, default=30)
    ap.add_argument("--diff-epochs", type=int, default=300)
    ap.add_argument("--num-samples", type=int, default=144)
    ap.add_argument("--aliases", default=",".join(ALIASES))
    ap.add_argument("--skip-vae", action="store_true")
    ap.add_argument("--skip-encode", action="store_true")
    ap.add_argument("--skip-diff", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the card by default, 'cpu' for the CPU; passed to the CLIs")
    args = ap.parse_args(argv)
    root = args.root.resolve()
    root.mkdir(parents=True, exist_ok=True)

    pixel_root = args.pixel_root.resolve() if args.pixel_root else None
    if pixel_root is None:
        pixel_root = root / "pixels"
        if not (pixel_root / "train.txt").exists():
            gen_dataset(pixel_root, n_train_cases=16, n_test_cases=6)
            print("pixel dataset generated", flush=True)

    # each stage skips itself when its artifact already exists (restart-safe)
    vae_cfg = write_vae_config(root, pixel_root, args.vae_epochs)
    if not args.skip_vae and not any(root.glob("vae_run*/vae_last.pt")):
        run(module_cmd("fmdm_tpu_torch.train", "--config", vae_cfg, device=args.device),
            root / "train_vae.log")
    vae_run = newest_run(root / "vae_run")
    print("vae_run:", vae_run, flush=True)

    latent_root = root / "latents"
    if not args.skip_encode and not (latent_root / "latent_scale.json").exists():
        scale = encode_latents(vae_run, pixel_root, latent_root, args.device)
    else:
        scale = json.loads((latent_root / "latent_scale.json").read_text())["scale"]

    diff_cfg = write_diff_config(root, latent_root, args.diff_epochs)
    if not args.skip_diff and not any(root.glob("diff_run*/diff_last.pt")):
        run(module_cmd("fmdm_tpu_torch.train", "--config", diff_cfg, device=args.device),
            root / "train_diff.log")
    diff_run = newest_run(root / "diff_run")
    print("diff_run:", diff_run, flush=True)

    ceiling = vae_recon_psnr(vae_run, pixel_root, device=args.device)
    print(f"VAE recon PSNR ceiling: {ceiling:.2f}", flush=True)

    results = {}
    for alias in args.aliases.split(","):
        tag = alias.replace("+", "p")
        out = root / "eval" / tag
        out.mkdir(parents=True, exist_ok=True)
        run(evaluate_cmd(diff_run, alias, out, num_samples=args.num_samples, device=args.device,
                         extra=["--latent_vae", f"{vae_run}?scale={scale}"]),
            root / f"eval_{tag}.log")
        metrics = newest_metrics(out)
        if metrics is None:
            print(f"!! no eval_metrics.csv for {alias}")
            continue
        results[alias] = read_metrics(metrics)
        print(alias, results[alias], flush=True)

    print(f"\nVAE recon ceiling: {ceiling:.2f} PSNR")
    print("| sampler | PSNR | SSIM | samples/s (model time) |")
    print("|---|---|---|---|")
    for alias, row in sorted(results.items(), key=lambda kv: -float(kv[1].get("psnr", 0))):
        print(f"| {alias} | {float(row['psnr']):.2f} | {float(row.get('ssim', 0) or 0):.3f} "
              f"| {float(row.get('model_samples_per_second', 0)):.1f} |")
    return results


if __name__ == "__main__":
    main()
