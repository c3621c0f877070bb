"""
Legacy per-trainer CLI (counterpart of ``fmdm_tpu/legacy_train.py``): the
reference's vestigial per-trainer entry point, with its override flags
patched into a copy of the config, then the port's trainer of that name.

    python -m fmdm_tpu_torch.legacy_train <trainer> --config cfg.json
        [--device cuda|cpu] [--epochs N] [--batch_size N] [--img_size N] [--channels N]

``--device`` is the config's ``manual_device`` override, as in JAX, and the
device the trainer runs on: CUDA when unset (which needs a card;
``cuda:LOCAL_RANK`` under ``python -m torch.distributed.run``), the CPU only
when asked for. At exit pending checkpoint writes are flushed and the
process group, if any, destroyed.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from importlib import import_module
from pathlib import Path

from fmdm_tpu_torch.data.dataset_utils import build_train_val_datasets
from fmdm_tpu_torch.device import resolve_device
from fmdm_tpu_torch.parallel import mesh as mesh_lib
from fmdm_tpu_torch.utils.checkpoint import flush_checkpoint_writes
from fmdm_tpu_torch.utils.config import load_json_config

TRAINER_MODULES = {
    "vae": "fmdm_tpu_torch.train.vae_lib",
    "vae_lib": "fmdm_tpu_torch.train.vae_lib",
    "diffusion": "fmdm_tpu_torch.train.diffusion_lib",
    "diffusion_lib": "fmdm_tpu_torch.train.diffusion_lib",
    "flow_matching": "fmdm_tpu_torch.train.flow_matching_lib",
    "flow_matching_lib": "fmdm_tpu_torch.train.flow_matching_lib",
}


def build_overrides(args) -> dict:
    overrides = {}
    if args.device is not None:
        overrides["manual_device"] = args.device
    if args.epochs is not None:
        overrides["epochs"] = args.epochs
        overrides["num_epochs"] = args.epochs
    if args.batch_size is not None:
        overrides["batch_size"] = args.batch_size
        overrides["train_batch_size"] = args.batch_size
    if args.img_size is not None:
        overrides["img_size"] = args.img_size
    if args.channels is not None:
        overrides["channels"] = args.channels
    if args.perceptual_device is not None:
        overrides["perceptual_device"] = args.perceptual_device
    if args.disc_device is not None:
        overrides["disc_device"] = args.disc_device
    return overrides


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Legacy per-trainer entrypoint.")
    parser.add_argument("trainer", choices=sorted(TRAINER_MODULES.keys()))
    parser.add_argument("--config", type=Path, required=True)
    parser.add_argument("--resume", type=str, default=None)
    parser.add_argument("--device", type=str, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--img_size", type=int, default=None)
    parser.add_argument("--channels", type=int, default=None)
    parser.add_argument("--perceptual_device", type=str, default=None)
    parser.add_argument("--disc_device", type=str, default=None)
    args = parser.parse_args(argv)
    joined = mesh_lib.maybe_initialize_distributed(args.device)
    try:
        _run(args)
    finally:
        flush_checkpoint_writes()
        if joined:
            mesh_lib.destroy_distributed()


def _run(args) -> None:
    device = (mesh_lib.rank_device(args.device) if mesh_lib.group_active()
              else resolve_device(args.device))

    cfg = load_json_config(args.config)
    overrides = build_overrides(args)
    cfg_path = args.config
    if overrides:
        cfg["training"].update(overrides)
        tmp = tempfile.NamedTemporaryFile(
            "w", suffix=".json", prefix="legacy_train_", delete=False,
            dir=str(Path(args.config).parent),
        )
        json.dump({k: v for k, v in cfg.items() if k != "__config_path__"}, tmp, indent=2)
        tmp.close()
        cfg_path = Path(tmp.name)
        cfg = load_json_config(cfg_path)

    module = import_module(TRAINER_MODULES[args.trainer])
    train_ds, val_ds = build_train_val_datasets(cfg)
    module.train(train_ds, cfg_path, val_dataset=val_ds, resume=args.resume, device=device)


if __name__ == "__main__":
    main()
