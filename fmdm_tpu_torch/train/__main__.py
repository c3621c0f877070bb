"""
The training CLI of the port (counterpart of the root ``train.py``): the
same flags and dispatch on ``model.model_type`` in {vae, diffusion,
flow_matching}, so an invocation of ``python train.py`` runs here unchanged,
on the card:

    python -m fmdm_tpu_torch.train --config configs/LDCT/LDCT_ddpm_diffusers_nd.json [--resume RUN/diff_last.pt]
    python -m fmdm_tpu_torch.train --config CFG --debug_visual_only --ckpt RUN/diff_best.pt
    python -m fmdm_tpu_torch.train --config CFG --device cpu

``--device`` unset means CUDA, and the CLI raises without a card: only
``--device cpu`` runs it on the CPU. There is no compile cache to enable
(the port compiles no program; its kernels build once into
``build/kernels/``).

Data parallelism, one rank per card (NCCL; gloo with ``--device cpu``):

    python -m torch.distributed.run --nproc_per_node N -m fmdm_tpu_torch.train --config CFG

Each rank runs on ``cuda:LOCAL_RANK`` and feeds its own rows of the global
batch (``parallel/mesh.py``). One process with several cards visible trains
on one card. At exit the pending checkpoint writes are flushed, then the
process group is destroyed.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Callable, Dict

from fmdm_tpu_torch.data.dataset_utils import build_train_val_datasets
from fmdm_tpu_torch.device import resolve_device
from fmdm_tpu_torch.parallel import mesh as mesh_lib
from fmdm_tpu_torch.utils.checkpoint import flush_checkpoint_writes
from fmdm_tpu_torch.utils.config import load_json_config


def _trainers() -> Dict[str, Callable]:
    from fmdm_tpu_torch.train.diffusion_lib import train as train_diffusion
    from fmdm_tpu_torch.train.flow_matching_lib import train as train_flow_matching
    from fmdm_tpu_torch.train.vae_lib import train as train_vae

    return {
        "vae": train_vae,
        "flow_matching": train_flow_matching,
        "diffusion": train_diffusion,
    }


def _debug_visuals() -> Dict[str, Callable]:
    from fmdm_tpu_torch.train.diffusion_lib import debug_visual_only as diffusion
    from fmdm_tpu_torch.train.flow_matching_lib import debug_visual_only as flow_matching
    from fmdm_tpu_torch.train.vae_lib import debug_visual_only as vae

    return {"diffusion": diffusion, "flow_matching": flow_matching, "vae": vae}


def _model_type(cfg: dict) -> str:
    return str(cfg.get("model", {}).get("model_type", "")).lower()


def dispatch_train(cfg_path: Path, resume, device=None) -> None:
    cfg = load_json_config(cfg_path)
    model_type = _model_type(cfg)
    trainers = _trainers()
    trainer = trainers.get(model_type)
    if trainer is None:
        available = ", ".join(trainers.keys())
        raise ValueError(f"Unsupported model_type '{model_type}'. Expected one of {{{available}}}.")
    train_ds, val_ds = build_train_val_datasets(cfg)
    trainer(train_ds, cfg_path, val_dataset=val_ds, resume=resume, device=device)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train models from JSON configs.")
    parser.add_argument("--config", type=Path, required=True, help="Path to JSON config.")
    parser.add_argument("--resume", type=str, default=None, help="Checkpoint path to resume from (optional).")
    parser.add_argument("--debug_visual_only", action="store_true",
                        help="Load checkpoint and save visual generations without training.")
    parser.add_argument("--ckpt", type=str, default=None, help="Checkpoint path for --debug_visual_only.")
    parser.add_argument("--visual_samples", type=int, default=10, help="Number of samples for --debug_visual_only.")
    parser.add_argument("--debug_split", type=str, choices=("train", "test"), default="test",
                        help="Split used by --debug_visual_only.")
    parser.add_argument("--output_dir", type=str, default=None, help="Output dir override for --debug_visual_only.")
    parser.add_argument("--seed", type=int, default=None, help="Seed override for --debug_visual_only.")
    parser.add_argument("--device", type=str, default=None,
                        help="Device to run on: CUDA by default, which needs a card; 'cpu' runs "
                             "the plain PyTorch path on the CPU.")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
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
    if args.debug_visual_only:
        cfg = load_json_config(args.config)
        model_type = _model_type(cfg)
        if not args.ckpt:
            raise ValueError("--ckpt is required when using --debug_visual_only.")
        debug = _debug_visuals().get(model_type)
        if debug is None:
            raise ValueError(f"--debug_visual_only unsupported model_type '{model_type}'.")
        train_ds, val_ds = build_train_val_datasets(cfg)
        ds = train_ds if args.debug_split == "train" else val_ds
        debug(ds, args.config, args.ckpt, output_dir=args.output_dir,
              visual_samples=args.visual_samples, seed=args.seed, device=device)
        return
    dispatch_train(args.config, args.resume, device)


if __name__ == "__main__":
    main()
