"""
The sampling CLI of the port (counterpart of ``fmdm_tpu/run_model.py``):
the same 6 modes, flags and handler registry, so an invocation of the JAX
package's ``run_model.py`` runs here unchanged, on the card:

    python -m fmdm_tpu_torch.run_model --ckpt_dir RUN --mode evaluate --num_samples 8 \\
        --num_inference_steps 4 --output_dir OUT
    python -m fmdm_tpu_torch.run_model --ckpt_dir RUN --mode evaluate --device cpu ...

``--device`` unset means CUDA, and the CLI raises without a card: only
``--device cpu`` runs it on the CPU. Every model type is ported (the
diffusion, flow-matching and VAE run dirs, KL and VQ), with
``--deep_cache`` and ``--latent_vae``:

    python -m fmdm_tpu_torch.run_model --ckpt_dir RUN --mode evaluate --deep_cache 3:1:adaptive
    python -m fmdm_tpu_torch.run_model --ckpt_dir RUN --mode evaluate --deep_cache auto:0.5
    python -m fmdm_tpu_torch.run_model --ckpt_dir LATENT_RUN --mode evaluate \
        --latent_vae "VAE_RUN?scale=0.18215"

``--quantize int8|int8+linear`` decodes with the int8 weights of
``utils/quantize.py``'s policy, calibrated on the card at the first batch:

    python -m fmdm_tpu_torch.run_model --ckpt_dir RUN --mode evaluate --quantize int8

With several cards visible each batch is split over them (data-parallel
sampling, one process; ``--no_dp_sampling`` keeps one card). There is no
compile cache to enable.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from fmdm_tpu_torch.device import resolve_device
from fmdm_tpu_torch.sample.diffusion_utils import (set_deep_cache, set_dp_sampling, set_quantize,
                                                   set_use_ema)
from fmdm_tpu_torch.sample.handlers import DiffusionHandler, FlowMatchingHandler, VAEHandler
from fmdm_tpu_torch.sample.sampling_utils import load_run_config

HANDLER_REGISTRY = {
    "vae": VAEHandler,
    "diffusion": DiffusionHandler,
    "flow_matching": FlowMatchingHandler,
}

MODES = ("sample", "encode", "decode", "evaluate", "build_tensor_cache", "debug_compare")

# (flag, kwargs): every flag but --mode also goes to the handler under its
# own name; store_true flags as booleans
_FLAG_SPEC = [
    ("--ckpt_dir", dict(type=Path, required=True,
                        help="Checkpoint directory containing train_config.json.")),
    ("--mode", dict(type=str, choices=MODES, default="sample")),
    ("--data_txt", dict(type=str, default=None, help="Optional override split file.")),
    ("--save", dict(action="store_true", help="Save outputs to disk.")),
    ("--output_dir", dict(type=str, default=None,
                          help="Output root directory (defaults to ckpt_dir/outputs).")),
    ("--batch_size", dict(type=int, default=4, help="Batch size for processing.")),
    ("--device", dict(type=str, default=None,
                      help="Device to run on: CUDA by default, which needs a card; 'cpu' runs "
                           "the plain PyTorch path on the CPU.")),
    ("--seed", dict(type=int, default=42, help="Random seed.")),
    ("--timestep", dict(type=int, default=None, help="Optional timestep for encode.")),
    ("--num_samples", dict(type=int, default=None, help="Random subset size to process.")),
    ("--num_inference_steps", dict(type=int, default=None,
                                   help="Override scheduler inference steps (diffusion/flow only).")),
    ("--start_step", dict(type=int, default=None,
                          help="Start denoising from this train-timestep index (e.g., 700 runs from t<=700).")),
    ("--last_n_steps", dict(type=int, default=None, help="Run only the last N denoising steps.")),
    ("--scheduler", dict(type=str, default=None,
                         help="Override scheduler at runtime (ddpm, ddim, dpmsolver1, dpmsolver2, "
                              "dpmsolver++, dpmsolversde, unipc, flowmatch). Optional query "
                              "params reach the scheduler config surface, e.g. "
                              "'dpmsolver++?thresholding=true' (dynamic thresholding — "
                              "stabilizes DPM-family solvers on imperfect pixel-space models).")),
    ("--save_input", dict(action="store_true",
                          help="Also save model inputs when --save is enabled.")),
    ("--save_conditioning", dict(action="store_true",
                                 help="Also save conditioning tensors when --save is enabled.")),
    ("--save_tensor_cache", dict(action="store_true",
                                 help="Force writing tensor cache files at runtime without editing train_config.json.")),
    ("--deep_cache", dict(type=str, default=None,
                          help="DeepCache acceleration 'INTERVAL[:DEPTH[:SCHEDULE]]' (e.g. 3, 3:1, "
                               "3:1:uniform): refresh the deep UNet levels on a schedule, recompute "
                               "only the shallow levels in between. SCHEDULE 'adaptive' (default) "
                               "keeps the first and last denoise steps full; 'uniform' is classic "
                               "DeepCache. Or 'auto[:dPSNR]' (evaluate mode only, default budget "
                               "0.5): probe candidate intervals on the first reference batch and "
                               "keep the fastest within the PSNR budget of exact sampling. Applies "
                               "to diffusers_nd UNets; others sample exactly, with a warning. "
                               "Omit for exact sampling.")),
    ("--latent_vae", dict(type=str, default=None,
                          help="Run dir of a trained VAE that decodes the samples (and, in "
                               "evaluate, the targets) as latents before saving and scoring; "
                               "'<run_dir>?scale=S' divides the stored latents by S first.")),
    ("--quantize", dict(type=str, default=None, choices=["int8", "int8+linear"],
                        help="Post-training quantized inference: 'int8' runs eligible "
                             "convolutions as int8 GEMMs (W8A8, per-channel weight scales, "
                             "activation scales calibrated on the first batch); 'int8+linear' "
                             "also quantizes the attention to_q/to_k/to_v/to_out projections "
                             "(token-gated policy, utils/quantize.py). Beyond-reference flag.")),
    ("--use_ema", dict(action="store_true",
                       help="Load the EMA shadow weights ('ema' tree, written when "
                            "training.ema_decay > 0) instead of the live weights. "
                            "Fails loudly if the checkpoint has no EMA tree.")),
    ("--no_dp_sampling", dict(action="store_true",
                              help="Disable data-parallel sampling over the visible cards (on by "
                                   "default; a no-op on one card).")),
]


def _parse_deep_cache(value):
    """'INTERVAL[:DEPTH[:SCHEDULE]]' -> (interval, depth, schedule), or
    'auto[:dPSNR]' -> ("auto", budget), as the JAX package parses it."""
    if value is None:
        return None
    parts = str(value).split(":")
    if parts[0] == "auto":
        budget = float(parts[1]) if len(parts) > 1 and parts[1] else 0.5
        if budget <= 0:
            raise ValueError("--deep_cache auto:<dPSNR> needs a positive budget")
        return ("auto", budget)
    interval = int(parts[0])
    depth = int(parts[1]) if len(parts) > 1 and parts[1] else 1
    schedule = parts[2] if len(parts) > 2 and parts[2] else "adaptive"
    if schedule not in ("adaptive", "uniform"):
        raise ValueError(f"--deep_cache schedule must be 'adaptive' or 'uniform', got '{schedule}'")
    return (interval, depth, schedule)


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Run sampling/encoding/decoding/eval/cache-build from a checkpoint dir.")
    for flag, kwargs in _FLAG_SPEC:
        parser.add_argument(flag, **kwargs)
    return parser


def _resolve_handler(model_type: str):
    key = str(model_type).lower()
    if key not in HANDLER_REGISTRY:
        raise ValueError(f"Unsupported model_type '{model_type}'.")
    return HANDLER_REGISTRY[key]


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s | %(levelname)s | %(message)s", force=True)
    args = _build_parser().parse_args(argv)
    device = resolve_device(args.device)

    cfg = load_run_config(args.ckpt_dir)
    handler_cls = _resolve_handler(cfg.get("model", {}).get("model_type", "vae"))
    handler_kwargs = {name.lstrip("-"): getattr(args, name.lstrip("-"))
                      for name, _ in _FLAG_SPEC if name != "--mode"}
    handler_kwargs["device"] = str(device)
    # engine-level runtime options, outside the handler surface
    set_deep_cache(_parse_deep_cache(handler_kwargs.pop("deep_cache")))
    set_dp_sampling(not handler_kwargs.pop("no_dp_sampling"))
    set_use_ema(handler_kwargs.pop("use_ema"))
    set_quantize(handler_kwargs.pop("quantize"))
    handler = handler_cls(**handler_kwargs)
    # every mode is the handler method of the same name
    getattr(handler, args.mode)()


if __name__ == "__main__":
    main()
