"""
Helpers of the sampling modes (counterpart of
``fmdm_tpu/sample/sampling_utils.py``): run-config loading, with a
``{training, model}`` config synthesized from a legacy diffusers pipeline
folder; checkpoint resolution (best > last > legacy safetensors); the
dataset of a run for sampling or evaluation (evaluation caches in their own
``<subdir>_eval`` namespace), batches with a progress bar where tqdm is
installed, the tensor-cache build; output roots, seeded subsets, the eval
CSV schemas and timestamped experiment directories.
"""

from __future__ import annotations

import csv
import json
import random
from datetime import datetime
from pathlib import Path
from typing import Optional

from fmdm_tpu_torch.data.dataset_utils import build_dataset_from_config, iter_batches
from fmdm_tpu_torch.utils.config import load_json_config

# scheduler_config.json keys that are routing or bookkeeping, not step() params
_SCHEDULER_NON_PARAM_KEYS = frozenset({
    "_class_name", "_diffusers_version", "num_train_timesteps",
    "num_inference_steps", "trained_betas",
})

# unet config keys forwarded verbatim into the synthesized model spec, with
# their coercions and defaults
_LEGACY_UNET_PASSTHROUGH = (
    ("layers_per_block", int, 2),
    ("attention_head_dim", int, 8),
    ("norm_num_groups", int, 32),
    ("norm_eps", float, 1e-5),
    ("flip_sin_to_cos", bool, True),
    ("freq_shift", int, 0),
    ("center_input_sample", bool, False),
    ("resnet_time_scale_shift", str, "default"),
    ("add_attention", bool, True),
)


def _legacy_layout(ckpt_dir: Path):
    """The three config files of a diffusers pipeline folder, or None."""
    model_index = ckpt_dir / "model_index.json"
    scheduler_cfg = ckpt_dir / "scheduler" / "scheduler_config.json"
    unet_cfg = ckpt_dir / "unet" / "config.json"
    if not unet_cfg.exists():
        unet_cfg = ckpt_dir / "unet" / "config.txt"
    if model_index.exists() and scheduler_cfg.exists() and unet_cfg.exists():
        return model_index, scheduler_cfg, unet_cfg
    return None


def _scheduler_spec(scheduler_cfg: dict) -> dict:
    n_train = int(scheduler_cfg.get("num_train_timesteps", 1000))
    class_name = str(scheduler_cfg.get("_class_name", "DDPMScheduler"))
    return {
        "name": class_name.replace("Scheduler", "").lower(),
        "num_train_timesteps": n_train,
        "num_inference_steps": n_train,
        "params": {k: v for k, v in scheduler_cfg.items() if k not in _SCHEDULER_NON_PARAM_KEYS},
    }


def _unet_spec(unet_cfg: dict, in_channels: int, out_channels: int) -> dict:
    spec = {
        "unet_impl": "diffusers_nd",
        # the saved in_channels already include concatenated conditioning
        "in_channels_already_conditioned": True,
        "sample_size": unet_cfg.get("sample_size", 256),
        "in_channels": in_channels,
        "out_channels": out_channels,
        "block_out_channels": tuple(unet_cfg.get("block_out_channels", [128, 128, 256, 256, 512, 512])),
        "down_block_types": tuple(unet_cfg.get("down_block_types", [])),
        "up_block_types": tuple(unet_cfg.get("up_block_types", [])),
        "load_legacy": True,
    }
    for key, coerce, default in _LEGACY_UNET_PASSTHROUGH:
        spec[key] = coerce(unet_cfg.get(key, default))
    return spec


def _load_diffusers_legacy_run_config(ckpt_dir: Path) -> dict:
    """A ``{training, model}`` run config synthesized from a legacy diffusers
    pipeline folder."""
    layout = _legacy_layout(ckpt_dir)
    if layout is None:
        raise FileNotFoundError(
            "Missing train_config.json and could not resolve a legacy diffusers folder layout.")
    model_index_path, scheduler_cfg_path, unet_cfg_path = layout
    scheduler_cfg = json.loads(scheduler_cfg_path.read_text())
    unet_cfg = json.loads(unet_cfg_path.read_text())

    in_channels = int(unet_cfg.get("in_channels", 1))
    out_channels = int(unet_cfg.get("out_channels", 1))
    # extra input channels can only have come from channel-stacked conditioning
    conditioning = "concatenate" if in_channels > out_channels else None
    n_train = int(scheduler_cfg.get("num_train_timesteps", 1000))
    return {
        "training": {
            "data_root": "/",
            "dataset": "ldct",
            "channels": out_channels,
            "img_size": int(unet_cfg.get("sample_size", 256)),
            "num_train_timesteps": n_train,
            "num_inference_steps": n_train,
            "conditioning": conditioning,
            "load_ldct": conditioning is not None,
            "norm": True,
        },
        "model": {
            "model_type": "diffusion",
            "conditioning": conditioning,
            "scheduler": _scheduler_spec(scheduler_cfg),
            "unet": _unet_spec(unet_cfg, in_channels, out_channels),
            "legacy_source": {
                "model_index": json.loads(model_index_path.read_text()),
                "scheduler_config_path": str(scheduler_cfg_path),
                "unet_config_path": str(unet_cfg_path),
            },
        },
        "__config_path__": str(model_index_path),
    }


def load_run_config(ckpt_dir: Path) -> dict:
    """A run dir's ``train_config.json``, or the config of a legacy diffusers
    pipeline folder; ``__config_path__`` names an existing file."""
    ckpt_dir = Path(ckpt_dir)
    cfg_path = ckpt_dir / "train_config.json"
    if not cfg_path.exists():
        return _load_diffusers_legacy_run_config(ckpt_dir)
    cfg = load_json_config(cfg_path)
    recorded = cfg.get("__config_path__")
    if not (recorded and Path(recorded).exists()):
        cfg["__config_path__"] = str(cfg_path)
    return cfg


_CKPT_PREFERENCE = {
    "vae": ("vae_best.pt", "vae_last.pt"),
    "diffusion": ("diff_best.pt", "diff_last.pt"),
    "flow_matching": ("flow_best.pt", "flow_last.pt"),
}


def resolve_checkpoint(ckpt_dir: Path, model_type: str) -> Path:
    """best > last > (diffusion only) the legacy unet safetensors > the
    newest *.pt (other model types)."""
    model_type = str(model_type).lower()
    ckpt_dir = Path(ckpt_dir)
    for name in _CKPT_PREFERENCE.get(model_type, ()):
        if (ckpt_dir / name).exists():
            return ckpt_dir / name
    if model_type == "diffusion":
        legacy = ckpt_dir / "unet" / "diffusion_pytorch_model.safetensors"
        if legacy.exists():
            return legacy
    if model_type not in _CKPT_PREFERENCE:
        candidates = sorted(ckpt_dir.glob("*.pt"))
        if candidates:
            return candidates[-1]
    raise FileNotFoundError(f"No checkpoint found in {ckpt_dir}")


def _eval_cache_subdir(cache_subdir: Optional[str]) -> str:
    name = str(cache_subdir or "cache")
    return name if name.endswith("_eval") else f"{name}_eval"


def build_sampling_dataset(cfg: dict, data_txt: Optional[str], evaluate: bool = False,
                           save_tensor_cache_override: Optional[bool] = None):
    """The test split of a run's dataset: ``data_txt`` as its split file
    (else the config's, dropped under ``evaluate``), and under ``evaluate``
    its tensor cache in ``<subdir>_eval``, apart from caches built under the
    training's preprocessing."""
    training_cfg = dict(cfg.get("training", {}))
    if save_tensor_cache_override is not None:
        training_cfg["save_tensor_cache"] = bool(save_tensor_cache_override)
    if data_txt:
        training_cfg["split_file"] = data_txt
    elif evaluate:
        training_cfg.pop("split_file", None)
    if evaluate:
        training_cfg["tensor_cache_subdir"] = _eval_cache_subdir(training_cfg.get("tensor_cache_subdir"))
    cfg_path = Path(cfg["__config_path__"]) if cfg.get("__config_path__") else None
    return build_dataset_from_config(training_cfg, cfg.get("model", {}), train=False, cfg_path=cfg_path)


def progress_batches(dataset, batch_size: int, desc: str, indices=None):
    """:func:`iter_batches`, behind a tqdm bar where tqdm is installed (shown
    on a terminal only)."""
    selected = list(range(len(dataset))) if indices is None else list(indices)
    iterator = iter_batches(dataset, batch_size, indices=selected)
    try:
        from tqdm import tqdm
    except ImportError:
        return iterator
    return tqdm(iterator, total=-(-len(selected) // max(int(batch_size), 1)), desc=desc,
                leave=False, dynamic_ncols=True, disable=None)


def build_tensor_cache_from_config(cfg: dict, data_txt: Optional[str], batch_size: int,
                                   seed: int, num_samples: Optional[int],
                                   desc: str = "build_tensor_cache", evaluate: bool = True) -> int:
    """Read every selected sample of the evaluation dataset, which writes
    its entries' tensor cache where the run's config (or its dataset.json)
    turns ``save_tensor_cache`` on; returns the number of samples."""
    dataset = build_sampling_dataset(cfg, data_txt, evaluate=evaluate)
    indices = resolve_sample_indices(dataset, num_samples, seed=seed)
    total = 0
    for _, samples in progress_batches(dataset, batch_size, desc, indices=indices):
        total += len(samples)
    return total


def resolve_output_root(ckpt_dir: Path, output_dir: Optional[str], save: bool) -> Optional[Path]:
    if not save:
        return None
    return Path(output_dir) if output_dir else Path(ckpt_dir) / "outputs"


def resolve_sample_indices(dataset, num_samples: Optional[int], seed: int = 42):
    """All indices, or a seeded random subset when 0 < num_samples < len."""
    total = len(dataset)
    if total == 0:
        return []
    if num_samples is None or not (0 < int(num_samples) < total):
        return list(range(total))
    return random.Random(seed).sample(list(range(total)), int(num_samples))


def _csv_out(ckpt_dir: Path, filename: str) -> Path:
    out_path = Path(ckpt_dir) / filename
    out_path.parent.mkdir(parents=True, exist_ok=True)
    return out_path


def append_eval_metrics(ckpt_dir: Path, row: dict) -> Path:
    """Append one stringified row to eval_metrics.csv (header on first write)."""
    out_path = _csv_out(ckpt_dir, "eval_metrics.csv")
    payload = {str(k): str(v) for k, v in row.items()}
    write_header = not out_path.exists()
    with out_path.open("a", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=list(payload))
        if write_header:
            writer.writeheader()
        writer.writerow(payload)
    return out_path


def write_eval_metrics(ckpt_dir: Path, row: dict) -> Path:
    """Overwrite eval_metrics.csv with a single stringified row."""
    out_path = _csv_out(ckpt_dir, "eval_metrics.csv")
    payload = {str(k): str(v) for k, v in row.items()}
    with out_path.open("w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=list(payload))
        writer.writeheader()
        writer.writerow(payload)
    return out_path


def append_per_image_eval_metrics(ckpt_dir: Path, rows) -> Path:
    """Overwrite eval_metrics_per_image.csv; its columns are the union of the
    rows' keys in first-seen order, missing cells empty."""
    out_path = _csv_out(ckpt_dir, "eval_metrics_per_image.csv")
    if not rows:
        if not out_path.exists():
            out_path.write_text("")
        return out_path
    fieldnames = list(dict.fromkeys(key for row in rows for key in row))
    with out_path.open("w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=fieldnames)
        writer.writeheader()
        for row in rows:
            writer.writerow({k: row.get(k, "") for k in fieldnames})
    return out_path


def create_experiment_dir(output_dir, mode: str, scheduler: Optional[str],
                          last_n_steps: Optional[int], start_step: Optional[int],
                          num_inference_steps: Optional[int], num_samples: Optional[int],
                          seed: int, batch_size: int) -> Optional[Path]:
    """<ts>_<mode>_<sched>_<steptag>_<ns>_seed<seed>_bs<bs>, created fresh."""
    if not output_dir:
        return None
    root = Path(output_dir)
    root.mkdir(parents=True, exist_ok=True)
    if last_n_steps is not None:
        step_tag = f"last{int(last_n_steps)}"
    elif start_step is not None:
        step_tag = f"start{int(start_step)}"
    elif num_inference_steps is not None:
        step_tag = f"steps{int(num_inference_steps)}"
    else:
        step_tag = "stepscfg"
    pieces = (
        datetime.now().strftime("%Y-%m-%d_%H-%M-%S"),
        mode,
        (scheduler or "default").replace("+", "pp"),
        step_tag,
        f"ns{num_samples}" if num_samples is not None else "nsall",
        f"seed{int(seed)}",
        f"bs{int(batch_size)}",
    )
    exp_dir = root / "_".join(pieces)
    exp_dir.mkdir(parents=True, exist_ok=False)
    return exp_dir
