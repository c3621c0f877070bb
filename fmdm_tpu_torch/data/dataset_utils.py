"""
Dataset configuration, the tensor cache and path resolution (counterpart of
``fmdm_tpu/data/dataset_utils.py``): the ``dataset.json`` walk up from the
config, ``'module:Symbol'`` classes (the reference's ``datasets.*`` names
and the JAX package's ``fmdm_tpu.data.*`` names both map onto this
package), the constructor keyword mapping, volumes split into windows, the
mirrored cache tree ``<stem>[_split_<i>].pt`` written atomically,
``iter_batches`` and ``save_output_tensor``.

A cache file holds one f32 CPU tensor written by ``torch.save``, so a cache
written by either package reads in the other.
"""

from __future__ import annotations

import inspect
import json
import os
import tempfile
from importlib import import_module
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from fmdm_tpu_torch.data.io import load

# the reference's package names, as dataset.json files spell them
MODULE_ALIASES = {
    "datasets.base": "fmdm_tpu_torch.data.base",
    "datasets.mnist": "fmdm_tpu_torch.data.mnist",
    "datasets.ldct": "fmdm_tpu_torch.data.ldct",
    "datasets": "fmdm_tpu_torch.data",
}
# a data root set up by the JAX package names its classes there
_JAX_DATA_PACKAGE = "fmdm_tpu.data"


def _port_module(module_name: str) -> str:
    """The module of this package that a dataset.json module name means."""
    if module_name in MODULE_ALIASES:
        return MODULE_ALIASES[module_name]
    if module_name == _JAX_DATA_PACKAGE or module_name.startswith(_JAX_DATA_PACKAGE + "."):
        return "fmdm_tpu_torch.data" + module_name[len(_JAX_DATA_PACKAGE):]
    if module_name.split(".")[0] == "fmdm_tpu":
        raise ImportError(f"'{module_name}' is a module of the JAX package, which the port "
                          "never imports; only its data classes have counterparts here.")
    return module_name


def _import_symbol(path: str):
    if ":" not in path:
        raise ValueError(f"Invalid dataset_class '{path}'. Use 'module:Symbol'.")
    module_name, symbol = path.split(":", 1)
    module_name = _port_module(module_name)
    module = import_module(module_name)
    if not hasattr(module, symbol):
        raise ImportError(f"Cannot find '{symbol}' in module '{module_name}'.")
    return getattr(module, symbol)


# ---------------------------------------------------------------------------
# Windowing / entry resolution
# ---------------------------------------------------------------------------

def consecutive_paths(directory: str, split: int = 3):
    """The files of ``directory``, sorted, as runs of ``split`` consecutive
    files (all of them for a negative split, one each for 0 and 1)."""
    directory_path = Path(directory)
    if not directory_path.exists():
        return []
    if directory_path.is_file():
        return [[str(directory_path)]]
    files = sorted(str(directory_path / f) for f in os.listdir(directory_path)
                   if (directory_path / f).is_file())
    if not files:
        return []
    if split < 0:
        split = max(len(files), 1)
    if split <= 1:
        return [[f] for f in files]
    return [files[i: i + split] for i in range(0, len(files) - split + 1)]


def absolute_path(root_path: Path, entry) -> Path:
    entry_path = Path(str(entry))
    return entry_path if entry_path.is_absolute() else root_path / entry_path


def maybe_unwrap(paths):
    if isinstance(paths, (list, tuple)) and len(paths) == 1:
        return paths[0]
    return paths


def resolve_entry(root_path: Path, entry, window_size: int) -> list:
    full_path = absolute_path(root_path, entry)
    if full_path.is_dir():
        return [paths for paths in consecutive_paths(str(full_path), window_size) if paths]
    return [[str(full_path)]]


def split_volume_entry(path: str, window_size: int) -> list:
    """A volume file as its windows of ``window_size`` slices, each a dict
    ``{path, split_index, split_count, window}``; ``[path]`` for a single
    slice, a negative window or a volume shorter than the window."""
    image = load(path, id=None).get("Image")
    if image is None:
        return [path]
    array = np.asarray(image)
    depth = array.shape[0] if array.ndim >= 3 else 1
    if window_size < 0 or depth <= 1:
        return [path]
    if window_size <= 1:
        return [{"path": path, "split_index": idx, "split_count": depth, "window": 1}
                for idx in range(depth)]
    if depth < window_size:
        return [path]
    count = depth - window_size + 1
    return [{"path": path, "split_index": idx, "split_count": count, "window": window_size}
            for idx in range(count)]


# ---------------------------------------------------------------------------
# Dataset builders (dataset.json discovery)
# ---------------------------------------------------------------------------

def build_dataset_from_config(training_cfg: dict, model_cfg: Optional[dict] = None,
                              train: bool = True, cfg_path: Optional[Path] = None):
    """The dataset of a run: the class named by the first ``dataset.json``
    found from ``cfg_path``'s directory upwards, else in ``data_root``, else
    the one inferred from the dataset's name; the json's other keys override
    ``training_cfg``'s."""
    dataset_json = _find_dataset_json(cfg_path)
    if dataset_json is None:
        # a run dir's frozen train_config.json seldom has a dataset.json among
        # its ancestors: the data root is its durable home
        data_root = (training_cfg or {}).get("data_root")
        if data_root and (Path(data_root) / "dataset.json").exists():
            dataset_json = Path(data_root) / "dataset.json"
    if dataset_json is None:
        dataset_class = _infer_dataset_class(training_cfg, model_cfg)
        if not dataset_class:
            raise ValueError("dataset.json not found in config directory or parents.")
        return _build_from_class(dataset_class, dict(training_cfg or {}), train)
    dataset_cfg = _read_dataset_config(dataset_json)
    dataset_class = dataset_cfg.get("dataset_class")
    if not dataset_class:
        raise ValueError(f"dataset.json missing 'dataset_class': {dataset_json}")
    merged_cfg = dict(training_cfg or {})
    merged_cfg.update({k: v for k, v in dataset_cfg.items() if k != "dataset_class"})
    return _build_from_class(dataset_class, merged_cfg, train)


def _infer_dataset_class(training_cfg: dict, model_cfg: Optional[dict] = None) -> Optional[str]:
    """The class a config names by its dataset name or split file."""
    model_cfg = model_cfg or {}
    dataset_name = str(training_cfg.get("dataset", "")).strip().lower()
    conditioning = str(training_cfg.get("conditioning", model_cfg.get("conditioning", ""))).strip().lower()
    split_file = str(training_cfg.get("split_file", "")).lower()
    attention = (conditioning == "attention" or "encodeddataset" in split_file
                 or "pixelattention" in split_file)
    if dataset_name == "mnist" or (dataset_name != "ldct" and "mnist" in split_file):
        return "datasets.mnist:MNISTDataset"
    if dataset_name == "ldct" or "ldct" in split_file:
        return "datasets.ldct:LDCTAttentionDataset" if attention else "datasets.ldct:LDCTDataset"
    return None


def build_train_val_datasets(cfg: dict) -> Tuple[object, object]:
    training_cfg = cfg["training"]
    cfg_path_value = cfg.get("__config_path__") if isinstance(cfg, dict) else None
    cfg_path = Path(cfg_path_value) if cfg_path_value else None
    model_cfg = cfg.get("model", {}) if isinstance(cfg, dict) else {}
    train_ds = build_dataset_from_config(training_cfg, model_cfg, train=True, cfg_path=cfg_path)
    val_ds = build_dataset_from_config(training_cfg, model_cfg, train=False, cfg_path=cfg_path)
    return train_ds, val_ds


def _find_dataset_json(cfg_path: Optional[Path]) -> Optional[Path]:
    if cfg_path is None or not str(cfg_path):
        return None
    cursor = Path(cfg_path).parent
    while True:
        candidate = cursor / "dataset.json"
        if candidate.exists():
            return candidate
        if cursor.parent == cursor:
            return None
        cursor = cursor.parent


def _read_dataset_config(dataset_json: Path) -> dict:
    with Path(dataset_json).open("r") as fh:
        payload = json.load(fh)
    if not isinstance(payload, dict):
        raise ValueError(f"dataset.json must contain a JSON object: {dataset_json}")
    return payload


def _build_from_class(dataset_class: str, training_cfg: dict, train: bool):
    target = _import_symbol(dataset_class)
    if inspect.isclass(target):
        sig = inspect.signature(target.__init__)
        return target(**_build_dataset_kwargs(training_cfg, train, sig.parameters.keys()))
    if callable(target):
        return target(training_cfg, train)
    raise TypeError(f"dataset_class '{dataset_class}' is not callable.")


# constructor parameter -> training-config key
_KWARG_KEYS = {
    "file_path": "data_root",
    "root": "data_root",
    "cache_subdir": "tensor_cache_subdir",
}


def _build_dataset_kwargs(training_cfg: dict, train: bool, keys) -> dict:
    """The constructor's keyword arguments from a training config: each
    parameter from the key of its name (``_KWARG_KEYS`` for the renamed
    ones), ``window_size`` also from ``slice_count``, and ``conditioning``
    (a mode string in configs) as a bool."""
    kwargs = {}
    for param in keys:
        if param == "self":
            continue
        if param == "train":
            kwargs["train"] = train
            continue
        if param == "conditioning":
            # datasets take a bool ("load the conditioning column")
            raw = training_cfg.get("conditioning")
            kwargs[param] = raw if isinstance(raw, bool) else \
                str(raw or "").strip().lower() in {"concatenate", "attention", "true", "1"}
            continue
        cfg_key = _KWARG_KEYS.get(param, param)
        if cfg_key in training_cfg:
            kwargs[param] = training_cfg[cfg_key]
        elif param == "window_size" and "slice_count" in training_cfg:
            kwargs[param] = training_cfg["slice_count"]
    return kwargs


# ---------------------------------------------------------------------------
# Tensor cache (mirrored tree of .pt files)
# ---------------------------------------------------------------------------

def cache_path_for_entry(base_path: Path, cache_root: Path, entry,
                         split_index: Optional[int] = None, split_count: int = 1) -> Optional[Path]:
    """Where an entry's tensor lives under ``cache_root``: its path relative
    to ``base_path`` (or its file name), stem ``.pt``, with ``_split_<i>``
    for one window of several."""
    if cache_root is None:
        return None
    if isinstance(entry, list):
        if not entry:
            return None
        base = entry[0]
    elif isinstance(entry, dict):
        base = entry.get("path")
        if base is None and isinstance(entry.get("paths"), (list, tuple)) and entry["paths"]:
            base = entry["paths"][0]
    else:
        base = entry
    if base is None:
        return None
    entry_path = Path(str(base))
    if entry_path.is_absolute():
        try:
            rel = entry_path.relative_to(base_path)
        except ValueError:
            rel = Path(entry_path.name)
    else:
        rel = entry_path
    split = split_count > 1 and split_index is not None
    filename = f"{rel.stem}_split_{split_index}.pt" if split else f"{rel.stem}.pt"
    return Path(cache_root) / rel.parent / filename


def save_tensor_cache(array, cache_path: Path) -> None:
    """Write ``array`` as an f32 CPU tensor: to a unique temporary file
    beside the target, flushed and synced, then renamed over it, so a
    reader never sees a partial file and concurrent writers never share one."""
    if cache_path is None:
        return
    cache_path = Path(cache_path)
    cache_path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp_name = tempfile.mkstemp(prefix=cache_path.stem + ".", suffix=".tmp",
                                    dir=str(cache_path.parent))
    tmp_path = Path(tmp_name)
    tensor = torch.as_tensor(np.ascontiguousarray(np.asarray(array, dtype=np.float32)))
    try:
        with os.fdopen(fd, "wb") as fh:
            torch.save(tensor, fh)
            fh.flush()
            try:
                os.fsync(fh.fileno())
            except OSError:  # a file system without fsync still gets the atomic rename
                pass
        os.replace(tmp_path, cache_path)
    except BaseException:
        tmp_path.unlink(missing_ok=True)
        raise


def load_tensor_cache(cache_path: Path) -> np.ndarray:
    return torch.load(cache_path, map_location="cpu", weights_only=True).numpy()


# ---------------------------------------------------------------------------
# Batch iteration / output writing
# ---------------------------------------------------------------------------

def iter_batches(dataset, batch_size: int, indices=None):
    """``(indices, samples)`` for consecutive runs of ``batch_size`` of
    ``indices`` (default: every index), read serially."""
    selected = list(range(len(dataset))) if indices is None else list(indices)
    for start in range(0, len(selected), batch_size):
        batch_indices = selected[start:start + batch_size]
        yield batch_indices, [dataset[i] for i in batch_indices]


def save_output_tensor(dataset, row: dict, key: str, tensor, output_root: Path) -> None:
    """Write a model output for ``row``'s ``key`` entry under ``output_root``
    through the dataset's own writer, else as a tensor cache file."""
    entry = row.get(key)
    split_index, split_count = dataset._cache_info(entry, row, key)
    out_path = cache_path_for_entry(dataset.base_path, output_root, entry, split_index, split_count)
    if out_path is None:
        return
    writer = getattr(dataset, "save_output", None)
    if callable(writer):
        writer(row=row, key=key, tensor=tensor, output_root=output_root)
        return
    save_tensor_cache(tensor, out_path)


def to_2d_image(arr: np.ndarray) -> Optional[np.ndarray]:
    """[H,W] / [1,H,W] / [3,H,W] in [0, 1] -> uint8 grayscale, else None."""
    arr = np.asarray(arr, dtype=np.float32)
    if arr.ndim == 2:
        img = arr
    elif arr.ndim == 3 and arr.shape[0] == 1:
        img = arr[0]
    elif arr.ndim == 3 and arr.shape[0] == 3:
        img = arr.mean(axis=0)
    else:
        return None
    return np.round(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
