"""
BaseDataset (counterpart of ``fmdm_tpu/data/base.py``): a dataset of rows
read from a tab-separated split file (``train.txt``/``test.txt`` or
``split_file``), samples in the canonical [0, 1] range (``to_image`` /
``from_image``), a mirrored tensor cache (written by one background
thread per dataset and process; ``flush_tensor_cache_writes`` waits for
it), windowed volume entries and an output writer (PNG through Pillow, else
a tensor file).

The split file is read with the ``csv`` module into rows whose cells are
typed as pandas' ``read_csv`` types them in the JAX package, where that can
reach an output (a case column of ``001`` is the integer 1 there and in a
lot name): blank lines are skipped, pandas' missing-value strings are
missing cells, a column is bool, int, float (int with a missing cell) or
str by its non-missing cells, and a row with a missing cell is dropped
(``dropna``). With explicit column names, a first row equal to the names is
a header and is dropped; it still counts for the column types.

Samples are numpy f32 arrays; the sampling modes stack a batch on the host
and move it to the card once.
"""

from __future__ import annotations

import csv
import logging
import os
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from fmdm_tpu_torch.data.dataset_utils import (
    cache_path_for_entry,
    load_tensor_cache,
    save_tensor_cache,
    to_2d_image,
)
from fmdm_tpu_torch.data.io import load, resize_array

try:
    from PIL import Image as PILImage
except ImportError:  # pragma: no cover - optional
    PILImage = None

# pandas' default missing-value strings (read_csv's na_values)
_MISSING = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                      "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
                      "nan", "null"})
_BOOLS = {"True": True, "TRUE": True, "true": True, "False": False, "FALSE": False, "false": False}
_INT = re.compile(r"\s*[+-]?\d+\s*")
_FLOAT = re.compile(r"\s*[+-]?((\d+\.?\d*|\.\d+)([eE][+-]?\d+)?|inf|infinity)\s*", re.IGNORECASE)
# guards the start of a dataset's cache writer; a forked child takes a new
# one, since a thread of the parent may have held it at the fork
_CACHE_WRITER_LOCK = threading.Lock()


def _new_cache_writer_lock() -> None:
    global _CACHE_WRITER_LOCK
    _CACHE_WRITER_LOCK = threading.Lock()


os.register_at_fork(after_in_child=_new_cache_writer_lock)


def _typed_column(cells: Sequence[Optional[str]]) -> list:
    """One column's cells typed as pandas types them (None stays missing)."""
    present = [c for c in cells if c is not None]
    if present and all(c in _BOOLS for c in present):
        convert = _BOOLS.__getitem__
    elif present and all(_INT.fullmatch(c) for c in present):
        # an int column with a missing cell is a float column in pandas
        convert = int if len(present) == len(cells) else float
    elif present and all(_FLOAT.fullmatch(c) for c in present):
        convert = float
    else:
        convert = str
    return [None if c is None else convert(c) for c in cells]


def read_split_rows(path: Path, names: Optional[Sequence[str]] = None) -> List[dict]:
    """The rows of a tab-separated split file as dicts of typed cells, None
    for a missing one. Without ``names`` the first row names the columns."""
    with Path(path).open("r", newline="", encoding="utf-8") as fh:
        raw = [row for row in csv.reader(fh, delimiter="\t") if row]
    if names is None:
        if not raw:
            return []
        names, raw = raw[0], raw[1:]
    names = tuple(names)
    cells = []
    for line, row in enumerate(raw, start=1):
        if len(row) > len(names):
            raise ValueError(f"{path}: row {line} has {len(row)} fields for the "
                             f"{len(names)} columns {names}")
        row = row + [""] * (len(names) - len(row))
        cells.append([None if c in _MISSING else c for c in row])
    columns = [_typed_column(col) for col in zip(*cells)] if cells else [[] for _ in names]
    rows = [dict(zip(names, values)) for values in zip(*columns)]
    # a headed file read with explicit names: its header row is data to pandas
    if rows and tuple(str(v) for v in rows[0].values()) == names:
        rows = rows[1:]
    return rows


def complete_rows(rows: List[dict]) -> List[dict]:
    """The rows with no missing cell (pandas' ``dropna``)."""
    return [row for row in rows if all(v is not None for v in row.values())]


class BaseDataset:
    # __getitem__ is thread-safe: per-call numpy state only, atomic
    # (tmp+os.replace) cache writes, no global-RNG transforms. This opts the
    # whole family into epoch_batches' auto-threaded sample fetch; external
    # dataset classes stay serial unless they declare the same.
    thread_safe_getitem = True

    def __init__(
        self,
        file_path: str,
        train: bool = True,
        img_size=None,
        norm: bool = True,
        img_datatype=np.float32,
        transforms=None,
        conditioning: bool = False,
        id_key: Optional[str] = None,
        target_key: str = "target",
        conditioning_key: Optional[str] = "conditioning",
        split_names: Optional[Tuple[str, ...]] = None,
        split_file=None,
        use_tensor_cache: bool = True,
        save_tensor_cache: bool = False,
        cache_subdir: str = "cache",
        preprocess_kwargs: Optional[dict] = None,
    ):
        self.base_path = Path(file_path)
        self.train = train
        self.split_name = "train" if train else "test"
        self.id_key = id_key
        self.target_key = target_key
        self.conditioning_key = conditioning_key
        self.img_size = self._normalize_img_size(img_size)
        self.norm = bool(norm)
        self.img_datatype = img_datatype
        self.transforms = transforms
        self.conditioning = bool(conditioning)
        self.use_tensor_cache = bool(use_tensor_cache) or bool(save_tensor_cache)
        self.save_tensor_cache = bool(save_tensor_cache)
        self.cache_subdir = cache_subdir
        self.cache_root = self.base_path / self.cache_subdir
        self.preprocess_kwargs = dict(preprocess_kwargs) if preprocess_kwargs else {}
        self.split_file = Path(split_file) if split_file is not None else None

        self.data_root = self.base_path
        self.data = complete_rows(self._read_split_file(self.data_root, names=split_names))
        self.size = len(self.data)
        if self.size == 0:
            raise ValueError("Empty Dataset")
        logging.info("Creating %s dataset with %d examples.", self.split_name.capitalize(), self.size)

    # -- canonical [0,1] contract ---------------------------------------------
    def to_image(self, img: np.ndarray) -> np.ndarray:
        img = np.asarray(img)
        if self.norm:
            if np.issubdtype(img.dtype, np.integer):
                max_val = np.iinfo(img.dtype).max
                if max_val > 0:
                    img = img / max_val
            else:
                img_min = float(np.min(img)) if img.size else 0.0
                img_max = float(np.max(img)) if img.size else 0.0
                if img_max > 1.0 or img_min < 0.0:
                    denom = (img_max - img_min) if img_max != img_min else 1.0
                    img = (img - img_min) / denom
        return np.clip(img, 0.0, 1.0).astype(self.img_datatype)

    def from_image(self, img) -> np.ndarray:
        return np.clip(np.asarray(img), 0.0, 1.0).astype(self.img_datatype)

    @staticmethod
    def _normalize_img_size(img_size):
        if img_size is None:
            return None
        if isinstance(img_size, int):
            return (img_size, img_size)
        return tuple(img_size)

    def __len__(self) -> int:
        return self.size

    def _read_split_file(self, root_path: Path, names=None) -> List[dict]:
        if self.split_file is not None:
            target_file = self.split_file
            if not target_file.is_absolute():
                target_file = root_path / target_file
        else:
            target_file = root_path / ("train.txt" if self.train else "test.txt")
        if not target_file.exists():
            raise FileNotFoundError(f"Annotations file not found: {target_file}")
        return read_split_rows(target_file, names)

    # -- preprocessing --------------------------------------------------------
    def preprocess(self, payload) -> np.ndarray:
        img = np.asarray(payload["Image"] if isinstance(payload, dict) else payload)
        if self.img_size is not None:
            img = resize_array(img, self.img_size)
        return self.to_image(img)

    # -- sample access ---------------------------------------------------------
    def __getitem__(self, idx: int) -> dict:
        row = self.data[idx]
        item_id = row.get(self.id_key) if self.id_key else None
        tgt = self._load_target_tensor(row, item_id)

        img = None
        if self.conditioning:
            if self.conditioning_key is None:
                raise KeyError("Conditioning requested but no conditioning column provided.")
            img = self._load_conditioning_tensor(row, item_id)

        if self.transforms is not None:
            if self.train and not self.conditioning:
                tgt = self.transforms(tgt)
            else:
                img, tgt = self.transforms(img, tgt)
        if img is None:
            img = tgt
        return {
            "image": img,
            "target": tgt,
            "img_id": item_id,
            "img_path": self._resolve_img_path(row.get(self.target_key)),
            "img_size": self.img_size,
        }

    def _load_target_tensor(self, row, item_id):
        return self._load_entry_tensor(row, item_id, self.target_key, preprocess=True)

    def _load_conditioning_tensor(self, row, item_id):
        if self.conditioning_key is None:
            raise KeyError("Conditioning requested but no conditioning column provided.")
        return self._load_entry_tensor(row, item_id, self.conditioning_key, preprocess=True)

    def _load_entry_tensor(self, row, item_id, key: str, preprocess: bool) -> np.ndarray:
        """An entry's f32 array: from the tensor cache when it holds it, else
        loaded (and preprocessed), and then written to the cache under
        ``save_tensor_cache``."""
        entry = row[key]
        split_index, split_count = self._cache_info(entry, row, key)
        cache_path = cache_path_for_entry(self.base_path, self.cache_root, entry, split_index, split_count)
        if self.use_tensor_cache and cache_path is not None and cache_path.exists():
            return np.ascontiguousarray(load_tensor_cache(cache_path), dtype=np.float32)

        payload = self._load_entry(entry, item_id)
        if preprocess:
            try:
                tensor = (self.preprocess(payload, **self.preprocess_kwargs)
                          if self.preprocess_kwargs else self.preprocess(payload))
            except TypeError as exc:
                raise TypeError(f"Invalid preprocess kwargs for {self.__class__.__name__}: "
                                f"{self.preprocess_kwargs}") from exc
        else:
            tensor = payload.get("Image") if isinstance(payload, dict) else payload
        tensor = np.ascontiguousarray(np.asarray(tensor, dtype=np.float32))
        if self.save_tensor_cache and cache_path is not None and not cache_path.exists():
            # off the fetch path: serializing holds the GIL for tens of ms per
            # sample, which would serialize the threaded cold-cache fetches; a
            # dropped write only means the entry is preprocessed again
            self._cache_writer().submit(save_tensor_cache, tensor, cache_path)
        return tensor

    def _cache_writer(self) -> ThreadPoolExecutor:
        """The dataset's one cache-writer thread in this process, started on
        first use (under a lock: the threaded fetches of a cold cache reach
        here together). A forked ``DataLoader`` worker inherits the parent's
        pool without its thread, so it starts its own (joined at its exit)."""
        with _CACHE_WRITER_LOCK:
            pid, writer = getattr(self, "_cache_writer_pool", (None, None))
            if pid != os.getpid():
                writer = ThreadPoolExecutor(max_workers=1, thread_name_prefix="cache-write")
                object.__setattr__(self, "_cache_writer_pool", (os.getpid(), writer))
            return writer

    def flush_tensor_cache_writes(self) -> None:
        """Block until every pending cache write of this process has landed."""
        pid, writer = getattr(self, "_cache_writer_pool", (None, None))
        if pid == os.getpid():
            writer.submit(lambda: None).result()

    @staticmethod
    def _resolve_img_path(entry):
        if isinstance(entry, list):
            return entry[len(entry) // 2]
        if isinstance(entry, dict):
            return entry.get("path")
        return entry

    def _cache_info(self, entry, row, key: Optional[str]):
        return None, 1

    def _resolve_entry_path(self, path):
        """A split-file entry relative to the dataset root."""
        p = Path(str(path))
        return p if p.is_absolute() else self.base_path / p

    def _load_entry(self, entry, item_id):
        if isinstance(entry, list):
            return load([self._resolve_entry_path(p) for p in entry], id=item_id)
        if isinstance(entry, dict):
            payload = load(self._resolve_entry_path(entry["path"]), id=item_id)
            return self._slice_payload(payload, int(entry.get("split_index", 0)),
                                       int(entry.get("window", 1)))
        return load(self._resolve_entry_path(entry), id=item_id)

    # -- output writer -----------------------------------------------------------
    def save_output(self, row: dict, key: str, tensor, output_root: Path) -> None:
        """A 2-D image as a PNG (with Pillow), anything else as a tensor file,
        at the entry's mirrored path under ``output_root``."""
        entry = row.get(key)
        split_index, split_count = self._cache_info(entry, row, key)
        out_path = cache_path_for_entry(self.base_path, output_root, entry, split_index, split_count)
        if out_path is None:
            return
        arr = np.asarray(tensor, dtype=np.float32)
        image2d = to_2d_image(arr)
        if image2d is not None and PILImage is not None:
            png_path = out_path.with_suffix(".png")
            png_path.parent.mkdir(parents=True, exist_ok=True)
            PILImage.fromarray(image2d).save(png_path)
            return
        save_tensor_cache(arr, out_path)

    @staticmethod
    def _slice_payload(payload, start: int, window: int):
        image = payload.get("Image") if isinstance(payload, dict) else None
        if image is None or window <= 0:
            return payload
        sliced = np.asarray(image)[start: start + window].copy()
        return {"Image": sliced, "Metadata": payload.get("Metadata"), "Id": payload.get("Id")}
