"""
File loaders (counterpart of ``fmdm_tpu/data/io.py``): DICOM (needs
pydicom), ``.npy`` (memory-mapped), ``.npz``, torch ``.pt``/``.pth`` and
images through Pillow, into the payload ``{"Image", "Metadata", "Id"}``;
directories and lists load as one stack sorted by file name.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

try:
    import pydicom
except ImportError:  # pragma: no cover - optional
    pydicom = None

try:
    from PIL import Image as PILImage
except ImportError:  # pragma: no cover - optional
    PILImage = None


def load_image(path, id=None) -> Dict[str, Any]:
    """One file as ``{"Image": ndarray, "Metadata": dict or None, "Id": id}``."""
    path = Path(path)
    suffix = path.suffix.lower()
    metadata: Optional[dict] = None
    if suffix in (".dcm", ".ima", ".dicom"):
        if pydicom is None:
            raise RuntimeError("DICOM support requires pydicom (not installed).")
        ds = pydicom.dcmread(str(path))
        image = ds.pixel_array
        # only the rescale tags present: LDCT's preprocess falls back to slope
        # 1 and intercept -1024 for an absent tag
        metadata = {
            "PixelSpacing": list(getattr(ds, "PixelSpacing", []) or []),
            "SliceThickness": getattr(ds, "SliceThickness", None),
        }
        for tag in ("RescaleSlope", "RescaleIntercept"):
            value = getattr(ds, tag, None)
            if value is not None:
                metadata[tag] = float(value)
    elif suffix == ".npy":
        # memory-mapped: a window of slices reads only its own bytes
        image = np.load(str(path), mmap_mode="r")
    elif suffix == ".npz":
        with np.load(str(path)) as payload:
            image = payload[payload.files[0]]
    elif suffix in (".pt", ".pth"):
        tensor = torch.load(str(path), map_location="cpu", weights_only=True)
        image = tensor.numpy() if isinstance(tensor, torch.Tensor) else np.asarray(tensor)
    else:
        if PILImage is None:
            raise RuntimeError("Image loading requires Pillow.")
        with PILImage.open(str(path)) as im:
            image = np.asarray(im)
    return {"Image": image, "Metadata": metadata, "Id": id}


def load_composite(paths: List, id=None, num_workers: Optional[int] = None) -> Dict[str, Any]:
    """A list of files as one stacked volume, sorted by file name; eight or
    more files decode on a thread pool (numpy, Pillow and pydicom release
    the interpreter lock while they decode)."""
    paths = sorted(str(p) for p in paths)
    if num_workers is None:
        num_workers = min(8, os.cpu_count() or 1) if len(paths) >= 8 else 0
    if num_workers and num_workers > 1 and len(paths) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=num_workers, thread_name_prefix="composite") as pool:
            payloads = list(pool.map(lambda p: load_image(p, id=id), paths))
    else:
        payloads = [load_image(p, id=id) for p in paths]
    stacked = np.stack([np.asarray(p["Image"]) for p in payloads], axis=0)
    return {"Image": stacked, "Metadata": payloads[0].get("Metadata"), "Id": id}


def load(entry, id=None) -> Dict[str, Any]:
    """A file path -> :func:`load_image`; a directory or a list -> a sorted
    composite."""
    if isinstance(entry, (list, tuple)):
        return load_composite(list(entry), id=id)
    path = Path(str(entry))
    if path.is_dir():
        return load_composite(sorted(p for p in path.iterdir() if p.is_file()), id=id)
    return load_image(path, id=id)


def resize_array(img: np.ndarray, size, preserve_range: bool = True) -> np.ndarray:
    """Linear resize (scipy ``zoom``, order 1) of the trailing ``len(size)``
    dims, in f32; unchanged when the sizes already match."""
    from scipy.ndimage import zoom

    img = np.asarray(img, dtype=np.float32)
    size = tuple(size)
    nd = len(size)
    if img.ndim < nd:
        raise ValueError(f"Cannot resize {img.shape} to {size}")
    factors = [1.0] * (img.ndim - nd) + [size[i] / img.shape[img.ndim - nd + i] for i in range(nd)]
    if all(abs(f - 1.0) < 1e-9 for f in factors):
        return img
    return zoom(img, factors, order=1)
