"""
Evaluation utilities on numpy arrays (counterpart of the JAX-free functions
of ``fmdm_tpu/utils/evaluation.py``): PSNR, SSIM, image grids, the seeded
pick of visual samples.

SSIM is a numpy implementation of scikit-image's default algorithm (a
uniform 7x7 window, the data range known, sample covariance), which the JAX
package's goldens (``tests/test_ssim_goldens.py``) pin.
"""

from __future__ import annotations

import logging
import random
from pathlib import Path
from typing import Optional

import numpy as np

try:
    from PIL import Image as PILImage
except ImportError:  # pragma: no cover
    PILImage = None


def select_visual_indices(ds, count: int, seed: Optional[int] = None):
    """A seeded pick of ``count`` indices: one per case ("Case" column of a
    dataset's ``data`` rows) where the dataset has cases, else a shuffle."""
    total = len(ds)
    if total <= 0:
        return []
    rng = random.Random(seed)
    indices = []
    if isinstance(getattr(ds, "data", None), list):
        cases = {}
        for idx, row in enumerate(ds.data):
            case_id = row.get("Case") or row.get("case") or row.get("case_id")
            if case_id is not None:
                cases.setdefault(case_id, []).append(idx)
        if cases:
            case_ids = list(cases.keys())
            rng.shuffle(case_ids)
            indices = [rng.choice(cases[case_id]) for case_id in case_ids[:count]]
    if not indices:
        indices = list(range(total))
        rng.shuffle(indices)
        indices = indices[:count]
    return indices


def make_grid(batch: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """(N, C, H, W) in [0,1] -> an HxWx3 uint8 grid."""
    batch = np.asarray(batch, dtype=np.float32)
    n, c, h, w = batch.shape
    if n < rows * cols:
        raise ValueError(f"Need at least {rows*cols} images to build the grid, found {n}")
    batch = batch[: rows * cols]
    if c == 1:
        batch = np.broadcast_to(batch, (rows * cols, 3, h, w))
        c = 3
    batch = np.clip(batch, 0.0, 1.0).reshape(rows, cols, c, h, w)
    grid = np.transpose(batch, (2, 0, 3, 1, 4)).reshape(c, rows * h, cols * w)
    grid_np = np.clip(grid * 255.0, 0, 255).astype(np.uint8)
    return np.transpose(grid_np, (1, 2, 0))


def save_image(array: np.ndarray, path) -> None:
    """Write an image array with PIL, or as ``.npy`` where PIL is missing."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if PILImage is None:
        np.save(path.with_suffix(".npy"), array)
        return
    PILImage.fromarray(array).save(path)
    logging.info("Saved grid: %s", path)


def _uniform_filter(x: np.ndarray, size: int) -> np.ndarray:
    from scipy.ndimage import uniform_filter

    return uniform_filter(x, size=size, mode="reflect")


def ssim(im1: np.ndarray, im2: np.ndarray, data_range: float = 1.0, win_size: int = 7) -> float:
    """skimage.metrics.structural_similarity with its default settings
    (uniform filter, K1=0.01, K2=0.03, sample covariance normalization)."""
    im1 = np.asarray(im1, dtype=np.float64)
    im2 = np.asarray(im2, dtype=np.float64)
    if im1.shape != im2.shape:
        raise ValueError("ssim inputs must share a shape")
    if min(im1.shape) < win_size:
        win_size = max(3, min(im1.shape) // 2 * 2 - 1)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    n_window = win_size ** im1.ndim
    cov_norm = n_window / (n_window - 1)

    ux = _uniform_filter(im1, win_size)
    uy = _uniform_filter(im2, win_size)
    uxx = _uniform_filter(im1 * im1, win_size)
    uyy = _uniform_filter(im2 * im2, win_size)
    uxy = _uniform_filter(im1 * im2, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux**2 + uy**2 + c1) * (vx + vy + c2))
    pad = (win_size - 1) // 2
    crop = tuple(slice(pad, n - pad) for n in s.shape)
    return float(s[crop].mean())


def compute_ssim_sample(pred: np.ndarray, tgt: np.ndarray) -> Optional[float]:
    """SSIM of one sample, the mean over its channels (or of a 2-D image)."""
    pred = np.asarray(pred, dtype=np.float32)
    tgt = np.asarray(tgt, dtype=np.float32)
    if pred.shape != tgt.shape or pred.ndim < 2:
        return None
    if pred.ndim == 2:
        return ssim(pred, tgt, data_range=1.0)
    scores = [ssim(pred[ch], tgt[ch], data_range=1.0)
              for ch in range(pred.shape[0]) if pred[ch].ndim >= 2]
    return float(np.mean(scores)) if scores else None


def psnr_from_mse(mse: float) -> float:
    """PSNR = 10 log10(1 / mse) for a data range of [0, 1]."""
    if mse <= 0:
        return float("inf")
    return float(10.0 * np.log10(1.0 / mse))
