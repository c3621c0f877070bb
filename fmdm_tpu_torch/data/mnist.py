"""
MNIST (counterpart of ``fmdm_tpu/data/mnist.py``): samples
``{target, image, label, img_id, img_size}`` with target == image, the
digit resized to ``img_size`` in [0, 1]. It reads the IDX files (raw or
gzipped) or a keras-style ``mnist.npz`` under the root and downloads
nothing: without them it serves a deterministic synthetic digit-like set
(4096 train, 512 test images).
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from fmdm_tpu_torch.data.dataset_utils import cache_path_for_entry, save_tensor_cache, to_2d_image
from fmdm_tpu_torch.data.io import resize_array

try:
    from PIL import Image as PILImage
except ImportError:  # pragma: no cover - optional
    PILImage = None


def _read_idx(path: Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as fh:
        ndim = struct.unpack(">I", fh.read(4))[0] & 0xFF
        shape = struct.unpack(">" + "I" * ndim, fh.read(4 * ndim))
        data = np.frombuffer(fh.read(), dtype=np.uint8)
    return data.reshape(shape)


def _find_idx(root: Path, stem: str) -> Optional[Path]:
    for folder in (root / "MNIST" / "raw", root / "raw", root):
        for name in (stem, stem + ".gz"):
            if (folder / name).exists():
                return folder / name
    return None


def _find_npz_under(root: Path) -> Optional[Path]:
    for candidate in (root / "mnist.npz", root / "MNIST" / "mnist.npz",
                      root / "MNIST" / "raw" / "mnist.npz"):
        if candidate.exists():
            return candidate
    return None


def _synthetic_digits(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic digit-like 28x28 images in [0, 1]: a ring and a bar per
    class, oriented and sized by the label."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n).astype(np.int64)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32) / 27.0
    images = np.zeros((n, 28, 28), dtype=np.float32)
    for i in range(n):
        d = labels[i]
        cx, cy = 0.5 + 0.08 * rng.randn(), 0.5 + 0.08 * rng.randn()
        angle = d * np.pi / 10.0
        u = (xx - cx) * np.cos(angle) + (yy - cy) * np.sin(angle)
        v = -(xx - cx) * np.sin(angle) + (yy - cy) * np.cos(angle)
        ring = np.exp(-((np.sqrt(u**2 + (1.6 * v) ** 2) - 0.22 - 0.015 * d) ** 2) / 0.004)
        bar = np.exp(-(u**2) / 0.004) * (np.abs(v) < (0.12 + 0.02 * d))
        img = ring if d % 2 == 0 else 0.3 * ring + bar
        img = img / max(img.max(), 1e-6)
        images[i] = img.astype(np.float32)
    return images, labels


class MNISTDataset:
    def __init__(self, root: str, train: bool = True, img_size: int = 32, download: bool = True) -> None:
        self.root = Path(root)
        self.train = train
        self.img_size = img_size

        split = "train" if train else "test"
        img_path = _find_idx(self.root, "train-images-idx3-ubyte" if train else "t10k-images-idx3-ubyte")
        lbl_path = _find_idx(self.root, "train-labels-idx1-ubyte" if train else "t10k-labels-idx1-ubyte")
        npz_path = _find_npz_under(self.root)
        if img_path is not None and lbl_path is not None:
            self.images = _read_idx(img_path)
            self.labels = _read_idx(lbl_path).astype(np.int64)
            self.synthetic = False
        elif npz_path is not None:
            with np.load(npz_path) as payload:
                self.images = np.asarray(payload[f"x_{split}"], np.uint8)
                self.labels = np.asarray(payload[f"y_{split}"], np.int64)
            self.synthetic = False
        else:
            images, self.labels = _synthetic_digits(4096 if train else 512, seed=0 if train else 1)
            self.images = (images * 255).astype(np.uint8)
            self.synthetic = True

        # the row and writer surface that run_model --save needs
        self.base_path = self.root
        self.target_key = "target"
        self.conditioning_key = None
        self.data = [{"target": f"{split}/{split}_{i}.png", "Case": None}
                     for i in range(len(self.images))]

    def _cache_info(self, entry, row, key):
        return None, 1

    def save_output(self, row, key, tensor, output_root):
        """A digit as a PNG (with Pillow), else as a tensor file."""
        out_path = cache_path_for_entry(self.base_path, output_root, row.get(key))
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

    def __len__(self) -> int:
        return len(self.images)

    def to_image(self, image):
        return np.asarray(image, dtype=np.float32) / 255.0

    def from_image(self, image):
        return np.clip(np.asarray(image), 0.0, 1.0) * 255.0

    def __getitem__(self, idx: int) -> dict:
        image = np.asarray(self.images[idx], dtype=np.float32)
        if (self.img_size, self.img_size) != image.shape:
            image = resize_array(image, (self.img_size, self.img_size))
        image = (image / 255.0).astype(np.float32)[None, :, :]  # (1, H, W)
        return {
            "target": image,
            "image": image,
            "label": int(self.labels[idx]),
            "img_id": f"{'train' if self.train else 'test'}_{idx}",
            "img_size": (self.img_size, self.img_size),
        }
