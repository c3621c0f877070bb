"""
Latent-space dataset (counterpart of ``fmdm_tpu/data/latent.py``): rows of
pre-encoded VAE latents (``.npy``) loaded as they are, for a denoiser that
runs wholly in latent space. Latents are roughly unit-normal after scaling,
so the [0, 1] image contract and the HU window of the pixel datasets do not
apply in either direction.

Split files are tab-separated with a header row, ``Case\\ttarget\\tconditioning``
(paths relative to the dataset root).
"""

from __future__ import annotations

import numpy as np

from fmdm_tpu_torch.data.base import BaseDataset


class LatentDataset(BaseDataset):
    """BaseDataset over raw latent tensors: identity pre- and postprocessing."""

    def __init__(self, file_path, train=True, conditioning=False, **kwargs):
        # `conditioning` is a named parameter so the config builder's
        # signature scan passes it: without it the base class serves
        # image := target
        kwargs.setdefault("norm", False)
        kwargs.setdefault("target_key", "target")
        kwargs.setdefault("conditioning_key", "conditioning")
        super().__init__(file_path, train=train, conditioning=conditioning, **kwargs)

    # latents are not images: no resize, no [0, 1] mapping, no clipping
    def preprocess(self, payload) -> np.ndarray:
        img = payload["Image"] if isinstance(payload, dict) else payload
        return np.asarray(img, self.img_datatype)

    def to_image(self, img) -> np.ndarray:
        return np.asarray(img, self.img_datatype)

    def from_image(self, img) -> np.ndarray:
        return np.asarray(img, self.img_datatype)


def dataset_from_config(training_cfg: dict, train: bool = True, **overrides):
    """Config factory (a ``dataset.json`` ``dataset_class`` entry point)."""
    kwargs = dict(
        file_path=training_cfg.get("data_root", "."),
        train=train,
        use_tensor_cache=bool(training_cfg.get("use_tensor_cache", False)),
        save_tensor_cache=bool(training_cfg.get("save_tensor_cache", False)),
    )
    kwargs.update(overrides)
    return LatentDataset(**kwargs)
