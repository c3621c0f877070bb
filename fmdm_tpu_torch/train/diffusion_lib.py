"""DDPM diffusion trainer (counterpart of ``fmdm_tpu/train/diffusion_lib.py``)."""

from fmdm_tpu_torch.train.denoise_lib import debug_visual_only as _debug, train as _train


def train(dataset, json_path, val_dataset=None, resume=None, **kwargs):
    return _train(dataset, json_path, val_dataset=val_dataset, resume=resume,
                  variant="diffusion", **kwargs)


def debug_visual_only(dataset, json_path, ckpt_path, **kwargs):
    return _debug(dataset, json_path, ckpt_path, variant="diffusion", **kwargs)
