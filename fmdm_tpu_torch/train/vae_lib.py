"""VAE trainer (counterpart of ``fmdm_tpu/train/vae_lib.py``): the import
surface of the CLI's dispatch."""

from fmdm_tpu_torch.train.vae_impl import debug_visual_only, train  # noqa: F401
