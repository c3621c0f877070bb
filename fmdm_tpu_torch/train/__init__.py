"""Trainers (counterpart of ``fmdm_tpu/train``): diffusion, flow matching, VAE."""

from fmdm_tpu_torch.train import diffusion_lib, flow_matching_lib

__all__ = ["diffusion_lib", "flow_matching_lib"]
