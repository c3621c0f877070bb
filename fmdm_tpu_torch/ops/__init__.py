"""Tensor primitives (counterpart of ``fmdm_tpu/ops``)."""

from fmdm_tpu_torch.ops.attention import linear_attention, sdpa, sdpa_xla
from fmdm_tpu_torch.ops.conv import conv_nd, conv_transpose_nd
from fmdm_tpu_torch.ops.norm import group_norm, layer_norm, rms_norm_nd, safe_num_groups
from fmdm_tpu_torch.ops.resample import avg_pool_nd, max_pool_nd, resize_bilinear, upsample_nearest
from fmdm_tpu_torch.ops.time_embed import timestep_embedding

__all__ = [
    "conv_nd",
    "conv_transpose_nd",
    "group_norm",
    "rms_norm_nd",
    "layer_norm",
    "safe_num_groups",
    "upsample_nearest",
    "avg_pool_nd",
    "max_pool_nd",
    "resize_bilinear",
    "timestep_embedding",
    "sdpa",
    "sdpa_xla",
    "linear_attention",
]
