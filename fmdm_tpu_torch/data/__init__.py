"""Data layer (counterpart of ``fmdm_tpu/data``): numpy datasets and the
config-driven builders, read serially by the sampling modes."""

from fmdm_tpu_torch.data.base import BaseDataset
from fmdm_tpu_torch.data.mnist import MNISTDataset
from fmdm_tpu_torch.data.dataset_utils import (
    build_dataset_from_config,
    build_train_val_datasets,
    cache_path_for_entry,
    consecutive_paths,
    iter_batches,
    load_tensor_cache,
    resolve_entry,
    save_output_tensor,
    save_tensor_cache,
    split_volume_entry,
    to_2d_image,
)
