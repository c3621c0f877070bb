"""
The worker-process input pipeline of ``training.data_loader: "grain"``
(counterpart of ``fmdm_tpu/data/grain_pipeline.py``), built on
``torch.utils.data.DataLoader``; the card's machine has no ``grain``.

Batches keep the contract of :func:`fmdm_tpu_torch.train.common.epoch_batches`
bit for bit, so a trainer switches with the one config key: static-size
``{"target", "image", "valid"}`` batches, the final partial batch
edge-padded (its last sample repeated) with ``valid`` 0 on the padding rows.
The sample order is ``epoch_batches``' own (:func:`epoch_order`: the same
``RandomState(seed * 100003 + epoch)`` permutation and process striding),
not grain's ``IndexSampler`` order; the JAX package's two loaders already
differ in order.

``num_workers`` worker processes fetch the samples (the ``dataset[i]``
calls: DICOM reads, HU windowing, resizing), a batch's indices at a time;
stacking and padding stay on the consumer's thread through the shared
``_finalize``. The workers fork from the training process, which may hold
a CUDA context: they touch no CUDA tensor and no CUDA generator, only the
dataset's numpy reads. With ``pin_memory`` the finished batch's arrays come
back as page-locked CPU tensors, so the copy to the card runs
asynchronously.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset

from fmdm_tpu_torch.train.common import _finalize, epoch_order


class _Samples(Dataset):
    """A map-style view of any ``__len__``/``__getitem__`` dataset."""

    def __init__(self, dataset):
        self._dataset = dataset

    def __len__(self) -> int:
        return len(self._dataset)

    def __getitem__(self, index: int):
        return self._dataset[int(index)]


def _as_list(samples):
    """The DataLoader's collate: a batch's sample dicts as they are."""
    return list(samples)


def grain_epoch_batches(
    dataset,
    batch_size: int,
    *,
    shuffle: bool,
    seed: int,
    epoch: int,
    pad_to_full: bool = True,
    process_index: int = 0,
    process_count: int = 1,
    num_workers: int = 0,
    pin_memory: bool = False,
) -> Iterator[Dict[str, Optional[np.ndarray]]]:
    """Yield one epoch's batches through a ``DataLoader`` with
    ``num_workers`` worker processes (0 = in this process)."""
    order = epoch_order(len(dataset), shuffle=shuffle, seed=seed, epoch=epoch,
                        process_index=process_index, process_count=process_count)
    chunks = [order[start:start + batch_size].tolist()
              for start in range(0, len(order), batch_size)]
    workers = max(0, int(num_workers))
    loader = DataLoader(
        _Samples(dataset),
        batch_sampler=chunks,
        num_workers=workers,
        collate_fn=_as_list,
        # the workers' base seed is drawn from this generator, never from
        # torch's global one
        generator=torch.Generator().manual_seed((int(seed) or 0) * 100003 + int(epoch)),
    )
    for samples in loader:
        batch = _finalize(samples, batch_size, pad_to_full)
        if pin_memory:
            batch = {k: None if v is None else torch.from_numpy(v).pin_memory()
                     for k, v in batch.items()}
        yield batch
