"""Batches for the trainers: ``torch.utils.data.DataLoader`` with the JAX
package's collate, and ``ForeverDataIterator`` (reference lib/data.py:40-61).

``default_collate`` gives a batch the structure of the JAX package's
``default_collate`` (``uda_poseestimation_tpu/data/loader.py``): numpy
arrays stack along a new batch axis (as tensors here, in their dtype),
dicts, lists and tuples recurse, numbers become a tensor, strings stay a
list. A list of k teacher views therefore stays a list of k batches, and an
``aug_param`` (6,) array becomes a (B, 6) float32 tensor. torch's own
collate would instead keep lists of tuples as lists of tensors.

``make_loader`` builds the map-style loader the trainers use: ``-j``
worker processes (kept across passes; 0 loads in the calling process),
``drop_last`` for the training sets, and page-locked batches when the device
is CUDA, so the steps' host-to-device copies run asynchronously. torch seeds
``random`` and numpy in each worker from the loader's base seed, so with
``-j > 0`` the per-sample augmentation draws are another stream than the
single-process one (and the JAX package's thread pool's); runs that compare
draws use ``-j 0``. The workers are forked (the default start method on
Linux), so they start with their parent's modules and datasets and import
and unpickle nothing; no worker process touches CUDA.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.data import DataLoader


def default_collate(items):
    first = items[0]
    if isinstance(first, np.ndarray):
        return torch.from_numpy(np.stack(items))
    if isinstance(first, (np.floating, np.integer, float, int, bool)):
        return torch.from_numpy(np.asarray(items))
    if isinstance(first, dict):
        return {k: default_collate([it[k] for it in items]) for k in first}
    if isinstance(first, (list, tuple)) and first and isinstance(
            first[0], (np.ndarray, dict, list, tuple, float, int)):
        transposed = list(zip(*items))
        return type(first)(default_collate(list(group)) for group in transposed)
    return list(items)


def make_loader(dataset, batch_size: int, shuffle: bool = False, num_workers: int = 0,
                drop_last: bool = False, pin_memory: bool = False) -> DataLoader:
    """A DataLoader over ``dataset`` with ``default_collate``."""
    return DataLoader(dataset, batch_size=batch_size, shuffle=shuffle,
                      num_workers=num_workers, drop_last=drop_last,
                      collate_fn=default_collate, pin_memory=pin_memory,
                      persistent_workers=num_workers > 0)


class ForeverDataIterator:
    """Infinite iterator over a loader (lib/data.py:40-61). The loader's
    first pass, and with it its worker processes, starts at the first
    ``next``, so a run that never draws a batch (``--phase test``) starts
    none."""

    def __init__(self, data_loader):
        self.data_loader = data_loader
        self.iter = None

    def __next__(self):
        if self.iter is None:
            self.iter = iter(self.data_loader)
        try:
            return next(self.iter)
        except StopIteration:
            if len(self.data_loader) == 0:
                raise RuntimeError(
                    "ForeverDataIterator wraps an empty loader (dataset "
                    "smaller than batch_size with drop_last=True?)") from None
            self.iter = iter(self.data_loader)
            return next(self.iter)

    def __len__(self):
        return len(self.data_loader)
