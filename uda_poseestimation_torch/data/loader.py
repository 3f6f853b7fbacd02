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

``CachedDataset`` is the decoded-canvas cache of ``--decode-cache`` (the
JAX package's, whose thread workers share one dict). Here the workers are
processes, so the cache lives in shared memory mapped before they fork: an
arena of ``max_bytes`` and a table of each item's place in it, filled under
one lock. An item decoded by any worker is a hit for every worker in the
passes after, and the budget is spent once for the run, not once a worker.
"""

from __future__ import annotations

import mmap
import multiprocessing
import pickle

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


class _U8Canvas:
    """Marker wrapper: a float canvas stored losslessly as uint8 * 255."""

    __slots__ = ("arr",)

    def __init__(self, arr):
        self.arr = arr


def _compress(obj):
    """Image-sized float32 arrays shrink for storage: LOSSLESSLY to uint8
    when exactly on the uint8/255 grid (a PIL-decoded canvas), else to
    float16 (2^-11 rounding, far below the augmentation's noise). Small
    arrays (keypoints, weights) and uint8 canvases stay as they are."""
    if isinstance(obj, np.ndarray):
        if obj.dtype == np.float32 and obj.ndim >= 3:
            q = np.round(obj * 255.0)
            if obj.size and np.max(np.abs(q / 255.0 - obj)) < 1e-6 \
                    and q.min() >= 0 and q.max() <= 255:
                return _U8Canvas(q.astype(np.uint8))
            return obj.astype(np.float16)
        return obj
    if isinstance(obj, dict):
        return {k: _compress(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_compress(v) for v in obj)
    return obj


def _restore(obj):
    if isinstance(obj, _U8Canvas):
        return obj.arr.astype(np.float32) / 255.0
    if isinstance(obj, np.ndarray):
        return obj.astype(np.float32) if obj.dtype == np.float16 else obj
    if isinstance(obj, dict):
        return {k: _restore(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_restore(v) for v in obj)
    return obj


# the counters after the per-item (offset, length) rows of the table
_USED, _HITS, _MISSES, _ITEMS, _FULL, _COUNTERS = range(6)


class CachedDataset:
    """Memoize a dataset's ``__getitem__``: the decoded-canvas cache.

    Training revisits the same frames every epoch, and the host's decode and
    resize dominate the raw-canvas pipeline. ONLY wrap a dataset whose
    transforms are deterministic (the ``--device-aug`` canvases): a cache
    would freeze random host augmentation. The trainer enforces this.

    Items are stored pickled, after ``_compress``, in a shared arena of
    ``max_bytes`` that the loader's forked workers inherit (see the module
    docstring); the first worker to decode an item stores it, every later
    fetch, in any process, reads it back through ``_restore``. When an item
    does not fit, the cache is full: it and every item not yet stored pass
    through uncached, and one line says so. ``hits``, ``misses``,
    ``bytes_used`` and ``items_cached`` count over all processes. The cache
    needs the fork start method: its shared memory cannot be pickled.
    """

    def __init__(self, dataset, max_bytes: float = 2e9):
        self.dataset = dataset
        self.max_bytes = int(max_bytes)
        self._n = len(dataset)
        # anonymous shared mappings: inherited across fork, pages committed
        # only as they are written
        self._arena = mmap.mmap(-1, max(self.max_bytes, 1))
        self._table_map = mmap.mmap(-1, (2 * self._n + _COUNTERS) * 8)
        self._table = np.frombuffer(self._table_map, dtype=np.int64)
        self._lock = multiprocessing.get_context("fork").Lock()

    def __len__(self):
        return self._n

    def __getattr__(self, name):  # num_keypoints, visualize, group_accuracy...
        if name == "dataset":  # not set yet: no recursion
            raise AttributeError(name)
        return getattr(self.dataset, name)

    def _counter(self, which: int) -> int:
        return int(self._table[2 * self._n + which])

    @property
    def hits(self) -> int:
        return self._counter(_HITS)

    @property
    def misses(self) -> int:
        return self._counter(_MISSES)

    @property
    def bytes_used(self) -> int:
        return self._counter(_USED)

    @property
    def items_cached(self) -> int:
        return self._counter(_ITEMS)

    def __getitem__(self, idx):
        t, c = self._table, 2 * self._n
        with self._lock:
            offset, length = int(t[2 * idx]), int(t[2 * idx + 1])
            t[c + (_HITS if length else _MISSES)] += 1
            full = bool(t[c + _FULL])
        if length:
            return _restore(pickle.loads(self._arena[offset:offset + length]))
        item = self.dataset[idx]
        if not full:
            self._store(idx, pickle.dumps(_compress(item), protocol=pickle.HIGHEST_PROTOCOL))
        return item

    def _store(self, idx, blob: bytes):
        t, c = self._table, 2 * self._n
        with self._lock:
            if t[2 * idx + 1] or t[c + _FULL]:
                return
            used = int(t[c + _USED])
            if used + len(blob) > self.max_bytes:
                t[c + _FULL] = 1
                self._log_cap_hit(int(t[c + _ITEMS]), used)
                return
            self._arena[used:used + len(blob)] = blob
            t[2 * idx] = used
            t[2 * idx + 1] = len(blob)
            t[c + _USED] = used + len(blob)
            t[c + _ITEMS] += 1

    def _log_cap_hit(self, items: int, used: int):
        """One visible line, in whichever process fills the budget: without
        it an undersized --decode-cache shows only as a bimodal iteration
        time (cached vs decoded every epoch)."""
        print("CachedDataset: cache budget full after "
              f"{items}/{self._n} items ({used / 1e9:.2f} GB); remaining items will be "
              "decoded every epoch (raise --decode-cache to cache all)", flush=True)
