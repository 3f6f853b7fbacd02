"""Sampler and dataset-combination utilities (reference lib/data.py:64-179).

The port's copy of ``uda_poseestimation_tpu/data/samplers.py``. No trainer
calls these; the registry exports them as the JAX package's does.
``RandomMultipleGallerySampler`` draws from the global ``np.random`` and
``random`` streams in the JAX package's order; ``concatenate`` joins numpy
arrays, tensors, lists and dicts of them along the batch axis.
"""

from __future__ import annotations

import itertools
import random
from typing import Dict, Iterable, List

import numpy as np
import torch
from torch.utils.data import Dataset


class RandomMultipleGallerySampler:
    """K-instances-per-identity sampler (lib/data.py:64-138)."""

    def __init__(self, dataset, num_instances: int = 4):
        self.dataset = dataset
        self.num_instances = num_instances

        self.idx_to_pid = {}
        self.cid_list_per_pid: Dict = {}
        self.idx_list_per_pid: Dict = {}
        for idx, (_, pid, cid) in enumerate(dataset):
            if pid not in self.cid_list_per_pid:
                self.cid_list_per_pid[pid] = []
                self.idx_list_per_pid[pid] = []
            self.idx_to_pid[idx] = pid
            self.cid_list_per_pid[pid].append(cid)
            self.idx_list_per_pid[pid].append(idx)
        self.pid_list = list(self.idx_list_per_pid.keys())
        self.num_samples = len(self.pid_list)

    def __len__(self):
        return self.num_samples * self.num_instances

    def __iter__(self):
        def select_idxes(element_list, target_element):
            return [i for i, element in enumerate(element_list)
                    if element != target_element]

        pid_idxes = np.random.permutation(len(self.pid_list)).tolist()
        final_idxes: List[int] = []
        for perm_id in pid_idxes:
            i = random.choice(self.idx_list_per_pid[self.pid_list[perm_id]])
            _, _, cid = self.dataset[i]
            final_idxes.append(i)

            pid_i = self.idx_to_pid[i]
            cid_list = self.cid_list_per_pid[pid_i]
            idx_list = self.idx_list_per_pid[pid_i]
            selected_cid_list = select_idxes(cid_list, cid)
            if selected_cid_list:
                replace = len(selected_cid_list) < self.num_instances
                cid_idxes = np.random.choice(selected_cid_list,
                                             size=self.num_instances - 1,
                                             replace=replace)
                final_idxes.extend(idx_list[c] for c in cid_idxes)
            else:
                selected_idxes = select_idxes(idx_list, i)
                if not selected_idxes:
                    continue
                replace = len(selected_idxes) < self.num_instances
                picked = np.random.choice(selected_idxes,
                                          size=self.num_instances - 1,
                                          replace=replace)
                final_idxes.extend(idx_list[p] for p in picked)
        return iter(final_idxes)


class CombineDataset(Dataset):
    """Element-wise splice of multiple datasets (lib/data.py:141-161)."""

    def __init__(self, datasets: Iterable) -> None:
        datasets = list(datasets)
        assert len(datasets) > 0, "datasets should not be an empty iterable"
        self.datasets = datasets

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        return list(itertools.chain(*[d[idx] for d in self.datasets]))


def concatenate(tensors):
    """Concatenate batches of arrays / lists / dicts (lib/data.py:164-179)."""
    first = tensors[0]
    if isinstance(first, np.ndarray):
        return np.concatenate(tensors, axis=0)
    if isinstance(first, List):
        return [concatenate([t[i] for t in tensors]) for i in range(len(first))]
    if isinstance(first, Dict):
        return {k: concatenate([t[k] for t in tensors]) for k in first.keys()}
    if isinstance(first, torch.Tensor):
        return torch.cat(tensors, dim=0)
    raise TypeError(f"cannot concatenate {type(first)}")
