"""PCK@0.05 keypoint accuracy on tensors.

PyTorch twin of ``keypoint_pck_accuracy`` in
``uda_poseestimation_tpu/ops/pck.py`` (reference lib/keypoint_detection.py:
9-94): argmax decode with maxval>0 masking, distances normalized by
[H, W] / 10, ground-truth keypoints with both coords <= 1 excluded,
per-keypoint accuracy -1 where no sample is valid, and an average over the
keypoints whose accuracy is >= 0.

The host half, ``get_max_preds_np`` and ``accuracy``, is the port's numpy
copy of the JAX package's (reference signature and returns), for host-side
decodes such as the trainers' debug images.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import device_vector
from .heatmap import get_max_preds


def get_max_preds_np(batch_heatmaps: np.ndarray):
    """Vectorized numpy argmax decode: (B, K, H, W) -> preds (B, K, 2)
    (x, y), zeroed where the maximum is not positive, and maxvals (B, K, 1)."""
    assert isinstance(batch_heatmaps, np.ndarray) and batch_heatmaps.ndim == 4
    b, k, h, w = batch_heatmaps.shape
    flat = batch_heatmaps.reshape(b, k, -1)
    idx = np.argmax(flat, axis=2)
    maxvals = np.amax(flat, axis=2).reshape(b, k, 1)
    preds = np.stack([(idx % w).astype(np.float32),
                      np.floor(idx.astype(np.float32) / w)], axis=-1)
    preds *= (maxvals > 0.0).astype(np.float32)
    return preds, maxvals


def _dists_np(preds, target, norm):
    """(B, K, 2) x2 + (B, 2) -> (K, B) normalized distances, -1 where GT<=1."""
    valid = (target[..., 0] > 1) & (target[..., 1] > 1)  # (B, K)
    diff = (preds - target) / norm[:, None, :]
    d = np.linalg.norm(diff, axis=-1)  # (B, K)
    return np.where(valid, d, -1.0).T.astype(np.float32)


def _dist_acc_np(dists_k, thr=0.5):
    cal = dists_k != -1
    n = cal.sum()
    if n > 0:
        return float((dists_k[cal] < thr).sum()) / n
    return -1


def accuracy(output: np.ndarray, target: np.ndarray, hm_type: str = "gaussian",
             thr: float = 0.5):
    """Reference-compatible PCK accuracy (lib/keypoint_detection.py:65-94) on
    (B, K, H, W) numpy heatmaps: (per-keypoint acc (K,), average over the
    valid keypoints, their count, decoded preds (B, K, 2))."""
    if hm_type != "gaussian":
        raise ValueError(f"hm_type {hm_type!r}: the reference defines 'gaussian' only")
    k = output.shape[1]
    pred, _ = get_max_preds_np(output)
    tgt, _ = get_max_preds_np(target)
    h, w = output.shape[2], output.shape[3]
    norm = np.ones((pred.shape[0], 2)) * np.array([h, w]) / 10
    dists = _dists_np(pred, tgt, norm)

    acc = np.zeros(k)
    avg_acc = 0.0
    cnt = 0
    for i in range(k):
        acc[i] = _dist_acc_np(dists[i], thr)
        if acc[i] >= 0:
            avg_acc += acc[i]
            cnt += 1
    avg_acc = avg_acc / cnt if cnt != 0 else 0
    return acc, avg_acc, cnt, pred


def pck_counts(output, target, thr: float = 0.5):
    """(B, K, H, W) heatmaps -> (hits (K,), valid samples (K,), preds
    (B, K, 2)): per keypoint, how many valid samples lie within ``thr`` and
    how many are valid. Counts of several batches (ranks) add up."""
    _, _, h, w = output.shape
    pred, _ = get_max_preds(output)
    tgt, _ = get_max_preds(target)
    norm = device_vector((h, w), output.device) / 10.0
    valid = (tgt[..., 0] > 1) & (tgt[..., 1] > 1)  # (B, K)
    d = torch.linalg.vector_norm((pred - tgt) / norm, dim=-1)  # (B, K)
    hits = ((d < thr) & valid).sum(dim=0).to(torch.float32)
    return hits, valid.sum(dim=0).to(torch.float32), pred


def pck_from_counts(hits, n_valid):
    """(per_kpt (K,), avg, cnt) of ``pck_counts``' counts."""
    per_kpt = torch.where(n_valid > 0, hits / n_valid.clamp(min=1.0), -1.0)
    counted = per_kpt >= 0
    cnt = counted.sum()
    avg = torch.where(cnt > 0,
                      torch.where(counted, per_kpt, 0.0).sum() / cnt.clamp(min=1),
                      0.0)
    return per_kpt, avg, cnt


def keypoint_pck_accuracy(output, target, thr: float = 0.5):
    """(B, K, H, W) heatmaps -> (per_kpt (K,), avg, cnt, preds (B, K, 2))."""
    hits, n_valid, pred = pck_counts(output, target, thr)
    return (*pck_from_counts(hits, n_valid), pred)
