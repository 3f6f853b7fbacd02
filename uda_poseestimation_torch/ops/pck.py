"""PCK@0.05 keypoint accuracy on tensors.

PyTorch twin of ``keypoint_pck_accuracy`` in
``uda_poseestimation_tpu/ops/pck.py`` (reference lib/keypoint_detection.py:
9-94): argmax decode with maxval>0 masking, distances normalized by
[H, W] / 10, ground-truth keypoints with both coords <= 1 excluded,
per-keypoint accuracy -1 where no sample is valid, and an average over the
keypoints whose accuracy is >= 0.
"""

from __future__ import annotations

import torch

from .heatmap import get_max_preds


def keypoint_pck_accuracy(output, target, thr: float = 0.5):
    """(B, K, H, W) heatmaps -> (per_kpt (K,), avg, cnt, preds (B, K, 2))."""
    _, _, h, w = output.shape
    pred, _ = get_max_preds(output)
    tgt, _ = get_max_preds(target)
    norm = torch.tensor([h, w], dtype=torch.float32, device=output.device) / 10.0
    valid = (tgt[..., 0] > 1) & (tgt[..., 1] > 1)  # (B, K)
    d = torch.linalg.vector_norm((pred - tgt) / norm, dim=-1)  # (B, K)
    hits = ((d < thr) & valid).sum(dim=0).to(torch.float32)
    n_valid = valid.sum(dim=0).to(torch.float32)
    per_kpt = torch.where(n_valid > 0, hits / n_valid.clamp(min=1.0), -1.0)
    counted = per_kpt >= 0
    cnt = counted.sum()
    avg = torch.where(cnt > 0,
                      torch.where(counted, per_kpt, 0.0).sum() / cnt.clamp(min=1),
                      0.0)
    return per_kpt, avg, cnt, pred
