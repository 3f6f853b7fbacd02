"""Keypoint losses on NCHW (B, K, H, W) heatmaps.

PyTorch twin of ``joints_mse_loss`` and ``cons_loss`` in
``uda_poseestimation_tpu/models/loss.py`` (reference lib/models/loss.py):

- ``joints_mse_loss``: elementwise 0.5*MSE with per-joint weights broadcast
  as (B, K, 1); 'mean' averages over B*K*HW (the weights do not renormalize),
  'none' returns (B, K);
- ``cons_loss``: the difference times ``tea_mask`` (B, K) broadcast over
  pixels, squared, averaged over channels and then over everything.
"""

from __future__ import annotations

import torch


def joints_mse_loss(output, target, target_weight=None, reduction: str = "mean"):
    b, k = output.shape[:2]
    pred = output.reshape(b, k, -1)
    gt = target.reshape(b, k, -1)
    loss = 0.5 * (pred - gt) ** 2
    if target_weight is not None:
        loss = loss * target_weight.reshape(b, k, 1)
    if reduction == "mean":
        return loss.mean()
    return loss.mean(dim=-1)


def cons_loss(stu_out, tea_out, valid_mask=None, tea_mask=None):
    diff = stu_out - tea_out
    if tea_mask is not None:
        diff = diff * tea_mask[:, :, None, None].to(diff.dtype)
    loss_map = torch.mean(diff ** 2, dim=1)  # (B, H, W)
    if valid_mask is not None:
        denom = max(int(valid_mask.sum()) * loss_map.shape[-1] * loss_map.shape[-2], 1)
        return torch.where(valid_mask[:, None, None], loss_map, 0.0).sum() / denom
    return loss_map.mean()
