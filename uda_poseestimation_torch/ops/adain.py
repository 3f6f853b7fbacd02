"""Adaptive instance normalization (AdaIN) statistics.

PyTorch twin of ``calc_mean_std`` and ``adain`` in
``uda_poseestimation_tpu/ops/adain.py`` (reference lib/models/Style_net.py:
4-29): per-(sample, channel) spatial mean and std of NCHW features, with the
*unbiased* variance plus eps under the square root.
"""

from __future__ import annotations

import torch


def calc_mean_std(feat, eps: float = 1e-5):
    """(N, C, H, W) -> mean and std, each (N, C, 1, 1)."""
    n, c = feat.shape[:2]
    x = feat.reshape(n, c, -1)
    mean = x.mean(dim=2)
    var = x.var(dim=2, unbiased=True) + eps
    return mean.reshape(n, c, 1, 1), torch.sqrt(var).reshape(n, c, 1, 1)


def adain(content_feat, style_feat, eps: float = 1e-5):
    """Re-normalize content features to the style features' statistics."""
    style_mean, style_std = calc_mean_std(style_feat, eps)
    content_mean, content_std = calc_mean_std(content_feat, eps)
    normalized = (content_feat - content_mean) / content_std
    return normalized * style_std + style_mean
