"""Adaptive instance normalization (AdaIN) statistics and Gram matrices.

PyTorch twin of ``calc_mean_std``, ``adain`` and ``gram_matrix`` in
``uda_poseestimation_tpu/ops/adain.py`` (reference lib/models/Style_net.py:
4-29): per-(sample, channel) spatial mean and std of NCHW features, with the
*unbiased* variance plus eps under the square root; Gram matrices divided
by C*H*W.
"""

from __future__ import annotations

import torch

from ..device import full_f32


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


class _Gram(torch.autograd.Function):
    """``x @ x^T / scale`` over (N, C, L), forward and backward in full
    float32."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.save_for_backward(x)
        ctx.scale = scale
        with full_f32(x.device):
            return torch.bmm(x, x.transpose(1, 2)) / scale

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        with full_f32(x.device):
            return torch.bmm(grad + grad.transpose(1, 2), x) / ctx.scale, None


def gram_matrix(feat):
    """(N, C, H, W) -> (N, C, C) Gram matrices divided by C*H*W. The JAX
    package keeps this contraction in full float32 (the style loss is
    parity-critical), so TF32 is off for it and for its gradient whatever
    the caller set."""
    n, c, h, w = feat.shape
    return _Gram.apply(feat.reshape(n, c, h * w), c * h * w)
