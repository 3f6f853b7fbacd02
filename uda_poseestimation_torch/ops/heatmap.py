"""Batched Gaussian-heatmap ops: target generation, argmax decode, rectify.

PyTorch twin of ``uda_poseestimation_tpu/ops/heatmap.py``, with the same
reference quirks kept for bit parity: python-``int()`` truncation of the
window bounds and centers, the 3*sigma paste window, and ``rectify``'s
swapped h/w bounds check and clip (reference utils.py:89,101-105).
"""

from __future__ import annotations

import torch


def _center_grid(height: int, width: int, device=None):
    ys = torch.arange(height, device=device, dtype=torch.int32).to(torch.float32)
    xs = torch.arange(width, device=device, dtype=torch.int32).to(torch.float32)
    ys, xs = torch.meshgrid(ys, xs, indexing="ij")
    return ys, xs


def render_gaussian(mu_x, mu_y, sigma: float, heatmap_size, clip_xy=None):
    """Unit-peak Gaussians centered at integer coords (mu_x, mu_y), shape
    (..., H, W), with the reference renderers' patch math: ``ul = int(mu -
    3σ)``, ``br = int(mu + 3σ + 1)``, peak at ``ul + (2*3σ+1)//2``, pasted
    over ``[max(0, ul), min(br, bound))``. ``clip_xy`` overrides the
    (x, y) clip bounds (rectify's swapped quirk). ``heatmap_size`` is (W, H).
    """
    w, h = int(heatmap_size[0]), int(heatmap_size[1])
    tmp_size = 3.0 * sigma
    x0 = float((2.0 * tmp_size + 1.0) // 2)
    ys, xs = _center_grid(h, w, mu_x.device)
    mu_x = mu_x[..., None, None]
    mu_y = mu_y[..., None, None]
    ul_x = torch.trunc(mu_x - tmp_size)  # python int(): trunc toward zero
    ul_y = torch.trunc(mu_y - tmp_size)
    dx = xs - (ul_x + x0)
    dy = ys - (ul_y + x0)
    g = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
    br_x = torch.trunc(mu_x + tmp_size + 1.0)
    br_y = torch.trunc(mu_y + tmp_size + 1.0)
    clip_x, clip_y = clip_xy if clip_xy is not None else (w, h)
    inside = ((xs >= ul_x) & (xs < torch.clamp(br_x, max=clip_x))
              & (ys >= ul_y) & (ys < torch.clamp(br_y, max=clip_y)))
    return torch.where(inside, g, 0.0).to(torch.float32)


def generate_target_batch(keypoints, visible, heatmap_size, sigma: float,
                          image_size):
    """Gaussian heatmap targets (reference lib/datasets/util.py:12-70).

    keypoints (B, K, 2) (x, y) at image scale and visibility (B, K) ->
    target (B, K, H, W) and weight (B, K, 1), both float32. The center is
    ``trunc(kp / stride + 0.5)``; the weight is zeroed where the center
    falls outside the map, and only weights > 0.5 render a Gaussian.
    """
    w, h = int(heatmap_size[0]), int(heatmap_size[1])
    keypoints = torch.as_tensor(keypoints, dtype=torch.float32)
    visible = torch.as_tensor(visible, dtype=torch.float32,
                              device=keypoints.device)
    visible = visible.reshape(keypoints.shape[:-1])
    stride_x = float(image_size[0]) / float(w)
    stride_y = float(image_size[1]) / float(h)
    mu_x = torch.trunc(keypoints[..., 0] / stride_x + 0.5)
    mu_y = torch.trunc(keypoints[..., 1] / stride_y + 0.5)
    in_bounds = (mu_x >= 0) & (mu_x < w) & (mu_y >= 0) & (mu_y < h)
    weight = torch.where(in_bounds, visible, 0.0)
    g = render_gaussian(mu_x, mu_y, sigma, (w, h))
    target = torch.where((weight > 0.5)[..., None, None], g, 0.0)
    return target, weight[..., None]


def generate_target(keypoints, visible, heatmap_size, sigma: float, image_size):
    """Single-sample ``generate_target_batch``: (K, 2), (K,) -> (K, H, W),
    (K, 1)."""
    keypoints = torch.as_tensor(keypoints, dtype=torch.float32)
    visible = torch.as_tensor(visible, dtype=torch.float32,
                              device=keypoints.device).reshape(1, -1)
    target, weight = generate_target_batch(keypoints[None], visible,
                                           heatmap_size, sigma, image_size)
    return target[0], weight[0]


def get_max_preds(heatmaps):
    """Argmax decode of (B, K, H, W) heatmaps (reference utils.py:54-75).

    Returns preds (B, K, 2) float32 (x, y), zeroed where maxval <= 0, and
    maxvals (B, K, 1).
    """
    b, k, h, w = heatmaps.shape
    flat = heatmaps.reshape(b, k, h * w)
    # argmax returns the first maximum, as jnp.argmax does
    idx = flat.argmax(dim=2)
    maxvals = flat.amax(dim=2)
    px = (idx % w).to(torch.float32)
    py = torch.floor(idx.to(torch.float32) / w)
    preds = torch.stack([px, py], dim=-1)
    preds = preds * (maxvals > 0.0).to(torch.float32)[..., None]
    return preds, maxvals[..., None]


def rectify(heatmaps, sigma: float):
    """Replace every channel with a unit-peak Gaussian at its argmax
    (reference utils.py:77-109), keeping the swapped h/w bounds check and
    paste-window clip."""
    b, k, h, w = heatmaps.shape
    preds, _ = get_max_preds(heatmaps)
    mu_x = preds[..., 0]
    mu_y = preds[..., 1]
    ok = (mu_x >= 0) & (mu_x < h) & (mu_y >= 0) & (mu_y < w)
    g = render_gaussian(mu_x, mu_y, sigma, (w, h), clip_xy=(h, w))
    return torch.where(ok[..., None, None], g, 0.0).to(torch.float32)
