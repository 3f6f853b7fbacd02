"""Batched affine warps with torchvision-exact sampling.

PyTorch twin of ``uda_poseestimation_tpu/ops/affine.py``: the exact nearest
chain the train step runs, ``warp_affine`` in nearest and bilinear modes and
``affine_keypoints`` (the on-device augmentation's, ``ops/device_aug.py``).
The conventions are the same:

- ``inverse_affine_coeffs`` gives the six output->input coefficients of
  torchvision's ``_get_inverse_affine_matrix`` with center (0, 0);
- output pixel (i, j) maps through centered coords x_c = j - (W-1)/2,
  y_c = i - (H-1)/2 to (m0*x_c + m1*y_c + m2 + (W-1)/2, m3*x_c + m4*y_c + m5 +
  (H-1)/2), evaluated in exactly that order so the float results, and so the
  rounded indices, are bit-equal to the JAX package's;
- nearest rounds half to even (``torch.round``, as ``jnp.round``);
  out-of-bounds samples are zero-filled; bilinear zero-pads its four
  corners like ``grid_sample``;
- a rounded coordinate becomes an int32 as XLA's and CUDA's conversions
  make it: NaN gives 0, values beyond int32 saturate (``_to_int32``).

Every stage of a warp chain rounds and clips on its own, so three chained
nearest warps compose into one gather (``compose_nearest_indices``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def rss_coeffs(angle_deg, shear_x_deg, shear_y_deg):
    """Forward rotation-shear coefficients (a, b, c, d) of torchvision's RSS
    decomposition (lib/transforms/keypoint_detection.py:147-150)."""
    rot = torch.deg2rad(angle_deg)
    sx = torch.deg2rad(shear_x_deg)
    sy = torch.deg2rad(shear_y_deg)
    a = torch.cos(rot - sy) / torch.cos(sy)
    b = -torch.cos(rot - sy) * torch.tan(sx) / torch.cos(sy) - torch.sin(rot)
    c = torch.sin(rot - sy) / torch.cos(sy)
    d = -torch.sin(rot - sy) * torch.tan(sx) / torch.cos(sy) + torch.cos(rot)
    return a, b, c, d


def inverse_affine_coeffs(angle_deg, trans_x, trans_y, shear_x_deg, shear_y_deg,
                          scale, center=(0.0, 0.0)):
    """The six output->input coefficients of torchvision's inverse affine,
    shape (..., 6). Arguments are equal-shape float32 tensors."""
    a, b, c, d = rss_coeffs(angle_deg, shear_x_deg, shear_y_deg)
    inv_scale = 1.0 / scale
    m0 = d * inv_scale
    m1 = -b * inv_scale
    m3 = -c * inv_scale
    m4 = a * inv_scale
    cx, cy = center
    # inverse of T(center) @ T(translate) @ RSS @ T(-center)
    m2 = m0 * (-cx - trans_x) + m1 * (-cy - trans_y) + cx
    m5 = m3 * (-cx - trans_x) + m4 * (-cy - trans_y) + cy
    return torch.stack(torch.broadcast_tensors(m0, m1, m2, m3, m4, m5), dim=-1)


def compose_inverse_coeffs(first, second):
    """Output->input map of warping by ``first`` then by ``second``:
    invA ∘ invB, both given as (..., 6) coefficient tensors."""
    a0, a1, a2, a3, a4, a5 = first.unbind(-1)
    b0, b1, b2, b3, b4, b5 = second.unbind(-1)
    c0 = a0 * b0 + a1 * b3
    c1 = a0 * b1 + a1 * b4
    c2 = a0 * b2 + a1 * b5 + a2
    c3 = a3 * b0 + a4 * b3
    c4 = a3 * b1 + a4 * b4
    c5 = a3 * b2 + a4 * b5 + a5
    return torch.stack([c0, c1, c2, c3, c4, c5], dim=-1)


def chain_coeffs(angle, tx, ty, shx, shy, scale):
    """Inverse coeffs of the trainer's 3-step chain (train_human.py:366-368):
    translate, then rotate+scale, then shear. Returns three (B, 6) tensors."""
    zero = torch.zeros_like(angle)
    one = torch.ones_like(zero)
    c1 = inverse_affine_coeffs(zero, tx, ty, zero, zero, one)
    c2 = inverse_affine_coeffs(angle, zero, zero, zero, zero, scale)
    c3 = inverse_affine_coeffs(zero, zero, zero, shx, shy, one)
    return c1, c2, c3


def _grid(h: int, w: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    ys = torch.arange(h, device=device, dtype=torch.int32).to(torch.float32)
    xs = torch.arange(w, device=device, dtype=torch.int32).to(torch.float32)
    ys, xs = torch.meshgrid(ys, xs, indexing="ij")
    return ys - (h - 1) / 2.0, xs - (w - 1) / 2.0


def _coef(m, i, xs):
    """Coefficient ``i`` of (..., 6) ``m``, shaped to broadcast against the
    trailing (H, W) grid of ``xs``."""
    c = m[..., i]
    return c.reshape(c.shape + (1,) * (xs.dim() - c.dim()))


def _to_int32(v):
    """float32 -> int32 with NaN -> 0 and out-of-range values saturated, as
    XLA and CUDA convert. The CPU's own conversion gives INT_MIN for all of
    these, so there the values are mapped first; the top goes to 2^31 - 128,
    the largest float32 below 2^31, which lies outside every map as INT_MAX
    does."""
    if v.device.type == "cpu":
        v = v.clamp(-2.0 ** 31, 2.0 ** 31 - 128).nan_to_num(0.0)
    return v.to(torch.int32)


def compose_nearest_indices(coeff_list: Sequence[torch.Tensor], xs, ys, valid,
                            h: int, w: int):
    """Compose NEAREST-warp index maps backwards through ``coeff_list``.

    ``coeff_list`` holds the warps in application order [first, ..., last],
    each (..., 6); ``xs``/``ys`` are centered coordinates at the output of the
    last warp, (..., H, W); ``valid`` is the mask accumulated so far. Returns
    centered integer-valued source coordinates into the first warp's input
    and the updated mask.
    """
    half_w = (w - 1) / 2.0
    half_h = (h - 1) / 2.0
    for m in reversed(list(coeff_list)):
        x_in = _coef(m, 0, xs) * xs + _coef(m, 1, xs) * ys + _coef(m, 2, xs) + half_w
        y_in = _coef(m, 3, xs) * xs + _coef(m, 4, xs) * ys + _coef(m, 5, xs) + half_h
        ix = _to_int32(torch.round(x_in))
        iy = _to_int32(torch.round(y_in))
        valid = valid & (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        xs = ix.clamp(0, w - 1).to(torch.float32) - half_w
        ys = iy.clamp(0, h - 1).to(torch.float32) - half_h
    return xs, ys, valid


def gather_nearest(imgs, xs, ys, valid, h: int, w: int):
    """Gather (B, C, H, W) ``imgs`` at centered integer coords (B, H, W);
    zeros where ``valid`` is False."""
    b, c = imgs.shape[:2]
    idx = ((ys + (h - 1) / 2.0).to(torch.int64) * w
           + (xs + (w - 1) / 2.0).to(torch.int64))
    idx = idx.reshape(b, 1, h * w).expand(b, c, h * w)
    out = imgs.reshape(b, c, h * w).gather(2, idx).reshape(b, c, h, w)
    return torch.where(valid[:, None], out, 0.0)


def _gather_nhwc(imgs, iy, ix):
    """``imgs`` (B, C, H, W) at integer (B, H, W) rows and columns, returned
    as (B, H, W, C). Indexing the NHWC view keeps a channels_last input's
    layout and needs no copy of it."""
    bidx = torch.arange(imgs.shape[0], device=imgs.device).view(-1, 1, 1)
    return imgs.permute(0, 2, 3, 1)[bidx, iy, ix]


def _sample_nearest(imgs, x_in, y_in):
    _, _, h, w = imgs.shape
    ix = _to_int32(torch.round(x_in))
    iy = _to_int32(torch.round(y_in))
    valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    out = _gather_nhwc(imgs, iy.clamp(0, h - 1).long(), ix.clamp(0, w - 1).long())
    return torch.where(valid[..., None], out, 0.0)


def _sample_bilinear(imgs, x_in, y_in):
    _, _, h, w = imgs.shape
    x0 = torch.floor(x_in)
    y0 = torch.floor(y_in)
    wx1 = x_in - x0
    wy1 = y_in - y0

    def corner(xc, yc, wgt):
        xi = _to_int32(xc)
        yi = _to_int32(yc)
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        vals = _gather_nhwc(imgs, yi.clamp(0, h - 1).long(), xi.clamp(0, w - 1).long())
        return vals * (wgt * valid.to(torch.float32))[..., None]

    return (corner(x0, y0, (1 - wx1) * (1 - wy1))
            + corner(x0 + 1, y0, wx1 * (1 - wy1))
            + corner(x0, y0 + 1, (1 - wx1) * wy1)
            + corner(x0 + 1, y0 + 1, wx1 * wy1))


def warp_affine(imgs, coeffs, mode: str = "nearest"):
    """Warp (B, C, H, W) ``imgs`` by per-sample inverse (output->input)
    coefficients (B, 6) in centered coordinates; zero outside the source.

    ``mode`` is 'nearest' (torchvision's default; its indices are those of
    ``compose_nearest_indices``, computed in the same order) or 'bilinear'.
    The output is NCHW in shape and channels_last in memory whatever the
    input's layout: the samples are gathered in NHWC.
    """
    if mode not in ("nearest", "bilinear"):
        raise ValueError(f"mode {mode!r}")
    b, _, h, w = imgs.shape
    ys, xs = _grid(h, w, imgs.device)
    ys, xs = ys.expand(b, h, w), xs.expand(b, h, w)
    x_in = _coef(coeffs, 0, xs) * xs + _coef(coeffs, 1, xs) * ys + _coef(coeffs, 2, xs) \
        + (w - 1) / 2.0
    y_in = _coef(coeffs, 3, xs) * xs + _coef(coeffs, 4, xs) * ys + _coef(coeffs, 5, xs) \
        + (h - 1) / 2.0
    sample = _sample_nearest if mode == "nearest" else _sample_bilinear
    return sample(imgs, x_in, y_in).permute(0, 3, 1, 2)


def _chain_gather_nearest(imgs, coeff_list: Sequence[torch.Tensor]):
    """One-gather evaluation of sequential NEAREST warps, bit-exact: integer
    index maps compose exactly, so the chain needs no intermediate images."""
    b, _, h, w = imgs.shape
    ys, xs = _grid(h, w, imgs.device)
    xs = xs.expand(b, h, w)
    ys = ys.expand(b, h, w)
    valid = torch.ones((b, h, w), dtype=torch.bool, device=imgs.device)
    xs, ys, valid = compose_nearest_indices(coeff_list, xs, ys, valid, h, w)
    return gather_nearest(imgs, xs, ys, valid, h, w)


def warp_affine_chain(imgs, angle, tx, ty, shx, shy, scale):
    """The trainer's translate -> rotate/scale -> shear NEAREST warp chain on
    (B, C, H, W), as one composed gather. ``tx``/``ty`` are in output pixels."""
    c1, c2, c3 = chain_coeffs(angle, tx, ty, shx, shy, scale)
    return _chain_gather_nearest(imgs, [c1, c2, c3])


def inverse_warp_heatmaps(heatmaps, aug_param, ratio: float):
    """Undo a dataset-side affine augmentation on (B, K, h, w) heatmaps
    (train_human.py:359-372/418-423). ``aug_param`` is (B, 6): (angle, tx,
    ty, shear_x, shear_y, scale), already the inverse parameters;
    translations are divided by ``ratio`` = image_size / heatmap_size."""
    angle, tx, ty, shx, shy, scale = torch.as_tensor(
        aug_param, dtype=torch.float32, device=heatmaps.device).unbind(-1)
    return warp_affine_chain(heatmaps, angle, tx / ratio, ty / ratio, shx, shy,
                             scale)


def affine_keypoints(keypoints, angle, shear_x, shear_y, trans_x, trans_y, scale,
                     size: Tuple[float, float]):
    """Forward keypoint transform of the dataset-side affine
    (lib/transforms/keypoint_detection.py:137-167): rotate, shear and scale
    about the image center, then translate. ``keypoints`` (..., K, 2); the
    parameters broadcast against (...,); ``size`` is (width, height)."""
    a, b, c, d = (t[..., None] for t in rss_coeffs(angle, shear_x, shear_y))
    w, h = size
    x = keypoints[..., 0] - w / 2.0
    y = keypoints[..., 1] - h / 2.0
    scale, trans_x, trans_y = (t[..., None] for t in (scale, trans_x, trans_y))
    xn = scale * (a * x + b * y) + w / 2.0 + trans_x
    yn = scale * (c * x + d * y) + h / 2.0 + trans_y
    return torch.stack([xn, yn], dim=-1)
