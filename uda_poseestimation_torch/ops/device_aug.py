"""On-device keypoint-aware augmentation: the views of ``--device-aug``.

PyTorch twin of ``uda_poseestimation_tpu/ops/device_aug.py``. The host only
decodes and resizes (or, for the animal family, crops) each frame into a
canvas; every random view (the source view, the student view, the k teacher
views and the style image) is drawn and rendered here, on the step's device.
The human trainer's views:

- RandomResizedCrop: 10 attempts of an area scale, the first side that fits
  wins, else the whole canvas (aspect 1), rendered as one separable resample
  with ``jax.image.scale_and_translate(method="linear")``'s semantics
  (``rrc_image``): half-pixel sample points, a triangle kernel widened by
  max(1/s, 1), each output's weights renormalized by their sum and zeroed
  outside the input, over the whole canvas (the pixels beside the crop
  window enter its border rows);
- RandomAffineRotation: the same parameter draws, the exact nearest warp of
  ``ops/affine.py``, keypoints by the exact RSS math, and ``aug_param`` in
  the reference's convention;
- ColorJitter: the PIL enhance formulas for brightness, contrast (about the
  mean gray) and saturation, in a fixed b -> c -> s order;
- Gaussian blur: separable, with a static support of ceil(3 * max sigma)
  taps a side and replicated edges;
- Normalize, and the Gaussian heatmap targets of ``ops/heatmap.py``.

DEVIATION NOTE (the JAX package's, unchanged): this path trades PIL
resampling bit-parity for speed: one bilinear resample instead of PIL's
uint8-quantized chain, ColorJitter in a fixed order where the reference
shuffles it per sample, and an exact truncated Gaussian where PIL applies
three box blurs. The host pipeline stays reference-exact.

The animal trainers' views (``animal_views``, ``animal_source_views``): the
TigDog/AnimalPose student and teacher views, an affine warp of the crop with
the targets through the MPII transform and window-rule labelmaps
(``mpii_transform_points``, ``draw_labelmap``); and the synthetic source's
imgaug chain, flip and crop as one gather from the frame, with its own
deviation note below.

Every function works on a batch of views, flattened to N = views x samples
or kept as (V, B), with no Python loop over samples. A view's random
parameters come in a dict of tensors, its draws: a test injects the values
that ``jax.random`` gives in the JAX package (mapped, so that no rounding
can flip), and ``draw_view`` / ``draw_rrc`` make them from a
``torch.Generator`` with the JAX package's map of a uniform ``u`` to [lo, hi)
(``max(lo, u * (hi - lo) + lo)``) and its rounding. Nothing reads a tensor
back to the host and no shape depends on a draw, so the views can be built
inside a captured CUDA graph. The resample's products, the blur's
convolutions and the animal coordinates run in float32 with TF32 and
autocast off, whatever the caller set.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import device_vector, full_f32
from .affine import affine_keypoints, inverse_affine_coeffs, warp_affine
from .heatmap import generate_target_batch

_GRAY = (0.299, 0.587, 0.114)  # PIL "L" weights


@dataclasses.dataclass(frozen=True)
class DeviceAugConfig:
    """The fields and defaults of the JAX package's ``DeviceAugConfig``."""

    image_size: int = 256
    heatmap_size: int = 64
    sigma: float = 2.0
    resize_scale: Tuple[float, float] = (0.6, 1.3)
    rotation: float = 180.0
    shear: Tuple[float, float] = (-30.0, 30.0)
    translate: Tuple[float, float] = (0.05, 0.05)
    scale: Tuple[float, float] = (0.6, 1.3)
    color: float = 0.25
    blur: float = 0.0
    use_rrc: bool = True  # source/base views use RandomResizedCrop


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------

def _uniform(u, lo: float, hi: float):
    """``jax.random.uniform``'s map of a [0, 1) float32 ``u`` to [lo, hi),
    with the bounds and their difference in float32."""
    lo32 = np.float32(lo)
    span = float(np.float32(hi) - lo32)
    return (u * span + float(lo32)).clamp(min=float(lo32))


def rrc_params(scales, u_i, u_j, canvas: int):
    """RandomResizedCrop decisions (JAX ``_rrc_params``, reference :479-507).

    ``scales`` (..., 10) are the ten attempts' area scales, ``u_i``/``u_j``
    (...) uniforms in [0, 1). The side is ``round(sqrt(scale * canvas *
    canvas))`` (half to even), the first attempt with 0 < side <= canvas,
    else the canvas; the offsets are ``floor(u * (canvas - side + 1))``.
    Returns float32 (i, j, side), the first valid attempt picked on the
    device.
    """
    sides = torch.round(torch.sqrt(scales * canvas * canvas))
    ok = (sides > 0) & (sides <= canvas)
    # first True; an int tensor, since argmax of a bool tensor is not
    # supported on every backend
    first = ok.to(torch.int32).argmax(dim=-1, keepdim=True)
    side = torch.where(ok.any(dim=-1), sides.gather(-1, first)[..., 0], float(canvas))
    max_off = canvas - side
    i = torch.floor(u_i * (max_off + 1))
    j = torch.floor(u_j * (max_off + 1))
    return i, j, side


def _fields(cfg: DeviceAugConfig):
    names = (["rrc"] * 12 if cfg.use_rrc else []) + ["angle", "shear_x", "trans_x",
                                                      "trans_y", "scale"]
    if cfg.color > 0:
        names += ["fb", "fc", "fs"]
    if cfg.blur > 0:
        names += ["sigma"]
    return names


def view_fields(cfg: DeviceAugConfig) -> int:
    """How many uniforms one view of ``cfg`` draws."""
    return len(_fields(cfg))


def rrc_from_uniforms(cfg: DeviceAugConfig, u, canvas: int) -> dict:
    """A RandomResizedCrop's draws {"i", "j", "side"} from (..., 12)
    uniforms: ten area scales, then the two offsets'."""
    scales = _uniform(u[..., :10], *cfg.resize_scale)
    i, j, side = rrc_params(scales, u[..., 10], u[..., 11], canvas)
    return {"i": i, "j": j, "side": side}


def view_from_uniforms(cfg: DeviceAugConfig, u, canvas: int) -> dict:
    """One view's draws from (..., ``view_fields(cfg)``) uniforms: the crop
    ({"i", "j", "side"}, when ``cfg.use_rrc``), the affine ({"angle",
    "shear_x", "trans_x", "trans_y", "scale"}; shear_y is 0 and the
    translations are rounded, as in JAX ``_affine_params``), the jitter
    factors ({"fb", "fc", "fs"}, when ``cfg.color > 0``) and the blur radius
    ({"sigma"}, when ``cfg.blur > 0``)."""
    names = _fields(cfg)
    out = {}
    at = 0
    if cfg.use_rrc:
        out.update(rrc_from_uniforms(cfg, u[..., :12], canvas))
        at = 12
    cols = dict(zip(names[at:], u[..., at:].unbind(-1)))
    if isinstance(cfg.rotation, (tuple, list)):
        rot_lo, rot_hi = cfg.rotation
    else:
        rot_lo, rot_hi = -abs(cfg.rotation), abs(cfg.rotation)
    max_dx = cfg.translate[0] * cfg.image_size
    max_dy = cfg.translate[1] * cfg.image_size
    out["angle"] = _uniform(cols["angle"], rot_lo, rot_hi)
    out["shear_x"] = _uniform(cols["shear_x"], *cfg.shear)
    out["trans_x"] = torch.round(_uniform(cols["trans_x"], -max_dx, max_dx))
    out["trans_y"] = torch.round(_uniform(cols["trans_y"], -max_dy, max_dy))
    out["scale"] = _uniform(cols["scale"], *cfg.scale)
    if cfg.color > 0:
        lo, hi = max(0.0, 1.0 - cfg.color), 1.0 + cfg.color
        for name in ("fb", "fc", "fs"):
            out[name] = _uniform(cols[name], lo, hi)
    if cfg.blur > 0:
        out["sigma"] = _uniform(cols["sigma"], 0.0, cfg.blur)
    return out


def draw_rrc(cfg: DeviceAugConfig, shape, canvas: int, device=None,
             generator: Optional[torch.Generator] = None) -> dict:
    """A RandomResizedCrop's draws, each of ``shape``: {"i", "j", "side"}."""
    u = torch.rand(tuple(shape) + (12,), generator=generator, device=device)
    return rrc_from_uniforms(cfg, u, canvas)


def draw_view(cfg: DeviceAugConfig, shape, canvas: int, device=None,
              generator: Optional[torch.Generator] = None) -> dict:
    """One view's draws, each of ``shape`` (views, samples), from one
    ``torch.rand`` call (see ``view_from_uniforms``)."""
    u = torch.rand(tuple(shape) + (view_fields(cfg),), generator=generator, device=device)
    return view_from_uniforms(cfg, u, canvas)


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def _weight_mat(in_size: int, out_size: int, scale, translation):
    """(N, out, in) linear resample weights of ``scale_and_translate``
    (``jax._src.image.scale.compute_weight_mat`` with the triangle kernel
    and antialias on) for per-sample ``scale`` and ``translation`` (N,)."""
    dev = scale.device
    inv = 1.0 / scale
    kernel_scale = inv.clamp(min=1.0)
    outs = torch.arange(out_size, device=dev, dtype=torch.int32).to(torch.float32)
    ins = torch.arange(in_size, device=dev, dtype=torch.int32).to(torch.float32)
    sample = (outs + 0.5) * inv[:, None] - (translation * inv)[:, None] - 0.5
    x = (sample[:, :, None] - ins).abs() / kernel_scale[:, None, None]
    w = (1.0 - x).clamp(min=0.0)
    total = w.sum(dim=-1, keepdim=True)
    eps = float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > 1000.0 * eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[..., None], w, 0.0)


def rrc_image(images, i, j, side, out_size: int):
    """Crop-and-resize of (N, S, S, C) float32 ``images`` to (N, out, out,
    C) at per-sample offsets and sides (N,) (JAX ``_rrc_image``): two
    batched products with the (out, S) weight matrices, rows then columns."""
    n, s_h, s_w, c = images.shape
    scale = out_size / side
    wy = _weight_mat(s_h, out_size, scale, -i * scale)
    wx = _weight_mat(s_w, out_size, scale, -j * scale)
    with full_f32(images.device):
        rows = torch.bmm(wy, images.reshape(n, s_h, s_w * c))  # (N, out, S_w * C)
        cols = rows.view(n, out_size, s_w, c).transpose(1, 2).reshape(n, s_w, out_size * c)
        out = torch.bmm(wx, cols)  # (N, out_x, out_y * C)
    return out.view(n, out_size, out_size, c).transpose(1, 2).contiguous()


def color_jitter(images, fb, fc, fs):
    """Brightness (blend with black), contrast (blend with the mean gray)
    and saturation (blend with the gray image), in that order, each clipped
    to [0, 1], on (N, H, W, 3) images with per-sample factors (N,). The gray
    image is that of the brightened image, as in JAX ``_color_jitter``."""
    def per(v):
        return v.view(-1, 1, 1, 1)

    img = (images * per(fb)).clamp(0.0, 1.0)
    gray = (img * device_vector(_GRAY, img.device)).sum(dim=-1, keepdim=True)
    mean = gray.mean(dim=(1, 2, 3), keepdim=True)
    img = ((img - mean) * per(fc) + mean).clamp(0.0, 1.0)
    return ((img - gray) * per(fs) + gray).clamp(0.0, 1.0)


def gaussian_blur(images, sigma, max_sigma: float):
    """Separable Gaussian blur of (N, H, W, C) images with per-sample sigma
    (N,) (PIL's ``radius``) and the static support ceil(3 * max_sigma) taps
    a side; edges are replicated. A sigma of at most 1e-4 is the identity,
    exactly. Each axis is one depthwise convolution in full float32 (JAX
    ``gaussian_blur``'s ``conv_general_dilated``). Deviation kept from JAX
    ``gaussian_blur``: an exact truncated Gaussian where PIL applies three
    box blurs."""
    r = max(1, int(math.ceil(3.0 * max_sigma)))
    dev = images.device
    n, h, wd, c = images.shape
    xs = torch.arange(-r, r + 1, device=dev, dtype=torch.int32).to(torch.float32)
    sig = sigma.reshape(-1, 1)
    w = torch.exp(-0.5 * (xs / sig.clamp(min=1e-4)) ** 2)
    w = torch.where(sig > 1e-4, w, (xs == 0).to(torch.float32))
    w = w / w.sum(dim=-1, keepdim=True)
    w = w[:, None].expand(n, c, 2 * r + 1).reshape(n * c, 2 * r + 1)  # a row per channel
    x = images.permute(0, 3, 1, 2).reshape(1, n * c, h, wd)
    with full_f32(dev):
        x = F.conv2d(F.pad(x, (0, 0, r, r), mode="replicate"), w.view(n * c, 1, -1, 1),
                     groups=n * c)
        x = F.conv2d(F.pad(x, (r, r, 0, 0), mode="replicate"), w.view(n * c, 1, 1, -1),
                     groups=n * c)
    out = x.view(n, c, h, wd).permute(0, 2, 3, 1).contiguous()
    return torch.where(sig.view(-1, 1, 1, 1) > 1e-4, out, images)


def _flat(draws: Mapping) -> dict:
    return {k: v.reshape(-1) for k, v in draws.items()}


def _expand_views(t, v: int):
    """(B, ...) -> (V * B, ...), each view a copy of the batch."""
    return t.expand((v,) + t.shape).reshape((v * t.shape[0],) + t.shape[1:])


def rrc_views(images, keypoints, draws: Mapping, out_size: int):
    """The shared RandomResizedCrop base view (JAX ``rrc_batch``): (B, S, S,
    C) canvases and (B, K, 2) keypoints -> (B, out, out, C) and (B, K, 2),
    with draws {"i", "j", "side"} of shape (B,)."""
    d = _flat(draws)
    img = rrc_image(images, d["i"], d["j"], d["side"], out_size)
    factor = out_size / d["side"]
    kp = (keypoints - torch.stack([d["j"], d["i"]], dim=-1)[:, None]) * factor[:, None, None]
    return img, kp


def augment_views(images, keypoints, visible, cfg: DeviceAugConfig, draws: Mapping,
                  mean=None, std=None, targets: bool = True) -> dict:
    """V augmented views of each of B samples (JAX ``augment_batch``).

    ``images`` (B, S, S, 3) float32 canvases in [0, 1], ``keypoints`` (B,
    K, 2) on them, ``visible`` (B, K); ``draws`` as ``draw_view`` gives them,
    each (V, B). Returns {"image" (V, B, size, size, 3) contiguous NHWC,
    "keypoint2d", "aug_param" (V, B, 6)} and, with ``targets``, "target"
    (V, B, K, hm, hm) and "target_weight" (V, B, K, 1). ``mean``/``std``
    normalize the images (``std`` only with ``mean``).
    """
    if mean is None and std is not None:
        raise ValueError("std given without mean; pass mean=[0,0,0] for "
                         "scale-only normalization")
    size = cfg.image_size
    v, b = draws["angle"].shape
    d = _flat(draws)
    img = _expand_views(images, v)
    kp = _expand_views(keypoints.to(torch.float32), v)
    if cfg.use_rrc:
        img = rrc_image(img, d["i"], d["j"], d["side"], size)
        factor = size / d["side"]
        kp = (kp - torch.stack([d["j"], d["i"]], dim=-1)[:, None]) * factor[:, None, None]

    angle, shx, tx, ty, scale = (d[n] for n in ("angle", "shear_x", "trans_x", "trans_y",
                                                "scale"))
    shy = torch.zeros_like(angle)
    coeffs = inverse_affine_coeffs(angle, tx, ty, shx, shy, scale)
    # the warp gathers in NHWC: its NCHW-shaped output is NHWC in memory
    img = warp_affine(img.permute(0, 3, 1, 2), coeffs, mode="nearest").permute(0, 2, 3, 1)
    kp = affine_keypoints(kp, angle, shx, shy, tx, ty, scale, (size, size))
    aug_param = torch.stack([-angle, -tx, -ty, -shx, -shy, 1.0 / scale], dim=-1)

    if cfg.color > 0:
        img = color_jitter(img, d["fb"], d["fc"], d["fs"])
    if cfg.blur > 0:
        img = gaussian_blur(img, d["sigma"], cfg.blur)
    if mean is not None:
        m = device_vector(mean, img.device)
        s = device_vector(std if std is not None else (1.0, 1.0, 1.0), img.device)
        img = (img - m) / s

    def views(t):
        return t.reshape((v, b) + t.shape[1:])

    out = {"image": views(img), "keypoint2d": views(kp), "aug_param": views(aug_param)}
    if targets:
        vis = _expand_views(visible.to(torch.float32).reshape(b, -1), v)
        target, weight = generate_target_batch(kp, vis, (cfg.heatmap_size, cfg.heatmap_size),
                                               cfg.sigma, (size, size))
        out["target"] = views(target)
        out["target_weight"] = views(weight)
    return out


# ---------------------------------------------------------------------------
# the animal family: MPII transform, window-rule labelmaps, the mt views
# ---------------------------------------------------------------------------

def mpii_transform_points(pts, center, scale, res: int):
    """Original-frame points to the ``res``-sized MPII crop (the host's
    ``data.util.transform`` at rot 0; JAX ``mpii_transform_points``), with
    the reference's -1/+1 offsets and truncation toward zero. ``pts`` (...,
    K, 2), ``center`` (..., 2), ``scale`` (...); returns int32 (..., K, 2)."""
    h = 200.0 * scale.to(torch.float32)
    t00 = (res / h)[..., None]
    t02 = (res * (-center[..., 0] / h + 0.5))[..., None]
    t12 = (res * (-center[..., 1] / h + 0.5))[..., None]
    x = t00 * (pts[..., 0] - 1.0) + t02
    y = t00 * (pts[..., 1] - 1.0) + t12
    return torch.stack([torch.trunc(x), torch.trunc(y)], dim=-1).to(torch.int32) + 1


def draw_labelmap(pt, sigma: float, out_res: int, label_type: str = "Gaussian"):
    """Window-rule labelmaps of integer points (JAX ``draw_labelmap``, the
    host's ``draw_labelmap_ori``), batched: ``pt`` (..., 2) -> (maps (...,
    out_res, out_res) float32, visibility bits (...) float32).

    The paste window ``ul = trunc(pt - 3σ)``, ``br = trunc(pt + 3σ + 1)``
    must lie inside the map, else the bit is 0 and the map empty. The peak
    sits at ``ul + (6σ + 1) // 2`` (Python float floor division), which is
    ``pt`` for an integer σ and moves by the truncation's asymmetry for a
    fractional one (σ = 1.5, pt = 4: ul = 0, peak 5), as in the reference;
    ``--sigma`` is a float flag. ``label_type`` "Gaussian" or "Cauchy"."""
    sig = float(sigma)
    tmp = 3.0 * sig
    x0 = float((6.0 * sig + 1.0) // 2)
    ptf = pt.to(torch.float32)
    ul_x, ul_y = (torch.trunc(ptf[..., i] - tmp)[..., None, None] for i in (0, 1))
    br_x, br_y = (torch.trunc(ptf[..., i] + tmp + 1.0)[..., None, None] for i in (0, 1))
    vis = ~((br_x >= out_res) | (br_y >= out_res) | (ul_x < 0) | (ul_y < 0))
    grid = torch.arange(out_res, device=pt.device, dtype=torch.int32).to(torch.float32)
    xs, ys = grid.view(1, -1), grid.view(-1, 1)
    dx = xs - (ul_x + x0)
    dy = ys - (ul_y + x0)
    if label_type == "Gaussian":
        g = torch.exp(-(dx * dx + dy * dy) / (2.0 * sig ** 2))
    else:  # Cauchy
        g = sig / torch.pow(dx * dx + dy * dy + sig ** 2, 1.5)
    window = (xs >= ul_x) & (xs < br_x) & (ys >= ul_y) & (ys < br_y)
    return torch.where(window & vis, g, 0.0), vis[..., 0, 0].to(torch.float32)


def _mpii_targets(pts, vis, center, scale, out_res: int, sigma: float, label_type: str):
    """Targets and weights of (N, K, 2) frame keypoints, rendered where the
    keypoint's y > 0 (the reference's ``tpts[i, 1] > 0``): (N, K, out, out)
    and (N, K, 1)."""
    gate = pts[..., 1] > 0
    tpts = mpii_transform_points(pts + 1.0, center, scale, out_res)
    hm, win_vis = draw_labelmap(tpts - 1, sigma, out_res, label_type)
    target = torch.where(gate[..., None, None], hm, 0.0)
    weight = torch.where(gate, vis * win_vis, vis)
    return target, weight[..., None], gate


def animal_views(images, kp_orig, vis, centers, scales, cfg: DeviceAugConfig, draws: Mapping,
                 mean=None, label_type: str = "Gaussian", targets: bool = True) -> dict:
    """V animal mt views of each of B samples (JAX ``animal_augment_batch``,
    real_animal_all_mt.py:250-322's semantics).

    ``images`` (B, S, S, 3) float32 crops in [0, 1], ``kp_orig`` (B, K, 2)
    keypoints in the ORIGINAL frame, ``vis`` (B, K), ``centers`` (B, 2),
    ``scales`` (B,); ``draws`` the affine's as ``draw_view`` gives them for a
    ``cfg`` with ``use_rrc=False`` and ``color=0``, each (V, B). The image is
    warped by the exact nearest warp; the keypoint math runs on the original
    frame's coordinates with the canvas's center (the reference's quirk),
    and the targets through the MPII transform where y > 0. Returns
    {"image" (V, B, S, S, 3) contiguous NHWC, minus ``mean`` when given,
    "keypoint2d", "aug_param" (V, B, 6)} and, with ``targets``, "target" (V,
    B, K, hm, hm) and "target_weight" (V, B, K, 1)."""
    size = cfg.image_size
    v, b = draws["angle"].shape
    d = _flat(draws)
    img = _expand_views(images, v)
    angle, shx, tx, ty, scale = (d[n] for n in ("angle", "shear_x", "trans_x", "trans_y",
                                                "scale"))
    shy = torch.zeros_like(angle)
    coeffs = inverse_affine_coeffs(angle, tx, ty, shx, shy, scale)
    # the warp gathers in NHWC: its NCHW-shaped output is NHWC in memory
    img = warp_affine(img.permute(0, 3, 1, 2), coeffs, mode="nearest").permute(0, 2, 3, 1)
    kp = affine_keypoints(_expand_views(kp_orig.to(torch.float32), v), angle, shx, shy, tx, ty,
                          scale, (size, size))
    aug_param = torch.stack([-angle, -tx, -ty, -shx, -shy, 1.0 / scale], dim=-1)
    if mean is not None:
        img = img - device_vector(mean, img.device)

    def views(t):
        return t.reshape((v, b) + t.shape[1:])

    out = {"image": views(img), "keypoint2d": views(kp), "aug_param": views(aug_param)}
    if targets:
        target, weight, _ = _mpii_targets(
            kp, _expand_views(vis.to(torch.float32), v), _expand_views(centers, v),
            _expand_views(scales, v), cfg.heatmap_size, cfg.sigma, label_type)
        out["target"] = views(target)
        out["target_weight"] = views(weight)
    return out


# ---------------------------------------------------------------------------
# the synthetic-animal SOURCE: imgaug chain, flip, crop_ori and targets
# ---------------------------------------------------------------------------
#
# The host pipeline (data/synthetic_animal.py, data/animal_aug.py) runs per
# sample: imgaug [Affine, Noise, Blur, Contrast], each with p = 0.5 and in
# random order, on the 640x480 frame; a p = 0.5 horizontal flip with the
# pair swap; the MPII crop_ori to inp_res; mean normalization and the
# window-rule targets. Here, as in the JAX package's twin, the three
# geometric stages compose into one map, so the crop is ONE nearest gather
# from the frame (its cost scales with the 256² output, not the frame);
# the keypoints and centers take the host's exact formulas; noise, blur and
# contrast act on the crop in their drawn order, after the affine.
#
# DEVIATIONS (the JAX package's, kept: the port is held to its device twin,
# not to the host chain): nearest resampling in one pass instead of
# imgaug's bilinear warp and scipy's imresize; cval outside the imgaug
# frame and 0 outside the crop; the image flips at w-1-x where the
# keypoints flip at w-x (the reference's 1 px); keypoints outside the
# configured frame zeroed by ``> w`` / ``> h``; the ops on the crop: noise
# i.i.d. at crop resolution, the blur's sigma scaled by the crop's zoom and
# clamped to ``max_blur_sigma`` (a static support), no uint8 rounding
# between ops; the bytescale stretch over the crop, ``floor(x + 0.5) /
# 255``.

@dataclasses.dataclass(frozen=True)
class AnimalSourceAugConfig:
    """The fields and defaults of the JAX package's ``AnimalSourceAugConfig``."""

    inp_res: int = 256
    out_res: int = 64
    sigma: float = 1.0
    p: float = 0.5          # imgaug per-op probability
    frame_w: int = 640      # original frame (the reference hardcodes 640/480)
    frame_h: int = 480
    label_type: str = "Gaussian"
    max_blur_sigma: float = 5.0


def flip_perm_from_pairs(pairs, num_keypoints: int) -> np.ndarray:
    """A ``FLIP_PAIRS`` entry as the permutation vector of the keypoints'
    left/right swap (JAX ``flip_perm_from_pairs``)."""
    perm = np.arange(num_keypoints)
    for a, b in pairs:
        perm[a], perm[b] = perm[b], perm[a]
    return perm.astype(np.int32)


def imgaug_affine_matrix(w: int, h: int, sx, sy, tx, ty, rot_rad, shear_rad):
    """imgaug's Affine as a (..., 3, 3) float32 matrix (JAX
    ``imgaug_affine_matrix``, the host's ``AnimalAugmentation`` matrix):
    scale, rotate and shear about the frame's center, then translate by
    (tx, ty) pixels; the draws are equal-shape tensors."""
    cx, cy = w / 2.0 - 0.5, h / 2.0 - 0.5
    cos_r, sin_r = torch.cos(rot_rad), torch.sin(rot_rad)
    a00 = sx * cos_r
    a01 = -sy * torch.sin(rot_rad + shear_rad)
    a10 = sx * sin_r
    a11 = sy * torch.cos(rot_rad + shear_rad)
    m02 = -cx * a00 - cy * a01 + cx + tx
    m12 = -cx * a10 - cy * a11 + cy + ty
    zero = torch.zeros_like(a00)
    return torch.stack([torch.stack([a00, a01, m02], -1), torch.stack([a10, a11, m12], -1),
                        torch.stack([zero, zero, zero + 1.0], -1)], -2)


def affine_inverse(m):
    """The inverse of (..., 3, 3) affine matrices (last row [0, 0, 1]) in
    closed form, elementwise: no solver, which would check for a singular
    matrix on the host."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    det = a * e - b * d
    zero = torch.zeros_like(a)
    return torch.stack([torch.stack([e / det, -b / det, (b * f - c * e) / det], -1),
                        torch.stack([-d / det, a / det, (c * d - a * f) / det], -1),
                        torch.stack([zero, zero, zero + 1.0], -1)], -2)


# the uniforms of one sample's source draws, in their order in ``u``
_SOURCE_UNIFORMS = (("gates", 4), ("perm", 4), ("sx", 1), ("sy", 1), ("tx", 1), ("ty", 1),
                    ("rot", 1), ("shear", 1), ("cval", 1), ("noise_pc", 1),
                    ("blur_sigma", 1), ("contrast_pc", 1), ("alphas", 3), ("flip", 1))
SOURCE_UNIFORMS = sum(n for _, n in _SOURCE_UNIFORMS)


def source_from_uniforms(cfg: AnimalSourceAugConfig, u, noise) -> dict:
    """One batch's source draws (JAX ``draw_animal_source_params``'s fields
    and distributions) from (B, ``SOURCE_UNIFORMS``) uniforms and the (B,
    inp, inp, 3) standard normal noise, which stands in for JAX's noise
    key: the imgaug gates (B, 4) of affine, noise, blur and contrast; their
    order ``perm`` (B, 4), the argsort of four uniforms; the affine's scales,
    translations (pixels), rotation and shear (radians); cval; the noise's
    per-channel switch; the blur sigma; the contrast's per-channel switch,
    its three alphas and the shared one (the first); the flip."""
    cols, at = {}, 0
    for name, n in _SOURCE_UNIFORMS:
        cols[name] = u[..., at:at + n] if n > 1 else u[..., at]
        at += n
    deg = math.pi / 180.0
    alphas = _uniform(cols["alphas"], 0.5, 2.0)
    return {
        "gates": cols["gates"] < cfg.p,
        "perm": torch.argsort(cols["perm"], dim=-1),
        "sx": _uniform(cols["sx"], 0.5, 1.5), "sy": _uniform(cols["sy"], 0.5, 1.5),
        "tx": _uniform(cols["tx"], -0.05, 0.05) * cfg.frame_w,
        "ty": _uniform(cols["ty"], -0.05, 0.05) * cfg.frame_h,
        "rot": _uniform(cols["rot"], -30.0, 30.0) * deg,
        "shear": _uniform(cols["shear"], -20.0, 20.0) * deg,
        "cval": _uniform(cols["cval"], 0.0, 255.0),
        "noise_pc": cols["noise_pc"] < 0.5,
        "noise": noise,
        "blur_sigma": _uniform(cols["blur_sigma"], 1.0, 5.0),
        "contrast_pc": cols["contrast_pc"] < 0.5,
        "alphas": alphas, "alpha_shared": alphas[..., 0],
        "flip": cols["flip"] < 0.5,
    }


def draw_animal_source(cfg: AnimalSourceAugConfig, b: int, device=None,
                       generator: Optional[torch.Generator] = None) -> dict:
    """B samples' source draws (``source_from_uniforms``) from one
    ``torch.rand`` and one ``torch.randn`` call."""
    u = torch.rand((b, SOURCE_UNIFORMS), generator=generator, device=device)
    noise = torch.randn((b, cfg.inp_res, cfg.inp_res, 3), generator=generator, device=device)
    return source_from_uniforms(cfg, u, noise)


def _per_sample(t):
    return t.view(-1, 1, 1, 1)


def animal_source_views(canvases, pts, centers, scales, flip_perm,
                        cfg: AnimalSourceAugConfig, draws: Mapping, mean=None, std=None,
                        is_aug: bool = True, m_inv=None) -> dict:
    """The synthetic source's training views of B decoded frames (JAX
    ``animal_source_batch``; see the note above this function).

    ``canvases`` (B, frame_h, frame_w, 3) uint8 (or float32 in [0, 255]),
    ``pts`` (B, K, 3) frame keypoints and visibility, ``centers`` (B, 2) and
    ``scales`` (B,) the MPII crop's, ``flip_perm`` (K,) the pair swap as a
    permutation (``flip_perm_from_pairs``), ``draws`` as
    ``draw_animal_source`` gives them; ``is_aug=False`` turns the imgaug ops
    and the flip off. ``m_inv`` (B, 3, 3), when given, replaces the closed
    form inverse of the imgaug matrix in the gather. Returns {"image" (B,
    inp, inp, 3) normalized by ``mean`` (and ``std``), "target" (B, K, out,
    out), "target_weight" (B, K, 1), "keypoint2d" (B, K, 2): the crop's
    integer coordinates where the keypoint's y > 0, its frame coordinates
    elsewhere (the host's quirk)}."""
    w, h, inp = cfg.frame_w, cfg.frame_h, cfg.inp_res
    b, fh, fw, ch = canvases.shape
    if (fh, fw) != (h, w):
        raise ValueError(f"frames of {fw}x{fh}, but the config's are {w}x{h}")
    dev = canvases.device
    gates, flip = draws["gates"], draws["flip"]
    if not is_aug:
        gates, flip = torch.zeros_like(gates), torch.zeros_like(flip)

    with torch.autocast(dev.type, enabled=False):
        m = imgaug_affine_matrix(w, h, draws["sx"], draws["sy"], draws["tx"], draws["ty"],
                                 draws["rot"], draws["shear"])
        eye = torch.eye(3, device=dev, dtype=torch.float32)
        m = torch.where(gates[:, 0, None, None], m, eye)

        # keypoints: the affine (the host's product), then the rows outside
        # the frame zeroed (synthetic_animal.py's 640/480 is the frame)
        pts = pts.to(torch.float32)
        x, y = pts[..., 0], pts[..., 1]
        kx = m[:, 0, 0, None] * x + m[:, 0, 1, None] * y + m[:, 0, 2, None]
        ky = m[:, 1, 0, None] * x + m[:, 1, 1, None] * y + m[:, 1, 2, None]
        pts = torch.stack([kx, ky, pts[..., 2]], dim=-1)
        oob = (kx < 0) | (ky < 0) | (kx > w) | (ky > h)
        pts = torch.where(oob[..., None], 0.0, pts)

        # the flip: keypoints at w - x with the pairs swapped, the center
        # mirrored (synthetic_animal.py's shufflelr_ori)
        kp_flip = torch.cat([w - pts[..., :1], pts[..., 1:]], dim=-1)[:, flip_perm.long()]
        pts = torch.where(flip[:, None, None], kp_flip, pts)
        centers = centers.to(torch.float32)
        centers = torch.where(flip[:, None], torch.stack([w - centers[:, 0], centers[:, 1]], -1),
                              centers)
        scales = scales.to(torch.float32)

        # the image: ONE gather from the frame to the crop
        t_h = 200.0 * scales
        t00 = inp / t_h
        t02 = inp * (-centers[:, 0] / t_h + 0.5)
        t12 = inp * (-centers[:, 1] / t_h + 0.5)
        grid = torch.arange(inp, device=dev, dtype=torch.int32).to(torch.float32)
        fx = (grid.view(1, 1, -1) - t02.view(-1, 1, 1)) / t00.view(-1, 1, 1)
        fy = (grid.view(1, -1, 1) - t12.view(-1, 1, 1)) / t00.view(-1, 1, 1)
        fx = torch.where(flip.view(-1, 1, 1), (w - 1.0) - fx, fx)  # fliplr's w-1-x
        inside1 = (fx >= 0) & (fx <= w - 1) & (fy >= 0) & (fy <= h - 1)
        if m_inv is None:
            m_inv = affine_inverse(m)
        mi = [m_inv[:, r, c].view(-1, 1, 1) for r in (0, 1) for c in (0, 1, 2)]
        qx = mi[0] * fx + mi[1] * fy + mi[2]
        qy = mi[3] * fx + mi[4] * fy + mi[5]
        ix = torch.round(qx).clamp(0, w - 1).to(torch.int64)
        iy = torch.round(qy).clamp(0, h - 1).to(torch.int64)
        inside0 = (qx >= -0.5) & (qx <= w - 0.5) & (qy >= -0.5) & (qy <= h - 0.5)
        idx = (iy * w + ix).view(b, inp * inp, 1).expand(b, inp * inp, ch)
        img = canvases.reshape(b, h * w, ch).gather(1, idx).view(b, inp, inp, ch)
        img = torch.where(inside0[..., None], img.to(torch.float32),
                          _per_sample(draws["cval"]))
        img = torch.where(inside1[..., None], img, 0.0)

        # noise, blur and contrast on the crop, in the drawn order: each of
        # the four stages computes every op for the batch and keeps, per
        # sample, the one its perm names where its gate holds (JAX's
        # lax.switch under vmap); the blur runs once a stage, with sigma 0
        # (the identity) for the samples that do not blur there
        zoom = inp / t_h
        blur_sigma = (draws["blur_sigma"] * zoom).clamp(0.0, cfg.max_blur_sigma)
        noise = draws["noise"] * (0.5 * 255.0)
        noise = torch.where(_per_sample(draws["noise_pc"]), noise, noise[..., :1])
        alpha = torch.where(draws["contrast_pc"][:, None], draws["alphas"],
                            draws["alpha_shared"][:, None]).view(-1, 1, 1, 3)
        perm = draws["perm"]
        for stage in range(4):
            op = perm[:, stage]
            on = gates.gather(1, op[:, None].long())[:, 0]
            blurred = gaussian_blur(img, torch.where(on & (op == 2), blur_sigma, 0.0),
                                    cfg.max_blur_sigma)
            noisy = (img + noise).clamp(0.0, 255.0)
            contrasted = ((img - 128.0) * alpha + 128.0).clamp(0.0, 255.0)
            img = torch.where(_per_sample(on & (op == 1)), noisy,
                              torch.where(_per_sample(on & (op == 3)), contrasted, blurred))

        # crop_ori's scipy-imresize bytescale: the crop stretched to [0, 255]
        # and put on the uint8 grid before the /255
        flat = img.reshape(b, -1)
        cmin = flat.amin(dim=1)
        cscale = (flat.amax(dim=1) - cmin).clamp(min=1e-12)
        img = torch.floor(((img - _per_sample(cmin)) * _per_sample(255.0 / cscale))
                          .clamp(0.0, 255.0) + 0.5) / 255.0
        if mean is not None:
            img = img - device_vector(mean, dev)
            if std is not None:
                img = img / device_vector(std, dev)

        # targets: the MPII transform and window-rule labelmaps where y > 0
        target, weight, gate = _mpii_targets(pts[..., :2], pts[..., 2], centers, scales,
                                             cfg.out_res, cfg.sigma, cfg.label_type)
        kp2d = torch.where(gate[..., None],
                           mpii_transform_points(pts[..., :2] + 1.0, centers, scales,
                                                 inp).to(torch.float32),
                           pts[..., :2])
    return {"image": img, "target": target, "target_weight": weight, "keypoint2d": kp2d}
