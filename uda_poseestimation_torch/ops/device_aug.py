"""On-device keypoint-aware augmentation: the views of ``--device-aug``.

PyTorch twin of the human half of ``uda_poseestimation_tpu/ops/device_aug.py``.
The host only decodes and resizes each frame into a canvas; every random
view (the source view, the student view, the k teacher views and the style
image) is drawn and rendered here, on the step's device:

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

Every function works on a batch of views, flattened to N = views x samples
or kept as (V, B), with no Python loop over samples. A view's random
parameters come in a dict of tensors, its draws: a test injects the values
that ``jax.random`` gives in the JAX package (mapped, so that no rounding
can flip), and ``draw_view`` / ``draw_rrc`` make them from a
``torch.Generator`` with the JAX package's map of a uniform ``u`` to [lo, hi)
(``max(lo, u * (hi - lo) + lo)``) and its rounding. Nothing reads a tensor
back to the host and no shape depends on a draw, so the views can be built
inside a captured CUDA graph. The resample's products run in float32 with
TF32 and autocast off, whatever the caller set.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from ..device import device_vector
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

@contextlib.contextmanager
def _full_f32(device: torch.device):
    """float32 products: TF32 and autocast off inside, restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.autocast(device.type, enabled=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


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
    with _full_f32(images.device):
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
    a side; edges are replicated. A sigma of at most 1e-4 is the identity.
    Deviation kept from JAX ``gaussian_blur``: an exact truncated Gaussian
    where PIL applies three box blurs."""
    r = max(1, int(math.ceil(3.0 * max_sigma)))
    dev = images.device
    xs = torch.arange(-r, r + 1, device=dev, dtype=torch.int32).to(torch.float32)
    sig = sigma[:, None]
    w = torch.exp(-0.5 * (xs / sig.clamp(min=1e-4)) ** 2)
    w = torch.where(sig > 1e-4, w, (xs == 0).to(torch.float32))
    w = w / w.sum(dim=-1, keepdim=True)

    def one_axis(x, axis, size):
        pos = torch.arange(size, device=dev)
        out = None
        for t in range(2 * r + 1):
            idx = (pos + (t - r)).clamp(0, size - 1)
            term = x.index_select(axis, idx) * w[:, t].view(-1, 1, 1, 1)
            out = term if out is None else out + term
        return out

    _, h, wd, _ = images.shape
    return one_axis(one_axis(images, 1, h), 2, wd)


def _flat(draws: Mapping) -> dict:
    return {k: v.reshape(-1) for k, v in draws.items()}


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
    img = images.expand((v,) + images.shape).reshape((v * b,) + images.shape[1:])
    kp = keypoints.to(torch.float32).expand((v,) + keypoints.shape).reshape(
        (v * b,) + keypoints.shape[1:])
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
        vis = visible.to(torch.float32).reshape(b, -1).expand(v, b, -1).reshape(v * b, -1)
        target, weight = generate_target_batch(kp, vis, (cfg.heatmap_size, cfg.heatmap_size),
                                               cfg.sigma, (size, size))
        out["target"] = views(target)
        out["target_weight"] = views(weight)
    return out
