"""Inputs made from ``--seed``: weights on the device and synthetic batches.

Both the program and the reference get these same tensors. Every draw
comes from a ``torch.Generator`` on the run's device, in a few large calls,
so the same seed on the same device gives the same inputs.

Weights (shapes from the reference's modules, built on the meta device):
He-normal convolutions (std sqrt(2 / fan_in)); each residual branch's last
BatchNorm scale at ``residual_gain``, as trained ResNets keep them small
(zero-initialized in the usual recipe): at unit scales a random train-mode
ResNet-101 is chaotic, so that rounding alone moves its heatmaps by most of
their size; the keypoint head at ``head_std``, wide enough that the
teacher's heatmaps pass the occlusion threshold as a trained teacher's do;
zero biases, other BatchNorm scales 1, fresh running statistics.

Batches are in the loaders' output format (NHWC float32 normalized images,
Gaussian targets, ``aug_param`` rows as the datasets record them), on the
host and page-locked where the run is on the card. Each image has its own
brightness per channel, contrast and share of fine detail over a smooth
field, so that images, and the losses of their rows, differ as photographs
do.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch

from .reference import models, ops

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % (2 ** 63))
    return g


def _fan_in(name: str, shape) -> int:
    if "upsampling" in name:  # ConvTranspose2d (Cin, Cout, k, k), stride 2: Cin * (k/2)^2 taps
        return shape[0] * (shape[2] // 2) * (shape[3] // 2)
    return shape[1] * shape[2] * shape[3]


def fill_weights(module: torch.nn.Module, seed: int, stream: int, device,
                 head_std: float = 0.03, residual_gain: float = 0.2,
                 dtype=torch.float32) -> dict:
    """A state dict for ``module``'s structure (its shapes are read only):
    one normal draw for every conv weight together."""
    shapes = {k: v.shape for k, v in module.state_dict().items()}
    convs = [k for k, s in shapes.items() if k.endswith("weight") and len(s) == 4]
    total = sum(math.prod(shapes[k]) for k in convs)
    noise = torch.randn(total, generator=_generator(seed, stream, device), device=device)
    out, at = {}, 0
    for k, s in shapes.items():
        if k in convs:
            n = math.prod(s)
            std = head_std if k == "head.weight" else math.sqrt(2.0 / _fan_in(k, s))
            out[k] = (noise[at:at + n].view(s) * std).to(dtype)
            at += n
        elif k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.long, device=device)
        elif k.endswith("bn3.weight"):  # the residual branch's last scale
            out[k] = torch.full(s, residual_gain, device=device, dtype=dtype)
        elif k.endswith("running_var") or (k.endswith("weight") and len(s) == 1):
            out[k] = torch.ones(s, device=device, dtype=dtype)
        else:
            out[k] = torch.zeros(s, device=device, dtype=dtype)
    return out


def pose_weights(cfg: Mapping, seed: int, device) -> dict:
    with torch.device("meta"):
        shape_model = models.PoseResNet(cfg["num_keypoints"], tuple(cfg["stage_sizes"]))
    return fill_weights(shape_model, seed, 1, device, cfg["head_std"], cfg["residual_gain"])


def style_weights(seed: int, device, dtype=torch.float32) -> dict:
    with torch.device("meta"):
        shape_model = models.StyleNet()
    return fill_weights(shape_model, seed, 2, device, dtype=dtype)


def _images(g, shape, device):
    """Normalized NHWC images of ``shape`` (..., S, S, 3): per image a
    channel mean U(0.2, 0.8), a contrast U(0.05, 0.5) and a detail share
    U(0, 1) mixing an 8x8 field, upsampled, with pixel noise."""
    *lead, h, w, c = shape
    n = math.prod(lead)

    def u(*s):
        return torch.rand((n, *s), generator=g, device=device)

    smooth = torch.nn.functional.interpolate(u(c, 8, 8), size=(h, w), mode="bilinear",
                                             align_corners=False).permute(0, 2, 3, 1)
    detail = u(1, 1, 1)
    x = (0.2 + 0.6 * u(1, 1, c)) + (0.05 + 0.45 * u(1, 1, 1)) * 2 * (
        (1 - detail) * (smooth - 0.5) + detail * (u(h, w, c) - 0.5))
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    return ((x.clamp(0.0, 1.0) - mean) / std).reshape(shape)


def _aug_params(g, b, traffic, device):
    """(B, 6) inverse parameters as the datasets record them:
    (-angle, -tx, -ty, -shear_x, -shear_y, 1/scale)."""
    u = torch.rand((b, 5), generator=g, device=device)
    rot, (sh0, sh1) = traffic["rotation"], traffic["shear"]
    max_t = traffic["translate"] * traffic["image_size"]
    angle = (u[:, 0] * 2 - 1) * rot
    shear = sh0 + u[:, 1] * (sh1 - sh0)
    tx = torch.round((u[:, 2] * 2 - 1) * max_t)
    ty = torch.round((u[:, 3] * 2 - 1) * max_t)
    lo, hi = traffic["scale"]
    scale = lo + u[:, 4] * (hi - lo)
    return torch.stack([-angle, -tx, -ty, -shear, torch.zeros_like(angle), 1.0 / scale], -1)


def adapt_batches(cfg: Mapping, traffic: Mapping, seed: int, device, n: int) -> list:
    """``n`` distinct adapt batches as device tensors: dicts with the
    source (``image_s``, ``target_s``, ``weight_s``) and the target's views
    (``image_t_stu``, ``images_t_tea`` (1, B, ...), ``aug_param_stu``,
    ``aug_params_tea`` (1, B, 6))."""
    g = _generator(seed, 3, device)
    b, s, k, h = cfg["batch"], cfg["image_size"], cfg["num_keypoints"], cfg["heatmap_size"]
    out = []
    for _ in range(n):
        kp = 16 + torch.rand((b, k, 2), generator=g, device=device) * (s - 32)
        vis = (torch.rand((b, k), generator=g, device=device) < traffic["visible"]).float()
        target, weight = ops.generate_targets(kp, vis, h, cfg["sigma"], s)
        out.append({
            "image_s": _images(g, (b, s, s, 3), device), "target_s": target,
            "weight_s": weight, "image_t_stu": _images(g, (b, s, s, 3), device),
            "images_t_tea": _images(g, (1, b, s, s, 3), device),
            "aug_param_stu": _aug_params(g, b, traffic, device),
            "aug_params_tea": _aug_params(g, b, traffic, device)[None],
        })
    return out


def image_batches(traffic: Mapping, image_size: int, seed: int, device, n: int,
                  stream: int = 4) -> list:
    """``n`` NHWC float32 normalized image batches of ``traffic["batch"]``."""
    g = _generator(seed, stream, device)
    return [_images(g, (traffic["batch"], image_size, image_size, 3), device)
            for _ in range(n)]


def to_host(tree, pin: bool):
    """A copy of a tree of tensors in host memory, page-locked if ``pin``."""
    if isinstance(tree, torch.Tensor):
        out = torch.empty(tree.shape, dtype=tree.dtype, pin_memory=pin)
        out.copy_(tree)
        return out
    if isinstance(tree, Mapping):
        return {k: to_host(v, pin) for k, v in tree.items()}
    return [to_host(v, pin) for v in tree]
