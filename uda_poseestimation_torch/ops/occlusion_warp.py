"""The occlusion image warp: backward(paste-rectangle(forward-chain(x))).

Counterpart of the Pallas TPU kernel ``occlusion_warp_onehot``
(``uda_poseestimation_tpu/ops/pallas_warp.py``). For each output pixel it
evaluates a staged nearest index chain (the backward affine ``cb``, the
paste-rectangle remap, then the forward chain c3 -> c2 -> c1), each stage
rounding half to even, ANDing an in-bounds flag into ``valid`` and
clipping, and gathers the source pixel for every channel (0 where not
valid). ``exact=False`` returns bf16-rounded values, as the TPU kernel's
single bf16 dot does.

``occlusion_warp`` launches the hand-written CUDA kernel
(``csrc/occlusion_warp.cu``, sm_90a) for a CUDA tensor and runs
``occlusion_warp_plain``, the same function in plain PyTorch, for a CPU
tensor. The plain version is the tests' CPU path and the kernel's oracle on
the card; it is never a fallback for a CUDA tensor.

On an H100 the kernel is bound by memory: at the main path's (32, 3, 256,
256) f32 it reads at most 25.2 MB and writes 25.2 MB (~15 us at 3.35 TB/s).
Its index math is not negligible: ~100 f32 operations a pixel hold it
more than its bytes do, so they are kept off the conversion pipe, where
float<->int conversions run at a quarter of the f32 rate. A block covers a
32x32 output tile, each warp gathers 8x4 pixel patches (an affine map's
locality), and the tile is staged in shared memory and written with
16-byte stores in the input's layout.
"""

from __future__ import annotations

import ctypes

import torch

from .affine import compose_nearest_indices


def _check(imgs, coeffs, rect):
    if imgs.dim() != 4 or imgs.dtype != torch.float32:
        raise ValueError(f"imgs must be (B, C, H, W) float32, got "
                         f"{tuple(imgs.shape)} {imgs.dtype}")
    b, c, h, w = imgs.shape
    if h != w or (w & (w - 1)) != 0:
        raise ValueError(
            f"occlusion_warp needs a square power-of-two image size (shift/"
            f"mask row-col split), got {h}x{w}")
    if coeffs.shape != (b, 4, 6) or coeffs.dtype != torch.float32:
        raise ValueError(f"coeffs must be ({b}, 4, 6) float32, got "
                         f"{tuple(coeffs.shape)} {coeffs.dtype}")
    if rect.shape != (b, 6) or rect.dtype != torch.int32:
        raise ValueError(f"rect must be ({b}, 6) int32, got "
                         f"{tuple(rect.shape)} {rect.dtype}")
    if not (coeffs.device == rect.device == imgs.device):
        raise ValueError(f"imgs, coeffs and rect must share a device, got "
                         f"{imgs.device}, {coeffs.device}, {rect.device}")


def occlusion_indices_plain(coeffs, rect, size: int):
    """The staged index chain on full grids (train_step.py:334-358).

    coeffs (B, 4, 6) rows [cb, c1, c2, c3]; rect (B, 6) [left, right, upper,
    bottom, left_src, upper_src] (left/right bound rows, upper/bottom cols:
    the reference's swapped naming). Returns source column and row (B, H, W)
    int64 and the valid mask.
    """
    b = coeffs.shape[0]
    h = w = size
    half = (size - 1) / 2.0
    dev = coeffs.device
    rows = torch.arange(size, device=dev, dtype=torch.int32).to(torch.float32)
    ys0, xs0 = torch.meshgrid(rows - half, rows - half, indexing="ij")
    xs0 = xs0.expand(b, h, w)
    ys0 = ys0.expand(b, h, w)
    valid = torch.ones((b, h, w), dtype=torch.bool, device=dev)
    cb, c1, c2, c3 = coeffs.unbind(1)
    qx, qy, valid = compose_nearest_indices([cb], xs0, ys0, valid, h, w)
    qr = (qy + half).to(torch.int32)
    qc = (qx + half).to(torch.int32)
    lt, rb, up, bb, ls, us = (t.view(b, 1, 1) for t in rect.unbind(1))
    inside = (qr >= lt) & (qr < rb) & (qc >= up) & (qc < bb)
    rr = torch.where(inside, qr - lt + ls, qr)
    rc = torch.where(inside, qc - up + us, qc)
    fx, fy, valid = compose_nearest_indices(
        [c1, c2, c3], rc.to(torch.float32) - half, rr.to(torch.float32) - half,
        valid, h, w)
    return (fx + half).to(torch.int64), (fy + half).to(torch.int64), valid


def occlusion_warp_plain(imgs, coeffs, rect, exact: bool = True):
    """Plain PyTorch version of the kernel, on any device."""
    _check(imgs, coeffs, rect)
    b, c, h, w = imgs.shape
    ix, iy, valid = occlusion_indices_plain(coeffs, rect, h)
    idx = (iy * w + ix).reshape(b, 1, h * w).expand(b, c, h * w)
    out = imgs.reshape(b, c, h * w).gather(2, idx).reshape(b, c, h, w)
    if not exact:
        out = out.to(torch.bfloat16).to(torch.float32)
    return torch.where(valid[:, None], out, 0.0)


def _launcher():
    fn = _launcher.fn
    if fn is None:
        from .._build import load

        fn = load("occlusion_warp").occlusion_warp_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launcher.fn = fn
    return fn


_launcher.fn = None


def occlusion_warp(imgs, coeffs, rect, exact: bool = True):
    """Fused occlusion warp of (B, C, H, W) float32 ``imgs`` (H == W a power
    of two, contiguous NCHW or channels_last) by coeffs (B, 4, 6) float32 and
    rect (B, 6) int32. The output has the input's memory format.

    A CUDA tensor goes through the CUDA kernel (``launches`` counts each
    launch); a CPU tensor through ``occlusion_warp_plain``.
    """
    _check(imgs, coeffs, rect)
    if imgs.device.type == "cpu":
        return occlusion_warp_plain(imgs, coeffs, rect, exact)
    if imgs.device.type != "cuda":
        raise ValueError(f"occlusion_warp runs on cuda or cpu, got {imgs.device}")
    if not (imgs.is_contiguous()
            or imgs.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError("imgs must be contiguous NCHW or channels_last")
    if not (coeffs.is_contiguous() and rect.is_contiguous()):
        raise ValueError("coeffs and rect must be contiguous")
    b, c, h, w = imgs.shape
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid (65535)")
    if c * h * w >= 2 ** 31:
        raise ValueError(f"an image of {c * h * w} elements exceeds the kernel's "
                         f"32-bit offsets")
    out = torch.empty_like(imgs)
    if b == 0 or c == 0:
        return out
    # a (B, 1, H, W) or 1x1 image is contiguous in both formats: NCHW then
    channels_last = not imgs.is_contiguous()
    err = _launcher()(
        imgs.data_ptr(), coeffs.data_ptr(), rect.data_ptr(), out.data_ptr(),
        b, c, w.bit_length() - 1, int(channels_last), int(bool(exact)),
        torch.cuda.current_stream(imgs.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"occlusion_warp kernel launch failed: cudaError {err}")
    occlusion_warp.launches += 1
    return out


occlusion_warp.launches = 0
