"""Nearest-warp gather of heatmaps from precomputed indices.

Counterpart of the Pallas TPU kernel ``warp_gather_onehot``
(``uda_poseestimation_tpu/ops/pallas_warp.py``):

    out[b, k, p] = hms[b, k, iy[b, p], ix[b, p]]   where valid[b, p],
                   0                                elsewhere,

and 0 as well where the index pair lies outside the map, since the TPU
kernel's one-hot rows and columns match no such index. ``exact=False``
returns bf16-rounded values, as the TPU kernel's single bf16 dot does.

``warp_gather`` launches the hand-written CUDA kernel
(``csrc/warp_gather.cu``, sm_90a) for a CUDA tensor and runs
``warp_gather_plain``, the same function in plain PyTorch, for a CPU tensor;
the plain version is never a fallback for a CUDA tensor. Nothing in the
port calls it, as nothing in the JAX package's steps calls its twin.
"""

from __future__ import annotations

import ctypes

import torch


def vector_path(hms, ix, iy, valid, out) -> bool:
    """Whether the kernel may read each 4 pixels' indices and mask with one
    vector load and write each channel's 4 outputs with one 16-byte store:
    H*W a multiple of 4, ``hms``, ``ix``, ``iy`` and ``out`` 16-byte aligned
    and ``valid`` 4-byte aligned. Else it loads and stores element by
    element."""
    h, w = hms.shape[-2:]
    return (h * w % 4 == 0 and valid.data_ptr() % 4 == 0
            and all(t.data_ptr() % 16 == 0 for t in (hms, ix, iy, out)))


def _check(hms, ix, iy, valid):
    if hms.dim() != 4 or hms.dtype != torch.float32:
        raise ValueError(f"hms must be (B, K, H, W) float32, got "
                         f"{tuple(hms.shape)} {hms.dtype}")
    b, _, h, w = hms.shape
    for name, t in (("ix", ix), ("iy", iy)):
        if t.shape != (b, h * w) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be ({b}, {h * w}) int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if valid.shape != (b, h * w) or valid.dtype != torch.bool:
        raise ValueError(f"valid must be ({b}, {h * w}) bool, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    if not (ix.device == iy.device == valid.device == hms.device):
        raise ValueError("hms, ix, iy and valid must share a device")


def warp_gather_plain(hms, ix, iy, valid, exact: bool = True):
    """Plain PyTorch version of the kernel, on any device."""
    _check(hms, ix, iy, valid)
    b, k, h, w = hms.shape
    ix, iy = ix.long(), iy.long()
    inside = valid & (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    idx = torch.where(inside, iy * w + ix, 0)
    out = hms.reshape(b, k, h * w).gather(2, idx[:, None].expand(b, k, h * w))
    if not exact:
        out = out.to(torch.bfloat16).to(torch.float32)
    return torch.where(inside[:, None], out, 0.0).reshape(b, k, h, w)


def _launcher():
    fn = _launcher.fn
    if fn is None:
        from .._build import load

        fn = load("warp_gather").warp_gather_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launcher.fn = fn
    return fn


_launcher.fn = None


def warp_gather(hms, ix, iy, valid, exact: bool = True):
    """Gather (B, K, H, W) float32 ``hms`` at int32 (B, H*W) source columns
    ``ix`` and rows ``iy``; 0 where the bool (B, H*W) ``valid`` is False or
    the index lies outside the map. Returns (B, K, H, W) float32.

    A CUDA tensor goes through the CUDA kernel (``launches`` counts each
    launch); a CPU tensor through ``warp_gather_plain``.
    """
    _check(hms, ix, iy, valid)
    if hms.device.type == "cpu":
        return warp_gather_plain(hms, ix, iy, valid, exact)
    if hms.device.type != "cuda":
        raise ValueError(f"warp_gather runs on cuda or cpu, got {hms.device}")
    if not all(t.is_contiguous() for t in (hms, ix, iy, valid)):
        raise ValueError("warp_gather needs contiguous hms, ix, iy and valid")
    b, k, h, w = hms.shape
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid (65535)")
    out = torch.empty_like(hms)
    if out.numel() == 0:
        return out
    vec = vector_path(hms, ix, iy, valid, out)
    err = _launcher()(hms.data_ptr(), ix.data_ptr(), iy.data_ptr(), valid.data_ptr(),
                      out.data_ptr(), b, k, h, w, int(vec), int(bool(exact)),
                      torch.cuda.current_stream(hms.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"warp_gather kernel launch failed: cudaError {err}")
    warp_gather.launches += 1
    return out


warp_gather.launches = 0
