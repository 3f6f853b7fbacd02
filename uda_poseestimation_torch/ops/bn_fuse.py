"""1x1 conv as a GEMM with the BatchNorm statistics fused into its epilogue.

Counterpart of ``uda_poseestimation_tpu/ops/bn_fuse.py``: ``matmul_stats``
computes ``y = cast(x @ w^T)`` and the per-column sum and sum of squares of
the CAST y, and ``conv1x1_bn_stats`` runs a (strided) 1x1 conv through it.
The train-mode Bottleneck uses them when ``fuse_bn`` is on (the JAX
package's ``UDA_BN_FUSE=1``), so BatchNorm needs no second pass over the
conv output for its statistics.

``matmul_stats`` launches the hand-written CUDA kernel
(``csrc/matmul_stats.cu``, sm_90a: bf16 tensor cores, or f32 FFMA) for CUDA
tensors and runs ``matmul_stats_plain``, the same function in plain
PyTorch, for CPU tensors; the plain version is never a fallback for a CUDA
tensor. The backward is the analytic gradient of the unfused composition in
plain PyTorch, exactly the JAX package's ``_mm_bwd``:

    g = dy + ds1 + 2 * ds2 * y        (per column, in float32)
    dx = cast(g) @ w ;  dw = cast(g)^T @ x

The weight is torch's conv layout, (N, K): both GEMM operands are
K-contiguous. Accumulation and the statistics are float32 whatever the input
type, as in the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _check(x, w_nk):
    if x.dim() != 2 or w_nk.dim() != 2 or x.shape[1] != w_nk.shape[1]:
        raise ValueError(f"matmul_stats needs x (M, K) and w (N, K), got "
                         f"{tuple(x.shape)} and {tuple(w_nk.shape)}")
    if x.dtype != w_nk.dtype or not x.dtype.is_floating_point:
        raise ValueError(f"x and w must share a floating dtype, got {x.dtype} "
                         f"and {w_nk.dtype}")
    if x.device != w_nk.device:
        raise ValueError(f"x and w must share a device, got {x.device} and "
                         f"{w_nk.device}")


def matmul_stats_plain(x, w_nk, out_dtype):
    """Plain PyTorch twin of ``_mm_stats_xla``: y = cast(x @ w^T) and the
    column sums of the cast y and of its square, on any device."""
    _check(x, w_nk)
    y = (x.float() @ w_nk.float().t()).to(out_dtype)
    yf = y.float()
    return y, yf.sum(0), (yf * yf).sum(0)


def _launcher():
    lib = _launcher.lib
    if lib is None:
        from .._build import load

        lib = load("matmul_stats")
        lib.matmul_stats_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.matmul_stats_launch.restype = ctypes.c_int
        lib.matmul_stats_tile_rows.argtypes = [ctypes.c_int]
        lib.matmul_stats_tile_rows.restype = ctypes.c_int
        _launcher.lib = lib
    return lib


_launcher.lib = None


def _matmul_stats_cuda(x, w_nk, out_dtype):
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the matmul_stats kernel takes float32 or bfloat16, "
                         f"got {x.dtype}")
    if out_dtype != x.dtype:
        raise ValueError(f"the matmul_stats kernel writes y in the input dtype "
                         f"({x.dtype}), got out_dtype {out_dtype}")
    if not (x.is_contiguous() and w_nk.is_contiguous()):
        raise ValueError("matmul_stats needs row-major contiguous x and w")
    (m, k), n = x.shape, w_nk.shape[0]
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    s1 = torch.empty((n,), dtype=torch.float32, device=x.device)
    s2 = torch.empty((n,), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y, s1.zero_(), s2.zero_()
    if k == 0:
        raise ValueError("matmul_stats needs K > 0")
    lib = _launcher()
    bf16 = int(x.dtype == torch.bfloat16)
    tiles = -(-m // lib.matmul_stats_tile_rows(bf16))
    if tiles > 65535 or max(m, n, k) >= 2 ** 31:
        raise ValueError(f"matmul_stats: shape ({m}, {k}, {n}) exceeds the "
                         f"kernel's grid")
    part1 = torch.empty((tiles, n), dtype=torch.float32, device=x.device)
    part2 = torch.empty((tiles, n), dtype=torch.float32, device=x.device)
    err = lib.matmul_stats_launch(
        x.data_ptr(), w_nk.data_ptr(), y.data_ptr(), part1.data_ptr(),
        part2.data_ptr(), s1.data_ptr(), s2.data_ptr(), m, k, n, bf16,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul_stats kernel launch failed: cudaError {err}")
    matmul_stats.launches += 1
    return y, s1, s2


def _forward(x, w_nk, out_dtype):
    if x.device.type == "cpu":
        return matmul_stats_plain(x, w_nk, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_stats runs on cuda or cpu, got {x.device}")
    return _matmul_stats_cuda(x, w_nk, out_dtype)


class _MatmulStats(torch.autograd.Function):
    # autocast stays off inside: the inputs come in the compute dtype, and
    # the backward's products must run in it, not in autocast's choice

    @staticmethod
    def forward(ctx, x, w_nk, out_dtype):
        with torch.autocast(x.device.type, enabled=False):
            y, s1, s2 = _forward(x, w_nk, out_dtype)
        ctx.save_for_backward(x, w_nk, y)
        ctx.out_dtype = out_dtype
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        x, w_nk, y = ctx.saved_tensors
        with torch.autocast(x.device.type, enabled=False):
            g = dy.float() + ds1 + 2.0 * ds2 * y.float()
            gc = g.to(ctx.out_dtype)
            dx = (gc @ w_nk.to(gc.dtype)).to(x.dtype)
            dw = (gc.t() @ x.to(gc.dtype)).to(w_nk.dtype)
        return dx, dw, None


def matmul_stats(x, w_nk, out_dtype=None):
    """``y = cast(x @ w_nk^T)`` (M, N) in ``out_dtype`` (default x's),
    ``s1``/``s2`` (N,) the column sums of the cast y and of y*y, in float32.
    Differentiable in x and w_nk.

    A CUDA tensor goes through the CUDA kernel (``launches`` counts each
    launch); a CPU tensor through ``matmul_stats_plain``.
    """
    _check(x, w_nk)
    return _MatmulStats.apply(x, w_nk, x.dtype if out_dtype is None else out_dtype)


matmul_stats.launches = 0


def conv1x1_bn_stats(x, weight, stride: int = 1):
    """A bias-free 1x1 conv of NCHW ``x`` with torch's (N, K, 1, 1)
    ``weight`` (both in the compute dtype), plus the per-channel sum and
    sum of squares of its output over (B, H', W').

    A strided 1x1 conv reads input positions ``s*i`` only, so it is the
    subsample ``x[:, :, ::s, ::s]`` followed by the GEMM. The GEMM reads x as
    an (B*H*W, K) matrix, i.e. channels_last memory (no copy when x already
    is), and y comes back as a channels_last (B, N, H', W') view of its
    (B*H'*W', N) output.
    """
    if stride != 1:
        x = x[:, :, ::stride, ::stride]
    b, k, h, w = x.shape
    n = weight.shape[0]
    x2 = x.permute(0, 2, 3, 1).reshape(b * h * w, k).contiguous()
    y2, s1, s2 = matmul_stats(x2, weight.reshape(n, k).contiguous(), x.dtype)
    return y2.view(b, h, w, n).permute(0, 3, 1, 2), s1, s2
