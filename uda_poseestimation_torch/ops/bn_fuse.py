"""1x1 conv as a GEMM with the BatchNorm statistics fused into its epilogue.

Counterpart of ``uda_poseestimation_tpu/ops/bn_fuse.py``: ``matmul_stats``
computes ``y = cast(x @ w^T)`` and the per-column sum and sum of squares of
the CAST y, and ``conv1x1_bn_stats`` runs a (strided) 1x1 conv through it.
The train-mode Bottleneck uses them when ``fuse_bn`` is on (the JAX
package's ``UDA_BN_FUSE=1``), so BatchNorm needs no second pass over the
conv output for its statistics.

``matmul_stats`` launches the hand-written CUDA kernel
(``csrc/matmul_stats.cu``, sm_90a) for CUDA tensors and runs
``matmul_stats_plain``, the same function in plain PyTorch, for CPU tensors;
the plain version is never a fallback for a CUDA tensor. ``_plan`` picks the
kernel's variant and tiles from the shape, the type, the operands'
alignment and the card's SM count: ``"tma"`` (wgmma + TMA, bf16, where a
tensor map can describe every operand), ``"mma_sync"`` (bf16, the rest) or
``"simt"`` (f32 FFMA). A failed build or launch raises; it never falls back
to another variant.

The backward is the analytic gradient of the unfused composition in plain
PyTorch, exactly the JAX package's ``_mm_bwd``:

    g = dy + ds1 + 2 * ds2 * y        (per column, in float32)
    dx = cast(g) @ w ;  dw = cast(g)^T @ x

The weight is torch's conv layout, (N, K): both GEMM operands are
K-contiguous. Accumulation and the statistics are float32 whatever the input
type, as in the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import launches

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
VARIANTS = ("tma", "mma_sync", "simt")
_LAUNCH_ERRORS = {-1: "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint",
                  -2: "cuTensorMapEncodeTiled refused an operand",
                  -3: "the kernel cannot run this plan"}


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


class Plan(NamedTuple):
    """How the kernel runs one (M, K, N): its variant, the block tile BM x BN,
    the ring stages, the row groups (each block walks the row tiles g,
    g + groups, ...; tma only, else the row tiles, which the launcher checks)
    and the blocks launched."""
    variant: str
    bm: int
    bn: int
    stages: int
    groups: int
    ctas: int


def _cdiv(a, b):
    return -(-a // b)


def _tile_n(n):
    """The tma variant's tile width for N columns (``_plan``)."""
    return 64 if n <= 512 else 128


def tma_describable(k, n, aligned=True):
    """Whether tensor maps can describe x (M, K), w (N, K) and y (M, N) in
    bf16: rows a multiple of 16 bytes apart and 16-byte aligned bases."""
    return aligned and k % 8 == 0 and n % 8 == 0


def _plan(m, k, n, num_sms, dtype=torch.bfloat16, aligned=True, variant=None):
    """The kernel's plan for x (m, k) @ w (n, k)^T on a card with ``num_sms``
    SMs; ``aligned`` says both operands' addresses are 16-byte aligned.
    ``variant`` forces one ("mma_sync" for bf16 is always possible).

    The tma variant: 128-row tiles; BN 64 up to N = 512 (N <= 64 then has
    no half-empty tiles, and the narrower tile's shorter epilogue and deeper
    ring measured faster there on an H100), else 128; ring stages as many as
    shared memory holds (8 at BN 64, 4 at BN 128). Each block walks
    ceil(tiles_m / groups) row tiles, with groups as many as fill the SMs
    once (one block per SM). K is not split: every pose_resnet101 shape
    fills the card with row groups alone."""
    if dtype == torch.float32:
        if variant not in (None, "simt"):
            raise ValueError(f"float32 runs only the simt variant, not {variant}")
        return Plan("simt", 64, 64, 1, _cdiv(m, 64), _cdiv(m, 64) * _cdiv(n, 64))
    if dtype != torch.bfloat16:
        raise ValueError(f"the matmul_stats kernel takes float32 or bfloat16, got {dtype}")
    if variant is None:
        variant = "tma" if tma_describable(k, n, aligned) else "mma_sync"
    if variant == "mma_sync":
        return Plan("mma_sync", 128, 128, 2, _cdiv(m, 128), _cdiv(m, 128) * _cdiv(n, 128))
    if variant != "tma" or not tma_describable(k, n, aligned):
        raise ValueError(f"no {variant} plan for ({m}, {k}, {n}), aligned={aligned}")
    bm, bn = 128, _tile_n(n)
    tiles_m, tiles_n = _cdiv(m, bm), _cdiv(n, bn)
    groups = min(tiles_m, max(1, num_sms // tiles_n))
    return Plan("tma", bm, bn, 4 if bn == 128 else 8, groups, tiles_n * groups)


def _launcher():
    lib = _launcher.lib
    if lib is None:
        from .._build import load

        lib = load("matmul_stats")
        lib.matmul_stats_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.matmul_stats_launch.restype = ctypes.c_int
        lib.matmul_stats_wgmma_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.matmul_stats_wgmma_launch.restype = ctypes.c_int
        _launcher.lib = lib
    return lib


_launcher.lib = None
_tickets: dict = {}
_plans: dict = {}


def _ticket_buffer(device, stream, tiles_n):
    """The zeroed int32 tickets of the tma variant's last-block reduction,
    one buffer per device and stream (calls on one stream run in order; each
    launch leaves its tickets zero).

    While a CUDA graph captures on ``stream``, the stream's buffer must
    exist already: one allocated in the capture would come from the graph's
    private memory pool and outlive it here. A graph's replays share the
    buffer with the eager calls on its capture stream, which they never
    overlap (run one eager call on that stream before capturing)."""
    key = (device.index, stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < tiles_n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "matmul_stats: no ticket buffer for the capturing stream; run the "
                "captured work once eagerly on that stream first")
        buf = torch.zeros(max(1024, tiles_n), dtype=torch.int32, device=device)
        _tickets[key] = buf
    return buf


def kernel_plan(x, w_nk, variant=None):
    """The plan the kernel runs for CUDA tensors x (M, K) and w_nk (N, K):
    ``_plan`` for their shape, type and alignment on their card (kept per
    key: the wrapper's host time counts on the host-paced training step)."""
    (m, k), n = x.shape, w_nk.shape[0]
    aligned = x.data_ptr() % 16 == 0 and w_nk.data_ptr() % 16 == 0
    key = (x.device.index, m, k, n, x.dtype, aligned, variant)
    plan = _plans.get(key)
    if plan is None:
        num_sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        plan = _plans[key] = _plan(m, k, n, num_sms, x.dtype, aligned, variant)
    return plan


def _matmul_stats_cuda(x, w_nk, out_dtype, variant=None):
    """The kernel's forward on CUDA tensors, with ``_plan``'s variant or the
    one given."""
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the matmul_stats kernel takes float32 or bfloat16, "
                         f"got {x.dtype}")
    if out_dtype != x.dtype:
        raise ValueError(f"the matmul_stats kernel writes y in the input dtype "
                         f"({x.dtype}), got out_dtype {out_dtype}")
    if not (x.is_contiguous() and w_nk.is_contiguous()):
        raise ValueError("matmul_stats needs row-major contiguous x and w")
    (m, k), n = x.shape, w_nk.shape[0]
    dev = x.device
    y = torch.empty((m, n), dtype=out_dtype, device=dev)
    stats = torch.empty((2, n), dtype=torch.float32, device=dev)
    s1, s2 = stats[0], stats[1]
    if m == 0 or n == 0:
        return y, s1.zero_(), s2.zero_()
    if k == 0:
        raise ValueError("matmul_stats needs K > 0")
    if max(m, n, k) >= 2 ** 31:
        raise ValueError(f"matmul_stats: shape ({m}, {k}, {n}) exceeds the kernel's grid")
    lib = _launcher()
    plan = kernel_plan(x, w_nk, variant)
    if plan.groups > 65535:
        raise ValueError(f"matmul_stats: shape ({m}, {k}, {n}) exceeds the kernel's grid")
    stream = torch.cuda.current_stream(dev).cuda_stream
    part = torch.empty((2, plan.groups, n), dtype=torch.float32, device=dev)
    part1 = part.data_ptr()
    part2 = part1 + plan.groups * n * 4
    stats1 = stats.data_ptr()
    stats2 = stats1 + n * 4
    if plan.variant == "tma":
        tickets = _ticket_buffer(dev, stream, _cdiv(n, plan.bn))
        err = lib.matmul_stats_wgmma_launch(
            x.data_ptr(), w_nk.data_ptr(), y.data_ptr(), part1, part2, stats1, stats2,
            tickets.data_ptr(), m, k, n, plan.bn, plan.groups, stream)
    else:
        err = lib.matmul_stats_launch(
            x.data_ptr(), w_nk.data_ptr(), y.data_ptr(), part1, part2, stats1, stats2,
            m, k, n, plan.groups, int(plan.variant == "mma_sync"), stream)
    if err != 0:
        why = _LAUNCH_ERRORS.get(err, f"cudaError {err}")
        raise RuntimeError(f"matmul_stats {plan.variant} kernel launch failed: {why}")
    launches.count(matmul_stats, plan.variant)
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
    call's launch, ``launches_by_variant`` the same by ``_plan``'s variant,
    a captured launch once per replay: ``ops/launches.py``); a CPU tensor
    through ``matmul_stats_plain``.
    """
    _check(x, w_nk)
    return _MatmulStats.apply(x, w_nk, x.dtype if out_dtype is None else out_dtype)


matmul_stats.launches = 0
matmul_stats.launches_by_variant = dict.fromkeys(VARIANTS, 0)


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
