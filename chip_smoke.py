#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (uda_poseestimation_torch) on one GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, one JSON line each; any failure raises and the script exits non-zero:

1. env      the card, its power limit (nvidia-smi) and the TF32 settings,
            which are set off: the f32 comparisons below need full f32.
2. build    nvcc builds every kernel of the port from csrc/, one process per
            source, all started together (the time counts).
3. kernel   each kernel against its plain PyTorch version on the card at the
            main paths' shapes, then CUDA-event times of the kernel, the
            plain version and (where one exists) one PyTorch library call,
            with the L2 flushed before every launch, and the bound:
            occlusion_warp (equality required, also at every tile
            geometry, batch 1 and 33, 1-5 channels and out-of-range
            coefficients; its gather half timed alone through warp_gather
            and torch.gather on its index maps), matmul_stats at the 15
            distinct (M, K, N) of pose_resnet101's fused 1x1 convs at b=32
            in bf16, plus f32, ragged, unaligned and small-grid shapes (y
            within one bf16 ulp or the f32 summation bound, statistics
            within 1e-5 of the sums of their own y, a second call equal bit
            for bit), each shape's plan and the mma.sync variant's time at
            it, and the host time of one call; and warp_gather (equality
            required at the edge shapes too; timed on
            random indices and on the heatmap reconstruction's maps). The
            gathers' records also count the distinct 32-byte sectors read.
4. parity   one f32 adapt step at small width (tiny PoseResNet, 64² images,
            b=4) on the card and on the CPU from the same weights, batch and
            occlusion draws, compared to stated tolerances; then the same
            with fuse_bn=True (matmul_stats's f32 kernel on the card, its
            plain version on the CPU).
5. main     the main path at full width through the port's entry points:
            pose_resnet101 (21 keypoints) and the StyleNet with random
            weights from a seed, b=32, 256² images, k=1, both style
            directions and occlusion on, bf16 autocast and bf16 style
            params: 2 warm-up and 5 timed adapt steps, a pretrain step and
            an eval step. Every kernel's launch count is reset to 0 just
            before and read just after; each kernel of the path must have
            launched (occlusion_warp once per adapt step).
6. main_bn_fuse  the same with pose_resnet101(fuse_bn=True), the
            UDA_BN_FUSE=1 training path: matmul_stats must launch 70 times
            per train-mode forward (210 per adapt step at k=1, 70 for the
            pretrain step, 0 for eval), all of its tma variant, and
            occlusion_warp once per adapt step; ms/step, img/s and peak
            memory beside phase main's.

Then the kernel table ({"kernels": [...]}), the nvidia-smi line, and the
result line {"ok": true, "device": {...}}. Without CUDA, or without the rest
of the repository beside it, the script fails before printing any result.

``--profile DIR`` also traces one more adapt step of each main path with
torch.profiler and writes the per-kernel device-time tables to
DIR/profile_adapt_step.json and DIR/profile_adapt_step_bn_fuse.json.
"""

from __future__ import annotations

import argparse
import collections
import copy
import gc
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 (non-tensor) flop/s
# and dense bf16 tensor-core flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
# the kernel's per-pixel index math, as written in the source: 4 affine
# stages of 4 fmul + 6 fadd, 4 fadd rounding, 2 fadd re-centering, 2 max
# tracking the bounds and 4 min/max clipping; the centering, the rectangle
# remap and the source index (~16 more)
WARP_FLOPS_PER_PIXEL = 104

MAIN_B, MAIN_K, MAIN_KV = 32, 21, 1
# ~1 ms at the H100's ~2 GHz SM clock (see cuda_ms)
SLEEP_CYCLES = 2_000_000

# kernel-name patterns of the profile's groups, first match wins
KERNEL_GROUPS = (
    ("matmul_stats", r"mm_stats|stats_reduce"),
    ("layout_nchw_nhwc", r"nchwToNhwc|nhwcToNchw"),
    ("conv_gemm", r"xmma|cutlass|gemm|cudnn|sm90|dgrad|wgrad|implicit|conv"),
    ("batchnorm", r"batch_norm"),
    ("reflection_pad", r"reflection_pad"),
    ("optimizer_ema", r"multi_tensor|foreach"),
    ("occlusion_warp", r"occlusion_warp"),
    ("gather_scatter", r"gather|scatter|index"),
    ("upsample_pool", r"upsample|pool"),
    ("reduce", r"reduce"),
    ("elementwise", r"elementwise"),
)


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(fn, iters, flush=None):
    """Median device time of ``fn`` over ``iters`` launches (CUDA events,
    after one warm-up call), the L2 cache flushed before each launch. The
    card is held busy (~1 ms) before the start event, so the host has
    enqueued ``fn``'s kernels before the events start timing: the host's
    launch overhead does not count as device time."""
    import torch

    fn()
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def aug_params(rng, b, ties):
    """bench.py's augmentation recipe, or the tie-provoking set: zero angle
    and shear, integer translations, scale 0.5 or 2."""
    import numpy as np

    if ties:
        return np.stack([np.zeros(b), np.round(rng.uniform(-12, 12, b)),
                         np.round(rng.uniform(-12, 12, b)), np.zeros(b), np.zeros(b),
                         rng.choice([0.5, 2.0], b)], -1).astype(np.float32)
    return np.stack([rng.uniform(-60, 60, b), np.round(rng.uniform(-12, 12, b)),
                     np.round(rng.uniform(-12, 12, b)), rng.uniform(-30, 30, b),
                     rng.uniform(-30, 30, b), rng.uniform(0.6, 1.3, b)],
                    -1).astype(np.float32)


def warp_inputs(seed, b, size, ties, device):
    """Images, (B, 4, 6) coefficients as the adapt step builds them, and
    (B, 6) rectangles whose centers cycle through the four corners and the
    interior, so the paste touches every border."""
    import numpy as np
    import torch

    from uda_poseestimation_torch.ops.affine import chain_coeffs, inverse_affine_coeffs

    rng = np.random.RandomState(seed)
    imgs = torch.from_numpy(rng.rand(b, 3, size, size).astype(np.float32))
    angle, tx, ty, shx, shy, scale = torch.from_numpy(aug_params(rng, b, ties)).unbind(-1)
    ratio = 4.0
    c1, c2, c3 = chain_coeffs(angle, tx / ratio, ty / ratio, shx, shy, scale)
    cb = inverse_affine_coeffs(-angle, -tx / ratio, -ty / ratio, -shx, -shy, 1.0 / scale)
    coeffs = torch.stack([cb, c1, c2, c3], dim=1)
    centers = [(0, 0), (size - 1, size - 1), (0, size - 1), (size - 1, 0)]
    rect = []
    for i in range(b):
        cy, cx = (centers[i] if i < len(centers)
                  else tuple(int(v) for v in rng.randint(0, size, 2)))
        left, right = max(cy - 10, 0), min(cy + 10, size)
        upper, bottom = max(cx - 10, 0), min(cx + 10, size)
        rect.append([left, right, upper, bottom,
                     int(rng.rand() * (size - (right - left) + 1)),
                     int(rng.rand() * (size - (bottom - upper) + 1))])
    rect = torch.tensor(rect, dtype=torch.int32)
    return imgs.to(device), coeffs.to(device), rect.to(device)


def extreme_coeffs(coeffs, rect):
    """Coefficients and rectangles whose stage values leave every map, one
    kind per sample (B >= 6): |v| >= 2^22, beyond int32, +inf, -inf, NaN
    (which converts to 0 and stays valid) and inf * 0, and rectangle shifts
    beyond 2^22, one wrapping in int32 (the kernel's integer remap)."""
    coeffs, rect = coeffs.clone(), rect.clone()
    coeffs[0, 0, :2] *= 1e5
    coeffs[1, 3, 0], coeffs[1, 1, 4] = 3e9, -1e12
    coeffs[2, 3, 2], coeffs[2, 2, 5] = float("inf"), float("-inf")
    coeffs[3, 2, 0] = float("nan")
    coeffs[4, 0, 3], coeffs[4, 0, 4], coeffs[4, 0, 0] = float("inf"), 0.0, float("inf")
    rect[5, 4], rect[5, 0], rect[5, 1] = 1 << 23, 0, 1 << 30
    rect[4, 5], rect[4, 2], rect[4, 3] = -(1 << 31), 5, (1 << 31) - 1  # shift wraps
    return coeffs, rect


def _check_occlusion_warp(imgs, coeffs, rect, tag, exacts=(True, False)):
    """occlusion_warp against occlusion_warp_plain on the card, in each
    layout and ``exact``, a second call equal bit for bit; then its index
    maps, read through an image whose values are index + 1. Returns the
    number of comparisons and the largest absolute error seen."""
    import torch

    from uda_poseestimation_torch.ops.occlusion_warp import (
        occlusion_indices_plain, occlusion_warp, occlusion_warp_plain)

    checks, err = 0, 0.0
    for fmt in (torch.contiguous_format, torch.channels_last):
        x = imgs.contiguous(memory_format=fmt)
        for exact in exacts:
            got = occlusion_warp(x, coeffs, rect, exact=exact)
            again = occlusion_warp(x, coeffs, rect, exact=exact)
            want = occlusion_warp_plain(x, coeffs, rect, exact=exact)
            torch.cuda.synchronize()
            err = max(err, float((got - want).abs().max()))
            if not (torch.equal(got, want) and torch.equal(again, got)
                    and got.is_contiguous(memory_format=fmt)):
                raise AssertionError(
                    f"occlusion_warp != plain {tag} (exact {exact}, {fmt}): max abs err "
                    f"{float((got - want).abs().max())}, repeat equal "
                    f"{torch.equal(again, got)}")
            checks += 1
    b, _, size, _ = imgs.shape
    iota = torch.arange(1, size * size + 1, device=imgs.device, dtype=torch.float32)
    iota = iota.view(1, 1, size, size).expand(b, 1, size, size).contiguous()
    ix, iy, valid = occlusion_indices_plain(coeffs, rect, size)
    want_idx = torch.where(valid, iy * size + ix + 1, 0).to(torch.float32)
    if not torch.equal(occlusion_warp(iota, coeffs, rect)[:, 0], want_idx):
        raise AssertionError(f"occlusion_warp index map != plain {tag}")
    return checks + 1, err


def sector_bytes(byte_addr):
    """Bytes of the distinct 32-byte sectors that the byte addresses touch."""
    import torch

    return int(torch.unique(byte_addr.reshape(-1) // 32).numel()) * 32


def phase_kernel_occlusion_warp(device):
    """occlusion_warp against occlusion_warp_plain; returns its table row."""
    import numpy as np
    import torch

    from uda_poseestimation_torch.ops.occlusion_warp import (
        occlusion_indices_plain, occlusion_warp, occlusion_warp_plain)
    from uda_poseestimation_torch.ops.warp_gather import warp_gather

    b, size = MAIN_B, 256
    checks, max_err = 0, 0.0

    def check(*args, **kwargs):
        nonlocal checks, max_err
        n, err = _check_occlusion_warp(*args, **kwargs)
        checks, max_err = checks + n, max(max_err, err)

    for seed, ties in ((0, False), (1, True), (2, False), (3, True)):
        check(*warp_inputs(seed, b, size, ties, device), f"(seed {seed})")
    # the card tests' shapes: every tile geometry, batch 1 and 33, one to
    # five channels (two chunks), each layout once with one ``exact`` in
    # turn; out-of-range stage values
    rng = np.random.RandomState(5)
    for i, (s, n, c) in enumerate((s, n, c) for s in (2, 16, 64, 256, 512) for n in (1, 33)
                                  for c in (1, 2, 3, 4, 5)):
        imgs, coeffs, rect = warp_inputs(100 + i, n, s, s == 64, device)
        imgs = torch.from_numpy(rng.rand(n, c, s, s).astype(np.float32)).to(device)
        check(imgs, coeffs, rect, f"at {(n, c, s, s)}", exacts=(bool(i % 2),))
    for s in (16, 64):
        imgs, coeffs, rect = warp_inputs(200 + s, 6, s, False, device)
        check(imgs, *extreme_coeffs(coeffs, rect), f"with extreme coefficients at {s}")

    # timing at the main path's call: channels_last f32 input, exact=False
    imgs, coeffs, rect = warp_inputs(4, b, size, False, device)
    x = imgs.contiguous(memory_format=torch.channels_last)
    flush = torch.empty(128 * 2**20 // 4, device=device)  # > the 50 MB L2
    times = {}
    for exact in (False, True):
        times[exact] = (
            cuda_ms(lambda: occlusion_warp(x, coeffs, rect, exact=exact), 50, flush),
            cuda_ms(lambda: occlusion_warp_plain(x, coeffs, rect, exact=exact), 10,
                    flush))
    # the gather half alone: the same call's index maps through warp_gather
    # over the NCHW copy of the images, and torch.gather on them
    ix, iy, valid = occlusion_indices_plain(coeffs, rect, size)
    c = x.shape[1]
    src = torch.where(valid, iy * size + ix, 0).reshape(b, 1, size * size)
    nchw = imgs.contiguous()
    maps = [t.reshape(b, size * size) for t in (ix.int(), iy.int(), valid)]
    if not torch.equal(warp_gather(nchw, *maps, exact=False),
                       occlusion_warp_plain(nchw, coeffs, rect, exact=False)):
        raise AssertionError("warp_gather on occlusion_warp's index maps != plain")
    gather_ms = cuda_ms(lambda: warp_gather(nchw, *maps, exact=False), 50, flush)
    index = src.expand(b, c, size * size)
    torch_gather_ms = cuda_ms(lambda: nchw.view(b, c, -1).gather(2, index), 50, flush)
    # the bytes this run's inputs need: each distinct valid source pixel read
    # once (C floats), the output written once, the coefficients and rects;
    # and the sectors they lie in (channels_last: C floats a pixel)
    src = torch.where(valid, iy * size + ix, -1)
    distinct = sum(int(torch.unique(src[i]).numel()) - int(bool((src[i] < 0).any()))
                   for i in range(b))
    small = coeffs.numel() * 4 + rect.numel() * 4
    n_bytes = distinct * c * 4 + x.numel() * 4 + small
    first = (torch.arange(b, device=device).view(b, 1, 1) * size * size + src) * c
    addr = (first[valid][:, None] + torch.arange(c, device=device)) * 4
    n_sector_bytes = sector_bytes(addr) + x.numel() * 4 + small
    n_flops = b * size * size * WARP_FLOPS_PER_PIXEL
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    flops_ms = n_flops / F32_FLOPS * 1e3
    row = {
        "name": "occlusion_warp", "route": "cuda",
        "source": "uda_poseestimation_torch/csrc/occlusion_warp.cu",
        "replaces": "uda_poseestimation_tpu/ops/pallas_warp.py:145",
        "launches": None, "max_abs_err": max_err,
        "ms": times[False][0], "plain_ms": times[False][1],
        "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": None,
        "gather_only_ms": gather_ms, "torch_gather_ms": torch_gather_ms,
        "sector_bytes": n_sector_bytes,
    }
    emit({"phase": "kernel", "name": "occlusion_warp", "checks_equal": checks,
          "max_abs_err": max_err, "shape": list(x.shape),
          "ms_exact_false": times[False][0], "plain_ms_exact_false": times[False][1],
          "ms_exact_true": times[True][0], "plain_ms_exact_true": times[True][1],
          "gather_only_ms": gather_ms, "torch_gather_ms": torch_gather_ms,
          "gather_only": "warp_gather (and torch.gather) on this call's index maps, "
                         "NCHW copy of the images, exact=False (torch.gather: f32)",
          "bytes": n_bytes, "sector_bytes": n_sector_bytes,
          "sector_bound_ms": n_sector_bytes / HBM_BYTES_PER_S * 1e3,
          "flops": n_flops, "bound_ms": row["bound_ms"],
          "library": "none: no single PyTorch call computes the staged-rounding chain"})
    return row


def _gemm_bound(m, k, n, elt, peak):
    """(bound ms, bytes, flops) of one matmul_stats call: x, w and y once,
    s1 and s2 (f32); 2MKN operations at ``peak``."""
    n_bytes = (m * k + n * k + m * n) * elt + 8 * n
    n_flops = 2 * m * k * n
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / peak) * 1e3, n_bytes, n_flops


def _check_matmul_stats(x, w, tag, variant=None):
    """The matmul_stats kernel (``_plan``'s variant, or ``variant``) against
    matmul_stats_plain on the card. y: within one bf16 ulp (bf16 only) plus
    twice the f32 summation bound K * 2^-24 * sum|x||w| (the two GEMMs sum
    in other orders; where a sum cancels to near zero, its f32 error exceeds
    a bf16 ulp of the result); s1/s2: within 1e-5 of the magnitude sums of
    the f64 sums of the kernel's own y (the kernel adds at most ~160 f32
    values in a chain); a second call equal bit for bit. Returns [variant,
    max abs error of y, outputs beyond one bf16 ulp, the largest error /
    bound]."""
    import torch

    from uda_poseestimation_torch.ops.bn_fuse import (_matmul_stats_cuda, matmul_stats,
                                                      matmul_stats_plain)

    before = dict(matmul_stats.launches_by_variant)
    y, s1, s2 = _matmul_stats_cuda(x, w, x.dtype, variant)
    ran = [v for v, c in matmul_stats.launches_by_variant.items() if c != before[v]]
    again = _matmul_stats_cuda(x, w, x.dtype, variant)
    yp, _, _ = matmul_stats_plain(x, w, x.dtype)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((y, s1, s2), again)):
        raise AssertionError(f"matmul_stats {ran} does not repeat bit for bit {tag}")
    k = x.shape[1]
    y, yp = y.float(), yp.float()
    err = (y - yp).abs()
    bound = 2 * k * 2.0 ** -24 * (x.float().abs() @ w.float().abs().t())
    beyond_ulp = 0
    if x.dtype == torch.bfloat16:
        # a bf16 ulp of v is 2^-7 of the power of two at or below |v|
        big = torch.maximum(y.abs(), yp.abs())
        ulp = torch.exp2(torch.floor(torch.log2(big.clamp_min(1e-30)))) * 2.0 ** -7
        beyond_ulp = int((err > ulp).sum())
        bound += ulp
    if not bool((err <= bound).all()):
        raise AssertionError(f"matmul_stats {ran} y != plain {tag}: max abs err "
                             f"{float(err.max())}, worst err/bound "
                             f"{float((err / bound).max())}")
    y64 = y.double()
    for name, got, want, mag in (("s1", s1, y64.sum(0), y64.abs().sum(0)),
                                 ("s2", s2, (y64 * y64).sum(0), (y64 * y64).sum(0))):
        if not bool(((got.double() - want).abs() <= 1e-5 * mag).all()):
            raise AssertionError(f"matmul_stats {ran} {name} != sum of its y {tag}: "
                                 f"max abs err {float((got.double() - want).abs().max())}")
    return [ran[0], float(err.max()), beyond_ulp, float((err / bound).max())]


def host_us(fn, calls=200):
    """Median host wall time of one call of ``fn`` (µs), not synchronized:
    what the caller's thread spends to enqueue it."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def phase_kernel_matmul_stats(device, shapes):
    """matmul_stats against matmul_stats_plain at the fused path's shapes
    (bf16) and at f32, ragged, unaligned and small-grid ones (each also
    repeated bit for bit), then per-shape times of the planned kernel, of
    the mma.sync variant at the same shape, of the plain version and of
    cuBLAS, and the host time of one call; returns its table row, whose
    times are per launch: the mean over the calls of one train-mode
    forward, each shape weighted by its calls. The phase line also gives
    their sums over the forward."""
    import torch

    from uda_poseestimation_torch.ops.bn_fuse import (_matmul_stats_cuda, kernel_plan,
                                                      matmul_stats, matmul_stats_plain)

    gen = torch.Generator(device=device).manual_seed(0)

    def operands(m, k, n, dtype):
        x = torch.randn(m, k, device=device, generator=gen).to(dtype)
        w = (torch.randn(n, k, device=device, generator=gen) / k ** 0.5).to(dtype)
        return x, w

    max_err = 0.0
    checks = []
    # f32 (simt); bf16 K % 8 != 0 and N % 8 != 0 (mma_sync); ragged M, N, K
    # and a long K on grids under one wave (tma); N < 64 (tma, BN 64); an
    # operand 16-byte unaligned (mma_sync); the mma_sync variant at a
    # main-path shape
    extra = [((200, 70, 130), torch.float32, None), ((1000, 24, 200), torch.float32, None),
             ((8192, 1024, 256), torch.float32, None),
             ((2048, 512, 2048), torch.float32, None),
             ((200, 70, 130), torch.bfloat16, None), ((77, 64, 33), torch.bfloat16, None),
             ((1000, 72, 200), torch.bfloat16, None), ((256, 4096, 256), torch.bfloat16, None),
             ((77, 64, 40), torch.bfloat16, None), ((1000, 64, 136), torch.bfloat16, "offset"),
             ((8192, 1024, 256), torch.bfloat16, "mma_sync")]
    for shape, dtype, how in [(s, torch.bfloat16, None) for s in sorted(shapes)] + extra:
        x, w = operands(*shape, dtype)
        if how == "offset":  # x starts 8 bytes past an aligned address
            x = torch.empty(x.numel() + 4, dtype=dtype, device=device)[4:].view_as(x).copy_(x)
        check = _check_matmul_stats(x, w, f"at {shape} {dtype} {how or ''}",
                                    "mma_sync" if how == "mma_sync" else None)
        checks.append([*shape, str(dtype).split(".")[1], *check])
        max_err = max(max_err, check[1])

    flush = torch.empty(128 * 2**20 // 4, device=device)  # > the 50 MB L2
    per_shape = []
    total = collections.Counter()
    for shape in sorted(shapes):
        x, w = operands(*shape, torch.bfloat16)
        plan = kernel_plan(x, w)
        ms = cuda_ms(lambda: matmul_stats(x, w), 20, flush)
        mma_ms = cuda_ms(lambda: _matmul_stats_cuda(x, w, torch.bfloat16, "mma_sync"), 20,
                         flush)
        plain_ms = cuda_ms(lambda: matmul_stats_plain(x, w, torch.bfloat16), 5, flush)
        lib_ms = cuda_ms(lambda: torch.matmul(x, w.t()), 20, flush)
        bound_ms, n_bytes, n_flops = _gemm_bound(*shape, 2, BF16_FLOPS)
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        calls = shapes[shape]
        per_shape.append({"mkn": list(shape), "calls": calls, "plan": plan._asdict(),
                          "ms": ms, "mma_sync_ms": mma_ms, "plain_ms": plain_ms,
                          "library_ms": lib_ms, "bound_ms": bound_ms,
                          "bound_by": "bytes" if bytes_ms >= bound_ms else "operations",
                          "x_bound": ms / bound_ms, "gbps": n_bytes / ms * 1e-6,
                          "hbm_share": n_bytes / ms * 1e3 / HBM_BYTES_PER_S,
                          "tflops": n_flops / ms * 1e-9,
                          "bf16_peak_share": n_flops / ms * 1e3 / BF16_FLOPS})
        total["ms"] += calls * ms
        total["mma_sync_ms"] += calls * mma_ms
        total["plain_ms"] += calls * plain_ms
        total["library_ms"] += calls * lib_ms
        total["bound_ms"] += calls * bound_ms
        total["bytes_bound_ms"] += calls * bound_ms * (bytes_ms >= bound_ms)

    # host time of one call at the commonest shape, without synchronizing
    x, w = operands(8192, 256, 1024, torch.bfloat16)
    host = {"mkn": [8192, 256, 1024], "calls": 200,
            "matmul_stats_us": host_us(lambda: matmul_stats(x, w)),
            "tma_us": host_us(lambda: _matmul_stats_cuda(x, w, torch.bfloat16)),
            "mma_sync_us": host_us(
                lambda: _matmul_stats_cuda(x, w, torch.bfloat16, "mma_sync"))}

    calls = sum(shapes.values())
    row = {
        "name": "matmul_stats", "route": "cuda",
        "source": "uda_poseestimation_torch/csrc/matmul_stats.cu",
        "replaces": "uda_poseestimation_tpu/ops/bn_fuse.py:84",
        "launches": None, "max_abs_err": max_err,
        "ms": total["ms"] / calls, "plain_ms": total["plain_ms"] / calls,
        "bound_ms": total["bound_ms"] / calls,
        "bound_by": ("bytes" if total["bytes_bound_ms"] >= total["bound_ms"] / 2
                     else "operations"),
        "library_ms": total["library_ms"] / calls,
    }
    emit({"phase": "kernel", "name": "matmul_stats",
          "checks": "m, k, n, dtype, variant, max abs err of y, outputs beyond one bf16 "
                    "ulp, largest err / bound (each call also repeated bit for bit)",
          "check_results": checks,
          "max_abs_err": max_err, "calls_per_forward": calls,
          "ms_per_forward": total["ms"], "mma_sync_ms_per_forward": total["mma_sync_ms"],
          "plain_ms_per_forward": total["plain_ms"],
          "library_ms_per_forward": total["library_ms"],
          "bound_ms_per_forward": total["bound_ms"],
          "bytes_bound_ms_per_forward": total["bytes_bound_ms"],
          "ms_per_launch": row["ms"], "mma_sync_ms_per_launch": total["mma_sync_ms"] / calls,
          "bound_ms_per_launch": row["bound_ms"],
          "faster_than_mma_sync_at_every_shape": all(r["ms"] < r["mma_sync_ms"]
                                                     for r in per_shape),
          "library": "torch.matmul of the same bf16 operands (cuBLAS), y only",
          "host": host, "per_shape": per_shape})
    return row


def heatmap_indices(b, size, seed, device):
    """The heatmap reconstruction's nearest index maps: the translate ->
    rotate/scale -> shear chain of inverse_warp_heatmaps at ``size`` (ratio
    4) from aug_params (bench.py's recipe), through compose_nearest_indices;
    int32 ix, iy (B, size*size) and the mask."""
    import numpy as np
    import torch

    from uda_poseestimation_torch.ops.affine import (_grid, chain_coeffs,
                                                     compose_nearest_indices)

    angle, tx, ty, shx, shy, scale = torch.from_numpy(
        aug_params(np.random.RandomState(seed), b, False)).unbind(-1)
    coeffs = chain_coeffs(angle, tx / 4.0, ty / 4.0, shx, shy, scale)
    ys, xs = _grid(size, size)
    fx, fy, valid = compose_nearest_indices(
        coeffs, xs.expand(b, size, size), ys.expand(b, size, size),
        torch.ones((b, size, size), dtype=torch.bool), size, size)
    half = (size - 1) / 2.0
    return [t.reshape(b, size * size).to(device)
            for t in ((fx + half).to(torch.int32), (fy + half).to(torch.int32), valid)]


def _gather_bytes(hms, ix, iy, valid):
    """(bytes, sector bytes) a warp_gather call needs: each distinct in-map
    source pixel of a valid output read once (K floats), or the distinct
    32-byte sectors those reads touch; the indices, mask and output once."""
    import torch

    b, k, h, w = hms.shape
    inside = valid & (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    src = torch.where(inside, iy * w + ix, 0).long()
    distinct = sum(int(torch.unique(src[i][inside[i]]).numel()) for i in range(b))
    dense = b * h * w * (4 + 4 + 1) + hms.numel() * 4
    plane = (torch.arange(b, device=hms.device).view(b, 1) * k) * h * w
    first = (plane + src)[inside]
    addr = (first[:, None] + torch.arange(k, device=hms.device) * h * w) * 4
    return distinct * k * 4 + dense, sector_bytes(addr) + dense


def _check_warp_gather(hms, ix, iy, valid, tag):
    """warp_gather against warp_gather_plain on the card: both ``exact``, ix
    also 4 bytes off its 16-byte alignment (scalar loads and stores), a
    second call equal bit for bit. Returns the number of comparisons and the
    largest absolute error seen."""
    import torch

    from uda_poseestimation_torch.ops.warp_gather import warp_gather, warp_gather_plain

    shifted = torch.empty(ix.numel() + 1, dtype=torch.int32, device=ix.device)[1:]
    checks, err = 0, 0.0
    for idx in (ix, shifted.view_as(ix).copy_(ix)):
        for exact in (True, False):
            got = warp_gather(hms, idx, iy, valid, exact=exact)
            again = warp_gather(hms, idx, iy, valid, exact=exact)
            want = warp_gather_plain(hms, idx, iy, valid, exact=exact)
            torch.cuda.synchronize()
            err = max(err, float((got - want).abs().max()))
            if not (torch.equal(got, want) and torch.equal(again, got)):
                raise AssertionError(
                    f"warp_gather != plain {tag} (exact {exact}, ix offset "
                    f"{idx.data_ptr() % 16}): max abs err "
                    f"{float((got - want).abs().max())}, repeat equal "
                    f"{torch.equal(again, got)}")
            checks += 1
    return checks, err


def phase_kernel_warp_gather(device):
    """warp_gather against warp_gather_plain at the heatmap warp's shape and
    at the card tests' edge shapes; times on random indices
    (the table row) and on the heatmap reconstruction's index maps; returns
    its table row."""
    import torch

    from uda_poseestimation_torch.ops.warp_gather import warp_gather, warp_gather_plain

    b, k, h, w = MAIN_B, MAIN_K, 64, 64
    gen = torch.Generator(device=device).manual_seed(0)

    def random_indices(b, k, h, w):
        # mostly in the map, some just outside each side, ~10% masked off
        hms = torch.randn(b, k, h, w, device=device, generator=gen)
        ix = torch.randint(-2, w + 2, (b, h * w), device=device, generator=gen,
                           dtype=torch.int32)
        iy = torch.randint(-2, h + 2, (b, h * w), device=device, generator=gen,
                           dtype=torch.int32)
        return hms, ix, iy, torch.rand(b, h * w, device=device, generator=gen) > 0.1

    results = [_check_warp_gather(*random_indices(*shape), f"at {shape}")
               for shape in ((1, 1, 1, 1), (3, 5, 17, 23), (32, 21, 64, 64),
                             (2, 33, 128, 128))]
    hms, ix, iy, valid = random_indices(b, k, h, w)
    heat = heatmap_indices(b, h, 0, device)
    results.append(_check_warp_gather(hms, *heat, "on the heatmap index maps"))
    checks = sum(n for n, _ in results)
    max_err = max(err for _, err in results)

    flush = torch.empty(128 * 2**20 // 4, device=device)
    times = {exact: (cuda_ms(lambda: warp_gather(hms, ix, iy, valid, exact=exact), 50,
                             flush),
                     cuda_ms(lambda: warp_gather_plain(hms, ix, iy, valid, exact=exact), 10,
                             flush))
             for exact in (True, False)}
    inside = valid & (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    index = torch.where(inside, iy * w + ix, 0).long()[:, None].expand(b, k, h * w)
    lib_ms = cuda_ms(lambda: hms.view(b, k, h * w).gather(2, index), 50, flush)
    n_bytes, n_sector_bytes = _gather_bytes(hms, ix, iy, valid)
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    # the heatmap reconstruction's index maps: an affine map's locality
    heat_ms = cuda_ms(lambda: warp_gather(hms, *heat), 50, flush)
    heat_plain_ms = cuda_ms(lambda: warp_gather_plain(hms, *heat), 10, flush)
    heat_bytes, heat_sector_bytes = _gather_bytes(hms, *heat)
    row = {
        "name": "warp_gather", "route": "cuda",
        "source": "uda_poseestimation_torch/csrc/warp_gather.cu",
        "replaces": "uda_poseestimation_tpu/ops/pallas_warp.py:228",
        "launches": 0, "max_abs_err": max_err,
        "ms": times[True][0], "plain_ms": times[True][1], "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": lib_ms, "sector_bytes": n_sector_bytes,
        "heatmap_ms": heat_ms, "heatmap_bound_ms": heat_bytes / HBM_BYTES_PER_S * 1e3,
    }
    emit({"phase": "kernel", "name": "warp_gather", "checks_equal": checks,
          "max_abs_err": max_err, "shape": [b, k, h, w],
          "random": {"ms_exact_true": times[True][0], "plain_ms_exact_true": times[True][1],
                     "ms_exact_false": times[False][0],
                     "plain_ms_exact_false": times[False][1],
                     "library_ms": lib_ms, "bytes": n_bytes, "bound_ms": bound_ms,
                     "sector_bytes": n_sector_bytes,
                     "sector_bound_ms": n_sector_bytes / HBM_BYTES_PER_S * 1e3},
          "heatmap": {"ms": heat_ms, "plain_ms": heat_plain_ms,
                      "bytes": heat_bytes, "bound_ms": row["heatmap_bound_ms"],
                      "sector_bytes": heat_sector_bytes,
                      "sector_bound_ms": heat_sector_bytes / HBM_BYTES_PER_S * 1e3},
          "library": "torch.gather on the flattened maps with precomputed in-map "
                     "indices, no mask"})
    return row


def small_models(seed, fuse_bn=False):
    """Tiny PoseResNet + StyleNet with random weights from ``seed``; the
    deconv/head kernels and the decoder's last kernel are scaled up from
    their tiny init so heatmaps and styled images are not flat (the
    comparison is ill-conditioned otherwise)."""
    import torch

    from uda_poseestimation_torch.models import Bottleneck, PoseResNet, ResNet, StyleNet

    model = PoseResNet(ResNet(Bottleneck, (1, 1, 1, 1), fuse_bn=fuse_bn), MAIN_K)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    style = StyleNet()
    style.reset_parameters(torch.Generator().manual_seed(seed + 1))
    with torch.no_grad():
        for i in (0, 3, 6):
            model.upsampling[i].weight.mul_(30.0)
        model.head.weight.mul_(100.0)
        style.decoder[28].weight.mul_(1000.0)
    return model, style


def synthetic_batch(rng, b, kv, size, hm_size, num_kpts):
    """bench.py's synthetic batch recipe (bench.py:134-150)."""
    import numpy as np

    from uda_poseestimation_torch.ops import generate_target_batch

    kp = rng.uniform(20 * size / 256, 230 * size / 256,
                     size=(b, num_kpts, 2)).astype(np.float32)
    target, weight = generate_target_batch(kp, np.ones((b, num_kpts), np.float32),
                                           (hm_size, hm_size), 2.0, (size, size))
    aug = aug_params(rng, b, ties=False)
    return {
        "image_s": rng.rand(b, size, size, 3).astype(np.float32),
        "target_s": target.numpy(), "weight_s": weight.numpy(),
        "image_t_stu": rng.rand(b, size, size, 3).astype(np.float32),
        "images_t_tea": rng.rand(kv, b, size, size, 3).astype(np.float32),
        "aug_param_stu": aug, "aug_params_tea": np.stack([aug] * kv),
    }


def _rel_max(got, want):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def _rel_norm(got, want):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).norm()) / max(float(want.norm()), 1e-30)


def phase_parity(device, fuse_bn=False):
    """One f32 adapt step at small width on the card (through the kernels)
    and on the CPU (through the plain versions), same everything; with
    ``fuse_bn`` the models take the fused 1x1-conv + statistics path
    (matmul_stats's f32 FFMA kernel on the card).

    Tolerances: forwards 1e-3 of the largest magnitude (cuDNN and the CPU
    sum f32 convolutions in other orders; BatchNorm over 16 values a channel
    amplifies that); gradients 5e-2 in norm per tensor: a tiny model's
    train-mode gradients are not smooth at f32 resolution (ReLU and
    max-pool kinks): a 1e-6 relative change of the input moves them ~1% in
    norm even in float64 (tests/grad_precision_probe.py), so two f32
    implementations agree only that far; integer
    decisions (kth-value mask, occlusion gate and rectangles) equal; the
    occluded view may differ in 0.1% of its pixels (the warp coefficients'
    cos/tan may differ by an ulp between the card and the CPU). The fused
    path keeps these tolerances: its f32 kernel sums in another order than
    the CPU's GEMM, as cuDNN does, and the one-pass variance of the
    fusion adds no loss of precision at these activation magnitudes.
    """
    import numpy as np
    import torch

    from uda_poseestimation_torch.models.resnet import fused_gemm_shapes
    from uda_poseestimation_torch.ops.bn_fuse import matmul_stats
    from uda_poseestimation_torch.parallel import StepConfig, create_state, make_adapt_step

    cfg = StepConfig(image_size=64, heatmap_size=16, k=1, use_sgd=True,
                     occlude_rate=0.5, occlude_thresh=-1.0, occlude_size=6,
                     aux_outputs=True)
    model, style = small_models(0, fuse_bn)
    rng = np.random.RandomState(1)
    batch = synthetic_batch(rng, 4, 1, 64, 16, MAIN_K)
    draws = {"u": np.array([0.2, 0.7, 0.4, 0.9], np.float32),
             "gumbel": -np.log(-np.log(rng.rand(4, MAIN_K))).astype(np.float32),
             "u1": rng.rand(4).astype(np.float32), "u2": rng.rand(4).astype(np.float32)}
    out = []
    matmul_stats.launches = 0
    for dev in (device, torch.device("cpu")):
        state = create_state(copy.deepcopy(model), cfg, seed=None, device=dev)
        step = make_adapt_step(cfg, style_model=copy.deepcopy(style).to(dev), device=dev)
        _, metrics, _ = step(state, batch, 0.01, do_s2t=True, alpha_s2t=0.7,
                             do_t2s=True, alpha_t2s=0.3,
                             occlusion_draws={k: torch.from_numpy(v).to(dev)
                                              for k, v in draws.items()})
        out.append(metrics)
    gpu, cpu = out
    launched = matmul_stats.launches
    errs = {}
    for name in ("x_s_styled", "x_t_teas_styled", "y_t_tea_recon", "y_t_tea_rect",
                 "activates", "mask_thresh", "y_t_stu_recon"):
        errs[name] = _rel_max(gpu["aux"][name], cpu["aux"][name])
    for name in ("loss_all", "loss_s", "loss_c"):
        errs[name] = _rel_max(gpu[name], cpu[name])
    grad_err = max(_rel_norm(gpu["aux"]["grads"][n], g)
                   for n, g in cpu["aux"]["grads"].items())
    equal = {name: torch.equal(gpu["aux"][name].cpu(), cpu["aux"][name])
             for name in ("tea_mask", "occlude", "occlusion_rect")}
    moved = float((gpu["aux"]["x_t_stu_final"].cpu() != cpu["aux"]["x_t_stu_final"])
                  .float().mean())
    emit({"phase": "parity", "fuse_bn": fuse_bn, "matmul_stats_launches": launched,
          "rel_max_err": errs, "grad_rel_norm_err": grad_err,
          "occluded_pixels_moved": moved,
          "occluded_samples": int(cpu["aux"]["occlude"].sum()),
          "integer_outputs_equal": equal})
    bad = {k: v for k, v in errs.items() if not v <= 1e-3}
    if bad or not all(equal.values()) or not grad_err <= 5e-2 or not moved <= 1e-3:
        raise AssertionError(f"card vs CPU beyond tolerance: {bad}, {equal}, "
                             f"grads {grad_err}, occluded pixels moved {moved}")
    # three train-mode forwards (teacher, two student) on the card
    want = 3 * sum(fused_gemm_shapes(model.backbone, 4, 64).values()) * fuse_bn
    if launched != want:
        raise AssertionError(f"matmul_stats launched {launched} times in the parity "
                             f"step, not {want}")


def _counters():
    """Every kernel wrapper of the port, by name (each has ``launches``)."""
    from uda_poseestimation_torch.ops.bn_fuse import matmul_stats
    from uda_poseestimation_torch.ops.occlusion_warp import occlusion_warp
    from uda_poseestimation_torch.ops.warp_gather import warp_gather

    return {"occlusion_warp": occlusion_warp, "matmul_stats": matmul_stats,
            "warp_gather": warp_gather}


def phase_main(device, profile_dir, fuse_bn=False, unfused=None):
    """A main path at full width: the default one, or with ``fuse_bn`` the
    UDA_BN_FUSE=1 training path, whose A/B against ``unfused`` (the default
    path's result) is printed beside it. Returns its result, launches
    included."""
    import numpy as np
    import torch

    from uda_poseestimation_torch.models import StyleNet, pose_resnet101
    from uda_poseestimation_torch.models.resnet import fused_gemm_shapes
    from uda_poseestimation_torch.ops.bn_fuse import VARIANTS, matmul_stats
    from uda_poseestimation_torch.parallel import (
        StepConfig, create_state, make_adapt_step, make_eval_step, make_pretrain_step)

    t0 = time.perf_counter()
    cfg = StepConfig(k=MAIN_KV, gather_exact=False, style_io_dtype="bfloat16")
    model = pose_resnet101(num_keypoints=MAIN_K, dtype=torch.bfloat16, fuse_bn=fuse_bn)
    state = create_state(model, cfg, seed=0, device=device)
    style = StyleNet()
    style.reset_parameters(torch.Generator().manual_seed(1))
    style.to(device=device, dtype=torch.bfloat16)  # frozen: bf16 storage
    host = synthetic_batch(np.random.RandomState(0), MAIN_B, MAIN_KV, 256, 64, MAIN_K)
    batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    pre_batch = {k: batch[k] for k in ("image_s", "target_s", "weight_s")}
    pre_batch["image_t_style"] = batch["image_t_stu"]
    adapt = make_adapt_step(cfg, style_model=style, device=device)
    pretrain = make_pretrain_step(cfg, style_model=style, device=device)
    evaluate = make_eval_step(device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def adapt_step():
        return adapt(state, batch, 1e-4, do_s2t=True, alpha_s2t=0.5, do_t2s=True,
                     alpha_t2s=0.5, generator=gen)

    torch.cuda.reset_peak_memory_stats(device)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    matmul_stats.launches_by_variant = dict.fromkeys(VARIANTS, 0)

    def counted(fn, *args, **kwargs):
        """``fn``'s result and the launches each kernel made in it."""
        before = {name: c.launches for name, c in counters.items()}
        out = fn(*args, **kwargs)
        return out, {name: c.launches - before[name] for name, c in counters.items()}

    losses, step_launches = [], []
    for _ in range(2):  # warm-up
        (_, metrics, _), launched = counted(adapt_step)
        losses.append(metrics)
        step_launches.append(launched)
    torch.cuda.synchronize()
    n_timed = 5
    t0 = time.perf_counter()
    for _ in range(n_timed):
        (_, metrics, _), launched = counted(adapt_step)
        losses.append(metrics)
        step_launches.append(launched)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n_timed
    if profile_dir:
        _, launched = counted(
            profile_adapt_step, adapt_step, profile_dir, step_s * 1e3,
            "profile_adapt_step_bn_fuse" if fuse_bn else "profile_adapt_step")
        step_launches.append(launched)
    adapt_steps = len(step_launches)
    (_, pre_metrics, _), pre_launches = counted(pretrain, state, pre_batch, 1e-4,
                                                do_s2t=True, alpha=0.5)
    (y, eval_loss, acc), eval_launches = counted(
        evaluate, state.student, batch["image_s"], batch["target_s"], batch["weight_s"])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated(device)

    values = [float(m[k]) for m in losses for k in ("loss_all", "loss_s", "loss_c")]
    values += [float(pre_metrics["loss_all"]), float(eval_loss)]
    if not all(np.isfinite(values)):
        raise AssertionError(f"non-finite loss on the main path: {values}")
    if tuple(y.shape) != (MAIN_B, MAIN_K, 64, 64) or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"eval heatmaps: shape {tuple(y.shape)}, finite "
                             f"{bool(torch.isfinite(y).all())}")
    # launches the path must make: occlusion_warp once per adapt step; the
    # fused GEMM in each train-mode forward (k teacher + 2 student per adapt
    # step, 1 per pretrain step, none in eval); each step is counted alone
    per_forward = sum(fused_gemm_shapes(model.backbone, MAIN_B, 256).values()) * fuse_bn
    want_step = {"occlusion_warp": 1, "matmul_stats": per_forward * (MAIN_KV + 2),
                 "warp_gather": 0}
    want_pre = {"occlusion_warp": 0, "matmul_stats": per_forward, "warp_gather": 0}
    want_eval = dict.fromkeys(counters, 0)
    want = {name: adapt_steps * want_step[name] + want_pre[name] for name in counters}
    if (any(launched != want_step for launched in step_launches)
            or pre_launches != want_pre or eval_launches != want_eval or launches != want):
        raise AssertionError(
            f"launches per adapt step {step_launches}, pretrain step {pre_launches}, "
            f"eval step {eval_launches}, in all {launches}; the path needs "
            f"{want_step}, {want_pre}, {want_eval}, in all {want}")
    # every fused GEMM of the path is bf16 with K and N multiples of 8: tma
    by_variant = dict(matmul_stats.launches_by_variant)
    if by_variant != dict(dict.fromkeys(VARIANTS, 0), tma=want["matmul_stats"]):
        raise AssertionError(f"matmul_stats launches by variant {by_variant}: the path "
                             f"needs all {want['matmul_stats']} to be tma")
    result = {"phase": "main_bn_fuse" if fuse_bn else "main", "model": "pose_resnet101",
              "fuse_bn": fuse_bn, "num_keypoints": MAIN_K,
              "batch": MAIN_B, "image": 256, "heatmap": 64, "k": MAIN_KV,
              "style": "s2t+t2s", "occlusion": True, "dtype": "bf16 autocast, bf16 style",
              "setup_s": setup_s, "adapt_steps": adapt_steps, "ms_per_step": step_s * 1e3,
              "img_per_s": MAIN_B / step_s, "max_memory_allocated": peak,
              "loss_all_last": float(losses[-1]["loss_all"]),
              "pretrain_loss": float(pre_metrics["loss_all"]),
              "eval_loss": float(eval_loss), "launches": launches,
              "launches_per_adapt_step": step_launches[-1],
              "launches_pretrain_step": pre_launches, "launches_eval_step": eval_launches,
              "matmul_stats_launches_by_variant": by_variant,
              "card": torch.cuda.get_device_name(device), "nvidia_smi": nvidia_smi_line()}
    if unfused is not None:
        result["unfused"] = {k: unfused[k] for k in ("ms_per_step", "img_per_s",
                                                     "max_memory_allocated")}
    emit(result)
    return result


def profile_adapt_step(adapt_step, out_dir, step_ms, file_name):
    """Device time by kernel and kernel group over one adapt step
    (torch.profiler), into ``out_dir/file_name.json``; the idle share is taken
    against ``step_ms``, the unprofiled step time, since the profiler slows
    the host."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        adapt_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # kernels only: operator rows and annotated ranges (the optimizer's
        # step) repeat their kernels' device time
        if ev.device_type != DeviceType.CUDA or ev.is_user_annotation:
            continue
        rows.append({"name": ev.key[:100], "calls": ev.count,
                     "device_ms": ev.device_time_total / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    busy_ms = sum(r["device_ms"] for r in rows)
    groups = {}
    for r in rows:
        name = next((g for g, pat in KERNEL_GROUPS if re.search(pat, r["name"], re.I)),
                    "other")
        g = groups.setdefault(name, {"device_ms": 0.0, "calls": 0})
        g["device_ms"] += r["device_ms"]
        g["calls"] += r["calls"]
    summary = {"profiled_wall_ms": wall_ms, "step_ms": step_ms, "device_busy_ms": busy_ms,
               "idle_share": 1.0 - busy_ms / step_ms,
               "kernel_launches": sum(r["calls"] for r in rows),
               "groups": dict(sorted(groups.items(), key=lambda kv: -kv[1]["device_ms"]))}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, file_name + ".json"), "w") as f:
        json.dump(dict(summary, kernels=rows), f, indent=1)
    emit(dict({"phase": "profile", "file": file_name}, **summary, top=rows[:8]))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="also trace one adapt step into DIR")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from uda_poseestimation_torch import _build
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})", file=sys.stderr)
        return 2

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    emit({"phase": "env", "device": torch.cuda.get_device_name(device),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    t0 = time.perf_counter()
    paths = _build.build(*_build.KERNELS)
    for name in _build.KERNELS:
        _build.load(name)
    emit({"phase": "build", "kernels": list(_build.KERNELS),
          "seconds": time.perf_counter() - t0,
          "libraries": [os.path.relpath(p, REPO) for p in paths]})

    from uda_poseestimation_torch.models.resnet import fused_gemm_shapes, resnet101

    shapes = fused_gemm_shapes(resnet101(fuse_bn=True), MAIN_B, 256)
    rows = {"occlusion_warp": phase_kernel_occlusion_warp(device),
            "matmul_stats": phase_kernel_matmul_stats(device, shapes),
            "warp_gather": phase_kernel_warp_gather(device)}
    phase_parity(device)
    phase_parity(device, fuse_bn=True)
    main_run = phase_main(device, args.profile)
    gc.collect()
    torch.cuda.empty_cache()
    fused_run = phase_main(device, args.profile, fuse_bn=True, unfused=main_run)
    # each row's launches are those of the path it lies on (warp_gather: none),
    # in all and in the last measured adapt step
    for name, run in (("occlusion_warp", main_run), ("matmul_stats", fused_run),
                      ("warp_gather", main_run)):
        rows[name]["launches"] = run["launches"][name]
        rows[name]["launches_per_adapt_step"] = run["launches_per_adapt_step"][name]

    emit({"kernels": list(rows.values())})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
