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
6b. bundled --steps-per-dispatch on both main paths (phase_bundled): the
            step bundlers' CUDA-graph replays against unbundled steps in
            turns at BUNDLE_N steps a bundle (ms/step, and with --profile
            the idle share, the trace's kernel counts held against the
            counted launches), one eager step under the sync debug mode
            "error", the launches per replay (occlusion_warp 1 a bundled
            adapt step, matmul_stats 210 fused, 70 a fused pretrain step),
            each of the four gate cases' replay held against an eager step
            (bit-equal occlusion and teacher reconstruction), and a
            checkpoint from the bundled state resumed unbundled and bundled.
6c. device_aug  --device-aug and --decode-cache (phase_device_aug): the
            view builders on the card against the CPU on one b=32 batch of
            256² uint8 canvases from the same uniforms (crop decisions,
            rounded translations, warp indices and target weights equal;
            views within 1e-4 normalized at all but 0.1% of their values);
            the device-aug adapt step, unbundled and bundled, timed in turns
            beside phase main's step (ms/step, host-to-device bytes per
            iteration, the view builder's time, peak memory, occlusion_warp
            once per step and replay; with --profile the idle share and the
            view builder's device time), an eager device-aug adapt and
            pretrain step under the sync debug mode "error"; every gate
            case's replay against the eager step, adapt and pretrain; and the
            CLI on a fake RHD tree of DA_FRAMES frames: DA_ITERS adapt
            iterations with --device-aug --decode-cache 1 at -j 8 and -j 2,
            unbundled and --steps-per-dispatch 4, the same bundled with host
            augmentation, and a --device-aug pretrain epoch with s2t fired
            (Time and Data medians per pass, first-batch wait, the cache's
            counts, which must show every second-pass fetch a hit, and the
            parent's and workers' RSS).
7. trainer_engine  the port's epoch loops (engine.py) on the card with the
            models and flags of phase main, fed by in-memory RHD-shaped
            batches (bench.py's recipe, page-locked): a pretrain epoch (3
            iterations, s2t always on), an adapt epoch (3 iterations, both
            gates always on), a validation over two batches, the last
            partial, and a 10-iteration adapt epoch for the loop's steady
            time, each counted on its own (occlusion_warp once per adapt
            iteration, no kernel elsewhere); the loops' time per iteration
            (between two step calls) and host batch time (first fetch to
            step call) beside phase main's ms/step, and the peak memory;
            then save_checkpoint -> load_checkpoint -> restore_train_state
            into a fresh state, held bit-equal (parameters, BatchNorm
            buffers, Adam state), and one more adapt step from each state
            with equal losses.
8. trainer_cli  when Pillow imports: the port's train_human.main in this
            process on a fake RHD tree (96 training and 16 evaluation frames
            at 320², make_rhd's recipe) with random style weights, at
            pose_resnet101 b=32, 3 iterations an epoch, -j min(8, cpus): a
            pretrain epoch, an adapt epoch, the adapt epoch under
            UDA_BN_FUSE=1 (630 matmul_stats launches, all tma), a pretrain
            and an adapt epoch with --steps-per-dispatch 4, --phase
            test --resume on phase 7's checkpoint, and a 40-iteration adapt
            epoch on the tree lengthened to 40 batches (hard links), long
            enough to drain the workers' prefetched batches; the
            logs' epoch and Source/Target lines finite, the launches of each
            run, the Time and Data per iteration that it prints, and no
            worker process left. Without
            Pillow it prints {"phase": "trainer_cli", "ran": false, ...}.
9. trainer_pairs  the four train_human.py lines of ``script`` (r2h, s2h,
            s2l, f2r) with their own flags through train_human.main in this
            process at the same width, -j as in trainer_cli, one epoch of 3
            iterations: an adapt epoch each and a pretrain epoch for s2h,
            on fake trees in each dataset's layout at its frame size that
            the phase writes (FAKE_TREES); occlusion_warp 3 times an adapt
            run and never in pretraining, finite epoch lines, no worker
            left; one line per run: wall time, dataset construction time,
            first-batch wait, the median Time and Data of iterations 1-2,
            each validation's seconds and items, and the parent's RSS after
            construction and at the end (/proc/self/statm, and getrusage
            for the peak). Needs Pillow and SciPy.
10. decoder  AdaIN decoder pretraining (phase_decoder): the meanstd
            StyleNet's decoder step alone at b=4, 256² (ms/step by CUDA
            events and peak memory with TF32 off and on, TF32's losses
            held against full float32's; the step's FLOPs and bound), one
            step on the card against the CPU at 64², the AdaIN CLI
            (uda_poseestimation_torch.adain.train_human) for 40 iterations
            on the fake RHD and H3D trees (finite log lines, 2 PNGs, the
            checkpoint; seconds per iteration and the loaders' wait), and
            the r2h adapt run of 3 iterations with --decoder-name set to
            that checkpoint (occlusion_warp 3 times).
11. trainer_animals  the two animal lines of ``script`` (train_animal.py,
            train_animal_other.py) through train_animal.main in this
            process at the same width, -j as in trainer_cli, on fake
            synthetic-animal, TigDog and AnimalPose trees that the phase
            writes (ANIMAL_TREES): the train_animal line adapting (3
            iterations), pretraining, bundled with --steps-per-dispatch 4
            (20 iterations on trees of 20 batches a pass,
            ANIMAL_LONG_TREES), and with a decoder that the AdaIN animal
            CLI (uda_poseestimation_torch.adain.train_animal) trains for
            40 iterations first and --decode-cache 1, over 6 iterations;
            the train_animal_other line adapting; and with --device-aug:
            adapting (3 iterations), pretraining bundled (4), adapting
            bundled with --decode-cache 1 over two passes of the
            synthetic set rounded up to whole bundles (8), adapting
            bundled on ANIMAL_LONG_TREES (20), and the
            train_animal_other line adapting (3). occlusion_warp
            once an adapt iteration, eager or replayed, never in
            pretraining or the AdaIN CLI; finite epoch lines with both
            category parts, the AdaIN run's 2 PNGs and checkpoint, no worker
            left; one line per run as in trainer_pairs, each category's
            validation included, and the frame caches' (and the raw
            source's CachedDataset's) hits and bytes; each --device-aug
            run's Time, Data and first-batch wait beside its host-path
            twin's. Before the runs, the animal view builder
            (animal_views_on_card): on the card against the CPU on a small
            batch (integer decisions equal), alone at b=32 (CUDA-event ms,
            host ms, kernels, bytes copied an iteration on both paths), and
            the adapt and pretrain bundlers' replays with the views built
            inside held against eager steps.

Then each phase's seconds, the kernel table ({"kernels": [...]}, with each
kernel's launches on every path), the nvidia-smi line, and the
result line {"ok": true, "device": {...}}. Without CUDA, or without the rest
of the repository beside it, the script fails before printing any result.

``--profile DIR`` also traces one more adapt step of each main path, one
bundle and BUNDLE_N unbundled steps of each of phase bundled's paths and of
phase device_aug's (and its view builder alone), and one
more adapt epoch of phase trainer_engine with torch.profiler and writes the
per-kernel device-time tables to DIR/profile_adapt_step.json,
DIR/profile_adapt_step_bn_fuse.json, DIR/profile_{bundled,unbundled}_{main,
main_bn_fuse}_4_steps.json, DIR/profile_device_aug_{bundled,unbundled}_4_steps.json,
DIR/profile_device_aug_view_builder.json and DIR/profile_trainer_adapt_epoch.json.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import gc
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
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
# the trainer phases' model and sizes (phase main's)
TRAINER_ARCH, MAIN_IMAGE, MAIN_HEATMAP = "pose_resnet101", 256, 64
# steps per bundler call in phase bundled
BUNDLE_N = 4
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
    """Device time by kernel and kernel group over one call of
    ``adapt_step`` (an adapt step, a bundle of them, or an epoch of the
    adapt loop; torch.profiler), into ``out_dir/file_name.json``; the idle
    share is taken against ``step_ms``, the unprofiled time of the same
    work, since the profiler slows the host. Returns the per-kernel rows."""
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
    return rows


def clocked(step, stamps):
    """``step`` with the host time of each call appended to ``stamps``."""
    def call(*args, **kwargs):
        stamps.append(time.perf_counter())
        return step(*args, **kwargs)
    return call


def step_times(step_stamps, fetch_stamps):
    """A training loop's seconds per iteration from its step calls: the
    period between two calls (the one-deep pipeline enqueues step i+1 once
    step i-1 is read back, so in a steady loop this is the iteration's time)
    and the host's batch time, from the iteration's first fetch to its step
    call (the fetch, the batch's assembly and the gate draws). Medians and
    each value."""
    periods = [b - a for a, b in zip(step_stamps, step_stamps[1:])]
    batch = [s - f for s, f in zip(step_stamps, fetch_stamps)]
    return {"period_s_median": statistics.median(periods), "period_s_each": periods,
            "batch_s_median": statistics.median(batch), "batch_s_each": batch}


_METER = re.compile(r"^Epoch: \[\d+\]\[ *\d+/\d+\]\tTime +([\d.]+) \([^)]*\)"
                    r"\tData +([\d.]+) ")


def printed_times(text):
    """Each iteration's Time and Data in seconds, as a training loop of the
    CLI prints them with ``-p 1`` (2 and 1 decimals). Time i runs from step
    i-1's readback to step i's, so the first holds the start-up; Data 0 is
    the wait for the first batches."""
    rows = [tuple(map(float, m.groups())) for m in map(_METER.match, text.splitlines()) if m]
    if not rows:
        return {}
    times, datas = zip(*rows)
    return {"time_s_median": statistics.median(times), "time_s_each": list(times),
            "first_batch_s": datas[0], "data_s_each": list(datas)}


class SyntheticRHD:
    """An endless in-memory stand-in for the RHD training loaders: the
    collated source 4-tuples (``RenderedHandPose``) or target 8-tuples with
    k teacher views (``RenderedHandPose_mt``), from bench.py's synthetic
    recipe (``synthetic_batch``), page-locked as the port's loaders give
    them on a CUDA run. Two distinct batches are made once and cycled, so a
    fetch costs the loop nothing."""

    def __init__(self, target, seed):
        import numpy as np
        import torch

        rng = np.random.RandomState(seed)
        kv = MAIN_KV
        self.items, self.stamps = [], []
        for _ in range(2):
            b = {k: torch.from_numpy(v).pin_memory()
                 for k, v in synthetic_batch(rng, MAIN_B, kv, MAIN_IMAGE, MAIN_HEATMAP,
                                             MAIN_K).items()}
            kp = torch.from_numpy(rng.uniform(20, 230, (MAIN_B, MAIN_K, 2)))
            if target:
                self.items.append((
                    b["image_t_stu"], b["target_s"], b["weight_s"],
                    {"aug_param_stu": b["aug_param_stu"], "keypoint2d_ori": kp},
                    list(b["images_t_tea"].unbind(0)), [b["target_s"]] * kv,
                    [b["weight_s"]] * kv,
                    [{"aug_param_tea": a} for a in b["aug_params_tea"].unbind(0)]))
            else:
                self.items.append((b["image_s"], b["target_s"], b["weight_s"],
                                   {"keypoint2d": kp}))

    def __next__(self):
        self.stamps.append(time.perf_counter())
        return self.items[(len(self.stamps) - 1) % len(self.items)]


def synthetic_val_loader(n, batch_size):
    """A loader of ``n`` evaluation samples (bench.py's recipe) whose last
    batch is partial, over a dataset with the RHD sets' ``num_keypoints`` and
    their 'all' group: the stand-in for the port's RenderedHandPose test
    split, which needs Pillow."""
    import numpy as np
    import torch

    data = synthetic_batch(np.random.RandomState(3), n, 1, MAIN_IMAGE, MAIN_HEATMAP, MAIN_K)

    class ValSet(torch.utils.data.Dataset):
        num_keypoints = MAIN_K

        def __len__(self):
            return n

        def __getitem__(self, i):
            return (data["image_s"][i], data["target_s"][i], data["weight_s"][i],
                    {"index": i})

        @staticmethod
        def group_accuracy(accuracies):
            return {"all": sum(accuracies) / len(accuracies)}

    return torch.utils.data.DataLoader(ValSet(), batch_size=batch_size, pin_memory=True)


def _reset_counts():
    from uda_poseestimation_torch.ops.bn_fuse import VARIANTS, matmul_stats

    for fn in _counters().values():
        fn.launches = 0
    matmul_stats.launches_by_variant = dict.fromkeys(VARIANTS, 0)


def _read_counts():
    return {name: fn.launches for name, fn in _counters().items()}


def _finite_lines(text, prefixes):
    """The lines of ``text`` that start with one of ``prefixes``; raises
    unless there is one and every number in them is finite."""
    import math

    lines = [ln for ln in text.splitlines() if ln.startswith(tuple(prefixes))]
    values = [float(v) for ln in lines for v in re.findall(r"[-+]?(?:\d+\.\d*|nan|inf)"
                                                            r"(?:e[-+]\d+)?", ln)]
    if not lines or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"no finite {prefixes} lines: {lines[:6]}")
    return lines


def _same_state(a, b):
    """Whether two UDAStates hold equal student and teacher parameters and
    buffers and an equal optimizer state, bit for bit."""
    import torch

    for ma, mb in ((a.student, b.student), (a.teacher, b.teacher)):
        sa, sb = ma.state_dict(), mb.state_dict()
        if list(sa) != list(sb) or not all(torch.equal(sa[k], sb[k]) for k in sa):
            return False
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    return (oa["param_groups"] == ob["param_groups"] and oa["state"].keys() == ob["state"].keys()
            and all(torch.equal(torch.as_tensor(v), torch.as_tensor(ob["state"][i][k]))
                    for i, entry in oa["state"].items() for k, v in entry.items()))


def _state_rel_err(a, b):
    """The largest difference between two modules' state dicts, tensor by
    tensor relative to the largest magnitude of ``b``'s tensor."""
    errs = []
    for x, y in zip(a.state_dict().values(), b.state_dict().values()):
        x, y = x.detach().double(), y.detach().double()
        errs.append(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30))
    return max(errs)


def _deterministic():
    """cuDNN's deterministic algorithms and no TF32: two runs of one
    computation then agree bit for bit."""
    import torch

    return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                      allow_tf32=False)


def _held_against_eager(device, state, style, host, view_builder=None, sync_check=False):
    """For each of the four (do_s2t, do_t2s) cases, from one copied state:
    the bundler's graph replay against the unbundled eager step, under
    deterministic cuDNN, with every keypoint taken as confident so that the
    occlusion fires (for the samples whose gate draw passes). The occlusion gates and rectangles, the occluded
    view (the occlusion_warp kernel's output) and the teacher's
    reconstruction must be equal bit for bit; the losses within 1e-6
    relative, and the updated student and teacher (parameters and BatchNorm
    buffers) within 1e-5 of each tensor's largest magnitude. The graph runs
    the eager step's kernels on the same inputs; what may still differ is
    the order of the atomic additions in the backward of the heatmap warp's
    gather, ~1e-7 of a gradient, which Adam's update (~lr = 1e-4 a
    parameter) shrinks further. With ``view_builder`` (--device-aug) ``host``
    is a raw batch and both build their views from the generator, before
    the occlusion draws; with ``sync_check`` the eager steps run under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    import warnings

    import torch

    from uda_poseestimation_torch.parallel import AdaptStepBundler, StepConfig, make_adapt_step

    # every keypoint confident (occlude_thresh -1), so that the occlusion
    # fires and the kernel's output reaches the student's view
    cfg = StepConfig(k=MAIN_KV, gather_exact=False, style_io_dtype="bfloat16",
                     occlude_thresh=-1.0, aux_outputs=True)
    bundler = AdaptStepBundler(cfg, style_model=style, device=device,
                               view_builder=view_builder)
    step = make_adapt_step(cfg, style_model=style, device=device, view_builder=view_builder)
    gen = torch.Generator(device=device).manual_seed(5)
    cases = {}
    with _deterministic(), warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*capturable=True")
        for do_s2t, do_t2s in ((True, True), (True, False), (False, True), (False, False)):
            def bundled(st):
                return bundler(st, [host], 1e-4, [do_s2t], [0.6], [do_t2s], [0.3],
                               generator=gen)

            bundled(state)  # the case's warm-up: eager
            twin = copy.deepcopy(state)
            twin_gen = torch.Generator(device=device)
            twin_gen.set_state(gen.get_state())
            replays = bundler.replays
            _, got, _ = bundled(state)  # captured, then replayed
            if bundler.replays != replays + 1:
                raise AssertionError(f"case {(do_s2t, do_t2s)}: the second call did not "
                                     f"replay a graph")
            with _sync_debug(sync_check):
                _, want, _ = step(twin, host, 1e-4, do_s2t, 0.6, do_t2s, 0.3,
                                  generator=twin_gen)
            equal = {k: bool(torch.equal(got["aux"][k][0], want["aux"][k]))
                     for k in ("occlude", "occlusion_rect", "x_t_stu_final", "y_t_tea_recon",
                               "tea_mask")}
            losses = {k: abs(float(got[k][0]) - float(want[k])) / abs(float(want[k]))
                      for k in ("loss_all", "loss_s", "loss_c")}
            moved = {"student": _state_rel_err(state.student, twin.student),
                     "teacher": _state_rel_err(state.teacher, twin.teacher)}
            cases[f"{do_s2t}/{do_t2s}"] = {
                "bit_equal": equal, "loss_rel_err": losses, "state_rel_err": moved,
                "occluded_samples": int(got["aux"]["occlude"][0].sum())}
            del twin
            if (not all(equal.values()) or max(losses.values()) > 1e-6
                    or max(moved.values()) > 1e-5):
                raise AssertionError(f"graph replay vs eager step, case "
                                     f"{(do_s2t, do_t2s)}: {cases[f'{do_s2t}/{do_t2s}']}")
    if not 0 < sum(c["occluded_samples"] for c in cases.values()) < len(cases) * MAIN_B:
        raise AssertionError(f"the occlusion must fire for some samples only: {cases}")
    return {"cases": cases, "eager_steps": bundler.eager_steps,
            "captures": bundler.captures, "replays": bundler.replays,
            "launches_per_replay": {"/".join(map(str, k[:2])): v
                                    for k, v in bundler.tallies.items()}}


@contextlib.contextmanager
def _sync_debug(on=True):
    """``torch.cuda.set_sync_debug_mode("error")`` inside (when ``on``): a
    host sync raises, as it would break a capture."""
    import torch

    if not on:
        yield
        return
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def phase_bundled(device, work_dir, profile_dir=None):
    """--steps-per-dispatch on the card with phase main's models, flags and
    batch (page-locked on the host, as the loader gives it), unfused and
    fused (UDA_BN_FUSE=1), each on a state of its own beside an unbundled
    twin: one eager adapt and pretrain step under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host sync may remain in
    a step that is captured); then BUNDLE_N-step bundles of AdaptStepBundler
    (both gates on) against unbundled steps, timed in turns (unbundled,
    bundled, bundled, unbundled) for ms/step and, with ``profile_dir``, the
    idle share of one bundle and of BUNDLE_N unbundled steps, with the
    trace's kernel counts held against the counted launches; the counted
    launches (occlusion_warp once per adapt replay, matmul_stats 210 times
    per fused adapt replay, all tma); two bundles of PretrainStepBundler
    with mixed s2t gates (70 matmul_stats launches per fused replay).
    Unfused only: ``_held_against_eager`` for the four gate cases, and a
    checkpoint saved from the bundled (capturable) state, restored into a
    fresh unbundled state, one step from each with equal losses, then a
    bundle from the restored state. Returns each path's bundled launches."""
    import statistics
    import warnings

    import numpy as np
    import torch

    from uda_poseestimation_torch.models import StyleNet, pose_resnet101
    from uda_poseestimation_torch.ops.bn_fuse import VARIANTS, matmul_stats
    from uda_poseestimation_torch.parallel import (AdaptStepBundler, PretrainStepBundler,
                                                   StepConfig, create_state,
                                                   make_adapt_step, make_pretrain_step)
    from uda_poseestimation_torch.utils.checkpoint import (load_checkpoint,
                                                           restore_train_state,
                                                           save_checkpoint)

    t0 = time.perf_counter()
    n = BUNDLE_N
    style = StyleNet()
    style.reset_parameters(torch.Generator().manual_seed(1))
    style.to(device=device, dtype=torch.bfloat16)
    host = {k: torch.from_numpy(v).pin_memory()
            for k, v in synthetic_batch(np.random.RandomState(0), MAIN_B, MAIN_KV, MAIN_IMAGE,
                                        MAIN_HEATMAP, MAIN_K).items()}
    pre_host = {k: host[k] for k in ("image_s", "target_s", "weight_s")}
    pre_host["image_t_style"] = host["image_t_stu"]
    gates = dict(do_s2t=True, alpha_s2t=0.5, do_t2s=True, alpha_t2s=0.5)
    cfg = StepConfig(k=MAIN_KV, gather_exact=False, style_io_dtype="bfloat16")
    paths, launches_by_path = {}, {}
    for fuse_bn in (False, True):
        name = "main_bn_fuse" if fuse_bn else "main"
        p0 = time.perf_counter()

        def new_state(seed=0, fuse_bn=fuse_bn):
            model = pose_resnet101(num_keypoints=MAIN_K, dtype=torch.bfloat16, fuse_bn=fuse_bn)
            return create_state(model, cfg, seed=seed, device=device)

        state_u, state_b = new_state(), new_state()
        step = make_adapt_step(cfg, style_model=style, device=device)
        pre_step = make_pretrain_step(cfg, style_model=style, device=device)
        bundler = AdaptStepBundler(cfg, style_model=style, device=device)
        gen_u = torch.Generator(device=device).manual_seed(0)
        gen_b = torch.Generator(device=device).manual_seed(0)

        def unbundled(steps):
            for _ in range(steps):
                _, m, _ = step(state_u, host, 1e-4, generator=gen_u, **gates)
            return [float(m["loss_all"])]

        def bundled(bundles):
            for _ in range(bundles):
                _, m, _ = bundler(state_b, [host] * n, 1e-4, [True] * n, [0.5] * n,
                                  [True] * n, [0.5] * n, generator=gen_b)
            return m["loss_all"].tolist()

        parts = {}

        def part(name, since):
            parts[name] = time.perf_counter() - since
            return time.perf_counter()

        p1 = part("setup", p0)
        unbundled(2)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:  # raises at a synchronizing call
            step(state_u, host, 1e-4, generator=gen_u, **gates)
            pre_step(state_u, pre_host, 1e-4, do_s2t=True, alpha=0.5)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        f0 = p1 = part("warm_up_and_sync_check", p1)
        bundled(1)  # warm-up step, capture, replays
        torch.cuda.synchronize()
        first_bundle_s = time.perf_counter() - f0
        if (bundler.eager_steps, bundler.captures, bundler.replays) != (1, 1, n - 1):
            raise AssertionError(f"first bundle: {bundler.eager_steps} eager steps, "
                                 f"{bundler.captures} captures, {bundler.replays} replays")

        times, losses = {"unbundled": [], "bundled": []}, []
        counted = {"unbundled": collections.Counter(), "bundled": collections.Counter()}
        tma = {"unbundled": 0, "bundled": 0}
        for kind in ("unbundled", "bundled", "bundled", "unbundled"):
            _reset_counts()
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            losses += unbundled(n) if kind == "unbundled" else bundled(1)
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - w0) / n * 1e3)
            counted[kind].update(_read_counts())
            tma[kind] += matmul_stats.launches_by_variant["tma"]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{name}: non-finite losses {losses}")
        per_step = {"occlusion_warp": 1, "matmul_stats": 210 * fuse_bn, "warp_gather": 0}
        for kind, got in counted.items():
            want = {k: 2 * n * v for k, v in per_step.items()}
            if dict(got) != want or tma[kind] != want["matmul_stats"]:
                raise AssertionError(f"{name} {kind}: launches {dict(got)} ({tma[kind]} tma) "
                                     f"over {2 * n} steps, needs {want}, all tma")
        per_replay = {k: v for k, v in per_step.items() if v}
        if bundler.tallies != {(True, True, False): per_replay}:
            raise AssertionError(f"{name}: launches per replay {bundler.tallies}, needs "
                                 f"{per_replay}")
        p1 = part("first_bundle_and_timing", p1)
        ms = {kind: statistics.median(v) for kind, v in times.items()}
        path = {"ms_per_step_bundled": ms["bundled"], "ms_per_step_unbundled": ms["unbundled"],
                "ms_each": times, "bundle_steps": n, "first_bundle_s": first_bundle_s,
                "launches_per_replay": per_replay,
                "launches_bundled": dict(counted["bundled"]),
                "sync_debug_error_steps": "clean: an adapt and a pretrain step"}

        if profile_dir:
            trace = {}
            for kind, run, step_ms in (("bundled", lambda: bundled(1), ms["bundled"] * n),
                                       ("unbundled", lambda: unbundled(n),
                                        ms["unbundled"] * n)):
                rows = profile_adapt_step(run, profile_dir, step_ms,
                                          f"profile_{kind}_{name}_{n}_steps")
                busy = sum(r["device_ms"] for r in rows)
                seen = {"occlusion_warp": sum(r["calls"] for r in rows
                                              if "occlusion_warp" in r["name"]),
                        "matmul_stats": sum(r["calls"] for r in rows
                                            if "mm_stats_wgmma" in r["name"])}
                trace[kind] = {"idle_share": 1.0 - busy / step_ms,
                               "device_ms_per_step": busy / n,
                               "kernels_per_step": sum(r["calls"] for r in rows) / n,
                               "kernels_in_trace": seen}
                if seen != {k: n * per_step[k] for k in seen}:
                    raise AssertionError(f"{name} {kind}: the trace shows {seen} over {n} "
                                         f"steps, the counts {per_step} a step")
            path["profile"] = trace
            p1 = part("profile", p1)

        pre = PretrainStepBundler(cfg, style_model=style, device=device)
        _reset_counts()
        pre_losses = []
        for _ in range(2):
            _, m, _ = pre(state_b, [pre_host] * 3, 1e-4, [True, False, True], [0.5, 0.0, 0.4])
            pre_losses += m["loss_all"].tolist()
        pre_want = {"occlusion_warp": 0, "matmul_stats": 6 * 70 * fuse_bn, "warp_gather": 0}
        if ((pre.eager_steps, pre.captures, pre.replays) != (2, 2, 4)
                or _read_counts() != pre_want or not all(np.isfinite(pre_losses))):
            raise AssertionError(f"{name} pretrain bundles: {pre.eager_steps} eager steps, "
                                 f"{pre.captures} captures, {pre.replays} replays, "
                                 f"launches {_read_counts()} (needs {pre_want}), losses "
                                 f"{pre_losses}")
        path["pretrain"] = {"losses": pre_losses, "launches_per_replay": {
            str(k[0]): v for k, v in pre.tallies.items()}}
        launches_by_path[name] = dict(counted["bundled"])
        launches_by_path[f"{name}_pretrain"] = _read_counts()
        del pre
        p1 = part("pretrain_bundles", p1)

        if not fuse_bn:
            path["held_against_eager"] = _held_against_eager(device, state_u, style, host)
            p1 = part("held_against_eager", p1)
            ckpt = os.path.join(work_dir, "bundled", "best.pth")
            save_checkpoint(ckpt, {"student": state_b.student, "teacher": state_b.teacher,
                                   "stu_optimizer": state_b.optimizer, "epoch": 0,
                                   "args": {"steps_per_dispatch": n}})
            saved = load_checkpoint(ckpt)["stu_optimizer"]
            layout = {"capturable": sorted({g["capturable"] for g in saved["param_groups"]}),
                      "step_devices": sorted({str(v["step"].device)
                                              for v in saved["state"].values()})}
            if layout != {"capturable": [False], "step_devices": ["cpu"]}:
                raise AssertionError(f"the checkpoint's optimizer layout {layout}")
            fresh = new_state(5)

            def incompatible(line):
                raise AssertionError(line)

            restore_train_state(fresh, load_checkpoint(ckpt), load_optimizer=True,
                                log=incompatible)
            next_losses = []
            with _deterministic(), warnings.catch_warnings():
                warnings.filterwarnings("ignore", message=".*capturable=True")
                for st in (state_b, fresh):
                    gen = torch.Generator(device=device).manual_seed(7)
                    _, m, _ = step(st, host, 1e-4, generator=gen, **gates)
                    next_losses.append([float(m[k]) for k in ("loss_all", "loss_s", "loss_c")])
            if next_losses[0] != next_losses[1]:
                raise AssertionError(f"one step from the saved and the restored state: "
                                     f"losses {next_losses}")
            resumed = AdaptStepBundler(cfg, style_model=style, device=device)
            _, m, _ = resumed(fresh, [host] * 2, 1e-4, [True] * 2, [0.5] * 2, [True] * 2,
                              [0.5] * 2, generator=gen_b)
            if not bool(torch.isfinite(m["loss_all"]).all()) or resumed.replays != 1:
                raise AssertionError(f"a bundle from the restored state: {m['loss_all']}, "
                                     f"{resumed.replays} replays")
            path["checkpoint"] = {"bytes": os.path.getsize(ckpt), "optimizer_layout": layout,
                                  "next_step_losses": next_losses[0],
                                  "next_step_losses_equal": True,
                                  "bundle_from_restored": m["loss_all"].tolist()}
            del fresh, resumed
            os.remove(ckpt)
            part("checkpoint", p1)
        path["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
        path["seconds"] = time.perf_counter() - p0
        path["seconds_by_part"] = parts
        paths[name] = path
        del state_u, state_b, bundler
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "bundled", "model": "pose_resnet101", "batch": MAIN_B, "image": MAIN_IMAGE,
          "heatmap": MAIN_HEATMAP, "k": MAIN_KV, "style": "s2t+t2s", "occlusion": True,
          "dtype": "bf16 autocast, bf16 style", "paths": paths,
          "card": torch.cuda.get_device_name(device), "nvidia_smi": nvidia_smi_line(),
          "seconds": time.perf_counter() - t0})
    return launches_by_path


# the fake RHD tree of phase device_aug's CLI runs: 10 batches a pass, so
# that 20 iterations read each training set twice and the second pass shows
# the decoded-canvas cache
DA_FRAMES = 10 * MAIN_B
DA_ITERS = 20
# phase device_aug's CLI runs: (name, workers (None: min(8, cpus)), flags)
DA_CLI_RUNS = (
    ("device_aug_j8", None, ["--device-aug", "--decode-cache", "1"]),
    ("device_aug_j8_spd4", None, ["--device-aug", "--decode-cache", "1",
                                  "--steps-per-dispatch", "4"]),
    ("device_aug_j2", 2, ["--device-aug", "--decode-cache", "1"]),
    ("device_aug_j2_spd4", 2, ["--device-aug", "--decode-cache", "1",
                               "--steps-per-dispatch", "4"]),
    ("host_aug_j8_spd4", None, ["--steps-per-dispatch", "4"]),
    ("host_aug_j2_spd4", 2, ["--steps-per-dispatch", "4"]),
)


def raw_canvas_batch(rng, b, size, num_kpts):
    """A raw --device-aug batch as ``DeviceAugPipeline.raw_adapt_batch``
    gives it from the loaders: uint8 canvases, keypoints on them and their
    visibility, for the source and the target, page-locked."""
    import numpy as np
    import torch

    out = {}
    for side in ("s", "t"):
        out["canvas_" + side] = rng.randint(0, 256, (b, size, size, 3)).astype(np.uint8)
        out["kp_" + side] = rng.uniform(20 * size / 256, 230 * size / 256,
                                        (b, num_kpts, 2)).astype(np.float32)
        out["vis_" + side] = (rng.rand(b, num_kpts) > 0.1).astype(np.float32)
    return {k: torch.from_numpy(v).pin_memory() for k, v in out.items()}


def _mostly_close(got, want, atol, share=1e-3):
    """The share of values off by more than ``atol``, and whether it is at
    most ``share`` (a nearest warp whose coefficients differ by an ulp may
    move a pixel that sits on a rounding boundary)."""
    off = float(((got.detach().cpu().double() - want.detach().cpu().double()).abs()
                 > atol).double().mean())
    return off, off <= share


def _views_card_vs_cpu(device, pipe, cpu_pipe, raw_host):
    """The view builders on the card against the CPU on one raw batch, from
    the same uniforms: the crop decisions and rounded translations equal,
    the nearest warp's indices equal on the same coefficients (an index
    image warped on both), the target weights equal, the views within 1e-4
    (normalized: 1e-5 of the [0, 1] image times 1/std) at all but 0.1% of
    their values, the targets within 1e-5 of their peak."""
    import torch

    from uda_poseestimation_torch.ops.affine import inverse_affine_coeffs, warp_affine
    from uda_poseestimation_torch.ops.device_aug import (rrc_from_uniforms, view_fields,
                                                         view_from_uniforms)

    src, stu, tea = pipe.cfg_src, pipe.cfg_stu, pipe.cfg_tea
    size = raw_host["canvas_s"].shape[1]
    g = torch.Generator().manual_seed(3)
    u = {"source": torch.rand((1, MAIN_B, view_fields(src)), generator=g),
         "base": torch.rand((MAIN_B, 12), generator=g),
         "student": torch.rand((1, MAIN_B, view_fields(stu)), generator=g),
         "teacher": torch.rand((MAIN_KV, MAIN_B, view_fields(tea)), generator=g)}

    def draws_on(dev):
        return {"source": view_from_uniforms(src, u["source"].to(dev), size),
                "target": {"base": rrc_from_uniforms(src, u["base"].to(dev), size),
                           "student": view_from_uniforms(stu, u["student"].to(dev), size),
                           "teacher": view_from_uniforms(tea, u["teacher"].to(dev), size)}}

    d_cpu, d_dev = draws_on("cpu"), draws_on(device)
    integer = {}
    for where, view in (("source", ("source",)), ("base", ("target", "base")),
                        ("student", ("target", "student")),
                        ("teacher", ("target", "teacher"))):
        a, b = d_cpu, d_dev
        for key in view:
            a, b = a[key], b[key]
        for name in ("i", "j", "side", "trans_x", "trans_y"):
            if name in a:
                integer[f"{where}/{name}"] = bool(torch.equal(a[name], b[name].cpu()))
    ds = d_cpu["source"]
    coeffs = inverse_affine_coeffs(*(ds[n][0] for n in ("angle", "trans_x", "trans_y",
                                                        "shear_x")),
                                   torch.zeros(MAIN_B), ds["scale"][0])
    index = torch.arange(size * size, dtype=torch.float32).view(1, 1, size, size)
    index = index.expand(MAIN_B, 1, size, size).contiguous()
    integer["warp_indices"] = bool(torch.equal(
        warp_affine(index, coeffs), warp_affine(index.to(device), coeffs.to(device)).cpu()))
    raw_cpu = {k: v for k, v in raw_host.items()}
    raw_dev = {k: v.to(device) for k, v in raw_host.items()}
    got = pipe.view_builder(raw_dev, draws=d_dev)
    want = cpu_pipe.view_builder(raw_cpu, draws=d_cpu)
    integer["weight_s"] = bool(torch.equal(got["weight_s"].cpu(), want["weight_s"]))
    floats = {}
    for name in ("image_s", "image_t_stu", "images_t_tea"):
        floats[name] = _mostly_close(got[name], want[name], 1e-4)
    for name in ("aug_param_stu", "aug_params_tea"):
        floats[name] = _mostly_close(got[name], want[name], 1e-5 * 180, share=0.0)
    peak = float(want["target_s"].abs().max())
    floats["target_s"] = _mostly_close(got["target_s"], want["target_s"], 1e-5 * peak,
                                       share=0.0)
    build_dev = pipe.pretrain_view_builder(True)(raw_dev, True, draws=d_dev)
    build_cpu = cpu_pipe.pretrain_view_builder(True)(raw_cpu, True, draws=d_cpu)
    for name in ("image_s", "image_t_style"):
        floats["pretrain/" + name] = _mostly_close(build_dev[name], build_cpu[name], 1e-4)
    layout = {"image_t_stu_contiguous_nhwc": bool(got["image_t_stu"].is_contiguous()),
              "kernel_view_channels_last": bool(got["image_t_stu"].permute(0, 3, 1, 2)
                                                .is_contiguous(
                                                    memory_format=torch.channels_last))}
    result = {"integer_equal": integer,
              "off_share": {k: v[0] for k, v in floats.items()}, "layout": layout,
              "fired_crops": int((d_cpu["source"]["side"] < size).sum())}
    if not (all(integer.values()) and all(v[1] for v in floats.values())
            and all(layout.values())):
        raise AssertionError(f"views on the card against the CPU: {result}")
    return result, raw_dev


def _pretrain_held_against_eager(device, state, style, build, raw):
    """Each do_s2t case of the pretrain bundler with the pretrain view
    builder: its graph replay against the eager step (under the sync debug
    mode "error") from one copied state and generator, under deterministic
    cuDNN: the losses and accuracy equal bit for bit, the updated student
    within 1e-5 of each tensor's largest magnitude."""
    import warnings

    import torch

    from uda_poseestimation_torch.parallel import (PretrainStepBundler, StepConfig,
                                                   make_pretrain_step)

    cfg = StepConfig(k=MAIN_KV, gather_exact=False, style_io_dtype="bfloat16")
    bundler = PretrainStepBundler(cfg, style_model=style, device=device, view_builder=build)
    step = make_pretrain_step(cfg, style_model=style, device=device, view_builder=build)
    gen = torch.Generator(device=device).manual_seed(6)
    cases = {}
    with _deterministic(), warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*capturable=True")
        for do_s2t in (True, False):
            bundler(state, [raw], 1e-4, [do_s2t], [0.6], generator=gen)  # warm-up: eager
            twin = copy.deepcopy(state)
            twin_gen = torch.Generator(device=device)
            twin_gen.set_state(gen.get_state())
            replays = bundler.replays
            _, got, _ = bundler(state, [raw], 1e-4, [do_s2t], [0.6], generator=gen)
            if bundler.replays != replays + 1:
                raise AssertionError(f"pretrain case {do_s2t}: no replay")
            with _sync_debug():
                _, want, _ = step(twin, raw, 1e-4, do_s2t, 0.6, generator=twin_gen)
            equal = {k: bool(torch.equal(got[k][0], want[k]))
                     for k in ("loss_all", "acc_s", "acc_cnt")}
            moved = _state_rel_err(state.student, twin.student)
            cases[str(do_s2t)] = {"bit_equal": equal, "student_rel_err": moved}
            del twin
            if not all(equal.values()) or moved > 1e-5:
                raise AssertionError(f"pretrain replay vs eager, case {do_s2t}: "
                                     f"{cases[str(do_s2t)]}")
    return {"cases": cases, "eager_steps": bundler.eager_steps,
            "captures": bundler.captures, "replays": bundler.replays}


def _children_rss_kb():
    """The resident kB of each of this process's child processes (the
    loader workers), from ``/proc/<pid>/statm``."""
    import multiprocessing

    page = os.sysconf("SC_PAGE_SIZE") // 1024
    out = []
    for child in multiprocessing.active_children():
        try:
            with open(f"/proc/{child.pid}/statm") as f:
                fields = f.read().split()
        except OSError:
            continue
        out.append(int(fields[1]) * page)
    return out


def phase_device_aug(device, work_dir, profile_dir=None):
    """--device-aug and --decode-cache on the card at full width (phase
    main's models and flags): (1) the view builders on the card against the
    CPU (``_views_card_vs_cpu``); (2) the device-aug adapt step, unbundled
    and in BUNDLE_N-step bundles, timed in turns beside phase main's step on
    its host-augmented batch (both in this call), an eager device-aug adapt
    and pretrain step under the sync debug mode "error", occlusion_warp once
    per step and per replay, the bytes each iteration copies to the card,
    the view builder's time, the peak memory and, with ``profile_dir``, the
    idle share and the view builder's device time; (3) every gate case's
    replay against the eager step, adapt (``_held_against_eager``) and
    pretrain (``_pretrain_held_against_eager``); (4) the CLI on a fake RHD
    tree of DA_FRAMES frames: DA_ITERS adapt iterations with --device-aug
    --decode-cache 1 at -j 8 and -j 2, unbundled and with
    --steps-per-dispatch 4, the same bundled with host augmentation, and a
    --device-aug pretrain epoch with s2t fired: Time and Data medians per
    pass, the first batch's wait, the cache's counts and the parent's and
    workers' RSS. Returns the launches of each path."""
    import multiprocessing
    import statistics
    import warnings

    import numpy as np
    import torch

    from uda_poseestimation_torch import train_human
    from uda_poseestimation_torch.engine import DeviceAugPipeline
    from uda_poseestimation_torch.models import StyleNet, pose_resnet101
    from uda_poseestimation_torch.ops.device_aug import DeviceAugConfig
    from uda_poseestimation_torch.parallel import (AdaptStepBundler, StepConfig, create_state,
                                                   make_adapt_step, make_pretrain_step)

    t0 = time.perf_counter()
    parts, launches_by_path = {}, {}

    def part(name, since):
        parts[name] = time.perf_counter() - since
        return time.perf_counter()

    mean, std = train_human.IMAGENET_MEAN, train_human.IMAGENET_STD
    cfgs = (DeviceAugConfig(use_rrc=True), DeviceAugConfig(use_rrc=False),
            DeviceAugConfig(use_rrc=False))
    pipe = DeviceAugPipeline(*cfgs, k=MAIN_KV, mean=mean, std=std, seed=0, device=device)
    cpu_pipe = DeviceAugPipeline(*cfgs, k=MAIN_KV, mean=mean, std=std, seed=0, device="cpu")
    raw = raw_canvas_batch(np.random.RandomState(0), MAIN_B, MAIN_IMAGE, MAIN_K)
    views, raw_dev = _views_card_vs_cpu(device, pipe, cpu_pipe, raw)
    views["builder_ms"] = cuda_ms(lambda: pipe.view_builder(raw_dev), 10)
    p1 = part("views_card_vs_cpu", t0)

    # (2) the device-aug adapt step beside phase main's
    style = StyleNet()
    style.reset_parameters(torch.Generator().manual_seed(1))
    style.to(device=device, dtype=torch.bfloat16)
    cfg = StepConfig(k=MAIN_KV, gather_exact=False, style_io_dtype="bfloat16")
    host = {k: torch.from_numpy(v).pin_memory()
            for k, v in synthetic_batch(np.random.RandomState(0), MAIN_B, MAIN_KV, MAIN_IMAGE,
                                        MAIN_HEATMAP, MAIN_K).items()}
    gates = dict(do_s2t=True, alpha_s2t=0.5, do_t2s=True, alpha_t2s=0.5)
    n = BUNDLE_N
    torch.cuda.reset_peak_memory_stats(device)
    paths = {}
    for name, builder, batch in (("main", None, host), ("device_aug", pipe.view_builder, raw)):
        def new_state():
            return create_state(pose_resnet101(num_keypoints=MAIN_K, dtype=torch.bfloat16),
                                cfg, seed=0, device=device)

        paths[name] = {
            "batch": batch, "state_u": new_state(), "state_b": new_state(),
            "step": make_adapt_step(cfg, style_model=style, device=device,
                                    view_builder=builder),
            "bundler": AdaptStepBundler(cfg, style_model=style, device=device,
                                        view_builder=builder),
            "gen_u": torch.Generator(device=device).manual_seed(0),
            "gen_b": torch.Generator(device=device).manual_seed(0)}

    def unbundled(p, steps):
        for _ in range(steps):
            _, m, _ = p["step"](p["state_u"], p["batch"], 1e-4, generator=p["gen_u"], **gates)
        return [float(m["loss_all"])]

    def bundled(p, bundles):
        for _ in range(bundles):
            _, m, _ = p["bundler"](p["state_b"], [p["batch"]] * n, 1e-4, [True] * n,
                                   [0.5] * n, [True] * n, [0.5] * n, generator=p["gen_b"])
        return m["loss_all"].tolist()

    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*capturable=True")
        for p in paths.values():
            unbundled(p, 2)  # warm-up
            bundled(p, 1)  # warm-up step, capture, replays
        torch.cuda.synchronize()
        da = paths["device_aug"]
        pre_build = pipe.pretrain_view_builder(True)
        pre_step = make_pretrain_step(cfg, style_model=style, device=device,
                                      view_builder=pre_build)
        with _sync_debug():  # raises at a synchronizing call
            da["step"](da["state_u"], raw, 1e-4, generator=da["gen_u"], **gates)
            pre_step(da["state_u"], raw, 1e-4, True, 0.5, generator=pipe.generator)
        torch.cuda.synchronize()
        p1 = part("step_warm_up_and_sync_check", p1)
        times = {f"{name}_{kind}": [] for name in paths for kind in ("unbundled", "bundled")}
        counted = {k: collections.Counter() for k in times}
        losses = []
        for name, kind in (("main", "unbundled"), ("device_aug", "unbundled"),
                           ("device_aug", "bundled"), ("main", "bundled"),
                           ("main", "bundled"), ("device_aug", "bundled"),
                           ("device_aug", "unbundled"), ("main", "unbundled")):
            _reset_counts()
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            losses += (unbundled(paths[name], n) if kind == "unbundled"
                       else bundled(paths[name], 1))
            torch.cuda.synchronize()
            times[f"{name}_{kind}"].append((time.perf_counter() - w0) / n * 1e3)
            counted[f"{name}_{kind}"].update(_read_counts())
        peak = torch.cuda.max_memory_allocated(device)
        if not all(np.isfinite(losses)):
            raise AssertionError(f"device_aug: non-finite losses {losses}")
        want = {"occlusion_warp": 2 * n, "matmul_stats": 0, "warp_gather": 0}
        tallies = da["bundler"].tallies
        if (any(dict(c) != want for c in counted.values())
                or tallies != {(True, True, False): {"occlusion_warp": 1}}):
            raise AssertionError(f"device_aug launches {counted} over {2 * n} steps each "
                                 f"(needs {want}), per replay {tallies}")
        launches_by_path["unbundled"] = dict(counted["device_aug_unbundled"])
        launches_by_path["bundled"] = dict(counted["device_aug_bundled"])
        ms = {k: statistics.median(v) for k, v in times.items()}
        h2d = {name: sum(t.numel() * t.element_size() for t in p["batch"].values())
               for name, p in paths.items()}
        step_result = {"ms_per_step": ms, "ms_each": times, "bundle_steps": n,
                       "h2d_bytes_per_iteration": h2d, "max_memory_allocated": peak,
                       "launches_per_replay": tallies[(True, True, False)],
                       "launches": launches_by_path,
                       "sync_debug_error_steps": "clean: an adapt and a pretrain step"}
        p1 = part("step_timing", p1)
        if profile_dir:
            trace = {}
            for kind, run, step_ms in (
                    ("bundled", lambda: bundled(da, 1), ms["device_aug_bundled"] * n),
                    ("unbundled", lambda: unbundled(da, n), ms["device_aug_unbundled"] * n)):
                rows = profile_adapt_step(run, profile_dir, step_ms,
                                          f"profile_device_aug_{kind}_{n}_steps")
                busy = sum(r["device_ms"] for r in rows)
                trace[kind] = {"idle_share": 1.0 - busy / step_ms,
                               "device_ms_per_step": busy / n}
            rows = profile_adapt_step(lambda: pipe.view_builder(raw_dev), profile_dir,
                                      views["builder_ms"], "profile_device_aug_view_builder")
            trace["view_builder_device_ms"] = sum(r["device_ms"] for r in rows)
            trace["view_builder_kernels"] = sum(r["calls"] for r in rows)
            step_result["profile"] = trace
            p1 = part("profile", p1)

        # (3) replays against eager steps
        held = {"adapt": _held_against_eager(device, da["state_u"], style, raw,
                                             view_builder=pipe.view_builder, sync_check=True),
                "pretrain": _pretrain_held_against_eager(device, da["state_u"], style,
                                                         pre_build, raw)}
        p1 = part("held_against_eager", p1)
    del paths, da
    gc.collect()
    torch.cuda.empty_cache()

    # (4) the CLI
    root = os.path.join(work_dir, "rhd_device_aug")
    write_fake_rhd(root)
    usable_fake_rhd(root, DA_FRAMES)
    write_style_weights(work_dir)
    workers8 = min(8, os.cpu_count() or 1)
    common = [root, root, "-s", "RenderedHandPose", "-t", "RenderedHandPose",
              "--target-train", "RenderedHandPose_mt", "-a", TRAINER_ARCH, "-b", str(MAIN_B),
              "--test-batch", str(MAIN_B), "--image-size", str(MAIN_IMAGE),
              "--heatmap-size", str(MAIN_HEATMAP), "--k", str(MAIN_KV), "--seed", "0",
              "-p", "1", "--decoder-name", "saved_models/decoder_rand.pth",
              "--device", str(device)]
    caches, record = [], {}

    class Cache(train_human.CachedDataset):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            caches.append(self)

    def sampled(run):
        def call(*a, **kw):
            out = run(*a, **kw)
            record["rss_kb_workers"] = _children_rss_kb()
            record["rss_kb_parent"] = _rss_kb()
            return out
        return call

    real = (train_human.CachedDataset, train_human.run_adapt_epoch,
            train_human.run_pretrain_epoch)
    runs = [(name, workers or workers8,
             flags + ["--pretrain-epoch", "-1", "--epochs", "1", "-i", str(DA_ITERS)],
             DA_ITERS) for name, workers, flags in DA_CLI_RUNS]
    runs.append(("device_aug_pretrain", workers8,
                 ["--device-aug", "--decode-cache", "1", "--pretrain-epoch", "1", "--epochs",
                  "1", "-i", "3", "--s2t-freq", "1.0"], 0))
    cli = {}
    cwd, fuse_env = os.getcwd(), os.environ.pop("UDA_BN_FUSE", None)
    train_human.CachedDataset = Cache
    train_human.run_adapt_epoch = sampled(real[1])
    train_human.run_pretrain_epoch = sampled(real[2])
    os.chdir(work_dir)
    try:
        for name, workers, flags, warps in runs:
            caches.clear()
            record.clear()
            args = train_human.build_parser().parse_args(
                common + ["-j", str(workers), "--log", f"logs/{name}"] + flags)
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                _reset_counts()
                r0 = time.perf_counter()
                train_human.main(args)
                torch.cuda.synchronize()
                wall = time.perf_counter() - r0
                launches = _read_counts()
            gc.collect()
            if multiprocessing.active_children():
                raise AssertionError(f"run {name} left {multiprocessing.active_children()}")
            want = dict(dict.fromkeys(_counters(), 0), occlusion_warp=warps)
            if launches != want:
                raise AssertionError(f"run {name}: launches {launches}, needs {want}")
            launches_by_path[f"cli_{name}"] = launches
            log_dir = f"logs/{name}_{TRAINER_ARCH}"
            (log,) = [f for f in os.listdir(log_dir) if f.startswith("train-")]
            with open(os.path.join(log_dir, log)) as f:
                lines = _finite_lines(f.read(), ("Epoch: 0 ",))
            _finite_lines(printed.getvalue(), ("Epoch: [0][",))
            times = printed_times(printed.getvalue())
            half = DA_ITERS // 2
            row = {"workers": workers, "wall_s": wall, "launches": launches, "log": lines,
                   "first_batch_s": times["first_batch_s"], **record,
                   "time_s_each": times["time_s_each"], "data_s_each": times["data_s_each"]}
            if warps:
                row.update({
                    "time_s_median_pass1": statistics.median(times["time_s_each"][2:half]),
                    "data_s_median_pass1": statistics.median(times["data_s_each"][2:half]),
                    "time_s_median_pass2": statistics.median(times["time_s_each"][half:]),
                    "data_s_median_pass2": statistics.median(times["data_s_each"][half:])})
            if "--device-aug" in flags:
                row["cache"] = [{"items": c.items_cached, "bytes": c.bytes_used,
                                 "misses": c.misses, "hits": c.hits} for c in caches]
                # DA_ITERS iterations read each training set twice: every
                # item is decoded once, and the second pass is all hits
                if warps and (len(caches) != 2 or any(
                        (c.items_cached, c.misses, c.hits) != (DA_FRAMES,) * 3
                        for c in caches)):
                    raise AssertionError(f"run {name}: cache {row['cache']}, needs "
                                         f"{DA_FRAMES} items and hits in each of 2")
            cli[name] = row
            emit({"phase": "device_aug", "cli_run": name, **row})
    finally:
        os.chdir(cwd)
        (train_human.CachedDataset, train_human.run_adapt_epoch,
         train_human.run_pretrain_epoch) = real
        if fuse_env is not None:
            os.environ["UDA_BN_FUSE"] = fuse_env
    part("cli", p1)
    emit({"phase": "device_aug", "model": "pose_resnet101", "batch": MAIN_B,
          "image": MAIN_IMAGE, "heatmap": MAIN_HEATMAP, "k": MAIN_KV, "style": "s2t+t2s",
          "occlusion": True, "dtype": "bf16 autocast, bf16 style", "views": views,
          "step": step_result, "held_against_eager": held,
          "cli_summary": {k: {m: v.get(m) for m in (
              "time_s_median_pass1", "data_s_median_pass1", "time_s_median_pass2",
              "data_s_median_pass2", "first_batch_s", "wall_s")} for k, v in cli.items()},
          "fake_rhd_frames": DA_FRAMES, "cli_iterations": DA_ITERS,
          "card": torch.cuda.get_device_name(device), "nvidia_smi": nvidia_smi_line(),
          "seconds_by_part": parts, "seconds": time.perf_counter() - t0})
    return launches_by_path


def phase_trainer_engine(device, work_dir, main_run, profile_dir=None):
    """The port's epoch loops on the card at full width (the models, batch
    and flags of phase main), fed by in-memory RHD-shaped batches: pretrain
    (3 iterations, s2t gate always on), adapt (3 iterations, both gates
    always on), validation over two batches (the last partial), adapt again
    for 10 iterations (the steady time per iteration); then a
    checkpoint round trip into a fresh state, held bit-equal, and one more
    adapt step from each state with equal losses. Each loop is counted on
    its own: occlusion_warp once per adapt iteration, no kernel in pretrain
    or validation. With ``profile_dir``, one more adapt epoch is traced for
    its device busy time and idle share. Returns the launches of each loop
    and the checkpoint's path."""
    import types

    import numpy as np
    import torch

    from uda_poseestimation_torch import models
    from uda_poseestimation_torch.engine import (make_adapt_batch, run_adapt_epoch,
                                                 run_pretrain_epoch, run_validate)
    from uda_poseestimation_torch.parallel import (
        StepConfig, create_state, make_adapt_step, make_eval_step, make_pretrain_step)
    from uda_poseestimation_torch.utils.checkpoint import (load_checkpoint,
                                                           restore_train_state,
                                                           save_checkpoint)

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(device)
    cfg = StepConfig(image_size=MAIN_IMAGE, heatmap_size=MAIN_HEATMAP, k=MAIN_KV,
                     gather_exact=False, style_io_dtype="bfloat16")

    def new_state(seed):
        model = getattr(models, TRAINER_ARCH)(num_keypoints=MAIN_K, dtype=torch.bfloat16)
        return create_state(model, cfg, seed=seed, device=device)

    state = new_state(0)
    style = models.StyleNet()
    style.reset_parameters(torch.Generator().manual_seed(1))
    style.to(device=device, dtype=torch.bfloat16)
    calls = []  # host time of each training step's call
    pretrain = clocked(make_pretrain_step(cfg, style_model=style, device=device), calls)
    adapt = clocked(make_adapt_step(cfg, style_model=style, device=device), calls)
    evaluate = make_eval_step(device=device)
    source, target = SyntheticRHD(False, 10), SyntheticRHD(True, 11)
    val_loader = synthetic_val_loader(MAIN_B + MAIN_B // 2, MAIN_B)
    args = types.SimpleNamespace(iters_per_epoch=3, print_freq=1, val_print_freq=1,
                                 image_size=MAIN_IMAGE, heatmap_size=MAIN_HEATMAP,
                                 s2t_freq=1.0,
                                 s2t_alpha=(0.0, 1.0), t2s_freq=1.0, t2s_alpha=(0.0, 1.0))
    np.random.seed(0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # a longer adapt epoch for the loop's steady time per iteration
    timed_args = types.SimpleNamespace(**dict(vars(args), iters_per_epoch=10))
    loops, launches, printed = {}, {}, io.StringIO()
    for name, run in (
            ("pretrain", lambda: run_pretrain_epoch(state, pretrain, source, target, 0, 1e-4,
                                                    args, style_enabled=True)),
            ("adapt", lambda: run_adapt_epoch(state, adapt, source, target, 1, 1e-4, args,
                                              style_enabled=True)),
            ("validate", lambda: run_validate(evaluate, state.teacher, val_loader, args)),
            ("adapt_10", lambda: run_adapt_epoch(state, adapt, source, target, 2, 1e-4,
                                                 timed_args, style_enabled=True))):
        del calls[:], source.stamps[:]
        with contextlib.redirect_stdout(printed):
            _reset_counts()
            w0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - w0
            launches[name] = _read_counts()
        loops[name] = dict(step_times(calls, source.stamps) if calls else {},
                           wall_s=wall, launches=launches[name])
        if name == "validate":
            loops[name]["accuracy"] = out = {k: float(v) for k, v in out.items()}
            if not all(np.isfinite(list(out.values()))):
                raise AssertionError(f"validation accuracy {out}")
    _finite_lines(printed.getvalue(), ("Epoch: [0][", "Epoch: [1][", "Test: ["))
    want = {"pretrain": dict.fromkeys(launches["pretrain"], 0),
            "adapt": dict(dict.fromkeys(launches["adapt"], 0),
                          occlusion_warp=args.iters_per_epoch),
            "validate": dict.fromkeys(launches["validate"], 0),
            "adapt_10": dict(dict.fromkeys(launches["adapt"], 0), occlusion_warp=10)}
    if launches != want:
        raise AssertionError(f"launches by loop {launches}, the loops need {want}")
    # s2t fired in every pretrain iteration
    if len(target.stamps) != 2 * args.iters_per_epoch + timed_args.iters_per_epoch:
        raise AssertionError(f"target batches fetched {len(target.stamps)}")
    loops_peak = torch.cuda.max_memory_allocated(device)
    if profile_dir:
        def quiet_epoch():
            with contextlib.redirect_stdout(io.StringIO()):
                run_adapt_epoch(state, adapt, source, target, 3, 1e-4, timed_args,
                                style_enabled=True)

        profile_adapt_step(quiet_epoch, profile_dir, loops["adapt_10"]["wall_s"] * 1e3,
                           "profile_trainer_adapt_epoch")

    # checkpoint round trip into a fresh state, then one adapt step from each
    path = os.path.join(work_dir, "engine", "best.pth")
    c0 = time.perf_counter()
    save_checkpoint(path, {"student": state.student, "teacher": state.teacher,
                           "stu_optimizer": state.optimizer,
                           "lr_scheduler": {"epoch": 1, "milestones": [45, 60], "gamma": 0.1},
                           "epoch": 1, "args": vars(args)})
    fresh = new_state(5)
    if _same_state(state, fresh):
        raise AssertionError("a fresh state already equals the trained one")

    def incompatible(line):
        raise AssertionError(line)

    restore_train_state(fresh, load_checkpoint(path), load_optimizer=True, log=incompatible)
    round_trip_s = time.perf_counter() - c0
    if not _same_state(state, fresh):
        raise AssertionError("the restored state differs from the saved one")
    batch = make_adapt_batch(next(source), next(target))
    losses = []
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for st in (state, fresh):
            gen = torch.Generator(device=device).manual_seed(7)
            _, metrics, _ = adapt(st, batch, 1e-4, True, 0.5, True, 0.5, generator=gen)
            losses.append([float(metrics[k]) for k in ("loss_all", "loss_s", "loss_c")])
    if losses[0] != losses[1] or not all(np.isfinite(losses[0])):
        raise AssertionError(f"one more adapt step: losses {losses[0]} vs {losses[1]}")
    del fresh

    adapt_ms = loops["adapt_10"]["period_s_median"] * 1e3
    emit({"phase": "trainer_engine", "model": TRAINER_ARCH, "batch": MAIN_B,
          "image": MAIN_IMAGE, "heatmap": MAIN_HEATMAP, "k": MAIN_KV, "style": "s2t+t2s, gates always on",
          "setup_s": setup_s, "loops": loops,
          "main_ms_per_step": main_run["ms_per_step"],
          "adapt_10_period_ms_minus_main": adapt_ms - main_run["ms_per_step"],
          "checkpoint": {"bytes": os.path.getsize(path), "round_trip_s": round_trip_s,
                         "state_bit_equal": True, "next_step_losses": losses[0],
                         "next_step_losses_equal": True},
          "max_memory_allocated_loops": loops_peak,
          "max_memory_allocated": torch.cuda.max_memory_allocated(device),
          "seconds": time.perf_counter() - t0})
    return launches, path


def blob_frame(rng, h, w, kp):
    """An h x w uint8 RGB frame: a Gaussian blob (sigma 6 px) at each
    keypoint over a dim noisy background (make_rhd's recipe)."""
    import numpy as np

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = rng.rand(h, w, 3).astype(np.float32) * 0.15
    for j in range(len(kp)):
        img[..., j % 3] += np.exp(-((xx - kp[j, 0]) ** 2 + (yy - kp[j, 1]) ** 2)
                                  / (2 * 6.0 ** 2))
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def write_fake_rhd(root, n_train=96, n_eval=16, size=320):
    """A fake RHD tree in the layout and recipe of
    ``tools/make_fixtures.py::make_rhd`` (a copy: this script imports nothing
    of ``tools/``): 21 Gaussian blobs per frame over a noisy background, the
    left hand's keypoints visible, the right hand's far away and invisible."""
    import pickle

    import numpy as np
    from PIL import Image

    base = os.path.join(root, "RHD_published_v2")
    for set_name, n, seed in (("training", n_train, 0), ("evaluation", n_eval, 1)):
        color = os.path.join(base, set_name, "color")
        os.makedirs(color, exist_ok=True)
        os.makedirs(os.path.join(base, set_name, "mask"), exist_ok=True)
        rng = np.random.RandomState(seed)
        anno = {}
        for i in range(n):
            kp = rng.uniform(60, size - 60, (21, 2)).astype(np.float32)
            Image.fromarray(blob_frame(rng, size, size, kp)).save(
                os.path.join(color, "%.5d.png" % i))
            uv = np.zeros((42, 3))
            uv[:21, :2], uv[:21, 2], uv[21:, :2] = kp, 1, 5.0
            anno[i] = {"uv_vis": uv, "xyz": rng.rand(42, 3) + 1.0,
                       "K": np.array([[320.0, 0, 160], [0, 320.0, 160], [0, 0, 1]])}
        with open(os.path.join(base, set_name, "anno_%s.pickle" % set_name), "wb") as f:
            pickle.dump(anno, f)


def write_style_weights(work_dir):
    """Random style weights in the reference's files under
    ``work_dir/saved_models``, as ``--decoder-name saved_models/decoder_rand.pth``
    reads them (once per directory)."""
    import torch

    from uda_poseestimation_torch.models import StyleNet

    out = os.path.join(work_dir, "saved_models")
    if os.path.isdir(out):
        return
    style = StyleNet()
    style.reset_parameters(torch.Generator().manual_seed(1))
    os.makedirs(out)
    torch.save(style.encoder.state_dict(), os.path.join(out, "vgg_normalised.pth"))
    torch.save(style.decoder.state_dict(), os.path.join(out, "decoder_rand.pth"))


def lengthen_fake_rhd(root, n):
    """Make the training set of a fake RHD tree ``n`` frames long: new
    names linked to its images and their annotations repeated, so that one
    pass holds n // 32 batches at the same decode and augmentation cost and
    a long run never waits for the loader's next pass."""
    import pickle

    base = os.path.join(root, "RHD_published_v2", "training")
    path = os.path.join(base, "anno_training.pickle")
    with open(path, "rb") as f:
        anno = pickle.load(f)
    have = len(anno)
    for i in range(have, n):
        os.link(os.path.join(base, "color", "%.5d.png" % (i % have)),
                os.path.join(base, "color", "%.5d.png" % i))
        anno[i] = anno[i % have]
    with open(path, "wb") as f:
        pickle.dump(anno, f)


def usable_fake_rhd(root, n):
    """Give a fake RHD tree's training set exactly ``n`` samples that the
    RHD dataset keeps (its hand-size filter drops some frames): new names
    linked to the kept frames in turn, their annotations repeated, the
    rest dropped from the annotation file."""
    import pickle

    from uda_poseestimation_torch.data.rendered_hand_pose import _get_samples

    base = os.path.join(root, "RHD_published_v2")
    kept = sorted(int(os.path.basename(s["name"])[:-4]) for s in _get_samples(base, "train"))
    train = os.path.join(base, "training")
    path = os.path.join(train, "anno_training.pickle")
    with open(path, "rb") as f:
        anno = pickle.load(f)
    first = max(anno) + 1
    out = {}
    for i in range(n):
        frame = kept[i % len(kept)]
        os.link(os.path.join(train, "color", "%.5d.png" % frame),
                os.path.join(train, "color", "%.5d.png" % (first + i)))
        out[first + i] = anno[frame]
    with open(path, "wb") as f:
        pickle.dump(out, f)


def phase_trainer_cli(device, work_dir, checkpoint):
    """``train_human.main`` of the port in this process, at full width on a
    fake RHD tree with random style weights (the cwd is ``work_dir`` for the
    phase): a pretrain epoch, an adapt epoch, the same under UDA_BN_FUSE=1,
    a pretrain and an adapt epoch with ``--steps-per-dispatch 4``,
    ``--phase test --resume`` on ``checkpoint`` (written by the port's
    save_checkpoint), and a 40-iteration adapt epoch on the tree
    lengthened to 40 batches a pass (the data pipeline's steady cost). Each
    run is counted on its own. Needs Pillow; returns
    the launches of each run, or None when Pillow is not installed."""
    import importlib.util
    import multiprocessing

    import torch

    if importlib.util.find_spec("PIL") is None:
        emit({"phase": "trainer_cli", "ran": False, "reason": "Pillow is not installed"})
        return None
    from uda_poseestimation_torch import train_human
    from uda_poseestimation_torch.models import resnet
    from uda_poseestimation_torch.ops.bn_fuse import VARIANTS, matmul_stats

    t0 = time.perf_counter()
    root = os.path.join(work_dir, "rhd")
    write_fake_rhd(root)
    write_style_weights(work_dir)
    fixture_s = time.perf_counter() - t0
    workers = min(8, os.cpu_count() or 1)
    common = [root, root, "-s", "RenderedHandPose", "-t", "RenderedHandPose",
              "--target-train", "RenderedHandPose_mt", "-a", TRAINER_ARCH, "-b", str(MAIN_B),
              "--test-batch", str(MAIN_B), "--image-size", str(MAIN_IMAGE),
              "--heatmap-size", str(MAIN_HEATMAP), "--k", str(MAIN_KV),
              "--seed", "0", "-i", "3", "-p", "1",
              "--decoder-name", "saved_models/decoder_rand.pth", "-j", str(workers),
              "--device", str(device)]
    # the fused GEMM's calls per train-mode forward (70 for pose_resnet101):
    # k teacher and 2 student forwards per adapt iteration, 3 iterations
    per_forward = sum(resnet.fused_gemm_shapes(
        getattr(resnet, TRAINER_ARCH[len("pose_"):])(fuse_bn=True), MAIN_B,
        MAIN_IMAGE).values())
    none = dict.fromkeys(_counters(), 0)
    runs = [("pretrain", ["--pretrain-epoch", "1", "--epochs", "1"], None, none),
            ("adapt", ["--pretrain-epoch", "-1", "--epochs", "1"], None,
             dict(none, occlusion_warp=3)),
            ("adapt_bn_fuse", ["--pretrain-epoch", "-1", "--epochs", "1"], "1",
             dict(none, occlusion_warp=3, matmul_stats=3 * (MAIN_KV + 2) * per_forward)),
            # --steps-per-dispatch: the 3 iterations in one bundle, graph
            # replays after each gate case's first (eager) step
            ("pretrain_spd4", ["--pretrain-epoch", "1", "--epochs", "1",
                               "--steps-per-dispatch", "4"], None, none),
            ("adapt_spd4", ["--pretrain-epoch", "-1", "--epochs", "1",
                            "--steps-per-dispatch", "4"], None, dict(none, occlusion_warp=3)),
            ("test", ["--phase", "test", "--resume", checkpoint], None, none),
            # long enough to drain the workers' prefetched batches (2 each),
            # on a tree of 40 batches a pass (the loader's next pass would
            # start only when the last one ends, a stall of one batch's
            # latency every 3 iterations on the 96-frame tree)
            ("adapt_40", ["--pretrain-epoch", "-1", "--epochs", "1", "-i", "40"], None,
             dict(none, occlusion_warp=40))]
    results, launches = {}, {}
    cwd, fuse_env = os.getcwd(), os.environ.get("UDA_BN_FUSE")
    os.chdir(work_dir)
    try:
        for name, extra, fuse, want in runs:
            if name == "adapt_40":
                lengthen_fake_rhd(root, 40 * MAIN_B)
            if fuse is None:
                os.environ.pop("UDA_BN_FUSE", None)
            else:
                os.environ["UDA_BN_FUSE"] = fuse
            printed = io.StringIO()
            args = train_human.build_parser().parse_args(common + extra + ["--log",
                                                                            f"logs/{name}"])
            with contextlib.redirect_stdout(printed):
                _reset_counts()
                r0 = time.perf_counter()
                train_human.main(args)
                torch.cuda.synchronize()
                wall = time.perf_counter() - r0
                launches[name] = _read_counts()
                by_variant = dict(matmul_stats.launches_by_variant)
            gc.collect()
            if multiprocessing.active_children():
                raise AssertionError(f"run {name} left {multiprocessing.active_children()}")
            if launches[name] != want:
                raise AssertionError(f"run {name}: launches {launches[name]}, needs {want}")
            if by_variant != dict(dict.fromkeys(VARIANTS, 0), tma=want["matmul_stats"]):
                raise AssertionError(f"run {name}: matmul_stats by variant {by_variant}")
            phase = "test" if name == "test" else "train"
            log_dir = f"logs/{name}_{TRAINER_ARCH}"
            logs = [f for f in os.listdir(log_dir) if f.startswith(phase + "-")]
            with open(os.path.join(log_dir, logs[0])) as f:
                text = f.read()
            lines = _finite_lines(text, ("Source: ",) if name == "test" else ("Epoch: 0 ",))
            if name != "test":
                _finite_lines(printed.getvalue(), ("Epoch: [0][",))
            results[name] = {"wall_s": wall, "launches": launches[name],
                             "matmul_stats_by_variant": by_variant, "log": lines,
                             **printed_times(printed.getvalue())}
    finally:
        os.chdir(cwd)
        if fuse_env is None:
            os.environ.pop("UDA_BN_FUSE", None)
        else:
            os.environ["UDA_BN_FUSE"] = fuse_env
    emit({"phase": "trainer_cli", "ran": True, "workers": workers,
          "cpu_count": os.cpu_count(),
          "fixture": {"train": 96, "eval": 16, "size": 320, "train_adapt_40": 40 * MAIN_B},
          "fixture_s": fixture_s, "runs": results, "seconds": time.perf_counter() - t0})
    return launches


# the fake trees of phase trainer_pairs (PERF.md section 4 states the sizes
# that no source records): FreiHAND's full index and frame size, Human3.6M's
# 512² crops, SURREAL's 240² frames, LSP's 2000 images, H3D's square crops
FAKE_TREES = {
    "freihand": {"index": 32560, "versions": 4, "frame": 224, "distinct_frames": 16},
    "h36m": {"per_part": 1000, "parts": (1, 5, 6, 7, 8, 9, 11), "crop": 512,
             "distinct_frames": 32},
    "surreal": {"train": 2400, "val": 240, "test": 4000, "frame": 240,
                "distinct_frames": 32},
    "lsp": {"images": 2000, "height": (140, 260), "width": (100, 260),
            "distinct_frames": 32},
    "h3d": {"samples": 4000, "crop": 512, "distinct_frames": 32},
}


def _frames(rng, directory, sizes, k, margin=0.15, ext="jpg"):
    """A distinct blob frame of each (h, w) of ``sizes`` with ``k`` blobs,
    in ``directory`` (frame0.jpg, ..., or PNG); their paths. The names of a
    tree are hard links to these, in turn."""
    import numpy as np
    from PIL import Image

    os.makedirs(directory)
    paths = []
    for i, (h, w) in enumerate(sizes):
        kp = np.stack([rng.uniform(margin * w, (1 - margin) * w, k),
                       rng.uniform(margin * h, (1 - margin) * h, k)], axis=1)
        paths.append(os.path.join(directory, f"frame{i}.{ext}"))
        Image.fromarray(blob_frame(rng, h, w, kp)).save(
            paths[-1], **({"quality": 90} if ext == "jpg" else {}))
    return paths


def _link(frames, names):
    for directory in {os.path.dirname(name) for name in names}:
        os.makedirs(directory, exist_ok=True)
    for i, name in enumerate(names):
        os.link(frames[i % len(frames)], name)


def _write_json(path, value):
    with open(path, "w") as f:
        f.write(json.dumps(value))


def write_fake_freihand(root):
    """FreiHAND_pub_v2's training layout at its frame size: the full
    32560-entry training_{K,mano,xyz}.json (61 MANO parameters an entry;
    hands 0.5-0.7 m from a camera of focal length 450-520 px, so they fill
    most of the 224² frame) and all 130240 image names of the four colour
    versions, since every name of the 3200-sample test split is read."""
    import numpy as np

    cfg = FAKE_TREES["freihand"]
    n, size = cfg["index"], cfg["frame"]
    rng = np.random.RandomState(2)
    rgb = os.path.join(root, "training", "rgb")
    os.makedirs(os.path.join(root, "evaluation"))
    frames = _frames(rng, os.path.join(root, "frames"), [(size, size)] * cfg["distinct_frames"],
                     21)
    focal = rng.uniform(450, 520, n)
    c = size / 2
    _write_json(os.path.join(root, "training_K.json"),
                [[[f, 0.0, c], [0.0, f, c], [0.0, 0.0, 1.0]] for f in focal.tolist()])
    _write_json(os.path.join(root, "training_mano.json"),
                (rng.randn(n, 1, 61) * 0.5).tolist())
    center = np.stack([rng.uniform(-0.03, 0.03, n), rng.uniform(-0.03, 0.03, n),
                       rng.uniform(0.5, 0.7, n)], axis=1)
    xyz = center[:, None, :] + rng.uniform(-1, 1, (n, 21, 3)) * [0.08, 0.08, 0.04]
    _write_json(os.path.join(root, "training_xyz.json"), xyz.tolist())
    _link(frames, [os.path.join(rgb, "%08d.jpg" % i) for i in range(cfg["versions"] * n)])


def write_fake_h36m(root):
    """The preprocessed Human3.6M layout that ``_preprocess`` writes:
    ``crop_images`` of 512² and ``annotations/keypoints2d_<part>.json`` for
    subjects 1, 5-9 and 11 (keypoints in crop pixels, 3D keypoints in camera
    millimetres 4-6 m away, intrinsics scaled to the crop)."""
    import numpy as np

    cfg = FAKE_TREES["h36m"]
    size, n = cfg["crop"], cfg["per_part"]
    rng = np.random.RandomState(3)
    frames = _frames(rng, os.path.join(root, "frames"), [(size, size)] * cfg["distinct_frames"],
                     16)
    os.makedirs(os.path.join(root, "annotations"))
    for part in cfg["parts"]:
        names = [f"s_{part:02d}/s_{part:02d}_{i:06d}.jpg" for i in range(n)]
        _link(frames, [os.path.join(root, "crop_images", name) for name in names])
        focal = rng.uniform(900, 1000, n)
        _write_json(os.path.join(root, "annotations", f"keypoints2d_{part}.json"), [
            {"name": name,
             "keypoint2d": rng.uniform(0.17 * size, 0.83 * size, (16, 2)).tolist(),
             "keypoint3d": (rng.uniform(-900, 900, (16, 3))
                            + [0, 0, rng.uniform(4500, 5500)]).tolist(),
             "intrinsic_matrix": [[f, 0.0, size / 2], [0.0, f, size / 2], [0.0, 0.0, 1.0]]}
            for name, f in zip(names, focal.tolist())])


def write_fake_surreal(root):
    """The processed SURREAL layout: ``train/run{0,1,2}``, ``val`` and
    ``test``, each with ``run{0,1,2}.json`` over 240² frames (24 SMPL joints
    a sample, 3-6 m from the camera); the test directory of 4000 samples,
    so that its split is 800 of the 3200 it holds at full size (a cut of
    scale for the script's time limit)."""
    import numpy as np

    cfg = FAKE_TREES["surreal"]
    size = cfg["frame"]
    rng = np.random.RandomState(4)
    frames = _frames(rng, os.path.join(root, "frames"), [(size, size)] * cfg["distinct_frames"],
                     24)
    for split in ("train", "val", "test"):
        for run in range(3):
            n = cfg[split] // 3
            names = ["img%06d.jpg" % i for i in range(n)]
            _link(frames, [os.path.join(root, split, f"run{run}", name) for name in names])
            _write_json(os.path.join(root, split, f"run{run}.json"), [
                {"name": name,
                 "keypoint2d": rng.uniform(0.12 * size, 0.88 * size, (24, 2)).tolist(),
                 "keypoint3d": (rng.uniform(-0.8, 0.8, (24, 3))
                                + [0, 0, rng.uniform(3.5, 5.5)]).tolist(),
                 "intrinsic_matrix": [[600.0, 0.0, size / 2], [0.0, 600.0, size / 2],
                                      [0.0, 0.0, 1.0]]}
                for name in names])


def write_fake_lsp(root):
    """LSP's layout: ``images/im0001.jpg``-``im2000.jpg`` of varied size,
    tall and wide, and a 2000-entry ``joints.mat`` (x, y and an occlusion
    bit for each of the 14 joints, inside each image's own frame)."""
    import numpy as np
    import scipy.io

    cfg = FAKE_TREES["lsp"]
    rng = np.random.RandomState(5)
    sizes = [(int(rng.randint(*cfg["height"])), int(rng.randint(*cfg["width"])))
             for _ in range(cfg["distinct_frames"])]
    frames = _frames(rng, os.path.join(root, "frames"), sizes, 14)
    n = cfg["images"]
    _link(frames, [os.path.join(root, "images", "im%04d.jpg" % (i + 1)) for i in range(n)])
    joints = np.zeros((3, 14, n))
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        joints[0, :, i] = rng.uniform(0.1 * w, 0.9 * w, 14)
        joints[1, :, i] = rng.uniform(0.1 * h, 0.9 * h, 14)
    joints[2] = rng.rand(14, n) < 0.15
    scipy.io.savemat(os.path.join(root, "joints.mat"), {"joints": joints})


def write_fake_h3d(root):
    """Hand-3D-Studio's cropped layout: ``H3D_crop/annotation.json`` and
    square crops, half of the samples holding an object (the ``noobject``
    task keeps the other half)."""
    import numpy as np

    cfg = FAKE_TREES["h3d"]
    size, n = cfg["crop"], cfg["samples"]
    rng = np.random.RandomState(6)
    base = os.path.join(root, "H3D_crop")
    frames = _frames(rng, os.path.join(root, "frames"), [(size, size)] * cfg["distinct_frames"],
                     21)
    names = [f"subject{i % 10}/{i:06d}.jpg" for i in range(n)]
    _link(frames, [os.path.join(base, name) for name in names])
    _write_json(os.path.join(base, "annotation.json"), [
        {"name": name, "without_object": i % 2,
         "keypoint2d": rng.uniform(0.2 * size, 0.8 * size, (21, 2)).tolist(),
         "keypoint3d": (rng.uniform(-0.08, 0.08, (21, 3))
                        + [0, 0, rng.uniform(0.4, 0.6)]).tolist(),
         "intrinsic_matrix": [[1000.0, 0.0, size / 2], [0.0, 1000.0, size / 2],
                              [0.0, 0.0, 1.0]]}
        for i, name in enumerate(names)])


# the four train_human.py lines of ``script``, in its order, and each run of
# phase trainer_pairs: (name, pair, extra flags, occlusion_warp launches)
SCRIPT_PAIRS = ("f2r", "s2h", "s2l", "r2h")
PAIR_RUNS = (("r2h", "r2h", ["--pretrain-epoch", "-1"], 3),
             ("s2h_pretrain", "s2h", ["--pretrain-epoch", "1"], 0),
             ("s2h", "s2h", ["--pretrain-epoch", "-1"], 3),
             ("s2l", "s2l", ["--pretrain-epoch", "-1"], 3),
             ("f2r", "f2r", ["--pretrain-epoch", "-1"], 3))


def script_line(pair):
    """The flags of ``script``'s train_human.py line for ``pair``, its two
    dataset roots first."""
    import shlex

    with open(os.path.join(REPO, "script")) as f:
        lines = [shlex.split(ln) for ln in f if ln.startswith("python train_human.py")]
    return lines[SCRIPT_PAIRS.index(pair)][2:]


def _rss_kb():
    """The process's resident set size (``/proc/self/statm``) and its peak
    (``getrusage``), in kB; the card's machine has no VmHWM line in
    ``/proc/self/status``."""
    import resource

    with open("/proc/self/statm") as f:
        resident_pages = int(f.read().split()[1])
    return {"rss": resident_pages * os.sysconf("SC_PAGE_SIZE") // 1024,
            "peak": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss}


def phase_trainer_pairs(device, work_dir):
    """The four human lines of ``script`` through the port's
    ``train_human.main`` in this process, each with its own flags and
    datasets on fake trees in their layouts (``write_fake_*``), random
    style weights, pose_resnet101 b=32 at 256²/64², -j as in trainer_cli,
    one epoch of 3 iterations: an adapt epoch for r2h, s2h, s2l and f2r,
    and a pretrain epoch for s2h. Each run's launches (occlusion_warp 3 an
    adapt epoch, none in pretraining), finite epoch lines and no worker
    left are required; each run prints its wall time, dataset construction
    time (build_data) and the parent's RSS after it and at the end, its
    first-batch wait, the median Time and Data of iterations 1-2, and each
    validation's seconds and items. Returns the launches of each run."""
    import multiprocessing

    import torch

    from uda_poseestimation_torch import train_human

    t0 = time.perf_counter()
    roots = {name: os.path.join(work_dir, name)
             for name in ("rhd", "freihand", "h36m", "surreal", "lsp", "h3d")}
    if not os.path.isdir(roots["rhd"]):  # phase trainer_cli's tree otherwise
        write_fake_rhd(roots["rhd"])
    for name, write in (("freihand", write_fake_freihand), ("h36m", write_fake_h36m),
                        ("surreal", write_fake_surreal), ("lsp", write_fake_lsp),
                        ("h3d", write_fake_h3d)):
        write(roots[name])
    write_style_weights(work_dir)
    fixture_s = time.perf_counter() - t0
    root_of = {"RenderedHandPose": "rhd", "FreiHand": "freihand", "Human36M": "h36m",
               "SURREAL": "surreal", "LSP": "lsp", "Hand3DStudio": "h3d"}
    workers = min(8, os.cpu_count() or 1)
    none = dict.fromkeys(_counters(), 0)
    build_data, run_validate = train_human.build_data, train_human.run_validate
    record = {}

    def timed_build(args, pin):
        t = time.perf_counter()
        out = build_data(args, pin)
        record["construct_s"] = time.perf_counter() - t
        record["rss_kb_after_construction"] = _rss_kb()
        return out

    def timed_validate(eval_step, model, loader, args, visualize=None):
        t = time.perf_counter()
        out = run_validate(eval_step, model, loader, args, visualize=visualize)
        record.setdefault("validation", []).append(
            {"s": time.perf_counter() - t, "items": len(loader.dataset)})
        return out

    launches = {}
    cwd, fuse_env = os.getcwd(), os.environ.pop("UDA_BN_FUSE", None)
    train_human.build_data, train_human.run_validate = timed_build, timed_validate
    os.chdir(work_dir)
    try:
        for name, pair, extra, warps in PAIR_RUNS:
            args = train_human.build_parser().parse_args(script_line(pair) + [
                "-a", TRAINER_ARCH, "-b", str(MAIN_B), "--test-batch", str(MAIN_B),
                "--image-size", str(MAIN_IMAGE), "--heatmap-size", str(MAIN_HEATMAP),
                "--epochs", "1", "-i", "3", "-p", "1", "-j", str(workers),
                "--decoder-name", "saved_models/decoder_rand.pth", "--device", str(device),
                "--log", f"logs/{name}"] + extra)
            args.source_root = roots[root_of[args.source]]
            args.target_root = roots[root_of[args.target]]
            record.clear()
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                _reset_counts()
                r0 = time.perf_counter()
                train_human.main(args)
                torch.cuda.synchronize()
                wall = time.perf_counter() - r0
                launches[name] = _read_counts()
            gc.collect()
            if multiprocessing.active_children():
                raise AssertionError(f"run {name} left {multiprocessing.active_children()}")
            want = dict(none, occlusion_warp=warps)
            if launches[name] != want:
                raise AssertionError(f"run {name}: launches {launches[name]}, needs {want}")
            log_dir = f"logs/{name}_{TRAINER_ARCH}"
            (log,) = [f for f in os.listdir(log_dir) if f.startswith("train-")]
            with open(os.path.join(log_dir, log)) as f:
                lines = _finite_lines(f.read(), ("Epoch: 0 ",))
            _finite_lines(printed.getvalue(), ("Epoch: [0][",))
            times = printed_times(printed.getvalue())
            (source_val, target_val) = record["validation"]
            emit({"phase": "trainer_pairs", "run": name, "source": args.source,
                  "target": args.target, "target_train": args.target_train,
                  "wall_s": wall, "construct_s": record["construct_s"],
                  "first_batch_s": times["first_batch_s"],
                  "time_s_median_1_2": statistics.median(times["time_s_each"][1:3]),
                  "data_s_median_1_2": statistics.median(times["data_s_each"][1:3]),
                  "validation_source": source_val, "validation_target": target_val,
                  "rss_kb_after_construction": record["rss_kb_after_construction"],
                  "rss_kb_end": _rss_kb(), "launches": launches[name], "log": lines,
                  "time_s_each": times["time_s_each"], "data_s_each": times["data_s_each"]})
    finally:
        os.chdir(cwd)
        train_human.build_data, train_human.run_validate = build_data, run_validate
        if fuse_env is not None:
            os.environ["UDA_BN_FUSE"] = fuse_env
    emit({"phase": "trainer_pairs", "workers": workers, "fake_trees": FAKE_TREES,
          "fixture_s": fixture_s, "seconds": time.perf_counter() - t0})
    return launches


# phase decoder: the reference's decoder batch (adain/train/train_human.py
# loads 4 a batch whatever --batch_size says), full width
DECODER_B = 4
DECODER_STEPS = 20
DECODER_CLI_ITERS = 40
# TF32 tensor-core peak of the H100 SXM (dense; NVIDIA data sheet)
TF32_FLOPS = 495e12


def decoder_net(seed, device):
    """The decoder trainer's meanstd StyleNet with random weights from
    ``seed``, the decoder's last kernel x100 (a random decoder's output is
    ~1e-3, and its style losses would be eps-dominated)."""
    import torch

    from uda_poseestimation_torch.models import StyleNet

    net = StyleNet("meanstd")
    net.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        net.decoder[28].weight.mul_(100.0)
    return net.to(device)


def decoder_images(seed, b, size, device):
    """A content and a style batch, NCHW, ImageNet-normalized uniform noise."""
    import torch

    g = torch.Generator().manual_seed(seed)
    mean = torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1)
    std = torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1)
    return [((torch.rand(b, 3, size, size, generator=g) - mean) / std).to(device)
            for _ in range(2)]


def decoder_step_flops(net, content):
    """The multiply-adds of one decoder step, x2, from the convolutions'
    shapes (hooks on one forward): three encodes (style, content, g_t),
    g_t's input gradient through the encoder (one more encode), the decoder's
    forward, its weight gradients and its input gradients (all but the first
    conv's: t needs none)."""
    import torch

    per_conv = []

    def hook(m, inputs, out):
        per_conv.append(2 * out.numel() * m.in_channels * m.kernel_size[0] * m.kernel_size[1])

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.no_grad():
            feat = net.encode(content)
            n_enc = len(per_conv)
            net.decode(feat)
    finally:
        for h in handles:
            h.remove()
    enc, dec = sum(per_conv[:n_enc]), sum(per_conv[n_enc:])
    return 4 * enc + 3 * dec - per_conv[n_enc]


@contextlib.contextmanager
def tf32(cudnn, matmul):
    """cuDNN's and cuBLAS's TF32 switches set inside, restored after (the
    script runs with both off)."""
    import torch

    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = cudnn, matmul
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _decoder_case(device, content, style, tf32_on):
    """One case of part 1: the first step's outputs from the seed's weights,
    2 warm-ups, then DECODER_STEPS steps timed by CUDA events, and the peak
    memory."""
    import torch

    from uda_poseestimation_torch.adain_engine import make_decoder_step

    with tf32(tf32_on, tf32_on):
        net = decoder_net(0, device)
        step, _ = make_decoder_step(net, 1.0, 1.0, 1e-5)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        first = [t.clone() for t in step(content, style)]
        for _ in range(2):
            step(content, style)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(DECODER_STEPS):
            step(content, style)
        end.record()
        torch.cuda.synchronize()
        # the host's own time for a step: each of 3 steps enqueued behind
        # ~50 ms of device work, with the launch queue empty
        host_ms = []
        for _ in range(3):
            torch.cuda._sleep(50 * SLEEP_CYCLES)
            h0 = time.perf_counter()
            step(content, style)
            host_ms.append((time.perf_counter() - h0) * 1e3)
            torch.cuda.synchronize()
    return first, {"ms_per_step": start.elapsed_time(end) / DECODER_STEPS,
                   "host_ms_per_step": statistics.median(host_ms),
                   "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def _cli_aug_flags():
    """The ``_stu``/``_tea`` augmentation flags of ``script``'s r2h line,
    which the AdaIN CLI takes too."""
    return _cli_aug_flags_of(script_line("r2h"))


def _cli_aug_flags_of(line):
    """The ``_stu``/``_tea`` flags of a ``script`` line and their values."""
    flags, keep = [], False
    for tok in line:
        if re.match(r"-+[a-z]", tok):  # a flag, not a negative value
            keep = tok.endswith(("_stu", "_tea"))
        if keep:
            flags.append(tok)
    return flags


def phase_decoder(device, work_dir):
    """AdaIN decoder pretraining (ROADMAP A11, human half), in four parts:

    1. the step alone at full width: the meanstd StyleNet with random
       weights from a seed, b=4, 256², float32, the CLI's weights and lr;
       ms/step by CUDA events over DECODER_STEPS steps after 2 warm-ups,
       and the peak memory, with TF32 off and on, and the host's time for a
       step with the card busy (median of 3); TF32's first-step losses and
       g_t held against full float32's within 5e-2 of the largest value,
       beside the step's FLOPs and its bound;
    2. one step on the card against the CPU, TF32 off, 64², b=2, from the
       same weights: losses, g_t and the decoder's gradients (each tensor)
       within 1e-3 of the largest value (cuDNN and the CPU sum in other
       orders through ~40 layers), the decoder's Adam update within 5e-2 in
       norm: Adam's first update is ~sign(g)·lr, so an entry whose gradient
       is near 0 may flip its sign and move by 2·lr (the sign flips are
       counted);
    3. the CLI (``uda_poseestimation_torch.adain.train_human.main``) in this
       process on fake RHD and H3D trees, RenderedHandPose -> Hand3DStudio_mt
       with the r2h line's augmentation flags, 256², DECODER_CLI_ITERS
       iterations, a checkpoint and a PNG every 20, at PyTorch's default
       TF32 settings (cuDNN's on): the log's finite lines, the PNGs and the
       checkpoint, the seconds per iteration (between step calls) and the
       time spent waiting for the loaders' batches;
    4. the chain: the port's ``train_human`` r2h adapt run, 3 iterations,
       with ``--decoder-name`` set to part 3's checkpoint; occlusion_warp
       launches 3 times.

    Returns the launches of parts 1, 3 and 4."""
    import copy
    import multiprocessing

    import torch

    from uda_poseestimation_torch import adain_engine, train_human
    from uda_poseestimation_torch.adain import train_human as adain_cli

    t0 = time.perf_counter()
    none = dict.fromkeys(_counters(), 0)
    launches = {}

    # 1. the step alone
    content, style = decoder_images(0, DECODER_B, MAIN_IMAGE, device)
    _reset_counts()
    firsts, records = {}, {}
    for name, tf32_on in (("f32", False), ("tf32", True)):
        firsts[name], records[name] = _decoder_case(device, content, style, tf32_on)
    launches["decoder_step"] = _read_counts()
    ref = firsts["f32"]
    errs = {key: _rel_max(firsts["tf32"][i], ref[i])
            for i, key in ((1, "loss_c"), (2, "loss_s"), (3, "g_t"))}
    records["tf32"]["rel_err_vs_f32"] = errs
    if not max(errs.values()) <= 5e-2:
        raise AssertionError(f"decoder step tf32 against f32: {errs} > 5e-2")
    flops = decoder_step_flops(decoder_net(0, device), content)
    emit({"phase": "decoder", "part": "step", "batch": DECODER_B, "size": MAIN_IMAGE,
          "steps_timed": DECODER_STEPS, "cases": records,
          "losses_f32": [float(t) for t in ref[:3]], "flops_per_step": flops,
          "bound_ms_f32": flops / F32_FLOPS * 1e3, "bound_ms_tf32": flops / TF32_FLOPS * 1e3,
          "launches": launches["decoder_step"]})
    if launches["decoder_step"] != none:
        raise AssertionError(f"decoder step launched {launches['decoder_step']}")
    del content, style
    gc.collect()
    torch.cuda.empty_cache()

    # 2. card against CPU
    nets = {"cpu": decoder_net(3, "cpu")}
    nets["card"] = copy.deepcopy(nets["cpu"]).to(device)
    dec0 = {k: v.clone() for k, v in nets["cpu"].decoder.state_dict().items()}
    outs = {}
    for side, dev in (("cpu", torch.device("cpu")), ("card", device)):
        c, s = decoder_images(4, 2, 64, dev)
        step, _ = adain_engine.make_decoder_step(nets[side], 1.0, 1.0, 1e-4)
        outs[side] = [t.cpu() for t in step(c, s)]
    upd = {side: torch.cat([(v.cpu() - dec0[k]).flatten()
                            for k, v in nets[side].decoder.state_dict().items()])
           for side in nets}
    flipped = int(((upd["card"] * upd["cpu"]) < 0).sum())
    parity = {"loss": _rel_max(outs["card"][0], outs["cpu"][0]),
              "loss_c": _rel_max(outs["card"][1], outs["cpu"][1]),
              "loss_s": _rel_max(outs["card"][2], outs["cpu"][2]),
              "g_t": _rel_max(outs["card"][3], outs["cpu"][3]),
              "grad": max(_rel_max(a.grad, b.grad) for a, b in zip(
                  nets["card"].decoder.parameters(), nets["cpu"].decoder.parameters())),
              "adam_update_norm": _rel_norm(upd["card"], upd["cpu"])}
    emit({"phase": "decoder", "part": "card_vs_cpu", "batch": 2, "size": 64, "rel_err": parity,
          "adam_update_sign_flips": flipped, "decoder_parameters": upd["cpu"].numel()})
    if not (max(parity[k] for k in ("loss", "loss_c", "loss_s", "g_t", "grad")) <= 1e-3
            and parity["adam_update_norm"] <= 5e-2):
        raise AssertionError(f"decoder step card against CPU: {parity}")

    # 3. the CLI
    roots = {"rhd": os.path.join(work_dir, "rhd"), "h3d": os.path.join(work_dir, "h3d")}
    if not os.path.isdir(roots["rhd"]):
        write_fake_rhd(roots["rhd"])
    if not os.path.isdir(roots["h3d"]):
        write_fake_h3d(roots["h3d"])
    write_style_weights(work_dir)
    exp = "decoder_r2h"
    args = adain_cli.build_parser().parse_args(
        ["--source", "RenderedHandPose", "--target", "Hand3DStudio_mt",
         "--source_root", roots["rhd"], "--target_root", roots["h3d"],
         "--vgg", "saved_models/vgg_normalised.pth", "--image-size", str(MAIN_IMAGE),
         "--max_iter", str(DECODER_CLI_ITERS), "--save_model_interval", "20",
         "--log_img_interval", "20", "--exp_name", exp, "--device", str(device)]
        + _cli_aug_flags())
    step_stamps, waits = [], []
    make_step, forever = adain_engine.make_decoder_step, adain_cli.ForeverDataIterator

    def timed_make_step(*a, **k):
        step, opt = make_step(*a, **k)
        return clocked(step, step_stamps), opt

    class TimedIterator(forever):
        def __next__(self):
            t = time.perf_counter()
            out = super().__next__()
            waits.append(time.perf_counter() - t)
            return out

    cwd = os.getcwd()
    adain_engine.make_decoder_step = timed_make_step
    adain_cli.ForeverDataIterator = TimedIterator
    os.chdir(work_dir)
    try:
        printed = io.StringIO()
        # PyTorch's defaults: cuDNN's TF32 on, cuBLAS's off
        with contextlib.redirect_stdout(printed), tf32(True, False):
            _reset_counts()
            r0 = time.perf_counter()
            adain_cli.main(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - r0
            launches["decoder_cli"] = _read_counts()
        gc.collect()
        if multiprocessing.active_children():
            raise AssertionError(f"the decoder CLI left {multiprocessing.active_children()}")
        root = os.path.join("logs", exp)
        with open(os.path.join(root, "log_" + exp + ".txt")) as f:
            lines = _finite_lines(f.read(), ("iter: ",))
        pngs = sorted(os.listdir(os.path.join(root, "save_imgs", "save_img_" + exp)))
        checkpoint = os.path.join(root, "saved_model", "decoder_" + exp + ".pth.tar")
        if (len(lines) != DECODER_CLI_ITERS or pngs != ["0.png", "20.png"]
                or not os.path.isfile(checkpoint) or "WARNING" in printed.getvalue()
                or launches["decoder_cli"] != none):
            raise AssertionError(f"decoder CLI: {len(lines)} lines, PNGs {pngs}, launches "
                                 f"{launches['decoder_cli']}, {printed.getvalue()[-500:]}")
        periods = [b - a for a, b in zip(step_stamps, step_stamps[1:])]
        fetch = [a + b for a, b in zip(waits[::2], waits[1::2])]
        emit({"phase": "decoder", "part": "cli", "iters": DECODER_CLI_ITERS, "wall_s": wall,
              "wall_s_per_iter": wall / DECODER_CLI_ITERS,
              "first_step_s": step_stamps[0] - r0,
              "period_s_median": statistics.median(periods[1:]),
              "fetch_s_median": statistics.median(fetch[1:]),
              "step_ms_f32_part1": records["f32"]["ms_per_step"],
              "step_ms_tf32_part1": records["tf32"]["ms_per_step"],
              "log": [lines[0], lines[-1]], "pngs": pngs, "launches": launches["decoder_cli"],
              "period_s_each": periods, "fetch_s_each": fetch})

        # 4. the chain: the trained decoder in the r2h adapt run
        workers = min(8, os.cpu_count() or 1)
        targs = train_human.build_parser().parse_args(script_line("r2h") + [
            "-a", TRAINER_ARCH, "-b", str(MAIN_B), "--test-batch", str(MAIN_B),
            "--image-size", str(MAIN_IMAGE), "--heatmap-size", str(MAIN_HEATMAP),
            "--epochs", "1", "-i", "3", "-p", "1", "-j", str(workers),
            "--pretrain-epoch", "-1", "--decoder-name", checkpoint, "--device", str(device),
            "--log", "logs/decoder_chain"])
        targs.source_root, targs.target_root = roots["rhd"], roots["h3d"]
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            _reset_counts()
            r0 = time.perf_counter()
            train_human.main(targs)
            torch.cuda.synchronize()
            chain_wall = time.perf_counter() - r0
            launches["decoder_chain"] = _read_counts()
        gc.collect()
        if multiprocessing.active_children():
            raise AssertionError(f"the chained run left {multiprocessing.active_children()}")
        if launches["decoder_chain"] != dict(none, occlusion_warp=3):
            raise AssertionError(f"chained run: launches {launches['decoder_chain']}")
        log_dir = f"logs/decoder_chain_{TRAINER_ARCH}"
        (log,) = [f for f in os.listdir(log_dir) if f.startswith("train-")]
        with open(os.path.join(log_dir, log)) as f:
            chain_lines = _finite_lines(f.read(), ("Epoch: 0 ",))
        _finite_lines(printed.getvalue(), ("Epoch: [0][",))
        emit({"phase": "decoder", "part": "chain", "decoder_name": checkpoint,
              "wall_s": chain_wall, "launches": launches["decoder_chain"], "log": chain_lines})
    finally:
        os.chdir(cwd)
        adain_engine.make_decoder_step, adain_cli.ForeverDataIterator = make_step, forever
    emit({"phase": "decoder", "seconds": time.perf_counter() - t0})
    return launches


# phase trainer_animals' fake trees (PERF.md section 4 states the sizes that
# no source records): the synthetic renders at 640x480, the size the dataset
# clips its boxes to; TigDog at 640x360 (a 16:9 video frame) in shots of 8
# frames; AnimalPose at 500x375. Each training set holds two or more batches
# of 32, each evaluation set at most 32 items a category (--test-batch 1).
ANIMAL_TREES = {
    "synthetic": {"animals": ("horse", "tiger"), "train": 48, "valid": 8, "frame": (480, 640),
                  "distinct_frames": 16},
    "tigdog": {"animals": ("horse", "tiger"), "shots": 7, "frames_per_shot": 8, "train": 40,
               "valid": 16, "frame": (360, 640), "distinct_frames": 16},
    "animal_pose": {"animals": ("dog", "sheep"), "train": 40, "test": 16, "frame": (375, 500),
                    "distinct_frames": 16},
}
# the bundled adapt runs' trees: the same frames and layouts with 20
# training batches of 32 a pass, so that 20 iterations read one whole pass
# and wait for no new one (the steady rate after the first bundle's
# warm-ups and captures)
ANIMAL_LONG_TREES = {"synthetic": dict(ANIMAL_TREES["synthetic"], train=320),
                     "tigdog": dict(ANIMAL_TREES["tigdog"], shots=45, train=320)}
ANIMAL_MEAN_STD = ([0.3999, 0.3909, 0.3871], [0.2589, 0.2431, 0.2291])
# blobs a fake frame: the annotations are drawn apart from them, and a blob
# costs an exp over the whole frame when the trees are written
ANIMAL_BLOBS = 6


def _save_mean(path, mean, std):
    import torch

    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"mean": torch.tensor(mean), "std": torch.tensor(std)}, path)


def _box_keypoints(rng, n, k, h, w, margin=0.15):
    """n sets of k (x, y) inside the middle of an h x w frame."""
    import numpy as np

    return np.stack([rng.uniform(margin * w, (1 - margin) * w, (n, k)),
                     rng.uniform(margin * h, (1 - margin) * h, (n, k))], axis=-1)


def write_fake_synthetic_animals(root, cfg=None):
    """The synthetic-animal layout under ``root/animal_data`` and
    ``root/cached_data``: horse and tiger renders (PNG, names linked to
    ``distinct_frames`` renders each), ``clean_data/keypoints_18.json`` (18
    visible keypoints, the box, train and valid indices, image paths
    relative to ``animal_data``'s parent as the reference writes them) and
    the 'all' mean file; and ``keypoints_14.json``, which serves the same
    renders as hound and sheep with their first 14 keypoints."""
    import numpy as np

    cfg = cfg or ANIMAL_TREES["synthetic"]
    h, w = cfg["frame"]
    n = cfg["train"] + cfg["valid"]
    rng = np.random.RandomState(7)
    data = {}
    for animal in cfg["animals"]:
        rel = f"animal_data/synthetic_animal/{animal}_combineds5r5_texture"
        frames = _frames(rng, os.path.join(root, "frames", animal),
                         [(h, w)] * cfg["distinct_frames"], ANIMAL_BLOBS, ext="png")
        names = [f"{rel}/{i:04d}_img.png" for i in range(n)]
        _link(frames, [os.path.join(root, name) for name in names])
        kp = _box_keypoints(rng, n, 18, h, w)
        data[animal] = {
            "keypoints": np.concatenate([kp, np.ones((n, 18, 1))], -1).tolist(),
            "imgpath": names,
            "bbox": [[float(p[:, 0].min()), float(p[:, 0].max()), float(p[:, 1].min()),
                      float(p[:, 1].max())] for p in kp],
            "train_idxs": list(range(cfg["train"])), "valid_idxs": list(range(cfg["train"], n))}
    clean = os.path.join(root, "animal_data", "clean_data")
    os.makedirs(clean)
    _write_json(os.path.join(clean, "keypoints_18.json"), data)
    other = {o: dict(data[a], keypoints=[kp[:14] for kp in data[a]["keypoints"]])
             for o, a in (("hound", "horse"), ("sheep", "tiger"))}
    _write_json(os.path.join(clean, "keypoints_14.json"), other)
    _save_mean(os.path.join(root, "cached_data", "synthetic_animal", "all_combineds5r5_texture",
                            "mean.pth.tar"), *ANIMAL_MEAN_STD)


def write_fake_tigdog(root, cfg=None):
    """TigDog's layout (behaviorDiscovery2.0): per animal ``ranges.mat``
    (shot, first frame, last frame), a ``landmarks/<shot>.mat`` per shot
    (18 keypoints and their visibility per frame), the frames, and the
    video-level train/valid index files under ``cached_data/real_animal``."""
    import numpy as np
    from scipy.io import savemat

    cfg = cfg or ANIMAL_TREES["tigdog"]
    h, w = cfg["frame"]
    rng = np.random.RandomState(8)
    base = os.path.join(root, "animal_data", "behaviorDiscovery2.0")
    for animal in cfg["animals"]:
        frames = _frames(rng, os.path.join(root, "frames", "tigdog_" + animal),
                         [(h, w)] * cfg["distinct_frames"], ANIMAL_BLOBS)
        n = cfg["shots"] * cfg["frames_per_shot"]
        _link(frames, [os.path.join(base, animal, "%08d.jpg" % (i + 1)) for i in range(n)])
        ranges = []
        os.makedirs(os.path.join(base, "landmarks", animal))
        for shot in range(cfg["shots"]):
            first = shot * cfg["frames_per_shot"] + 1
            ranges.append([shot + 1, first, first + cfg["frames_per_shot"] - 1])
            cells = np.empty((cfg["frames_per_shot"], 1), dtype=object)
            for f, kp in enumerate(_box_keypoints(rng, cfg["frames_per_shot"], 18, h, w)):
                rec = np.zeros((1, 1), dtype=[("coord", "O"), ("vis", "O")])
                rec[0, 0]["coord"] = kp
                rec[0, 0]["vis"] = (rng.rand(18, 1) > 0.1).astype(np.float64)
                cells[f, 0] = rec
            savemat(os.path.join(base, "landmarks", animal, f"{shot + 1}.mat"),
                    {"landmarks": cells})
        os.makedirs(os.path.join(base, "ranges", animal))
        savemat(os.path.join(base, "ranges", animal, "ranges.mat"),
                {"ranges": np.asarray(ranges, np.int64)})
        cached = os.path.join(root, "cached_data", "real_animal", animal)
        os.makedirs(cached)
        order = rng.permutation(n)
        np.save(os.path.join(cached, "train_idxs_by_video.npy"), np.sort(order[:cfg["train"]]))
        np.save(os.path.join(cached, "valid_idxs_by_video.npy"),
                np.sort(order[cfg["train"]:cfg["train"] + cfg["valid"]]))


def write_fake_animal_pose(root):
    """AnimalPose's layout: ``animal-pose/images``, the ``keypoints.json``
    image map, and per animal the train/test annotation arrays (a box, 20
    keypoints with visibility, category 5 or 2) under
    ``cached_data/real_animal_pose``, with the 'all' mean file
    (``tests/test_animal_data.py::fake_animal_pose``'s recipe, larger)."""
    import numpy as np

    cfg = ANIMAL_TREES["animal_pose"]
    h, w = cfg["frame"]
    rng = np.random.RandomState(9)
    images_dir = os.path.join(root, "animal_data", "animal-pose", "images")
    images = {}
    for animal, category in zip(cfg["animals"], (5, 2)):
        frames = _frames(rng, os.path.join(root, "frames", "pose_" + animal),
                         [(h, w)] * cfg["distinct_frames"], ANIMAL_BLOBS)
        n = cfg["train"] + cfg["test"]
        names = [f"{animal}_{i}.jpg" for i in range(n)]
        _link(frames, [os.path.join(images_dir, name) for name in names])
        annos = []
        for i, kp in enumerate(_box_keypoints(rng, n, 20, h, w)):
            images[f"{animal}_{i}"] = names[i]
            vis = (rng.rand(20, 1) > 0.1).astype(np.float64)
            annos.append({"image_id": f"{animal}_{i}",
                          "bbox": [float(kp[:, 0].min()) - 10, float(kp[:, 1].min()) - 10,
                                   float(kp[:, 0].max()) + 10, float(kp[:, 1].max()) + 10],
                          "keypoints": np.concatenate([kp, vis], -1).tolist(),
                          "num_keypoints": 20, "category_id": category})
        cached = os.path.join(root, "cached_data", "real_animal_pose", animal)
        os.makedirs(cached)
        np.save(os.path.join(cached, "train_anno.npy"),
                np.array(annos[:cfg["train"]], dtype=object))
        np.save(os.path.join(cached, "test_anno.npy"),
                np.array(annos[cfg["train"]:], dtype=object))
    _write_json(os.path.join(root, "animal_data", "animal-pose", "keypoints.json"),
                {"images": images})
    _save_mean(os.path.join(root, "cached_data", "real_animal_pose", "all", "mean.pth.tar"),
               [0.4042, 0.3977, 0.3974], [0.25, 0.24, 0.23])


def raw_animal_batch(rng, b, num_kpts, with_style=False):
    """A raw animal --device-aug batch as ``AnimalDeviceAugPipeline.
    raw_adapt_batch`` gives it from the loaders: the synthetic source's
    uint8 640x480 frames with their keypoints (visibility 1), box centers
    and scales, and the target's uint8 crops at MAIN_IMAGE with keypoints in
    a 640x360 frame, their visibility, centers and scales; page-locked.
    ``with_style`` adds the pretrain batch's style image (the identity
    teacher view, mean-normalized)."""
    import numpy as np
    import torch

    h, w = ANIMAL_TREES["synthetic"]["frame"]
    pts = np.concatenate([_box_keypoints(rng, b, num_kpts, h, w),
                          np.ones((b, num_kpts, 1))], -1).astype(np.float32)
    lo, hi = pts[..., :2].min(1), pts[..., :2].max(1)
    th, tw = ANIMAL_TREES["tigdog"]["frame"]
    kp_t = _box_keypoints(rng, b, num_kpts, th, tw).astype(np.float32)
    out = {"canvas_s": rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8), "pts_s": pts,
           "center_s": ((lo + hi) / 2).astype(np.float32),
           "scale_s": ((hi - lo).max(1) / 200.0 * 1.25).astype(np.float32),
           "canvas_t": rng.randint(0, 256, (b, MAIN_IMAGE, MAIN_IMAGE, 3)).astype(np.uint8),
           "kp_t": kp_t, "vis_t": (rng.rand(b, num_kpts) > 0.1).astype(np.float32),
           "center_t": ((kp_t.min(1) + kp_t.max(1)) / 2).astype(np.float32),
           "scale_t": ((kp_t.max(1) - kp_t.min(1)).max(1) / 200.0 * 1.25).astype(np.float32)}
    if with_style:
        out["image_t_style"] = (out["canvas_t"].astype(np.float32) / 255.0
                                - np.asarray(ANIMAL_MEAN_STD[0], np.float32))
    return {k: torch.from_numpy(v).pin_memory() for k, v in out.items()}


def animal_pipelines(device):
    """The animal --device-aug pipeline of the train_animal line's flags
    (``train_animal.device_aug_pipeline``, the synthetic source on the
    device) at MAIN_IMAGE/MAIN_HEATMAP, on ``device`` and on the CPU."""
    from types import SimpleNamespace

    from uda_poseestimation_torch import train_animal

    args = train_animal.build_parser().parse_args(
        animal_script_line("train_animal.py") + [
            "--image-size", str(MAIN_IMAGE), "--heatmap-size", str(MAIN_HEATMAP),
            "--inp-res", str(MAIN_IMAGE), "--out-res", str(MAIN_HEATMAP), "--device-aug"])
    source = SimpleNamespace(raw_mode=True, FLIP_DATASET="real_animal", num_keypoints=18,
                             mean=ANIMAL_MEAN_STD[0])
    return tuple(train_animal.device_aug_pipeline(args, source, d) for d in (device, "cpu"))


def _kernel_count(fn):
    """(kernels, device ms) of one call of ``fn`` in a torch.profiler trace,
    or (None, None) when the trace holds no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [ev for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and not ev.is_user_annotation]
    if not rows:
        return None, None
    return sum(ev.count for ev in rows), sum(ev.device_time_total for ev in rows) / 1e3


def _animal_views_card_vs_cpu(device, pipe, cpu_pipe, b=4):
    """The animal view builder on the card against the CPU on one small raw
    batch, from the same draws (made on the CPU, copied): the source's
    keypoint2d, target weights and the warp's nearest indices (an index
    image warped on both, the affine coefficients of the student draws)
    equal; the source's targets within 1e-6 of their peak; the source image
    within 1e-5 but for one bytescale level (1/255) at 0.1% of its values
    at most; the student and teacher views within 1e-6 at all but 0.1%; the
    aug_params within 1e-6."""
    import numpy as np
    import torch

    from uda_poseestimation_torch.ops.affine import inverse_affine_coeffs, warp_affine

    raw = {k: v[:b] for k, v in raw_animal_batch(np.random.RandomState(5), b, 18).items()}
    g = torch.Generator().manual_seed(4)
    draws = {"target": cpu_pipe.draw_target(b, g), "source": cpu_pipe.draw_source(b, g)}

    def on(tree, dev):
        return {k: on(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    raw_dev, draws_dev = on(raw, device), on(draws, device)
    want = cpu_pipe.view_builder(raw, draws=draws)
    got = pipe.view_builder(raw_dev, draws=draws_dev)
    src_args = [raw[k] for k in ("canvas_s", "pts_s", "center_s", "scale_s")]
    want_src = cpu_pipe.prep_source(*src_args, draws=draws["source"])
    got_src = pipe.prep_source(*(t.to(device) for t in src_args), draws=draws_dev["source"])
    d = draws["target"]["student"]
    coeffs = inverse_affine_coeffs(*(d[n][0] for n in ("angle", "trans_x", "trans_y",
                                                       "shear_x")),
                                   torch.zeros(b), d["scale"][0])
    index = torch.arange(MAIN_IMAGE ** 2, dtype=torch.float32).view(1, 1, MAIN_IMAGE, MAIN_IMAGE)
    index = index.expand(b, 1, MAIN_IMAGE, MAIN_IMAGE).contiguous()
    integer = {"keypoint2d_s": bool(torch.equal(got_src[3].cpu(), want_src[3])),
               "weight_s": bool(torch.equal(got["weight_s"].cpu(), want["weight_s"])),
               "warp_indices": bool(torch.equal(warp_affine(index, coeffs),
                                                warp_affine(index.to(device),
                                                            coeffs.to(device)).cpu()))}
    peak = float(want["target_s"].abs().max())
    floats = {"target_s": _mostly_close(got["target_s"], want["target_s"], 1e-6 * peak,
                                        share=0.0)}
    for name in ("image_t_stu", "images_t_tea"):
        floats[name] = _mostly_close(got[name], want[name], 1e-6)
    for name in ("aug_param_stu", "aug_params_tea"):
        floats[name] = _mostly_close(got[name], want[name], 1e-6, share=0.0)
    err = (got["image_s"].cpu() - want["image_s"]).abs()
    floats["image_s"] = (float((err > 1e-5).double().mean()),
                         float((err > 1e-5).double().mean()) <= 1e-3
                         and float(err.max()) <= 1.0 / 255 + 1e-5)
    result = {"batch": b, "integer_equal": integer,
              "off_share": {k: v[0] for k, v in floats.items()},
              "source_gates_fired": int(draws["source"]["gates"].sum()),
              "source_flips": int(draws["source"]["flip"].sum())}
    if not (all(integer.values()) and all(v[1] for v in floats.values())):
        raise AssertionError(f"animal views on the card against the CPU: {result}")
    return result


def animal_views_on_card(device):
    """The animal view builder on the card: against the CPU
    (``_animal_views_card_vs_cpu``); alone at b=MAIN_B with 18 keypoints
    (CUDA-event ms, then 8 calls' host enqueue and synchronized wall ms,
    its kernels and their device ms in a torch.profiler trace, and the
    bytes an iteration copies to the card against the host path's adapt
    batch); then the adapt and pretrain
    bundlers' graph replays with the views built inside held against eager
    steps (``_held_against_eager``, ``_pretrain_held_against_eager``) on a
    pose_resnet101 with 18 keypoints. Returns the record and the launches
    of the replay checks."""
    import numpy as np
    import torch

    from uda_poseestimation_torch.models import StyleNet, pose_resnet101
    from uda_poseestimation_torch.parallel import StepConfig, create_state

    t0 = time.perf_counter()
    pipe, cpu_pipe = animal_pipelines(device)
    record = {"card_vs_cpu": _animal_views_card_vs_cpu(device, pipe, cpu_pipe)}
    raw = raw_animal_batch(np.random.RandomState(0), MAIN_B, 18, with_style=True)
    raw_dev = {k: v.to(device) for k, v in raw.items()}
    build = pipe.pretrain_view_builder(True)
    views = {"adapt": lambda: pipe.view_builder(raw_dev),
             "pretrain": lambda: build(raw_dev, True)}
    for name, fn in views.items():
        event_ms = cuda_ms(fn, 10)  # after its own warm-up call
        enqueue, synchronized = [], []
        for _ in range(8):
            h0 = time.perf_counter()
            fn()
            h1 = time.perf_counter()
            torch.cuda.synchronize()
            enqueue.append((h1 - h0) * 1e3)
            synchronized.append((time.perf_counter() - h0) * 1e3)
        kernels, device_ms = _kernel_count(fn)
        record[f"{name}_builder"] = {"cuda_event_ms": event_ms,
                                     "host_enqueue_ms_each": enqueue,
                                     "synchronized_ms_each": synchronized,
                                     "kernels": kernels, "profiled_device_ms": device_ms}
    # what an iteration copies to the card: the raw leaves, against the host
    # path's adapt batch (make_adapt_batch) at the same sizes
    raw_adapt = {k: v for k, v in raw.items() if k != "image_t_style"}
    host_leaves = {"image_s": (MAIN_B, MAIN_IMAGE, MAIN_IMAGE, 3),
                   "target_s": (MAIN_B, 18, MAIN_HEATMAP, MAIN_HEATMAP),
                   "weight_s": (MAIN_B, 18, 1),
                   "image_t_stu": (MAIN_B, MAIN_IMAGE, MAIN_IMAGE, 3),
                   "images_t_tea": (MAIN_KV, MAIN_B, MAIN_IMAGE, MAIN_IMAGE, 3),
                   "aug_param_stu": (MAIN_B, 6), "aug_params_tea": (MAIN_KV, MAIN_B, 6)}
    record["h2d_bytes_per_adapt_iteration"] = {
        "device_aug": sum(t.numel() * t.element_size() for t in raw_adapt.values()),
        "host_aug": 4 * sum(int(np.prod(s)) for s in host_leaves.values())}
    record["views_s"] = time.perf_counter() - t0

    style = StyleNet()
    style.reset_parameters(torch.Generator().manual_seed(1))
    style.to(device=device, dtype=torch.bfloat16)
    cfg = StepConfig(k=MAIN_KV, gather_exact=False, style_io_dtype="bfloat16")
    state = create_state(pose_resnet101(num_keypoints=18, dtype=torch.bfloat16), cfg, seed=0,
                         device=device)
    _reset_counts()
    record["held_against_eager"] = {
        "adapt": _held_against_eager(device, state, style, raw_adapt,
                                     view_builder=pipe.view_builder, sync_check=True),
        "pretrain": _pretrain_held_against_eager(device, state, style, build, raw)}
    launches = _read_counts()
    record["replays_s"] = time.perf_counter() - t0 - record["views_s"]
    del state, style
    gc.collect()
    torch.cuda.empty_cache()
    return record, launches


def animal_script_line(program):
    """The flags of ``script``'s ``train_animal.py`` or
    ``train_animal_other.py`` line."""
    import shlex

    with open(os.path.join(REPO, "script")) as f:
        (line,) = [shlex.split(ln)[2:] for ln in f if ln.startswith(f"python {program} ")]
    return line


# phase trainer_animals' runs: (name, program, extra flags, occlusion_warp
# launches); "{decoder}" is the checkpoint of the AdaIN run, "{two_passes}"
# the iterations of two passes over the synthetic training set,
# "{two_passes_bundled}" the same rounded up to whole bundles of 4,
# "{long_tree}" the image path of ANIMAL_LONG_TREES
ANIMAL_RUNS = (
    ("adapt", "train_animal.py", ["--pretrain-epoch", "-1", "-i", "3"], 3),
    ("pretrain", "train_animal.py", ["--pretrain-epoch", "1", "-i", "3"], 0),
    ("other_adapt", "train_animal_other.py", ["--pretrain-epoch", "-1", "-i", "3"], 3),
    ("adapt_bundled", "train_animal.py",
     ["--pretrain-epoch", "-1", "--steps-per-dispatch", "4", "-i", "20", "--image-path",
      "{long_tree}"], 20),
    ("adain", None, [], 0),
    ("adapt_trained_decoder_decode_cache", "train_animal.py",
     ["--pretrain-epoch", "-1", "-i", "{two_passes}", "--decoder-name", "{decoder}",
      "--decode-cache", "1"], "{two_passes}"),
    ("adapt_device_aug", "train_animal.py", ["--pretrain-epoch", "-1", "-i", "3", "--device-aug"],
     3),
    ("pretrain_device_aug_bundled", "train_animal.py",
     ["--pretrain-epoch", "1", "-i", "4", "--device-aug", "--steps-per-dispatch", "4"], 0),
    ("adapt_device_aug_bundled_decode_cache", "train_animal.py",
     ["--pretrain-epoch", "-1", "-i", "{two_passes_bundled}", "--device-aug",
      "--steps-per-dispatch", "4", "--decode-cache", "1"], "{two_passes_bundled}"),
    ("adapt_device_aug_bundled", "train_animal.py",
     ["--pretrain-epoch", "-1", "--steps-per-dispatch", "4", "-i", "20", "--image-path",
      "{long_tree}", "--device-aug"], 20),
    ("other_adapt_device_aug", "train_animal_other.py",
     ["--pretrain-epoch", "-1", "-i", "3", "--device-aug"], 3),
)
# the host-path run each --device-aug run is read beside
ANIMAL_HOST_TWIN = {"adapt_device_aug": "adapt", "pretrain_device_aug_bundled": "pretrain",
                    "adapt_device_aug_bundled_decode_cache": "adapt_trained_decoder_decode_cache",
                    "adapt_device_aug_bundled": "adapt_bundled",
                    "other_adapt_device_aug": "other_adapt"}
ANIMAL_DECODER_ITERS = 40


def animal_item_ms(image_path, items=16):
    """Host ms an item (this process, one thread, after one warm item) of
    the train_animal line's training sets at MAIN_IMAGE/MAIN_HEATMAP: the
    synthetic source in raw mode (--device-aug: decode only) and with its
    imgaug chain, flip and crop (the host path), and the TigDog _mt set
    with identity views (--device-aug) and with its affine views (the
    host path)."""
    from uda_poseestimation_torch import data as tdata
    from uda_poseestimation_torch.data import transforms as T

    kw = dict(animal="all", image_path=image_path, inp_res=MAIN_IMAGE, out_res=MAIN_HEATMAP,
              sigma=1, scale_factor=0.25, rot_factor=30, label_type="Gaussian",
              train_on_all_cat=True)
    identity = T.Compose([T.IdentityAffine(), T.ToTensor()])
    affine = T.Compose([T.RandomAffineRotation(60, (-30, 30), (0.05, 0.05), (0.6, 1.3)),
                        T.ToTensor()])
    sets = {"synthetic_raw": lambda: tdata.synthetic_animal_sp_all(is_train=True,
                                                                   raw_mode=True, **kw),
            "synthetic_host_aug": lambda: tdata.synthetic_animal_sp_all(is_train=True, **kw),
            "tigdog_mt_identity_views": lambda: tdata.real_animal_all_mt(
                is_train=True, k=1, transforms_stu=identity, transforms_tea=identity, **kw),
            "tigdog_mt_affine_views": lambda: tdata.real_animal_all_mt(
                is_train=True, k=1, transforms_stu=affine, transforms_tea=affine, **kw)}
    out = {}
    with contextlib.redirect_stdout(io.StringIO()):
        for name, make in sets.items():
            ds = make()
            ds[0]
            n = min(items, len(ds) - 1)
            t = time.perf_counter()
            for i in range(1, n + 1):
                ds[i]
            out[name] = (time.perf_counter() - t) / n * 1e3
    return out


def phase_trainer_animals(device, work_dir):
    """The two animal lines of ``script`` through the port's
    ``train_animal.main`` in this process (``train_animal_other`` runs the
    same main with dog and sheep), on fake trees in the datasets' layouts
    (``write_fake_synthetic_animals``, ``write_fake_tigdog``,
    ``write_fake_animal_pose``) with random style weights, pose_resnet101
    b=32 at 256²/64², -j as in trainer_cli, one epoch (ANIMAL_RUNS): the
    train_animal line adapting, pretraining, bundled (--steps-per-dispatch
    4, 20 iterations on ANIMAL_LONG_TREES: the other trees' passes of 2-3
    batches make every few iterations wait for a new pass), and with the
    decoder that the AdaIN animal CLI trains here for ANIMAL_DECODER_ITERS
    iterations and --decode-cache 1, over two passes of the synthetic
    training set (6 iterations at b=32; the TigDog set's third); the
    train_animal_other line adapting. Each run's launches (occlusion_warp
    once an adapt iteration, none in pretraining or the AdaIN CLI), finite
    epoch lines with their two category parts, the AdaIN CLI's two PNGs and
    checkpoint, and no worker left are required; each run prints its wall
    time, dataset construction time (build_data), first-batch wait, the
    median Time and Data of the iterations after the first, the mean Time
    of those after the first dispatch (a bundled run prints one Time a
    bundle, so its mean is the rate), each validation's seconds and items,
    the parent's RSS, and for --decode-cache the frame caches' counts.
    Returns the launches of each run. The --device-aug runs follow, each
    read beside its host-path twin (ANIMAL_HOST_TWIN); before the runs,
    ``animal_item_ms`` times each training set's items on the host and
    ``animal_views_on_card`` checks and times the animal view builder."""
    import multiprocessing

    import torch

    from uda_poseestimation_torch import train_animal
    from uda_poseestimation_torch.adain import train_animal as adain_cli

    t0 = time.perf_counter()
    root = os.path.join(work_dir, "animals")
    write_fake_synthetic_animals(root)
    write_fake_tigdog(root)
    write_fake_animal_pose(root)
    long_root = os.path.join(work_dir, "animals_long")
    write_fake_synthetic_animals(long_root, ANIMAL_LONG_TREES["synthetic"])
    write_fake_tigdog(long_root, ANIMAL_LONG_TREES["tigdog"])
    write_style_weights(work_dir)
    fixture_s = time.perf_counter() - t0
    image_path = os.path.join(root, "animal_data")
    workers = min(8, os.cpu_count() or 1)
    none = dict.fromkeys(_counters(), 0)
    build_data, run_validate = train_animal.build_data, train_animal.run_validate
    record = {}

    def timed_build(args, pin, eval_categories):
        t = time.perf_counter()
        out = build_data(args, pin, eval_categories)
        record["construct_s"] = time.perf_counter() - t
        record["rss_kb_after_construction"] = _rss_kb()
        record["datasets"] = (out.train_source_dataset, out.train_target_loader.dataset)
        record["source_items"] = out.train_source_loader.dataset
        return out

    def timed_validate(eval_step, model, loader, args, visualize=None):
        t = time.perf_counter()
        out = run_validate(eval_step, model, loader, args, visualize=visualize)
        record.setdefault("validation", []).append(
            {"s": time.perf_counter() - t, "items": len(loader.dataset)})
        return out

    cfg = ANIMAL_TREES["synthetic"]
    per_pass = len(cfg["animals"]) * cfg["train"] // MAIN_B
    fill = {"{two_passes}": str(2 * per_pass),
            "{two_passes_bundled}": str(-(-2 * per_pass // 4) * 4),
            "{long_tree}": os.path.join(long_root, "animal_data")}
    runs = {}
    cwd, fuse_env = os.getcwd(), os.environ.pop("UDA_BN_FUSE", None)
    cache_env = os.environ.get("UDA_CACHED_DATA_DIR")
    os.environ["UDA_CACHED_DATA_DIR"] = os.path.join(root, "cached_data")
    train_animal.build_data, train_animal.run_validate = timed_build, timed_validate
    os.chdir(work_dir)
    try:
        item_ms = animal_item_ms(image_path)
        views, view_launches = animal_views_on_card(device)
        emit({"phase": "trainer_animals", "host_ms_per_item": item_ms, "views": views,
              "launches": view_launches})
        launches = {"views_held_against_eager": view_launches}
        for name, program, extra, warps in ANIMAL_RUNS:
            record.clear()
            printed = io.StringIO()
            if program is None:  # the AdaIN animal CLI
                os.environ["UDA_CACHED_DATA_DIR"] = os.path.join(root, "cached_data")
                args = adain_cli.build_parser().parse_args(
                    ["--source", "synthetic_animal_sp_all", "--target_ssl",
                     "real_animal_all_mt", "--image-path", image_path, "--train_on_all_cat",
                     "--vgg", "saved_models/vgg_normalised.pth", "--image-size",
                     str(MAIN_IMAGE), "--inp-res", str(MAIN_IMAGE), "--out-res",
                     str(MAIN_HEATMAP), "--max_iter", str(ANIMAL_DECODER_ITERS),
                     "--save_model_interval", "20", "--log_img_interval", "20",
                     "--exp_name", "decoder_animal", "--device", str(device)]
                    + _cli_aug_flags_of(animal_script_line("train_animal.py")))
                with contextlib.redirect_stdout(printed), tf32(True, False):
                    _reset_counts()
                    r0 = time.perf_counter()
                    adain_cli.main(args)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - r0
                    launches[name] = _read_counts()
                out = os.path.join("logs", "decoder_animal")
                with open(os.path.join(out, "log_decoder_animal.txt")) as f:
                    lines = _finite_lines(f.read(), ("iter: ",))
                pngs = sorted(os.listdir(os.path.join(out, "save_imgs",
                                                      "save_img_decoder_animal")))
                fill["{decoder}"] = os.path.join(out, "saved_model",
                                                 "decoder_decoder_animal.pth.tar")
                if (len(lines) != ANIMAL_DECODER_ITERS or pngs != ["0.png", "20.png"]
                        or not os.path.isfile(fill["{decoder}"])
                        or "WARNING" in printed.getvalue()):
                    raise AssertionError(f"AdaIN animal CLI: {len(lines)} lines, PNGs {pngs}, "
                                         f"{printed.getvalue()[-500:]}")
                run = {"wall_s": wall, "wall_s_per_iter": wall / ANIMAL_DECODER_ITERS,
                       "log": [lines[0], lines[-1]], "pngs": pngs}
            else:
                argv = animal_script_line(program) + [
                    "--image-path", image_path, "-a", TRAINER_ARCH, "-b", str(MAIN_B),
                    "--image-size", str(MAIN_IMAGE), "--heatmap-size", str(MAIN_HEATMAP),
                    "--inp-res", str(MAIN_IMAGE), "--out-res", str(MAIN_HEATMAP),
                    "--epochs", "1", "-p", "1", "-j", str(workers),
                    "--decoder-name", "saved_models/decoder_rand.pth", "--device", str(device),
                    "--log", f"logs/animal_{name}"] + [fill.get(tok, tok) for tok in extra]
                args = train_animal.build_parser().parse_args(argv)
                # the index and mean files of the run's tree
                os.environ["UDA_CACHED_DATA_DIR"] = os.path.join(
                    os.path.dirname(args.image_path), "cached_data")
                categories = ("dog", "sheep") if program == "train_animal_other.py" \
                    else ("horse", "tiger")
                with contextlib.redirect_stdout(printed):
                    _reset_counts()
                    r0 = time.perf_counter()
                    train_animal.main(args, eval_categories=categories)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - r0
                    launches[name] = _read_counts()
                log_dir = f"logs/animal_{name}_{TRAINER_ARCH}"
                (log,) = [f for f in os.listdir(log_dir) if f.startswith("train-")]
                with open(os.path.join(log_dir, log)) as f:
                    lines = _finite_lines(f.read(), ("Epoch: 0 ",))
                if not all(f" {c.capitalize()}: " in lines[0] for c in categories):
                    raise AssertionError(f"run {name}: epoch line {lines[0]}")
                _finite_lines(printed.getvalue(), ("Epoch: [0][",))
                times = printed_times(printed.getvalue())
                source_val, target_val, *category_vals = record["validation"]
                run = {"program": program, "source": args.source, "target": args.target,
                       "target_ssl": args.target_ssl, "wall_s": wall,
                       "construct_s": record["construct_s"],
                       "first_batch_s": times["first_batch_s"],
                       "time_s_median_after_first": statistics.median(times["time_s_each"][1:]),
                       "time_s_mean_after_first_dispatch": (
                           statistics.fmean(after) if (after := times["time_s_each"][
                               max(1, args.steps_per_dispatch or 1):]) else None),
                       "data_s_median_after_first": statistics.median(times["data_s_each"][1:]),
                       "validation_source": source_val, "validation_target": target_val,
                       "validation_categories": dict(zip(categories, category_vals)),
                       "rss_kb_after_construction": record["rss_kb_after_construction"],
                       "log": lines, "time_s_each": times["time_s_each"],
                       "data_s_each": times["data_s_each"]}
                if args.decode_cache:
                    caches = {side: ds._frames for side, ds in
                              zip(("source", "target"), record["datasets"])}
                    if args.device_aug:  # the raw source's items: a CachedDataset
                        caches["source"] = record["source_items"]
                    run["decode_cache"] = {side: {"hits": c.hits, "misses": c.misses,
                                                  "items_cached": c.items_cached,
                                                  "bytes_used": c.bytes_used}
                                           for side, c in caches.items()}
                    used = caches["target"].bytes_used  # the frame arena of the run
                    if args.device_aug:
                        used = caches["source"].bytes_used
                        # every source item decoded once in the first pass, a
                        # hit in each later fetch (whole passes of whole
                        # batches; the last pass may be prefetched in part)
                        n_src = len(cfg["animals"]) * cfg["train"]
                        c = caches["source"]
                        if not (c.items_cached == c.misses == n_src
                                and c.hits >= args.iters_per_epoch * MAIN_B - n_src):
                            raise AssertionError(f"run {name}: cache {run['decode_cache']}")
                    if not (all(c.hits > 0 for c in caches.values())
                            and 0 < used <= args.decode_cache * 1e9):
                        raise AssertionError(f"run {name}: cache {run['decode_cache']}")
            record.clear()
            gc.collect()
            if multiprocessing.active_children():
                raise AssertionError(f"run {name} left {multiprocessing.active_children()}")
            want = dict(none, occlusion_warp=int(fill.get(warps, warps)))
            if launches[name] != want:
                raise AssertionError(f"run {name}: launches {launches[name]}, needs {want}")
            runs[name] = run
            emit({"phase": "trainer_animals", "run": name, **run, "rss_kb_end": _rss_kb(),
                  "launches": launches[name]})
    finally:
        os.chdir(cwd)
        train_animal.build_data, train_animal.run_validate = build_data, run_validate
        if fuse_env is not None:
            os.environ["UDA_BN_FUSE"] = fuse_env
        if cache_env is None:
            os.environ.pop("UDA_CACHED_DATA_DIR", None)
        else:
            os.environ["UDA_CACHED_DATA_DIR"] = cache_env
    keys = ("wall_s", "first_batch_s", "time_s_median_after_first",
            "time_s_mean_after_first_dispatch",
            "data_s_median_after_first", "decode_cache")
    emit({"phase": "trainer_animals", "device_aug_beside_host": {
        name: {"device_aug": {k: runs[name].get(k) for k in keys},
               "host": {k: runs[host].get(k) for k in keys}}
        for name, host in ANIMAL_HOST_TWIN.items()},
        "card": torch.cuda.get_device_name(device), "nvidia_smi": nvidia_smi_line()})
    emit({"phase": "trainer_animals", "workers": workers, "fake_trees": ANIMAL_TREES,
          "long_trees": ANIMAL_LONG_TREES, "fixture_s": fixture_s,
          "seconds": time.perf_counter() - t0})
    return launches


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

    seconds = {"build": time.perf_counter() - t0}

    def timed(name, fn, *fn_args, **fn_kwargs):
        t = time.perf_counter()
        out = fn(*fn_args, **fn_kwargs)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t
        return out

    shapes = fused_gemm_shapes(resnet101(fuse_bn=True), MAIN_B, 256)
    rows = {"occlusion_warp": timed("kernel", phase_kernel_occlusion_warp, device),
            "matmul_stats": timed("kernel", phase_kernel_matmul_stats, device, shapes),
            "warp_gather": timed("kernel", phase_kernel_warp_gather, device)}
    timed("parity", phase_parity, device)
    timed("parity", phase_parity, device, fuse_bn=True)
    main_run = timed("main", phase_main, device, args.profile)
    gc.collect()
    torch.cuda.empty_cache()
    fused_run = timed("main_bn_fuse", phase_main, device, args.profile, fuse_bn=True,
                      unfused=main_run)
    gc.collect()
    torch.cuda.empty_cache()
    # the later phases' files (fixture, weights, logs, checkpoints) live in a
    # directory of the checkout that is removed afterwards
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=REPO) as work_dir:
        bundled_launches = timed("bundled", phase_bundled, device, work_dir, args.profile)
        gc.collect()
        torch.cuda.empty_cache()
        device_aug_launches = timed("device_aug", phase_device_aug, device, work_dir,
                                    args.profile)
        gc.collect()
        torch.cuda.empty_cache()
        engine_launches, checkpoint = timed("trainer_engine", phase_trainer_engine, device,
                                            work_dir, main_run, args.profile)
        gc.collect()
        torch.cuda.empty_cache()
        cli_launches = timed("trainer_cli", phase_trainer_cli, device, work_dir, checkpoint)
        gc.collect()
        torch.cuda.empty_cache()
        pair_launches = timed("trainer_pairs", phase_trainer_pairs, device, work_dir)
        gc.collect()
        torch.cuda.empty_cache()
        decoder_launches = timed("decoder", phase_decoder, device, work_dir)
        gc.collect()
        torch.cuda.empty_cache()
        animal_launches = timed("trainer_animals", phase_trainer_animals, device, work_dir)
    emit({"phase_seconds": seconds})
    # each row's launches are those of the path it lies on (warp_gather: none),
    # in all and in the last measured adapt step; then every path's own count
    by_path = {"main": main_run["launches"], "main_bn_fuse": fused_run["launches"],
               **{f"bundled_{k}": v for k, v in bundled_launches.items()},
               **{f"device_aug_{k}": v for k, v in device_aug_launches.items()},
               **{f"trainer_engine_{k}": v for k, v in engine_launches.items()},
               **{f"trainer_cli_{k}": v for k, v in (cli_launches or {}).items()},
               **{f"trainer_pairs_{k}": v for k, v in pair_launches.items()},
               **decoder_launches,
               **{f"trainer_animals_{k}": v for k, v in animal_launches.items()}}
    for name, run in (("occlusion_warp", main_run), ("matmul_stats", fused_run),
                      ("warp_gather", main_run)):
        rows[name]["launches"] = run["launches"][name]
        rows[name]["launches_per_adapt_step"] = run["launches_per_adapt_step"][name]
        rows[name]["launches_by_path"] = {path: n[name] for path, n in by_path.items()}

    emit({"kernels": list(rows.values())})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
