"""Serving-path throughput benchmark: the exported ``torch.export`` artifact.

The twin of the repository's ``tools/serve_benchmark.py``: images/s of an
``export_inference`` artifact (weights inside, dynamic batch, no import of
this package needed to serve) at one batch size, with the argmax decode.

On the card one stream orders the calls, so the throughput loop is ``reps``
calls of the artifact between two CUDA events and one synchronize at the
end: nothing else is dispatched in it. A second loop synchronizes after
every call and gives the latency of one request at the batch: its median,
and its 90th percentile from 10 reps on. On the CPU both loops read the
host's clock.

    python -m uda_poseestimation_torch.tools.serve_benchmark [--arch pose_resnet101]
        [--batch 64] [--image-size 256] [--reps 30] [--checkpoint CKPT]
        [--artifact OUT.pt2]  # an exported artifact, timed as it is
        [--device cuda|cpu]   # default: the card

With ``--artifact`` nothing is built or exported; ``--arch`` and
``--checkpoint`` are ignored, and the image size must be the artifact's.
Without it the model (the checkpoint's, or random weights from seed 0, in
bf16) is exported, saved and loaded back, as a serving process loads it.

Prints one JSON line: {"metric", "value", "unit", "batch", "ms_per_batch"}
as the JAX harness does, and "latency_ms_median", "latency_ms_p90",
"dtype", "device", "peak_memory_bytes" (the card only), "artifact_bytes".
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from .. import models
from ..device import resolve_device
from .export_inference import (artifact_meta, export_model, load_artifact, load_model,
                               save_artifact)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(call, images, reps: int, device) -> dict:
    """Time ``call(images)`` after two warm-up calls: ms per call over
    ``reps`` calls in a row (CUDA events on the card, one synchronize at the
    end), then ``reps`` calls each synchronized (the latency of one
    request)."""
    device = torch.device(device)
    with torch.no_grad():
        for _ in range(2):
            call(images)
        _sync(device)
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                call(images)
            end.record()
            torch.cuda.synchronize(device)
            ms = start.elapsed_time(end) / reps
        else:
            t = time.perf_counter()
            for _ in range(reps):
                call(images)
            ms = (time.perf_counter() - t) * 1e3 / reps
        latency = []
        for _ in range(reps):
            t = time.perf_counter()
            call(images)
            _sync(device)
            latency.append((time.perf_counter() - t) * 1e3)
    return {"ms_per_batch": ms, "latency_ms_median": statistics.median(latency),
            "latency_ms_p90": (statistics.quantiles(latency, n=10)[-1]
                               if reps >= 10 else None)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description="Throughput of the exported torch.export inference artifact")
    p.add_argument("--arch", default="pose_resnet101")
    p.add_argument("--num-keypoints", type=int, default=21)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--reps", type=int, default=30)
    p.add_argument("--checkpoint", default=None,
                   help="optional trained checkpoint (the port's, the JAX "
                        "package's or the reference's); omitted -> random "
                        "weights (throughput does not depend on them)")
    p.add_argument("--which", default="teacher")
    p.add_argument("--artifact", default=None,
                   help="an exported artifact to time as it is (skips the "
                        "model build and the export; --arch/--checkpoint "
                        "are ignored)")
    p.add_argument("--device", default=None,
                   help="the device to serve on (default: the card; 'cpu' "
                        "for the test lane)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    t0 = time.monotonic()

    def say(msg):
        print(f"[serve-bench] {msg} (t={time.monotonic() - t0:.0f}s)",
              file=sys.stderr, flush=True)

    S, K = args.image_size, args.num_keypoints
    say(f"device={dev}")
    with tempfile.TemporaryDirectory() as tmp:
        if args.artifact:
            path, label = args.artifact, os.path.basename(args.artifact)
        else:
            if args.checkpoint:
                model = load_model(args.checkpoint, args.arch, K, args.which, device=dev)
            else:
                model = getattr(models, args.arch)(num_keypoints=K, dtype=torch.bfloat16,
                                                   fuse_bn=False)
                model.reset_parameters(torch.Generator().manual_seed(0))
            say(f"exporting ({dev.type})")
            path, label = os.path.join(tmp, "model.pt2"), args.arch
            save_artifact(export_model(model, S, dev), path,
                          artifact_meta(model, args.arch, S))
            del model
        exported, meta = load_artifact(path, dev)
        size = os.path.getsize(path)
    say(f"artifact {label} ({size / 1e6:.1f} MB)")

    images = torch.from_numpy(
        np.random.RandomState(0).rand(args.batch, S, S, 3).astype(np.float32)).to(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    say(f"measuring {args.reps} calls")
    timing = measure(exported.module(), images, args.reps, dev)
    record = {
        "metric": f"serving images/sec/chip (torch.export artifact, {label} "
                  f"b={args.batch} {S}px {meta['dtype']}, argmax decode included)",
        "value": args.batch / timing["ms_per_batch"] * 1e3,
        "unit": "images/sec/chip",
        "batch": args.batch,
        **timing,
        "dtype": meta["dtype"],
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        "artifact_bytes": size,
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
