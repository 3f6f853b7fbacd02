"""Driver of batch serving: the exported ``torch.export`` artifact
(``tools/export_inference.py``) over a seeded pool of image batches.

Set-up exports the seed's model as users do (``export_model``,
``save_artifact`` into ``TMPDIR``, then ``load_artifact``) and calls the
artifact on each batch size it will see. The window is a closed loop that
keeps ``in_flight`` requests queued on the card: a request is a batch of
host images (page-locked), copied to the card and served by one call of
the artifact; it is timed from when its call was enqueued to when the host
sees its completion event. A seeded sample of the window's requests keeps
its outputs, which the reference's forward of the same images judges after
the window.
"""

from __future__ import annotations

import collections
import os
import random
import statistics
import tempfile
import time

import torch

from benchmark import compare, flops, inputs
from benchmark.loop import Clock, memory_peak, release, sync
from benchmark.reference.models import PoseResNet
from benchmark.reference.precision import computing_in, set_fp8
from benchmark.reference.steps import serve_forward
from benchmark.trace import SubWindow


def pool(cfg, traffic, seed, device):
    tr = dict(traffic, batch=traffic["serve_batch"])
    return inputs.image_batches(tr, cfg["image_size"], seed, device, traffic["pool"], stream=7)


def sampled(seed: int, index: int, rate: float) -> bool:
    """Whether request ``index`` of a run is in the seed's sample."""
    return random.Random(seed * 1000003 + index).random() < rate


def reference_model(cfg, seed, device, precision="f32"):
    model = PoseResNet(cfg["num_keypoints"], tuple(cfg["stage_sizes"]), cfg["deconv_dim"])
    model.load_state_dict(inputs.pose_weights(cfg, seed, device))
    model.to(device)
    if precision == "fp8":
        set_fp8(model)
    return model


def reference_numbers(cfg, traffic, seed, device, kept, precision="f32"):
    """The worst of each number over the kept requests, (index, outputs)."""
    images = pool(cfg, traffic, seed, device)
    model = reference_model(cfg, seed, device, precision)
    worst = {}
    with computing_in(precision, device):
        for index, outputs in kept:
            want = serve_forward(model, images[index % len(images)])
            for k, v in compare.serving_numbers(outputs, want).items():
                worst[k] = max(worst.get(k, 0.0), v)
    return worst


def run(cell, device) -> dict:
    from uda_poseestimation_torch.models.pose_resnet import PoseResNet as Program
    from uda_poseestimation_torch.models.resnet import Bottleneck, ResNet
    from uda_poseestimation_torch.tools import export_inference as ei

    cfg, tr = cell.config, cell.traffic
    parts, t = {}, time.perf_counter()
    model = Program(ResNet(Bottleneck, cfg["stage_sizes"], fuse_bn=False), cfg["num_keypoints"],
                    dtype=getattr(torch, cfg["precision"])).to(device)
    model.load_state_dict(inputs.pose_weights(cfg, cell.seed, device))
    with tempfile.TemporaryDirectory(prefix="bench_serve_") as tmp:
        path = os.path.join(tmp, "model.pt2")
        exported = ei.export_model(model, cfg["image_size"], device)
        parts["export_s"] = time.perf_counter() - t
        ei.save_artifact(exported, path, ei.artifact_meta(model, cfg["model"], cfg["image_size"]))
        parts["save_s"] = time.perf_counter() - t
        del model, exported
        release(device)
        program = ei.load_artifact(path, device)[0].module()
        parts["load_s"] = time.perf_counter() - t
    pin = device.type == "cuda"
    host = [inputs.to_host(x, pin) for x in pool(cfg, tr, cell.seed, device)]
    release(device)

    def call(images):
        with torch.no_grad():
            return program(images.to(device, non_blocking=True))

    for images in host[:2]:  # every shape warm: the batch size served
        call(images)
    sync(device)
    parts["warm_s"] = time.perf_counter() - t

    clock = Clock()
    sub = SubWindow(device, tr["trace_after_s"], tr["trace_s"]) if cell.trace else None
    batch_flops = flops.serve_batch_flops(cfg, tr["serve_batch"])
    queue = collections.deque()
    latencies, enqueue_ms, kept = [], [], []
    issued = 0
    cuda = device.type == "cuda"
    clock.start(cell.seconds)
    while True:
        while len(queue) < tr["in_flight"] and not clock.expired:
            t0 = time.perf_counter()
            with torch.profiler.record_function("bench.serve_call"):
                out = call(host[issued % len(host)])
            enqueue_ms.append((time.perf_counter() - t0) * 1e3)
            done = torch.cuda.Event() if cuda else None
            if cuda:
                done.record()
            if sampled(cell.seed, issued, tr["sample_rate"]) and len(kept) < tr["sample_max"]:
                kept.append((issued, tuple(o.clone() for o in out)))
            queue.append((t0, done))
            issued += 1
        if not queue:
            break
        t0, done = queue.popleft()
        with torch.profiler.record_function("bench.wait"):
            if done is not None:
                done.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        if sub is not None:
            if sub.active:
                sub.count_step(1, flops=batch_flops)
            sub.due(clock.elapsed())
    sync(device)
    window_s = time.perf_counter() - clock.t0
    if sub is not None:
        sub.end()
    peak = memory_peak(device)
    trace = sub.summary() if sub is not None else {}
    if not kept:  # a window too short for the sample still judges its last request
        kept.append((issued - 1, tuple(o.clone() for o in out)))
    del program, out, queue
    release(device)
    numbers = reference_numbers(cfg, tr, cell.seed, device, kept)
    checks = compare.judge(numbers, cell.limits["numbers"])
    p95 = (statistics.quantiles(latencies, n=20)[18] if len(latencies) >= 20
           else max(latencies))
    return {
        "window_t0": clock.t0, "setup_parts": parts, "window_s": window_s,
        "e2e": {tr["metrics"]["rate"]: len(latencies) * tr["serve_batch"] / window_s,
                tr["metrics"]["p95"]: p95},
        "attempted": len(latencies), "failed": 0, "checks": checks,
        "correct": all(c["ok"] for c in checks), "memory_peak_bytes": peak, "trace": trace,
        "enqueue_ms": enqueue_ms,
        "counters": {"requests": len(latencies), "latency_ms_median": statistics.median(latencies),
                     "enqueue_ms_median": statistics.median(enqueue_ms),
                     "sampled": [i for i, _ in kept]},
        "info": {"numbers": numbers},
    }


def control_numbers(cell, seed: int, device, kind: str) -> dict:
    """The reference in the program's place, its convolutions in float8 (one
    precision below bfloat16), against the float32 reference, on the
    requests a run of ``seed`` would sample."""
    cfg, tr = cell.config, cell.traffic
    if kind != "control":
        raise ValueError(f"serving has no fault {kind!r} of its own")
    images = pool(cfg, tr, seed, device)
    index = [i for i in range(10000) if sampled(seed, i, tr["sample_rate"])][:tr["sample_max"]]
    low = reference_model(cfg, seed, device, "fp8")
    with computing_in("fp8", device):
        kept = [(i, serve_forward(low, images[i % len(images)])) for i in index]
    del low
    return reference_numbers(cfg, tr, seed, device, kept)
