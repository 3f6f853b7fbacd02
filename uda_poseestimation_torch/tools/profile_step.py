"""Profile the port's adaptation step and attribute its device time.

The twin of the repository's ``tools/profile_step.py``: the same flagship
configuration as bench.py (pose_resnet101, 21 keypoints, b=32, 256² images,
64² heatmaps, k=1, bf16, both style directions firing, occlusion on), a
warm-up step, then a ``torch.profiler`` trace of a few steps in a row. It
writes the Chrome trace (``trace.json``) and the profiler's own per-op
table (``ops.json``: self device time and calls of every op, from
``key_averages()``) under the output directory, and prints the top ops by
self device time a step (by self CPU time when no device time was
recorded, as on the CPU).

    python -m uda_poseestimation_torch.tools.profile_step [--steps N] [--out DIR]
    python -m uda_poseestimation_torch.tools.profile_step --parse-only --out DIR

``--device cpu`` with ``--arch``, ``--batch``, ``--image-size``,
``--heatmap-size`` and ``--keypoints`` runs a small configuration on the
CPU; the card is the default.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time

import numpy as np
import torch

from .. import models
from ..device import resolve_device
from ..models import StyleNet
from ..ops import generate_target_batch
from ..parallel import StepConfig, create_state, make_adapt_step


def activities():
    """What torch.profiler records here: the CPU, and CUDA with a card."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def synthetic_batch(rng, b, kv, size, hm_size, num_kpts):
    """The JAX tool's synthetic batch (tools/profile_step.py:43-60),
    keypoints and augmentation ranges scaled to ``size``."""
    scale = size / 256
    kp = rng.uniform(20 * scale, 230 * scale, size=(b, num_kpts, 2)).astype(np.float32)
    target, weight = generate_target_batch(kp, np.ones((b, num_kpts), np.float32),
                                           (hm_size, hm_size), 2.0, (size, size))
    aug = np.stack([
        rng.uniform(-60, 60, b), np.round(rng.uniform(-12, 12, b) * scale),
        np.round(rng.uniform(-12, 12, b) * scale), rng.uniform(-30, 30, b),
        rng.uniform(-30, 30, b), rng.uniform(0.6, 1.3, b)], -1).astype(np.float32)
    return {
        "image_s": rng.rand(b, size, size, 3).astype(np.float32),
        "target_s": target.numpy(), "weight_s": weight.numpy(),
        "image_t_stu": rng.rand(b, size, size, 3).astype(np.float32),
        "images_t_tea": rng.rand(kv, b, size, size, 3).astype(np.float32),
        "aug_param_stu": aug, "aug_params_tea": np.stack([aug] * kv),
    }


def _op_rows(prof):
    """(name, device us, self CPU us, calls) of every entry the profiler
    averaged. On a card the kernels (and memcpys, memsets) are entries of
    their own, whose device time is their self time; an operator's device
    time repeats its kernels', so only the kernels' is kept."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        kernel = ev.device_type == DeviceType.CUDA and not ev.is_user_annotation
        rows.append({"name": ev.key, "self_device_us": float(ev.device_time_total) if kernel
                     else 0.0, "self_cpu_us": 0.0 if kernel else float(ev.self_cpu_time_total),
                     "calls": int(ev.count)})
    return rows


def run_trace(out_dir: str, n_steps: int, device=None, arch: str = "pose_resnet101",
              batch: int = 32, image_size: int = 256, heatmap_size: int = 64,
              keypoints: int = 21) -> dict:
    """Build the flagship step on ``device``, run one warm-up step, trace
    ``n_steps`` steps and write ``trace.json`` and ``ops.json`` into
    ``out_dir``. Returns ``{"steps", "wall_ms_per_step", "ops"}``."""
    dev = resolve_device(device)
    cfg = StepConfig(image_size=image_size, heatmap_size=heatmap_size, k=1,
                     gather_exact=False, style_io_dtype="bfloat16")
    model = models.__dict__[arch](num_keypoints=keypoints, dtype=torch.bfloat16)
    state = create_state(model, cfg, seed=0, device=dev)
    style = StyleNet()
    style.reset_parameters(torch.Generator().manual_seed(1))
    style.to(device=dev, dtype=torch.bfloat16)  # frozen: bf16 storage
    host = synthetic_batch(np.random.RandomState(0), batch, 1, image_size, heatmap_size,
                           keypoints)
    data = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    step = make_adapt_step(cfg, style_model=style, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def run():
        _, metrics, _ = step(state, data, 1e-4, do_s2t=True, alpha_s2t=0.5, do_t2s=True,
                             alpha_t2s=0.5, generator=gen)
        return metrics["loss_all"]

    def wait(t):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return float(t)

    wait(run())  # warm-up: plans, optimizer state, kernels built
    os.makedirs(out_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities()) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            loss = run()
        wait(loss)
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    out = {"steps": n_steps, "wall_ms_per_step": wall_ms, "ops": _op_rows(prof),
           "config": {"arch": arch, "batch": batch, "image_size": image_size,
                      "heatmap_size": heatmap_size, "keypoints": keypoints,
                      "device": str(dev)}}
    with open(os.path.join(out_dir, "ops.json"), "w") as f:
        json.dump(out, f)
    print(f"trace written to {out_dir}", flush=True)
    return out


def parse_trace(out_dir: str, n_steps=None, top: int = 45) -> list:
    """Print the top ops of ``out_dir/ops.json`` by self device time a step
    (self CPU time when the trace recorded no device time), one by one and
    grouped by name with the trailing digits and template arguments cut.
    Returns the printed per-op rows: name, ms a step, calls a step."""
    with open(os.path.join(out_dir, "ops.json")) as f:
        table = json.load(f)
    steps = n_steps or table["steps"]
    key = "self_device_us" if any(r["self_device_us"] > 0 for r in table["ops"]) \
        else "self_cpu_us"
    rows = sorted(({"name": r["name"], "ms_per_step": r[key] / 1e3 / steps,
                    "calls_per_step": r["calls"] / steps} for r in table["ops"]
                   if r[key] > 0), key=lambda r: -r["ms_per_step"])
    where = "device" if key == "self_device_us" else "CPU (no device time recorded)"
    print(f"\n=== top ops by self {where} time, {table['config']['device']}, "
          f"{steps} steps, {table['wall_ms_per_step']:.3f} ms a step under the profiler ===")
    print(f"total self time: {sum(r['ms_per_step'] for r in rows):.3f} ms/step")
    print(f"{'ms/step':>9}  {'calls':>7}  op")
    for r in rows[:top]:
        print(f"{r['ms_per_step']:9.3f}  {r['calls_per_step']:7.1f}  {r['name'][:160]}")
    groups = {}
    for r in rows:
        name = re.sub(r"<.*>", "<>", re.sub(r"_?\d+$", "", r["name"]))
        groups[name] = groups.get(name, 0.0) + r["ms_per_step"]
    print(f"\n{'ms/step':>9}  op group")
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1])[:top]:
        print(f"{ms:9.3f}  {name[:160]}")
    return rows[:top]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default="logs/profile_step")
    ap.add_argument("--parse-only", action="store_true")
    ap.add_argument("--top", type=int, default=45)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--arch", default="pose_resnet101")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--image-size", type=int, default=256)
    ap.add_argument("--heatmap-size", type=int, default=64)
    ap.add_argument("--keypoints", type=int, default=21)
    args = ap.parse_args(argv)
    if not args.parse_only:
        run_trace(args.out, args.steps, device=args.device, arch=args.arch,
                  batch=args.batch, image_size=args.image_size,
                  heatmap_size=args.heatmap_size, keypoints=args.keypoints)
    return parse_trace(args.out, None, args.top)


if __name__ == "__main__":
    main()
