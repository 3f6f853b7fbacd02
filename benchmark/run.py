"""The benchmark of ``uda_poseestimation_torch`` on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` in this process: set-up (weights and
batches from ``--seed``, every shape warmed), a window of ``--seconds``,
then the comparison with the plain reference that decides ``correct``.
With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiled sub-window. The
last line of standard output is the result (JSON); the numbers compared,
each beside its limit, are the last lines of standard error.

Exits non-zero, printing no result, without the CUDA devices the cell asks
for, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _cache_dirs():
    """Kernel caches inside the checkout, at fixed paths."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "benchmark" / "_cache" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "benchmark" / "_cache" / "torch_ext"))
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    cell.seed, cell.seconds, cell.trace = args.seed, args.seconds, bool(args.trace)
    harness.require_devices(cell.chips)
    import torch

    device = torch.device("cuda", 0)
    smi = harness.nvidia_smi()
    driver = harness.load_module("drivers", cell.traffic["driver"])
    run = driver.run(cell, device)
    # set-up: from the process's start (imports, device, builds, weights,
    # warm-up) to the window's
    run["setup_s"] = run["window_t0"] - T_START
    loaded = harness.forbidden_loaded()
    if loaded:
        sys.stderr.write(f"benchmark: modules loaded that the port may not use: {loaded}\n")
        return 4
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": cell.chips, "memory_peak_bytes": run["memory_peak_bytes"]}
    if cell.trace:
        trace = run.get("trace") or {}
        device_info.update(busy_s=trace.get("busy_s", 0.0), window_s=trace.get("window_s", 0.0))
        run["breakdown"] = {"device_ops": trace.get("device_ops", []),
                            "idle_gaps": trace.get("idle_gaps", [])}
        metrics = harness.per_layer(cell, run)
    else:
        metrics = {name: {"value": value, "unit": unit} for name, value, unit in
                   harness.end_to_end(cell, run)}
    sys.stderr.write(f"benchmark: {cell.name} seed {cell.seed}: setup_s {run['setup_s']!r} "
                     f"({run.get('setup_parts')}), "
                     f"window_s {run['window_s']!r}, process_s "
                     f"{time.perf_counter() - T_START!r}, nvidia-smi {smi}, "
                     f"counters {run.get('counters')}, info {run.get('info')}\n")
    harness.print_result(cell, run, metrics, device_info)
    return 0


if __name__ == "__main__":
    sys.exit(main())
