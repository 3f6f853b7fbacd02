"""Readings that the limits of ``correct`` are set from (PERF.md): the
program's numbers on many seeds, the control's and each planted fault's on
a few, for one cell, in one process on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1-12 \\
        --control-seeds 101-103 [--seconds 1] [--out logs/readings.jsonl]

Each program seed is a whole run of the cell with a short window; the
controls are the cell driver's ``control_numbers``. One JSON line a reading.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _seeds(text):
    if "-" in text:
        a, b = text.split("-")
        return list(range(int(a), int(b) + 1))
    return [int(s) for s in text.split(",") if s]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="1-12")
    p.add_argument("--control-seeds", default="101-103")
    p.add_argument("--kinds", default="control,half_batch")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", default="logs/readings.jsonl")
    args = p.parse_args(argv)
    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    harness.require_devices(cell.chips)
    device = torch.device("cuda", 0)
    driver = harness.load_module("drivers", cell.traffic["driver"])
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as out:
        def emit(rec):
            rec = dict(rec, workload=cell.name, device=torch.cuda.get_device_name(device))
            out.write(json.dumps(rec) + "\n")
            out.flush()
            print(json.dumps(rec), flush=True)

        emit({"nvidia_smi": harness.nvidia_smi()})
        kinds = [k for k in args.kinds.split(",") if k]
        control_seeds = _seeds(args.control_seeds)
        # a driver that reads the controls in its own run (from the program's
        # state) gives them for the control seeds among the program seeds
        along = "control_kinds" in inspect.signature(driver.run).parameters
        done = set()
        for seed in _seeds(args.seeds):
            cell.seed, cell.seconds, cell.trace = seed, args.seconds, False
            t = time.perf_counter()
            with_controls = along and seed in control_seeds
            run = (driver.run(cell, device, control_kinds=kinds) if with_controls
                   else driver.run(cell, device))
            emit({"kind": "program", "seed": seed, "numbers": run["info"]["numbers"],
                  "info": run["info"], "e2e": run["e2e"], "s": time.perf_counter() - t,
                  "setup_parts": run.get("setup_parts"), "memory_peak_bytes":
                  run["memory_peak_bytes"]})
            for kind, numbers in (run.get("controls") or {}).items():
                emit({"kind": kind, "seed": seed, "numbers": numbers})
            if with_controls:
                done.add(seed)
        for kind in kinds:
            for seed in [s for s in control_seeds if s not in done]:
                t = time.perf_counter()
                emit({"kind": kind, "seed": seed,
                      "numbers": driver.control_numbers(cell, seed, device, kind),
                      "s": time.perf_counter() - t})


if __name__ == "__main__":
    main()
