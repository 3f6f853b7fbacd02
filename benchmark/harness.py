"""What every cell shares: the cell's files found by name, the device
checks, the JAX check, the per-layer readers and the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); the mix names its driver
(``drivers/<driver>.py``), and each per-layer metric has its reader
(``metrics/<metric>.py``). The limits of the comparison that decides
``correct`` are the cell's own (``limits/<cell>.json``). Nothing here knows
a cell, a mix or a metric by name.
"""

from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level modules that may not be loaded in a run that prints a result
FORBIDDEN = ("jax", "jaxlib", "flax", "uda_poseestimation_tpu")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list
    per_layer: list
    seed: int = 0
    seconds: float = 10.0
    trace: bool = False


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    spec = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    config = next(c for c in spec["configs"] if c["name"] == w["config"])
    return Cell(
        name=name,
        config=_read_json(root / config["file"]),
        traffic=_read_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=_read_json(HERE / "limits" / f"{name}.json"),
        chips=w["chips"],
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
    )


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (a metric's name may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def require_devices(n: int):
    """Exit non-zero, printing no result, without ``n`` CUDA devices."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        sys.stderr.write(f"benchmark: needs {n} CUDA device(s), found {count}\n")
        raise SystemExit(3)


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def nvidia_smi() -> dict:
    """The card's name, power limit, clocks and draw, as nvidia-smi reads them."""
    q = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"error": str(e)}
    return {"query": q, "rows": out.splitlines()}


def per_layer(cell: Cell, run: dict) -> dict:
    """Each per-layer metric's reader on the run; one that finds nothing to
    read returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        value = load_module("metrics", m["name"]).read(run, cell)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def end_to_end(cell: Cell, run: dict):
    """(name, value, unit) of each end-to-end metric of the cell: ``setup_s``
    from the run's set-up, the others as the driver measured them."""
    for m in cell.end_to_end:
        value = run["setup_s"] if m["name"] == "setup_s" else run["e2e"][m["name"]]
        yield m["name"], value, m["unit"]


def _number(x):
    """A JSON number: a non-finite reading becomes the largest double."""
    if x is None:
        return None
    return x if math.isfinite(x) else 1.7976931348623157e308

def checks_line(checks: list) -> dict:
    """The compared numbers, each beside its limit: name -> [value, limit]."""
    return {c["name"]: [_number(c["value"]), _number(c["limit"])] for c in checks}


def print_result(cell: Cell, run: dict, metrics: dict, device: dict):
    checks = run["checks"]
    for c in checks:
        ok = "ok" if c["ok"] else "FAILED"
        sys.stderr.write(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} {ok}\n")
    result = {"correct": run["correct"], "attempted": run["attempted"],
              "failed": run["failed"], "metrics": metrics, "device": device}
    if run.get("breakdown"):
        result["breakdown"] = run["breakdown"]
    result["checks"] = checks_line(checks)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
