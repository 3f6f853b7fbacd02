"""Arithmetic the per-layer readers (``metrics/<metric>.py``) share. Each
returns None where the run has nothing to read."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def _device_trace(run):
    """The traced sub-window, if the device ran anything in it."""
    t = run.get("trace") or {}
    return t if t.get("window_s") and t.get("busy_s") else None


def idle_pct(run):
    t = _device_trace(run)
    if t is None:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu_pct(run, cell):
    """Model FLOPs of the sub-window's steps over its time, against the
    configuration's peak."""
    t = _device_trace(run)
    if t is None or not t.get("flops"):
        return None
    return 100.0 * t["flops"] / t["window_s"] / PEAKS[cell.config["peak"]]


def launches_per_step(run):
    t = _device_trace(run)
    if t is None or not t.get("steps"):
        return None
    return t["n_kernels"] / t["steps"]


def kernel_roofline_pct(run, match: str, bytes_key: str):
    """A memory-bound kernel's bytes at the HBM rate over its device time a
    launch; the kernel is found by ``match`` in its name."""
    t = _device_trace(run) or {}
    hits = [v for name, v in (t.get("kernels") or {}).items() if match in name]
    launches = sum(v[0] for v in hits)
    if not launches or not run.get(bytes_key):
        return None
    seconds = sum(v[1] for v in hits) / launches
    return 100.0 * run[bytes_key] / PEAKS["hbm_bytes_per_s"] / seconds
