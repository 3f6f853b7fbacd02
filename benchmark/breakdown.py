"""A traced run of one cell, with the breakdown that ``trace.summarize`` does
not give: the sub-window's idle time split by the span the host was in,
its longest idle gaps named by the program's spans (``spans.idle_split``),
the bundler's graph builds and resets in the window, and the program's
spans over the whole window outside the sub-window.

    python3 benchmark/breakdown.py --workload <cell> --seed <n> --seconds <s>

Runs the cell's driver as ``run.py --trace 1`` does and prints one JSON
line. Times in ``builds``, ``resets`` and ``sub_window`` are seconds from
the window's start; ``outside`` is {span: [count, host seconds]}.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BUILDS = ("bundler.warm_up", "bundler.capture")


class _Reasons(collections.Counter):
    """A bundler's ``reset_reasons`` that also keeps when each was counted."""

    def __init__(self):
        super().__init__()
        self.at = []

    def __setitem__(self, key, value):
        self.at.append((time.perf_counter(), key))
        super().__setitem__(key, value)


def breakdown(cell, device) -> dict:
    from benchmark import harness, spans, trace
    from uda_poseestimation_torch import parallel
    from uda_poseestimation_torch.utils import trace as program

    split, bundlers, edges = {}, [], []
    summarize, sub_window = trace.summarize, trace.SubWindow

    def summarize_and_split(events):
        split.update(spans.idle_split(events))
        return summarize(events)

    class Window(sub_window):
        def begin(self):
            super().begin()
            edges.append(self._t0)

        def end(self):
            if self.active:
                super().end()
                edges.append(time.perf_counter())

    class Bundler(parallel.AdaptStepBundler):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.reset_reasons = _Reasons()
            bundlers.append(self)

    patches = [(trace, "summarize", summarize_and_split), (trace, "SubWindow", Window),
               (parallel, "AdaptStepBundler", Bundler)]
    saved = [(m, name, getattr(m, name)) for m, name, _ in patches]
    for m, name, value in patches:
        setattr(m, name, value)
    try:
        run = harness.load_module("drivers", cell.traffic["driver"]).run(cell, device)
    finally:
        for m, name, value in saved:
            setattr(m, name, value)

    t0 = run["window_t0"]
    t1 = t0 + run["window_s"]
    begin, end = (edges + [t1, t1])[:2]
    ns = [round(t * 1e9) for t in (t0, begin, end, t1)]
    log = [s for s in program.recent() if ns[0] <= s[1] and s[2] <= ns[3]]
    outside = collections.defaultdict(lambda: [0, 0.0])
    for name, a, b in log:
        if b <= ns[1] or a >= ns[2]:
            outside[name][0] += 1
            outside[name][1] += (b - a) / 1e9
    t = run.get("trace") or {}
    return {
        "workload": cell.name, "seed": cell.seed, "correct": run["correct"], "e2e": run["e2e"],
        "per_layer": {k: v["value"] for k, v in harness.per_layer(cell, run).items()},
        "sub_window": [begin - t0, end - t0], "window_s": t.get("window_s"),
        "busy_s": t.get("busy_s"), "idle_s": (t["window_s"] - t["busy_s"]) if t else None,
        **split,
        "builds": [[(a - ns[0]) / 1e9, name, (b - a) / 1e9] for name, a, b in log
                   if name in BUILDS],
        "resets": [[at - t0, why] for b in bundlers for at, why in b.reset_reasons.at
                   if t0 <= at <= t1],
        "outside": dict(outside),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    from benchmark import harness, run

    run._cache_dirs()
    cell = harness.load_cell(args.workload)
    cell.seed, cell.seconds, cell.trace = args.seed, args.seconds, True
    harness.require_devices(cell.chips)
    import torch

    print(json.dumps(breakdown(cell, torch.device("cuda", 0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
