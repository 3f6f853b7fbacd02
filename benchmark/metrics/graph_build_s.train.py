"""Host seconds the bundler spends building its CUDA graphs, per epoch
begun, in the window before the profile could begin: its eager warm-ups
and captures (the spans ``bundler.warm_up`` and ``bundler.capture``). The
window starts at an epoch's start, so this holds the epoch's rebuild after
its new generator (the bundler's ``reset_reasons`` say why it rebuilt),
and a gate case's first build when the case is first drawn in that
stretch: that depends on the seed (PERF.md §6)."""

import math

from benchmark.spans import window_spans


def read(run, cell):
    spans = window_spans(run, cell)
    if not spans or "bundler.stage" not in spans:
        return None
    epochs = max(1, math.ceil(spans.get("engine.fetch", (0,))[0] / cell.traffic["iters_per_epoch"]))
    return sum(spans.get(n, (0, 0.0))[1] for n in ("bundler.warm_up", "bundler.capture")) / epochs
