"""Median host milliseconds to enqueue one call of the serving artifact,
without a synchronize (``bench.serve_call``)."""

import statistics


def read(run, cell):
    ms = run.get("enqueue_ms")
    return statistics.median(ms) if ms else None
