"""Model FLOPs of the sub-window's unbundled training steps over its time,
against the configuration's peak (%)."""

from benchmark.readers import mfu_pct


def read(run, cell):
    return mfu_pct(run, cell)
