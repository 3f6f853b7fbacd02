"""Model FLOPs of the sub-window's decoder steps over its time, against the
TF32 peak (%)."""

from benchmark.readers import mfu_pct


def read(run, cell):
    return mfu_pct(run, cell)
