"""Model FLOPs of the sub-window's served batches over its time, against the
bf16 peak (%)."""

from benchmark.readers import mfu_pct


def read(run, cell):
    return mfu_pct(run, cell)
