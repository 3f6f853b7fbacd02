"""Device operations recorded in the sub-window over its training steps."""

from benchmark.readers import launches_per_step


def read(run, cell):
    return launches_per_step(run)
