"""Share of the serving sub-window in which nothing ran on the device (%)."""

from benchmark.readers import idle_pct


def read(run, cell):
    return idle_pct(run)
