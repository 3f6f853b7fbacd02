"""Share of the unbundled training sub-window in which nothing ran on the device (%)."""

from benchmark.readers import idle_pct


def read(run, cell):
    return idle_pct(run)
