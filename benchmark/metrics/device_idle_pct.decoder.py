"""Share of the decoder loop's sub-window in which nothing ran on the
device (%)."""

from benchmark.readers import idle_pct


def read(run, cell):
    return idle_pct(run)
