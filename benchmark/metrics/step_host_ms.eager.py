"""Host milliseconds in the unbundled adapt step's body (``adapt.step``) a
step, before the profile begins: the enqueue of its ~8200 device
operations."""

from benchmark.spans import per_step_ms


def read(run, cell):
    return per_step_ms(run, cell, "adapt.step", ("adapt.step",))
