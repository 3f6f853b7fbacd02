"""Host milliseconds of the unbundled epoch loop a step, before the
profile begins: the batch and gate draws (``engine.fetch``), the wait
for the step's metrics (``engine.readback``), the meters and the log
(``engine.log``)."""

from benchmark.spans import per_step_ms


def read(run, cell):
    return per_step_ms(run, cell, "adapt.step", ("engine.fetch", "engine.readback", "engine.log"))
