"""Host milliseconds to enqueue the decoder step and its losses' copies
(``decoder.step``) an iteration, before the profile begins."""

from benchmark.spans import per_step_ms


def read(run, cell):
    return per_step_ms(run, cell, "decoder.step", ("decoder.step",))
