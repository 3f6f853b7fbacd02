"""Host milliseconds of the decoder loop an iteration, before the
profile begins: the batches' fetch and copy (``decoder.fetch``), the
wait for the previous step (``decoder.readback``), its log line and PNG
(``decoder.log``) and the decoder file (``decoder.save``)."""

from benchmark.spans import per_step_ms


def read(run, cell):
    return per_step_ms(run, cell, "decoder.step",
                       ("decoder.fetch", "decoder.readback", "decoder.log", "decoder.save"))
