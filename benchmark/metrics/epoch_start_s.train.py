"""Host seconds from an adaptation epoch's call to its first CUDA-graph
replay: the epoch's eager warm-ups and captures (the bundler drops its
graphs with each epoch's new generator)."""


def read(run, cell):
    return (run.get("counters") or {}).get("epoch_start_s")
