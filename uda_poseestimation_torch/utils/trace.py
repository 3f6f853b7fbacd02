"""Spans of the port's host loops.

``span(name)`` times a stretch of host code. On closing it appends
``(name, start_ns, end_ns)`` (``time.perf_counter_ns``) to a log of the
last ``LOG`` spans, and holds its own length in ``seconds``. While a torch
profiler records, the span is also a ``record_function`` of the same name:
a kineto event on the device's clock, nested as the code nests, which a
profile of the run shows with no switch. With no profiler recording it
enters none (a ``record_function`` costs a dispatcher call even then).

``recent()`` is the log, oldest first; ``counters(start_ns, end_ns)`` sums
it into ``{name: (count, seconds)}`` over the spans that lie within a
stretch of time, so callers name the stretch rather than take deltas.

The spans:

- ``engine.fetch``, ``engine.readback``, ``engine.log``: the epoch loops
  (``engine.py``): an iteration's batch and gate draws (and a bundle's
  stacking), the host's wait for a step's or a bundle's metrics, the
  meters and the log;
- ``adapt.step``, ``pretrain.step``: the steps' bodies
  (``parallel/train_step.py``), which a CUDA-graph replay does not run;
- ``bundler.stage``, ``bundler.warm_up``, ``bundler.capture``,
  ``bundler.replay``: a bundler's staging of one step's inputs and its
  eager warm-up, capture or replay of the step;
- ``decoder.fetch``, ``decoder.step``, ``decoder.readback``,
  ``decoder.log``, ``decoder.save``: the AdaIN decoder loop
  (``adain_engine.run_decoder_training``): an iteration's batches and swap
  draw, the staging of its batches and the enqueue of its step, the wait
  for a step's losses, the log line and PNG, the decoder file;
- ``decoder.warm_up``, ``decoder.capture``, ``decoder.replay``, inside
  ``decoder.step``: on the card with no process group, one of the step's
  eager warm-ups, its capture into a CUDA graph, or a replay of the graph
  (``adain_engine.DecoderStepGraph``, which counts them as
  ``eager_steps``, ``captures`` and ``replays``). On the CPU and under a
  process group the step runs eagerly and opens none of them.
"""

from __future__ import annotations

import collections
import time

import torch

LOG = 1 << 15
_log = collections.deque(maxlen=LOG)  # (name, start_ns, end_ns), in order of closing
# whether a torch profiler records, asked without a dispatcher call
_recording = torch._C._autograd._profiler_enabled


class span:
    """``with span(name) as s:`` logs the block under ``name``; ``s.seconds``
    is its host time once it has closed."""

    __slots__ = ("name", "seconds", "_t0", "_fn")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0

    def __enter__(self):
        self._fn = None
        if _recording():
            self._fn = torch.profiler.record_function(self.name)
            self._fn.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._fn is not None:
            self._fn.__exit__(*exc)
        self.seconds = (t1 - self._t0) / 1e9
        _log.append((self.name, self._t0, t1))
        return False


def recent() -> list:
    """The last ``LOG`` spans closed, oldest first: (name, start_ns, end_ns)."""
    return list(_log)


def counters(start_ns: int = None, end_ns: int = None):
    """{span name: (calls, host seconds)} of the logged spans that started
    at or after ``start_ns`` and ended by ``end_ns`` (None: no bound); None
    where the log, full, may have dropped such a span."""
    spans = list(_log)
    if start_ns is not None and len(spans) == LOG and spans[0][2] >= start_ns:
        return None
    out = {}
    for name, t0, t1 in spans:
        if (start_ns is None or t0 >= start_ns) and (end_ns is None or t1 <= end_ns):
            n, ns = out.get(name, (0, 0))
            out[name] = (n + 1, ns + t1 - t0)
    return {name: (n, ns / 1e9) for name, (n, ns) in out.items()}
