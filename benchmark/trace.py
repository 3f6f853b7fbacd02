"""The traced sub-window: a ``torch.profiler`` trace of a few steady seconds,
kept in memory and reduced to what the per-layer readers and the
``breakdown`` need.

The benchmark's own calls into the program run inside ``record_function``
spans named ``bench.*``; the sub-window itself is the span
``bench.window``, opened after a device synchronize and closed after one,
so every operation of its steps lies inside it. From the profiler's raw
events:

- ``window_s``: the span's length; ``busy_s``: the union of the device's
  operations (kernels, copies, fills) inside it;
- ``kernels``: name -> [launches, device seconds];
- ``device_ops``: the ten operations that took most device time;
- ``idle_gaps``: the ten longest stretches with nothing on the device,
  each named by the innermost ``bench.*`` span the host was in when it
  began.
"""

from __future__ import annotations

import bisect
import collections
import time

import torch

WINDOW = "bench.window"


class SubWindow:
    """Profiles one stretch of a run: ``begin()`` and ``end()`` at step
    boundaries the driver chooses (``due``), each after a synchronize."""

    def __init__(self, device: torch.device, start_after_s: float, length_s: float):
        self.device = device
        self.start_after_s = start_after_s
        self.length_s = length_s
        self.prof = None
        self.steps = 0
        self.done = False
        self._span = None
        self._t0 = None
        self.extra = collections.Counter()  # what the driver adds up inside, e.g. flops

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.done

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def due(self, window_elapsed_s: float):
        """Called between steps: opens the sub-window once
        ``start_after_s`` of the run's window have passed and closes it
        ``length_s`` later."""
        if self.done:
            return
        if self.prof is None and window_elapsed_s >= self.start_after_s:
            self.begin()
        elif self.prof is not None and time.perf_counter() - self._t0 >= self.length_s:
            self.end()

    def begin(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._sync()
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self._span = torch.profiler.record_function(WINDOW)
        self._span.__enter__()
        self._t0 = time.perf_counter()

    def end(self):
        if self.prof is None or self.done:
            return
        self._sync()
        self._span.__exit__(None, None, None)
        self.prof.stop()
        self.done = True

    def count_step(self, n: int = 1, **extra):
        if self.active:
            self.steps += n
            self.extra.update(extra)

    def summary(self) -> dict:
        if self.prof is None:
            return {}
        return dict(summarize(self.prof.profiler.kineto_results.events()),
                    steps=self.steps, **self.extra)


def _annotation(e) -> bool:
    """A span projected onto the device's timeline (``record_function``),
    not an operation the device ran."""
    if e.is_user_annotation():
        return True
    kind = getattr(e, "activity_type", None)
    return kind is not None and "annotation" in str(kind()).lower()


def summarize(events) -> dict:
    cpu = [e for e in events if e.device_type() == torch.autograd.DeviceType.CPU]
    windows = [e for e in cpu if e.name() == WINDOW]
    if not windows:
        return {}
    w0, w1 = windows[0].start_ns(), windows[0].end_ns()
    spans = sorted(((e.start_ns(), e.end_ns(), e.name()) for e in cpu
                    if e.name().startswith("bench.") and e.name() != WINDOW),
                   key=lambda s: s[0])
    dev = []
    kernels = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CUDA or _annotation(e):
            continue
        s, t = max(e.start_ns(), w0), min(e.end_ns(), w1)
        if t <= s:
            continue
        dev.append((s, t))
        k = kernels[e.name()]
        k[0] += 1
        k[1] += (t - s) / 1e9
    dev.sort()
    busy, gaps, at = 0, [], w0
    for s, t in dev:
        if s > at:
            gaps.append((at, s))
        if t > at:
            busy += t - max(s, at)
            at = t
    if at < w1:
        gaps.append((at, w1))
    starts = [s[0] for s in spans]

    def host_doing(t):
        # the innermost span open at t: the latest-starting one that covers it
        i = bisect.bisect_right(starts, t)
        for s, e, name in reversed(spans[:i]):
            if e >= t:
                return name
        return "engine_loop"

    gaps.sort(key=lambda g: g[0] - g[1])
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy / 1e9,
        "kernels": {k: list(v) for k, v in kernels.items()},
        "n_kernels": sum(v[0] for v in kernels.values()),
        "device_ops": [[name, v[1]] for name, v in ops[:10]],
        "idle_gaps": [[host_doing(a), (b - a) / 1e9] for a, b in gaps[:10]],
    }
