"""The program's own spans (``uda_poseestimation_torch/utils/trace.py``) as
the benchmark reads them.

- ``window_spans(run, cell)``: {span: (count, host seconds)} of the spans
  that lie in the run's window and, in a traced run, ended before its
  profiled sub-window could begin (``trace_after_s`` into the window), on
  the window's clock (``time.perf_counter``). The profiled stretch and all
  after it are left out: the profiler's cost on each CUDA launch lasts
  while ``SubWindow`` holds the profiler, past its stop (PERF.md §6), so
  these host times carry none of it. None where the program keeps no
  spans (a checkout without them) or its log no longer reaches back to
  the window's start.
- ``idle_split(events)``: from a profile's raw events, the sub-window's
  idle time split, instant by instant, by the innermost span open on the
  thread that opened ``bench.window`` (the benchmark's ``bench.*`` spans
  and the program's; elsewhere ``engine_loop``), and the longest idle gaps
  named by the innermost span open where each begins. ``breakdown.py``
  prints it for a traced run.
"""

from __future__ import annotations

import collections

import torch

from benchmark.trace import WINDOW, _annotation

OUTSIDE = "engine_loop"
PROGRAM = ("engine.", "adapt.", "pretrain.", "bundler.", "decoder.")


def _program_trace():
    try:
        from uda_poseestimation_torch.utils import trace
    except ImportError:
        return None
    return trace


def window_spans(run, cell):
    trace = _program_trace()
    t0, length = run.get("window_t0"), run.get("window_s")
    if trace is None or t0 is None or not length:
        return None
    if run.get("trace"):  # the sub-window began: read up to its earliest start
        length = min(length, cell.traffic["trace_after_s"])
    return trace.counters(round(t0 * 1e9), round((t0 + length) * 1e9)) or None


def per_step_ms(run, cell, step, names):
    """Host milliseconds a step of ``names`` (summed), over the count of the
    span ``step`` in the window; None without such steps."""
    spans = window_spans(run, cell)
    if not spans or step not in spans:
        return None
    return 1e3 * sum(spans.get(n, (0, 0.0))[1] for n in names) / spans[step][0]


def _tracked(name: str) -> bool:
    return name != WINDOW and (name.startswith("bench.") or name.startswith(PROGRAM))


def idle_split(events, gaps: int = 10) -> dict:
    """``idle_by_span`` {span: idle seconds}, summing to the sub-window's
    idle time, and ``idle_gaps`` [[span, seconds]], the ``gaps`` longest."""
    cpu = [e for e in events if e.device_type() == torch.autograd.DeviceType.CPU]
    windows = [e for e in cpu if e.name() == WINDOW]
    if not windows:
        return {}
    w = windows[0]
    w0, w1, thread = w.start_ns(), w.end_ns(), w.start_thread_id()
    busy = sorted((max(e.start_ns(), w0), min(e.end_ns(), w1)) for e in events
                  if e.device_type() == torch.autograd.DeviceType.CUDA
                  and not _annotation(e) and min(e.end_ns(), w1) > max(e.start_ns(), w0))
    idle, at = [], w0
    for s, t in busy:
        if s > at:
            idle.append((at, s))
        at = max(at, t)
    if at < w1:
        idle.append((at, w1))
    # the spans' edges in time order (at one instant ends first, the inner
    # span's first, then starts, the outer span's first): between two edges
    # the innermost open span is the top of the stack
    edges = sorted(edge for i, e in enumerate(cpu)
                   if _tracked(e.name()) and e.start_thread_id() == thread
                   for edge in ((e.start_ns(), 1, -e.end_ns(), i),
                                (e.end_ns(), 0, -e.start_ns(), i)))
    names = [e.name() for e in cpu]
    by_span = collections.defaultdict(float)
    named = []
    stack, k = [], 0
    for a, b in idle:
        while k < len(edges) and edges[k][0] <= a:
            _step(stack, edges[k])
            k += 1
        named.append((names[stack[-1]] if stack else OUTSIDE, (b - a) / 1e9))
        at = a
        while k < len(edges) and edges[k][0] < b:
            by_span[names[stack[-1]] if stack else OUTSIDE] += (edges[k][0] - at) / 1e9
            at = edges[k][0]
            _step(stack, edges[k])
            k += 1
        by_span[names[stack[-1]] if stack else OUTSIDE] += (b - at) / 1e9
    named.sort(key=lambda g: -g[1])
    return {"idle_by_span": dict(by_span), "idle_gaps": [list(g) for g in named[:gaps]]}


def _step(stack, edge):
    _, kind, _, i = edge
    if kind:
        stack.append(i)
    elif i in stack:
        stack.remove(i)

