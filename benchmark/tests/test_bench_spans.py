"""The program's spans as the benchmark reads them (``benchmark/spans.py``)
and the per-layer readers built on them: on synthetic events and runs, and
in a driver's tiny run on the CPU."""

import collections
import json
import types

import pytest
import torch

from benchmark import harness, spans
from benchmark.trace import summarize

from .conftest import tiny_cell

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
HOST = {"step_host_ms.eager": "hand_r101.adapt_spd1", "loop_host_ms.eager": "hand_r101.adapt_spd1",
        "step_host_ms.decoder": "adain_vgg19.decoder_b4",
        "loop_host_ms.decoder": "adain_vgg19.decoder_b4",
        "graph_build_s.train": "hand_r101.adapt_spd4"}


class Event:
    """The parts of a kineto event that the benchmark reads."""

    def __init__(self, name, start, end, device=CPU, thread=1):
        self._name, self._start, self._end = name, start, end
        self._device, self._thread = device, thread

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def device_type(self):
        return self._device

    def start_thread_id(self):
        return self._thread

    def is_user_annotation(self):
        return False


# a window of 1000 ns: three kernels; a bundle holding a capture holding a
# step; a fetch; a span of another thread, which names nothing
EVENTS = [
    Event("bench.window", 0, 1000),
    Event("bench.bundle", 50, 600), Event("bundler.capture", 150, 500),
    Event("adapt.step", 160, 300), Event("engine.fetch", 620, 800),
    Event("engine.log", 0, 1000, thread=2), Event("aten::add", 160, 170),
    Event("k1", 100, 200, CUDA), Event("k2", 400, 450, CUDA), Event("k1", 900, 1000, CUDA),
]


def test_idle_split_names_each_idle_instant_by_the_innermost_span():
    out = spans.idle_split(EVENTS)
    want = {"engine_loop": 170, "bench.bundle": 150, "adapt.step": 100,
            "bundler.capture": 150, "engine.fetch": 180}
    assert out["idle_by_span"] == pytest.approx({k: v / 1e9 for k, v in want.items()})
    assert out["idle_gaps"] == [["bundler.capture", pytest.approx(450e-9)],
                                ["adapt.step", pytest.approx(200e-9)],
                                ["engine_loop", pytest.approx(100e-9)]]


def test_idle_split_sums_to_the_windows_idle_time():
    summary = summarize(EVENTS)
    assert (summary["window_s"], summary["busy_s"], summary["n_kernels"]) == \
        (pytest.approx(1000e-9), pytest.approx(250e-9), 3)
    assert summary["kernels"] == {"k1": [2, pytest.approx(200e-9)], "k2": [1, pytest.approx(50e-9)]}
    assert [op[0] for op in summary["device_ops"]] == ["k1", "k2"]
    idle = sum(spans.idle_split(EVENTS)["idle_by_span"].values())
    assert idle == pytest.approx(summary["window_s"] - summary["busy_s"], rel=1e-12)


def test_idle_split_of_spans_that_start_together():
    events = [Event("bench.window", 0, 100), Event("engine.readback", 0, 100),
              Event("bench.step", 0, 50), Event("k", 60, 70, CUDA)]
    out = spans.idle_split(events)
    assert out["idle_by_span"] == pytest.approx({"bench.step": 50e-9,
                                                 "engine.readback": 40e-9})
    assert spans.idle_split(events[1:]) == {}


@pytest.fixture
def recent(monkeypatch):
    """The program's log of spans, replaced by the test's."""
    from uda_poseestimation_torch.utils import trace

    log = collections.deque(maxlen=trace.LOG)
    monkeypatch.setattr(trace, "_log", log)
    return log


def _run(traced=False):
    # a window from 10 s to 12 s on the host clock; traced, with a sub-window
    return {"window_t0": 10.0, "window_s": 2.0, **({"trace": {"window_s": 0.5}} if traced else {})}


CELL = types.SimpleNamespace(traffic={"trace_after_s": 0.5, "iters_per_epoch": 500})


def _span(name, start_s, ms):
    return (name, round(start_s * 1e9), round((start_s + ms / 1e3) * 1e9))


def test_window_spans_leave_out_set_up_and_all_from_the_profile_on(recent):
    recent.extend([_span("adapt.step", 9.5, 100),             # set-up
                   _span("adapt.step", 10.1, 20), _span("engine.fetch", 10.2, 2),
                   _span("engine.fetch", 10.45, 100),         # ends after the profile's start
                   _span("adapt.step", 10.5, 30),             # in the profile
                   _span("adapt.step", 11.0, 30),             # after the profile
                   _span("adapt.step", 11.99, 20)])           # past the window's end
    assert spans.window_spans(_run(traced=True), CELL) == {
        "adapt.step": (1, pytest.approx(0.02)), "engine.fetch": (1, pytest.approx(0.002))}
    # untraced, the whole window
    assert spans.window_spans(_run(), CELL) == {
        "adapt.step": (3, pytest.approx(0.08)), "engine.fetch": (2, pytest.approx(0.102))}


def test_host_readers_read_per_step(recent):
    cell = harness.load_cell("hand_r101.adapt_spd1")
    for t in (10.1, 10.3):
        recent.extend([_span("engine.fetch", t, 1), _span("adapt.step", t + 0.01, 8),
                       _span("engine.readback", t + 0.02, 3), _span("engine.log", t + 0.03, 0.5)])
    read = {m: harness.load_module("metrics", m).read(_run(), cell) for m in HOST}
    assert read == {"step_host_ms.eager": pytest.approx(8.0), "loop_host_ms.eager":
                    pytest.approx(4.5), "step_host_ms.decoder": None,
                    "loop_host_ms.decoder": None, "graph_build_s.train": None}
    recent.extend([_span("bundler.stage", 10.5, 1), _span("bundler.warm_up", 10.6, 300),
                   _span("bundler.capture", 11.0, 500)])
    build = harness.load_module("metrics", "graph_build_s.train")
    assert build.read(_run(), cell) == pytest.approx(0.8)


def test_graph_build_is_per_epoch_begun(recent):
    """Two epochs of 2 iterations begun in the window, and 3 fetches: the
    builds' 0.6 s over 2."""
    build = harness.load_module("metrics", "graph_build_s.train")
    cell = types.SimpleNamespace(traffic={"trace_after_s": 4.0, "iters_per_epoch": 2})
    recent.extend([_span("engine.fetch", 10.0 + 0.1 * i, 1) for i in range(3)])
    recent.extend([_span("bundler.stage", 10.5, 1), _span("bundler.warm_up", 10.6, 200),
                   _span("bundler.capture", 11.0, 400)])
    assert build.read(_run(), cell) == pytest.approx(0.3)


def test_host_readers_read_nothing_without_the_programs_spans(recent, monkeypatch):
    cell = harness.load_cell("hand_r101.adapt_spd1")
    recent.append(_span("adapt.step", 10.1, 20))
    readers = [harness.load_module("metrics", m) for m in HOST]
    assert all(r.read({}, cell) is None for r in readers)  # no window
    monkeypatch.setattr(spans, "_program_trace", lambda: None)  # a checkout without spans
    assert all(r.read(_run(), cell) is None for r in readers)


def test_host_readers_read_nothing_where_the_log_starts_late(recent, monkeypatch):
    from uda_poseestimation_torch.utils import trace

    recent.extend([_span("engine.fetch", 10.5, 1), _span("adapt.step", 10.6, 8)])
    monkeypatch.setattr(trace, "LOG", 2)  # full, and it begins after the window's start
    assert spans.window_spans(_run(), CELL) is None


@pytest.mark.parametrize("name", ["hand_r101.adapt_spd1", "adain_vgg19.decoder_b4"])
def test_host_readers_in_a_tiny_run(name, cpu, in_tmp):
    """A driver's traced run on the CPU: each host reader of the cell reads,
    and the spans hold most of the host's time before the profile began."""
    cell = tiny_cell(name, seconds=3.0, trace=True)
    cell.traffic["trace_after_s"] = 1.5
    run = harness.load_module("drivers", cell.traffic["driver"]).run(cell, cpu)
    metrics = harness.per_layer(cell, run)
    mine = [m for m, c in HOST.items() if c == name]
    assert all(metrics[m]["value"] > 0 for m in mine), metrics
    step = "adapt.step" if name.endswith("spd1") else "decoder.step"
    steps = spans.window_spans(run, cell)[step][0]
    covered = sum(metrics[m]["value"] for m in mine) * steps / 1e3
    assert 0.5 * 1.5 < covered <= 1.5


def test_breakdown_of_a_tiny_run(cpu, in_tmp):
    """``breakdown.py`` on a bundled cell's traced run on the CPU (where the
    bundler runs eagerly): the idle split sums to the sub-window's idle
    time, and the spans outside it lie in the window."""
    from benchmark import breakdown, trace

    cell = tiny_cell("hand_r101.adapt_spd4", seconds=2.0, trace=True)
    out = breakdown.breakdown(cell, cpu)
    assert out["correct"] and trace.SubWindow.__name__ == "SubWindow"
    assert sum(out["idle_by_span"].values()) == pytest.approx(out["idle_s"], rel=1e-9)
    assert 0 < out["sub_window"][0] < out["sub_window"][1]
    assert out["outside"]["engine.fetch"][0] > 0 and out["builds"] == []
    assert json.loads(json.dumps(out)) == out
