"""The port's spans and counters (``uda_poseestimation_torch/utils/trace.py``).

- With no profiler recording, a span enters no ``record_function`` and
  still logs its call and host time; under ``torch.profiler`` it is a
  kineto event of its name, nested as the code nests.
- ``recent()`` keeps the last ``LOG`` spans closed; ``counters`` sums
  those of a stretch of time, and declines a stretch the log has dropped.
- Under the profiler on the CPU, the spans of an adaptation epoch through
  the bundler lie where the module says: ``engine.fetch``,
  ``engine.readback`` and ``engine.log`` beside the bundler's call, which
  holds ``bundler.stage`` and the step's ``adapt.step``. (The decoder
  loop's are in ``test_torch_adain_engine.py``, the loops' counts in
  ``test_torch_engine.py`` and ``test_torch_bundle.py``.)
- Marked ``gpu``: on the card, a bundler's warm-up and capture hold the
  step's span, a replay holds none, and traced captures run.

No JAX here, so that the card's run needs only PyTorch (``-m gpu
--noconftest``).
"""

import collections
import time
import types

import numpy as np
import pytest
import torch

from uda_poseestimation_torch import engine
from uda_poseestimation_torch.models import Bottleneck, PoseResNet, ResNet, StyleNet
from uda_poseestimation_torch.parallel import train_step as tts
from uda_poseestimation_torch.utils import trace

B, K, SIZE, HM = 2, 3, 32, 8
CFG = dict(image_size=SIZE, heatmap_size=HM, sigma=1.0, k=1, occlude_size=2)


def _profiled_spans(prof, prefixes):
    """(name, start_ns, end_ns) of the profile's host events named by a span
    of ``prefixes``, in order of start (on the card each span is also
    projected onto the device's timeline: those are left out)."""
    events = prof.profiler.kineto_results.events()
    return sorted(((e.name(), e.start_ns(), e.end_ns()) for e in events
                   if e.device_type() == torch.autograd.DeviceType.CPU
                   and e.name().split(".")[0] in prefixes), key=lambda e: e[1])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_without_profiler_enters_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    start = time.perf_counter_ns()
    for _ in range(3):
        with trace.span("test.off") as s:
            sum(range(1000))
    n, seconds = trace.counters(start)["test.off"]
    assert n == 3 and seconds > 0 and s.seconds > 0
    name, t0, t1 = trace.recent()[-1]
    assert name == "test.off" and abs(t1 - t0 - s.seconds * 1e9) < 1


def test_span_is_a_nested_record_function_under_the_profiler():
    start = time.perf_counter_ns()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("test.outer"):
            with trace.span("test.inner"):
                sum(range(1000))
    outer, inner = _profiled_spans(prof, ("test",))
    assert (outer[0], inner[0]) == ("test.outer", "test.inner") and _inside(inner, outer)
    counts = trace.counters(start)
    assert counts["test.outer"][0] == counts["test.inner"][0] == 1
    assert [r[0] for r in trace.recent()[-2:]] == ["test.inner", "test.outer"]


def test_recent_keeps_the_last_spans(monkeypatch):
    monkeypatch.setattr(trace, "LOG", 2)
    monkeypatch.setattr(trace, "_log", collections.deque(maxlen=2))
    start = time.perf_counter_ns()
    for name in ("test.a", "test.b", "test.c"):
        with trace.span(name):
            pass
    assert [r[0] for r in trace.recent()] == ["test.b", "test.c"]
    # test.a was dropped: the stretch from start can no longer be summed
    assert trace.counters(start) is None
    assert set(trace.counters(trace.recent()[0][2] + 1)) <= {"test.c"}
    assert set(trace.counters()) == {"test.b", "test.c"}


def _models():
    model = PoseResNet(ResNet(Bottleneck, (1, 1, 1, 1)), K)
    model.reset_parameters(torch.Generator().manual_seed(0))
    style = StyleNet()
    style.reset_parameters(torch.Generator().manual_seed(1))
    return model, style


class _Feed:
    """The loaders' source 4-tuples and target 8-tuples, seeded."""

    def __init__(self, seed, target):
        self.rng, self.target = np.random.RandomState(seed), target

    def __next__(self):
        r = self.rng
        img = torch.from_numpy(r.rand(B, SIZE, SIZE, 3).astype(np.float32))
        if not self.target:
            return (img, torch.from_numpy(r.rand(B, K, HM, HM).astype(np.float32)),
                    torch.ones(B, K, 1), {})
        aug = torch.zeros(B, 6)
        aug[:, 5] = 1.0
        return (img, None, None, {"aug_param_stu": aug}, [img.clone()], None, None,
                [{"aug_param_tea": aug}])


def test_adapt_epoch_spans_nest_under_the_profiler(capsys):
    """A bundled epoch of 3 iterations (a bundle of 2, then 1) on the CPU,
    where the bundler runs each step eagerly."""
    model, style = _models()
    cfg = tts.StepConfig(**CFG)
    state = tts.create_state(model, cfg, seed=None, device="cpu")
    bundler = tts.AdaptStepBundler(cfg, style, "cpu")

    def call(*a, **k):
        with torch.profiler.record_function("test.bundle"):
            return bundler(*a, **k)

    args = types.SimpleNamespace(iters_per_epoch=3, print_freq=1, steps_per_dispatch=2,
                                 s2t_freq=0.5, s2t_alpha=(0.0, 1.0), t2s_freq=0.5,
                                 t2s_alpha=(0.0, 1.0))
    np.random.seed(0)
    start = time.perf_counter_ns()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        engine.run_adapt_epoch(state, None, _Feed(1, False), _Feed(2, True), 0, 1e-4, args,
                               style_enabled=True, bundler=call)
    spans = _profiled_spans(prof, ("engine", "bundler", "adapt", "test"))
    bundles = [s for s in spans if s[0] == "test.bundle"]
    loop = [s for s in spans if s[0].startswith("engine.")]
    assert [s[0] for s in loop] == ["engine.fetch"] * 3 + ["engine.readback", "engine.log"] * 2
    assert len(bundles) == 2 and not any(_inside(b, s) or _inside(s, b)
                                         for b in bundles for s in loop)
    for name in ("bundler.stage", "adapt.step"):
        inner = [s for s in spans if s[0] == name]
        assert len(inner) == 3 and all(any(_inside(s, b) for b in bundles) for s in inner)
    stages = [s for s in spans if s[0] == "bundler.stage"]
    assert not any(_inside(s, st) for s in spans if s[0] == "adapt.step" for st in stages)
    counts = trace.counters(start)
    assert {n: counts[n][0] for n in ("engine.fetch", "adapt.step")} == \
        {"engine.fetch": 3, "adapt.step": 3}
    assert "Epoch: [0][2/3]" in capsys.readouterr().out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_bundler_spans_on_card_under_the_profiler(cuda):
    """A gate case's first call warms up, its second captures and replays,
    its third replays: the step's span lies in the warm-up and the capture
    (whose record_function runs inside the capture), and none in a replay;
    the profiler's run of it replays as the unprofiled one does."""
    model, style = _models()
    cfg = tts.StepConfig(**CFG)
    state = tts.create_state(model, cfg, seed=None, device=cuda)
    bundler = tts.AdaptStepBundler(cfg, style.to(cuda), cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    src, tgt = next(_Feed(1, False)), next(_Feed(2, True))
    batch = {k: v.pin_memory() for k, v in engine.make_adapt_batch(src, tgt).items()}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            _, metrics, _ = bundler(state, [batch], 1e-4, [True], [0.5], [False], [0.0],
                                    generator=gen)
        torch.cuda.synchronize()
    assert torch.isfinite(metrics["loss_all"]).all()
    spans = _profiled_spans(prof, ("bundler", "adapt"))
    outer = [s for s in spans if s[0] != "adapt.step" and s[0] != "bundler.stage"]
    assert [s[0] for s in outer] == ["bundler.warm_up", "bundler.capture", "bundler.replay",
                                     "bundler.replay"]
    steps = [s for s in spans if s[0] == "adapt.step"]
    assert len(steps) == 2 and _inside(steps[0], outer[0]) and _inside(steps[1], outer[1])
    assert (bundler.eager_steps, bundler.captures, bundler.replays) == (1, 1, 2)
