"""--steps-per-dispatch in the port: the step bundlers and the bundled epochs.

- ``AdaptStepBundler`` and ``PretrainStepBundler`` on the CPU against n
  single calls of the port's steps, bit for bit (no tolerance: the bundler
  runs the same step on the same values, through its static buffers), over
  every gate case in two bundles, with a generator and with given occlusion
  draws.
- The same bundlers against the JAX package's (``lax.scan``) on the same
  weights, gates and occlusion draws (``_jax_draws`` of each scan key), at
  the tolerances ``tests/test_torch_train_step.py`` states for one step:
  losses and BatchNorm statistics 1e-3 of the largest magnitude, parameter
  and EMA-teacher deltas 5e-2 in norm (SGD; the tiny model's float32
  gradients are only that smooth), over bundles of 2 at a learning rate
  of 1e-3, a tenth of that file's. A step after the first starts from
  parameters that differ by the first step's gradient noise times the lr,
  and the tiny model's gradients are not smooth at that scale: at 1e-2 the
  second step moves the BatchNorm parameters' summed updates by up to 11.7%
  in norm, at 1e-3 by 3.5%, and a third step at 1e-3 by 6.2% (while every
  occlusion decision and mask stays equal). The teacher's parameter deltas
  are (1 - alpha) of the student's, near the float32 resolution of the
  parameters, so each EMA update's rounding (half an ulp, in each package)
  is allowed on top: 5e-2 of the delta's norm plus 2^-23 of the parameter's
  norm per step; its BatchNorm statistics are held at 1e-3.
- The bundled epoch loops against the JAX package's bundled loops, with
  recording stub bundlers: the same per-iteration batches, lr, gates and
  alphas, target advances, next ``np.random`` draw and masked log lines,
  with a trailing partial bundle; and the pretrain loop's target-stream
  contract (``tests/test_engine_loops.py``): bundled and unbundled consume
  the same streams.
- A CLI drive on the CPU with ``--steps-per-dispatch 2`` (both phases, a
  trailing partial bundle, the checkpoints and logs it writes).
- The parts the CPU cannot run: launch counting under capture
  (``ops/launches.py``), the ticket buffer's capture guard, the checkpoint's
  non-capturable layout; and, marked ``gpu``, graph replays against eager
  steps on the card.
- The spans and counters of ``utils/trace.py``: a bundled epoch's
  ``engine.fetch`` once an iteration, its readback and log once a bundle;
  a bundler's ``reset_reasons``: ``buffer`` on the CPU and, on the card,
  ``first``, ``generator`` and ``lr``.

JAX is imported inside the tests that use it, so that the card test runs
where only PyTorch is installed (``-m gpu --noconftest``).
"""

import copy
import functools
import math
import os
import re
import time

import numpy as np
import pytest
import torch

from uda_poseestimation_torch import engine as tengine
from uda_poseestimation_torch import train_human as ttrain
from uda_poseestimation_torch.device import device_scalar, device_vector
from uda_poseestimation_torch.models import Bottleneck, PoseResNet, ResNet, StyleNet
from uda_poseestimation_torch.ops import bn_fuse, launches
from uda_poseestimation_torch.ops.occlusion_warp import occlusion_warp
from uda_poseestimation_torch.parallel import train_step as tts
from uda_poseestimation_torch.utils import CompleteLogger
from uda_poseestimation_torch.utils import checkpoint as tckpt
from uda_poseestimation_torch.utils import trace

B, K = 4, 5  # tests/test_torch_train_step.py's sizes
LR_CHAIN = 1e-3  # the JAX comparisons' learning rate (see above)
CFG = dict(image_size=64, heatmap_size=16, sigma=2.0, k=1, occlude_rate=0.5,
           occlude_thresh=-1.0, occlude_size=6, aux_outputs=True)
# all four (do_s2t, do_t2s) cases over two bundles of 3
ADAPT_GATES = [[(True, 0.7, False, 0.2), (False, 0.1, True, 0.4), (True, 0.2, True, 0.9)],
               [(False, 0.3, False, 0.6), (True, 0.5, True, 0.1), (False, 0.8, True, 0.3)]]
PRETRAIN_GATES = [[(True, 0.6), (False, 0.0), (True, 0.3)],
                  [(False, 0.0), (False, 0.0), (True, 0.9)]]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this file's CPU steps: the Tier-1 run puts
    six test processes on the host's cores, where torch's default of one
    thread per core oversubscribes them (on an 8-core x86 host, a CPU adapt
    step of this file took ~25 s in a six-worker run, 0.4 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _batch(seed, style_image=False):
    from uda_poseestimation_torch.ops import generate_target_batch

    rng = np.random.RandomState(seed)
    kp = rng.uniform(8, 56, size=(B, K, 2)).astype(np.float32)
    target, weight = generate_target_batch(kp, np.ones((B, K), np.float32), (16, 16), 2.0,
                                           (64, 64))

    def aug():
        return np.stack([rng.uniform(-30, 30, B), np.round(rng.uniform(-4, 4, B)),
                         np.round(rng.uniform(-4, 4, B)), rng.uniform(-10, 10, B),
                         rng.uniform(-10, 10, B), rng.uniform(0.8, 1.2, B)],
                        -1).astype(np.float32)

    batch = {"image_s": rng.rand(B, 64, 64, 3).astype(np.float32),
             "target_s": target.numpy(), "weight_s": weight.numpy()}
    if style_image:
        batch["image_t_style"] = rng.rand(B, 64, 64, 3).astype(np.float32)
        return batch
    batch.update(image_t_stu=rng.rand(B, 64, 64, 3).astype(np.float32),
                 images_t_tea=rng.rand(1, B, 64, 64, 3).astype(np.float32),
                 aug_param_stu=aug(), aug_params_tea=aug()[None])
    return batch


def _models(seed=0, fuse_bn=False):
    """A tiny PoseResNet and a StyleNet whose heatmaps and styled images are
    not flat (the scaling of tests/test_torch_train_step.py)."""
    model = PoseResNet(ResNet(Bottleneck, (1, 1, 1, 1), fuse_bn=fuse_bn), K)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    style = StyleNet()
    style.reset_parameters(torch.Generator().manual_seed(seed + 1))
    with torch.no_grad():
        for i in (0, 3, 6):
            model.upsampling[i].weight.mul_(30.0)
        model.head.weight.mul_(100.0)
        style.decoder[28].weight.mul_(1000.0)
    return model, style


def _draws(seed):
    rng = np.random.RandomState(seed)
    return {"u": rng.rand(B).astype(np.float32),
            "gumbel": -np.log(-np.log(rng.rand(B, K))).astype(np.float32),
            "u1": rng.rand(B).astype(np.float32), "u2": rng.rand(B).astype(np.float32)}


def _assert_equal_trees(stacked, singles, where=""):
    """``stacked`` (a tree of (n, ...) tensors) equals the n trees of
    ``singles`` bit for bit."""
    if isinstance(stacked, torch.Tensor):
        for j, single in enumerate(singles):
            assert torch.equal(stacked[j], single), f"{where}[{j}]"
    elif isinstance(stacked, dict):
        assert all(set(s) == set(stacked) for s in singles), where
        for k in stacked:
            _assert_equal_trees(stacked[k], [s[k] for s in singles], f"{where}/{k}")
    else:
        assert all(s is stacked or s == stacked for s in singles), where


def _assert_same_state(a, b, step=True):
    for ma, mb in ((a.student, b.student), (a.teacher, b.teacher)):
        sa, sb = ma.state_dict(), mb.state_dict()
        assert list(sa) == list(sb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    for i, entry in oa["state"].items():
        for k, v in entry.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    assert a.step == b.step or not step


# ---------------------------------------------------------------------------
# (a) the bundlers on the CPU against single steps, bit for bit
# ---------------------------------------------------------------------------

def test_adapt_bundler_equals_single_steps():
    """Two bundles of 3 over the four gate cases: the first with the
    occlusion draws from a generator, the second with given draws."""
    model, style = _models()
    cfg = tts.StepConfig(**CFG)  # Adam
    single, bundled = (tts.create_state(copy.deepcopy(model), cfg, seed=None, device="cpu")
                       for _ in range(2))
    step = tts.make_adapt_step(cfg, style, "cpu")
    bundler = tts.AdaptStepBundler(cfg, style, "cpu")
    gen_single, gen_bundled = (torch.Generator().manual_seed(3) for _ in range(2))
    for b, gates in enumerate(ADAPT_GATES):
        batches = [_batch(10 * b + j) for j in range(3)]
        given = [_draws(10 * b + j) for j in range(3)] if b == 1 else None
        want = []
        for j, (s, a_s, t, a_t) in enumerate(gates):
            _, metrics, y_last = step(single, batches[j], 1e-3, s, a_s, t, a_t,
                                      generator=gen_single,
                                      occlusion_draws=given[j] if given else None)
            want.append(metrics)
        state, got, y = bundler(bundled, batches, 1e-3, *zip(*gates), generator=gen_bundled,
                                occlusion_draws=given)
        assert state is bundled
        _assert_equal_trees(got, want, f"bundle {b}")
        assert torch.equal(y, y_last)
        _assert_same_state(single, bundled)
    assert bundled.step == 6 and bundler.eager_steps == 6
    assert (bundler.captures, bundler.replays) == (0, 0)  # no graphs on the CPU
    occluded = torch.cat([m["aux"]["occlude"] for m in want])
    assert 0 < occluded.sum() < occluded.numel()


def test_pretrain_bundler_equals_single_steps():
    model, style = _models()
    cfg = tts.StepConfig(**CFG)
    single, bundled = (tts.create_state(copy.deepcopy(model), cfg, seed=None, device="cpu")
                       for _ in range(2))
    step = tts.make_pretrain_step(cfg, style, "cpu")
    bundler = tts.PretrainStepBundler(cfg, style, "cpu")
    for b, gates in enumerate(PRETRAIN_GATES):
        batches = [_batch(20 + 10 * b + j, style_image=True) for j in range(3)]
        for batch, (fired, _) in zip(batches, gates):
            if not fired:  # the zeros the loop gives a slot whose gate did not fire
                batch["image_t_style"] = np.zeros_like(batch["image_s"])
        want = [step(single, batch, 1e-3, s, a)[1] for batch, (s, a) in zip(batches, gates)]
        _, got, _ = bundler(bundled, batches, 1e-3, *zip(*gates))
        _assert_equal_trees(got, want, f"bundle {b}")
        _assert_same_state(single, bundled)
    assert bundled.step == 6


def _device_aug(k=1):
    """The port's DeviceAugPipeline at this file's sizes, and a raw batch
    maker (uint8 canvases)."""
    from uda_poseestimation_torch.ops.device_aug import DeviceAugConfig

    cfg = DeviceAugConfig(image_size=64, heatmap_size=16, sigma=2.0)
    pipe = tengine.DeviceAugPipeline(cfg, cfg, cfg, k=k, mean=[0.485, 0.456, 0.406],
                                     std=[0.229, 0.224, 0.225], seed=4, device="cpu")

    def raw(seed):
        rng = np.random.RandomState(seed)
        return {"canvas_s": rng.randint(0, 256, (B, 64, 64, 3)).astype(np.uint8),
                "kp_s": rng.uniform(4, 60, (B, K, 2)).astype(np.float32),
                "vis_s": np.ones((B, K), np.float32),
                "canvas_t": rng.randint(0, 256, (B, 64, 64, 3)).astype(np.uint8),
                "kp_t": rng.uniform(4, 60, (B, K, 2)).astype(np.float32),
                "vis_t": np.ones((B, K), np.float32)}

    return pipe, raw


def test_bundlers_with_view_builders_equal_single_steps():
    """--device-aug: the adapt bundler (views from the occlusion generator)
    and the pretrain bundler (views from the pipeline's generator, the style
    image only in the do_s2t case) against single steps with the same
    generators, bit for bit."""
    model, style = _models()
    cfg = tts.StepConfig(**CFG)
    pipe, raw = _device_aug()
    single, bundled = (tts.create_state(copy.deepcopy(model), cfg, seed=None, device="cpu")
                       for _ in range(2))
    step = tts.make_adapt_step(cfg, style, "cpu", view_builder=pipe.view_builder)
    bundler = tts.AdaptStepBundler(cfg, style, "cpu", view_builder=pipe.view_builder)
    gen_single, gen_bundled = (torch.Generator().manual_seed(3) for _ in range(2))
    gates = ADAPT_GATES[0]
    batches = [raw(j) for j in range(3)]
    want = [step(single, b, 1e-3, *g, generator=gen_single)[1] for b, g in zip(batches, gates)]
    _, got, _ = bundler(bundled, batches, 1e-3, *zip(*gates), generator=gen_bundled)
    _assert_equal_trees(got, want, "adapt")
    _assert_same_state(single, bundled)
    assert torch.equal(gen_single.get_state(), gen_bundled.get_state())

    build = pipe.pretrain_view_builder(True)
    pstep = tts.make_pretrain_step(cfg, style, "cpu", view_builder=build)
    pbundler = tts.PretrainStepBundler(cfg, style, "cpu", view_builder=build)
    gates = PRETRAIN_GATES[0]
    batches = [raw(10 + j) for j in range(3)]
    gen_single, gen_bundled = (torch.Generator().manual_seed(5) for _ in range(2))
    want = [pstep(single, b, 1e-3, *g, generator=gen_single)[1]
            for b, g in zip(batches, gates)]
    _, got, _ = pbundler(bundled, batches, 1e-3, *zip(*gates), generator=gen_bundled)
    _assert_equal_trees(got, want, "pretrain")
    _assert_same_state(single, bundled)
    assert torch.equal(gen_single.get_state(), gen_bundled.get_state())


def test_bundler_restages_a_new_batch_shape():
    """A batch of another shape gets new static buffers (and, on the card,
    new graphs); the step still equals a single call."""
    model, style = _models()
    cfg = tts.StepConfig(**CFG)
    single, bundled = (tts.create_state(copy.deepcopy(model), cfg, seed=None, device="cpu")
                       for _ in range(2))
    bundler = tts.PretrainStepBundler(cfg, style, "cpu")
    step = tts.make_pretrain_step(cfg, style, "cpu")
    for batch in (_batch(1, True), {k: v[:2] for k, v in _batch(2, True).items()}):
        want = step(single, batch, 1e-3, True, 0.5)[1]
        _assert_equal_trees(bundler(bundled, [batch], 1e-3, [True], [0.5])[1], [want])
    assert bundler._static["batch/image_s"].shape[0] == 2


def test_bundler_counts_why_it_dropped_its_graphs():
    """The first call's new buffers drop nothing; a staged buffer of
    another shape records ``buffer``."""
    model, style = _models()
    cfg = tts.StepConfig(**CFG)
    state = tts.create_state(model, cfg, seed=None, device="cpu")
    bundler = tts.PretrainStepBundler(cfg, style, "cpu")
    batch = _batch(1, True)
    bundler(state, [batch], 1e-3, [True], [0.5])
    bundler(state, [batch], 1e-3, [True], [0.5])
    assert bundler.reset_reasons == {}
    bundler(state, [{k: v[:2] for k, v in batch.items()}], 1e-3, [True], [0.5])
    assert bundler.reset_reasons == {"buffer": 1}


def test_bundler_checks_gate_lengths():
    cfg = tts.StepConfig(**CFG)
    bundler = tts.PretrainStepBundler(cfg, None, "cpu")
    state = tts.create_state(_models()[0], cfg, seed=None, device="cpu")
    with pytest.raises(ValueError, match="2 batches but 1 gate"):
        bundler(state, [_batch(0, True)] * 2, 1e-3, [True], [0.5, 0.5])


@pytest.mark.parametrize("cls", ["AdaptStepBundler", "PretrainStepBundler"])
def test_bundlers_default_to_cuda(cls):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(tts, cls)(tts.StepConfig(**CFG))


def test_device_constants_round_as_torch_tensor_does():
    """The steps' constants, now made by fills on the device, equal what
    ``torch.tensor`` made from the same numbers, bit for bit."""
    values = (-2.1179, -2.0357, -1.8044, 2.2489, 2.4285, 2.64, 0.7, 1 / 3)
    for dtype in (torch.float32, torch.bfloat16):
        got, want = device_vector(values, "cpu", dtype), torch.tensor(values, dtype=dtype)
        assert got.dtype == dtype and torch.equal(got, want)
    for v in np.random.RandomState(0).uniform(-10, 10, 1000):
        assert torch.equal(device_scalar(float(v), "cpu"),
                           torch.as_tensor(float(v), dtype=torch.float32))
    t = torch.tensor(0.25, dtype=torch.float64)
    assert device_scalar(t, "cpu").dtype == torch.float32


# ---------------------------------------------------------------------------
# (b) the bundlers against the JAX package's
# ---------------------------------------------------------------------------

def _jax_parity_setup():
    from test_torch_train_step import _models as models_both

    return models_both()


def _jax_weights_delta(weights_mod, variables, jstate, which):
    params, stats = (("student_params", "student_stats") if which == "student"
                     else ("teacher_params", "teacher_stats"))
    return (weights_mod.pose_resnet_state_dict(variables),
            weights_mod.pose_resnet_state_dict({"params": getattr(jstate, params),
                                                "batch_stats": getattr(jstate, stats)}))


def _assert_state_close(state, before, variables, jstate, which, steps):
    from test_torch_train_step import _close, _close_norm, _sd

    from uda_poseestimation_torch import weights

    module = state.student if which == "student" else state.teacher
    after = _sd(module)
    jbefore, jafter = _jax_weights_delta(weights, variables, jstate, which)
    for name in jafter:
        if "running_" in name:
            _close(after[name], jafter[name], 1e-3, f"{which} {name}")
        elif name.endswith("num_batches_tracked"):
            continue
        elif which == "teacher":
            err = np.linalg.norm((after[name] - jafter[name]).astype(np.float64))
            delta = np.linalg.norm((jafter[name] - jbefore[name]).astype(np.float64))
            rounding = steps * 2.0 ** -23 * np.linalg.norm(jafter[name].astype(np.float64))
            assert err <= 5e-2 * delta + rounding, f"teacher {name}: {err} vs {delta}"
        else:
            _close_norm(after[name] - before[name], jafter[name] - jbefore[name], 5e-2,
                        f"{which} {name}")


def test_adapt_bundler_matches_jax():
    import jax
    import jax.numpy as jnp
    from test_torch_train_step import _close, _jax_draws, _jax_state, _sd

    from uda_poseestimation_tpu.parallel import train_step as jts

    jmodel, variables, jstyle, style_params, tmodel, tstyle = _jax_parity_setup()
    cfg = dict(CFG, use_sgd=True)
    gates = ADAPT_GATES[0][:2]
    batches = [_batch(40 + j) for j in range(2)]
    keys = [jax.random.PRNGKey(100 + j) for j in range(2)]
    g = np.asarray(gates, np.float64)
    jcfg = jts.StepConfig(**cfg)
    jstate, jmetrics, _ = jax.device_get(jts.AdaptStepBundler(jmodel, jcfg, style_model=jstyle)(
        _jax_state(variables, jcfg), style_params,
        {k: np.stack([b[k] for b in batches]) for k in batches[0]}, jnp.float32(LR_CHAIN),
        jnp.stack(keys), jnp.asarray(g[:, 0].astype(bool)), jnp.asarray(g[:, 1], jnp.float32),
        jnp.asarray(g[:, 2].astype(bool)), jnp.asarray(g[:, 3], jnp.float32)))

    tcfg = tts.StepConfig(**cfg)
    state = tts.create_state(tmodel, tcfg, seed=None, device="cpu")
    before = _sd(state.student)
    _, metrics, _ = tts.AdaptStepBundler(tcfg, tstyle, "cpu")(
        state, batches, LR_CHAIN, *zip(*gates),
        occlusion_draws=[_jax_draws(key, B, K) for key in keys])
    for name in ("loss_all", "loss_s", "loss_c", "acc_s"):
        for j in range(2):
            _close(metrics[name][j].numpy(), jmetrics[name][j], 1e-3, f"{name}[{j}]")
    np.testing.assert_array_equal(metrics["acc_cnt"].numpy(), np.asarray(jmetrics["acc_cnt"]))
    # every step's mask and occluded view (its pixels copies; at most 0.1%
    # moved by an ulp of the port's own warp coefficients)
    np.testing.assert_array_equal(metrics["aux"]["tea_mask"].numpy(),
                                  np.asarray(jmetrics["aux"]["tea_mask"]))
    for j in range(2):
        got = metrics["aux"]["x_t_stu_final"][j].numpy()
        assert (got != np.asarray(jmetrics["aux"]["x_t_stu_final"][j])).mean() <= 1e-3, j
    assert 0 < metrics["aux"]["occlude"].sum() < 2 * B
    assert state.step == 2
    _assert_state_close(state, before, variables, jstate, "student", 2)
    _assert_state_close(state, before, variables, jstate, "teacher", 2)


def test_pretrain_bundler_matches_jax():
    import jax
    import jax.numpy as jnp
    from test_torch_train_step import _close, _jax_state, _sd

    from uda_poseestimation_tpu.parallel import train_step as jts

    jmodel, variables, jstyle, style_params, tmodel, tstyle = _jax_parity_setup()
    cfg = dict(CFG, use_sgd=True)
    gates = [(True, 0.6), (False, 0.0)]
    batches = [_batch(50 + j, style_image=True) for j in range(2)]
    batches[1]["image_t_style"] = np.zeros_like(batches[1]["image_s"])
    g = np.asarray(gates, np.float64)
    jcfg = jts.StepConfig(**cfg)
    jstate, jmetrics, _ = jax.device_get(
        jts.PretrainStepBundler(jmodel, jcfg, style_model=jstyle)(
            _jax_state(variables, jcfg), style_params,
            {k: np.stack([b[k] for b in batches]) for k in batches[0]},
            jnp.float32(LR_CHAIN), jnp.stack([jax.random.PRNGKey(40 + j) for j in range(2)]),
            jnp.asarray(g[:, 0].astype(bool)), jnp.asarray(g[:, 1], jnp.float32)))

    tcfg = tts.StepConfig(**cfg)
    state = tts.create_state(tmodel, tcfg, seed=None, device="cpu")
    before = _sd(state.student)
    _, metrics, _ = tts.PretrainStepBundler(tcfg, tstyle, "cpu")(state, batches, LR_CHAIN,
                                                                 *zip(*gates))
    for name in ("loss_all", "loss_s", "acc_s"):
        for j in range(2):
            _close(metrics[name][j].numpy(), jmetrics[name][j], 1e-3, f"{name}[{j}]")
    assert state.step == 2
    _assert_state_close(state, before, variables, jstate, "student", 2)


# ---------------------------------------------------------------------------
# (c) the bundled epoch loops against the JAX package's
# ---------------------------------------------------------------------------

class _BundleRecorder:
    """Stub bundlers for both packages: each iteration of a bundle is
    recorded in a common form (as test_torch_engine's ``_Recorder`` records
    a step) and answered with scripted stacked metrics."""

    def __init__(self, torch_form):
        self.torch_form = torch_form
        self.calls, self.bundles, self.seeds = [], [], []

    def _record(self, batches, lr, gates):
        self.bundles.append(len(batches))
        for batch, g in zip(batches, gates):
            self.calls.append(({k: np.asarray(v) for k, v in batch.items()},
                               np.float32(lr), tuple(np.float32(np.asarray(x)) for x in g)))

    def _answer(self, n, extra_loss):
        idx = np.arange(len(self.calls) - n + 1, len(self.calls) + 1, dtype=np.float32)
        metrics = {"loss_all": 0.5 / idx, "loss_s": 0.25 / idx, "acc_s": idx / 10.0,
                   "acc_cnt": idx.astype(np.int32) % K}
        if extra_loss:
            metrics["loss_c"] = 0.125 * idx
        metrics = {k: np.asarray(v, v.dtype) for k, v in metrics.items()}
        if self.torch_form:
            return {k: torch.from_numpy(v) for k, v in metrics.items()}, torch.zeros(B, K, 4, 4)
        return metrics, np.zeros((B, K, 4, 4), np.float32)

    @staticmethod
    def _unstack(batch, n):
        return [{k: np.asarray(v)[j] for k, v in batch.items()} for j in range(n)]

    def jax_pretrain(self, state, style_params, batch, lr, rngs, do_s2t, alphas):
        n = len(do_s2t)
        self._record(self._unstack(batch, n), lr, zip(np.asarray(do_s2t), np.asarray(alphas)))
        return (state, *self._answer(n, False))

    def torch_pretrain(self, state, batches, lr, do_s2t, alphas):
        self._record(batches, lr, zip(do_s2t, alphas))
        return (state, *self._answer(len(batches), False))

    def jax_adapt(self, state, style_params, batch, lr, rngs, do_s2t, a_s2t, do_t2s, a_t2s):
        n = len(do_s2t)
        self._record(self._unstack(batch, n), lr,
                     zip(*(np.asarray(x) for x in (do_s2t, a_s2t, do_t2s, a_t2s))))
        return (state, *self._answer(n, True))

    def torch_adapt(self, state, batches, lr, do_s2t, a_s2t, do_t2s, a_t2s, generator=None):
        self._record(batches, lr, zip(do_s2t, a_s2t, do_t2s, a_t2s))
        self.seeds.append(generator.initial_seed())
        return (state, *self._answer(len(batches), True))


def _run_bundled(loop, style_enabled, capsys, n, iters, packages=("jax", "torch")):
    """``loop`` ('pretrain' or 'adapt') of each package in ``packages``,
    with ``--steps-per-dispatch n`` ("torch-unbundled": the port's loop
    with its unbundled step, recorded the same way) on the same streams;
    returns per package (calls, target advances, next np.random draw, masked
    lines, recorder)."""
    from test_torch_engine import _args, _Iter, _masked, _Recorder, _source, _target

    from uda_poseestimation_tpu import engine as jengine
    from uda_poseestimation_tpu.parallel import make_mesh

    state = type("State", (), {"student": torch.nn.Linear(1, 1)})()
    out = []
    for pkg in packages:
        tf = pkg != "jax"
        rec = _BundleRecorder(tf) if pkg != "torch-unbundled" else _Recorder(True)
        src, tgt = _Iter(_source, 1, tf), _Iter(_target, 2, tf)
        np.random.seed(42)
        args = _args(iters_per_epoch=iters, steps_per_dispatch=n)
        if pkg == "torch-unbundled":
            args.steps_per_dispatch = 1
            run = (tengine.run_pretrain_epoch if loop == "pretrain" else tengine.run_adapt_epoch)
            step = rec.torch_pretrain if loop == "pretrain" else rec.torch_adapt
            run(state, step, src, tgt, 3, 1e-4, args, None, style_enabled)
        elif loop == "pretrain":
            if tf:
                tengine.run_pretrain_epoch(state, None, src, tgt, 3, 1e-4, args, None,
                                           style_enabled, bundler=rec.torch_pretrain)
            else:
                jengine.run_pretrain_epoch(None, None, None, make_mesh(1), src, tgt, 3, 1e-4,
                                           args, None, style_enabled,
                                           bundler=rec.jax_pretrain)
        elif tf:
            tengine.run_adapt_epoch(state, None, src, tgt, 3, 1e-4, args, None, style_enabled,
                                    bundler=rec.torch_adapt)
        else:
            jengine.run_adapt_epoch(None, None, None, make_mesh(1), src, tgt, 3, 1e-4, args,
                                    None, style_enabled, bundler=rec.jax_adapt)
        out.append((rec.calls, tgt.n, np.random.rand(), _masked(capsys.readouterr().out), rec))
    return out


def _assert_same_calls(a, b):
    assert len(a) == len(b)
    for (ab, alr, ag), (bb, blr, bg) in zip(a, b):
        assert sorted(ab) == sorted(bb)
        for k in ab:
            assert ab[k].dtype == bb[k].dtype == np.float32 and ab[k].shape == bb[k].shape, k
            assert np.array_equal(ab[k], bb[k]), k
        assert (alr, ag) == (blr, bg)


@pytest.mark.parametrize("loop", ["pretrain", "adapt"])
@pytest.mark.parametrize("style_enabled", [True, False])
def test_bundled_epoch_matches_jax(loop, style_enabled, capsys):
    """Seven iterations in bundles of 3, 3 and 1 (the trailing partial
    bundle), every second one printed: iterations 0, 2, 4 and 6, at each
    position of a bundle."""
    (jcalls, jn, jnext, jlines, jrec), (tcalls, tn, tnext, tlines, trec) = _run_bundled(
        loop, style_enabled, capsys, n=3, iters=7)
    _assert_same_calls(jcalls, tcalls)
    assert jrec.bundles == trec.bundles == [3, 3, 1]
    assert (jn, jnext) == (tn, tnext)
    assert jlines == tlines
    assert [ln.split("\t")[0] for ln in tlines if ln.startswith("Epoch: [3]")] == \
        [f"Epoch: [3][{i}/7]" for i in (0, 2, 4, 6)]
    if loop == "adapt":
        assert tn == 7
        np.random.seed(42)  # one generator seed per epoch, drawn first
        assert trec.seeds == [np.random.randint(0, 2 ** 31 - 1)] * 3
    if style_enabled:
        assert {g[0] for _, _, g in tcalls} == {True, False}


@pytest.mark.parametrize("loop", ["pretrain", "adapt"])
def test_bundled_epoch_spans_count_its_iterations(loop, capsys, monkeypatch):
    """Seven iterations in bundles of 3, 3 and 1: a fetch span an
    iteration, a readback and a log span a bundle, the Data meter the
    bundles' fetch time."""
    progress = []

    class KeptProgress(tengine.ProgressMeter):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            progress.append(self)

    monkeypatch.setattr(tengine, "ProgressMeter", KeptProgress)
    t0 = time.perf_counter_ns()
    (_, _, _, _, rec), = _run_bundled(loop, True, capsys, n=3, iters=7, packages=("torch",))
    spans = {n: c for n, c in trace.counters(t0).items() if n.startswith("engine.")}
    assert rec.bundles == [3, 3, 1]
    assert {n: c for n, (c, _) in spans.items()} == \
        {"engine.fetch": 7, "engine.readback": 3, "engine.log": 3}
    data = progress[0].meters[1]
    assert data.name == "Data" and data.count == 3
    assert data.sum == pytest.approx(spans["engine.fetch"][1], rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("loop", ["pretrain", "adapt"])
def test_bundled_and_unbundled_epochs_consume_the_same_streams(loop, capsys):
    """The port's bundled loop (bundles of 3 over 7 iterations) and its
    unbundled loop make the same step calls from the same source, target and
    gate streams: in pretraining the target advances only on fired s2t
    draws, in both modes."""
    (bcalls, bn, bnext, _, _), (ucalls, un, unext, _, _) = _run_bundled(
        loop, True, capsys, n=3, iters=7, packages=("torch", "torch-unbundled"))
    _assert_same_calls(bcalls, ucalls)
    assert (bn, bnext) == (un, unext)
    fired = sum(bool(g[0]) for _, _, g in bcalls)
    assert bn == (fired if loop == "pretrain" else 7)
    assert 0 < fired < 7


@pytest.mark.parametrize("loop", ["pretrain", "adapt"])
def test_bundled_device_aug_epoch_matches_jax(loop, capsys):
    """The bundled loops with --device-aug against the JAX package's, seven
    iterations in bundles of 3, 3 and 1: the same fetches and pipeline
    calls, the same raw batches per iteration and, in pretraining, zero
    style canvases where the s2t gate did not fire (the target is fetched
    only where it fired); a bundle's leaves keep one dtype."""
    from test_torch_engine import assert_same_device_aug_runs, device_aug_run

    jax_run, torch_run = device_aug_run(loop, True, capsys)
    assert_same_device_aug_runs(jax_run, torch_run)
    log = torch_run[0]
    steps = [e for e in log if isinstance(e, tuple)]
    assert len(steps) == 7
    if loop == "pretrain":
        fired = [bool(g[0]) for _, _, _, g in steps]
        assert 0 < sum(fired) < 7 and log.count("target") == sum(fired)
        for (_, leaves, raw, _), f in zip(steps, fired):
            zero = dict((k, z) for k, _, _, z in leaves)
            assert zero["canvas_t"] == zero["kp_t"] == zero["vis_t"] == (not f)
            assert raw["canvas_t"].shape == raw["canvas_s"].shape
    else:
        assert log.count("raw_adapt_batch") == 7 and log.count("target") == 7


# ---------------------------------------------------------------------------
# (d) the CLI with --steps-per-dispatch 2 on the CPU
# ---------------------------------------------------------------------------

def test_cli_bundled_drive_on_cpu(tmp_path, monkeypatch, capsys):
    """A pretrain epoch then an adapt epoch (the ``best_pt`` reload between
    them), 3 iterations each in bundles of 2 and 1. The validation's result
    is raised a little more at each call, so that every epoch writes its
    checkpoint; the checkpoints load, with the optimizer's state in the
    non-capturable layout."""
    from tools.make_fixtures import make_rhd

    make_rhd(str(tmp_path / "rhd"), n_train=8, n_eval=4)
    style = StyleNet()
    style.reset_parameters(torch.Generator().manual_seed(0))
    os.makedirs(tmp_path / "saved_models")
    torch.save(style.encoder.state_dict(), tmp_path / "saved_models" / "vgg_normalised.pth")
    torch.save(style.decoder.state_dict(), tmp_path / "saved_models" / "decoder_rand.pth")
    monkeypatch.chdir(tmp_path)
    real_validate, calls = ttrain.run_validate, []

    def validate(*args, **kwargs):
        calls.append(1)
        return {k: v + len(calls) for k, v in real_validate(*args, **kwargs).items()}

    monkeypatch.setattr(ttrain, "run_validate", validate)
    monkeypatch.setattr(ttrain, "CompleteLogger", functools.partial(CompleteLogger, now="fixed"))
    torch.manual_seed(0)
    ttrain.main(ttrain.build_parser().parse_args(
        ["rhd", "rhd", "-s", "RenderedHandPose", "-t", "RenderedHandPose", "--target-train",
         "RenderedHandPose_mt", "-a", "pose_resnet50", "--image-size", "64",
         "--heatmap-size", "16", "-b", "4", "--test-batch", "4", "--seed", "12", "-p", "1",
         "-j", "0", "--decoder-name", "saved_models/decoder_rand.pth", "--device", "cpu",
         "--epochs", "2", "--pretrain-epoch", "1", "-i", "3", "--steps-per-dispatch", "2",
         "--log", "logs/spd"]))
    out = capsys.readouterr().out.splitlines()
    for epoch, loss_c in ((0, False), (1, True)):
        lines = [ln for ln in out if ln.startswith(f"Epoch: [{epoch}][")]
        assert [re.match(r"Epoch: \[\d\]\[(\d)/3\]", ln).group(1) for ln in lines] == \
            ["0", "1", "2"]
        assert all(("Loss (c)" in ln) == loss_c for ln in lines)
        for ln in lines:
            assert all(math.isfinite(float(v)) for v in re.findall(r"\d+\.\d+e[-+]\d+", ln))
    log = (tmp_path / "logs" / "spd_pose_resnet50" / "train-fixed.txt").read_text()
    assert [ln.split()[1] for ln in log.splitlines()
            if ln.startswith("Epoch: ") and "Target(best)" in ln] == ["0", "1"]
    ckpt_dir = tmp_path / "checkpoints" / "spd_pose_resnet50" / "checkpoints_fixed"
    for name, epoch in (("best_pt", 0), ("best", 1)):
        ckpt = tckpt.load_checkpoint(str(ckpt_dir / f"{name}.pth"))
        assert ckpt["epoch"] == epoch and ckpt["args"]["steps_per_dispatch"] == 2
        groups = ckpt["stu_optimizer"]["param_groups"]
        assert [g["capturable"] for g in groups] == [False] * len(groups)
        assert all(math.isfinite(float(v.float().abs().max()))
                   for v in ckpt["student"].values())
        os.remove(ckpt_dir / f"{name}.pth")  # ~0.5 GB each


# ---------------------------------------------------------------------------
# What the CPU cannot run: capture bookkeeping and the checkpoint layout
# ---------------------------------------------------------------------------

def test_launches_under_capture_count_once_per_replay(monkeypatch):
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    monkeypatch.setattr(bn_fuse.matmul_stats, "launches_by_variant",
                        dict.fromkeys(bn_fuse.VARIANTS, 0))
    ow0, mm0 = occlusion_warp.launches, bn_fuse.matmul_stats.launches
    launches.count(occlusion_warp)
    assert occlusion_warp.launches == ow0 + 1
    capturing[0] = True
    with pytest.raises(RuntimeError, match="outside launches.recording"):
        launches.count(occlusion_warp)
    with launches.recording() as tally:
        launches.count(occlusion_warp)
        for _ in range(3):
            launches.count(bn_fuse.matmul_stats, "tma")
    capturing[0] = False
    assert (occlusion_warp.launches, bn_fuse.matmul_stats.launches) == (ow0 + 1, mm0)
    assert launches.per_wrapper(tally) == {"occlusion_warp": 1, "matmul_stats": 3}
    launches.replayed(tally, times=2)
    assert (occlusion_warp.launches, bn_fuse.matmul_stats.launches) == (ow0 + 3, mm0 + 6)
    assert bn_fuse.matmul_stats.launches_by_variant["tma"] == 6


def test_ticket_buffer_is_never_made_inside_a_capture(monkeypatch):
    """The tma variant's tickets come from the buffer of the capturing
    stream, made by an eager call before the capture; a capture finds none
    and raises rather than allocate from the graph's pool."""
    monkeypatch.setattr(bn_fuse, "_tickets", {})
    dev = torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="no ticket buffer"):
        bn_fuse._ticket_buffer(dev, 7, 16)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    buf = bn_fuse._ticket_buffer(dev, 7, 16)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert bn_fuse._ticket_buffer(dev, 7, 16) is buf and not buf.any()


def test_capturable_checkpoint_resumes_in_the_reference_layout(tmp_path):
    """An Adam made capturable (as the bundled card path makes it) is saved
    with ``capturable`` False and its step counts on the CPU: the file loads
    into a fresh, non-capturable optimizer, whose next step equals a
    non-capturable twin's."""
    model, _ = _models()
    cfg = tts.StepConfig(**CFG)
    state = tts.create_state(copy.deepcopy(model), cfg, seed=None, device="cpu")
    twin = tts.create_state(copy.deepcopy(model), cfg, seed=None, device="cpu")
    batch = _batch(3, style_image=True)
    step = tts.make_pretrain_step(cfg, device="cpu")
    for st in (state, twin):
        step(st, batch, 1e-3)
    tts.make_capturable(state.optimizer)
    assert all(g["capturable"] for g in state.optimizer.param_groups)
    path = str(tmp_path / "best.pth")
    tckpt.save_checkpoint(path, {"student": state.student, "teacher": state.teacher,
                                 "stu_optimizer": state.optimizer, "epoch": 0})
    saved = tckpt.load_checkpoint(path)["stu_optimizer"]
    assert [g["capturable"] for g in saved["param_groups"]] == [False]
    assert {v["step"].device.type for v in saved["state"].values()} == {"cpu"}
    assert all(g["capturable"] for g in state.optimizer.param_groups)  # the live one keeps it
    fresh = tts.create_state(_models(9)[0], cfg, seed=None, device="cpu")
    tckpt.restore_train_state(fresh, tckpt.load_checkpoint(path), load_optimizer=True,
                              log=pytest.fail)
    for st in (fresh, twin):
        step(st, batch, 1e-3)
    _assert_same_state(fresh, twin, step=False)  # the file holds no step count


# ---------------------------------------------------------------------------
# On the card: graph replays against eager steps
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("fuse_bn", [False, True])
def test_graph_replays_match_eager_steps_on_card(cuda, fuse_bn):
    """Each gate case's first bundled step runs eagerly, its next is a graph
    replay; the replay equals the unbundled step from a copy of the state
    under deterministic cuDNN (occlusion and teacher reconstruction bit for
    bit, losses within 1e-6 relative), and counts one occlusion_warp launch
    (and the fused GEMM's) per replay."""
    from uda_poseestimation_torch.models.resnet import fused_gemm_shapes

    model, style = _models(fuse_bn=fuse_bn)
    style = style.to(cuda)
    cfg = tts.StepConfig(**CFG)
    state = tts.create_state(model, cfg, seed=None, device=cuda)
    bundler = tts.AdaptStepBundler(cfg, style, cuda)
    step = tts.make_adapt_step(cfg, style, cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    batch = {k: torch.from_numpy(v).pin_memory() for k, v in _batch(0).items()}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for s, t in ((True, True), (True, False), (False, True), (False, False)):
            bundler(state, [batch], 1e-3, [s], [0.6], [t], [0.3], generator=gen)
            twin = copy.deepcopy(state)
            twin_gen = torch.Generator(device=cuda)
            twin_gen.set_state(gen.get_state())
            ow0 = occlusion_warp.launches
            _, got, _ = bundler(state, [batch], 1e-3, [s], [0.6], [t], [0.3], generator=gen)
            assert occlusion_warp.launches == ow0 + 1
            _, want, _ = step(twin, batch, 1e-3, s, 0.6, t, 0.3, generator=twin_gen)
            for k in ("occlude", "occlusion_rect", "x_t_stu_final", "y_t_tea_recon"):
                assert torch.equal(got["aux"][k][0], want["aux"][k]), (s, t, k)
            for k in ("loss_all", "loss_s", "loss_c"):
                assert float(got[k][0]) == pytest.approx(float(want[k]), rel=1e-6), (s, t, k)
    assert (bundler.eager_steps, bundler.captures, bundler.replays) == (4, 4, 4)
    per_replay = {"occlusion_warp": 1}
    if fuse_bn:
        # the fused 1x1 convs of a forward, in 3 forwards (teacher, 2 student)
        per_replay["matmul_stats"] = 3 * sum(fused_gemm_shapes(model.backbone, B, 64).values())
    assert all(t == per_replay for t in bundler.tallies.values())


def test_fingerprint_sees_what_a_graph_holds():
    """A bundler drops its graphs when the fingerprint of the state changes:
    a checkpoint restore (which replaces the optimizer's state tensors) or a
    changed hyper-parameter changes it; the in-place updates of a step and a
    restore's copy into the modules do not."""
    model, _ = _models()
    cfg = tts.StepConfig(**CFG)
    state = tts.create_state(model, cfg, seed=None, device="cpu")
    step = tts.make_pretrain_step(cfg, device="cpu")
    step(state, _batch(0, True), 1e-3)
    first = tts._fingerprint(state)
    step(state, _batch(1, True), 1e-3)
    assert tts._fingerprint(state) == first
    state.student.load_state_dict(copy.deepcopy(state.student.state_dict()))
    assert tts._fingerprint(state) == first
    state.optimizer.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
    restored = tts._fingerprint(state)
    assert restored != first
    state.optimizer.param_groups[0]["betas"] = (0.8, 0.999)
    assert tts._fingerprint(state) != restored


@pytest.mark.gpu
def test_bundler_counts_a_new_generator_on_card(cuda):
    """The first call on the card records ``first``; a new epoch's
    generator drops the graphs as ``generator``, another lr as ``lr``."""
    model, style = _models()
    cfg = tts.StepConfig(**CFG)
    state = tts.create_state(model, cfg, seed=None, device=cuda)
    bundler = tts.AdaptStepBundler(cfg, style.to(cuda), cuda)
    batch = {k: torch.from_numpy(v).pin_memory() for k, v in _batch(0).items()}

    def bundle(gen, lr=1e-3):
        bundler(state, [batch] * 2, lr, [True] * 2, [0.5] * 2, [False] * 2, [0.0] * 2,
                generator=gen)

    first = torch.Generator(device=cuda).manual_seed(0)
    bundle(first)
    bundle(first)
    assert bundler.reset_reasons == {"first": 1} and bundler.captures == 1
    second = torch.Generator(device=cuda).manual_seed(1)
    bundle(second)
    assert bundler.reset_reasons == {"first": 1, "generator": 1} and bundler.captures == 2
    bundle(second, lr=2e-3)
    assert bundler.reset_reasons == {"first": 1, "generator": 1, "lr": 1}


@pytest.mark.gpu
def test_device_aug_replays_match_eager_steps_on_card(cuda):
    """--device-aug on the card: the views built inside each gate case's
    graph replay equal the eager step's (the occluded student view, the
    teacher's reconstruction, the occlusion, bit for bit, under
    deterministic cuDNN), one occlusion_warp launch per replay; and the
    view builder on the card against the CPU from the same draws: the
    target weights equal, the views within 1e-4 (normalized) at all but
    0.1% of their values."""
    model, style = _models()
    style = style.to(cuda)
    cfg = tts.StepConfig(**CFG)
    pipe, raw = _device_aug()
    pipe_gpu = tengine.DeviceAugPipeline(pipe.cfg_src, pipe.cfg_stu, pipe.cfg_tea, k=1,
                                         mean=pipe.mean, std=pipe.std, device=cuda)
    state = tts.create_state(model, cfg, seed=None, device=cuda)
    bundler = tts.AdaptStepBundler(cfg, style, cuda, view_builder=pipe_gpu.view_builder)
    step = tts.make_adapt_step(cfg, style, cuda, view_builder=pipe_gpu.view_builder)
    gen = torch.Generator(device=cuda).manual_seed(0)
    batch = {k: torch.from_numpy(v).pin_memory() for k, v in raw(0).items()}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for s, t in ((True, True), (False, False)):
            bundler(state, [batch], 1e-3, [s], [0.6], [t], [0.3], generator=gen)
            twin = copy.deepcopy(state)
            twin_gen = torch.Generator(device=cuda)
            twin_gen.set_state(gen.get_state())
            ow0 = occlusion_warp.launches
            _, got, _ = bundler(state, [batch], 1e-3, [s], [0.6], [t], [0.3], generator=gen)
            assert occlusion_warp.launches == ow0 + 1
            _, want, _ = step(twin, batch, 1e-3, s, 0.6, t, 0.3, generator=twin_gen)
            for k in ("occlude", "occlusion_rect", "x_t_stu_final", "y_t_tea_recon"):
                assert torch.equal(got["aux"][k][0], want["aux"][k]), (s, t, k)
    assert bundler.replays == 2

    draws = pipe.draw_source(B, 64, torch.Generator().manual_seed(1))
    draws = {"source": draws, "target": pipe.draw_target(B, 64, torch.Generator().manual_seed(2))}
    to_card = functools.partial(tts._tree_map, lambda v: v.to(cuda))
    want = pipe.view_builder({k: torch.from_numpy(v) for k, v in raw(1).items()}, draws=draws)
    got = pipe_gpu.view_builder({k: torch.from_numpy(v).to(cuda) for k, v in raw(1).items()},
                                draws=to_card(draws))
    assert torch.equal(got["weight_s"].cpu(), want["weight_s"])
    for k in ("image_s", "image_t_stu", "images_t_tea"):
        off = ((got[k].cpu() - want[k]).abs() > 1e-4).double().mean()
        assert off <= 1e-3, k
