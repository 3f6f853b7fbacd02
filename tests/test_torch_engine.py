"""The port's epoch loops against the JAX package's.

``run_pretrain_epoch`` and ``run_adapt_epoch`` of both packages are driven
by the same seeded iterators and by stub steps that record their calls and
return the same scripted metrics. Both must record the same sequence of
(batch keys and values, lr, gates, alphas), advance the target iterator the
same number of times, leave ``np.random`` in the same state, make the same
debug-image calls and print the same ``ProgressMeter`` lines once the Time
and Data fields are masked. Tolerance: none; the values are copies.

``run_validate`` runs both packages' eval steps on the same tiny PoseResNet
weights (carried over by ``weights.py``) over 6 samples in batches of 4,
so the last batch is partial: the JAX loop pads it and rescales the loss,
the port runs it as it is. The group PCK must be equal, and each batch's
logged loss equal within 1e-5 relative (float32 sums over different
shapes: the padded mean times 4/2 against the plain mean of 2 rows).

The port's unbundled loops record one ``engine.fetch``, ``engine.readback``
and ``engine.log`` span an iteration (``utils/trace.py``), and the Data
meter holds the fetch spans' time.
"""

import re
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uda_poseestimation_tpu import engine as jengine
from uda_poseestimation_tpu.data import DataLoader as JDataLoader
from uda_poseestimation_tpu.data import KeypointDataset as JKeypointDataset
from uda_poseestimation_tpu.data.util import generate_target
from uda_poseestimation_tpu.models.pose_resnet import PoseResNet as JPoseResNet
from uda_poseestimation_tpu.models.resnet import Bottleneck as JBottleneck
from uda_poseestimation_tpu.models.resnet import ResNet as JResNet
from uda_poseestimation_tpu.parallel import make_mesh
from uda_poseestimation_tpu.parallel import train_step as jts
from uda_poseestimation_torch import engine as tengine
from uda_poseestimation_torch import weights
from uda_poseestimation_torch.data import KeypointDataset as TKeypointDataset
from uda_poseestimation_torch.data import make_loader
from uda_poseestimation_torch.models import Bottleneck, PoseResNet, ResNet
from uda_poseestimation_torch.ops.pck import get_max_preds_np
from uda_poseestimation_torch.parallel import train_step as tts
from uda_poseestimation_torch.utils import trace

B, K, SIZE, HM = 4, 5, 32, 8


def _source(rng):
    kp = rng.uniform(2, SIZE - 2, (B, K, 2))
    return (rng.rand(B, SIZE, SIZE, 3).astype(np.float32),
            rng.rand(B, K, HM, HM).astype(np.float32),
            np.ones((B, K, 1), np.float32), {"keypoint2d": kp})


def _target(rng, kv=2):
    def aug():
        return rng.uniform(-1, 1, (B, 6)).astype(np.float32)

    return (rng.rand(B, SIZE, SIZE, 3).astype(np.float32), None, None,
            {"aug_param_stu": aug(), "keypoint2d_ori": rng.rand(B, K, 2)},
            [rng.rand(B, SIZE, SIZE, 3).astype(np.float32) for _ in range(kv)], None, None,
            [{"aug_param_tea": aug()} for _ in range(kv)])


def _tensors(obj):
    """The loader's form of a collated batch: numpy arrays as tensors."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj)
    if isinstance(obj, dict):
        return {k: _tensors(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tensors(v) for v in obj)
    return obj


class _Iter:
    """A seeded infinite iterator that counts its advances."""

    def __init__(self, make, seed, torch_form):
        self.make, self.rng, self.torch_form, self.n = make, np.random.RandomState(seed), \
            torch_form, 0

    def __next__(self):
        self.n += 1
        item = self.make(self.rng)
        return _tensors(item) if self.torch_form else item


class _Recorder:
    """Stub steps for both packages: each call is recorded in a common form
    and answered with the same scripted metrics and heatmaps."""

    def __init__(self, torch_form):
        self.torch_form = torch_form
        self.calls = []
        self.rng = np.random.RandomState(123)

    def _answer(self, extra_loss):
        n = len(self.calls)
        metrics = {"loss_all": np.float32(0.5 / n), "loss_s": np.float32(0.25 / n),
                   "acc_s": np.float32(n / 10.0), "acc_cnt": np.int32(n % K)}
        if extra_loss:
            metrics["loss_c"] = np.float32(0.125 * n)
        y = self.rng.rand(B, K, HM, HM).astype(np.float32)
        if self.torch_form:
            return {k: torch.tensor(v) for k, v in metrics.items()}, torch.from_numpy(y)
        return metrics, y

    def _record(self, batch, lr, *gates):
        # as float32: the JAX loop hands its step float32 scalars, the port's
        # loop Python floats
        self.calls.append(({k: np.asarray(v) for k, v in batch.items()}, np.float32(lr),
                           tuple(np.float32(np.asarray(g)) for g in gates)))

    def jax_pretrain(self, state, style_params, batch, lr, do_s2t, alpha):
        self._record(batch, lr, bool(do_s2t), alpha)
        return (state, *self._answer(False))

    def torch_pretrain(self, state, batch, lr, do_s2t, alpha):
        self._record(batch, lr, bool(do_s2t), alpha)
        return (state, *self._answer(False))

    def jax_adapt(self, state, style_params, batch, lr, rng, do_s2t, a_s2t, do_t2s, a_t2s):
        self._record(batch, lr, bool(do_s2t), a_s2t, bool(do_t2s), a_t2s)
        return (state, *self._answer(True))

    def torch_adapt(self, state, batch, lr, do_s2t, a_s2t, do_t2s, a_t2s, generator=None):
        self._record(batch, lr, bool(do_s2t), a_s2t, bool(do_t2s), a_t2s)
        self.seeds = getattr(self, "seeds", []) + [generator.initial_seed()]
        return (state, *self._answer(True))


_TIME = re.compile(r"(Time|Data) +[-0-9.e+]+ \( *[-0-9.e+]+\)")


def _masked(text):
    return [_TIME.sub(r"\1 <t>", line) for line in text.splitlines()]


def _args(**kw):
    base = dict(iters_per_epoch=5, print_freq=2, image_size=SIZE, heatmap_size=HM,
                s2t_freq=0.5, s2t_alpha=(0.0, 1.0), t2s_freq=0.5, t2s_alpha=(0.2, 0.6),
                seed=0)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _run(loop, style_enabled, capsys, iters=5):
    """Both packages' ``loop`` ('pretrain' or 'adapt') on the same streams;
    returns per package (calls, target advances, next np.random draw,
    masked lines, debug-image calls, recorder)."""
    state = types.SimpleNamespace(student=torch.nn.Linear(1, 1))
    out = []
    for pkg in ("jax", "torch"):
        tf = pkg == "torch"
        rec = _Recorder(tf)
        src, tgt = _Iter(_source, 1, tf), _Iter(_target, 2, tf)
        shown = []

        def visualize(image, kps, name):
            shown.append((name, np.asarray(image), np.asarray(kps, np.float64)))

        np.random.seed(42)
        args = _args(iters_per_epoch=iters)
        if loop == "pretrain":
            if tf:
                tengine.run_pretrain_epoch(state, rec.torch_pretrain, src, tgt, 3, 1e-4,
                                           args, visualize, style_enabled)
            else:
                jengine.run_pretrain_epoch(None, None, rec.jax_pretrain, make_mesh(1), src,
                                           tgt, 3, 1e-4, args, visualize, style_enabled)
        elif tf:
            tengine.run_adapt_epoch(state, rec.torch_adapt, src, tgt, 3, 1e-4, args,
                                    visualize, style_enabled)
        else:
            jengine.run_adapt_epoch(None, None, rec.jax_adapt, make_mesh(1), src, tgt, 3,
                                    1e-4, args, visualize, style_enabled)
        out.append((rec.calls, tgt.n, np.random.rand(), _masked(capsys.readouterr().out),
                    shown, rec))
    return out


def _assert_same_runs(jax_run, torch_run):
    (jcalls, jn, jnext, jlines, jshown, _), (tcalls, tn, tnext, tlines, tshown, _) = \
        jax_run, torch_run
    assert len(jcalls) == len(tcalls)
    for (jb, jlr, jg), (tb, tlr, tg) in zip(jcalls, tcalls):
        assert sorted(jb) == sorted(tb)  # the JAX batch passes a pytree map: sorted
        for k in jb:
            assert tb[k].dtype == np.float32 and jb[k].shape == tb[k].shape, k
            assert np.array_equal(jb[k], tb[k]), k
        assert (jlr, jg) == (tlr, tg)
    assert (jn, jnext) == (tn, tnext)
    assert jlines == tlines and any(line.startswith("Epoch: [3]") for line in tlines)
    assert [n for n, _, _ in jshown] == [n for n, _, _ in tshown]
    for (_, ji, jk), (_, ti, tk) in zip(jshown, tshown):
        assert np.array_equal(ji, ti) and np.array_equal(jk, tk)


@pytest.mark.parametrize("style_enabled", [True, False])
def test_pretrain_epoch_matches_jax(style_enabled, capsys):
    jax_run, torch_run = _run("pretrain", style_enabled, capsys, iters=7)
    _assert_same_runs(jax_run, torch_run)
    gates = [g[0] for _, _, g in torch_run[0]]
    if style_enabled:  # the target stream advances exactly on fired s2t draws
        assert 0 < sum(gates) < len(gates) and torch_run[1] == sum(gates)
    else:
        assert not any(gates) and torch_run[1] == 0


@pytest.mark.parametrize("style_enabled", [True, False])
def test_adapt_epoch_matches_jax(style_enabled, capsys):
    jax_run, torch_run = _run("adapt", style_enabled, capsys)
    _assert_same_runs(jax_run, torch_run)
    assert torch_run[1] == 5
    # one occlusion generator per epoch, seeded by the epoch's one randint
    np.random.seed(42)
    want = np.random.randint(0, 2 ** 31 - 1)
    assert torch_run[5].seeds == [want] * 5
    if style_enabled:
        assert {g[0] for _, _, g in torch_run[0]} == {True, False}


@pytest.mark.parametrize("loop", ["pretrain", "adapt"])
def test_unbundled_epoch_spans_count_its_iterations(loop, capsys, monkeypatch):
    progress = []

    class KeptProgress(tengine.ProgressMeter):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            progress.append(self)

    monkeypatch.setattr(tengine, "ProgressMeter", KeptProgress)
    state = types.SimpleNamespace(student=torch.nn.Linear(1, 1))
    rec = _Recorder(True)
    run = tengine.run_pretrain_epoch if loop == "pretrain" else tengine.run_adapt_epoch
    step = rec.torch_pretrain if loop == "pretrain" else rec.torch_adapt
    t0 = time.perf_counter_ns()
    run(state, step, _Iter(_source, 1, True), _Iter(_target, 2, True), 3, 1e-4,
        _args(iters_per_epoch=5), None, True)
    spans = {n: c for n, c in trace.counters(t0).items() if n.startswith("engine.")}
    assert {n: c for n, (c, _) in spans.items()} == dict.fromkeys(spans, 5)
    data = progress[0].meters[1]
    assert data.name == "Data" and data.count == 5
    assert data.sum == pytest.approx(spans["engine.fetch"][1], rel=1e-9, abs=1e-12)
    assert "Epoch: [3][4/5]" in capsys.readouterr().out


class _JVal(JKeypointDataset):
    def __init__(self, items):
        super().__init__("root", K, items, keypoints_group={
            "head": (0, 1), "tail": (2, 3, 4), "all": tuple(range(K))})

    def __getitem__(self, i):
        return self.samples[i]


class _TVal(TKeypointDataset):
    def __init__(self, items):
        super().__init__("root", K, items, keypoints_group={
            "head": (0, 1), "tail": (2, 3, 4), "all": tuple(range(K))})

    def __getitem__(self, i):
        return self.samples[i]


def _val_items(model, n=6, size=64, hm=16):
    """Samples whose even rows put their keypoints where ``model`` finds
    them, so that PCK is neither 0 nor 1."""
    rng = np.random.RandomState(7)
    images = rng.rand(n, size, size, 3).astype(np.float32)
    with torch.no_grad():
        found = get_max_preds_np(model.eval()(torch.from_numpy(images).permute(0, 3, 1, 2))
                                 .numpy())[0] * (size / hm)
    items = []
    for i in range(n):
        kp = rng.uniform(4, size - 4, (K, 2))
        if i % 2 == 0:
            kp = np.clip(found[i] + 0.5, 0, size - 1)
        vis = np.ones((K, 1), np.float32)
        if i == 1:
            vis[3] = 0.0  # one invisible keypoint: zero target, excluded from PCK
        target, weight = generate_target(kp, vis, (hm, hm), 2, (size, size))
        items.append((images[i], target, weight, {"keypoint2d": kp}))
    return items


def test_validate_matches_jax(capsys):
    jmodel = JPoseResNet(backbone=JResNet(block=JBottleneck, stage_sizes=(1, 1, 1, 1)),
                         num_keypoints=K)
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                           train=False))
    params = jax.tree_util.tree_map(np.array, variables["params"])
    for i in range(3):
        params["upsampling"][f"deconv{i}"]["kernel"] *= 30.0
    params["head"]["kernel"] *= 100.0
    stats = variables["batch_stats"]
    tmodel = weights.load_pose_resnet(PoseResNet(ResNet(Bottleneck, (1, 1, 1, 1)), K),
                                      {"params": params, "batch_stats": stats})
    args = _args(val_print_freq=1, image_size=64, heatmap_size=16)
    items = _val_items(tmodel)

    jeval, teval = jts.make_eval_step(jmodel), tts.make_eval_step(device="cpu")
    jlosses, tlosses = [], []

    def jstep(p, s, x, label, weight):
        y, loss, acc = jeval(p, s, x, label, weight)
        jlosses.append(float(loss) * len(x) / int(np.asarray(weight).any(-1).any(-1).sum()))
        return y, loss, acc

    def tstep(model, x, label, weight):
        y, loss, acc = teval(model, x, label, weight)
        tlosses.append(float(loss))
        return y, loss, acc

    want = jengine.run_validate(jstep, params, stats, JDataLoader(_JVal(items), 4), args)
    jlines = _masked(capsys.readouterr().out)
    got = tengine.run_validate(tstep, tmodel, make_loader(_TVal(items), 4), args)
    tlines = _masked(capsys.readouterr().out)
    assert list(want) == list(got) == ["head", "tail", "all"]
    assert {k: float(v) for k, v in want.items()} == {k: float(v) for k, v in got.items()}
    assert 0.0 < float(got["all"]) < 1.0
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert jlines == tlines and len(tlines) == 2


# ---------------------------------------------------------------------------
# --device-aug: both packages' loops with their DeviceAugPipeline, recorded
# ---------------------------------------------------------------------------

def _canvas_source(rng):
    """A raw source batch: canvases on the uint8 grid as float32 (they pack
    to uint8), some keypoints invisible."""
    return (rng.randint(0, 256, (B, SIZE, SIZE, 3)).astype(np.float32) / 255.0,
            rng.rand(B, K, HM, HM).astype(np.float32),
            (rng.rand(B, K, 1) > 0.2).astype(np.float32),
            {"keypoint2d": rng.uniform(2, SIZE - 2, (B, K, 2))})


def _canvas_target(rng):
    """A raw mean-teacher batch: uint8 canvases (ToUint8Canvas) and identity
    aug_params (IdentityAffine)."""
    canvas = rng.randint(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8)
    ident = np.tile(np.array([0, 0, 0, 0, 0, 1], np.float32), (B, 1))
    meta = {"aug_param_stu": ident, "keypoint2d_ori": rng.uniform(2, SIZE - 2, (B, K, 2)),
            "target_weight_ori": (rng.rand(B, K, 1) > 0.1).astype(np.float32)}
    return (canvas, None, None, meta, [canvas], None, None, [{"aug_param_tea": ident}])


class _LoggedIter(_Iter):
    def __init__(self, make, seed, torch_form, log, name):
        super().__init__(make, seed, torch_form)
        self.log, self.name = log, name

    def __next__(self):
        self.log.append(self.name)
        return super().__next__()


class _LoggedPipeline:
    """A package's DeviceAugPipeline whose methods, called by a loop, are
    logged by name (key streams and the port's cached zeros are each
    package's own business and not logged)."""

    def __init__(self, pipe, log):
        self._pipe, self._log = pipe, log

    def __getattr__(self, name):
        attr = getattr(self._pipe, name)
        if not callable(attr) or name in ("next_rng", "style_zeros"):
            return attr

        def call(*a, **kw):
            self._log.append(name)
            return attr(*a, **kw)

        return call


RAW_KEYS = ("canvas_s", "kp_s", "vis_s", "canvas_t", "kp_t", "vis_t")


def _record_batch(log, batch, gates):
    """A step's (or a bundle iteration's) batch in a common form: every
    leaf's shape and dtype and whether it is all zeros; a raw leaf's values
    (both packages copy the same host data), and the gates."""
    leaves = {k: np.asarray(v) for k, v in batch.items()}
    log.append(("step", sorted((k, v.shape, v.dtype.str, not v.any()) for k, v in
                               leaves.items()),
                {k: v for k, v in leaves.items() if k in RAW_KEYS},
                tuple(np.float32(np.asarray(g)) for g in gates)))


def device_aug_run(loop, bundled, capsys, iters=7):
    """Both packages' ``loop`` ('pretrain' or 'adapt') with a
    DeviceAugPipeline and style on, unbundled or in bundles of 3, on the
    same streams; returns per package (the log of fetches, pipeline calls
    and step batches, the next np.random draw, the masked lines)."""
    from uda_poseestimation_tpu.ops.device_aug import DeviceAugConfig as JCfg
    from uda_poseestimation_torch.ops.device_aug import DeviceAugConfig as TCfg

    state = types.SimpleNamespace(student=torch.nn.Linear(1, 1))
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    out = []
    for pkg in ("jax", "torch"):
        tf = pkg == "torch"
        log = []
        cfg = (TCfg if tf else JCfg)(image_size=SIZE, heatmap_size=HM, sigma=1.0)
        pipe = (tengine.DeviceAugPipeline(cfg, cfg, cfg, k=1, mean=mean, std=std,
                                          device="cpu") if tf else
                jengine.DeviceAugPipeline(cfg, cfg, cfg, k=1, mean=mean, std=std))
        pipe = _LoggedPipeline(pipe, log)
        src = _LoggedIter(_canvas_source, 1, tf, log, "source")
        tgt = _LoggedIter(_canvas_target, 2, tf, log, "target")
        metrics = {"loss_all": 0.5, "loss_s": 0.25, "loss_c": 0.125, "acc_s": 0.1,
                   "acc_cnt": 1}

        def answer(n):
            if n is None:
                m = {k: np.float32(v) for k, v in metrics.items()}
                m["acc_cnt"] = np.int32(1)
                return (state, {k: torch.tensor(v) for k, v in m.items()} if tf else m,
                        torch.zeros(B, K, HM, HM) if tf else np.zeros((B, K, HM, HM)))
            m = {k: np.full(n, v, np.int32 if k == "acc_cnt" else np.float32)
                 for k, v in metrics.items()}
            return (state, {k: torch.from_numpy(v) for k, v in m.items()} if tf else m,
                    None)

        def step(*a, **kw):
            # the batch and the gates follow the state (and, in JAX, the
            # style params) and the lr (and, in JAX adapt, the rng)
            batch = a[1] if tf else a[2]
            gates = a[3:] if tf else (a[4:] if loop == "pretrain" else a[5:])
            _record_batch(log, batch, gates)
            return answer(None)

        def bundle(*a, **kw):
            if tf:
                batches, gates = a[1], list(zip(*a[3:]))
                assert loop == "adapt" or kw["generator"] is pipe.generator
            else:
                n = len(a[5])
                batches = [{k: np.asarray(v)[j] for k, v in a[2].items()} for j in range(n)]
                gates = list(zip(*(np.asarray(g) for g in a[5:])))
            for b, g in zip(batches, gates):
                _record_batch(log, b, g)
            return answer(len(batches))

        np.random.seed(42)
        args = _args(iters_per_epoch=iters, steps_per_dispatch=3 if bundled else 1,
                     s2t_freq=0.5)
        kw = dict(style_enabled=True, device_aug=pipe,
                  bundler=bundle if bundled else None)
        if loop == "pretrain":
            if tf:
                tengine.run_pretrain_epoch(state, step, src, tgt, 3, 1e-4, args, **kw)
            else:
                jengine.run_pretrain_epoch(None, None, step, make_mesh(1), src, tgt, 3, 1e-4,
                                           args, **kw)
        elif tf:
            tengine.run_adapt_epoch(state, step, src, tgt, 3, 1e-4, args, **kw)
        else:
            jengine.run_adapt_epoch(None, None, step, make_mesh(1), src, tgt, 3, 1e-4, args,
                                    **kw)
        out.append((log, np.random.rand(), _masked(capsys.readouterr().out)))
    return out


def assert_same_device_aug_runs(jax_run, torch_run):
    (jlog, jnext, jlines), (tlog, tnext, tlines) = jax_run, torch_run
    assert [e if isinstance(e, str) else e[0] for e in jlog] == \
        [e if isinstance(e, str) else e[0] for e in tlog]
    for je, te in zip(jlog, tlog):
        if isinstance(je, tuple):
            assert je[1] == te[1] and je[3] == te[3]
            assert sorted(je[2]) == sorted(te[2])
            for k in je[2]:
                np.testing.assert_array_equal(te[2][k], je[2][k], err_msg=k)
    assert jnext == tnext and jlines == tlines


@pytest.mark.parametrize("loop", ["pretrain", "adapt"])
def test_device_aug_epoch_matches_jax(loop, capsys):
    """The unbundled loops with --device-aug: the same fetches, pipeline
    calls (adapt: the raw batch into the step; pretrain: the source views,
    and the style image only when s2t fires, zeros otherwise) and step
    batches."""
    jax_run, torch_run = device_aug_run(loop, False, capsys)
    assert_same_device_aug_runs(jax_run, torch_run)
    log = torch_run[0]
    steps = [e for e in log if isinstance(e, tuple)]
    assert len(steps) == 7
    if loop == "pretrain":
        fired = [g[0] for _, _, _, g in steps]
        assert 0 < sum(fired) < 7 and log.count("target") == sum(fired)
        assert log.count("style_image") == sum(fired)
        zero = [dict((k, z) for k, _, _, z in leaves)["image_t_style"]
                for _, leaves, _, _ in steps]
        assert zero == [not f for f in fired]
    else:
        assert log.count("raw_adapt_batch") == 7 and log.count("target") == 7
        assert all(dict((k, d) for k, _, d, _ in e[1])["canvas_s"] == "|u1" for e in steps)
