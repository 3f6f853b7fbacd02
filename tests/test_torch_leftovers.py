"""The port's modules that no trainer calls, against the JAX package's on
the same numpy-seeded inputs:

- the losses of ``models/loss.py``: ``joints_kl_loss``, ``ent_loss``,
  ``cons_softmax_loss``, ``cons_kl_loss`` (with JAX's guard on its
  log-probability target: finite where the reference is NaN) and
  ``coral_loss`` (bilinear downsample without antialias, a prior);
- the ramps of ``utils/schedules.py``, and the EMA classes ``ema_init``,
  ``OldWeightEMA`` and ``ModelEMA`` (parameters averaged, buffers copied);
- ``ops/heatmap.generate_prior_map``, both branches;
- the backbones: every parameter's and statistic's shape of resnet152,
  resnext50_32x4d, resnext101_32x8d, wide_resnet50_2 and wide_resnet101_2
  against ``jax.eval_shape`` of JAX's (no forward at full size; the port's
  built on the meta device), and a tiny grouped ResNet's forward through
  ``weights.py``;
- the registry: every name of ``uda_poseestimation_tpu.models`` resolves in
  the port's (the stubs raise, as JAX's do);
- ``tools/fixtures.make_animal``: the tree of ``tools/make_fixtures.
  make_animal`` byte for byte, the ``.mat`` headers' time of writing fixed;
- ``models/switches.py``: each of the JAX package's opt-in layer switches,
  set, warns that it selects nothing in the port;
- ``tools/profile_step.py`` on the CPU at a small size.

Tolerances (float32, relative to the largest magnitude of JAX's value):
losses and the prior map 1e-5 (XLA's and ATen's exp, log and sums differ
by ulps), CORAL 1e-4 (a difference of two nearly equal covariances), the
grouped forward 1e-4; schedules and EMA arithmetic exact or 1e-6.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uda_poseestimation_tpu.models as jmodels
from tools import make_fixtures
from uda_poseestimation_tpu.models import ema as jema
from uda_poseestimation_tpu.models import loss as jloss
from uda_poseestimation_tpu.models import resnet as jresnet
from uda_poseestimation_tpu.ops import heatmap as jheat
from uda_poseestimation_tpu.utils import schedules as jsched
from uda_poseestimation_torch import models as tmodels
from uda_poseestimation_torch import weights
from uda_poseestimation_torch.models import ema as tema
from uda_poseestimation_torch.models import loss as tloss
from uda_poseestimation_torch.models import resnet as tresnet
from uda_poseestimation_torch.ops import heatmap as theat
from uda_poseestimation_torch.tools import fixtures, profile_step
from uda_poseestimation_torch.utils import schedules as tsched


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Torch at 2 threads: six test workers share the cores, and the
    profiled step and the spawned processes would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rel, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * max(scale, 1e-30), f"{what}: {err} vs {rel} x {scale}"


def _maps(seed, shape=(3, 4, 8, 8)):
    rng = np.random.RandomState(seed)
    return rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)


T = torch.from_numpy


@pytest.mark.parametrize("weighted,reduction,eps", [(False, "mean", 0.0), (True, "mean", 0.1),
                                                    (True, "none", 0.0)])
def test_joints_kl_loss_matches_jax(weighted, reduction, eps):
    out, tgt = _maps(0)
    tgt = np.abs(tgt) * (np.random.RandomState(1).rand(*tgt.shape) > 0.3)  # zeros: 0 log 0
    w = np.random.RandomState(2).rand(3, 4, 1).astype(np.float32) if weighted else None
    want = jloss.joints_kl_loss(out, tgt, w, reduction, eps)
    got = tloss.joints_kl_loss(T(out), T(tgt.astype(np.float32)), None if w is None else T(w),
                               reduction, eps)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("threshold,reduction", [(-1.0, "mean"), (-1.0, "none"), (0.97, "mean"),
                                                 (1e-3, "mean")])
def test_ent_loss_matches_jax(threshold, reduction):
    x = _maps(3)[0] * 3.0
    want = jloss.ent_loss(x, threshold, reduction)
    _close(tloss.ent_loss(T(x), threshold, reduction), want, 1e-5)


def _masks(seed):
    rng = np.random.RandomState(seed)
    return rng.rand(3) > 0.4, rng.rand(3, 4) > 0.5


@pytest.mark.parametrize("name", ["cons_softmax_loss", "cons_kl_loss"])
@pytest.mark.parametrize("masked", [False, True])
def test_consistency_variants_match_jax(name, masked):
    stu, tea = _maps(4)
    valid, tea_mask = _masks(5) if masked else (None, None)
    want = getattr(jloss, name)(stu, tea, valid, tea_mask)
    got = getattr(tloss, name)(T(stu), T(tea), None if valid is None else T(valid),
                               None if tea_mask is None else T(tea_mask))
    _close(got, want, 1e-5, name)


def test_cons_kl_loss_is_finite_where_the_reference_is_nan():
    """The reference's KLDivLoss on a log-probability target is NaN; JAX's
    guard and the port's give the finite -t * log_softmax(stu) instead."""
    stu, tea = _maps(6)
    ref = torch.nn.functional.kl_div(torch.log_softmax(T(stu).reshape(3, 4, -1), -1),
                                     torch.log_softmax(T(tea).reshape(3, 4, -1), -1),
                                     reduction="none")
    assert torch.isnan(ref).any()
    assert torch.isfinite(tloss.cons_kl_loss(T(stu), T(tea)))


@pytest.mark.parametrize("down,prior", [(1, False), (2, False), (2, True)])
def test_coral_loss_matches_jax(down, prior):
    src, tgt = _maps(7, (6, 3, 8, 8))
    d = 3 * (8 // down) ** 2
    p = (np.random.RandomState(8).randn(d, d).astype(np.float32) * 0.1) if prior else None
    want = jloss.coral_loss(src, tgt + 0.5, down, p)
    got = tloss.coral_loss(T(src), T(tgt + 0.5), down, None if p is None else T(p))
    _close(got, want, 1e-4)
    want_down = jloss._bilinear_downsample(tgt, 2)
    _close(tloss._bilinear_downsample(T(tgt), 2), want_down, 1e-6, "downsample")


def test_schedules_match_jax():
    for x in np.linspace(-0.5, 12.5, 53):
        for fn, args in (("sigmoid_rampup", (x, 10.0)), ("sigmoid_rampup", (x, 0)),
                         ("cosine_rampdown", (x, 10.0)), ("rev_sigmoid", (x / 10,)),
                         ("sigmoid", (x / 10,))):
            got, want = getattr(tsched, fn)(*args), getattr(jsched, fn)(*args)
            assert isinstance(got, float) and got == want, (fn, args, got, want)


def _linear(seed):
    torch.manual_seed(seed)
    m = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    with torch.no_grad():
        m[1].running_mean.uniform_(-1, 1)
    return m


def _np_tree(module):
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def test_ema_classes_match_jax():
    """Over modules: ``ema_init`` copies (a frozen deep copy), ``OldWeightEMA``
    averages the parameters only, ``ModelEMA`` averages them and copies the
    buffers; over state dicts the same, against JAX's pytrees."""
    student, other = _linear(0), _linear(1)
    params = {k for k, _ in student.named_parameters()}
    teacher = tema.ema_init(student)
    assert teacher is not student and not any(p.requires_grad for p in teacher.parameters())
    jold = jema.OldWeightEMA(None, {k: v for k, v in _np_tree(student).items() if k in params},
                             alpha=0.9)
    old = tema.OldWeightEMA(None, student, alpha=0.9)
    got = old.step(other)
    want = jold.step({k: v for k, v in _np_tree(other).items() if k in params})
    for k, v in _np_tree(got).items():
        if k in params:
            _close(v, want[k], 1e-6, k)
        else:  # buffers stay the copy's
            np.testing.assert_array_equal(v, _np_tree(student)[k], err_msg=k)
    sd = {k: v.clone() for k, v in other.state_dict().items()}
    old_sd = tema.OldWeightEMA(None, {k: v for k, v in student.state_dict().items()
                                      if k in params}, alpha=0.9)
    for k, v in old_sd.step(sd).items():
        _close(v, want[k], 1e-6, k)

    split = lambda tree: {"params": {k: v for k, v in tree.items() if k in params},  # noqa: E731
                          "batch_stats": {k: v for k, v in tree.items() if k not in params}}
    jmodel = jema.ModelEMA(split(_np_tree(student)), decay=0.8)
    want = jmodel.update(split(_np_tree(other)))
    for ema in (tema.ModelEMA(student, decay=0.8),
                tema.ModelEMA(student.state_dict(), decay=0.8, params=params)):
        got = ema.update(other if isinstance(ema.ema, torch.nn.Module) else other.state_dict())
        got = _np_tree(got) if isinstance(got, torch.nn.Module) else \
            {k: v.numpy() for k, v in got.items()}
        for k, v in got.items():
            group = "params" if k in params else "batch_stats"
            _close(v, np.asarray(want[group][k]), 1e-6, k)
    assert torch.equal(student[0].weight, _linear(0)[0].weight)  # the student untouched


@pytest.mark.parametrize("v3", [False, True])
def test_generate_prior_map_matches_jax(v3):
    rng = np.random.RandomState(9)
    k = 5
    preds = rng.rand(2, k, 16, 16).astype(np.float32)
    preds[1, 2] = -preds[1, 2]  # a channel with max <= 0 decodes to (0, 0)
    mean = (rng.rand(k, k) * 8).astype(np.float32)
    std = (rng.rand(k, k) * 3).astype(np.float32)
    want = jheat.generate_prior_map(jnp.asarray(mean), jnp.asarray(std), preds, v3=v3)
    got = theat.generate_prior_map(T(mean), T(std), T(preds), v3=v3)
    _close(got, want, 1e-5)


BACKBONES = ("resnet152", "resnext50_32x4d", "resnext101_32x8d", "wide_resnet50_2",
             "wide_resnet101_2")


def _jax_shapes(variables):
    """torch state-dict key -> shape, from JAX ResNet variables' shapes."""
    out = {}
    for coll, tree in variables.items():
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            names = [p.key for p in path]
            mod = names[0]
            if mod.startswith("layer"):
                stage, block = mod[len("layer"):].split("_")
                sub = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}.get(
                    names[1], names[1])
                key = f"layer{stage}.{block}.{sub}"
            else:
                key = mod
            leafname = {"kernel": "weight", "scale": "weight", "bias": "bias",
                        "mean": "running_mean", "var": "running_var"}[names[-1]]
            shape = tuple(leaf.shape)
            if leafname == "weight" and len(shape) == 4:
                shape = (shape[3], shape[2], shape[0], shape[1])
            out[f"{key}.{leafname}"] = shape
    return out


@pytest.mark.parametrize("name", BACKBONES)
def test_wide_backbone_shapes_match_jax(name):
    jnet = getattr(jresnet, name)()
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 64, 64, 3)), train=False))
    want = _jax_shapes(shapes)
    with torch.device("meta"):
        net = getattr(tmodels, name)()
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == want


def test_grouped_resnet_forward_through_weights():
    """A tiny ResNeXt-style backbone (groups 4, width 8 a group): the JAX
    variables carried across by ``weights.py`` give JAX's forward."""
    x = np.random.RandomState(10).rand(2, 32, 32, 3).astype(np.float32)
    jnet = jresnet.ResNet(block=jresnet.Bottleneck, stage_sizes=(1, 1), groups=4,
                          width_per_group=8)
    variables = jax.device_get(jax.jit(lambda r: jnet.init(r, x, train=False))(
        jax.random.PRNGKey(1)))
    want = jax.device_get(jax.jit(lambda v, a: jnet.apply(v, a, train=False))(variables, x))
    net = tresnet.ResNet(tresnet.Bottleneck, (1, 1), groups=4, width_per_group=8).eval()
    assert net.layer1[0].conv2.groups == 4 and net.layer1[0].conv2.in_channels == 32
    weights._load(net, weights.resnet_state_dict(variables["params"],
                                                 variables["batch_stats"]))
    got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, want, 1e-4)


def test_registry_names_resolve_in_the_port():
    """Every public name of the JAX registry is in the port's; the stubs
    raise there as in JAX (the reference's own cannot be built)."""
    names = [n for n in vars(jmodels) if not n.startswith("_")]
    missing = [n for n in names if not hasattr(tmodels, n)]
    assert missing == [], missing
    for stub in ("trans_pose_resnet", "trans_pose_resnet50"):
        with pytest.raises(NotImplementedError):
            getattr(tmodels, stub)(21)
    mask = tmodels.backbone_param_mask(tmodels.pose_resnet50(3))
    assert mask["backbone.conv1.weight"] and not mask["head.weight"]


def _tree(root):
    return {os.path.relpath(os.path.join(d, f), root): os.path.join(d, f)
            for d, _, files in os.walk(root) for f in files}


def test_make_animal_trees_byte_equal(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "asctime", lambda *a: "Thu Jan  1 00:00:00 1970")
    make_fixtures.make_animal(str(tmp_path / "jax"))
    fixtures.make_animal(str(tmp_path / "torch"))
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "torch")
    assert sorted(got) == sorted(want) and len(want) > 30
    assert any(p.endswith(".mat") for p in want) and any(p.endswith(".npy") for p in want)
    for rel, path in want.items():
        with open(path, "rb") as a, open(got[rel], "rb") as b:
            assert a.read() == b.read(), rel


@pytest.mark.parametrize("env, want", [
    ({}, []), ({"UDA_STEM_MODE": "direct", "UDA_PHASE_DECONV": "0"}, []),
    ({"UDA_STEM_MODE": "s2d"}, ["UDA_STEM_MODE"]),
    ({"UDA_STEM_MODE": "im2col", "UDA_STEM_S2D": "1"}, ["UDA_STEM_MODE", "UDA_STEM_S2D"]),
    ({"UDA_PHASE_DECONV": "1", "UDA_SUBPIXEL_DECODER": "1", "UDA_VGG_IM2COL": "1"},
     ["UDA_PHASE_DECONV", "UDA_SUBPIXEL_DECODER", "UDA_VGG_IM2COL"])])
def test_unported_switches_warn(env, want):
    """A JAX switch that would select another layer form warns that the port
    runs the default; one left at its default, or unset, says nothing."""
    import warnings

    from uda_poseestimation_torch.models import switches

    assert set(switches.UNPORTED) == {"UDA_STEM_MODE", "UDA_STEM_S2D", "UDA_PHASE_DECONV",
                                      "UDA_SUBPIXEL_DECODER", "UDA_VGG_IM2COL"}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert switches.warn_unported(env) == want
    assert [str(w.message).split("=")[0] for w in caught] == want
    assert all("selects nothing in the port" in str(w.message) for w in caught)


def test_profile_step_on_cpu(tmp_path, capsys):
    rows = profile_step.main(["--device", "cpu", "--arch", "pose_resnet50", "--batch", "2",
                              "--image-size", "32", "--heatmap-size", "8", "--keypoints",
                              "3", "--steps", "1", "--out", str(tmp_path), "--top", "5"])
    out = capsys.readouterr().out
    assert "top ops by self CPU" in out and len(rows) == 5
    assert any("conv" in r["name"] for r in rows)
    again = profile_step.main(["--parse-only", "--out", str(tmp_path), "--top", "5"])
    assert again == rows
