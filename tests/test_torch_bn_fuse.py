"""The fused 1x1-conv + BatchNorm-statistics path (``UDA_BN_FUSE=1``): the
port's ``matmul_stats``, ``conv1x1_bn_stats``, fused Bottleneck, fused
PoseResNet and fused adapt step against the JAX package's, and the CUDA
kernel against its plain version on the card.

Tolerances, with their reasons:
- y in float32: rtol 1e-5, atol 1e-5 (the JAX package's own bound between
  its Pallas and XLA forms; the two GEMMs sum in other orders). y in bf16:
  one bf16 ulp, since both round an f32 sum whose order differs, plus twice
  the f32 summation bound K * 2^-24 * sum|x||w|: where the sum cancels to
  near zero its f32 error exceeds a bf16 ulp of the result (on an H100, 66
  of the 2.1M outputs at (8192, 1024, 256)).
- s1, s2: the sums of each side's own y, so they may differ by what the y
  differ by (summed over the rows) plus f32 summation-order error, taken as
  1e-5 of the sum of magnitudes (a few dozen rounding steps at 2^-24 each).
- Gradients of ``matmul_stats``: rtol 1e-4, atol 1e-4 (the JAX package's
  own bound for its custom VJP); against torch autograd of the plain
  composition: rtol 1e-5, atol 1e-5 (the same analytic gradient, whose f32
  terms are summed in another order).
- Modules and models: as tests/test_torch_models.py and
  tests/test_torch_train_step.py, for the same reasons (XLA's and ATen's
  convolutions sum in other orders; train-mode BatchNorm over few values
  amplifies that).
- Backward passes in float64. The fused GEMM of both packages accumulates
  in float32 and returns float32 statistics even for float64 inputs
  (``preferred_element_type=jnp.float32`` in ``_mm_stats_xla``), and this
  tiny model's gradients move ~1% in norm for a 1e-6 relative change
  (tests/grad_precision_probe.py). So the port's fused float64 backward is
  held against JAX's fused one only in norm, and closely against the
  port's own fused forward differentiated by torch autograd through
  ``matmul_stats_plain``: the forwards are then the same computation, and
  only the backward's float32 terms differ in rounding.

The JAX package is imported inside the tests that use it, so that the card
tests also run where only PyTorch is installed:
``python -m pytest --noconftest tests/test_torch_bn_fuse.py -m gpu``.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from uda_poseestimation_torch import weights
from uda_poseestimation_torch.models import (Bottleneck, PoseResNet, ResNet, pose_resnet50,
                                             resnet50)
from uda_poseestimation_torch.models.resnet import reset_resnet_
from uda_poseestimation_torch.ops.bn_fuse import (conv1x1_bn_stats, matmul_stats,
                                                  matmul_stats_plain)

K = 5


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= rel * scale, f"{what}: max abs err {err} vs {rel} x {scale}"


def _close_norm(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.linalg.norm(got - want))
    assert err <= rel * float(np.linalg.norm(want)), f"{what}: norm of err {err}"


def _bf16_gemm_close(got, want, x, w):
    """y = x @ w^T in bf16 from two f32 accumulations (module docstring)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    x, w = np.asarray(x, np.float64), np.asarray(w, np.float64)
    # a bf16 ulp is 2^16 f32 ulps (7 stored mantissa bits against 23)
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want))) * 65536.0
    bound = ulp + 2 * x.shape[1] * 2.0 ** -24 * (np.abs(x) @ np.abs(w).T)
    assert (np.abs(got - want) <= bound).all(), float(np.abs(got - want).max())


def _stats_close(s1, s2, y, s1_ref, s2_ref, y_ref):
    """s1/s2 of y against s1_ref/s2_ref of y_ref (see the module docstring)."""
    y, y_ref = np.asarray(y, np.float64), np.asarray(y_ref, np.float64)
    bound1 = np.abs(y - y_ref).sum(0) + 1e-5 * np.abs(y_ref).sum(0)
    bound2 = np.abs(y * y - y_ref * y_ref).sum(0) + 1e-5 * (y_ref * y_ref).sum(0)
    assert (np.abs(np.asarray(s1, np.float64) - s1_ref) <= bound1).all()
    assert (np.abs(np.asarray(s2, np.float64) - s2_ref) <= bound2).all()


def _gemm_inputs(seed, m, k, n):
    rng = np.random.RandomState(seed)
    return (rng.randn(m, k).astype(np.float32),
            (rng.randn(n, k) / np.sqrt(k)).astype(np.float32))


# ---------------------------------------------------------------- matmul_stats

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(200, 70, 130), (64, 64, 64), (1024, 256, 512)])
def test_plain_matches_jax(dtype, m, k, n):
    """matmul_stats_plain against JAX matmul_stats through its Pallas kernel
    (interpret mode) and against its XLA twin ``_mm_stats_xla``."""
    import jax.numpy as jnp

    from uda_poseestimation_tpu.ops.bn_fuse import _mm_stats_xla
    from uda_poseestimation_tpu.ops.bn_fuse import matmul_stats as jmatmul_stats

    x, w = _gemm_inputs(0, m, k, n)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w.T, jdt)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    # the same rounded inputs on both sides
    np.testing.assert_array_equal(np.float32(jx), tx.float().numpy())
    y, s1, s2 = matmul_stats_plain(tx, tw, tdt)
    assert y.dtype == tdt and s1.dtype == s2.dtype == torch.float32
    y = y.float().numpy()
    for jy, js1, js2 in (jmatmul_stats(jx, jw, jdt, "pallas", True),
                         _mm_stats_xla(jx, jw, jdt)):
        jy = np.float32(jy)
        if dtype == "float32":
            np.testing.assert_allclose(y, jy, rtol=1e-5, atol=1e-5)
        else:
            _bf16_gemm_close(y, jy, np.float32(jx), np.float32(jw).T)
        _stats_close(s1.numpy(), s2.numpy(), y, np.asarray(js1), np.asarray(js2), jy)
    # the statistics are of the CAST y
    _stats_close(s1.numpy(), s2.numpy(), y, y.astype(np.float64).sum(0),
                 (y.astype(np.float64) ** 2).sum(0), y)


def _loss_terms(seed, n):
    rng = np.random.RandomState(seed)
    return rng.randn(n).astype(np.float32), rng.randn(n).astype(np.float32)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_backward_matches_jax_grad(impl):
    """Gradients through the autograd Function equal jax.grad of JAX
    matmul_stats (its custom VJP ``_mm_bwd``), for a loss that reads y, s1
    and s2."""
    import jax
    import jax.numpy as jnp

    from uda_poseestimation_tpu.ops.bn_fuse import matmul_stats as jmatmul_stats

    x, w = _gemm_inputs(1, 96, 40, 24)
    t1, t2 = _loss_terms(2, 24)

    def jloss(x, w):
        y, s1, s2 = jmatmul_stats(x, w, jnp.float32, impl, impl == "pallas")
        return jnp.sum(jnp.tanh(y)) + jnp.sum(s1 * t1) + jnp.sum(s2 * t2)

    jgx, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w.T))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y, s1, s2 = matmul_stats(tx, tw)
    (torch.tanh(y).sum() + (s1 * torch.from_numpy(t1)).sum()
     + (s2 * torch.from_numpy(t2)).sum()).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw).T, rtol=1e-4, atol=1e-4)


def test_backward_is_autograd_of_plain_composition():
    """The analytic backward equals torch autograd through the plain
    composition (the same gradient, up to f32 summation order)."""
    x, w = (torch.from_numpy(a) for a in _gemm_inputs(3, 50, 12, 7))
    t1, t2 = (torch.from_numpy(a) for a in _loss_terms(4, 7))
    grads = []
    for fn in (matmul_stats, matmul_stats_plain):
        xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        y, s1, s2 = fn(xx, ww, torch.float32)
        ((y ** 3).sum() + (s1 * t1).sum() + (s2 * t2).sum()).backward()
        grads.append((xx.grad, ww.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_wrapper_on_cpu_is_the_plain_version():
    x, w = (torch.from_numpy(a) for a in _gemm_inputs(5, 40, 16, 8))
    before = matmul_stats.launches
    for got, want in zip(matmul_stats(x, w), matmul_stats_plain(x, w, torch.float32)):
        assert torch.equal(got, want)
    assert matmul_stats.launches == before  # only kernel launches count


def test_wrapper_rejects_bad_inputs():
    x, w = (torch.from_numpy(a) for a in _gemm_inputs(6, 40, 16, 8))
    with pytest.raises(ValueError, match=r"\(M, K\) and w \(N, K\)"):
        matmul_stats(x, w[:, :15])
    with pytest.raises(ValueError, match="share a floating dtype"):
        matmul_stats(x, w.double())
    with pytest.raises(ValueError, match="share a floating dtype"):
        matmul_stats(x.long(), w.long())


@pytest.mark.parametrize("stride", [1, 2])
def test_conv1x1_bn_stats_matches_jax_and_conv(stride):
    """A (strided) 1x1 conv + its channel statistics against JAX's
    conv1x1_bn_stats and against F.conv2d; y is a channels_last view."""
    import jax.numpy as jnp

    from uda_poseestimation_tpu.ops.bn_fuse import conv1x1_bn_stats as jconv

    rng = np.random.RandomState(7)
    x = rng.randn(2, 12, 9, 9).astype(np.float32)
    kernel = (rng.randn(20, 12, 1, 1) * 0.2).astype(np.float32)
    y, s1, s2 = conv1x1_bn_stats(torch.from_numpy(x), torch.from_numpy(kernel), stride)
    assert y.shape == (2, 20, 9 // stride + (9 % stride > 0), 9 // stride + (9 % stride > 0))
    assert y.is_contiguous(memory_format=torch.channels_last)
    jy, js1, js2 = jconv(jnp.asarray(x.transpose(0, 2, 3, 1)),
                         jnp.asarray(kernel.transpose(2, 3, 1, 0)), strides=stride)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    ref = F.conv2d(torch.from_numpy(x), torch.from_numpy(kernel), stride=stride)
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-5)
    yf = y.permute(0, 2, 3, 1).reshape(-1, 20).numpy()
    jyf = np.asarray(jy).reshape(-1, 20)
    _stats_close(s1.numpy(), s2.numpy(), yf, np.asarray(js1), np.asarray(js2), jyf)


# ------------------------------------------------------------ modules / models

def _bottleneck_variables(seed):
    """A JAX fused Bottleneck(filters 8, stride 2, projection shortcut) and
    its variables, with non-trivial BN parameters and running statistics."""
    import functools

    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from uda_poseestimation_tpu.models.resnet import Bottleneck as JBottleneck

    norm = functools.partial(nn.BatchNorm, use_running_average=False, momentum=0.9,
                             epsilon=1e-5)
    jblock = JBottleneck(filters=8, strides=2, downsample=True, norm=norm, fuse_bn=True)
    x = np.random.RandomState(seed).randn(4, 8, 8, 16).astype(np.float32)
    variables = jax.device_get(jblock.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    rng = np.random.RandomState(seed + 1)
    variables = jax.tree_util.tree_map(
        lambda v: (v + 0.1 * rng.randn(*v.shape)).astype(np.float32), variables)
    return jblock, variables, x


def _block_state_dict(variables):
    """The block's torch state dict through weights.resnet_state_dict, by
    placing it as ``layer1_0`` of a headless-ResNet tree."""
    params = {"conv1": {"kernel": np.zeros((7, 7, 3, 64), np.float32)},
              "bn1": {"scale": np.ones(64, np.float32), "bias": np.zeros(64, np.float32)},
              "layer1_0": variables["params"]}
    stats = {"bn1": {"mean": np.zeros(64, np.float32), "var": np.ones(64, np.float32)},
             "layer1_0": variables["batch_stats"]}
    sd = weights.resnet_state_dict(params, stats)
    return {k[len("layer1.0."):]: v for k, v in sd.items() if k.startswith("layer1.0.")}


def test_fused_bottleneck_matches_jax():
    """Train-mode output and running statistics of a fused Bottleneck
    (stride 2, projection shortcut) against JAX's fused Bottleneck."""
    jblock, variables, x = _bottleneck_variables(8)
    want, mut = jblock.apply(variables, x, mutable=["batch_stats"])
    block = Bottleneck(16, 8, stride=2, downsample=True, fuse_bn=True)
    weights._load(block, _block_state_dict(variables))
    got = block.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got.detach().permute(0, 2, 3, 1).numpy(), want, 1e-4, "output")
    new = _block_state_dict({"params": variables["params"],
                             "batch_stats": mut["batch_stats"]})
    own = block.state_dict()
    for key, v in new.items():
        if "running_" in key:
            _close(own[key].numpy(), v, 1e-4, key)
    assert int(own["bn1.num_batches_tracked"]) == 1
    assert int(own["downsample.1.num_batches_tracked"]) == 1


def _tiny_models(fuse_jax):
    """The tiny JAX PoseResNet of tests/test_torch_models.py (random running
    statistics, deconv/head kernels scaled) with ``fuse_bn=fuse_jax``, its
    variables, and the port's fused twin with the same weights."""
    import jax
    import jax.numpy as jnp

    from uda_poseestimation_tpu.models.pose_resnet import PoseResNet as JPoseResNet
    from uda_poseestimation_tpu.models.resnet import Bottleneck as JBottleneck
    from uda_poseestimation_tpu.models.resnet import ResNet as JResNet

    def jmodel(fuse, dtype=jnp.float32):
        return JPoseResNet(backbone=JResNet(block=JBottleneck, stage_sizes=(1, 1, 1, 1),
                                            dtype=dtype, fuse_bn=fuse),
                           num_keypoints=K, dtype=dtype)

    variables = jax.device_get(jmodel(False).init(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, 64, 64, 3)), train=False))
    rng = np.random.RandomState(1)
    stats = jax.tree_util.tree_map(
        lambda v: (v + 0.05 * rng.randn(*v.shape)).astype(np.float32),
        variables["batch_stats"])
    params = jax.tree_util.tree_map(np.array, variables["params"])
    for i in range(3):
        params["upsampling"][f"deconv{i}"]["kernel"] *= 30.0
    params["head"]["kernel"] *= 100.0
    variables = {"params": params, "batch_stats": stats}
    tmodel = weights.load_pose_resnet(
        PoseResNet(ResNet(Bottleneck, (1, 1, 1, 1), fuse_bn=True), K), variables)
    return jmodel, variables, tmodel


def test_fused_pose_resnet_train_forward_matches_jax():
    """Train-mode forward and running statistics of the tiny fused
    PoseResNet against JAX ``fuse_bn=True``, in float32."""
    import jax

    jmodel, variables, tmodel = _tiny_models(True)
    x = np.random.RandomState(2).randn(4, 64, 64, 3).astype(np.float32)
    want, mut = jax.jit(lambda v, x: jmodel(True).apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, x)
    got = tmodel.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got.detach().numpy(), want, 1e-4, "heatmaps")
    new_sd = weights.pose_resnet_state_dict(
        {"params": variables["params"], "batch_stats": jax.device_get(mut["batch_stats"])})
    own = tmodel.state_dict()
    for key, v in new_sd.items():
        if "running_" in key:
            _close(own[key].numpy(), v, 1e-4, key)


def _student_loss_and_grads_jax(jmodel, variables, x1, x2, weight_y):
    import jax
    import jax.numpy as jnp

    f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
    stats = f64(variables["batch_stats"])

    def loss_fn(params):
        y1, mut = jmodel.apply({"params": params, "batch_stats": stats}, f64(x1),
                               train=True, mutable=["batch_stats"])
        y2, _ = jmodel.apply({"params": params, "batch_stats": mut["batch_stats"]},
                             f64(x2), train=True, mutable=["batch_stats"])
        return jnp.sum(y1 * weight_y) + jnp.sum(jnp.tanh(y2))

    loss, grads = jax.device_get(jax.jit(jax.value_and_grad(loss_fn))(
        f64(variables["params"])))
    return float(loss), weights.pose_resnet_state_dict({"params": grads})


def test_fused_student_backward_in_float64(monkeypatch):
    """Two chained train-mode forwards and their gradients in float64: the
    port's fused model against the same model with ``matmul_stats``'s
    backward left to torch autograd of ``matmul_stats_plain`` at 2e-5 (the
    same forward; the two backwards round their float32 terms differently,
    ~2^-24 each, which the model's backward grows to ~2e-6 here),
    and against JAX's fused model in norm at 1e-2 (see the module
    docstring; tests/grad_precision_probe.py prints the comparison for one
    forward)."""
    import jax
    import jax.numpy as jnp

    from uda_poseestimation_torch.ops import bn_fuse

    jmodel, variables, tmodel = _tiny_models(True)
    rng = np.random.RandomState(3)
    x1, x2 = rng.rand(2, 4, 64, 64, 3)
    weight_y = rng.randn(4, K, 16, 16)
    with jax.enable_x64(True):
        jl_fused, jg_fused = _student_loss_and_grads_jax(
            jmodel(True, jnp.float64), variables, x1, x2, weight_y)

    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)

    def loss_and_grads():
        model = copy.deepcopy(tmodel).double().train()
        loss = ((model(nchw(x1)).double() * torch.from_numpy(weight_y)).sum()
                + torch.tanh(model(nchw(x2))).sum())
        loss.backward()
        return float(loss.detach()), {n: p.grad.numpy() for n, p in model.named_parameters()}

    loss, grads = loss_and_grads()
    monkeypatch.setattr(bn_fuse, "matmul_stats", matmul_stats_plain)
    auto_loss, auto_grads = loss_and_grads()
    assert loss == auto_loss
    assert loss == pytest.approx(jl_fused, rel=1e-4)
    for name, g in grads.items():
        _close(g, auto_grads[name], 2e-5, name)
        _close_norm(g, jg_fused[name], 1e-2, name)


def test_fused_state_dict_equals_unfused():
    """Fusion changes no module: the same keys and shapes, so weights.py and
    checkpoints load the same tree into either."""
    fused = PoseResNet(ResNet(Bottleneck, (1, 1, 1, 1), fuse_bn=True), K)
    plain = PoseResNet(ResNet(Bottleneck, (1, 1, 1, 1), fuse_bn=False), K)
    a, b = fused.state_dict(), plain.state_dict()
    assert list(a) == list(b)
    assert all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype for k in a)


def test_fused_eval_forward_is_the_unfused_one():
    """Eval mode keeps the plain conv and the running-statistics BN: the
    fused and unfused models' eval heatmaps are bit-equal, and a fused
    train-mode forward does take another path."""
    _, _, fused = _tiny_models(True)
    plain = copy.deepcopy(fused)
    for m in plain.modules():
        if isinstance(m, Bottleneck):
            m.fuse_bn = False
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 3, 64, 64).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(fused.eval()(x), plain.eval()(x))
        assert not torch.equal(fused.train()(x), plain.train()(x))


@pytest.mark.parametrize("env,arg,want", [(None, None, False), ("1", None, True),
                                          ("0", None, False), ("1", False, False),
                                          (None, True, True)])
def test_fuse_bn_none_follows_env(monkeypatch, env, arg, want):
    """``fuse_bn=None`` reads UDA_BN_FUSE (on only for "1"), as the JAX
    package's flag; an explicit value wins."""
    if env is None:
        monkeypatch.delenv("UDA_BN_FUSE", raising=False)
    else:
        monkeypatch.setenv("UDA_BN_FUSE", env)
    backbone = resnet50(fuse_bn=arg)
    assert backbone.fuse_bn is want
    assert all(b.fuse_bn is want for b in backbone.modules() if isinstance(b, Bottleneck))
    assert pose_resnet50(K, fuse_bn=arg).backbone.fuse_bn is want


# ----------------------------------------------------------- fused adapt step

@pytest.fixture(scope="module")
def fused_adapt_run():
    """One fused adapt step of the JAX package and of the port from the same
    weights, batch, gates and occlusion draws (the setup of
    tests/test_torch_train_step.py, with ``fuse_bn=True`` in both)."""
    import jax
    import jax.numpy as jnp
    from test_torch_train_step import (CFG, GATES, KEY, LR, _batch, _jax_draws,
                                       _jax_state, _models)

    from uda_poseestimation_tpu.models.pose_resnet import PoseResNet as JPoseResNet
    from uda_poseestimation_tpu.models.resnet import Bottleneck as JBottleneck
    from uda_poseestimation_tpu.models.resnet import ResNet as JResNet
    from uda_poseestimation_tpu.parallel import train_step as jts
    from uda_poseestimation_torch.parallel import train_step as tts

    _, variables, jstyle, style_params, tmodel, tstyle = _models()
    kpts = tmodel.head.out_channels
    jmodel = JPoseResNet(backbone=JResNet(block=JBottleneck, stage_sizes=(1, 1, 1, 1),
                                          fuse_bn=True), num_keypoints=kpts)
    fused = weights.load_pose_resnet(
        PoseResNet(ResNet(Bottleneck, (1, 1, 1, 1), fuse_bn=True), kpts), variables)
    batch = _batch(0)
    jbatch = {k: v for k, v in batch.items() if k != "image_t_style"}
    jcfg = jts.StepConfig(**CFG)
    jstep = jts.make_adapt_step(jmodel, jcfg, style_model=jstyle)
    jstate, jmetrics, jy = jax.device_get(jstep(
        _jax_state(variables, jcfg), style_params, jbatch, jnp.float32(LR), KEY,
        *(jnp.asarray(GATES[n]) for n in ("do_s2t", "alpha_s2t", "do_t2s", "alpha_t2s"))))
    tcfg = tts.StepConfig(**CFG)
    state = tts.create_state(fused, tcfg, seed=None, device="cpu")
    step = tts.make_adapt_step(tcfg, style_model=tstyle, device="cpu")
    state, metrics, y = step(state, batch, LR, **GATES,
                             occlusion_draws=_jax_draws(KEY, *batch["target_s"].shape[:2]))
    return dict(jstate=jstate, jmetrics=jmetrics, jy=jy, state=state, metrics=metrics,
                y=y, key=KEY, jcfg=jcfg)


def test_fused_adapt_integer_outputs_equal(fused_adapt_run):
    """The kth-value mask, the occlusion gate and its rectangles are equal."""
    from uda_poseestimation_tpu.parallel import train_step as jts

    aux = fused_adapt_run["metrics"]["aux"]
    jaux = fused_adapt_run["jmetrics"]["aux"]
    np.testing.assert_array_equal(aux["tea_mask"].numpy(), np.asarray(jaux["tea_mask"]))
    assert 0 < aux["tea_mask"].sum() < aux["tea_mask"].numel()
    geom = [np.asarray(g) for g in jts._occlusion_geometry(
        fused_adapt_run["key"], np.asarray(jaux["y_t_tea_recon"]), fused_adapt_run["jcfg"])]
    np.testing.assert_array_equal(aux["occlude"].numpy(), geom[0])
    assert 0 < geom[0].sum() < len(geom[0])
    np.testing.assert_array_equal(aux["occlusion_rect"].numpy(), np.stack(geom[1:], -1))


@pytest.mark.parametrize("name", ["y_t_tea_recon", "activates", "mask_thresh",
                                  "y_t_stu_recon"])
def test_fused_adapt_aux_floats_match(fused_adapt_run, name):
    _close(fused_adapt_run["metrics"]["aux"][name].numpy(),
           fused_adapt_run["jmetrics"]["aux"][name], 1e-3, name)


def test_fused_adapt_losses_grads_and_stats_match(fused_adapt_run):
    """Losses and heatmaps at 1e-3, gradients in norm at 5e-2 (the tiny
    model's float32 sensitivity, as in tests/test_torch_train_step.py), and
    both models' running statistics at 1e-3."""
    run = fused_adapt_run
    for name in ("loss_all", "loss_s", "loss_c"):
        _close(run["metrics"][name].numpy(), run["jmetrics"][name], 1e-3, name)
    _close(run["y"].numpy(), run["jy"], 1e-3, "y_s")
    grads = run["metrics"]["aux"]["grads"]
    jgrads = weights.pose_resnet_state_dict({"params": run["jmetrics"]["aux"]["grads"]})
    assert set(grads) == set(jgrads)
    for name, g in jgrads.items():
        _close_norm(grads[name].numpy(), g, 5e-2, name)
    state, jstate = run["state"], run["jstate"]
    for model, params, stats in ((state.student, jstate.student_params, jstate.student_stats),
                                 (state.teacher, jstate.teacher_params, jstate.teacher_stats)):
        want = weights.pose_resnet_state_dict({"params": params, "batch_stats": stats})
        own = model.state_dict()
        for name, v in want.items():
            if "running_" in name:
                _close(own[name].numpy(), v, 1e-3, name)


# ------------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# each branch of the plan in bf16 (ops/bn_fuse.py::_plan; f32 runs simt):
# mma_sync (K % 8 != 0, N % 8 != 0); tma at BN 64 (N <= 512) and BN 128;
# N = 64; grids under one wave ((1000, 72, 200) with ragged M, N and K,
# (256, 4096, 256) with 64 k-steps); a one-block grid (77, 64, 40); row
# groups walking several tiles
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(200, 70, 130), (77, 64, 33), (8192, 1024, 256),
                                   (2048, 512, 2048), (4096, 256, 64), (2048, 2048, 512),
                                   (256, 4096, 256), (1000, 72, 200), (77, 64, 40),
                                   (32768, 128, 512)])
def test_kernel_matches_plain_on_card(cuda, dtype, m, k, n):
    """The CUDA kernel against the plain version on the card: y as in the
    module docstring, and its statistics against the sums of its own y; one
    launch counted, of the variant that ``_plan`` picks."""
    from uda_poseestimation_torch.ops.bn_fuse import kernel_plan

    tdt = getattr(torch, dtype)
    x, w = (torch.from_numpy(a).to(cuda, tdt) for a in _gemm_inputs(9, m, k, n))
    variant = kernel_plan(x, w).variant
    before = matmul_stats.launches
    by_variant = dict(matmul_stats.launches_by_variant)
    y, s1, s2 = matmul_stats(x, w)
    torch.cuda.synchronize()
    assert matmul_stats.launches == before + 1
    by_variant[variant] += 1
    assert matmul_stats.launches_by_variant == by_variant
    yp = matmul_stats_plain(x, w, tdt)[0].float().cpu().numpy()
    y = y.float().cpu().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(y, yp, rtol=1e-5, atol=1e-5)
    else:
        _bf16_gemm_close(y, yp, x.float().cpu().numpy(), w.float().cpu().numpy())
    y64 = y.astype(np.float64)
    _stats_close(s1.cpu().numpy(), s2.cpu().numpy(), y, y64.sum(0), (y64 ** 2).sum(0), y)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", [None, "mma_sync"])
@pytest.mark.parametrize("m,k,n", [(8192, 256, 1024), (2048, 2048, 512), (1000, 72, 200)])
def test_kernel_repeats_bit_for_bit_on_card(cuda, m, k, n, variant):
    """No float atomics: two calls give the same y, s1 and s2 bit for bit,
    with the last-block reduction of the statistics (its partial rows meet
    in a fixed order)."""
    from uda_poseestimation_torch.ops.bn_fuse import _matmul_stats_cuda

    x, w = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in _gemm_inputs(11, m, k, n))
    first = _matmul_stats_cuda(x, w, torch.bfloat16, variant)
    for _ in range(3):
        again = _matmul_stats_cuda(x, w, torch.bfloat16, variant)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
def test_kernel_rejects_a_tma_plan_for_unaligned_operands(cuda):
    """Forcing the tma variant where no tensor map can describe x raises; it
    never runs another variant instead."""
    from uda_poseestimation_torch.ops.bn_fuse import _matmul_stats_cuda

    x, w = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in _gemm_inputs(12, 64, 72, 64))
    shifted = torch.empty(x.numel() + 4, dtype=x.dtype, device=cuda)[4:].view_as(x)
    with pytest.raises(ValueError, match="no tma plan"):
        _matmul_stats_cuda(shifted.copy_(x), w, torch.bfloat16, "tma")


@pytest.mark.gpu
def test_launcher_rejects_partials_of_another_size(cuda):
    """The mma_sync and simt launcher sizes its grid from the shape; given
    partial rows for another count of row tiles it refuses to launch (-3)
    rather than write past them."""
    from uda_poseestimation_torch.ops.bn_fuse import _launcher

    lib = _launcher()
    m, k, n = 300, 72, 64
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for dtype, tiles in ((torch.bfloat16, 3), (torch.float32, 5)):
        x = torch.zeros(m, k, dtype=dtype, device=cuda)
        w = torch.zeros(n, k, dtype=dtype, device=cuda)
        y = torch.empty(m, n, dtype=dtype, device=cuda)
        part = torch.zeros(2, tiles + 1, n, device=cuda)
        stats = torch.zeros(2, n, device=cuda)
        for groups, want in ((tiles - 1, -3), (tiles + 1, -3), (tiles, 0)):
            err = lib.matmul_stats_launch(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), part[0].data_ptr(),
                part[1].data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(), m, k, n,
                groups, int(dtype == torch.bfloat16), stream)
            assert err == want, (dtype, groups)
        torch.cuda.synchronize()


@pytest.mark.gpu
def test_fused_bottleneck_on_card_matches_cpu(cuda):
    """A fused Bottleneck's f32 train-mode output and gradients on the card
    (through the kernel) against the CPU (through the plain version)."""
    block = Bottleneck(16, 8, stride=2, downsample=True, fuse_bn=True)
    reset_resnet_(block, torch.Generator().manual_seed(10))
    x = torch.from_numpy(np.random.RandomState(10).randn(4, 16, 8, 8).astype(np.float32))
    outs = []
    for dev in (cuda, torch.device("cpu")):
        b = copy.deepcopy(block).to(dev).train()
        xin = x.to(dev)
        before = matmul_stats.launches
        y = b(xin)
        (y * y).sum().backward()
        outs.append((y.detach().cpu(), b.conv1.weight.grad.cpu(),
                     matmul_stats.launches - before))
    (yg, gg, launched), (yc, gc, _) = outs
    assert launched == 3
    _close(yg.numpy(), yc.numpy(), 1e-4, "output")
    _close_norm(gg.numpy(), gc.numpy(), 1e-3, "conv1 grad")
