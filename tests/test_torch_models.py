"""The port's PoseResNet and StyleNet against the JAX package's, with the
JAX weights carried over by ``uda_poseestimation_torch.weights``.

Tolerance: float32 forwards through XLA's and ATen's CPU convolutions sum
in different orders; over a tiny PoseResNet (~20 layers, train-mode BN on
few samples amplifies) and the VGG encoder/decoder the outputs agree to
~1e-5 of their largest magnitude, so they are held to 1e-4 of it.
Running statistics are means of those activations and are held to 1e-4 too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools.port_torch_weights import export_pose_resnet
from uda_poseestimation_tpu.models import StyleNet as JStyleNet
from uda_poseestimation_tpu.models.pose_resnet import PoseResNet as JPoseResNet
from uda_poseestimation_tpu.models.resnet import BasicBlock as JBasic
from uda_poseestimation_tpu.models.resnet import Bottleneck as JBottleneck
from uda_poseestimation_tpu.models.resnet import ResNet as JResNet
from uda_poseestimation_torch import weights
from uda_poseestimation_torch.models import (BasicBlock, BatchNorm2d, Bottleneck,
                                             PoseResNet, ResNet, StyleNet)

K = 5


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= rel * scale, f"max abs err {err} vs {rel} x {scale}"


def _tiny(block_name):
    jblock, tblock = {"bottleneck": (JBottleneck, Bottleneck),
                      "basic": (JBasic, BasicBlock)}[block_name]
    jmodel = JPoseResNet(backbone=JResNet(block=jblock, stage_sizes=(1, 1, 1, 1)),
                         num_keypoints=K)
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 64, 64, 3)), train=False))
    rng = np.random.RandomState(1)
    # non-trivial running statistics, and deconv/head kernels at a scale
    # whose outputs are not all cut by the ReLUs (their init std is 0.001)
    stats = jax.tree_util.tree_map(
        lambda v: (v + 0.05 * rng.randn(*v.shape)).astype(np.float32),
        variables["batch_stats"])
    params = jax.tree_util.tree_map(np.array, variables["params"])
    for i in range(3):
        params["upsampling"][f"deconv{i}"]["kernel"] *= 30.0
    params["head"]["kernel"] *= 100.0
    variables = {"params": params, "batch_stats": stats}
    tmodel = PoseResNet(ResNet(tblock, (1, 1, 1, 1)), K)
    weights.load_pose_resnet(tmodel, variables)
    return jmodel, variables, tmodel


@pytest.mark.parametrize("block", ["bottleneck", "basic"])
@pytest.mark.parametrize("train", [False, True])
def test_pose_resnet_forward_matches(block, train):
    jmodel, variables, tmodel = _tiny(block)
    x = np.random.RandomState(2).randn(4, 64, 64, 3).astype(np.float32)
    if train:
        want, mut = jax.jit(lambda v, x: jmodel.apply(v, x, train=True,
                                                      mutable=["batch_stats"]))(variables, x)
    else:
        want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, x)
    tmodel.train(train)
    got = tmodel(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32 and got.shape == (4, K, 16, 16)
    _close(got.detach().numpy(), want)
    if train:
        # running statistics after the train-mode forward: Flax's rule
        new_sd = weights.pose_resnet_state_dict(
            {"params": variables["params"], "batch_stats": jax.device_get(mut["batch_stats"])})
        own = tmodel.state_dict()
        for key, want_v in new_sd.items():
            if "running_" in key:
                _close(own[key].numpy(), want_v)


def test_batchnorm_running_var_is_biased():
    """Flax BatchNorm(momentum=0.9) moves running_var toward the BIASED batch
    variance; torch.nn.BatchNorm2d would use the unbiased one."""
    bn = BatchNorm2d(3)
    x = torch.randn(2, 3, 2, 2, generator=torch.Generator().manual_seed(0))
    y = bn.train()(x)
    mean = x.mean(dim=(0, 2, 3))
    var_b = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var_b, rtol=1e-6, atol=1e-7)
    ref = torch.nn.BatchNorm2d(3).train()
    ref(x)
    assert not torch.allclose(ref.running_var, bn.running_var)  # n/(n-1) apart
    torch.testing.assert_close(  # train-mode outputs normalize by the biased var
        y, (x - mean.view(1, 3, 1, 1)) / torch.sqrt(var_b.view(1, 3, 1, 1) + 1e-5),
        rtol=1e-5, atol=1e-5)
    # a second batch: 0.9 * running + 0.1 * batch statistics
    x2 = 2.0 * torch.randn(2, 3, 2, 2, generator=torch.Generator().manual_seed(1))
    rv = bn.running_var.clone()
    bn(x2)
    torch.testing.assert_close(bn.running_var,
                               0.9 * rv + 0.1 * x2.var(dim=(0, 2, 3), unbiased=False),
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(bn.num_batches_tracked, torch.tensor(2))


def test_state_dict_layout_matches_reference_export():
    """The port's keys are the reference's torch keys: the JAX package's own
    exporter (tools/port_torch_weights.py) writes the same dict."""
    _, variables, tmodel = _tiny("bottleneck")
    ref = export_pose_resnet(variables, prefix="")
    ours = weights.pose_resnet_state_dict(variables)
    assert set(ours) == set(ref)
    assert set(ours) | {k for k in tmodel.state_dict() if k.endswith("num_batches_tracked")} \
        == set(tmodel.state_dict())
    for k, v in ours.items():
        np.testing.assert_array_equal(v, ref[k].numpy(), err_msg=k)


@pytest.fixture(scope="module")
def style_pair():
    jstyle = JStyleNet()
    dummy = jnp.zeros((1, 64, 64, 3), jnp.float32)
    params = jax.device_get(jstyle.init(jax.random.PRNGKey(3), dummy, dummy)["params"])
    tstyle = weights.load_style_net(StyleNet(), params)
    return jstyle, params, tstyle


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("method", ["encode", "decode", "stylize"])
def test_style_net_matches(style_pair, method):
    jstyle, params, tstyle = style_pair
    rng = np.random.RandomState(4)
    content = rng.rand(2, 64, 64, 3).astype(np.float32)
    style = rng.rand(2, 64, 64, 3).astype(np.float32)
    feat = rng.rand(2, 8, 8, 512).astype(np.float32)
    with torch.no_grad():
        if method == "encode":
            want = jstyle.apply({"params": params}, content, method=JStyleNet.encode)
            got = tstyle.encode(_nchw(content))
        elif method == "decode":
            want = jstyle.apply({"params": params}, feat, method=JStyleNet.decode)
            got = tstyle.decode(_nchw(feat))
        else:
            want = jstyle.apply({"params": params}, content, style, 0.7,
                                method=JStyleNet.stylize)
            got = tstyle.stylize(_nchw(content), _nchw(style), 0.7)
    _close(got.permute(0, 2, 3, 1).numpy(), want)


def test_style_net_taps_and_ceil_pool(style_pair):
    """The four AdaIN taps, on an odd size that exercises ceil-mode pooling."""
    jstyle, params, tstyle = style_pair
    x = np.random.RandomState(5).rand(1, 33, 47, 3).astype(np.float32)
    want = jstyle.apply({"params": params}, x,
                        method=JStyleNet.encode_with_intermediate)
    with torch.no_grad():
        got = tstyle.encoder(_nchw(x), return_intermediate=True)
    assert len(got) == 4
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1).numpy(), w)
