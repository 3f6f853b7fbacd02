"""The port's StyleNet training forward, its backward into the decoder,
its encoder's four AdaIN taps and ``gram_matrix`` against the JAX
package's, with the JAX weights carried over by
``uda_poseestimation_torch.weights.load_style_net``.

The decoder's last kernel is scaled by 100 in the JAX weights before they
are carried over: a random-init StyleNet's output is ~1e-3 (ROADMAP.md
§C), and its style losses would then be dominated by the eps under the
square root.

Tolerance: float32 through XLA's and ATen's CPU convolutions, which sum in
other orders. ``gram_matrix`` and its gradient (one contraction) are held
to 1e-5 of the largest output; the encoder's taps to 1e-5 of each tap's
largest value; the StyleNet's stylized image to 1e-4 of its largest value,
its two losses to 1e-4 relative (the encoder-decoder-encoder chain is ~40
layers deep). The decoder's gradients: within 1e-5 of each tensor's
largest entry of the port's own float64 run (measured 1.3e-6), and within
1e-3 of JAX's (measured 1.4e-4 for the gram loss, 8e-6 for meanstd: JAX's
float32 gram gradient is itself 1.4e-4 from the float64 one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uda_poseestimation_tpu.models import StyleNet as JStyleNet
from uda_poseestimation_tpu.ops.adain import gram_matrix as jgram_matrix
from uda_poseestimation_torch import weights
from uda_poseestimation_torch.models import StyleNet
from uda_poseestimation_torch.ops import gram_matrix

SIZE = 32


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= rel * scale, f"max abs err {err} vs {rel} x {scale}"


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


def style_params(seed=3, size=SIZE):
    """JAX StyleNet parameters (numpy), the decoder's last kernel x100."""
    jstyle = JStyleNet()
    dummy = jnp.zeros((1, size, size, 3), jnp.float32)
    params = jax.device_get(
        jax.jit(lambda r: jstyle.init(r, dummy, dummy))(jax.random.PRNGKey(seed))["params"])
    conv8 = params["decoder"]["conv8"]["Conv_0"]
    conv8["kernel"] = conv8["kernel"] * 100.0
    return params


@pytest.fixture(scope="module")
def params():
    return style_params()


def _images(seed=4, b=2, size=SIZE):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, size, size, 3).astype(np.float32),
            rng.rand(b, size, size, 3).astype(np.float32))


def test_gram_matrix_matches_jax():
    feat = np.random.RandomState(0).randn(2, 6, 5, 7).astype(np.float32)
    want = jgram_matrix(jnp.asarray(feat))
    got = gram_matrix(torch.from_numpy(feat))
    assert got.shape == (2, 6, 6)
    _close(got.numpy(), want, 1e-5)


def test_gram_matrix_gradient_matches_jax():
    """The gradient of a Gram MSE, through the port's full-float32
    backward, against ``jax.grad`` of JAX's."""
    rng = np.random.RandomState(2)
    feat = rng.randn(2, 6, 5, 7).astype(np.float32)
    target = rng.randn(2, 6, 6).astype(np.float32) * 0.1
    want = jax.grad(lambda f: jnp.mean((jgram_matrix(f) - target) ** 2))(jnp.asarray(feat))
    x = torch.from_numpy(feat).requires_grad_()
    torch.mean((gram_matrix(x) - torch.from_numpy(target)) ** 2).backward()
    _close(x.grad.numpy(), want, 1e-5)


def _jax_forward(params, content, style, alpha, kind):
    return JStyleNet(style_loss_kind=kind).apply({"params": params}, content, style, alpha)


def _port(params, kind):
    return weights.load_style_net(StyleNet(kind), params)


@pytest.mark.parametrize("kind,alpha", [("gram", 1.0), ("meanstd", 1.0), ("meanstd", 0.7)])
def test_style_net_forward_matches_jax(params, kind, alpha):
    content, style = _images()
    loss_c, loss_s, g_t = _jax_forward(params, content, style, alpha, kind)
    with torch.no_grad():
        got_c, got_s, got_g = _port(params, kind)(_nchw(content), _nchw(style), alpha)
    assert got_c.shape == got_s.shape == ()
    np.testing.assert_allclose(float(got_c), float(loss_c), rtol=1e-4)
    np.testing.assert_allclose(float(got_s), float(loss_s), rtol=1e-4)
    _close(_nhwc(got_g), g_t, 1e-4)


@pytest.mark.parametrize("kind", ["gram", "meanstd"])
def test_style_net_backward_matches_jax(params, kind):
    """The decoder's gradients of ``loss_c + loss_s`` against ``jax.grad``
    of JAX's ``StyleNet.apply`` and against the port's float64 run (the
    gram kind through ``gram_matrix``'s own backward)."""
    content, style = _images(seed=6)

    def total(dec):
        loss_c, loss_s, _ = _jax_forward(dict(params, decoder=dec), content, style, 1.0, kind)
        return loss_c + loss_s

    want = weights.decoder_state_dict(jax.device_get(jax.grad(total)(params["decoder"])))
    grads = []
    for dtype in (torch.float32, torch.float64):
        net = _port(params, kind).to(dtype)
        net.encoder.requires_grad_(False)
        loss_c, loss_s, _ = net(_nchw(content).to(dtype), _nchw(style).to(dtype))
        (loss_c + loss_s).backward()
        assert all(p.grad is None for p in net.encoder.parameters())
        grads.append({k: p.grad.double().numpy() for k, p in net.decoder.named_parameters()})
    got, exact = grads
    assert list(got) == list(want)
    for k in want:
        _close(got[k], exact[k], 1e-5)
        _close(got[k], want[k], 1e-3)


def test_encoder_taps_match_jax(params):
    """``encode_with_intermediate``: relu1_1..relu4_1 on an odd size
    (33 x 47, the ceil-mode pools' uneven edges)."""
    x = np.random.RandomState(5).rand(1, 33, 47, 3).astype(np.float32)
    want = JStyleNet().apply({"params": params}, jnp.asarray(x),
                             method=JStyleNet.encode_with_intermediate)
    with torch.no_grad():
        got = _port(params, "gram").encode_with_intermediate(_nchw(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _close(_nhwc(g), w, 1e-5)


def test_style_loss_kind_is_checked():
    assert StyleNet().style_loss_kind == "gram"
    assert StyleNet("meanstd").style_loss_kind == "meanstd"
    with pytest.raises(ValueError, match="style_loss_kind"):
        StyleNet("kl")
