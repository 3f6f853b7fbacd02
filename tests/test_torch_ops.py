"""The port's ops against the JAX package on the same numpy inputs.

Tolerances: index maps, argmax decodes and masks are integer decisions and
must be bit-equal. Float results that both frameworks compute with the same
operation order are held to float32 rounding (1e-6); transcendental
functions (cos/tan/exp) may differ by an ulp between XLA and ATen, so the
coefficient and Gaussian checks allow 1e-6 and the rotated index-map checks
feed both sides the JAX coefficients, as the port's step feeds its own.
"""

import ast
import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uda_poseestimation_tpu.models import ema as jema
from uda_poseestimation_tpu.models import loss as jloss
from uda_poseestimation_tpu.ops import affine as jaff
from uda_poseestimation_tpu.ops import heatmap as jhm
from uda_poseestimation_tpu.ops import pck as jpck
from uda_poseestimation_torch.models import ema as tema
from uda_poseestimation_torch.models import loss as tloss
from uda_poseestimation_torch.ops import affine as taff
from uda_poseestimation_torch.ops import heatmap as thm
from uda_poseestimation_torch.ops import pck as tpck

# the packages' ops/__init__ export the function ``adain`` under the module's name
jadain = importlib.import_module("uda_poseestimation_tpu.ops.adain")
tadain = importlib.import_module("uda_poseestimation_torch.ops.adain")

REPO = pathlib.Path(__file__).resolve().parents[1]


def _t(x):
    return torch.from_numpy(np.array(x))


def _aug(rng, b, rotated=True):
    """(B, 6) aug params; rotated=False gives the tie-provoking set: zero
    angle and shear, integer translations, scale 0.5 or 2."""
    if rotated:
        return np.stack([rng.uniform(-60, 60, b), np.round(rng.uniform(-12, 12, b)),
                         np.round(rng.uniform(-12, 12, b)), rng.uniform(-30, 30, b),
                         rng.uniform(-30, 30, b), rng.uniform(0.6, 1.3, b)],
                        -1).astype(np.float32)
    return np.stack([np.zeros(b), np.round(rng.uniform(-8, 8, b)),
                     np.round(rng.uniform(-8, 8, b)), np.zeros(b), np.zeros(b),
                     rng.choice([0.5, 2.0], b)], -1).astype(np.float32)


def test_affine_coefficients_match():
    rng = np.random.RandomState(0)
    aug = _aug(rng, 16)
    args = [aug[:, i] for i in range(6)]
    # coefficients reach |m2| ~ 30: compare at float32 resolution
    np.testing.assert_allclose(
        taff.inverse_affine_coeffs(*map(_t, args)).numpy(),
        np.asarray(jaff.inverse_affine_coeffs(*args)), rtol=1e-6, atol=1e-6)
    for tc, jc in zip(taff.chain_coeffs(*map(_t, args)), jaff.chain_coeffs(*args)):
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    for tc, jc in zip(taff.rss_coeffs(*map(_t, (args[0], args[3], args[4]))),
                      jaff.rss_coeffs(args[0], args[3], args[4])):
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    a = rng.randn(16, 6).astype(np.float32)
    b = rng.randn(16, 6).astype(np.float32)
    np.testing.assert_allclose(taff.compose_inverse_coeffs(_t(a), _t(b)).numpy(),
                               np.asarray(jaff.compose_inverse_coeffs(a, b)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size", [16, 64])
def test_nearest_index_maps_bit_exact(size):
    """Given equal coefficients, the composed index maps are bit-equal."""
    rng = np.random.RandomState(size)
    aug = _aug(rng, 6)
    coeffs = [np.asarray(c) for c in jaff.chain_coeffs(*[aug[:, i] for i in range(6)])]
    ys, xs = jaff._grid(size, size)
    valid = jnp.ones((size, size), bool)
    jx, jy, jv = jax.vmap(lambda c1, c2, c3: jaff.compose_nearest_indices(
        [c1, c2, c3], xs, ys, valid, size, size))(*coeffs)
    tys, txs = taff._grid(size, size)
    b = aug.shape[0]
    tx, ty, tv = taff.compose_nearest_indices(
        [_t(c) for c in coeffs], txs.expand(b, size, size), tys.expand(b, size, size),
        torch.ones((b, size, size), dtype=torch.bool), size, size)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert 0 < tv.sum() < tv.numel()  # both in- and out-of-bounds samples


def test_chain_gather_rotated_bit_exact():
    rng = np.random.RandomState(1)
    hm = rng.rand(4, 5, 32, 32).astype(np.float32)
    aug = _aug(rng, 4)
    coeffs = [np.asarray(c) for c in jaff.chain_coeffs(*[aug[:, i] for i in range(6)])]
    want = np.asarray(jaff._chain_gather_nearest(jnp.asarray(hm), coeffs))
    got = taff._chain_gather_nearest(_t(hm), [_t(c) for c in coeffs]).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ratio", [1.0, 4.0])
def test_inverse_warp_heatmaps_ties_bit_exact(ratio):
    """Tie-provoking parameters (exact .5 coordinates everywhere) through the
    whole inverse warp, coefficients computed by each side itself."""
    rng = np.random.RandomState(2)
    hm = rng.rand(6, 5, 16, 16).astype(np.float32)
    aug = _aug(rng, 6, rotated=False)
    want = np.asarray(jaff.inverse_warp_heatmaps(jnp.asarray(hm), jnp.asarray(aug), ratio))
    got = taff.inverse_warp_heatmaps(_t(hm), _t(aug), ratio).numpy()
    np.testing.assert_array_equal(got, want)


def test_inverse_warp_heatmaps_rotated():
    """Rotated parameters: coefficients may differ by an ulp (cos/tan), which
    can move a pixel that sits on a rounding boundary; all but a handful of
    pixels must be bit-equal."""
    rng = np.random.RandomState(3)
    hm = rng.rand(4, 5, 16, 16).astype(np.float32)
    aug = _aug(rng, 4)
    want = np.asarray(jaff.inverse_warp_heatmaps(jnp.asarray(hm), jnp.asarray(aug), 4.0))
    got = taff.inverse_warp_heatmaps(_t(hm), _t(aug), 4.0).numpy()
    assert (got != want).mean() < 1e-3


def test_get_max_preds_and_rectify():
    rng = np.random.RandomState(4)
    hm = rng.rand(3, 6, 16, 16).astype(np.float32) - 0.3
    hm[0, 0] = -1.0  # maxval <= 0: masked to (0, 0)
    hm[1, 1] = 0.5   # all-equal channel: first maximum
    jp, jm = jhm.get_max_preds(jnp.asarray(hm))
    tp, tm = thm.get_max_preds(_t(hm))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    for sigma in (2.0, 1.0, 1.5):  # 1.5 exercises the fractional-window quirk
        np.testing.assert_allclose(thm.rectify(_t(hm), sigma).numpy(),
                                   np.asarray(jhm.rectify(jnp.asarray(hm), sigma)),
                                   rtol=1e-6, atol=1e-7)


def test_generate_target_batch():
    rng = np.random.RandomState(5)
    kp = rng.uniform(-10, 74, size=(4, 7, 2)).astype(np.float32)  # some off-map
    vis = (rng.rand(4, 7) > 0.2).astype(np.float32)
    jt, jw = jhm.generate_target_batch(kp, vis, (16, 16), 2.0, (64, 64))
    tt, tw = thm.generate_target_batch(kp, vis, (16, 16), 2.0, (64, 64))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6, atol=1e-7)
    st, sw = thm.generate_target(kp[0], vis[0], (16, 16), 2.0, (64, 64))
    np.testing.assert_array_equal(st.numpy(), tt[0].numpy())
    np.testing.assert_array_equal(sw.numpy(), tw[0].numpy())


def test_keypoint_pck_accuracy():
    rng = np.random.RandomState(6)
    kp = rng.uniform(0, 64, size=(8, 5, 2)).astype(np.float32)
    target, _ = jhm.generate_target_batch(kp, np.ones((8, 5), np.float32),
                                          (16, 16), 2.0, (64, 64))
    target = np.array(target)
    out = target + 0.3 * rng.rand(*target.shape).astype(np.float32)
    out[:, 2] = -1.0  # a keypoint whose predictions all decode to (0, 0)
    target[:, 4] = 0.0  # a keypoint with no valid ground truth: -1
    j = jpck.keypoint_pck_accuracy(jnp.asarray(out), jnp.asarray(target))
    t = tpck.keypoint_pck_accuracy(_t(out), _t(target))
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    assert float(t[1]) == pytest.approx(float(j[1]), abs=1e-7)
    assert int(t[2]) == int(j[2])
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))


def test_adain_matches():
    rng = np.random.RandomState(7)
    content = rng.randn(3, 8, 6, 5).astype(np.float32)
    style = (2.0 * rng.randn(3, 8, 6, 5) + 1.0).astype(np.float32)
    jm, js = jadain.calc_mean_std(jnp.asarray(content))
    tm, ts = tadain.calc_mean_std(_t(content))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    # unbiased variance: the std of a 2-sample channel is |a-b|/sqrt(2)
    two = torch.tensor([[[[1.0, 3.0]]]])
    assert float(tadain.calc_mean_std(two, eps=0.0)[1]) == pytest.approx(np.sqrt(2.0))
    # the normalized content is divided by a std of ~1: float32 rounding x ~10
    np.testing.assert_allclose(
        tadain.adain(_t(content), _t(style)).numpy(),
        np.asarray(jadain.adain(jnp.asarray(content), jnp.asarray(style))),
        rtol=1e-5, atol=1e-5)


def test_losses_match():
    rng = np.random.RandomState(8)
    out = rng.rand(4, 5, 16, 16).astype(np.float32)
    tgt = rng.rand(4, 5, 16, 16).astype(np.float32)
    w = (rng.rand(4, 5) > 0.3).astype(np.float32)
    mask = rng.rand(4, 5) > 0.5
    for red in ("mean", "none"):
        np.testing.assert_allclose(
            tloss.joints_mse_loss(_t(out), _t(tgt), _t(w), red).numpy(),
            np.asarray(jloss.joints_mse_loss(jnp.asarray(out), jnp.asarray(tgt),
                                             jnp.asarray(w), red)), rtol=1e-6)
    np.testing.assert_allclose(
        float(tloss.cons_loss(_t(out), _t(tgt), tea_mask=_t(mask))),
        float(jloss.cons_loss(jnp.asarray(out), jnp.asarray(tgt),
                              tea_mask=jnp.asarray(mask))), rtol=1e-6)
    valid = np.array([True, False, True, True])
    np.testing.assert_allclose(
        float(tloss.cons_loss(_t(out), _t(tgt), valid_mask=_t(valid))),
        float(jloss.cons_loss(jnp.asarray(out), jnp.asarray(tgt),
                              valid_mask=jnp.asarray(valid))), rtol=1e-6)


def test_ema_update_parameters_only():
    rng = np.random.RandomState(9)
    student, teacher = torch.nn.BatchNorm1d(4), torch.nn.BatchNorm1d(4)
    with torch.no_grad():
        for m in (student, teacher):
            m.weight.copy_(_t(rng.randn(4).astype(np.float32)))
            m.bias.copy_(_t(rng.randn(4).astype(np.float32)))
            m.running_mean.copy_(_t(rng.randn(4).astype(np.float32)))
    want = jema.ema_update(
        {"w": teacher.weight.detach().numpy().copy(), "b": teacher.bias.detach().numpy().copy()},
        {"w": student.weight.detach().numpy().copy(), "b": student.bias.detach().numpy().copy()},
        0.99)
    stats_before = teacher.running_mean.clone()
    tema.ema_update(teacher, student, 0.99)
    np.testing.assert_allclose(teacher.weight.detach().numpy(), np.asarray(want["w"]),
                               rtol=1e-7, atol=1e-7)
    np.testing.assert_allclose(teacher.bias.detach().numpy(), np.asarray(want["b"]),
                               rtol=1e-7, atol=1e-7)
    assert torch.equal(teacher.running_mean, stats_before)  # buffers untouched


# tqdm and webcolors are not on the card's machine
_FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "uda_poseestimation_tpu", "tools", "tqdm",
              "webcolors"}
_PORT_FILES = sorted(str(p.relative_to(REPO)) for p in
                     (REPO / "uda_poseestimation_torch").rglob("*.py")) + [
                         "chip_smoke.py", "probe_gathers.py"]


@pytest.mark.parametrize("rel", _PORT_FILES)
def test_port_imports_no_jax(rel):
    """No module of the port, and neither chip_smoke.py nor probe_gathers.py,
    imports JAX, Flax, Optax, the JAX package, tools/, tqdm or webcolors (at
    top level or inside a function)."""
    tree = ast.parse((REPO / rel).read_text(), rel)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in _FORBIDDEN, f"{rel}: imports {name}"
