"""The port's ``--device-aug`` views and steps against the JAX package's, on
the same canvases and the same draws.

The draws are injected: the JAX functions run on their keys, and the port
gets the values ``jax.random`` gives there (the crop's side and offsets,
the affine parameters after JAX's map and rounding, the jitter factors),
rebuilt from the JAX key tree as ``tests/test_torch_train_step.py`` rebuilds
the occlusion draws. Tolerances:
- integer decisions exact: the crop sides and offsets, the nearest warp's
  indices given the same coefficients (bit-equal images), the targets'
  in-bounds weights, and in the steps the occlusion gates and rectangles
  and the kth-value mask;
- the bilinear warp, the keypoints, the crop-and-resize (against
  ``jax.image.scale_and_translate``), the jitter and the blur: 1e-5
  absolute (their values lie in [0, 1] or are pixel coordinates < 100);
- a whole view, normalized (divided by the ImageNet std, so x4.4): 1e-4,
  which holds 1e-5 of the [0, 1] image and XLA's own fusion noise (JAX's
  jitted view builder differs from its eager one by up to 3.6e-5; the
  port's differs from the eager one by under 1e-6). The port computes its
  own warp coefficients from the draws, and torch's cos/tan differ from
  XLA's by an ulp in ~11% of them, which may move a pixel that sits on a
  rounding boundary; so at most 0.1% of a view's values may be off by more;
- the steps: the tolerances of ``tests/test_torch_train_step.py`` (its
  module docstring says why), whose float64 rule for the backward pass
  covers these steps too: the views feed the same models.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_step import _close, _close_norm, _jax_draws, _jax_state, _models, _sd
from uda_poseestimation_tpu import engine as jengine
from uda_poseestimation_tpu.ops import affine as jaffine
from uda_poseestimation_tpu.ops import device_aug as jda
from uda_poseestimation_tpu.parallel import train_step as jts
from uda_poseestimation_torch import engine as tengine
from uda_poseestimation_torch import weights
from uda_poseestimation_torch.ops import affine as taffine
from uda_poseestimation_torch.ops import device_aug as tda
from uda_poseestimation_torch.parallel import train_step as tts

B, K, KV, S, HM = 4, 5, 1, 64, 16
MEAN, STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
CFG_KW = dict(image_size=S, heatmap_size=HM, sigma=2.0)


def _cfgs():
    src = jda.DeviceAugConfig(use_rrc=True, **CFG_KW)
    stu = jda.DeviceAugConfig(use_rrc=False, **CFG_KW)
    tea = jda.DeviceAugConfig(use_rrc=False, rotation=90, scale=(0.8, 1.2), **CFG_KW)
    return src, stu, tea


def _tcfg(cfg):
    return tda.DeviceAugConfig(**{f.name: getattr(cfg, f.name)
                                  for f in jda.dataclasses.fields(cfg)})


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ---------------------------------------------------------------------------
# the JAX key tree's draws
# ---------------------------------------------------------------------------

def _view_draws_one(key, cfg, canvas):
    """One sample's draws from its ``augment_view`` key."""
    k_rrc, k_aff, k_col = jax.random.split(key, 3)
    out = {}
    if cfg.use_rrc:
        out["i"], out["j"], out["side"] = jda._rrc_params(k_rrc, cfg, canvas)
    angle, shx, _shy, tx, ty, scale = jda._affine_params(k_aff, cfg, cfg.image_size)
    out.update(angle=angle, shear_x=shx, trans_x=tx, trans_y=ty, scale=scale)
    if cfg.color > 0:
        lo, hi = max(0.0, 1.0 - cfg.color), 1.0 + cfg.color
        for name, k in zip(("fb", "fc", "fs"), jax.random.split(k_col, 3)):
            out[name] = jax.random.uniform(k, minval=lo, maxval=hi)
    if cfg.blur > 0:
        out["sigma"] = jax.random.uniform(jax.random.fold_in(k_col, 1), minval=0.0,
                                          maxval=cfg.blur)
    return out


def _view_draws_jax(rng, cfg, n_views, b, canvas):
    keys = jax.random.split(rng, n_views * b).reshape(n_views, b, -1)
    return jax.vmap(jax.vmap(lambda k: _view_draws_one(k, cfg, canvas)))(keys)


def _torch_tree(tree):
    return jax.tree_util.tree_map(_t, jax.device_get(tree))


def _view_draws(rng, cfg, n_views, b, canvas):
    """``augment_batch``'s draws, each (n_views, b)."""
    return _torch_tree(jax.jit(_view_draws_jax, static_argnums=(1, 2, 3, 4))(
        rng, cfg, n_views, b, canvas))


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _builder_draws_jax(rng, cfgs, b, canvas):
    src, stu, tea = cfgs
    r_s, r_t = jax.random.split(rng)
    r_base, r_stu, r_tea = jax.random.split(r_t, 3)
    i, j, side = jax.vmap(lambda k: jda._rrc_params(k, src, canvas))(
        jax.random.split(r_base, b))
    return {"source": _view_draws_jax(r_s, src, 1, b, canvas),
            "target": {"base": {"i": i, "j": j, "side": side},
                       "student": _view_draws_jax(r_stu, stu, 1, b, canvas),
                       "teacher": _view_draws_jax(r_tea, tea, KV, b, canvas)}}


def _builder_draws(rng, cfgs, b, canvas):
    """``view_builder``'s (and the pretrain builder's) draws: the source
    view's from the key's first half; from its second, ``prep_target``'s:
    the base crop's (``rrc_batch``), the student's and the teachers'."""
    return _torch_tree(_builder_draws_jax(rng, cfgs, b, canvas))


def _raw_batch(seed, canvas=S):
    rng = np.random.RandomState(seed)
    vis_s = (rng.rand(B, K) > 0.2).astype(np.float32)
    return {"canvas_s": rng.randint(0, 256, (B, canvas, canvas, 3)).astype(np.uint8),
            "kp_s": rng.uniform(2, canvas - 2, (B, K, 2)).astype(np.float32),
            "vis_s": vis_s,
            "canvas_t": rng.randint(0, 256, (B, canvas, canvas, 3)).astype(np.uint8),
            "kp_t": rng.uniform(2, canvas - 2, (B, K, 2)).astype(np.float32),
            "vis_t": np.ones((B, K), np.float32)}


def _mostly_close(got, want, what, atol=1e-4, share=1e-3):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    off = np.abs(got - want) > atol
    assert off.mean() <= share, f"{what}: {off.mean():.2e} of the values off by > {atol}"


# ---------------------------------------------------------------------------
# ops/affine.py
# ---------------------------------------------------------------------------

def _coeffs(seed, n):
    rng = np.random.RandomState(seed)
    return np.array(jaffine.inverse_affine_coeffs(
        rng.uniform(-180, 180, n).astype(np.float32),
        np.round(rng.uniform(-4, 4, n)).astype(np.float32),
        np.round(rng.uniform(-4, 4, n)).astype(np.float32),
        rng.uniform(-30, 30, n).astype(np.float32), np.zeros(n, np.float32),
        rng.uniform(0.6, 1.3, n).astype(np.float32)), np.float32)


def test_warp_affine_matches_jax():
    """Nearest bit-equal (its indices are the JAX ones), also on a
    channels_last input and on half-pixel ties; bilinear within 1e-5."""
    rng = np.random.RandomState(0)
    imgs = rng.rand(6, 3, 24, 24).astype(np.float32)
    coeffs = _coeffs(1, 6)
    coeffs[0] = [1.0, 0.0, 0.5, 0.0, 1.0, -0.5]  # a shift by half a pixel: ties
    for mode in ("nearest", "bilinear"):
        want = np.asarray(jaffine.warp_affine(jnp.asarray(imgs), jnp.asarray(coeffs), mode))
        for x in (torch.from_numpy(imgs),
                  torch.from_numpy(imgs).contiguous(memory_format=torch.channels_last)):
            got = taffine.warp_affine(x, torch.from_numpy(coeffs), mode).numpy()
            if mode == "nearest":
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="mode"):
        taffine.warp_affine(torch.from_numpy(imgs), torch.from_numpy(coeffs), "cubic")


def test_affine_keypoints_match_jax():
    rng = np.random.RandomState(2)
    kp = rng.uniform(0, 64, (8, K, 2)).astype(np.float32)
    params = [rng.uniform(-180, 180, 8), rng.uniform(-30, 30, 8), rng.uniform(-10, 10, 8),
              np.round(rng.uniform(-4, 4, 8)), np.round(rng.uniform(-4, 4, 8)),
              rng.uniform(0.6, 1.3, 8)]
    params = [p.astype(np.float32) for p in params]
    want = np.stack([np.asarray(jaffine.affine_keypoints(kp[n], *(p[n] for p in params),
                                                         (64, 48))) for n in range(8)])
    got = taffine.affine_keypoints(torch.from_numpy(kp), *map(torch.from_numpy, params),
                                   (64, 48)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# ops/device_aug.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("canvas,resize_scale", [(64, (0.6, 1.3)), (37, (0.1, 1.5)),
                                                 (16, (1.2, 1.6))])
def test_rrc_params_exact(canvas, resize_scale):
    """The port's crop decisions from the JAX uniforms of 64 keys, exactly;
    the last case has no valid attempt for most keys (the whole canvas)."""
    cfg = jda.DeviceAugConfig(resize_scale=resize_scale)
    keys = jax.random.split(jax.random.PRNGKey(canvas), 64)
    want = [np.asarray(v) for v in jax.vmap(lambda k: jda._rrc_params(k, cfg, canvas))(keys)]

    def uniforms(k):
        k_u, k_i, k_j = jax.random.split(k, 3)
        return (jax.random.uniform(k_u, (10,), minval=resize_scale[0], maxval=resize_scale[1]),
                jax.random.uniform(k_i), jax.random.uniform(k_j))

    us, ui, uj = (_t(v) for v in jax.vmap(uniforms)(keys))
    got = [v.numpy() for v in tda.rrc_params(us, ui, uj, canvas)]
    for g, w, name in zip(got, want, ("i", "j", "side")):
        np.testing.assert_array_equal(g, w, err_msg=name)
    full = want[2] == canvas
    if resize_scale[0] > 1:
        assert full.mean() > 0.5
    else:
        assert 0 < (~full).mean()


@pytest.mark.parametrize("i,j,side,out", [
    (0, 0, 24, 24),   # identity
    (5, 3, 11, 24),   # upscale
    (2, 1, 20, 9),    # downscale: the kernel widens
    (0, 0, 12, 16),   # touches the top and left borders
    (12, 12, 12, 16),  # touches the bottom and right borders
    (0, 12, 12, 20), (12, 0, 12, 20),
])
def test_rrc_image_matches_scale_and_translate(i, j, side, out):
    img = np.random.RandomState(side).rand(24, 24, 3).astype(np.float32)
    want = np.asarray(jda._rrc_image(jnp.asarray(img), jnp.float32(i), jnp.float32(j),
                                     jnp.float32(side), out))
    got = tda.rrc_image(torch.from_numpy(img)[None], _t([i]), _t([j]), _t([side]), out)
    assert got.is_contiguous()
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=1e-5)


def test_color_jitter_matches_jax():
    rng = np.random.RandomState(3)
    imgs = rng.rand(3, 16, 16, 3).astype(np.float32)
    want, factors = [], []
    for n in range(3):
        key = jax.random.PRNGKey(10 + n)
        want.append(np.asarray(jda._color_jitter(key, jnp.asarray(imgs[n]), 0.5)))
        factors.append([jax.random.uniform(k, minval=0.5, maxval=1.5)
                        for k in jax.random.split(key, 3)])
    fb, fc, fs = _t(factors).unbind(-1)
    got = tda.color_jitter(torch.from_numpy(imgs), fb, fc, fs).numpy()
    np.testing.assert_allclose(got, np.stack(want), rtol=0, atol=1e-5)


def test_gaussian_blur_matches_jax():
    """Per-sample sigmas, one of them 0 and one below the 1e-4 cut: the
    identity there."""
    rng = np.random.RandomState(4)
    imgs = rng.rand(4, 15, 17, 3).astype(np.float32)
    sigmas = np.array([0.0, 5e-5, 0.8, 1.9], np.float32)
    want = np.stack([np.asarray(jda.gaussian_blur(jnp.asarray(imgs[n]), sigmas[n], 2.0))
                     for n in range(4)])
    got = tda.gaussian_blur(torch.from_numpy(imgs), torch.from_numpy(sigmas), 2.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[:2], imgs[:2])


def test_augment_batch_two_views_match_jax():
    """Two views of each sample with crops, jitter, blur and
    normalization: images, keypoints, aug_param, targets and their weights."""
    cfg = jda.DeviceAugConfig(use_rrc=True, blur=1.0, **CFG_KW)
    raw = _raw_batch(5, canvas=48)
    canvas = raw["canvas_s"].astype(np.float32) / 255.0
    key = jax.random.PRNGKey(7)
    want = jax.device_get(jax.jit(lambda k, c, kp, v: jda.augment_batch(
        k, c, kp, v, cfg, n_views=2, mean=MEAN, std=STD))(key, canvas, raw["kp_s"],
                                                          raw["vis_s"]))
    draws = _view_draws(key, cfg, 2, B, 48)
    got = tda.augment_views(torch.from_numpy(canvas), torch.from_numpy(raw["kp_s"]),
                            torch.from_numpy(raw["vis_s"]), _tcfg(cfg), draws, MEAN, STD)
    assert got["image"].shape == (2, B, S, S, 3) and got["image"].is_contiguous()
    _mostly_close(got["image"].numpy(), want["image"], "image")
    for name in ("keypoint2d", "aug_param"):
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=0, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_array_equal(got["target_weight"].numpy(), want["target_weight"])
    assert 0 < want["target_weight"].sum() < want["target_weight"].size
    _close(got["target"].numpy(), want["target"], 1e-5, "target")


def test_draws_follow_the_jax_mapping():
    """``draw_view``'s values lie where JAX's do: the ranges, the rounded
    translations, a crop that fits; the same generator state gives the same
    draws."""
    cfg = tda.DeviceAugConfig(image_size=32, color=0.3, blur=1.5)
    g = torch.Generator().manual_seed(3)
    d = tda.draw_view(cfg, (2, 500), 40, generator=g)
    assert set(d) == {"i", "j", "side", "angle", "shear_x", "trans_x", "trans_y", "scale",
                      "fb", "fc", "fs", "sigma"}
    assert all(v.shape == (2, 500) for v in d.values())
    assert bool((d["side"] <= 40).all() and (d["i"] + d["side"] <= 40).all()
                and (d["j"] + d["side"] <= 40).all())
    assert bool((d["trans_x"] == torch.round(d["trans_x"])).all()
                and d["trans_x"].abs().max() <= round(0.05 * 32))
    assert bool((d["angle"].abs() <= 180).all() and (d["fb"] >= 0.7).all()
                and (d["fb"] < 1.3).all() and (d["sigma"] < 1.5).all())
    g.manual_seed(3)
    again = tda.draw_view(cfg, (2, 500), 40, generator=g)
    assert all(torch.equal(again[k], v) for k, v in d.items())


# ---------------------------------------------------------------------------
# engine.DeviceAugPipeline
# ---------------------------------------------------------------------------

def _pipelines():
    cfgs = _cfgs()
    jpipe = jengine.DeviceAugPipeline(*cfgs, k=KV, mean=MEAN, std=STD)
    tpipe = tengine.DeviceAugPipeline(*map(_tcfg, cfgs), k=KV, mean=MEAN, std=STD,
                                      device="cpu")
    return cfgs, jpipe, tpipe


def test_view_builder_matches_jax(device_aug_adapt_run):
    """The adapt step's views from the step's key (its view half), built
    outside the step in both packages."""
    cfgs, _, tpipe = _pipelines()
    run = device_aug_adapt_run
    key, want = run["r_views"], run["jviews"]
    draws = _builder_draws(key, cfgs, B, S)
    got = tpipe.view_builder({k: torch.from_numpy(v) for k, v in run["raw"].items()},
                             draws=draws)
    assert sorted(got) == sorted(want)
    for name in ("image_s", "image_t_stu", "images_t_tea"):
        assert got[name].is_contiguous(), name
        _mostly_close(got[name].numpy(), want[name], name)
    for name in ("aug_param_stu", "aug_params_tea"):
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["weight_s"].numpy(), want["weight_s"])
    _close(got["target_s"].numpy(), want["target_s"], 1e-5, "target_s")
    # the crop decisions the port used are JAX's own (integers, exact)
    jkeys = jax.random.split(jax.random.split(jax.random.split(key)[1], 3)[0], B)
    side = jax.vmap(lambda k: jda._rrc_params(k, cfgs[0], S)[2])(jkeys)
    np.testing.assert_array_equal(draws["target"]["base"]["side"].numpy(), np.asarray(side))


PRETRAIN_KEY = jax.random.PRNGKey(22)


@pytest.fixture(scope="module")
def pretrain_views():
    """The JAX pretrain builder's views of one raw batch with s2t fired and
    not (one compile); the same as the unbundled JAX loop's ``prep_source``
    and ``prep_target`` on the key's two halves."""
    _, jpipe, _ = _pipelines()
    raw = _raw_batch(14)
    jbuild = jax.jit(jpipe.pretrain_view_builder(True))
    return raw, {do_s2t: jax.device_get(jbuild(raw, PRETRAIN_KEY, jnp.bool_(do_s2t)))
                 for do_s2t in (True, False)}


def test_pretrain_view_builder_matches_jax(pretrain_views):
    """The source views, and the style image only when s2t fires."""
    cfgs, _, tpipe = _pipelines()
    raw, wants = pretrain_views
    traw = {k: torch.from_numpy(v) for k, v in raw.items()}
    draws = _builder_draws(PRETRAIN_KEY, cfgs, B, S)
    tbuild = tpipe.pretrain_view_builder(True)
    for do_s2t in (True, False):
        want = wants[do_s2t]
        got = tbuild(traw, do_s2t, draws=draws)
        _mostly_close(got["image_s"].numpy(), want["image_s"], "image_s")
        np.testing.assert_array_equal(got["weight_s"].numpy(), want["weight_s"])
        if do_s2t:
            _mostly_close(got["image_t_style"].numpy(), want["image_t_style"], "style")
        else:
            assert "image_t_style" not in got
            assert not want["image_t_style"].any()
    assert "image_t_style" not in tpipe.pretrain_view_builder(False)(traw, True, draws=draws)


def test_uint8_transport_is_the_f32_canvas():
    """A canvas on the uint8 grid packs to uint8 (a uint8 one passes as it
    is), and the division on the device gives the float32 canvas within one
    ulp; a canvas off the grid ships as float32. A mixed bundle decodes its
    uint8 leaves (JAX ``_stack_host_leaves``)."""
    _, jpipe, tpipe = _pipelines()
    u8 = np.random.RandomState(9).randint(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    f32 = u8.astype(np.float32) / 255.0
    packed = tpipe._pack_canvas(torch.from_numpy(f32))
    assert packed.dtype == torch.uint8 and torch.equal(packed, torch.from_numpy(u8))
    assert jpipe._pack_canvas(f32).dtype == np.uint8
    assert tpipe._pack_canvas(torch.from_numpy(u8)).dtype == torch.uint8
    off = tpipe._pack_canvas(torch.from_numpy(f32 + 7e-4))
    assert off.dtype == torch.float32
    dev = tpipe.dev_canvas(packed).numpy()
    ulp = np.spacing(np.maximum(f32, np.float32(1e-30)))
    assert np.all(np.abs(dev - f32) <= ulp)
    mixed = tengine._stack_host_leaves([{"c": packed}, {"c": off}])
    jmixed = jengine._stack_host_leaves(u8, np.asarray(off))
    assert all(b["c"].dtype == torch.float32 for b in mixed)
    np.testing.assert_allclose(np.stack([b["c"].numpy() for b in mixed]), jmixed,
                               rtol=0, atol=1e-7)
    same = tengine._stack_host_leaves([{"c": packed}, {"c": packed}])
    assert all(b["c"].dtype == torch.uint8 for b in same)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

LR = 0.01
STEP_CFG = dict(image_size=S, heatmap_size=HM, sigma=2.0, k=KV, use_sgd=True,
                occlude_rate=0.5, occlude_thresh=-1.0, occlude_size=6, aux_outputs=True)
GATES = dict(do_s2t=True, alpha_s2t=0.7, do_t2s=True, alpha_t2s=0.3)
KEY = jax.random.PRNGKey(21)


@pytest.fixture(scope="module")
def models():
    """``_models()`` once for the module (JAX's eager init is slow on the
    CPU); a test deep-copies the torch model it steps."""
    return _models()


@pytest.fixture(scope="module")
def device_aug_adapt_run(models):
    """One ``--device-aug`` adapt step in each package (the JAX step
    compiled once for the module's tests)."""
    jmodel, variables, jstyle, style_params, tmodel, tstyle = models
    tmodel = copy.deepcopy(tmodel)
    cfgs, jpipe, tpipe = _pipelines()
    raw = _raw_batch(13)
    jcfg = jts.StepConfig(**STEP_CFG)
    jstep = jts.make_adapt_step(jmodel, jcfg, style_model=jstyle,
                                view_builder=jpipe.view_builder)
    jstate, jmetrics, jy = jax.device_get(jstep(
        _jax_state(variables, jcfg), style_params, raw, jnp.float32(LR), KEY,
        *(jnp.asarray(GATES[n]) for n in ("do_s2t", "alpha_s2t", "do_t2s", "alpha_t2s"))))
    rng, r_views = jax.random.split(KEY)
    # the JAX step's views, rebuilt from the same key
    jviews = jax.device_get(jax.jit(jpipe.view_builder)(raw, r_views))

    tcfg = tts.StepConfig(**STEP_CFG)
    state = tts.create_state(tmodel, tcfg, seed=None, device="cpu")
    before = _sd(state.student)
    tstep = tts.make_adapt_step(tcfg, style_model=tstyle, device="cpu",
                                view_builder=tpipe.view_builder)
    state, metrics, y = tstep(state, {k: torch.from_numpy(v) for k, v in raw.items()}, LR,
                              **GATES, occlusion_draws=_jax_draws(rng, B, K),
                              view_draws=_builder_draws(r_views, cfgs, B, S))
    return dict(jstate=jstate, jmetrics=jmetrics, jy=jy, jviews=jviews, rng=rng,
                r_views=r_views, raw=raw,
                variables=variables, state=state, metrics=metrics, y=y, before=before,
                jcfg=jcfg)


def test_device_aug_adapt_step_views_and_decisions(device_aug_adapt_run):
    run = device_aug_adapt_run
    aux, jaux = run["metrics"]["aux"], run["jmetrics"]["aux"]
    _close(aux["x_s_styled"].numpy(), jaux["x_s_styled"], 1e-4, "x_s_styled")
    _close(aux["x_t_teas_styled"].numpy(), jaux["x_t_teas_styled"], 1e-4, "x_t_teas_styled")
    for name in ("y_t_tea_recon", "activates", "mask_thresh", "y_t_stu_recon"):
        _close(aux[name].numpy(), jaux[name], 1e-3, name)
    np.testing.assert_array_equal(aux["tea_mask"].numpy(), np.asarray(jaux["tea_mask"]))
    geom = [np.asarray(g) for g in jts._occlusion_geometry(
        run["rng"], jnp.asarray(jaux["y_t_tea_recon"]), run["jcfg"])]
    np.testing.assert_array_equal(aux["occlude"].numpy(), geom[0])
    assert 0 < geom[0].sum() < B
    np.testing.assert_array_equal(aux["occlusion_rect"].numpy(), np.stack(geom[1:], -1))
    _mostly_close(aux["x_t_stu_final"].numpy(), jaux["x_t_stu_final"], "x_t_stu_final")


def test_device_aug_adapt_step_losses_and_update(device_aug_adapt_run):
    run = device_aug_adapt_run
    for name in ("loss_all", "loss_s", "loss_c", "acc_s"):
        _close(run["metrics"][name].numpy(), run["jmetrics"][name], 1e-3, name)
    assert int(run["metrics"]["acc_cnt"]) == int(run["jmetrics"]["acc_cnt"])
    _close(run["y"].numpy(), run["jy"], 1e-3, "y_s")
    grads = run["metrics"]["aux"]["grads"]
    jgrads = weights.pose_resnet_state_dict({"params": run["jmetrics"]["aux"]["grads"]})
    for name, g in jgrads.items():
        _close_norm(grads[name].numpy(), g, 5e-2, name)
    after = _sd(run["state"].student)
    jbefore = weights.pose_resnet_state_dict(run["variables"])
    jafter = weights.pose_resnet_state_dict({"params": run["jstate"].student_params,
                                             "batch_stats": run["jstate"].student_stats})
    for name in jgrads:
        _close_norm(after[name] - run["before"][name], jafter[name] - jbefore[name], 5e-2,
                    name)


def test_device_aug_pretrain_step_matches_jax(models, pretrain_views):
    """A pretrain step with s2t fired: JAX's unbundled loop builds its views
    outside the step (``prep_source``, ``prep_target``: the pretrain
    builder's views) and calls ``make_pretrain_step``; the port's step
    builds them itself (``pretrain_view_builder``)."""
    jmodel, variables, jstyle, style_params, tmodel, tstyle = models
    tmodel = copy.deepcopy(tmodel)
    cfgs, _, tpipe = _pipelines()
    raw, wants = pretrain_views
    key = PRETRAIN_KEY
    jcfg = jts.StepConfig(**STEP_CFG)
    jstate, jmetrics, jy = jax.device_get(jts.make_pretrain_step(jmodel, jcfg, jstyle)(
        _jax_state(variables, jcfg), style_params, wants[True],
        jnp.float32(LR), jnp.bool_(True), jnp.float32(0.6)))

    tcfg = tts.StepConfig(**STEP_CFG)
    state = tts.create_state(tmodel, tcfg, seed=None, device="cpu")
    before = _sd(state.student)
    tstep = tts.make_pretrain_step(tcfg, style_model=tstyle, device="cpu",
                                   view_builder=tpipe.pretrain_view_builder(True))
    state, metrics, y = tstep(state, {k: torch.from_numpy(v) for k, v in raw.items()}, LR,
                              do_s2t=True, alpha=0.6,
                              view_draws=_builder_draws(key, cfgs, B, S))
    _close(y.numpy(), jy, 1e-3, "y_s")
    for name in ("loss_all", "acc_s"):
        _close(metrics[name].numpy(), jmetrics[name], 1e-3, name)
    after = _sd(state.student)
    jbefore = weights.pose_resnet_state_dict(variables)
    jafter = weights.pose_resnet_state_dict({"params": jstate.student_params,
                                             "batch_stats": jstate.student_stats})
    for name in jafter:
        if "running_" in name:
            _close(after[name], jafter[name], 1e-3, name)
        elif not name.endswith("num_batches_tracked"):
            _close_norm(after[name] - before[name], jafter[name] - jbefore[name], 5e-2, name)


def test_adapt_step_draws_views_before_occlusion(models):
    """Without injected draws the adapt step draws its views from its own
    generator, before anything else draws from it; the occlusion draws
    follow."""
    _, _, tpipe = _pipelines()
    seen = []

    def builder(raw, generator=None, draws=None):
        seen.append(generator.get_state())
        return tpipe.view_builder(raw, generator=generator, draws=draws)

    tcfg = tts.StepConfig(**STEP_CFG)
    state = tts.create_state(copy.deepcopy(models[4]), tcfg, seed=None, device="cpu")
    raw = {k: torch.from_numpy(v) for k, v in _raw_batch(15).items()}
    g = torch.Generator().manual_seed(5)
    fresh = g.get_state()
    step = tts.make_adapt_step(tcfg, device="cpu", view_builder=builder)
    _, metrics, _ = step(state, raw, LR, generator=g)
    assert torch.equal(seen[0], fresh)
    # replaying the views' draws leaves the generator where the occlusion
    # draws started: they give the step's rectangles
    g2 = torch.Generator().manual_seed(5)
    tpipe.view_builder(raw, generator=g2)
    draws = tts.draw_occlusion(B, K, "cpu", g2)
    rect = tts._occlusion_geometry(metrics["aux"]["y_t_tea_recon"], tcfg, draws)
    np.testing.assert_array_equal(metrics["aux"]["occlusion_rect"].numpy(),
                                  torch.stack(rect[1:], -1).numpy())
    assert torch.equal(g.get_state(), g2.get_state())
