"""The port's ``--device-aug`` for the animal trainers against the JAX
package's, on the same inputs and the same draws.

The draws are injected: the JAX functions run on their keys, and the port
gets the values ``jax.random`` gives there (the affine parameters of the
student and teacher views; the source's gates, order, imgaug parameters,
flip and its normal noise), rebuilt from the JAX key tree as
``tests/test_torch_device_aug.py`` rebuilds the human views'. The sizes are
small: 64x48 frames, 32² crops, 8² heatmaps. Tolerances:

- exact: every integer decision (the MPII transform, the labelmaps'
  visibility bits, the gates, the keypoint2d, the target weights) and the
  source's targets, which are the window rule's exp of the same integers;
  in the step, the occlusion gates and rectangles and the kth-value mask;
- the labelmap alone, 1e-6: ``exp`` and ``pow`` of the two libraries may
  differ by an ulp of values <= 1;
- the imgaug matrix and its inverse, 1e-5: the port's cos/sin and its
  closed-form inverse (no solver: that would sync) against XLA's;
- the student and teacher views, 1e-6, at all but 0.1% of the values: the
  port computes the warp's coefficients from the draws with torch's
  cos/tan, which differ from XLA's by an ulp in some of them and may move
  a pixel that sits on a rounding boundary; ``aug_param`` 1e-6;
- the source image: 1e-5, and at most 0.1% of the values one bytescale
  level (1/255) off: the blur's sums and the stretch's min and max differ
  in float rounding, and ``floor(x + 0.5)`` moves a value by one level
  where they straddle a level. With JAX's own inverse matrix injected, the
  levels are equal: the gather is bit-equal;
- the step: the tolerances of ``tests/test_torch_train_animal.py`` (its
  module docstring), with s2t alone, where the teacher's decisions hold.
"""

import copy
import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_animal import _models
from test_torch_train_step import _close, _jax_draws, _jax_state
from tools.make_fixtures import make_animal
from uda_poseestimation_tpu import engine as jengine
from uda_poseestimation_tpu.data.util import FLIP_PAIRS as JFLIP_PAIRS
from uda_poseestimation_tpu.ops import device_aug as jda
from uda_poseestimation_tpu.parallel import train_step as jts
from uda_poseestimation_torch import data as tdata
from uda_poseestimation_torch import engine as tengine
from uda_poseestimation_torch import train_animal as ttrain
from uda_poseestimation_torch.data.util import FLIP_PAIRS
from uda_poseestimation_torch.ops import device_aug as tda
from uda_poseestimation_torch.parallel import train_step as tts

K, B = 18, 4
FRAME_W, FRAME_H, INP, OUT = 64, 48, 32, 8
MEAN = np.array([0.3999, 0.3909, 0.3871], np.float32)
SRC_MEAN = np.array([0.41, 0.4, 0.38], np.float32)
VIEW_KW = dict(image_size=INP, heatmap_size=OUT, sigma=1.0, rotation=60.0, shear=(-30.0, 30.0),
               translate=(0.05, 0.05), scale=(0.6, 1.3), color=0.0, use_rrc=False)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads (as tests/test_torch_train_animal.py holds them):
    the Tier-1 run puts six test processes on the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _src_cfgs(**kw):
    kw = dict(dict(inp_res=INP, out_res=OUT, sigma=1.0, frame_w=FRAME_W, frame_h=FRAME_H), **kw)
    return jda.AnimalSourceAugConfig(**kw), tda.AnimalSourceAugConfig(**kw)


def _view_cfgs(**kw):
    return jda.DeviceAugConfig(**dict(VIEW_KW, **kw)), tda.DeviceAugConfig(**dict(VIEW_KW, **kw))


def _torch(tree):
    """A JAX tree as torch tensors of the same dtypes."""
    return jax.tree_util.tree_map(lambda v: torch.from_numpy(np.array(v)),
                                  jax.device_get(tree))


# ---------------------------------------------------------------------------
# the JAX key tree's draws
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _view_draws_jax(rng, cfg, n_views, b):
    """``animal_augment_batch``'s affine draws, each (n_views, b)."""
    keys = jax.random.split(rng, n_views * b).reshape(n_views, b, -1)
    names = ("angle", "shear_x", "shear_y", "trans_x", "trans_y", "scale")

    def one(k):
        out = dict(zip(names, jda._affine_params(k, cfg, cfg.image_size)))
        del out["shear_y"]
        return out

    return jax.vmap(jax.vmap(one))(keys)


def _source_params_one(key, cfg):
    params = jda.draw_animal_source_params(key, cfg)
    noise = jax.random.normal(params["noise_key"], (cfg.inp_res, cfg.inp_res, 3))
    return params, noise


@functools.partial(jax.jit, static_argnums=(1, 2))
def _source_params_jax(rng, cfg, b):
    """``animal_source_batch``'s per-sample params and their normal noise."""
    return jax.vmap(lambda k: _source_params_one(k, cfg))(jax.random.split(rng, b))


def _source_draws(params, noise):
    """The port's source draws from JAX's params (the noise key's normals in
    place of the key)."""
    draws = _torch({k: v for k, v in params.items() if k != "noise_key"})
    draws["noise"] = _torch(noise)
    return draws


def _builder_draws(rng, cfg_stu, cfg_tea, k, b, src_cfg):
    """``AnimalDeviceAugPipeline.view_builder``'s draws from its key: the
    student's, the teachers' and the source's, as JAX splits them."""
    r_stu, r_tea, r_src = jax.random.split(rng, 3)
    draws = {"target": {"student": _torch(_view_draws_jax(r_stu, cfg_stu, 1, b)),
                        "teacher": _torch(_view_draws_jax(r_tea, cfg_tea, k, b))}}
    if src_cfg is not None:
        draws["source"] = _source_draws(*_source_params_jax(r_src, src_cfg, b))
    return draws


# ---------------------------------------------------------------------------
# MPII transform, labelmaps, the imgaug matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("res", [8, 64])
def test_mpii_transform_points_exact(res):
    """Negative and out-of-crop coordinates included: truncation toward zero
    and the -1/+1 offsets, exactly."""
    rng = np.random.RandomState(res)
    pts = rng.uniform(-120, 450, (20, 7, 2)).astype(np.float32)
    pts[0, :3] = [[-0.5, -1.5], [0.0, 1.0], [-3.0, 2.9]]
    c = rng.uniform(-20, 350, (20, 2)).astype(np.float32)
    s = rng.uniform(0.2, 2.5, 20).astype(np.float32)
    want = jax.vmap(lambda p, cc, ss: jda.mpii_transform_points(p, cc, ss, res))(pts, c, s)
    got = tda.mpii_transform_points(*map(torch.from_numpy, (pts, c, s)), res)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() < 0).any()


@pytest.mark.parametrize("label_type", ["Gaussian", "Cauchy"])
@pytest.mark.parametrize("sigma", [1.0, 1.5, 2.0, 3.0])
def test_draw_labelmap_matches_jax(sigma, label_type):
    """Points inside, on the borders and outside a 32² map, and windows
    that just fit or just cross an edge: visibility bits exact, maps within
    1e-6."""
    rng = np.random.RandomState(int(sigma * 10))
    edge = int(3 * sigma)  # the last point whose window fits from the left
    border = [[0, 0], [31, 31], [0, 31], [31, 5], [16, 16], [12, 20], [edge, edge],
              [edge - 1, 16], [31 - edge - 1, 16], [31 - edge, 16], [32, 3], [-1, 7]]
    pts = np.concatenate([rng.randint(-5, 37, (40, 2)), border]).astype(np.int32)
    want_map, want_vis = jax.vmap(lambda p: jda.draw_labelmap(p, sigma, 32, label_type))(pts)
    got_map, got_vis = tda.draw_labelmap(torch.from_numpy(pts), sigma, 32, label_type)
    np.testing.assert_array_equal(got_vis.numpy(), np.asarray(want_vis))
    assert 0 < float(want_vis.mean()) < 1
    np.testing.assert_allclose(got_map.numpy(), np.asarray(want_map), rtol=0, atol=1e-6)
    if sigma == 1.5:  # the fractional sigma's shifted peak (pt 4 -> 5)
        qmap, qvis = tda.draw_labelmap(torch.tensor([[4, 8]]), 1.5, 16, label_type)
        assert float(qvis[0]) == 1.0 and int(qmap[0, 8].argmax()) == 5


def test_imgaug_matrix_and_inverse_match_jax():
    rng = np.random.RandomState(7)
    n = 16
    draws = [rng.uniform(0.5, 1.5, n), rng.uniform(0.5, 1.5, n), rng.uniform(-32, 32, n),
             rng.uniform(-24, 24, n), np.deg2rad(rng.uniform(-30, 30, n)),
             np.deg2rad(rng.uniform(-20, 20, n))]
    draws = [d.astype(np.float32) for d in draws]
    want = jax.vmap(lambda *d: jda.imgaug_affine_matrix(160, 120, *d))(*draws)
    got = tda.imgaug_affine_matrix(160, 120, *map(torch.from_numpy, draws))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tda.affine_inverse(got).numpy(),
                               np.asarray(jnp.linalg.inv(want)), rtol=0, atol=1e-5)
    eye = torch.eye(3).expand(2, 3, 3)
    assert torch.equal(tda.affine_inverse(eye), eye)


def test_flip_perm_matches_jax():
    for name, k in (("real_animal", 18), ("animal_pose", 14)):
        assert FLIP_PAIRS[name] == JFLIP_PAIRS[name]
        np.testing.assert_array_equal(tda.flip_perm_from_pairs(FLIP_PAIRS[name], k),
                                      jda.flip_perm_from_pairs(JFLIP_PAIRS[name], k))


# ---------------------------------------------------------------------------
# the mt views
# ---------------------------------------------------------------------------

def _mostly_close(got, want, atol, what, share=1e-3):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    off = np.abs(got - want) > atol
    assert off.mean() <= share, f"{what}: {off.mean():.2e} of the values off by > {atol}"


@pytest.mark.parametrize("label_type", ["Gaussian", "Cauchy"])
def test_animal_views_match_jax(label_type):
    """JAX ``test_animal_augment_batch_shapes``'s inputs: two views of four
    64² crops, 18 keypoints of a larger frame, mean-only normalization."""
    jcfg, tcfg = _view_cfgs(image_size=64, heatmap_size=16)
    rng = np.random.RandomState(1)
    images = rng.rand(4, 64, 64, 3).astype(np.float32)
    kp = rng.uniform(50, 350, (4, K, 2)).astype(np.float32)
    vis = (rng.rand(4, K) > 0.2).astype(np.float32)
    centers = rng.uniform(100, 300, (4, 2)).astype(np.float32)
    scales = rng.uniform(0.8, 2.0, (4,)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    want = jax.device_get(jax.jit(lambda r: jda.animal_augment_batch(
        r, images, kp, vis, centers, scales, jcfg, n_views=2, mean=MEAN,
        label_type=label_type))(key))
    got = tda.animal_views(*map(torch.from_numpy, (images, kp, vis, centers, scales)), tcfg,
                           _torch(_view_draws_jax(key, jcfg, 2, 4)), mean=MEAN,
                           label_type=label_type)
    assert got["image"].shape == (2, 4, 64, 64, 3) and got["image"].is_contiguous()
    _mostly_close(got["image"], want["image"], 1e-6, "image")
    np.testing.assert_allclose(got["aug_param"].numpy(), want["aug_param"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["keypoint2d"].numpy(), want["keypoint2d"], rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(got["target_weight"].numpy(), want["target_weight"])
    assert 0 < want["target_weight"].sum() < want["target_weight"].size
    np.testing.assert_allclose(got["target"].numpy(), want["target"], rtol=0, atol=1e-6)
    no_targets = tda.animal_views(*map(torch.from_numpy, (images, kp, vis, centers, scales)),
                                  tcfg, _torch(_view_draws_jax(key, jcfg, 2, 4)),
                                  targets=False)
    assert set(no_targets) == {"image", "keypoint2d", "aug_param"}


# ---------------------------------------------------------------------------
# the synthetic source
# ---------------------------------------------------------------------------

def _frames(seed, b, k=K):
    """Frames, keypoints (with some outside the frame), their boxes' MPII
    centers and scales."""
    rng = np.random.RandomState(seed)
    canvases = rng.randint(0, 256, (b, FRAME_H, FRAME_W, 3)).astype(np.uint8)
    pts = np.concatenate([rng.uniform(6, 58, (b, k, 1)), rng.uniform(4, 44, (b, k, 1)),
                          np.ones((b, k, 1))], -1).astype(np.float32)
    pts[:, 0, :2] = [[-2.0, 10.0]]  # outside the frame: zeroed
    pts[:, 1, 1] = 0.0  # on the top edge: no target
    lo, hi = pts[:, 2:, :2].min(1), pts[:, 2:, :2].max(1)
    centers = ((lo + hi) / 2).astype(np.float32)
    scales = ((hi - lo).max(1) / 200.0 * 1.25).astype(np.float32)
    return canvases, pts, centers, scales


SOURCE_CASES = {"gaussian": dict(sigma=1.0, label_type="Gaussian"),
                "cauchy_sigma_1.5": dict(sigma=1.5, label_type="Cauchy")}


@pytest.fixture(scope="module", params=sorted(SOURCE_CASES))
def source_run(request):
    """JAX's source views of 32 frames, one compile: the 16 gate
    combinations, each with the flip off and on, each sample with its own
    op order; and JAX's inverse imgaug matrices."""
    jcfg, tcfg = _src_cfgs(**SOURCE_CASES[request.param])
    b = 32
    canvases, pts, centers, scales = _frames(0, b)
    rng = np.random.RandomState(3)
    params, noise = jax.device_get(_source_params_jax(jax.random.PRNGKey(1), jcfg, b))
    params = dict(params)
    params["gates"] = np.array([[(i >> j) & 1 for j in range(4)] for i in range(16)] * 2, bool)
    params["flip"] = np.repeat([False, True], 16)
    params["perm"] = np.stack([rng.permutation(4) for _ in range(b)]).astype(np.int32)
    perm = jda.flip_perm_from_pairs(JFLIP_PAIRS["real_animal"], K)

    @jax.jit
    def run(params, canvases, pts, centers, scales):
        out = jax.vmap(lambda p, c, pt, ce, s: jda.animal_source_apply(
            p, c.astype(jnp.float32), pt, ce, s, jnp.asarray(perm), jcfg, mean=SRC_MEAN))(
            params, canvases, pts, centers, scales)

        def m_inv(p):
            m = jda.imgaug_affine_matrix(FRAME_W, FRAME_H, p["sx"], p["sy"], p["tx"], p["ty"],
                                         p["rot"], p["shear"])
            return jnp.linalg.inv(jnp.where(p["gates"][0], m, jnp.eye(3, dtype=jnp.float32)))

        return out, jax.vmap(m_inv)(params)

    want, m_inv = jax.device_get(run(params, canvases, pts, centers, scales))
    inputs = [torch.from_numpy(a) for a in (canvases, pts, centers, scales)]
    inputs.append(torch.from_numpy(perm.astype(np.int64)))
    return dict(want=want, m_inv=m_inv, inputs=inputs, tcfg=tcfg, run=run,
                draws=_source_draws(params, noise), params=params)


def _levels(image):
    """A normalized source image's bytescale levels (integers 0-255)."""
    return np.round((np.asarray(image) + SRC_MEAN) * 255.0)


@pytest.mark.parametrize("inverse", ["closed_form", "jax"])
def test_animal_source_views_match_jax(source_run, inverse):
    run = source_run
    m_inv = torch.from_numpy(np.array(run["m_inv"])) if inverse == "jax" else None
    got = tda.animal_source_views(*run["inputs"], run["tcfg"], run["draws"], mean=SRC_MEAN,
                                  m_inv=m_inv)
    want = run["want"]
    for name in ("keypoint2d", "target_weight", "target"):
        np.testing.assert_array_equal(got[name].numpy(), want[name], err_msg=name)
    assert 0 < want["target_weight"].sum() < want["target_weight"].size
    # keypoint 0 lies outside the frame: zeroed where no affine moves it
    # and no flip swaps it away
    unmoved = ~run["params"]["gates"][:, 0] & ~run["params"]["flip"]
    assert (want["keypoint2d"][unmoved, 0] == 0).all()
    err = np.abs(got["image"].numpy() - want["image"])
    assert (err > 1e-5).mean() <= 1e-3 and err.max() <= 1.0 / 255 + 1e-5, err.max()
    if inverse == "jax":
        np.testing.assert_array_equal(_levels(got["image"]), _levels(want["image"]))
    # the four ops changed what they gate: each sample differs from the
    # plain crop where one of noise, blur or contrast fired
    plain = tda.animal_source_views(*run["inputs"], run["tcfg"], run["draws"], mean=SRC_MEAN,
                                    is_aug=False)
    changed = (plain["image"] != got["image"]).flatten(1).any(1).numpy()
    fired = run["params"]["gates"][:, 1:].any(1) | run["params"]["gates"][:, 0] \
        | run["params"]["flip"]
    np.testing.assert_array_equal(changed, fired)


def test_animal_source_is_aug_off_matches_jax(source_run):
    """``is_aug=False`` is the plain crop: no imgaug op, no flip (JAX's
    ``is_aug=False`` sets the gates and the flip off); ``std`` divides the
    normalized image."""
    run = source_run
    off = dict(run["params"], gates=np.zeros_like(run["params"]["gates"]),
               flip=np.zeros_like(run["params"]["flip"]))
    want, _ = jax.device_get(run["run"](off, *(t.numpy() for t in run["inputs"][:4])))
    got = tda.animal_source_views(*run["inputs"], run["tcfg"], run["draws"], mean=SRC_MEAN,
                                  is_aug=False)
    for name in ("keypoint2d", "target_weight", "target"):
        np.testing.assert_array_equal(got[name].numpy(), want[name], err_msg=name)
    _mostly_close(got["image"], want["image"], 1e-5, "image", share=0.0)
    scaled = tda.animal_source_views(*run["inputs"], run["tcfg"], run["draws"], mean=SRC_MEAN,
                                     std=SRC_MEAN, is_aug=False)
    np.testing.assert_allclose(scaled["image"].numpy(), got["image"].numpy() / SRC_MEAN,
                               rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def animal_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("animal_device_aug")
    make_animal(str(root))
    return root


@pytest.mark.parametrize("flip", [False, True])
def test_source_keypoints_targets_match_host(animal_tree, monkeypatch, flip):
    """At the identity draw (no imgaug op), with the flip off and on, the
    port's device source gives the keypoint2d, targets and weights of the
    port's host ``Synthetic_Animal_SP_All`` item of the same frame (the host
    flips when ``random.random() <= 0.5``)."""
    monkeypatch.setenv("UDA_CACHED_DATA_DIR", str(animal_tree / "cached_data"))
    kw = dict(animal="all", image_path=str(animal_tree / "animal_data"), inp_res=64,
              out_res=16, sigma=1, scale_factor=0.25, rot_factor=30, label_type="Gaussian")
    host = tdata.synthetic_animal_sp_all(is_train=True, is_aug=False, **kw)
    raw = tdata.synthetic_animal_sp_all(is_train=True, raw_mode=True, **kw)
    monkeypatch.setattr(random, "random", lambda: 0.0 if flip else 1.0)
    items = [host[i] for i in range(len(host))]
    metas = tdata.default_collate([raw[i][3] for i in range(len(raw))])
    _, tcfg = _src_cfgs(inp_res=64, out_res=16, frame_w=640, frame_h=480)
    b = len(items)
    draws = tda.draw_animal_source(tcfg, b, generator=torch.Generator().manual_seed(0))
    draws.update(gates=torch.zeros(b, 4, dtype=torch.bool),
                 flip=torch.full((b,), flip, dtype=torch.bool))
    perm = torch.from_numpy(tda.flip_perm_from_pairs(FLIP_PAIRS["real_animal"], K))
    got = tda.animal_source_views(metas["canvas"], metas["pts"], metas["center"],
                                  metas["scale"], perm, tcfg, draws)
    np.testing.assert_array_equal(got["target"].numpy(), np.stack([it[1] for it in items]))
    np.testing.assert_array_equal(got["target_weight"].numpy(),
                                  np.stack([it[2] for it in items]))
    np.testing.assert_array_equal(got["keypoint2d"].numpy(),
                                  np.stack([it[3]["keypoint2d"][:, :2] for it in items]))
    assert float(got["target_weight"].sum()) > 0


@pytest.mark.parametrize("p", [0.5, 0.3])
def test_source_draws_follow_the_jax_ranges(p):
    """The port's own draws: JAX's ranges, the gate probability ``p`` (as
    JAX's draws give it, within 4 binomial deviations at n = 2000), each
    order a permutation, a standard normal noise; the same generator state
    gives the same draws."""
    jcfg, tcfg = _src_cfgs(inp_res=8, p=p)
    n = 2000
    g = torch.Generator().manual_seed(4)
    d = tda.draw_animal_source(tcfg, n, generator=g)
    jparams, _ = jax.device_get(_source_params_jax(jax.random.PRNGKey(5), jcfg, n))
    tol = 4 * np.sqrt(p * (1 - p) / n)
    for name, prob in (("gates", p), ("noise_pc", 0.5), ("contrast_pc", 0.5), ("flip", 0.5)):
        got, want = float(d[name].float().mean()), float(np.mean(jparams[name]))
        assert abs(got - prob) <= tol and abs(want - prob) <= tol, (name, got, want)
    assert torch.equal(d["perm"].sort(dim=1).values, torch.arange(4).expand(n, 4))
    for name, lo, hi in (("sx", 0.5, 1.5), ("sy", 0.5, 1.5), ("tx", -3.2, 3.2),
                         ("ty", -2.4, 2.4), ("rot", -np.pi / 6, np.pi / 6),
                         ("shear", -np.pi / 9, np.pi / 9), ("cval", 0.0, 255.0),
                         ("blur_sigma", 1.0, 5.0), ("alphas", 0.5, 2.0)):
        v = d[name].numpy()
        assert lo <= v.min() and v.max() < hi + 1e-6, name
        assert lo <= jparams[name].min() and jparams[name].max() < hi + 1e-6, name
        assert v.min() < lo + 0.05 * (hi - lo) and v.max() > hi - 0.05 * (hi - lo), name
    assert torch.equal(d["alpha_shared"], d["alphas"][:, 0])
    assert d["noise"].shape == (n, 8, 8, 3)
    assert abs(float(d["noise"].mean())) < 0.01 and abs(float(d["noise"].std()) - 1) < 0.01
    g.manual_seed(4)
    again = tda.draw_animal_source(tcfg, n, generator=g)
    assert all(torch.equal(again[k], v) for k, v in d.items())


# ---------------------------------------------------------------------------
# engine.AnimalDeviceAugPipeline
# ---------------------------------------------------------------------------

def _pipelines(with_source=True, k=1):
    jstu, tstu = _view_cfgs()
    jtea, ttea = _view_cfgs(rotation=30.0, scale=(0.8, 1.2))
    jsrc, tsrc = _src_cfgs() if with_source else (None, None)
    perm = tda.flip_perm_from_pairs(FLIP_PAIRS["real_animal"], K)
    src = dict(flip_perm=perm, src_mean=SRC_MEAN) if with_source else {}
    jpipe = jengine.AnimalDeviceAugPipeline(jstu, jtea, k=k, mean=MEAN, src_cfg=jsrc, **src)
    tpipe = tengine.AnimalDeviceAugPipeline(tstu, ttea, k=k, mean=MEAN, src_cfg=tsrc,
                                            device="cpu", **src)
    return (jstu, jtea, jsrc), jpipe, tpipe


def _tuples(seed, b=B):
    """A collated source (raw mode) and target (``_mt``, under --device-aug)
    batch as the loaders give them: the raw keys in the metas, the source's
    host leaves (dummies in raw mode, used without src_cfg), the identity
    teacher view."""
    rng = np.random.RandomState(seed)
    canvases, pts, centers, scales = _frames(seed, b)
    src = (torch.from_numpy(rng.rand(b, INP, INP, 3).astype(np.float32)),
           torch.from_numpy(rng.rand(b, K, OUT, OUT).astype(np.float32)),
           torch.from_numpy((rng.rand(b, K, 1) > 0.3).astype(np.float32)),
           {"canvas": torch.from_numpy(canvases), "pts": torch.from_numpy(pts),
            "center": torch.from_numpy(centers), "scale": torch.from_numpy(scales)})
    canvas_t = rng.randint(0, 256, (b, INP, INP, 3)).astype(np.uint8)
    meta_t = {"canvas": torch.from_numpy(canvas_t),
              "kp_orig": torch.from_numpy(rng.uniform(40, 300, (b, K, 2)).astype(np.float32)),
              "vis": torch.from_numpy((rng.rand(b, K) > 0.2).astype(np.float32)),
              "center": torch.from_numpy(rng.uniform(100, 250, (b, 2)).astype(np.float32)),
              # the TigDog set's scale is a Python float: collated to float64
              "scale": torch.from_numpy(rng.uniform(0.8, 1.6, b))}
    tea = [torch.from_numpy(canvas_t.astype(np.float32) / 255.0 - MEAN)]
    return src, (None, None, None, meta_t, tea, None, None, None)


def _numpy(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("with_source", [True, False])
def test_raw_batches_match_jax(with_source):
    """The raw adapt and pretrain batches: JAX's leaves, dtypes and values;
    the source's dense leaves without ``src_cfg``."""
    _, jpipe, tpipe = _pipelines(with_source)
    src, tgt = _tuples(0)
    jsrc = (src[0].numpy(), src[1].numpy(), src[2].numpy(), _numpy(src[3]))
    jtgt = (None, None, None, _numpy(tgt[3]), [tgt[4][0].numpy()])
    want = jpipe.raw_adapt_batch(jsrc, jtgt, device=False)
    got = tpipe.raw_adapt_batch(src, tgt)
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert got[name].dtype == {np.uint8: torch.uint8, np.float32: torch.float32}[
            value.dtype.type], name
        np.testing.assert_array_equal(got[name].numpy(), value, err_msg=name)
    assert ("canvas_s" in got) == with_source and ("image_s" in got) != with_source
    if with_source:
        for fired in (True, False):
            want = jpipe.raw_pretrain_batch(jsrc, jtgt if fired else None)
            got = tpipe.raw_pretrain_batch(src, tgt if fired else None)
            assert sorted(got) == sorted(want)
            for name, value in want.items():
                assert str(got[name].dtype) == f"torch.{value.dtype}", name
                np.testing.assert_array_equal(got[name].numpy(), value, err_msg=name)
        template = tpipe.pretrain_style_template(got)
        assert template == {"image_t_style": ((B, INP, INP, 3), torch.float32)}
        assert template["image_t_style"][0] == jpipe.pretrain_style_template(
            _numpy(got))["image_t_style"][0]
        assert not tpipe.host_visualizable and tpipe.source_on_device
    else:
        with pytest.raises(ValueError, match="src_cfg"):
            tpipe.pretrain_view_builder(True)
        assert not tpipe.source_on_device
    assert tengine.DeviceAugPipeline.host_visualizable


@pytest.mark.parametrize("with_source,k", [(True, 1), (False, 2)])
def test_view_builder_matches_jax(with_source, k):
    """The adapt step's batch from the builder's key: the source views (or
    the dense source passed through), the student view and k teacher
    views."""
    cfgs, jpipe, tpipe = _pipelines(with_source, k)
    src, tgt = _tuples(1)
    raw = tpipe.raw_adapt_batch(src, tgt)
    key = jax.random.PRNGKey(8)
    want = jax.device_get(jax.jit(jpipe.view_builder)(_numpy(raw), key))
    got = tpipe.view_builder(raw, draws=_builder_draws(key, cfgs[0], cfgs[1], k, B, cfgs[2]))
    assert sorted(got) == sorted(want)
    assert got["images_t_tea"].shape == (k, B, INP, INP, 3)
    for name in ("image_t_stu", "images_t_tea"):
        assert got[name].is_contiguous(), name
        _mostly_close(got[name], want[name], 1e-6, name)
    for name in ("aug_param_stu", "aug_params_tea"):
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=0, atol=1e-6)
    for name in ("target_s", "weight_s"):
        np.testing.assert_array_equal(got[name].numpy(), want[name], err_msg=name)
    err = np.abs(got["image_s"].numpy() - want["image_s"])
    assert (err > 1e-5).mean() <= 1e-3 and err.max() <= 1.0 / 255 + 1e-5


def test_view_builder_draws_target_then_source():
    """Without injected draws the builder draws from its generator: the
    student's, the teachers', then the source's."""
    _, _, tpipe = _pipelines()
    raw = tpipe.raw_adapt_batch(*_tuples(2))
    g = torch.Generator().manual_seed(9)
    got = tpipe.view_builder(raw, generator=g)
    g.manual_seed(9)
    draws = {"target": tpipe.draw_target(B, g), "source": tpipe.draw_source(B, g)}
    want = tpipe.view_builder(raw, draws=draws)
    assert all(torch.equal(got[k], want[k]) for k in want)
    again = tpipe.view_builder(raw)  # the pipeline's own generator
    assert again["image_s"].shape == got["image_s"].shape


def test_pretrain_view_builder_matches_jax():
    """The source views from the builder's key; the style image passed
    through as it is when s2t fires, absent when it does not."""
    cfgs, jpipe, tpipe = _pipelines()
    src, tgt = _tuples(3)
    raw = tpipe.raw_pretrain_batch(src, tgt)
    key = jax.random.PRNGKey(11)
    jbuild = jax.jit(jpipe.pretrain_view_builder(True))
    draws = {"source": _source_draws(*_source_params_jax(key, cfgs[2], B))}
    tbuild = tpipe.pretrain_view_builder(True)
    for do_s2t in (True, False):
        want = jax.device_get(jbuild(_numpy(raw), key, jnp.bool_(do_s2t)))
        got = tbuild(raw, do_s2t, draws=draws)
        for name in ("target_s", "weight_s"):
            np.testing.assert_array_equal(got[name].numpy(), want[name], err_msg=name)
        err = np.abs(got["image_s"].numpy() - want["image_s"])
        assert (err > 1e-5).mean() <= 1e-3 and err.max() <= 1.0 / 255 + 1e-5
        if do_s2t:
            assert got["image_t_style"] is raw["image_t_style"]
            np.testing.assert_array_equal(got["image_t_style"].numpy(), want["image_t_style"])
        else:
            assert "image_t_style" not in got
    assert "image_t_style" not in tpipe.pretrain_view_builder(False)(raw, True, draws=draws)
    style = tpipe.style_image(tgt)
    np.testing.assert_array_equal(style.numpy(), np.asarray(jpipe.style_image(
        (None, None, None, None, [tgt[4][0].numpy()]))))


# ---------------------------------------------------------------------------
# the adapt step
# ---------------------------------------------------------------------------

LR = 0.01
STEP_CFG = dict(image_size=INP, heatmap_size=OUT, sigma=1.0, k=1, use_sgd=True,
                occlude_rate=0.5, occlude_thresh=-1.0, occlude_size=3, aux_outputs=True,
                recover_min=ttrain.RECOVER_MIN, recover_max=ttrain.RECOVER_MAX,
                gather_exact=False, style_io_dtype="bfloat16")
# s2t alone: the teacher's views are then the same bf16 roundings of equal
# inputs in both packages (tests/test_torch_train_animal.py, SLICE_GATES)
GATES = dict(do_s2t=True, alpha_s2t=0.7, do_t2s=False, alpha_t2s=0.3)
KEY = jax.random.PRNGKey(21)


def test_device_aug_adapt_step_matches_jax():
    """One animal adapt step with the device builder in each package, on
    ``test_torch_train_animal._models()``: the step's key split into the
    occlusion's and the views'. The kth-value mask and the occlusion gates
    and rectangles equal; the tensors through the model to 1e-3."""
    jmodel, variables, jstyle, style_params, tmodel, tstyle = _models(jit_init=True)
    cfgs, jpipe, tpipe = _pipelines()
    raw = tpipe.raw_adapt_batch(*_tuples(4))
    jcfg = jts.StepConfig(**STEP_CFG, gather_impl="pallas", pallas_interpret=True)
    jstep = jts.make_adapt_step(jmodel, jcfg, style_model=jstyle,
                                view_builder=jpipe.view_builder)
    _, jmetrics, jy = jax.device_get(jstep(
        _jax_state(variables, jcfg), style_params, _numpy(raw), jnp.float32(LR), KEY,
        *(jnp.asarray(GATES[n]) for n in ("do_s2t", "alpha_s2t", "do_t2s", "alpha_t2s"))))
    rng, r_views = jax.random.split(KEY)

    tcfg = tts.StepConfig(**STEP_CFG)
    state = tts.create_state(copy.deepcopy(tmodel), tcfg, seed=None, device="cpu")
    tstep = tts.make_adapt_step(tcfg, style_model=tstyle, device="cpu",
                                view_builder=tpipe.view_builder)
    _, metrics, y = tstep(state, raw, LR, **GATES, occlusion_draws=_jax_draws(rng, B, K),
                          view_draws=_builder_draws(r_views, *cfgs[:2], 1, B, cfgs[2]))
    aux, jaux = metrics["aux"], jmetrics["aux"]
    np.testing.assert_array_equal(aux["tea_mask"].numpy(), np.asarray(jaux["tea_mask"]))
    assert 0 < aux["tea_mask"].sum() < aux["tea_mask"].numel()
    geom = [np.asarray(g) for g in jts._occlusion_geometry(
        rng, jnp.asarray(jaux["y_t_tea_recon"]), jcfg)]
    np.testing.assert_array_equal(aux["occlude"].numpy(), geom[0])
    assert geom[0].any()
    np.testing.assert_array_equal(aux["occlusion_rect"].numpy(), np.stack(geom[1:], -1))
    for name in ("y_t_tea_recon", "activates", "mask_thresh", "y_t_stu_recon"):
        _close(aux[name].numpy(), jaux[name], 1e-3, name)
    got, want = aux["x_t_stu_final"].numpy(), np.asarray(jaux["x_t_stu_final"])
    assert (np.abs(got - want) > 1e-6).mean() <= 1e-3
    for name in ("loss_all", "loss_s", "loss_c", "acc_s"):
        _close(metrics[name].numpy(), jmetrics[name], 1e-3, name)
    assert int(metrics["acc_cnt"]) == int(jmetrics["acc_cnt"])
    _close(y.numpy(), jy, 1e-2, "y_s")
