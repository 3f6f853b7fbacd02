"""The port's animal datasets and their helpers against the JAX package's.

- Every animal dataset's item equals the JAX package's bit for bit, given
  the same ``random`` and ``np.random`` state before each ``__getitem__``:
  the synthetic horse/tiger (18 keypoints) and hound/sheep (14) sets,
  TigDog and AnimalPose and their ``_mt`` twins at k = 1 and 2, train and
  eval, both ``label_type``s, AnimalPose with and without ``is_aug``; the
  synthetic ``raw_mode`` item; a collated batch. The port's datasets run
  with ``decode_cache`` on, over two passes, so cached items are held to
  the same equality as fresh ones.
- ``AnimalAugmentation``'s image and keypoints; ``crop_ori`` (rotation and
  the downscale branch included), ``imresize``, ``imrotate``,
  ``transform(invert=1)``, ``draw_labelmap_ori`` and the flips.
- ``FrameCache``: a hit equals a fresh load; two forked loader workers
  share hits and one byte budget; the budget holds across the caches of a
  run.
- ``generic_transforms`` and ``samplers`` on seeded inputs; the registry
  names; the mean files (read, and computed and written when missing) and
  ``generate_data_file``.

Tolerance: none; every comparison is for equality.

Fixtures: ``tools/make_fixtures.make_animal`` (synthetic horse/tiger at
640x480 and TigDog at 320x240, with their cached index and mean files under
``UDA_CACHED_DATA_DIR``), a 14-keypoint ``keypoints_14.json`` over the same
renders for the hound/sheep sets, and ``tests/test_animal_data.py``'s
``fake_animal_pose``.
"""

import json
import os
import random

import numpy as np
import pytest
import torch
from PIL import Image

import uda_poseestimation_tpu.data as jdata
import uda_poseestimation_torch.data as tdata
from test_animal_data import fake_animal_pose  # noqa: F401 (fixture)
from tools.make_fixtures import make_animal
from uda_poseestimation_tpu.data import animal_aug as janimal_aug
from uda_poseestimation_tpu.data import generic_transforms as jgt
from uda_poseestimation_tpu.data import samplers as jsamplers
from uda_poseestimation_tpu.data import synthetic_animal as jsynthetic
from uda_poseestimation_tpu.data import transforms as JT
from uda_poseestimation_tpu.data import util as jutil
from uda_poseestimation_torch.data import animal_aug as tanimal_aug
from uda_poseestimation_torch.data import generic_transforms as tgt
from uda_poseestimation_torch.data import loader as tloader
from uda_poseestimation_torch.data import samplers as tsamplers
from uda_poseestimation_torch.data import synthetic_animal as tsynthetic
from uda_poseestimation_torch.data import transforms as TT
from uda_poseestimation_torch.data import util as tutil


def add_other_keypoints(root):
    """A keypoints_14.json for the hound/sheep sets over make_animal's
    horse/tiger renders (their first 14 keypoints)."""
    path = os.path.join(root, "animal_data", "clean_data")
    with open(os.path.join(path, "keypoints_18.json")) as f:
        data18 = json.load(f)
    data14 = {}
    for other, animal in (("hound", "horse"), ("sheep", "tiger")):
        annot = dict(data18[animal])
        annot["keypoints"] = [kp[:14] for kp in annot["keypoints"]]
        data14[other] = annot
    with open(os.path.join(path, "keypoints_14.json"), "w") as f:
        json.dump(data14, f)


@pytest.fixture(scope="module")
def animal_root(tmp_path_factory):
    """make_animal's tree (8 renders per animal, 2 TigDog shots of 4
    frames), with the 14-keypoint file; the path relative to which its
    clean_data paths are written."""
    root = tmp_path_factory.mktemp("animal")
    make_animal(str(root))
    add_other_keypoints(str(root))
    return str(root)


@pytest.fixture
def animal_env(animal_root, monkeypatch):
    monkeypatch.setenv("UDA_CACHED_DATA_DIR", os.path.join(animal_root, "cached_data"))
    return os.path.join(animal_root, "animal_data")


def animal_kwargs(image_path, label_type="Gaussian", **extra):
    """The dataset keywords of the animal trainers' flags at 64²/16²."""
    return dict(animal="all", image_path=image_path, inp_res=64, out_res=16, sigma=1,
                scale_factor=0.25, rot_factor=30, label_type=label_type,
                train_on_all_cat=True, **extra)


def view_transforms(pkg):
    """The script lines' student/teacher transforms in one package."""
    return {role: pkg.Compose([pkg.RandomAffineRotation(60, (-30, 30), (0.05, 0.05),
                                                        (0.6, 1.3)), pkg.ToTensor()])
            for role in ("transforms_stu", "transforms_tea")}


def assert_same(got, want, path="item"):
    """Equal structure, dtypes, shapes and values (tensors against arrays)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for key in want:
            assert_same(got[key], want[key], f"{path}[{key!r}]")
    elif isinstance(want, (list, tuple)) and not isinstance(want, str):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, str):
        assert got == want, path
    else:
        if isinstance(got, torch.Tensor):
            got = got.numpy()
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, \
            (path, got.dtype, want.dtype, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=path)


def items_alike(tds, jds, passes=2):
    """Every item of both datasets from the same host RNG state, over
    ``passes`` passes of the port's (its frame cache fills in the first)."""
    assert len(tds) == len(jds) > 0
    for _ in range(passes):
        for i in range(len(tds)):
            random.seed(i)
            np.random.seed(i)
            got = tds[i]
            random.seed(i)
            np.random.seed(i)
            assert_same(got, jds[i], f"item {i}")


LABEL_TYPES = ("Gaussian", "Cauchy")


@pytest.mark.parametrize("label_type", LABEL_TYPES)
@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("name", ["synthetic_animal_sp_all", "synthetic_animal_sp_all_other",
                                  "real_animal_all"])
def test_item_matches_jax(animal_env, name, is_train, label_type):
    kw = animal_kwargs(animal_env, label_type)
    tds = tdata.__dict__[name](is_train=is_train, decode_cache=1, **kw)
    jds = jdata.__dict__[name](is_train=is_train, **kw)
    assert tds.num_keypoints == jds.num_keypoints == (14 if name.endswith("other") else 18)
    items_alike(tds, jds)
    assert tds._frames.items_cached == len(tds) and tds._frames.hits == len(tds)


@pytest.mark.parametrize("label_type", LABEL_TYPES)
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("is_train", [True, False])
def test_tigdog_mt_item_matches_jax(animal_env, is_train, k, label_type):
    kw = animal_kwargs(animal_env, label_type)
    tds = tdata.real_animal_all_mt(is_train=is_train, k=k, decode_cache=1,
                                   **view_transforms(TT), **kw)
    jds = jdata.real_animal_all_mt(is_train=is_train, k=k, **view_transforms(JT), **kw)
    items_alike(tds, jds)
    item = tds[0]
    assert len(item) == 8 and len(item[4]) == k
    assert {"canvas", "vis", "kp_orig", "aug_param_stu"} <= set(item[3])


@pytest.mark.parametrize("label_type", LABEL_TYPES)
@pytest.mark.parametrize("is_aug", [False, True])
@pytest.mark.parametrize("is_train", [True, False])
def test_animal_pose_item_matches_jax(fake_animal_pose, is_train, is_aug,  # noqa: F811
                                      label_type):
    kw = animal_kwargs(fake_animal_pose, label_type)
    tds = tdata.animal_pose(is_train=is_train, is_aug=is_aug, decode_cache=1, **kw)
    jds = jdata.animal_pose(is_train=is_train, is_aug=is_aug, **kw)
    items_alike(tds, jds)


@pytest.mark.parametrize("label_type", LABEL_TYPES)
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("is_train", [True, False])
def test_animal_pose_mt_item_matches_jax(fake_animal_pose, is_train, k,  # noqa: F811
                                         label_type):
    kw = animal_kwargs(fake_animal_pose, label_type)
    tds = tdata.animal_pose_mt(is_train=is_train, k=k, decode_cache=1,
                               **view_transforms(TT), **kw)
    jds = jdata.animal_pose_mt(is_train=is_train, k=k, **view_transforms(JT), **kw)
    items_alike(tds, jds)


def test_raw_mode_item_matches_jax(animal_env):
    kw = animal_kwargs(animal_env)
    tds = tdata.synthetic_animal_sp_all(is_train=True, raw_mode=True, decode_cache=1, **kw)
    jds = jdata.synthetic_animal_sp_all(is_train=True, raw_mode=True, **kw)
    assert tds.raw_mode and tds._frames.max_bytes == 0  # decode only, no frame cache
    items_alike(tds, jds, passes=1)
    assert tds[0][3]["canvas"].shape == (480, 640, 3)


def test_collated_batch_matches_jax(animal_env):
    kw = animal_kwargs(animal_env)
    batches = []
    for pkg, T in ((tdata, TT), (jdata, JT)):
        src = pkg.synthetic_animal_sp_all(is_train=True, **kw)
        tgt = pkg.real_animal_all_mt(is_train=True, k=2, **view_transforms(T), **kw)
        random.seed(5)
        np.random.seed(5)
        items = [(src[i], tgt[i]) for i in range(4)]
        collate = tloader.default_collate if pkg is tdata else jdata.default_collate
        batches.append([collate([it[0] for it in items]), collate([it[1] for it in items])])
    assert_same(batches[0], batches[1], "batch")
    assert isinstance(batches[0][1][4], list) and batches[0][1][4][0].shape == (4, 64, 64, 3)


@pytest.mark.parametrize("p", [0.5, 1.0])
@pytest.mark.parametrize("seed", range(6))
def test_animal_augmentation_matches_jax(seed, p):
    rng = np.random.RandomState(100 + seed)
    image = (rng.rand(120, 160, 3) * 255).astype(np.uint8)
    kps = rng.uniform(0, 160, (18, 2)).astype(np.float32)
    np.random.seed(seed)
    got = tanimal_aug.AnimalAugmentation(p=p)(image, kps)
    np.random.seed(seed)
    want = janimal_aug.AnimalAugmentation(p=p)(image, kps)
    assert_same(got, want)
    # an injected stream draws the same as the global one
    got_rng = tanimal_aug.AnimalAugmentation(p=p, rng=np.random.RandomState(seed))(image, kps)
    assert_same(got_rng, want)


@pytest.mark.parametrize("rot", [0, 15, -30])
@pytest.mark.parametrize("scale", [0.9, 2.4, 6.0])
def test_crop_ori_matches_jax(rot, scale):
    rng = np.random.RandomState(7)
    img = rng.rand(240, 320, 3).astype(np.float32)
    center = np.array([150.0, 110.0], np.float32)
    assert_same(tutil.crop_ori(img, center, scale, [64, 64], rot=rot),
                jutil.crop_ori(img, center, scale, [64, 64], rot=rot))


def test_resampling_and_transform_helpers_match_jax():
    rng = np.random.RandomState(8)
    img_f = rng.rand(50, 70, 3).astype(np.float32) * 3 - 1
    img_u8 = (rng.rand(50, 70, 3) * 255).astype(np.uint8)
    gray = rng.rand(50, 70).astype(np.float32)
    for arr in (img_f, img_u8, gray):
        for interp in ("nearest", "bilinear", "bicubic"):
            assert_same(tutil.imresize(arr, (33, 21), interp),
                        jutil.imresize(arr, (33, 21), interp))
        for angle in (-25, 40):
            assert_same(tutil.imrotate(arr, angle), jutil.imrotate(arr, angle))
    for invert in (0, 1):
        for rot in (0, 20):
            for pt in ([3.5, 7.0], [63.0, 1.0]):
                assert_same(tutil.transform(pt, [160.0, 120.0], 1.3, [64, 64], invert, rot),
                            jutil.transform(pt, [160.0, 120.0], 1.3, [64, 64], invert, rot))
    assert_same(tutil.get_transform([10, 20], 0.7, [16, 16], rot=33),
                jutil.get_transform([10, 20], 0.7, [16, 16], rot=33))
    assert_same(tutil.fliplr(img_f), jutil.fliplr(img_f))
    assert_same(tutil.fliplr(gray), jutil.fliplr(gray))
    pts = rng.uniform(0, 64, (18, 3)).astype(np.float32)
    assert_same(tutil.shufflelr_ori(pts, 64, "real_animal"),
                jutil.shufflelr_ori(pts, 64, "real_animal"))
    assert_same(tutil.shufflelr_ori(pts[:14], 64, "animal_pose"),
                jutil.shufflelr_ori(pts[:14], 64, "animal_pose"))
    for x in (img_f, gray):
        assert_same(tutil.color_normalize(x, [0.4, 0.39, 0.38], [1, 1, 1]),
                    jutil.color_normalize(x, [0.4, 0.39, 0.38], [1, 1, 1]))
    assert_same(tutil.im_to_float(img_u8), jutil.im_to_float(img_u8))


@pytest.mark.parametrize("label_type", LABEL_TYPES)
@pytest.mark.parametrize("sigma", [1, 2.0])
def test_draw_labelmap_ori_matches_jax(label_type, sigma):
    base = np.zeros((16, 16), np.float32)
    # inside, on each edge of the window rule, outside
    for pt in ([8.0, 8.0], [3.0, 12.0], [2.0, 8.0], [13.0, 8.0], [-1.0, 5.0], [20.0, 3.0]):
        got = tutil.draw_labelmap_ori(base, np.array(pt), sigma, label_type)
        want = jutil.draw_labelmap_ori(base, np.array(pt), sigma, label_type)
        assert got[1] == want[1]
        assert_same(got[0], want[0])


def _frame_files(directory, n, size=(24, 32)):
    rng = np.random.RandomState(9)
    paths = []
    for i in range(n):
        paths.append(os.path.join(directory, f"f{i}.png"))
        Image.fromarray((rng.rand(*size, 3) * 255).astype(np.uint8)).save(paths[-1])
    return paths


def test_frame_cache_hits_equal_fresh_loads(tmp_path):
    paths = _frame_files(str(tmp_path), 4)
    frame_bytes = 24 * 32 * 3
    cache = tutil.FrameCache(frame_bytes * 10 + 1, keys=paths[:3])
    for _ in range(2):
        for p in paths:
            np.testing.assert_array_equal(cache.load(p), jutil.load_image_ori(p))
    # the fourth path is not a key: it loads, uncached
    assert (cache.misses, cache.hits, cache.items_cached) == (3, 3, 3)
    assert cache.bytes_used == 3 * frame_bytes

    def decode(p):
        with Image.open(p) as im:
            return np.asarray(im)[:, :, :3].copy()

    u8 = tutil.FrameCache(frame_bytes * 10 + 2, keys=paths)
    first = [u8.load_u8(p, decode) for p in paths]
    again = [u8.load_u8(p, decode) for p in paths]
    for a, b in zip(first, again):
        assert b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    gray = np.arange(12, dtype=np.uint8).reshape(3, 4)  # a 2-D frame keeps its shape
    two_d = tutil.FrameCache(1000.5, keys=["g"])
    assert two_d.load_u8("g", lambda _: gray) is gray
    np.testing.assert_array_equal(two_d.load_u8("g", lambda _: None), gray)
    off = tutil.FrameCache(0, keys=paths)
    np.testing.assert_array_equal(off.load(paths[0]), jutil.load_image_ori(paths[0]))
    assert off.hits == off.misses == off.bytes_used == 0


def test_frame_cache_budget_holds_across_a_runs_caches(tmp_path):
    """Two caches in one arena (a trainer's ``frame_arena``) share its
    budget: 2.5 frames' worth holds two frames, whichever cache stores
    them; a cache without an arena has a budget of its own."""
    paths = _frame_files(str(tmp_path), 4)
    budget = 24 * 32 * 3 * 2.5
    arena = tutil.FrameArena(budget)
    a = tutil.FrameCache(budget, keys=paths[:2], arena=arena)
    b = tutil.FrameCache(budget, keys=paths[2:], arena=arena)
    for p in paths:
        (a if p in paths[:2] else b).load(p)
    assert a.items_cached == 2 and b.items_cached == 0
    assert a.bytes_used == b.bytes_used == 2 * 24 * 32 * 3 <= budget
    for p in paths[2:]:  # uncached, still right
        np.testing.assert_array_equal(b.load(p), jutil.load_image_ori(p))
    alone = tutil.FrameCache(budget, keys=paths[2:])
    for p in paths[2:]:
        alone.load(p)
    assert alone.items_cached == 2 and alone.bytes_used == 2 * 24 * 32 * 3


class FrameDataset(torch.utils.data.Dataset):
    """Loads its frames through a FrameCache; counts decodes per process."""

    def __init__(self, paths, budget):
        self.paths = paths
        self.frames = tutil.FrameCache(budget, keys=paths)
        self.decodes = 0

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        def decode(p):
            self.decodes += 1
            with Image.open(p) as im:
                return np.asarray(im).copy()

        info = torch.utils.data.get_worker_info()
        return self.frames.load_u8(self.paths[i], decode), i, 0 if info is None else info.id


def test_forked_workers_share_one_frame_cache(tmp_path):
    """Two forked workers over three passes: the first pass decodes every
    frame once, every later fetch is a hit whichever worker it lands on,
    the parent reads the counts, and the bytes are one process's."""
    n = 12
    paths = _frame_files(str(tmp_path), n)
    ds = FrameDataset(paths, 1e6 + 1)
    loader = tloader.make_loader(ds, batch_size=3, shuffle=True, num_workers=2)
    torch.manual_seed(0)
    workers = set()
    for epoch in range(3):
        seen = []
        for frames, index, worker in loader:
            seen += index.tolist()
            workers |= set(worker.tolist())
            for f, i in zip(frames, index.tolist()):
                with Image.open(paths[i]) as im:
                    np.testing.assert_array_equal(f.numpy(), np.asarray(im))
        assert sorted(seen) == list(range(n))
        assert (ds.frames.misses, ds.frames.hits) == (n, n * epoch), epoch
    assert workers == {0, 1} and ds.decodes == 0  # the parent decoded nothing
    assert ds.frames.items_cached == n and ds.frames.bytes_used == n * 24 * 32 * 3


def test_generic_transforms_match_jax():
    rng = np.random.RandomState(10)
    pil = Image.fromarray((rng.rand(30, 40, 3) * 255).astype(np.uint8))
    hwc = rng.rand(8, 9, 3).astype(np.float32)
    chw = rng.rand(3, 40, 50).astype(np.float32)
    assert_same(np.asarray(tgt.ResizeImage(17)(pil)), np.asarray(jgt.ResizeImage(17)(pil)))
    assert_same(np.asarray(tgt.ResizeImage((11, 13))(pil)),
                np.asarray(jgt.ResizeImage((11, 13))(pil)))
    assert repr(tgt.ResizeImage(5)) == repr(jgt.ResizeImage(5))
    multi = tgt.MultipleApply([tgt.Denormalize([0.1, 0.2, 0.3], [2, 3, 4]),
                               tgt.NormalizeAndTranspose()])
    jmulti = jgt.MultipleApply([jgt.Denormalize([0.1, 0.2, 0.3], [2, 3, 4]),
                                jgt.NormalizeAndTranspose()])
    assert_same(multi(hwc), jmulti(hwc))
    assert_same(tgt.NormalizeAndTranspose()(pil), jgt.NormalizeAndTranspose()(pil))
    assert_same(tgt.DeNormalizeAndTranspose()(chw), jgt.DeNormalizeAndTranspose()(chw))
    for seed in range(5):
        random.seed(seed)
        got = tgt.RandomErasing(probability=0.7)(chw)
        random.seed(seed)
        assert_same(got, jgt.RandomErasing(probability=0.7)(chw))
    assert repr(tgt.RandomErasing()) == repr(jgt.RandomErasing())


def test_samplers_match_jax():
    ids = [(np.zeros(2), pid, cid) for pid in range(4) for cid in range(pid % 3 + 1)]
    ids += [(np.zeros(2), 9, 0)]  # an identity with one camera and one image
    for seed in range(3):
        random.seed(seed)
        np.random.seed(seed)
        sampler = tsamplers.RandomMultipleGallerySampler(ids, num_instances=3)
        got = list(iter(sampler))
        random.seed(seed)
        np.random.seed(seed)
        want = list(iter(jsamplers.RandomMultipleGallerySampler(ids, num_instances=3)))
        assert [int(i) for i in got] == [int(i) for i in want]
        assert len(sampler) == 15
    a, b = [(1, 2), (3, 4), (5, 6)], [(7,), (8,)]
    assert tsamplers.CombineDataset([a, b])[1] == jsamplers.CombineDataset([a, b])[1]
    assert len(tsamplers.CombineDataset([a, b])) == 2
    parts = [{"x": np.ones((2, 3)), "y": [np.zeros(2), np.arange(2)]},
             {"x": np.zeros((1, 3)), "y": [np.ones(1), np.arange(1)]}]
    assert_same(tsamplers.concatenate(parts), jsamplers.concatenate(parts))
    tparts = [torch.ones(2, 3), torch.zeros(1, 3)]
    assert_same(tsamplers.concatenate(tparts), np.concatenate([t.numpy() for t in tparts]))
    with pytest.raises(TypeError):
        tsamplers.concatenate([1, 2])


def test_registry_names_match_jax():
    """Every name of the JAX registry resolves in the port's, from the port's
    own modules; ``DataLoader`` is the one exception (the port's loader is
    ``make_loader`` over ``torch.utils.data.DataLoader``)."""
    names = [n for n in dir(jdata) if not n.startswith("_") and not isinstance(
        getattr(jdata, n), type(jdata))]
    assert set(names) - set(dir(tdata)) == {"DataLoader"}
    for name in set(names) - {"DataLoader"}:
        obj = getattr(tdata, name)
        if callable(obj) and hasattr(obj, "__module__"):
            assert obj.__module__.startswith("uda_poseestimation_torch."), name
    for name in ("synthetic_animal_sp_all", "synthetic_animal_sp_all_other",
                 "real_animal_all", "real_animal_all_mt", "animal_pose", "animal_pose_mt"):
        assert getattr(tdata, name).njoints == getattr(jdata, name).njoints, name
    tcls, jcls = tdata.Animal18KeypointDataset, jdata.Animal18KeypointDataset
    for group in ("eye", "chin", "hoof", "hip", "knee", "shoulder", "elbow", "all"):
        assert getattr(tcls, group) == getattr(jcls, group), group
    for group in ("eye", "hoof", "knee", "elbow", "all"):
        assert getattr(tdata.Animal14KeypointDataset, group) == \
            getattr(jdata.Animal14KeypointDataset, group), group


def test_visualize_draws_the_animal_skeleton(animal_env, tmp_path):
    kw = animal_kwargs(animal_env)
    for name in ("synthetic_animal_sp_all", "synthetic_animal_sp_all_other"):
        tds = tdata.__dict__[name](is_train=False, **kw)
        jds = jdata.__dict__[name](is_train=False, **kw)
        image = np.zeros((64, 64, 3), np.uint8)
        kps = np.random.RandomState(0).uniform(0, 64, (tds.num_keypoints, 2))
        tds.visualize(image, kps, str(tmp_path / "t.png"))
        jds.visualize(image, kps, str(tmp_path / "j.png"))
        assert_same(np.asarray(Image.open(tmp_path / "t.png")),
                    np.asarray(Image.open(tmp_path / "j.png")))


def test_mean_file_computed_when_missing(animal_root, tmp_path, monkeypatch):
    """Without its mean file, a single-animal synthetic set computes the
    mean and std over its training frames and writes them in the
    reference's layout; both packages compute the same, and each reads the
    other's file."""
    kw = dict(animal_kwargs(os.path.join(animal_root, "animal_data")), animal="horse")
    written = {}
    for name, module, pkg in (("torch", tsynthetic, tdata), ("jax", jsynthetic, jdata)):
        cached = tmp_path / name
        cached.mkdir()
        monkeypatch.setenv("UDA_CACHED_DATA_DIR", str(cached))
        ds = pkg.synthetic_animal_sp_all(is_train=True, **kw)
        written[name] = str(cached / "synthetic_animal" / "horse_combineds5r5_texture"
                            / "mean.pth.tar")
        assert os.path.isfile(written[name])
        written[name + "_values"] = (ds.mean, ds.std)
    assert_same(written["torch_values"], written["jax_values"])
    assert_same(tsynthetic.load_mean_file(written["jax"]), written["jax_values"])
    assert_same(jsynthetic.load_mean_file(written["torch"]), written["torch_values"])


def test_generate_data_file_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("UDA_CACHED_DATA_DIR", str(tmp_path / "cached"))
    for pkg_name in ("torch", "jax"):
        data_dir = tmp_path / pkg_name
        for animal in ("horse", "tiger"):
            img_dir = data_dir / "synthetic_animal" / f"{animal}_combineds5r5_texture"
            img_dir.mkdir(parents=True)
            for i in range(3):
                (img_dir / f"{i:04d}_img.png").touch()
                np.save(img_dir / f"{i:04d}_kpts.npy",
                        np.random.RandomState(i).uniform(0, 600, (3100, 3)))
            cdir = tmp_path / "cached" / "synthetic_animal" / f"{animal}_combineds5r5_texture"
            cdir.mkdir(parents=True, exist_ok=True)
            np.save(cdir / "train_idxs.npy", np.array([0, 2]))
            np.save(cdir / "valid_idxs.npy", np.array([1]))
    tsynthetic.generate_data_file(str(tmp_path / "torch"))
    jsynthetic.generate_data_file(str(tmp_path / "jax"))
    got = json.loads((tmp_path / "torch" / "clean_data" / "keypoints_18.json").read_text())
    want = json.loads((tmp_path / "jax" / "clean_data" / "keypoints_18.json").read_text())
    for animal in ("horse", "tiger"):
        got[animal]["imgpath"] = [p.replace("/torch/", "/") for p in got[animal]["imgpath"]]
        want[animal]["imgpath"] = [p.replace("/jax/", "/") for p in want[animal]["imgpath"]]
    assert got == want and len(got["horse"]["keypoints"][0]) == 18
