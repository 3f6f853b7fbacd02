"""The port's human datasets against the JAX package's: Hand3DStudio(All)
and its ``_mt`` twins, FreiHand, SURREAL, LSP(_mt) and Human36M(_mt), on
tiny trees in each dataset's layout (the recipes of
tests/test_more_datasets.py and tests/test_data.py); Human3.6M's
``_preprocess`` on two copies of one raw tree; the missing-data errors.

For each class, split (and task for H3D, k in {1, 2} for the mean-teacher
classes) both packages build the dataset from the same seeded global
streams; then its sample names, its items, the first collated batch (the
JAX package's DataLoader and collate against the port's ``make_loader``)
and the streams' next draws must be equal. The constructors of H3D,
FreiHAND, SURREAL and Human3.6M reseed ``random`` with 42, as the reference
does, so the streams check that too.

Tolerance: none. Every array is compared bit for bit, with its dtype, and
every dict with its keys in order.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import scipy.io as scio
from PIL import Image

import uda_poseestimation_tpu.data as jdata
import uda_poseestimation_tpu.data.transforms as JT
import uda_poseestimation_torch.data as tdata
import uda_poseestimation_torch.data.transforms as TT
from test_more_datasets import _h36m_fixture
from test_torch_data import HM, MEAN, SIZE, STD, _pipeline, _seed, _streams, assert_same
from uda_poseestimation_tpu.data import freihand as jfreihand
from uda_poseestimation_tpu.data import human36m as jh36m
from uda_poseestimation_torch.data import human36m as th36m

PACKAGES = ((jdata, JT, lambda ds, n: jdata.DataLoader(ds, batch_size=n)),
            (tdata, TT, lambda ds, n: tdata.make_loader(ds, n)))


def _noise(rng, h, w):
    return Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8))


def _source_kwargs(T, split):
    transforms = (_pipeline(T, "source_train") if split == "train" else
                  T.Compose([T.Resize(SIZE), T.ToTensor(), T.Normalize(MEAN, STD)]))
    return dict(split=split, transforms=transforms, image_size=(SIZE, SIZE),
                heatmap_size=(HM, HM))


def _mt_kwargs(T, k):
    return dict(k=k, image_size=(SIZE, SIZE), heatmap_size=(HM, HM),
                transforms_base=T.Compose([T.RandomResizedCrop(SIZE, scale=(0.6, 1.3))]),
                transforms_stu=T.Compose(_pipeline(T, "source_train").transforms[1:]),
                transforms_tea=T.Compose([
                    T.RandomAffineRotation(90, (-20, 20), (0.05, 0.05), (0.8, 1.2)),
                    T.ColorJitter(0.3, 0.3, 0.3), T.ToTensor(), T.Normalize(MEAN, STD)]))


def _name(sample):
    return sample["name"] if isinstance(sample, dict) else sample[0]


def assert_packages_agree(make, n_items=12, batch=4, seed=11,
                          index=lambda ds: [_name(s) for s in ds.samples]):
    """Build the dataset with each package (``make(data_module, T)``) from
    the same seeded streams and compare ``index(ds)`` (the sample names),
    the number of keypoints, the items, the first batch and the streams'
    next draws."""
    outs = []
    for mod, T, loader in PACKAGES:
        _seed(seed)
        ds = make(mod, T)
        items = [ds[i] for i in range(min(len(ds), n_items))]
        first = next(iter(loader(ds, batch)))
        outs.append((index(ds), ds.num_keypoints, items, first, _streams()))
    assert len(outs[0][0]) > 0
    assert_same(*outs)
    return outs[1]


# ---------------------------------------------------------------------------
# Hand-3D-Studio
# ---------------------------------------------------------------------------

def write_h3d(root):
    """12 square frames under ``root`` (a ``pathlib.Path``), every other one
    with an object (test_more_datasets); returns ``root`` as a string."""
    crop = root / "H3D_crop"
    (crop / "part1").mkdir(parents=True)
    rng = np.random.RandomState(3)
    samples = []
    for i in range(12):
        name = f"part1/im{i}.jpg"
        _noise(rng, 128, 128).save(crop / name)
        samples.append({
            "name": name,
            "without_object": i % 2,
            "keypoint2d": rng.uniform(20, 100, (21, 2)).tolist(),
            "keypoint3d": (rng.uniform(-0.05, 0.05, (21, 3)) + [0, 0, 0.4]).tolist(),
            "intrinsic_matrix": [[300.0, 0, 64], [0, 300.0, 64], [0, 0, 1]],
        })
    (crop / "annotation.json").write_text(json.dumps(samples))
    return str(root)


@pytest.fixture(scope="module")
def h3d_root(tmp_path_factory):
    return write_h3d(tmp_path_factory.mktemp("h3d"))


@pytest.mark.parametrize("task", ["noobject", "object", "all"])
@pytest.mark.parametrize("split", ["train", "test", "val", "train-val", "all"])
def test_hand_3d_studio_items_match_jax(h3d_root, split, task):
    _, _, items, _, _ = assert_packages_agree(
        lambda mod, T: mod.Hand3DStudio(h3d_root, task=task, **_source_kwargs(T, split)))
    assert items[0][0].shape == (SIZE, SIZE, 3) and items[0][1].shape == (21, HM, HM)


@pytest.mark.parametrize("split", ["train", "test"])
def test_hand_3d_studio_all_items_match_jax(h3d_root, split):
    names = assert_packages_agree(
        lambda mod, T: mod.Hand3DStudioAll(h3d_root, download=False,
                                           **_source_kwargs(T, split)))[0]
    assert len(names) == {"train": 10, "test": 2}[split]


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cls", ["Hand3DStudio_mt", "Hand3DStudioAll_mt"])
def test_hand_3d_studio_mt_items_match_jax(h3d_root, cls, k):
    _, _, items, first, _ = assert_packages_agree(
        lambda mod, T: getattr(mod, cls)(h3d_root, **_mt_kwargs(T, k)))
    assert len(items[0]) == 8 and len(items[0][4]) == k
    assert first[4][0].shape == (4, SIZE, SIZE, 3) and first[3]["aug_param_stu"].shape == (4, 6)


# ---------------------------------------------------------------------------
# FreiHAND
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def freihand_root(tmp_path_factory):
    """The full 32560-sample index (test_more_datasets' recipe, keypoints
    rounded to 0.1 mm) and all 130240 images: 8 frames of 224², linked in
    turn."""
    root = tmp_path_factory.mktemp("freihand")
    rgb = root / "training" / "rgb"
    rgb.mkdir(parents=True)
    (root / "evaluation").mkdir()
    rng = np.random.RandomState(0)
    n = jfreihand.db_size("training")
    xyz = np.round(rng.uniform(-0.05, 0.05, (n, 21, 3)) + [0.01, -0.02, 0.5], 4)
    (root / "training_K.json").write_text(
        json.dumps([[[300.0, 0, 112], [0, 300.0, 112], [0, 0, 1]]] * n))
    (root / "training_mano.json").write_text(json.dumps([[0.0]] * n))
    (root / "training_xyz.json").write_text(json.dumps(xyz.tolist()))
    frames = [os.path.join(rgb, "%08d.jpg" % i) for i in range(8)]
    for frame in frames:
        _noise(rng, 224, 224).save(frame)
    for i in range(8, 4 * n):
        os.link(frames[i % 8], os.path.join(rgb, "%08d.jpg" % i))
    return str(root)


def _freihand_index(ds):
    """Every sample of the split in order: names, handedness and projected
    keypoints."""
    return ([(s["name"], s["mask_name"], s["left"]) for s in ds.samples],
            np.stack([s["keypoint2d"] for s in ds.samples]))


@pytest.mark.parametrize("task,split", [("all", "test"), ("sample", "train")])
def test_freihand_items_match_jax(freihand_root, task, split):
    """The trainer's validation split (all four colour versions) and a
    training split of one version."""
    names = assert_packages_agree(
        lambda mod, T: mod.FreiHand(freihand_root, task=task, **_source_kwargs(T, split)),
        index=_freihand_index)[0][0]
    n = {"all": 4, "sample": 1}[task] * jfreihand.db_size("training")
    assert len(names) == {"test": 3200, "train": n - 3200}[split]


# ---------------------------------------------------------------------------
# SURREAL
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def surreal_root(tmp_path_factory):
    """train/run{0,1,2}, val and test, each with run{0,1,2}.json over 240²
    frames (test_more_datasets' recipe)."""
    root = tmp_path_factory.mktemp("surreal")
    rng = np.random.RandomState(1)
    for split, per_run in (("train", 4), ("val", 2), ("test", 5)):
        for part in (0, 1, 2):
            run_dir = root / split / f"run{part}"
            run_dir.mkdir(parents=True)
            samples = []
            for i in range(per_run):
                name = f"img{i}.jpg"
                _noise(rng, 240, 240).save(run_dir / name)
                samples.append({
                    "name": name,
                    "keypoint2d": rng.uniform(40, 200, (24, 2)).tolist(),
                    "keypoint3d": (rng.uniform(-0.3, 0.3, (24, 3)) + [0, 0, 3.0]).tolist(),
                    "intrinsic_matrix": [[600.0, 0, 160], [0, 600.0, 120], [0, 0, 1]],
                })
            (root / split / f"run{part}.json").write_text(json.dumps(samples))
    return str(root)


@pytest.mark.parametrize("split", ["train", "test", "val"])
def test_surreal_items_match_jax(surreal_root, split):
    names, k, items, _, _ = assert_packages_agree(
        lambda mod, T: mod.SURREAL(surreal_root, **_source_kwargs(T, split)))
    assert len(names) == {"train": 10, "test": 3, "val": 6}[split]
    assert k == 16 and items[0][1].shape == (16, HM, HM)


# ---------------------------------------------------------------------------
# LSP
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lsp_root(tmp_path_factory):
    """A 2000-entry joints.mat (test_data.py's recipe, some joints occluded)
    and its 2000 images: 6 frames, wide and tall in turn, linked in order."""
    root = tmp_path_factory.mktemp("lsp")
    (root / "images").mkdir()
    (root / "lsp").mkdir()  # download=False checks for it (lsp.py:47)
    rng = np.random.RandomState(0)
    joints = np.zeros((3, 14, 2000))
    joints[0] = rng.uniform(10, 120, (14, 2000))
    joints[1] = rng.uniform(10, 120, (14, 2000))
    joints[2] = rng.rand(14, 2000) < 0.2
    scio.savemat(root / "joints.mat", {"joints": joints})
    for i in range(2000):
        path = root / "images" / ("im%04d.jpg" % (i + 1))
        if i < 6:
            h, w = (128, 192) if i % 2 == 0 else (192, 128)
            _noise(rng, h, w).save(path)
        else:
            os.link(root / "images" / ("im%04d.jpg" % (i % 6 + 1)), path)
    return str(root)


@pytest.mark.parametrize("split,download", [("train", True), ("test", False)])
def test_lsp_items_match_jax(lsp_root, split, download):
    """Every split is the 2000 samples, and the transform is ResizePad +
    ToTensor + Normalize whatever ``transforms`` says."""
    names, _, items, _, _ = assert_packages_agree(
        lambda mod, T: mod.LSP(lsp_root, download=download, **_source_kwargs(T, "train")),
        n_items=6)
    assert len(names) == 2000 and items[0][0].shape == (SIZE, SIZE, 3)
    weights = np.stack([item[2][:, 0] for item in items])
    assert (weights[:, 6:8] == 0).all() and 0 < weights.mean() < 1


@pytest.mark.parametrize("k", [1, 2])
def test_lsp_mt_items_match_jax(lsp_root, k):
    _, _, items, _, _ = assert_packages_agree(
        lambda mod, T: mod.LSP_mt(lsp_root, **_mt_kwargs(T, k)), n_items=6)
    assert len(items[0][4]) == k and items[0][3]["aug_param_stu"].shape == (6,)


# ---------------------------------------------------------------------------
# Human3.6M
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def h36m_root(tmp_path_factory):
    """Preprocessed parts 1, 5-9 and 11, 3 crops of 512² each."""
    return _h36m_fixture(tmp_path_factory.mktemp("h36m"))


@pytest.mark.parametrize("split", ["train", "test", "all"])
def test_human36m_items_match_jax(h36m_root, split):
    names, _, _, _, _ = assert_packages_agree(
        lambda mod, T: mod.Human36M(h36m_root, **_source_kwargs(T, split)), n_items=8)
    assert len(names) == {"train": 15, "test": 3200, "all": 21}[split]


@pytest.mark.parametrize("k", [1, 2])
def test_human36m_mt_items_match_jax(h36m_root, k):
    _, _, items, _, _ = assert_packages_agree(
        lambda mod, T: mod.Human36M_mt(h36m_root, **_mt_kwargs(T, k)))
    assert len(items[0][4]) == k and items[0][3]["z_stu"].shape == (16,)


def _write_raw_h36m(root, part=9):
    """Official-layout annotations for 10 frames of one subject
    (test_more_datasets' recipe)."""
    (root / "annotations").mkdir(parents=True)
    (root / "images" / f"s{part}").mkdir(parents=True)
    rng = np.random.RandomState(6)
    images_meta, joints = [], {}
    cam = {"1": {"R": np.eye(3).tolist(), "t": [0.0, 0.0, 4000.0],
                 "f": [1100.0, 1100.0], "c": [500.0, 500.0]}}
    for i in range(10):
        fname = f"s{part}/f{i}.jpg"
        _noise(rng, 1000, 1000).save(root / "images" / fname)
        images_meta.append({"file_name": fname, "action_idx": 2,
                            "subaction_idx": 1, "frame_idx": i, "cam_idx": 1})
        joints.setdefault("2", {}).setdefault("1", {})[str(i)] = (
            rng.uniform(-300, 300, (17, 3))).tolist()
    for kind, value in (("camera", cam), ("data", {"images": images_meta}),
                        ("joint_3d", joints)):
        (root / "annotations" / f"Human36M_subject{part}_{kind}.json").write_text(
            json.dumps(value))


def test_preprocess_matches_jax(tmp_path):
    """Two copies of one raw tree: the same keypoints2d JSON, text for text,
    and pixel-equal 512² crops."""
    _write_raw_h36m(tmp_path / "jax")
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    jh36m._preprocess(9, str(tmp_path / "jax"))
    th36m._preprocess(9, str(tmp_path / "port"))
    name = os.path.join("annotations", "keypoints2d_9.json")
    texts = [(tmp_path / tree / name).read_text() for tree in ("jax", "port")]
    assert texts[0] == texts[1] and len(json.loads(texts[1])) == 2
    crops = sorted(os.listdir(tmp_path / "port" / "crop_images" / "s9"))
    assert crops == ["f0.jpg", "f5.jpg"]
    for crop in crops:
        images = [np.asarray(Image.open(tmp_path / tree / "crop_images" / "s9" / crop))
                  for tree in ("jax", "port")]
        assert images[1].shape == (512, 512, 3)
        assert np.array_equal(*images)


# ---------------------------------------------------------------------------
# missing data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["Hand3DStudio", "Hand3DStudioAll", "Hand3DStudio_mt",
                                  "Hand3DStudioAll_mt", "FreiHand", "SURREAL", "LSP",
                                  "LSP_mt", "Human36M", "Human36M_mt"])
def test_missing_data_raises(tmp_path, monkeypatch, name):
    """An empty root raises FileNotFoundError (the JAX package exits with
    status 0 from its download helper); nothing calls sys.exit."""
    def no_exit(code=None):
        raise AssertionError(f"sys.exit({code})")

    monkeypatch.setattr(sys, "exit", no_exit)
    kwargs = _mt_kwargs(TT, 1) if name.endswith("_mt") else {"transforms": None}
    with pytest.raises(FileNotFoundError):
        getattr(tdata, name)(str(tmp_path), **kwargs)
    assert os.listdir(tmp_path) == []
