"""The port's data pipeline and host utilities against the JAX package's:
each transform (ResizePad on wide and tall frames), the RHD datasets (4- and 8-tuples, k = 1 and 2), the
collated batch through make_adapt_batch, group_accuracy, the host PCK
helpers, the meters' lines, the run logger and the LR schedule, on a tiny
fake-RHD tree (tools/make_fixtures.make_rhd: 8 training and 4 evaluation
frames at 320²).

Tolerance: none. The port runs the same numpy and PIL code on the same
random draws, so every array must be equal bit for bit, every printed line
character for character, and the global ``random`` / ``np.random`` streams
must be left in the same state.
"""

import os
import random
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

import uda_poseestimation_tpu.data as jdata
import uda_poseestimation_tpu.data.transforms as JT
import uda_poseestimation_torch.data as tdata
import uda_poseestimation_torch.data.transforms as TT
from tools.make_fixtures import make_rhd
from uda_poseestimation_tpu import engine as jengine
from uda_poseestimation_tpu.data import _util as jutil
from uda_poseestimation_tpu.ops import pck as jpck
from uda_poseestimation_tpu.utils import logger as jlogger
from uda_poseestimation_tpu.utils import meter as jmeter
from uda_poseestimation_tpu.utils import schedules as jsched
from uda_poseestimation_torch import engine as tengine
from uda_poseestimation_torch.data import _util as tutil
from uda_poseestimation_torch.ops import pck as tpck
from uda_poseestimation_torch.utils import logger as tlogger
from uda_poseestimation_torch.utils import meter as tmeter
from uda_poseestimation_torch.utils import schedules as tsched

MEAN, STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
SIZE, HM = 64, 16


@pytest.fixture(scope="module")
def rhd_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rhd"))
    make_rhd(root, n_train=8, n_eval=4)
    return root


def _seed(seed):
    random.seed(seed)
    np.random.seed(seed)


def _streams():
    """The next value of each global stream (consumes one draw of each)."""
    return random.random(), np.random.rand()


def assert_same(a, b, path="item"):
    """Equal structure, types of containers, dtypes and values, bit for bit."""
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    if isinstance(b, torch.Tensor):
        b = b.numpy()
    if isinstance(a, Image.Image):
        assert isinstance(b, Image.Image) and a.mode == b.mode, path
        a, b = np.asarray(a), np.asarray(b)
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
        assert np.array_equal(a, b, equal_nan=True), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _cropped(transform, width, height):
    """``transform`` on the top-left ``width`` x ``height`` of the image."""
    return lambda image, **kwargs: transform(image.crop((0, 0, width, height)), **kwargs)


def _pipeline(T, name, size=SIZE):
    normalize = T.Normalize(MEAN, STD)
    return {
        "resize": lambda: T.Resize(size),
        "resize_pad_wide": lambda: _cropped(T.ResizePad(size), 200, 117),
        "resize_pad_tall": lambda: _cropped(T.ResizePad(size), 91, 200),
        "random_resized_crop": lambda: T.RandomResizedCrop(size, scale=(0.6, 1.3)),
        "random_affine_rotation": lambda: T.RandomAffineRotation(
            180, (-30, 30), (0.05, 0.05), (0.6, 1.3)),
        "affine_numbers": lambda: T.RandomAffineRotation(60, 20, 0.1, 0.8),
        "color_jitter": lambda: T.ColorJitter(0.25, 0.25, 0.25),
        "gaussian_blur": lambda: T.GaussianBlur(high=0.8),
        "to_tensor": T.ToTensor,
        "normalize": lambda: T.Compose([T.ToTensor(), normalize]),
        "source_train": lambda: T.Compose([
            T.RandomResizedCrop(size, scale=(0.6, 1.3)),
            T.RandomAffineRotation(180, (-30, 30), (0.05, 0.05), (0.6, 1.3)),
            T.ColorJitter(0.25, 0.25, 0.25), T.GaussianBlur(high=0.5),
            T.ToTensor(), normalize]),
    }[name]()


def _frame(rhd_root):
    path = os.path.join(rhd_root, "RHD_published_v2", "training", "color", "00001.png")
    with Image.open(path) as im:
        image = im.crop((40, 30, 240, 230))
        image.load()
    kp = np.random.RandomState(3).uniform(10, 190, (21, 2))
    intrinsic = np.array([[320.0, 0, 160], [0, 320.0, 160], [0, 0, 1]])
    return image, kp, intrinsic


@pytest.mark.parametrize("name", ["resize", "resize_pad_wide", "resize_pad_tall",
                                  "random_resized_crop", "random_affine_rotation",
                                  "affine_numbers", "color_jitter", "gaussian_blur",
                                  "to_tensor", "normalize", "source_train"])
@pytest.mark.parametrize("seed", [0, 7])
def test_transform_matches_jax(rhd_root, name, seed):
    image, kp, intrinsic = _frame(rhd_root)
    outs = []
    for T in (JT, TT):
        _seed(seed)
        out = _pipeline(T, name)(image, keypoint2d=kp, intrinsic_matrix=intrinsic)
        outs.append((out, _streams()))
    assert_same(*outs)


def test_functional_helpers_match_jax(rhd_root):
    image, kp, _ = _frame(rhd_root)
    assert JT._inverse_affine_matrix((5.5, 6.5), 33.0, (2, -3), 0.9, (12.0, -4.0)) == \
        TT._inverse_affine_matrix((5.5, 6.5), 33.0, (2, -3), 0.9, (12.0, -4.0))
    for fn, args in ((lambda T: T.crop(image, 10, 20, 100, 90, kp), ()),
                     (lambda T: T.hflip(image, kp), ()),
                     (lambda T: T.resized_crop(image, 5, 7, 120, 120, 48, keypoint2d=kp), ()),
                     (lambda T: T.affine(image, 25.0, -10.0, 0.0, 3, -2, 1.1, kp), ()),
                     (lambda T: T.pil_affine(image, -40.0, [1, 2], 0.7, [5.0, 0.0]), ())):
        assert_same(fn(JT, *args), fn(TT, *args))


def _rhd(mod, T, root, mt, split="train", k=1):
    if mt:
        return mod.RenderedHandPose_mt(
            root, split=split, k=k, image_size=(SIZE, SIZE), heatmap_size=(HM, HM),
            transforms_base=T.Compose([T.RandomResizedCrop(SIZE, scale=(0.6, 1.3))]),
            transforms_stu=T.Compose(_pipeline(T, "source_train").transforms[1:]),
            transforms_tea=T.Compose([
                T.RandomAffineRotation(90, (-20, 20), (0.05, 0.05), (0.8, 1.2)),
                T.ColorJitter(0.3, 0.3, 0.3), T.ToTensor(), T.Normalize(MEAN, STD)]))
    transforms = (_pipeline(T, "source_train") if split == "train" else
                  T.Compose([T.Resize(SIZE), T.ToTensor(), T.Normalize(MEAN, STD)]))
    return mod.RenderedHandPose(root, split=split, transforms=transforms,
                                image_size=(SIZE, SIZE), heatmap_size=(HM, HM))


@pytest.mark.parametrize("mt,split,k", [(False, "train", 1), (False, "test", 1),
                                        (False, "val", 1), (True, "train", 1),
                                        (True, "train", 2)])
def test_rhd_items_match_jax(rhd_root, mt, split, k):
    outs = []
    for mod, T in ((jdata, JT), (tdata, TT)):
        ds = _rhd(mod, T, rhd_root, mt, split, k)
        _seed(11)
        outs.append(([ds[i] for i in range(len(ds))], len(ds), ds.num_keypoints,
                     _streams()))
    assert outs[0][1] > 0
    assert_same(*outs)


@pytest.mark.parametrize("k", [1, 2])
def test_collated_batch_matches_jax(rhd_root, k):
    """JAX: its DataLoader + default_collate + make_adapt_batch; the port:
    make_loader (-j 0) + its collate + make_adapt_batch. Same arrays, shapes
    and float32."""
    batches = []
    for mod, T, eng, loader in (
            (jdata, JT, jengine, lambda ds: jdata.DataLoader(ds, batch_size=4)),
            (tdata, TT, tengine, lambda ds: tdata.make_loader(ds, 4))):
        _seed(5)
        src = next(iter(loader(_rhd(mod, T, rhd_root, mt=False))))
        tgt = next(iter(loader(_rhd(mod, T, rhd_root, mt=True, k=k))))
        batches.append((eng.make_adapt_batch(src, tgt),
                        eng.make_source_batch(*src[:3], tgt[4][0]), _streams()))
    (jb, js, jstream), (tb, ts, tstream) = batches
    assert jstream == tstream
    assert tb["images_t_tea"].shape == (k, 4, SIZE, SIZE, 3)
    assert tb["aug_params_tea"].shape == (k, 4, 6) and tb["aug_param_stu"].shape == (4, 6)
    for want, got in ((jb, tb), (js, ts)):
        assert list(want) == list(got)
        for key in want:
            assert got[key].dtype == torch.float32, key
            assert_same(np.asarray(want[key]), got[key], key)


def test_collate_structure(rhd_root):
    """Lists of k views stay lists, metadata dicts stay dicts of batches,
    strings stay lists; every array is a tensor in its own dtype."""
    ds = _rhd(tdata, TT, rhd_root, mt=True, k=2)
    _seed(0)
    batch = next(iter(tdata.make_loader(ds, 4, shuffle=True, drop_last=True)))
    assert isinstance(batch, tuple) and len(batch) == 8
    images_tea, metas_tea = batch[4], batch[7]
    assert isinstance(images_tea, list) and len(images_tea) == 2
    assert images_tea[0].shape == (4, SIZE, SIZE, 3) and images_tea[0].dtype == torch.float32
    assert isinstance(metas_tea, list) and metas_tea[1]["aug_param_tea"].shape == (4, 6)
    assert batch[3]["keypoint2d_ori"].dtype == torch.float64
    assert batch[3]["image"] == [batch[3]["image"][i] for i in range(4)]
    assert all(isinstance(name, str) for name in batch[3]["image"])


def test_worker_batches_equal_in_process(rhd_root):
    """With a transform that draws nothing, the loader's worker processes
    give the batches that -j 0 gives."""
    ds = _rhd(tdata, TT, rhd_root, mt=False, split="test")
    batches = [list(tdata.make_loader(ds, 3, num_workers=workers)) for workers in (0, 2)]
    assert len(batches[0]) == 2 and batches[0][1][0].shape == (1, SIZE, SIZE, 3)
    assert_same(*batches)


class _Draws:
    """Items that draw from the worker's seeded ``random``, numpy and torch
    streams."""

    def __len__(self):
        return 7

    def __getitem__(self, i):
        return np.array([i, random.random(), np.random.rand(), torch.rand(()).item()])


@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_starts_no_idle_workers(drop_last):
    """make_loader starts at most one worker a batch of a pass, and its
    batches and draws over two passes are those of a DataLoader with all
    the workers asked for."""
    capped = tdata.make_loader(_Draws(), 3, shuffle=True, num_workers=8, drop_last=drop_last)
    assert capped.num_workers == (2 if drop_last else 3)
    full = torch.utils.data.DataLoader(_Draws(), batch_size=3, shuffle=True, num_workers=8,
                                       drop_last=drop_last, persistent_workers=True,
                                       collate_fn=tdata.default_collate)
    passes = []
    for loader in (capped, full):
        torch.manual_seed(0)
        passes.append([b for _ in range(2) for b in loader])
    assert len(passes[0]) == (4 if drop_last else 6)
    assert_same(*passes)
    assert tdata.make_loader(_Draws(), 3, num_workers=0).num_workers == 0
    assert tdata.make_loader(_Draws(), 8, num_workers=4, drop_last=True).num_workers == 1


def test_forever_iterator(rhd_root):
    ds = _rhd(tdata, TT, rhd_root, mt=False, split="test")
    it = tdata.ForeverDataIterator(tdata.make_loader(ds, 3, drop_last=True))
    assert len(it) == 1
    first = [next(it)[0].shape for _ in range(3)]
    assert first == [(3, SIZE, SIZE, 3)] * 3
    empty = tdata.ForeverDataIterator(tdata.make_loader(ds, 5, drop_last=True))
    with pytest.raises(RuntimeError, match="empty loader"):
        next(empty)


@pytest.mark.parametrize("cls", ["Hand21KeypointDataset", "Body16KeypointDataset"])
def test_group_accuracy_matches_jax(cls):
    accs = list(np.random.RandomState(2).rand(21).astype(np.float32))
    accs[3] = np.float32(-1.0)
    want = getattr(jdata, cls)("root", []).group_accuracy(accs)
    got = getattr(tdata, cls)("root", []).group_accuracy(accs)
    assert_same(want, got)


def test_host_pck_matches_jax():
    rng = np.random.RandomState(0)
    out = rng.randn(4, 5, 16, 16).astype(np.float32)
    tgt = rng.rand(4, 5, 16, 16).astype(np.float32)
    tgt[1, 2] = 0.0  # no ground truth: excluded
    assert_same(jpck.get_max_preds_np(out), tpck.get_max_preds_np(out))
    want, got = jpck.accuracy(out, tgt), tpck.accuracy(out, tgt)
    assert_same(want[0], got[0])
    assert want[1:3] == got[1:3]
    assert_same(want[3], got[3])


def test_download_raises_without_data(tmp_path):
    """The port raises where the JAX package exits with status 0, and never
    fetches: a missing archive raises before any download."""
    with pytest.raises(FileNotFoundError, match="RHD_v1-1.zip"):
        tutil.download(str(tmp_path), "RHD_published_v2", "RHD_v1-1.zip",
                       "https://example.invalid/RHD_v1-1.zip")
    with pytest.raises(FileNotFoundError):
        tutil.check_exits(str(tmp_path), "RHD_published_v2")
    with pytest.raises(FileNotFoundError):
        tdata.RenderedHandPose(str(tmp_path))
    # a present archive is extracted; a present directory is left alone
    (tmp_path / "src" / "RHD_published_v2").mkdir(parents=True)
    (tmp_path / "src" / "RHD_published_v2" / "x.txt").write_text("a\n b \n")
    shutil.make_archive(str(tmp_path / "RHD_v1-1"), "zip", str(tmp_path / "src"))
    tutil.download(str(tmp_path), "RHD_published_v2", "RHD_v1-1.zip", "unused")
    listed = str(tmp_path / "RHD_published_v2" / "x.txt")
    assert tutil.read_list_from_file(listed) == jutil.read_list_from_file(listed) == ["a", "b"]
    tutil.download(str(tmp_path), "RHD_published_v2", "missing.zip", "unused")
    tutil.check_exits(str(tmp_path), "RHD_published_v2")


def test_meter_lines_match_jax(capsys):
    lines = []
    for m in (jmeter, tmeter):
        meters = [m.AverageMeter("Time", ":4.2f"), m.AverageMeter("Data", ":3.1f"),
                  m.AverageMeter("Loss (all)", ":.4e"), m.AverageMeter("Acc (s)", ":3.2f")]
        progress = m.ProgressMeter(500, meters, prefix="Epoch: [3]")
        acc = m.AverageMeterList([0, 1, 2], ":3.2f", ignore_val=-1)
        for i, v in enumerate((0.25, 1.5, 3.125)):
            for meter in meters:
                meter.update(v * (i + 1), 32)
            acc.update([np.float32(v), np.float32(-1), np.float32(0.5)], 32)
            progress.display(i * 7)
        print(acc.average(), str(acc[0]))
        lines.append(capsys.readouterr().out)
    assert lines[0] == lines[1]
    assert "Epoch: [3][  0/500]\tTime 0.25 (0.25)\tData 0.2 (0.2)" in lines[1]


def test_logger_matches_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    seen = []
    for m in (jlogger, tlogger):
        log = m.CompleteLogger(f"logs/{m.__name__.split('.')[0]}/run_pose_resnet101",
                               now="2026-01-02-03_04_05")
        log.set_epoch(2)
        log.write("Epoch: 2 Source: 0.500")
        paths = (log.get_checkpoint_path("best_pt"), log.get_checkpoint_path(),
                 log.get_image_path("x.jpg"), log.visualize_directory)
        log.close()
        test = m.CompleteLogger(f"logs/{m.__name__.split('.')[0]}/t", phase="test",
                                now="2026-01-02-03_04_05")
        paths += (test.get_image_path("y.jpg"), test.get_checkpoint_path())
        test.close()
        root = m.__name__.split(".")[0]
        seen.append([p.replace(root, "PKG") for p in paths])
        text = open(f"logs/{root}/run_pose_resnet101/train-2026-01-02-03_04_05.txt").read()
        seen.append(text.replace(root, "PKG"))
        assert os.path.isdir(f"output_viz/{root}/run_pose_resnet101/visualize/2")
    assert seen[0] == seen[2] and seen[1] == seen[3]
    out = capsys.readouterr().out
    assert out.count("Epoch: 2 Source: 0.500") == 2


@pytest.mark.parametrize("milestones", [[45, 60], ("4", "5"), (2,)])
def test_multistep_lr_matches_jax(milestones):
    for epoch in range(0, 70, 3):
        assert tsched.multistep_lr(1e-4, epoch, milestones, 0.1) == \
            jsched.multistep_lr(1e-4, epoch, milestones, 0.1)
