"""The port's animal trainer with ``--device-aug`` (``python -m
uda_poseestimation_torch.train_animal --device-aug``) on the CPU, and on the
card its graphs' replays.

- ``train_animal.main`` in this process on ``tools/make_fixtures.
  make_animal``'s tree (12 synthetic training frames: one batch of 12 a
  pass) with random style weights, the ``script`` line's flags at 32²/8²,
  ``-j 1``: a pretrain epoch and an adapt epoch, each of 2 iterations (two
  passes) with ``--device-aug --steps-per-dispatch 2 --decode-cache 1``. The
  epoch lines are finite with both category parts; the raw source goes
  through one ``CachedDataset`` whose second pass is all hits; no loader
  worker is left.
- ``--device-aug``'s pipeline from both animal lines of ``script``.
- The unbundled pretrain loop with the animal pipeline: the source views
  built before each step (``prep_source``), the style image the identity
  teacher view, no source keypoint2d for the debug images.
- On the card (``-m gpu``; skipped without one): each gate case's bundled
  replay against the eager step, the views built inside the graph.

This file imports no JAX, so that its card test runs where JAX is not
installed (``--noconftest``).
"""

import copy
import math
import multiprocessing
import os
import re
import shlex
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from tools.make_fixtures import make_animal
from uda_poseestimation_torch import data as tdata
from uda_poseestimation_torch import engine as tengine
from uda_poseestimation_torch import train_animal as ttrain
from uda_poseestimation_torch.data import transforms as TT
from uda_poseestimation_torch.data.util import FLIP_PAIRS
from uda_poseestimation_torch.models import Bottleneck, PoseResNet, ResNet, StyleNet
from uda_poseestimation_torch.ops import device_aug as tda
from uda_poseestimation_torch.ops.occlusion_warp import occlusion_warp
from uda_poseestimation_torch.parallel import create_state
from uda_poseestimation_torch.parallel import train_step as tts

REPO = Path(__file__).resolve().parents[1]
FLAGS = ["--image-size", "64", "--heatmap-size", "16", "--inp-res", "64", "--out-res", "16",
         "-b", "6", "-j", "1", "-a", "pose_resnet50", "-p", "1", "--epochs", "1",
         "--decoder-name", "saved_models/decoder_rand.pth", "--device", "cpu",
         "--device-aug", "--steps-per-dispatch", "2", "--decode-cache", "1", "-i", "4"]
# the CLI drives: 32² and one batch of 12 a pass, so that two iterations
# (one bundle) read each training set twice; on a loaded CPU a step costs
# its many small ops more than its size
CLI_FLAGS = ["--image-size", "32", "--heatmap-size", "8", "--inp-res", "32", "--out-res", "8",
             "-b", "12", "-i", "2"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the Tier-1 run puts six test processes on the
    host's cores (as tests/test_torch_train_animal.py holds them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _script_line(program="train_animal.py"):
    (argv,) = [shlex.split(line)[2:] for line in (REPO / "script").read_text().splitlines()
               if line.startswith(f"python {program} ")]
    return argv


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """make_animal's tree and random style weights in saved_models/ (the
    reference's file layout)."""
    root = tmp_path_factory.mktemp("animal_device_aug_cli")
    make_animal(str(root))
    style = StyleNet()
    style.reset_parameters(torch.Generator().manual_seed(0))
    os.makedirs(root / "saved_models")
    vgg = dict(style.encoder.state_dict())
    vgg["31.weight"], vgg["31.bias"] = torch.ones(512, 512, 3, 3), torch.zeros(512)
    torch.save(vgg, root / "saved_models" / "vgg_normalised.pth")
    torch.save(style.decoder.state_dict(), root / "saved_models" / "decoder_rand.pth")
    return root


@pytest.fixture
def in_tree(tree, monkeypatch):
    monkeypatch.setenv("UDA_CACHED_DATA_DIR", str(tree / "cached_data"))
    monkeypatch.chdir(tree)
    return tree


def _numbers(line):
    return [float(v) for v in re.findall(r"[-+]?\d+\.\d+(?:e[-+]\d+)?", line)]


def _run(tree, monkeypatch, capsys, name, extra):
    """``train_animal.main`` on the tree; returns the step lines it printed,
    the epoch line of its log and the CachedDatasets it made."""
    caches = []

    class Cache(tdata.loader.CachedDataset):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            caches.append(self)

    monkeypatch.setattr(ttrain, "CachedDataset", Cache)
    log = "logs/" + name
    ttrain.main(ttrain.build_parser().parse_args(
        _script_line() + FLAGS + CLI_FLAGS
        + ["--image-path", str(tree / "animal_data"), "--log", log] + extra))
    steps = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("Epoch: [0][")]
    (log_file,) = (tree / (log + "_pose_resnet50")).glob("train-*.txt")
    (epoch,) = [line for line in log_file.read_text().splitlines()
                if line.startswith("Epoch: 0 ")]
    assert " Horse: " in epoch and " Tiger: " in epoch, epoch
    assert all(math.isfinite(v) for v in _numbers(epoch)), epoch
    for line in steps:
        assert all(math.isfinite(v) for v in _numbers(line)), line
    assert not multiprocessing.active_children()
    return steps, caches


def _all_second_pass_hits(caches):
    """One cache, of the raw synthetic source (12 items): each item decoded
    once in the first pass, a hit in the second."""
    (cache,) = caches
    assert isinstance(cache.dataset, tdata.synthetic_animal.Synthetic_Animal_SP_All)
    assert cache.dataset.raw_mode
    n = len(cache)
    assert (cache.items_cached, cache.misses, cache.hits) == (n, n, n) == (12, 12, 12)
    assert 0 < cache.bytes_used <= 1e9


def test_cli_pretrain_epoch_device_aug_bundled(in_tree, monkeypatch, capsys):
    steps, caches = _run(in_tree, monkeypatch, capsys, "pretrain", ["--pretrain-epoch", "1"])
    assert len(steps) == 2 and not any("Loss (c)" in line for line in steps)
    _all_second_pass_hits(caches)


def test_cli_adapt_device_aug_bundled(in_tree, monkeypatch, capsys):
    steps, caches = _run(in_tree, monkeypatch, capsys, "adapt", ["--pretrain-epoch", "-1"])
    assert len(steps) == 2 and all("Loss (c)" in line for line in steps)
    _all_second_pass_hits(caches)


def _raw_batches(root, b=4, k=1):
    """One collated raw source batch (``raw_mode``) and one ``_mt`` target
    batch under --device-aug's transforms, from the tree's datasets."""
    kw = dict(animal="all", image_path=str(root / "animal_data"), inp_res=64, out_res=16,
              sigma=1, scale_factor=0.25, rot_factor=30, label_type="Gaussian",
              train_on_all_cat=True)
    identity = TT.Compose([TT.IdentityAffine(), TT.ToTensor()])
    src = tdata.synthetic_animal_sp_all(is_train=True, raw_mode=True, **kw)
    tgt = tdata.real_animal_all_mt(is_train=True, k=k, transforms_stu=identity,
                                   transforms_tea=identity, **kw)
    return (tdata.default_collate([src[i] for i in range(b)]),
            tdata.default_collate([tgt[i] for i in range(b)]), src)


def _pipeline(src_dataset, device):
    args = ttrain.build_parser().parse_args(_script_line() + FLAGS)
    return ttrain.device_aug_pipeline(args, src_dataset, device)


@pytest.mark.parametrize("program,flip_dataset,k", [("train_animal.py", "real_animal", 18),
                                                     ("train_animal_other.py", "animal_pose", 14)])
@pytest.mark.parametrize("raw", [True, False])
def test_pipeline_from_the_script_lines(program, flip_dataset, k, raw):
    """``--device-aug``'s pipeline for each animal line of ``script``: the
    student's and teachers' affine flags without crop or jitter, the target
    views normalized by ANIMAL_MEAN; a raw source's config from
    ``--inp-res``/``--out-res``/``--sigma``/``--label-type``, its pair swap
    and its mean; a source without a raw mode left on the host."""
    args = ttrain.build_parser().parse_args(_script_line(program) + [
        "--inp-res", "48", "--out-res", "12", "--sigma", "1.5", "--label-type", "Cauchy",
        "--image-size", "48", "--heatmap-size", "12", "--seed", "4", "--device-aug"])
    mean = np.array([0.41, 0.4, 0.38], np.float32)
    source = types.SimpleNamespace(raw_mode=raw, FLIP_DATASET=flip_dataset, num_keypoints=k,
                                   mean=mean)
    pipe = ttrain.device_aug_pipeline(args, source, "cpu")
    for cfg, role in ((pipe.cfg_stu, "stu"), (pipe.cfg_tea, "tea")):
        assert (cfg.rotation, cfg.shear, cfg.translate, cfg.scale) == (
            getattr(args, f"rotation_{role}"), tuple(getattr(args, f"shear_{role}")),
            tuple(getattr(args, f"translate_{role}")), tuple(getattr(args, f"scale_{role}")))
        assert (cfg.image_size, cfg.heatmap_size, cfg.sigma, cfg.use_rrc, cfg.color) == (
            48, 12, 1.5, False, 0.0)
    assert pipe.mean == tuple(ttrain.ANIMAL_MEAN)
    assert pipe.k == args.k and pipe.source_on_device == raw
    assert torch.equal(pipe.generator.get_state(),
                       torch.Generator().manual_seed(4).get_state())
    if raw:
        assert pipe.src_cfg == tda.AnimalSourceAugConfig(inp_res=48, out_res=12, sigma=1.5,
                                                         label_type="Cauchy")
        np.testing.assert_array_equal(pipe.flip_perm.numpy(), tda.flip_perm_from_pairs(
            FLIP_PAIRS[flip_dataset], k))
        assert pipe.src_mean == tuple(mean.tolist())
    else:
        assert pipe.src_cfg is None and pipe.flip_perm is None


def test_unbundled_pretrain_loop_builds_the_source_views(in_tree):
    """The unbundled pretrain loop with the animal pipeline: per iteration
    the raw source on the step's device, its views from ``prep_source``,
    and with s2t fired the identity teacher view as the style image; the
    loop passes no source keypoint2d to the debug images."""
    src, tgt, src_dataset = _raw_batches(in_tree)
    pipe = _pipeline(src_dataset, "cpu")
    assert pipe.source_on_device and not pipe.host_visualizable
    assert pipe.src_cfg.inp_res == 64 and pipe.src_mean == tuple(src_dataset.mean.tolist())
    seen, drawn = [], []

    def step(state, batch, lr, do_s2t, alpha):
        seen.append((do_s2t, {k: tuple(v.shape) for k, v in batch.items()}))
        if do_s2t:
            assert torch.equal(batch["image_t_style"], tgt[4][0])
        return state, {"loss_all": torch.tensor(1.0), "loss_s": torch.tensor(1.0),
                       "acc_s": torch.tensor(0.5), "acc_cnt": torch.tensor(3)}, \
            torch.zeros(4, 18, 16, 16)

    class Targets:
        def __next__(self):
            drawn.append(1)
            return tgt

    args = ttrain.build_parser().parse_args(_script_line() + FLAGS + ["-i", "4", "-p", "1"])
    np.random.seed(6)  # s2t fires in iterations 1 and 2 of 0-3
    tengine.run_pretrain_epoch(None, step, iter([src] * 4), Targets(), 0, 1e-4, args,
                               visualize=lambda *a: pytest.fail("no debug image"),
                               style_enabled=True, device_aug=pipe)
    fired = [s for s, _ in seen]
    assert fired == [False, True, True, False] and len(drawn) == 2
    for do_s2t, shapes in seen:
        assert shapes["image_s"] == (4, 64, 64, 3) and shapes["target_s"] == (4, 18, 16, 16)
        assert shapes["image_t_style"] == (4, 64, 64, 3)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_animal_device_aug_replays_match_eager_steps_on_card(cuda, tree):
    """The animal views built inside each gate case's graph replay equal
    the eager step's: the occluded student view, the teacher's
    reconstruction and the occlusion, bit for bit, under deterministic
    cuDNN; one occlusion_warp launch per replay."""
    os.environ.setdefault("UDA_CACHED_DATA_DIR", str(tree / "cached_data"))
    src, tgt, src_dataset = _raw_batches(tree)
    pipe = _pipeline(src_dataset, cuda)
    batch = {k: v.pin_memory() for k, v in pipe.raw_adapt_batch(src, tgt).items()}
    cfg = tts.StepConfig(image_size=64, heatmap_size=16, sigma=1.0, k=1, occlude_rate=0.5,
                         occlude_thresh=-1.0, occlude_size=6, aux_outputs=True,
                         recover_min=ttrain.RECOVER_MIN, recover_max=ttrain.RECOVER_MAX,
                         gather_exact=False, style_io_dtype="bfloat16")
    style = StyleNet()
    style.reset_parameters(torch.Generator().manual_seed(1))
    style.to(cuda)
    state = create_state(PoseResNet(ResNet(Bottleneck, (1, 1, 1, 1)), 18), cfg, seed=0,
                         device=cuda)
    bundler = tts.AdaptStepBundler(cfg, style, cuda, view_builder=pipe.view_builder)
    step = tts.make_adapt_step(cfg, style, cuda, view_builder=pipe.view_builder)
    gen = torch.Generator(device=cuda).manual_seed(0)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for s, t in ((True, True), (False, False)):
            bundler(state, [batch], 1e-3, [s], [0.6], [t], [0.3], generator=gen)
            twin = copy.deepcopy(state)
            twin_gen = torch.Generator(device=cuda)
            twin_gen.set_state(gen.get_state())
            ow0 = occlusion_warp.launches
            _, got, _ = bundler(state, [batch], 1e-3, [s], [0.6], [t], [0.3], generator=gen)
            assert occlusion_warp.launches == ow0 + 1
            _, want, _ = step(twin, batch, 1e-3, s, 0.6, t, 0.3, generator=twin_gen)
            for k in ("occlude", "occlusion_rect", "x_t_stu_final", "y_t_tea_recon"):
                assert torch.equal(got["aux"][k][0], want["aux"][k]), (s, t, k)
    assert bundler.replays == 2
