"""The port's trainer CLI (``python -m uda_poseestimation_torch.train_human``)
against the repository's ``train_human.py`` (the JAX package's trainer).

- The parser: every option of the JAX parser exists in the port's with the
  same option strings, destination, default, type, nargs and action; the
  port adds only ``--device``, and its ``-a`` choices are the JAX
  parser's (both registries' lowercase callables). Every ``train_human.py``
  line of ``script`` parses to the same namespace in both.
- The ``--dist-*`` wiring at start: ``--dist-num-processes`` or
  ``--dist-process-id`` without ``--dist-coordinator`` run one process, as
  in JAX; a global batch that the processes do not divide raises before
  joining; a missing ``--seed`` warns and uses 0 (a group of one process
  through a rendezvous file). Without a card and without ``--device cpu``
  the CLI raises before it writes anything. (Two ranks run in
  ``tests/test_torch_train_distributed.py``.)
- ``--decoder-name`` reads the reference's torch files as the JAX package's
  ``load_style_net_params`` does: the same weights.
- The four ``script`` pairs (f2r, s2h, s2l, r2h): every dataset name of
  their lines and every human name of the JAX registry resolves in the
  port's; ``build_data`` on each line, its roots pointed at tiny trees
  (``tests/test_torch_human_datasets.py``'s), gives a source and a target
  batch, and one pretrain and one adapt step of a small PoseResNet with the
  source's keypoint count run on the CPU; r2h also runs as ``python -m``
  for one adapt epoch (the other pairs validate on 2000 or 3200 fixed
  items, which the card's run covers).
- CPU drives on a tiny fake-RHD tree (``tools/make_fixtures.make_rhd``,
  8 training and 4 evaluation frames) with random style weights: one
  pretrain epoch through ``python -m``; an adapt epoch from a checkpoint
  that the test writes with the port's ``save_checkpoint``, named by
  ``--pretrain`` or put where the ``best_pt`` reload of epoch
  ``--pretrain-epoch`` looks for it; ``--phase test --resume`` on the same
  file, which the JAX package also reads. No run depends on what a
  random-init student scores: the ``acc > best`` rule writes no checkpoint
  at target PCK 0.

Tolerance: none; parsed values and loaded weights are compared for
equality, the drive for finite logged values.
"""

import functools
import math
import os
import random
import re
import shlex
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import train_human as jtrain
import uda_poseestimation_tpu.data as jdata
import uda_poseestimation_torch.data as tdata
from test_torch_human_datasets import (  # noqa: F401 (fixtures)
    freihand_root,
    h3d_root,
    h36m_root,
    lsp_root,
    surreal_root,
)
from tools.make_fixtures import make_rhd
from tools.port_torch_weights import load_style_net_params
from uda_poseestimation_tpu.utils import checkpoint as jckpt
from uda_poseestimation_torch import engine as tengine
from uda_poseestimation_torch import train_human as ttrain
from uda_poseestimation_torch import models, weights
from uda_poseestimation_torch.models import Bottleneck, PoseResNet, ResNet, StyleNet
from uda_poseestimation_torch.parallel import StepConfig, create_state, make_adapt_step, \
    make_pretrain_step
from uda_poseestimation_torch.parallel import distributed as dist
from uda_poseestimation_torch.utils import CompleteLogger
from uda_poseestimation_torch.utils import checkpoint as tckpt

REPO = Path(__file__).resolve().parents[1]
FIXTURE_ARGS = ["rhd", "rhd", "-s", "RenderedHandPose", "-t", "RenderedHandPose",
                "--target-train", "RenderedHandPose_mt", "-a", "pose_resnet50",
                "--image-size", "64", "--heatmap-size", "16", "-b", "4",
                "--test-batch", "4", "--seed", "12", "-p", "1",
                "--decoder-name", "saved_models/decoder_rand.pth"]


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax():
    jact, tact = _actions(jtrain.build_parser()), _actions(ttrain.build_parser())
    assert set(tact) - set(jact) == {"device"} and set(jact) <= set(tact)
    for dest, j in jact.items():
        t = tact[dest]
        assert (t.option_strings, t.default, t.type, t.nargs, t.const, type(t)) == \
            (j.option_strings, j.default, j.type, j.nargs, j.const, type(j)), dest
        assert t.choices == j.choices, dest
    assert {"pose_resnet101", "pose_resnet50", "resnext50_32x4d"} <= set(tact["arch"].choices)
    assert tact["device"].option_strings == ["--device"] and tact["device"].default is None


def _script_lines():
    lines = [shlex.split(line) for line in (REPO / "script").read_text().splitlines()
             if line.startswith("python train_human.py")]
    assert len(lines) == 4
    return [argv[2:] for argv in lines]


@pytest.mark.parametrize("index", range(4))
def test_script_lines_parse_alike(index):
    argv = _script_lines()[index]
    want = vars(jtrain.build_parser().parse_args(argv))
    got = vars(ttrain.build_parser().parse_args(argv))
    assert got.pop("device") is None
    assert got == want
    assert got["lambda_t"] == 0.0 and got["decoder_name"].startswith("saved_models/")


def _seen_by_train(monkeypatch, module):
    """Replace ``module._train`` by a recorder of what it would run with."""
    seen = {}

    def record(args, device, logger, *_):
        seen.update(group=dist.process_count() if dist.is_active() else None,
                    device=str(device), file_output=logger.file_output, seed=args.seed)

    monkeypatch.setattr(module, "_train", record)
    return seen


@pytest.mark.parametrize("flags", [["--dist-num-processes", "2"],
                                   ["--dist-process-id", "1"]])
def test_dist_flags_without_coordinator_run_one_process(tmp_path, monkeypatch, flags):
    monkeypatch.chdir(tmp_path)
    seen = _seen_by_train(monkeypatch, ttrain)
    ttrain.main(ttrain.build_parser().parse_args(FIXTURE_ARGS + ["--device", "cpu"] + flags))
    assert seen == {"group": None, "device": "cpu", "file_output": True, "seed": 12}
    assert not dist.is_active()


def test_dist_batch_not_divisible_raises(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = ttrain.build_parser().parse_args(
        FIXTURE_ARGS + ["--device", "cpu", "-b", "5", "--dist-coordinator",
                        f"file://{tmp_path}/rendezvous", "--dist-num-processes", "2"])
    with pytest.raises(ValueError, match="global batch 5 not divisible by 2 processes"):
        ttrain.main(args)
    assert os.listdir(tmp_path) == [] and not dist.is_active()


def test_dist_without_seed_warns_and_uses_0(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    seen = _seen_by_train(monkeypatch, ttrain)
    argv = [a for a in FIXTURE_ARGS if a not in ("--seed", "12")]
    args = ttrain.build_parser().parse_args(
        argv + ["--device", "cpu", "--dist-coordinator", f"file://{tmp_path}/rendezvous",
                "--dist-num-processes", "1"])
    with pytest.warns(UserWarning, match="requires a seed.*using --seed 0"):
        ttrain.main(args)
    assert seen == {"group": 1, "device": "cpu", "file_output": True, "seed": 0}
    assert not dist.is_active()  # left at the end


def test_cli_needs_a_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ttrain.main(ttrain.build_parser().parse_args(FIXTURE_ARGS))
    assert os.listdir(tmp_path) == []


def _write_style_weights(out_dir):
    """Random-init style weights in the reference's torch format: the
    Sequential-index state dicts of vgg_normalised and of the decoder, the
    vgg file with one more layer than the encoder takes, as the released
    vgg_normalised.pth has."""
    style = StyleNet()
    style.reset_parameters(torch.Generator().manual_seed(0))
    os.makedirs(out_dir, exist_ok=True)
    vgg = dict(style.encoder.state_dict())
    vgg["31.weight"], vgg["31.bias"] = torch.ones(512, 512, 3, 3), torch.zeros(512)
    torch.save(vgg, os.path.join(out_dir, "vgg_normalised.pth"))
    torch.save(style.decoder.state_dict(), os.path.join(out_dir, "decoder_rand.pth"))
    return style


def test_style_files_load_as_in_jax(tmp_path):
    written = _write_style_weights(str(tmp_path))
    vgg, dec = str(tmp_path / "vgg_normalised.pth"), str(tmp_path / "decoder_rand.pth")
    got = weights.load_style_net_files(StyleNet(), vgg, dec).state_dict()
    want = weights.load_style_net(StyleNet(), load_style_net_params(vgg, dec)).state_dict()
    assert list(got) == list(want) == list(written.state_dict())
    for k, v in written.state_dict().items():
        assert torch.equal(got[k], v) and torch.equal(want[k], v), k
    torch.save({"0.weight": torch.zeros(3, 3, 1, 1)}, str(tmp_path / "short.pth"))
    with pytest.raises(KeyError, match="no value for"):
        weights.load_style_net_files(StyleNet(), vgg, str(tmp_path / "short.pth"))


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    """The fake RHD tree and the random style weights, in one directory
    that the CLI runs from."""
    run = tmp_path_factory.mktemp("cli")
    make_rhd(str(run / "rhd"), n_train=8, n_eval=4)
    _write_style_weights(str(run / "saved_models"))
    return run


@pytest.fixture(scope="module")
def drive(fixture_root):
    """The CPU drive: one pretrain epoch as ``python -m
    uda_poseestimation_torch.train_human``; returns the run directory, the
    log text and the standard output (the ``ProgressMeter`` lines are
    printed, not logged, as in the reference)."""
    run = fixture_root
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "uda_poseestimation_torch.train_human", *FIXTURE_ARGS,
         "--device", "cpu", "--epochs", "1", "--pretrain-epoch", "1", "-i", "2",
         "--log", "logs/drive"],
        cwd=run, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    (log,) = (run / "logs" / "drive_pose_resnet50").glob("train-*.txt")
    return run, log.read_text(), proc.stdout


@pytest.fixture(scope="module")
def pretrained(fixture_root):
    """A checkpoint that the port's ``save_checkpoint`` writes: a
    pose_resnet50 student and teacher initialized from seed 3 (the CLI's own
    init uses ``--seed 12``, so a restored state is told apart)."""
    state = create_state(models.pose_resnet50(num_keypoints=21, dtype=torch.bfloat16),
                         StepConfig(image_size=64, heatmap_size=16), seed=3, device="cpu")
    path = fixture_root / "pretrained.pth"
    tckpt.save_checkpoint(str(path), {"student": state.student, "teacher": state.teacher,
                                      "epoch": 0, "args": {"arch": "pose_resnet50"}})
    return path


def _numbers(line):
    return [float(v) for v in re.findall(r"[-+]?\d+\.\d+(?:e[-+]\d+)?", line)]


def _epoch_lines(text):
    return [line for line in text.splitlines()
            if line.startswith("Epoch: ") and "Target(best)" in line]


def test_cli_drive_on_cpu(drive):
    run, text, stdout = drive
    lines = text.splitlines()
    first = lines.index("Source train: 2")
    assert lines[first:first + 4] == ["Source train: 2", "Target train: 2", "Source test: 1",
                                      "Target test: 1"]
    epochs = _epoch_lines(text)
    assert [line.split()[1] for line in epochs] == ["0"]
    pretrain = [line for line in stdout.splitlines() if line.startswith("Epoch: [0][")]
    assert len(pretrain) == 2 and not any("Loss (c)" in line for line in pretrain)
    for line in epochs + pretrain:
        assert all(math.isfinite(v) for v in _numbers(line)), line
    for name in ("MCP", "PIP", "DIP", "fingertip", "all"):
        assert sum(line.startswith(name + ": ") for line in lines) == 1, name


@pytest.mark.parametrize("given", ["--pretrain", "best_pt"])
def test_cli_adapts_from_the_pretrained_student(fixture_root, pretrained, given, monkeypatch,
                                                capsys):
    """An adapt epoch that starts from a pretrained student: one that
    ``--pretrain`` names (with ``--pretrain-epoch -1``), or the ``best_pt``
    that the epoch ``--pretrain-epoch`` reloads from the run's checkpoint
    directory (``--pretrain-epoch 0``: the file is put where the pretrain
    epochs would have saved it). Either way the student and the teacher
    equal the file's student once it is restored."""
    monkeypatch.chdir(fixture_root)
    log = "logs/adapt_" + given.strip("-")
    loaded, restored = [], []

    def load(path):
        loaded.append(str(path))
        return tckpt.load_checkpoint(path)

    def restore(state, checkpoint, **kw):
        out = tckpt.restore_train_state(state, checkpoint, **kw)
        restored.append((kw, all(
            torch.equal(module.state_dict()[k], v) for module in (state.student, state.teacher)
            for k, v in checkpoint["student"].items())))
        return out

    monkeypatch.setattr(ttrain, "restore_train_state", restore)
    monkeypatch.setattr(ttrain, "load_checkpoint", load)
    monkeypatch.setattr(ttrain, "CompleteLogger", functools.partial(CompleteLogger, now="fixed"))
    if given == "--pretrain":
        extra, want = ["--pretrain", str(pretrained), "--pretrain-epoch", "-1"], str(pretrained)
    else:
        # the run's checkpoint directory (CompleteLogger), relative to its cwd
        want = "checkpoints/adapt_best_pt_pose_resnet50/checkpoints_fixed/best_pt.pth"
        os.makedirs(os.path.dirname(want))
        os.link(pretrained, want)
        extra = ["--pretrain-epoch", "0"]
    ttrain.main(ttrain.build_parser().parse_args(
        FIXTURE_ARGS + ["--device", "cpu", "--epochs", "1", "-i", "2", "--log", log] + extra))
    assert loaded == [want] and restored == [({"teacher_source": "student"}, True)]
    adapt = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("Epoch: [0][")]
    assert len(adapt) == 2 and all("Loss (c)" in line for line in adapt)
    epochs = _epoch_lines((fixture_root / f"{log}_pose_resnet50" / "train-fixed.txt").read_text())
    assert [line.split()[1] for line in epochs] == ["0"]
    for line in epochs + adapt:
        assert all(math.isfinite(v) for v in _numbers(line)), line


def test_cli_test_phase_resumes_its_checkpoint(fixture_root, pretrained, monkeypatch):
    """``--phase test --resume`` on a checkpoint that the port's
    ``save_checkpoint`` wrote, in this process; the JAX package's loader
    reads the same file."""
    ckpt = tckpt.load_checkpoint(str(pretrained))
    assert ckpt["format"] == "uda_poseestimation_torch" and ckpt["epoch"] == 0
    assert jckpt.load_checkpoint(str(pretrained))["epoch"] == 0
    monkeypatch.chdir(fixture_root)
    ttrain.main(ttrain.build_parser().parse_args(
        FIXTURE_ARGS + ["--device", "cpu", "--phase", "test", "--resume", str(pretrained),
                        "--log", "logs/test"]))
    (log,) = (fixture_root / "logs" / "test_pose_resnet50").glob("test-*.txt")
    lines = log.read_text().splitlines()
    result = [line for line in lines if line.startswith("Source: ")]
    assert len(result) == 1 and all(math.isfinite(v) for v in _numbers(result[0]))
    assert lines[-1].startswith("all: ")
    assert np.isfinite(float(lines[-1].split()[1]))


PAIRS = ("f2r", "s2h", "s2l", "r2h")  # script's train_human.py lines, in order
# the pair runs' sizes: small images and batches, in-process loading, the CPU
SMALL = ["--image-size", "64", "--heatmap-size", "16", "-b", "4", "--test-batch", "4",
         "-j", "0", "--device", "cpu"]


def test_every_human_dataset_name_resolves():
    names = {getattr(args, key) for args in map(ttrain.build_parser().parse_args,
                                                _script_lines())
             for key in ("source", "target", "target_train")}
    assert names == {"FreiHand", "RenderedHandPose", "RenderedHandPose_mt", "SURREAL",
                     "Human36M", "Human36M_mt", "LSP", "LSP_mt", "Hand3DStudio",
                     "Hand3DStudio_mt"}
    # the JAX registry's human datasets: its hand and body keypoint datasets
    human = {name for name in jdata.__all__ if not name.endswith("KeypointDataset")
             and isinstance(getattr(jdata, name), type)
             and issubclass(getattr(jdata, name), (jdata.Body16KeypointDataset,
                                                   jdata.Hand21KeypointDataset))}
    assert names | {"Hand3DStudioAll", "Hand3DStudioAll_mt"} == human
    for name in human:
        cls = tdata.__dict__[name]
        assert cls.__module__.startswith("uda_poseestimation_torch.data."), name
        assert issubclass(cls, torch.utils.data.Dataset), name


@pytest.fixture(scope="module")
def pair_roots(fixture_root, freihand_root, surreal_root, lsp_root, h36m_root, h3d_root):
    """Each dataset name's tree."""
    return {"FreiHand": freihand_root, "RenderedHandPose": str(fixture_root / "rhd"),
            "SURREAL": surreal_root, "Human36M": h36m_root, "LSP": lsp_root,
            "Hand3DStudio": h3d_root}


def _pair_args(pair, roots, extra=()):
    args = ttrain.build_parser().parse_args(_script_lines()[PAIRS.index(pair)] + SMALL
                                            + list(extra))
    args.source_root, args.target_root = roots[args.source], roots[args.target]
    return args


@pytest.mark.parametrize("pair", PAIRS)
def test_script_pair_steps_on_cpu(pair, pair_roots):
    """``build_data`` on the pair's line gives its four loaders; one source
    and one target batch feed a pretrain and an adapt step of a small
    PoseResNet with the source's keypoint count."""
    args = _pair_args(pair, pair_roots)
    random.seed(0)
    np.random.seed(0)
    torch.manual_seed(0)
    data = ttrain.build_data(args, pin=False)
    num_keypoints = data.train_source_dataset.num_keypoints
    assert num_keypoints == {"f2r": 21, "s2h": 16, "s2l": 16, "r2h": 21}[pair]
    assert data.val_target_loader.dataset.num_keypoints == num_keypoints
    src = next(iter(data.train_source_loader))
    tgt = next(iter(data.train_target_loader))
    assert src[0].shape == (4, 64, 64, 3) and src[1].shape == (4, num_keypoints, 16, 16)
    assert tgt[4][0].shape == (4, 64, 64, 3) and tgt[3]["aug_param_stu"].shape == (4, 6)

    cfg = StepConfig(image_size=64, heatmap_size=16, k=args.k, mask_ratio=args.mask_ratio,
                     occlude_rate=args.occlude_rate, occlude_thresh=args.occlude_thresh,
                     aux_outputs=True)
    state = create_state(PoseResNet(ResNet(Bottleneck, (1, 1, 1, 1)), num_keypoints), cfg,
                         seed=0, device="cpu")
    state, metrics, y_s = make_pretrain_step(cfg, device="cpu")(
        state, tengine.make_source_batch(*src[:3]), 1e-4)
    assert y_s.shape == (4, num_keypoints, 16, 16)
    assert all(math.isfinite(float(metrics[k])) for k in ("loss_all", "acc_s"))
    state, metrics, y_s = make_adapt_step(cfg, device="cpu")(
        state, tengine.make_adapt_batch(src, tgt), 1e-4,
        generator=torch.Generator().manual_seed(0))
    assert all(math.isfinite(float(metrics[k])) for k in ("loss_all", "loss_s", "loss_c"))
    aux = metrics["aux"]
    assert aux["y_t_tea_recon"].shape == aux["y_t_stu_recon"].shape == (4, num_keypoints,
                                                                       16, 16)
    assert aux["activates"].shape == aux["tea_mask"].shape == (4, num_keypoints)


def test_r2h_cli_drive_on_cpu(fixture_root, pair_roots):
    """The r2h line as ``python -m``, one adapt epoch of one iteration at
    small sizes with random style weights; the log's epoch line and the H3D
    target's group lines are finite."""
    args = _pair_args("r2h", pair_roots)
    argv = [args.source_root, args.target_root] + _script_lines()[PAIRS.index("r2h")][2:] + \
        SMALL + ["-a", "pose_resnet50", "--epochs", "1", "--pretrain-epoch", "-1", "-i", "1",
                 "-p", "1", "--decoder-name", "saved_models/decoder_rand.pth",
                 "--log", "logs/r2h"]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", "uda_poseestimation_torch.train_human", *argv],
                          cwd=fixture_root, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    (log,) = (fixture_root / "logs" / "r2h_pose_resnet50").glob("train-*.txt")
    lines = log.read_text().splitlines()
    (flags,) = [line for line in lines if line.startswith("source_root=")]
    assert "source=RenderedHandPose " in flags and "target=Hand3DStudio " in flags
    assert lines[lines.index("Source train: 2") + 3] == "Target test: 1"
    epochs = _epoch_lines("\n".join(lines))
    adapt = [line for line in proc.stdout.splitlines() if line.startswith("Epoch: [0][")]
    assert len(epochs) == 1 and len(adapt) == 1 and "Loss (c)" in adapt[0]
    for line in epochs + adapt:
        assert all(math.isfinite(v) for v in _numbers(line)), line
    for name in ("MCP", "PIP", "DIP", "fingertip", "all"):
        assert sum(line.startswith(name + ": ") for line in lines) == 1, name


@pytest.mark.parametrize("spd", [1, 2])
def test_cli_device_aug_drive_on_cpu(fixture_root, spd, monkeypatch, capsys):
    """``--device-aug --decode-cache 1`` with two forked loader workers: a
    pretrain epoch, then an adapt epoch from its ``best_pt`` (the
    validation's result is raised a little at each call, so that the
    pretrain epoch writes one), unbundled and with ``--steps-per-dispatch
    2``. The views come from the device pipeline (no host augmentation),
    both training sets are cached, and from the second pass on their items
    come from the cache."""
    monkeypatch.chdir(fixture_root)
    log = f"logs/device_aug_{spd}"
    caches, pipes = [], []

    class Cache(ttrain.CachedDataset):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            caches.append(self)

    class Pipeline(ttrain.DeviceAugPipeline):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            pipes.append(self)

    real_validate, calls = ttrain.run_validate, []

    def validate(*args, **kwargs):
        calls.append(1)
        return {k: v + len(calls) for k, v in real_validate(*args, **kwargs).items()}

    monkeypatch.setattr(ttrain, "CachedDataset", Cache)
    monkeypatch.setattr(ttrain, "DeviceAugPipeline", Pipeline)
    monkeypatch.setattr(ttrain, "run_validate", validate)
    monkeypatch.setattr(ttrain, "CompleteLogger", functools.partial(CompleteLogger, now="fixed"))
    ttrain.main(ttrain.build_parser().parse_args(
        FIXTURE_ARGS + ["--device", "cpu", "--epochs", "2", "--pretrain-epoch", "1", "-i", "3",
                        "-j", "2", "--device-aug", "--decode-cache", "1",
                        "--steps-per-dispatch", str(spd), "--log", log]))
    out = capsys.readouterr().out.splitlines()
    for epoch, loss_c in ((0, False), (1, True)):
        lines = [ln for ln in out if ln.startswith(f"Epoch: [{epoch}][")]
        assert len(lines) == 3 and all(("Loss (c)" in ln) == loss_c for ln in lines)
        for ln in lines:
            assert all(math.isfinite(v) for v in _numbers(ln)), ln
    epochs = _epoch_lines((fixture_root / f"{log}_pose_resnet50" / "train-fixed.txt")
                          .read_text())
    assert [line.split()[1] for line in epochs] == ["0", "1"]
    assert len(pipes) == 1 and len(caches) == 2
    # 8 frames, 2 batches a pass: both sets are past their first pass
    assert all(c.items_cached == 8 and c.hits > 0 for c in caches)
    ckpt_dir = fixture_root / "checkpoints" / f"device_aug_{spd}_pose_resnet50" / \
        "checkpoints_fixed"
    for name in ("best_pt", "best"):
        os.remove(ckpt_dir / f"{name}.pth")  # ~0.5 GB each
