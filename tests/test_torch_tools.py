"""The port's learning-evidence tools (``uda_poseestimation_torch/tools/``)
against the repository's ``tools/`` and ``tests/test_convergence.py``.

- ``fixtures.make_rhd`` writes the same bytes as ``tools/make_fixtures.
  make_rhd`` (PNG frames and annotation pickles) for the clean, shifted
  and hard-shifted trees; ``make_style_weights`` writes files that the
  trainer's ``--decoder-name`` loader reads.
- ``convergence.make_blob_batch`` equals the JAX recipe's on the same seed
  (images bit-equal, targets within 1e-6), and the recipe's three-stage
  PoseResNet maps 64² images to 32² heatmaps.
- ``run_benchmarks``: each of the six commands equals the JAX harness's,
  argument for argument after the trainer, and parses through the port's
  trainer parser; the twins of ``tests/test_run_benchmarks.py``'s fast
  cases (dry run, ``--root``, log parsing, table), and the animal
  trainers' epoch line, which the JAX pattern does not read.
- ``run_gain_drive``: the parser on the JAX test's canned logs, and the
  margin check on logs that meet it, miss it and hold no epoch line.
- The StyleNet's ``ReflectionPad1`` (deterministic on the card, which the
  style recipe needs) equals ``nn.ReflectionPad2d(1)``.

No training loop runs here (``tests/test_torch_convergence.py``, marked
slow, runs the recipe). Tolerance: equality, targets 1e-6.
"""

import filecmp
import os
import sys

import numpy as np
import pytest
import torch

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS_DIR)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tools import make_fixtures as jax_fixtures  # noqa: E402
from tools import run_benchmarks as jax_rb  # noqa: E402
from uda_poseestimation_torch.tools import convergence  # noqa: E402
from uda_poseestimation_torch.tools import fixtures  # noqa: E402
from uda_poseestimation_torch.tools import run_benchmarks as rb  # noqa: E402
from uda_poseestimation_torch.tools import run_gain_drive as gd  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the Tier-1 run puts six test processes on the
    host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.mark.parametrize("shift", [False, True, "hard"], ids=["rhd", "rhd_shifted",
                                                             "rhd_shifted_hard"])
def test_make_rhd_writes_the_jax_bytes(tmp_path, shift):
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    fixtures.make_rhd(str(ours), n_train=2, n_eval=1, size=128, shift=shift)
    jax_fixtures.make_rhd(str(theirs), n_train=2, n_eval=1, size=128, shift=shift)
    files = _tree(ours)
    assert files == _tree(theirs)
    assert sum(f.endswith(".png") for f in files) == 3
    assert sum(f.endswith(".pickle") for f in files) == 2
    for f in files:
        assert filecmp.cmp(ours / f, theirs / f, shallow=False), f


def test_fixtures_cli_kinds(tmp_path):
    fixtures.main(["style", str(tmp_path / "saved_models")])
    from uda_poseestimation_torch.models import StyleNet
    from uda_poseestimation_torch.weights import load_style_net_files

    net = load_style_net_files(StyleNet(), str(tmp_path / "saved_models/vgg_normalised.pth"),
                               str(tmp_path / "saved_models/decoder_rand.pth"))
    want = StyleNet()
    want.reset_parameters(torch.Generator().manual_seed(fixtures.STYLE_SEED))
    for (k, v), (k2, v2) in zip(net.state_dict().items(), want.state_dict().items()):
        assert k == k2 and torch.equal(v, v2), k
    with pytest.raises(SystemExit):
        fixtures.main(["rhd"])  # needs DIR
    with pytest.raises(SystemExit):
        fixtures.main(["animal"])  # needs DIR
    with pytest.raises(SystemExit, match="unknown fixture kind"):
        fixtures.main(["horse", str(tmp_path)])


@pytest.mark.parametrize("shift", [False, True])
def test_make_blob_batch_matches_jax(shift):
    import test_convergence as jax_conv

    kp = None
    if shift:  # the target batch reuses the source's keypoints
        kp = np.random.RandomState(3).uniform(10, 54, (4, 4, 2)).astype(np.float32)
    got = convergence.make_blob_batch(np.random.RandomState(0), shift=shift, kp=kp)
    want = jax_conv.make_blob_batch(np.random.RandomState(0), shift=shift, kp=kp)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], np.asarray(want[2]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[3], np.asarray(want[3]))
    np.testing.assert_array_equal(convergence.identity_aug(), jax_conv.identity_aug())
    assert (convergence.SIZE, convergence.HM, convergence.B, convergence.K,
            convergence.SIGMA) == (jax_conv.SIZE, jax_conv.HM, jax_conv.B, jax_conv.K,
                                   jax_conv.SIGMA)


def test_recipe_model_maps_to_heatmaps():
    """A three-stage BasicBlock backbone (256 channels out, not 512) under
    the deconv head: 64² images to 32² heatmaps of the recipe's 4
    keypoints."""
    model = convergence.make_model()
    assert model.backbone.out_features == 256
    model.reset_parameters(torch.Generator().manual_seed(0))
    y = model(torch.zeros(2, 3, convergence.SIZE, convergence.SIZE))
    assert y.shape == (2, convergence.K, convergence.HM, convergence.HM)


_TRAINERS = {"train_human.py": "uda_poseestimation_torch.train_human",
             "train_animal.py": "uda_poseestimation_torch.train_animal",
             "train_animal_other.py": "uda_poseestimation_torch.train_animal_other"}


@pytest.mark.parametrize("name", list(jax_rb.BENCHMARKS))
def test_commands_match_jax_after_the_trainer(name):
    extra = ["--epochs", "2", "--device-aug"]
    ours = rb.build_command(rb.BENCHMARKS[name], "/data", "logs/bench", extra)
    theirs = jax_rb.build_command(name, jax_rb.BENCHMARKS[name], "/data", "logs/bench",
                                  extra)
    assert ours[1:3] == ["-m", _TRAINERS[jax_rb.BENCHMARKS[name]["trainer"]]]
    assert ours[3:] == theirs[2:]


def test_all_canonical_commands_parse():
    from uda_poseestimation_torch import train_animal, train_human

    for spec in rb.BENCHMARKS.values():
        argv = rb.build_command(spec, "/data", "logs/bench", [])[3:]
        parser = (train_human if spec["trainer"].endswith("train_human")
                  else train_animal).build_parser()
        args = parser.parse_args(argv)
        assert args.pretrain_epoch == 40 and args.batch_size == 32
        assert args.s2t_freq == 0.5 and args.occlude_thresh == 0.9
        assert args.device is None  # the card


def test_dry_run_prints_all_six(capsys, tmp_path):
    results = rb.main(["--data-root", "/data", "--dry-run",
                       "--log-root", str(tmp_path / "logs")])
    out = capsys.readouterr().out
    assert set(results) == set(rb.BENCHMARKS) == set(jax_rb.BENCHMARKS)
    assert all(v == "DRY-RUN" for v in results.values())
    for name in rb.BENCHMARKS:
        assert f"[{name}]" in out
    assert "| benchmark | target 'all' PCK@0.05 |" in out
    assert not (tmp_path / "logs").exists()


def test_root_override_rewrites_path(capsys, tmp_path):
    rb.main(["--data-root", "/data", "--dry-run", "--only", "RHD2H3D",
             "--root", "RHD=/elsewhere/rhd", "--log-root", str(tmp_path / "logs")])
    out = capsys.readouterr().out
    assert "/elsewhere/rhd" in out and "/data/RHD " not in out
    with pytest.raises(SystemExit):
        rb.main(["--data-root", "/data", "--dry-run", "--only", "NOPE"])


def test_parse_result_extracts_best_pck(tmp_path):
    log_root = tmp_path / "x_pose_resnet101"
    log_root.mkdir()
    (log_root / "train-2026.txt").write_text(
        "Epoch: 0 Source: 0.500 Target: 0.100 Target(best): 0.100\n"
        "all: 0.100\nhead: 0.200\n"
        "Epoch: 1 Source: 0.600 Target: 0.300 Target(best): 0.300\n"
        "all: 0.300\nhead: 0.400\n"
        "Epoch: 2 Source: 0.650 Target: 0.250 Target(best): 0.300\n"
        "all: 0.250\nhead: 0.350\n")
    res = rb.parse_result(str(tmp_path / "x"))
    assert res == jax_rb.parse_result(str(tmp_path / "x"))
    assert res["best_target_all_pck"] == 0.300
    assert res["epochs_seen"] == 3
    assert res["final_groups"] == {"all": 0.250, "head": 0.350}


def test_parse_result_reads_the_animal_report(tmp_path):
    """The animal trainers print each category's PCK before Target(best),
    then Source:/Target:/<Category>: blocks (train_animal.py's report); the
    JAX pattern finds no epoch there."""
    log_root = tmp_path / "a_pose_resnet101"
    log_root.mkdir()
    text = ""
    for epoch, tgt, best in ((0, 0.2, 0.2), (1, 0.15, 0.2)):
        text += (f"Epoch: {epoch} Source: 0.500 Target: {tgt:4.3f} Horse: 0.300 "
                 f"Tiger: 0.100 Target(best): {best:4.3f}\n"
                 "Source:\nall: 0.500\nhead: 0.600\n"
                 f"Target:\nall: {tgt:4.3f}\nhead: 0.250\n"
                 "Horse:\nall: 0.300\nTiger:\nall: 0.100\n")
    (log_root / "train-2026.txt").write_text(text)
    assert jax_rb.parse_result(str(tmp_path / "a")) is None
    res = rb.parse_result(str(tmp_path / "a"))
    assert res["best_target_all_pck"] == 0.2 and res["epochs_seen"] == 2
    assert res["final_groups"] == {"all": 0.15, "head": 0.25}
    assert gd.parse_curve(str(log_root)) == [(0, 0.5, 0.2), (1, 0.5, 0.15)]


def test_parse_result_missing_log():
    assert rb.parse_result("/nonexistent/zzz") is None


def test_render_table_placeholders():
    results = {"RHD2H3D": {"best_target_all_pck": 0.5, "epochs_seen": 1,
                           "final_groups": {}, "log": "x"},
               "SURREAL2LSP": "FAILED (rc=1)"}
    table = rb.render_table(results)
    assert table == jax_rb.render_table(results)
    assert "0.500" in table and "FAILED" in table
    assert "fill from arXiv:2204.00172" in table


def _canned_drive(tmp_path):
    """The JAX test's canned pair: a stale and a latest adapt log, and a
    control log."""
    adapt, ctl = tmp_path / "adapt", tmp_path / "control"
    adapt.mkdir()
    ctl.mkdir()
    (adapt / "train-2026-01-01-00_00_00.txt").write_text(
        "Epoch: 0 Source: 0.900 Target: 0.900 Target(best): 0.900\n"
        "Epoch: 5 Source: 0.900 Target: 0.900 Target(best): 0.900\n")
    (adapt / "train-2026-01-02-00_00_00.txt").write_text(
        "Epoch: 0 Source: 0.100 Target: 0.080 Target(best): 0.080\n"
        "all: 0.080\n"
        "Epoch: 1 Source: 0.300 Target: 0.250 Target(best): 0.250\n")
    (ctl / "train-y.txt").write_text(
        "Epoch: 0 Source: 0.100 Target: 0.080 Target(best): 0.080\n"
        "Epoch: 1 Source: 0.350 Target: 0.120 Target(best): 0.120\n")
    return adapt, ctl


def test_gain_drive_parser(tmp_path):
    from tools import run_gain_drive as jax_gd

    adapt, ctl = _canned_drive(tmp_path)
    assert gd.parse_curve(str(adapt)) == [(0, 0.1, 0.08), (1, 0.3, 0.25)]
    assert gd.parse_curve(str(adapt)) == jax_gd.parse_curve(str(adapt))
    record = gd.report(str(adapt), str(ctl), pretrain_epoch=1)
    assert len(record["adapt"]) == 2 and len(record["control"]) == 2
    assert record["frozen_pretrain"] == 0.08 and record["best_adapt"] == 0.25
    assert record["margin"] == pytest.approx(0.17)
    assert record["control_margin"] == pytest.approx(0.04)
    assert record["control_delta"] == pytest.approx(0.13)
    with pytest.raises(SystemExit):
        gd.report(str(tmp_path / "nope"), str(ctl), pretrain_epoch=1)


def _write_curve(path, targets):
    path.mkdir(parents=True)
    (path / "train-2026.txt").write_text("".join(
        f"Epoch: {e} Source: 0.500 Target: {t:4.3f} Target(best): {max(targets[:e + 1]):4.3f}\n"
        for e, t in enumerate(targets)))


@pytest.mark.parametrize("case", ["met", "missed", "no_lines"])
def test_gain_drive_margin(tmp_path, capsys, case):
    """``main parse`` exits 0 when the adaptation phase's best target PCK
    reaches the frozen-pretrain level (epoch pretrain_epoch - 1) plus
    --min-gain, and exits 1 with the numbers when it does not or when the
    logs hold no epoch line."""
    adapt = {"met": [0.10, 0.15, 0.16, 0.17, 0.20, 0.19],
             "missed": [0.10, 0.15, 0.16, 0.17, 0.18, 0.15]}.get(case)
    ctl = [0.10, 0.15, 0.16, 0.16, 0.17, 0.18]
    if adapt is None:
        (tmp_path / "adapt").mkdir()
        (tmp_path / "adapt" / "train-2026.txt").write_text("Epoch: [0][0/75]\tTime 1.0\n")
    else:
        _write_curve(tmp_path / "adapt", adapt)
    _write_curve(tmp_path / "control", ctl)
    argv = ["parse", str(tmp_path / "adapt"), str(tmp_path / "control"),
            "--pretrain-epoch", "3"]
    if case == "met":
        record = gd.main(argv)
        assert record["frozen_pretrain"] == 0.16 and record["best_adapt"] == 0.20
        assert record["margin"] == pytest.approx(0.04)
        # the control's own margin is recorded, not gated: 0.18 - 0.16
        assert record["control_margin"] == pytest.approx(0.02)
        assert "ok" in capsys.readouterr().out
    else:
        with pytest.raises(SystemExit) as exc:
            gd.main(argv)
        assert exc.value.code != 0
        if case == "missed":  # 0.18 - 0.16 = 0.02 < 0.03
            assert "+0.020 < 0.03" in str(exc.value.code)
        # a lower margin lets the same logs pass
        if case == "missed":
            assert gd.main(argv + ["--min-gain", "0.01"])["margin"] == pytest.approx(0.02)


def test_gain_drive_commands(tmp_path):
    """Both drives run the port's CLI with the JAX drive's flags."""
    from tools import run_gain_drive as jax_gd

    class Args:
        source_root, target_root = "/s", "/t"
        arch, batch_size, epochs, iters, seed = "pose_resnet101", 32, 8, 75, 0

    for pe in (3, 8):
        ours, theirs = gd.drive_cmd(Args, "logs/x", pe), jax_gd.drive_cmd(Args, "logs/x", pe)
        assert ours[1:3] == ["-m", "uda_poseestimation_torch.train_human"]
        assert ours[3:] == theirs[2:]


_PRE = {"first_loss": 6e-3, "last_loss": 1.5e-3, "pck_src": 1.0}
_OUT = {"pck_tgt_before": 0.8125, "pck_tgt_student": 1.0, "pck_tgt_teacher": 1.0,
        "loss_all": 1e-3, "loss_c": 5e-4}


@pytest.mark.parametrize("case, pre, out, failed", [
    ("met", _PRE, _OUT, []),
    ("teacher_below_floor", _PRE, dict(_OUT, pck_tgt_teacher=0.875),
     ["teacher_target_pck_rose"]),
    ("loss_fell_2x", dict(_PRE, last_loss=3e-3), _OUT, ["pretrain_loss_fell_3x"]),
    ("style_three_cases", _PRE, dict(_OUT, decoder_first_loss=2e-4, decoder_last_loss=7e-5,
                                     cases=[(False, False), (True, False), (True, True)]),
     ["all_gate_cases"]),
    ("nan_loss", _PRE, dict(_OUT, loss_c=float("nan")), ["losses_finite"]),
    ("style_pretrain_not_asserted", dict(_PRE, last_loss=2.1e-3, pck_src=0.8),
     dict(_OUT, decoder_first_loss=2e-4, decoder_last_loss=7e-5,
          cases=[(False, False), (False, True), (True, False), (True, True)]), []),
])
def test_threshold_checks(case, pre, out, failed):
    """The JAX test's assertions on a recipe's records: the floor is
    min(before + 0.1, 0.9) (0.9 here, so 0.875 misses it); the plain
    recipe's pretraining is held (its loss 3x down, its PCK above 0.9), the
    style recipe's is not, as in the JAX style test, which holds the
    decoder and the gate cases instead."""
    checks = convergence.threshold_checks(pre, out)
    assert [k for k, ok in checks.items() if not ok] == failed, case
    assert ("all_gate_cases" in checks) == ("cases" in out)


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 2, 2, 2), (3, 4, 9, 3)])
def test_reflection_pad_matches_torch(shape):
    """The StyleNet's reflection pad, whose backward folds the border by
    slice additions (``nn.ReflectionPad2d``'s CUDA backward adds with
    atomics, so that the style recipe's decoder trained differently on
    every card run), against ``nn.ReflectionPad2d(1)``: the same output,
    and gradients equal to float64 rounding."""
    from uda_poseestimation_torch.models.style_net import ReflectionPad1

    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(*shape), requires_grad=True)
    g = torch.tensor(rng.randn(shape[0], shape[1], shape[2] + 2, shape[3] + 2))
    want = torch.nn.ReflectionPad2d(1)(x)
    got = ReflectionPad1()(x)
    assert torch.equal(got, want)
    (dwant,) = torch.autograd.grad(want, x, g)
    (dgot,) = torch.autograd.grad(got, x, g)
    np.testing.assert_allclose(dgot.numpy(), dwant.numpy(), rtol=0, atol=1e-12)
