"""End-to-end learning evidence for the port: its PCK rises over a run.

The twin of ``tests/test_convergence.py``, through the port's recipe
(``uda_poseestimation_torch/tools/convergence.py``) on the CPU, with the
JAX test's assertions and thresholds:

1. pretraining on a fixed blob batch: the final loss under a third of the
   first, train-batch PCK above 0.9;
2. mean-teacher adaptation on the shifted target: the student's and the
   EMA teacher's target PCK above ``min(before + 0.1, 0.9)``, losses finite;
3. the same with style transfer at p=0.5: the decoder's loss lower after its
   40 steps, all four gate cases run, the same PCK thresholds.

Each runs one step per call (``make_*_step``) and ten per call through the
step bundlers, which on the CPU run the same steps eagerly. Then the
accuracy harness runs end to end on an injected fixture benchmark: the
port's CLI as a subprocess with ``--device cpu``, its log parsed, the
table and JSON written. Marked slow (minutes), as the JAX twin.
"""

import json
import os

import numpy as np
import pytest
import torch

from uda_poseestimation_torch.tools import convergence as cv
from uda_poseestimation_torch.tools import fixtures
from uda_poseestimation_torch.tools import run_benchmarks as rb

pytestmark = pytest.mark.slow


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _pretrained(seed, teacher_alpha, steps_per_dispatch):
    rng = np.random.RandomState(seed)
    cfg, state = cv.make_state(teacher_alpha, "cpu")
    src = cv.make_blob_batch(rng)
    pre = cv.pretrain_until(state, cfg, src, "cpu", steps_per_dispatch)
    tgt = cv.make_blob_batch(rng, shift=True, kp=src[1])
    return rng, cfg, state, src, tgt, pre


def _assert_adapted(out):
    assert np.isfinite(out["loss_all"]) and np.isfinite(out["loss_c"])
    floor = min(out["pck_tgt_before"] + 0.1, 0.9)
    assert out["pck_tgt_student"] > floor, out
    assert out["pck_tgt_teacher"] > floor, out


@pytest.mark.parametrize("steps_per_dispatch", [1, cv.STEPS_PER_DISPATCH])
def test_pipeline_learns(steps_per_dispatch):
    rng, cfg, state, src, tgt, pre = _pretrained(0, 0.9, steps_per_dispatch)
    assert np.isfinite(pre["last_loss"])
    assert pre["last_loss"] < pre["first_loss"] / 3, pre
    assert pre["pck_src"] > 0.9, f"pretraining failed to learn: {pre}"
    out = cv.adapt(state, cfg, src, tgt, rng, "cpu", steps_per_dispatch)
    print(f"pck src={pre['pck_src']:.3f} tgt_before={out['pck_tgt_before']:.3f} "
          f"tgt_student={out['pck_tgt_student']:.3f} "
          f"tgt_teacher={out['pck_tgt_teacher']:.3f} steps={pre['steps']}+{out['steps']}")
    _assert_adapted(out)


@pytest.mark.parametrize("steps_per_dispatch", [1, cv.STEPS_PER_DISPATCH])
def test_pipeline_learns_with_style_transfer(steps_per_dispatch):
    rng, cfg, state, src, tgt, _ = _pretrained(1, 0.85, steps_per_dispatch)
    out = cv.adapt_with_style(state, cfg, src, tgt, rng, "cpu", steps_per_dispatch)
    assert out["decoder_last_loss"] < out["decoder_first_loss"]  # the decoder trained
    assert out["cases"] == [(False, False), (False, True), (True, False), (True, True)]
    print(f"style-on: tgt_before={out['pck_tgt_before']:.3f} "
          f"tgt_student={out['pck_tgt_student']:.3f} "
          f"tgt_teacher={out['pck_tgt_teacher']:.3f} steps={out['steps']}")
    _assert_adapted(out)


def test_harness_end_to_end_on_fixture(tmp_path, monkeypatch):
    """An injected fixture benchmark through the whole harness: the command,
    the port's trainer as a subprocess on the CPU, the log parse, the table
    and the JSON."""
    root = str(tmp_path / "data" / "RHDfix")
    fixtures.make_rhd(root, n_train=24, n_eval=8)
    spec = {"trainer": "uda_poseestimation_torch.train_human",
            "argv": ["{root}/RHDfix", "{root}/RHDfix",
                     "-s", "RenderedHandPose", "-t", "RenderedHandPose",
                     "--target-train", "RenderedHandPose_mt",
                     "--log", "{log}/fix_exp/run", "--seed", "0"]}
    monkeypatch.setitem(rb.BENCHMARKS, "FIXTURE", spec)
    monkeypatch.setitem(rb.PAPER_PCK, "FIXTURE", 0.9)
    results = rb.main([
        "--data-root", str(tmp_path / "data"), "--log-root", str(tmp_path / "logs"),
        "--only", "FIXTURE", "--arch", "pose_resnet50", "--out", str(tmp_path / "res.json"),
        "--extra", "--device", "cpu", "--image-size", "64", "--heatmap-size", "16",
        "-a", "pose_resnet50", "-b", "8", "--test-batch", "8", "--epochs", "1",
        "--pretrain-epoch", "-1", "-i", "2", "-p", "1", "--val-print-freq", "1",
        "--device-aug", "-j", "0"])
    res = results["FIXTURE"]
    assert isinstance(res, dict), res
    assert res["epochs_seen"] == 1
    assert 0.0 <= res["best_target_all_pck"] <= 1.0
    assert "all" in res["final_groups"]
    saved = json.load(open(tmp_path / "res.json"))
    assert "FIXTURE" in saved["results"] and "table" in saved
    assert os.path.exists(res["log"])
