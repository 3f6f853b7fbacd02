"""Two ranks of the port's trainer CLIs through the port's launcher
(``python -m uda_poseestimation_torch.tools.launch_distributed -n 2``), on
the CPU (``--device cpu``: gloo, one thread a rank, ``-j 0``), with a
rendezvous file.

- ``train_human`` on the fake RHD tree (8 training and 4 evaluation frames,
  ``-b 4``: 2 rows a rank) with random style weights: one pretrain and one
  adapt epoch of 2 iterations, unbundled and with ``--steps-per-dispatch
  2``. Both ranks exit 0; rank 0 prints the progress lines and writes the
  one log and the ``best_pt`` checkpoint (seed 0: the random-init student
  scores a target PCK above 0, which the ``acc > best`` rule needs), rank 1
  prints no progress and makes no file (the run directory holds rank 0's
  files only); the bundled run logs the unbundled run's losses (equal as
  printed); the checkpoint loads in a one-process ``--phase test``.
- ``train_animal`` on ``make_animal``'s tree (``test_torch_train_animal``'s
  sizes): a pretrain epoch, then an adapt epoch from a checkpoint that the
  test writes (``--pretrain``): a random-init student scores PCK 0 there,
  so the pretrain epoch writes no ``best_pt`` to adapt from. Rank 0 logs
  both epochs with every category and draws the line's ``--debug`` images;
  no checkpoint is written; rank 1 prints no progress.
- The launcher alone on a two-line script: its flags reach every rank,
  rank 1's lines come prefixed, a failing rank's code is returned.
- ``CompleteLogger(file_output=False)`` (every rank but 0) makes nothing.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from test_torch_train_animal import ANIMAL18_GROUPS, SMALL, _check_epoch_log, _script_line
from test_torch_train_human import FIXTURE_ARGS, _write_style_weights
from tools.make_fixtures import make_animal, make_rhd
from uda_poseestimation_torch import models
from uda_poseestimation_torch import train_human as ttrain
from uda_poseestimation_torch.parallel import StepConfig, create_state
from uda_poseestimation_torch.utils import CompleteLogger
from uda_poseestimation_torch.utils import checkpoint as tckpt

REPO = Path(__file__).resolve().parents[1]
# seed 0: see the module docstring
HUMAN_ARGS = FIXTURE_ARGS[:FIXTURE_ARGS.index("--seed") + 1] + ["0"] + FIXTURE_ARGS[
    FIXTURE_ARGS.index("--seed") + 2:] + ["--device", "cpu", "-j", "0", "--epochs", "2",
                                          "--pretrain-epoch", "1", "-i", "2"]
_LOSS = re.compile(r"Loss \((all|s|c)\) ([-+.\de]+)")


def launch(run, module, runs, env=None):
    """For each name -> argv of ``runs``, two ranks of ``python -m module
    argv`` from ``run``, logging to logs/<name>; all runs at once. Returns
    each launcher's output (rank 1's lines prefixed)."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", **(env or {}))
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "uda_poseestimation_torch.tools.launch_distributed",
         "-n", "2", "--coordinator", f"file://{run}/rendezvous_{name}", "--",
         sys.executable, "-m", module, *argv, "--log", f"logs/{name}"],
        cwd=run, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, argv in runs.items()}
    outs = {}
    try:
        for name, proc in procs.items():
            outs[name] = proc.communicate(timeout=300)[0]
            assert proc.returncode == 0, outs[name][-4000:]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def files_of(run, name):
    """The files a run made under logs/, checkpoints/ and output_viz/."""
    return sorted(str(p.relative_to(run)) for top in ("logs", "checkpoints", "output_viz")
                  for p in (run / top).rglob("*")
                  if p.is_file() and p.relative_to(run).parts[1] == f"{name}_pose_resnet50")


def progress(out, rank1=False):
    prefix = "[rank 1] " if rank1 else ""
    return [line[len(prefix):] for line in out.splitlines()
            if line.startswith(prefix + "Epoch: [")]


@pytest.fixture(scope="module")
def human_run(tmp_path_factory):
    run = tmp_path_factory.mktemp("dist_cli")
    make_rhd(str(run / "rhd"), n_train=8, n_eval=4)
    _write_style_weights(str(run / "saved_models"))
    return run


@pytest.fixture(scope="module")
def human_runs(human_run):
    return launch(human_run, "uda_poseestimation_torch.train_human",
                  {"unbundled": HUMAN_ARGS, "bundled": HUMAN_ARGS + ["--steps-per-dispatch", "2"]})


@pytest.mark.parametrize("name", ["unbundled", "bundled"])
def test_two_ranks_train_human_rank0_writes(human_run, human_runs, name):
    out = human_runs[name]
    files = files_of(human_run, name)
    assert [f for f in files if f.endswith(".txt")] == [
        f for f in files if re.fullmatch(rf"logs/{name}_pose_resnet50/train-[\d_-]+\.txt", f)]
    assert len([f for f in files if f.endswith(".txt")]) == 1
    assert [f for f in files if f.endswith(".pth")] == [
        f for f in files if re.fullmatch(rf"checkpoints/{name}_pose_resnet50/"
                                         r"checkpoints_[\d_-]+/best_pt\.pth", f)]
    assert len(files) == 2, files  # the log and best_pt; no image (no --debug)
    (log,) = (human_run / "logs" / f"{name}_pose_resnet50").glob("train-*.txt")
    text = log.read_text()
    assert re.search(r"^Epoch: 0 Source: \d\.\d{3} Target: 0\.0*[1-9]", text, re.M), text[-800:]
    assert re.search(r"^Epoch: 1 Source: \d\.\d{3} Target:", text, re.M), text[-800:]
    assert "dist_num_processes=2" in text and "Source train: 2" in text
    assert [line[:13] for line in progress(out)] == ["Epoch: [0][0/", "Epoch: [0][1/",
                                                     "Epoch: [1][0/", "Epoch: [1][1/"]
    assert progress(out, rank1=True) == []
    assert not any(line.startswith("[rank 1] Epoch") for line in out.splitlines())


def test_two_ranks_bundled_logs_the_unbundled_losses(human_runs):
    losses = {name: [_LOSS.findall(line) for line in progress(out)]
              for name, out in human_runs.items()}
    assert losses["bundled"] == losses["unbundled"]
    assert all(len(step) == 2 or len(step) == 3 for step in losses["unbundled"])


@pytest.mark.parametrize("name", ["unbundled", "bundled"])
def test_two_rank_checkpoint_loads_in_one_process(human_run, human_runs, name, monkeypatch):
    (ckpt,) = (human_run / "checkpoints" / f"{name}_pose_resnet50").glob("*/best_pt.pth")
    monkeypatch.chdir(human_run)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        ttrain.main(ttrain.build_parser().parse_args(
            HUMAN_ARGS + ["--phase", "test", "--resume", str(ckpt), "--log",
                          f"logs/test_{name}"]))
    finally:
        torch.set_num_threads(threads)
    (log,) = (human_run / "logs" / f"test_{name}_pose_resnet50").glob("test-*.txt")
    assert re.search(r"^Source: \d\.\d{3} Target: \d\.\d{3}$", log.read_text(), re.M)


def test_logger_without_file_output_writes_nothing(tmp_path):
    logger = CompleteLogger(str(tmp_path / "logs" / "x"), "train", now="ts",
                            file_output=False)
    logger.set_epoch(0)
    logger.write("nothing")
    logger.close()
    assert os.listdir(tmp_path) == []
    assert logger.get_checkpoint_path("best").endswith("checkpoints/x/checkpoints_ts/best.pth")


@pytest.fixture(scope="module")
def animal_runs(tmp_path_factory):
    run = tmp_path_factory.mktemp("dist_animal")
    make_animal(str(run))
    _write_style_weights(str(run / "saved_models"))
    state = create_state(models.pose_resnet50(num_keypoints=18, dtype=torch.bfloat16),
                         StepConfig(image_size=64, heatmap_size=16), seed=3, device="cpu")
    tckpt.save_checkpoint(str(run / "pretrained.pth"), {
        "student": state.student, "teacher": state.teacher, "epoch": 0,
        "args": {"arch": "pose_resnet50"}})
    argv = _script_line("train_animal.py") + SMALL + [
        "--image-path", str(run / "animal_data"), "--epochs", "1", "-i", "2", "--seed", "0"]
    return run, launch(run, "uda_poseestimation_torch.train_animal", {
        "pretrain": argv + ["--pretrain-epoch", "1"],
        "adapt": argv + ["--pretrain-epoch", "-1", "--pretrain", str(run / "pretrained.pth")]},
        env={"UDA_CACHED_DATA_DIR": str(run / "cached_data")})


@pytest.mark.parametrize("name", ["pretrain", "adapt"])
def test_two_ranks_train_animal(animal_runs, name):
    run, outs = animal_runs
    files = files_of(run, name)
    # the log and the line's --debug images; no checkpoint: a random-init
    # student scores PCK 0 here
    logs = [f for f in files if f.startswith("logs/")]
    assert len(logs) == 1 and re.fullmatch(
        rf"logs/{name}_pose_resnet50/train-[\d_-]+\.txt", logs[0]), files
    assert all(re.fullmatch(rf"output_viz/{name}_pose_resnet50/visualize/0/\w+\.jpg\.jpg", f)
               for f in files if f not in logs), files
    text = (run / logs[0]).read_text()
    _check_epoch_log(text, ("horse", "tiger"), ANIMAL18_GROUPS)
    steps = progress(outs[name])
    assert len(steps) == 2 and all(("Loss (c)" in s) == (name == "adapt") for s in steps)
    assert progress(outs[name], rank1=True) == []


@pytest.mark.parametrize("failing,rc", [(None, 0), (1, 3)])
def test_launcher_prefixes_ranks_and_returns_the_failure(capfd, failing, rc):
    """The launcher appends the --dist-* flags, streams rank 0's lines,
    prefixes the others' and returns the first failing rank's code."""
    from uda_poseestimation_torch.tools import launch_distributed

    script = ("import sys; a = sys.argv; rank = int(a[a.index('--dist-process-id') + 1]); "
              "print('rank', rank, 'of', a[a.index('--dist-num-processes') + 1], "
              "a[a.index('--dist-coordinator') + 1]); "
              f"sys.exit({rc} if rank == {failing!r} else 0)")
    got = launch_distributed.main(["-n", "2", "--coordinator", "file:///nowhere", "--",
                                   sys.executable, "-c", script])
    out = capfd.readouterr().out.splitlines()
    assert got == rc
    assert "[rank 1] rank 1 of 2 file:///nowhere" in out
    if failing is None:  # a failure stops the other ranks, which may not have printed
        assert sorted(out) == ["[rank 1] rank 1 of 2 file:///nowhere",
                               "rank 0 of 2 file:///nowhere"]


def test_launcher_imports_no_torch():
    """The launcher starts its ranks without importing torch itself (each
    rank imports it anyway), so a run does not wait for that twice."""
    code = ("import sys, uda_poseestimation_torch.tools.launch_distributed as l; "
            "assert 'torch' not in sys.modules, 'torch imported'; print(l.free_port())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert 0 < int(out.stdout) < 65536
