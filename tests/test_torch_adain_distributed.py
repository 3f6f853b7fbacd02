"""The port's AdaIN decoder trainer across processes (the JAX package's
``adain_engine._pick_decoder_mesh``): one process a device, each on its
rows of the global batch, gradients averaged before the update.

- Two gloo ranks on the CPU (spawned from ``_torch_dist_worker.py``), one
  decoder step with SGD on 2 rows each of a 4-row batch, against the port's
  one-process step on the 4 rows and the JAX package's
  ``make_decoder_step`` with ``tx=optax.sgd`` on them (as
  ``tests/test_adain_engine.py`` holds its sharded step): the ranks' states
  bit-equal, the losses the global batch's, each rank's stylized rows the
  one-process step's.
- The CLI (``adain.train_human``) through the launcher at 2 ranks on the
  fake RHD and H3D trees (32², 4 iterations) against the same CLI in one
  process, torch's generator seeded 0 in both (as a group seeds it): the
  same log lines, PNGs at the same iterations (content and style thirds
  byte-equal), the same checkpoint keys; rank 0 alone prints and writes.
- The batch rule: a process count that does not divide the global batch
  exits before joining, naming the largest count that does.

Tolerances (float32; two ranks' sums in another order than one process's):
losses 1e-6 relative, the SGD update within 1e-5 of each tensor's largest
entry; against JAX, as ``test_torch_adain_engine.py``: losses 1e-4, the
update within 1e-4 of the largest entry or the one-process port step's own
distance from JAX, whichever is larger, plus 1e-5. The CLI's logged losses 2e-5 relative over 4 Adam steps, the
checkpoint's decoder within 1e-3 in norm, the stylized third within one
grey level.
"""

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import torch
from PIL import Image

from test_torch_adain_engine import _jax_step, _updates
from test_torch_distributed import join_ranks, start_ranks
from test_torch_human_datasets import h3d_root  # noqa: F401 (fixture)
from test_torch_style_net import style_params
from tools.make_fixtures import make_rhd
from uda_poseestimation_torch import adain_engine as tengine
from uda_poseestimation_torch import weights
from uda_poseestimation_torch.adain import train_animal as tanimal
from uda_poseestimation_torch.adain import train_human as tcli
from uda_poseestimation_torch.models import StyleNet

REPO = Path(__file__).resolve().parents[1]
SIZE, B, LR = 32, 4, 1e-1
ENV = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def step_run(tmp_path_factory):
    params = style_params()
    rng = np.random.RandomState(11)
    content = rng.rand(B, SIZE, SIZE, 3).astype(np.float32)
    style = rng.rand(B, SIZE, SIZE, 3).astype(np.float32)
    net = weights.load_style_net(StyleNet("meanstd"), params)
    job = {"jobs": ["decoder"], "style_net": net.state_dict(), "decoder_lr": LR,
           "content": content, "style_imgs": style}
    ranks = start_ranks(2, job, tmp_path_factory.mktemp("decoder_ranks"))
    want_dec, want_losses = _jax_step(params, optax.sgd(LR), content, style)
    step, _ = tengine.make_decoder_step(
        net, 1.0, 2.0, LR, optimizer=torch.optim.SGD(net.decoder.parameters(), lr=LR))
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()  # noqa: E731
    *losses, g_t = step(nchw(content), nchw(style))
    return dict(ranks=[r["decoder"] for r in join_ranks(*ranks)],
                old=weights.decoder_state_dict(params["decoder"]),
                one={"losses": [float(x) for x in losses], "g_t": g_t.numpy(),
                     "decoder": {k: v.numpy() for k, v in net.decoder.state_dict().items()}},
                jax={"losses": [float(x) for x in want_losses], "decoder": want_dec})


def test_two_ranks_hold_one_state(step_run):
    a, b = step_run["ranks"]
    assert a["digests"] == b["digests"]
    assert a["losses"] == b["losses"]  # the global means, on every rank


def test_two_ranks_step_matches_one_process(step_run):
    rank0, one = step_run["ranks"][0], step_run["one"]
    np.testing.assert_allclose(rank0["losses"], one["losses"], rtol=1e-6)
    got = _updates(rank0["decoder"], step_run["old"])
    want = _updates(one["decoder"], step_run["old"])
    for k in want:
        err, scale = np.abs(got[k] - want[k]).max(), np.abs(want[k]).max()
        assert scale > 0 and err <= 1e-5 * scale, (k, err, scale)
    g_t = np.concatenate([r["g_t"] for r in step_run["ranks"]])
    np.testing.assert_allclose(g_t, one["g_t"], rtol=1e-5, atol=1e-6)


def test_two_ranks_step_matches_jax(step_run):
    """The ranks' update is no farther from JAX's than the one-process port
    step's, plus the ranks' own 1e-5 (this batch sits near a ReLU or
    max-pool kink: the one-process step is 4.2e-4 of the largest entry from
    JAX's in the first conv, where another batch gives 6e-6)."""
    rank0, want = step_run["ranks"][0], step_run["jax"]
    np.testing.assert_allclose(rank0["losses"], want["losses"], rtol=1e-4)
    got = _updates(rank0["decoder"], step_run["old"])
    one = _updates(step_run["one"]["decoder"], step_run["old"])
    ref = _updates(want["decoder"], step_run["old"])
    for k in ref:
        scale = np.abs(ref[k]).max()
        floor = max(np.abs(one[k] - ref[k]).max(), 1e-4 * scale)
        err = np.abs(got[k] - ref[k]).max()
        assert scale > 0 and err <= floor + 1e-5 * scale, (k, err, floor, scale)


CLI_ARGS = ["--source", "RenderedHandPose", "--target", "Hand3DStudio_mt",
            "--source_root", "rhd", "--vgg", "vgg.pth", "--image-size", str(SIZE),
            "--max_iter", "4", "--save_model_interval", "3", "--log_img_interval", "2",
            "--exp_name", "run", "--device", "cpu", "--lr", "1e-4"]
ONE_PROCESS = ("import sys, torch; torch.manual_seed(0); "
               "from uda_poseestimation_torch.adain import train_human as t; "
               "t.main(t.build_parser().parse_args(sys.argv[1:]))")


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory, h3d_root):  # noqa: F811 (fixture)
    """The CLI at 2 ranks through the launcher and in one process, at once,
    each in its own directory beside a shared fake RHD tree and vgg file."""
    root = tmp_path_factory.mktemp("decoder_cli")
    make_rhd(str(root / "rhd"), n_train=8, n_eval=4)
    style = StyleNet()
    style.reset_parameters(torch.Generator().manual_seed(1))
    torch.save(style.encoder.state_dict(), str(root / "vgg.pth"))
    argv = CLI_ARGS + ["--target_root", h3d_root]
    cmds = {"ranks": [sys.executable, "-m", "uda_poseestimation_torch.tools.launch_distributed",
                      "-n", "2", "--coordinator", f"file://{root}/rendezvous", "--",
                      sys.executable, "-m", "uda_poseestimation_torch.adain.train_human"],
            "one": [sys.executable, "-c", ONE_PROCESS]}
    procs = {}
    for name, cmd in cmds.items():
        os.makedirs(root / name)
        for f in ("rhd", "vgg.pth"):
            os.symlink(root / f, root / name / f)
        procs[name] = subprocess.Popen(cmd + argv, cwd=root / name, env=ENV, text=True,
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    outs = {}
    try:
        for name, proc in procs.items():
            outs[name] = proc.communicate(timeout=300)[0]
            assert proc.returncode == 0, outs[name][-3000:]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return root, outs


_LINE = re.compile(r"^iter: (\d+), decoder_loss: (\S+), content loss: (\S+), "
                   r"style loss: (\S+)$")


def test_two_rank_cli_logs_the_one_process_run(cli_runs):
    root, outs = cli_runs
    assert "decoder training sharded over 2 devices" in outs["ranks"]
    assert "sharded" not in outs["one"]
    assert not any(line.startswith("[rank 1]") and "sharded" in line
                   for line in outs["ranks"].splitlines())
    logs = [(root / side / "logs/run/log_run.txt").read_text().splitlines()
            for side in ("ranks", "one")]
    assert len(logs[0]) == len(logs[1]) == 4
    for i, (got, want) in enumerate(zip(*logs)):
        got_m, want_m = _LINE.match(got), _LINE.match(want)
        assert got_m and want_m and int(got_m[1]) == int(want_m[1]) == i, (got, want)
        np.testing.assert_allclose([float(x) for x in got_m.groups()[1:]],
                                   [float(x) for x in want_m.groups()[1:]], rtol=2e-5)
    pngs = "logs/run/save_imgs/save_img_run"
    assert sorted(os.listdir(root / "ranks" / pngs)) == \
        sorted(os.listdir(root / "one" / pngs)) == ["0.png", "2.png"]
    for name in ("0.png", "2.png"):
        got, want = (np.asarray(Image.open(root / side / pngs / name))
                     for side in ("ranks", "one"))
        np.testing.assert_array_equal(got[:, SIZE:], want[:, SIZE:])
        assert np.abs(got[:, :SIZE].astype(int) - want[:, :SIZE]).max() <= 1
    got, want = (torch.load(str(root / side / "logs/run/saved_model/decoder_run.pth.tar"),
                            weights_only=True) for side in ("ranks", "one"))
    assert list(got) == list(want) == list(StyleNet().decoder.state_dict())
    diff = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want) ** 0.5
    assert diff <= 1e-3 * sum(float((want[k] ** 2).sum()) for k in want) ** 0.5
    # rank 0 alone wrote: the run directory holds one log, two PNGs, one file
    files = sorted(str(p.relative_to(root / "ranks")) for p in (root / "ranks").rglob("*")
                   if p.is_file() and not p.is_symlink() and "rhd" not in p.parts)
    assert files == ["logs/run/log_run.txt", "logs/run/save_imgs/save_img_run/0.png",
                     "logs/run/save_imgs/save_img_run/2.png",
                     "logs/run/saved_model/decoder_run.pth.tar"], files


@pytest.mark.parametrize("cli,batch_args,world,fit", [
    (tcli, [], 3, 2), (tcli, ["--batch_size", "6"], 8, 4),
    (tanimal, ["--batch_size", "6"], 4, 3), (tanimal, ["--batch_size", "5"], 2, 1)])
def test_process_count_must_divide_the_batch(tmp_path, monkeypatch, cli, batch_args, world,
                                             fit):
    """The human pair's batch is 4 whatever --batch_size says; the animal
    pair's is --batch_size. The CLI exits before joining a group or writing
    a file."""
    monkeypatch.chdir(tmp_path)
    args = cli.build_parser().parse_args(
        batch_args + ["--device", "cpu", "--dist-coordinator", f"file://{tmp_path}/rdv",
                      "--dist-num-processes", str(world), "--dist-process-id", "0"])
    with pytest.raises(SystemExit, match=rf"does not split over {world} processes; "
                                         rf"run at most {fit}$"):
        cli.main(args)
    assert os.listdir(tmp_path) == []
    assert not torch.distributed.is_initialized()
    assert tengine.decoder_group_size(4, 4) == 4


def test_no_coordinator_runs_one_process(monkeypatch):
    """Without --dist-coordinator the group stays down and the device is
    the one asked for (the flags alone change nothing, as in JAX)."""
    args = argparse.Namespace(dist_coordinator=None, dist_num_processes=3,
                              dist_process_id=1, device="cpu")
    with tengine.decoder_process_group(args, 4) as device:
        assert device == torch.device("cpu") and not torch.distributed.is_initialized()
