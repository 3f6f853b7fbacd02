"""The port's animal trainers (``python -m uda_poseestimation_torch.train_animal``
and ``...train_animal_other``) against the repository's ``train_animal.py``
and ``train_animal_other.py`` (the JAX package's trainers).

- The parser: every option of the JAX parser exists in the port's with the
  same option strings, destination, default, type, nargs and action; the
  port adds only ``--device``, and its ``-a`` choices are its own
  constructors. Both animal lines of ``script`` parse to the same
  namespace in both packages.
- The ``--dist-*`` flags raise at start, naming their ROADMAP item; without
  a card and without ``--device cpu`` the CLI raises. (``--device-aug`` is
  held in ``tests/test_torch_animal_device_aug.py`` and
  ``tests/test_torch_train_animal_device_aug.py``.)
- The datasets and the per-category evaluation sets are built in the JAX
  trainer's order, with the same keywords, and ``args.animal`` is left at
  the last category, as the JAX trainer leaves it.
- The slice against JAX on the CPU: one adapt batch collated from both
  packages' synthetic source and TigDog ``_mt`` datasets (18 keypoints,
  64²/16², b=4) through both adapt steps with ``aux_outputs``, the same
  weights (``weights.py``), the animal clamp, ``gather_exact=False`` (the
  JAX Pallas kernel in interpret mode) and bf16 styled images; then one
  ``run_validate`` of each package at ``--test-batch 1`` on the same
  weights over the source, the target and each category.
- CPU drives on ``tools/make_fixtures.make_animal``'s tree with random style
  weights: a pretrain epoch through ``python -m``; adapt epochs from a
  checkpoint that the test writes with the port's ``save_checkpoint``
  (named by ``--pretrain``, through ``python -m``, and put where the
  ``best_pt`` reload looks, with ``--steps-per-dispatch 2``);
  ``--phase test --resume``; and ``train_animal_other`` (synthetic hound
  and sheep to AnimalPose) for an adapt epoch through ``python -m``. No
  drive depends on what a random-init student scores.

Tolerances, as ``tests/test_torch_train_step.py`` states them: integer
decisions (the kth-value mask, the occlusion gate and rectangles, the
rectified targets' argmax) equal; the styled images 1e-4 of their largest
value in float32, and here within one bf16 ulp (2^-8 relative) where the
step rounds them to bf16, since a 1e-6 change can cross a rounding
boundary; tensors through the train-mode model 1e-3, and 1e-2 for the
student's source heatmaps, whose styled input differs in those roundings
(``SLICE_GATES``); the occluded view in at most 0.1% of its pixels; the
loop's PCK exactly.
"""

import argparse
import copy
import functools
import math
import os
import random
import re
import shlex
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train_animal as jtrain
import uda_poseestimation_tpu.data as jdata
import uda_poseestimation_torch.data as tdata
from test_animal_data import fake_animal_pose  # noqa: F401 (fixture)
from test_torch_animal_datasets import add_other_keypoints, view_transforms
from test_torch_train_human import _write_style_weights
from test_torch_train_step import _close, _jax_draws, _jax_state
from tools.make_fixtures import make_animal
from uda_poseestimation_tpu import engine as jengine
from uda_poseestimation_tpu.models import StyleNet as JStyleNet
from uda_poseestimation_tpu.models.pose_resnet import PoseResNet as JPoseResNet
from uda_poseestimation_tpu.models.resnet import Bottleneck as JBottleneck
from uda_poseestimation_tpu.models.resnet import ResNet as JResNet
from uda_poseestimation_tpu.parallel import train_step as jts
from uda_poseestimation_tpu.data import transforms as JT
from uda_poseestimation_torch import engine as tengine
from uda_poseestimation_torch import models, weights
from uda_poseestimation_torch import train_animal as ttrain
from uda_poseestimation_torch import train_human as thuman
from uda_poseestimation_torch.data import transforms as TT
from uda_poseestimation_torch.models import Bottleneck, PoseResNet, ResNet, StyleNet
from uda_poseestimation_torch.parallel import StepConfig, create_state
from uda_poseestimation_torch.parallel import train_step as tts
from uda_poseestimation_torch.utils import CompleteLogger
from uda_poseestimation_torch.utils import checkpoint as tckpt

REPO = Path(__file__).resolve().parents[1]
# small sizes, in-process loading, random style weights; the port adds the CPU
SIZES = ["--image-size", "64", "--heatmap-size", "16", "--inp-res", "64", "--out-res", "16",
         "-b", "4", "-j", "0", "-a", "pose_resnet50", "-p", "1",
         "--decoder-name", "saved_models/decoder_rand.pth"]
SMALL = SIZES + ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this file's CPU steps and in-process drives:
    the Tier-1 run puts six test processes on the host's cores, where
    torch's default of one thread per core oversubscribes them (as in
    tests/test_torch_bundle.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _script_line(program):
    (argv,) = [shlex.split(line)[2:] for line in (REPO / "script").read_text().splitlines()
               if line.startswith(f"python {program} ")]
    return argv


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax():
    jact, tact = _actions(jtrain.build_parser()), _actions(ttrain.build_parser())
    assert list(jact) == [d for d in tact if d != "device"]
    for dest, j in jact.items():
        t = tact[dest]
        assert (t.option_strings, t.default, t.type, t.nargs, t.const, type(t)) == \
            (j.option_strings, j.default, j.type, j.nargs, j.const, type(j)), dest
        if dest != "arch":
            assert t.choices == j.choices, dest
    assert tact["arch"].choices == ["pose_resnet101", "pose_resnet50"]
    assert tact["device"].option_strings == ["--device"] and tact["device"].default is None
    assert tact["lr_step"].type is tuple and tact["test_batch"].default == 1


@pytest.mark.parametrize("program", ["train_animal.py", "train_animal_other.py"])
def test_script_lines_parse_alike(program):
    argv = _script_line(program)
    want = vars(jtrain.build_parser().parse_args(argv))
    got = vars(ttrain.build_parser().parse_args(argv))
    assert got.pop("device") is None
    assert got == want
    assert got["decoder_name"] == "saved_models/decoder_animal_0_1.pth.tar"


@pytest.mark.parametrize("flags,item", [
    (["--dist-coordinator", "localhost:1"], "A12"),
    (["--dist-num-processes", "2"], "A12"), (["--dist-process-id", "1"], "A12")])
def test_unported_flags_raise(tmp_path, monkeypatch, flags, item):
    monkeypatch.chdir(tmp_path)
    args = ttrain.build_parser().parse_args(["--device", "cpu"] + flags)
    with pytest.raises(NotImplementedError, match=rf"{flags[0]}.*ROADMAP\.md {item}"):
        ttrain.main(args)
    assert os.listdir(tmp_path) == []


def test_cli_needs_a_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ttrain.main(ttrain.build_parser().parse_args([]))
    assert os.listdir(tmp_path) == []


@pytest.fixture(scope="module")
def run_root(tmp_path_factory):
    """make_animal's tree with the 14-keypoint file, random style weights
    in saved_models/; the CLI runs from here."""
    root = tmp_path_factory.mktemp("animal_cli")
    make_animal(str(root))
    add_other_keypoints(str(root))
    _write_style_weights(str(root / "saved_models"))
    return root


@pytest.fixture
def animal_env(run_root, monkeypatch):
    monkeypatch.setenv("UDA_CACHED_DATA_DIR", str(run_root / "cached_data"))
    monkeypatch.chdir(run_root)
    return str(run_root / "animal_data")


def _line_args(program, image_path, extra=()):
    return ttrain.build_parser().parse_args(
        _script_line(program) + SMALL + ["--image-path", image_path] + list(extra))


class _Stop(Exception):
    pass


def test_datasets_built_in_jax_order(animal_env, monkeypatch):
    """Both packages' trainers, up to their first batch, on the train_animal
    line: the dataset constructors' names, keywords and ``animal`` in call
    order, and the namespace they leave."""
    calls = {"jax": [], "torch": []}
    names = ("synthetic_animal_sp_all", "real_animal_all", "real_animal_all_mt")
    for pkg, side in ((jdata, "jax"), (tdata, "torch")):
        for name in names:
            real = getattr(pkg, name)

            def record(real=real, name=name, side=side, **kw):
                calls[side].append((name, kw["is_train"], kw["animal"],
                                    sorted(set(kw) - {"transforms_stu", "transforms_tea",
                                                      "device", "frame_arena"})))
                return real(**kw)

            monkeypatch.setattr(pkg, name, record)

    def stop(*_a, **_k):
        raise _Stop

    jargs = jtrain.build_parser().parse_args(
        _script_line("train_animal.py") + SIZES + ["--image-path", animal_env])
    monkeypatch.setattr(jtrain, "ForeverDataIterator", stop)
    with pytest.raises(_Stop):
        jtrain.main(jargs)
    targs = _line_args("train_animal.py", animal_env)
    monkeypatch.setattr(ttrain, "ForeverDataIterator", stop)
    with pytest.raises(_Stop):
        ttrain.main(targs)
    assert calls["torch"] == calls["jax"]
    assert [c[:3] for c in calls["torch"]] == [
        ("synthetic_animal_sp_all", True, "all"), ("synthetic_animal_sp_all", False, "all"),
        ("real_animal_all_mt", True, "all"), ("real_animal_all", False, "all"),
        ("real_animal_all", False, "horse"), ("real_animal_all", False, "tiger")]
    assert jargs.animal == targs.animal == "tiger"


# ---------------------------------------------------------------------------
# the slice against JAX
# ---------------------------------------------------------------------------

B, K = 4, 18
CFG = dict(image_size=64, heatmap_size=16, sigma=1.0, k=1, use_sgd=True, occlude_rate=0.5,
           occlude_thresh=-1.0, occlude_size=6, aux_outputs=True,
           recover_min=ttrain.RECOVER_MIN, recover_max=ttrain.RECOVER_MAX,
           gather_exact=False, style_io_dtype="bfloat16")
KEY = jax.random.PRNGKey(3)
GATES = dict(do_s2t=True, alpha_s2t=0.7, do_t2s=True, alpha_t2s=0.3)
ANIMAL18_GROUPS = ("eye", "chin", "hoof", "hip", "knee", "shoulder", "elbow", "all")


def _models(jit_init=False):
    """A tiny JAX PoseResNet with 18 keypoints and a StyleNet, and the port's
    twins with the same weights (scaled as test_torch_train_step's are).
    ``jit_init`` initializes them jitted: ~9 s against ~24 s eagerly on the
    CPU, with weights that differ from the eager ones by float rounding."""
    jmodel = JPoseResNet(backbone=JResNet(block=JBottleneck, stage_sizes=(1, 1, 1, 1)),
                         num_keypoints=K)

    def init(module, *args, **kwargs):
        fn = functools.partial(module.init, **kwargs)
        return jax.device_get((jax.jit(fn) if jit_init else fn)(*args))

    variables = init(jmodel, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False)
    params = jax.tree_util.tree_map(np.array, variables["params"])
    for i in range(3):
        params["upsampling"][f"deconv{i}"]["kernel"] *= 30.0
    params["head"]["kernel"] *= 100.0
    variables = {"params": params, "batch_stats": variables["batch_stats"]}
    jstyle = JStyleNet()
    dummy = jnp.zeros((1, 64, 64, 3), jnp.float32)
    style_params = jax.tree_util.tree_map(
        np.array, init(jstyle, jax.random.PRNGKey(1), dummy, dummy)["params"])
    style_params["decoder"]["conv8"]["Conv_0"]["kernel"] *= 1000.0
    tmodel = weights.load_pose_resnet(PoseResNet(ResNet(Bottleneck, (1, 1, 1, 1)), K),
                                      variables)
    tstyle = weights.load_style_net(StyleNet(), style_params)
    return jmodel, variables, jstyle, style_params, tmodel, tstyle


def _animal_batches(image_path):
    """One collated source and TigDog _mt batch from each package's datasets,
    from the same host RNG state."""
    kw = dict(animal="all", image_path=image_path, inp_res=64, out_res=16, sigma=1,
              scale_factor=0.25, rot_factor=30, label_type="Gaussian", train_on_all_cat=True)
    out = {}
    for side, pkg, T, collate in (("torch", tdata, TT, tdata.default_collate),
                                  ("jax", jdata, JT, jdata.default_collate)):
        src = pkg.synthetic_animal_sp_all(is_train=True, **kw)
        tgt = pkg.real_animal_all_mt(is_train=True, k=1, **view_transforms(T), **kw)
        random.seed(2)
        np.random.seed(2)
        out[side] = (collate([src[i] for i in range(B)]), collate([tgt[i] for i in range(B)]))
    return out


# the two gate cases of the slice: with t2s on, the teacher sees styled
# views that the step rounds to bf16; the two packages' decodes differ by
# ~1e-5, so ~0.6% of those pixels round to the neighbouring bf16 value, and
# the tiny train-mode model turns that into ~5e-3 on the teacher's heatmaps
# and may move an argmax. With s2t alone the teacher's views are the same
# bf16 roundings of equal inputs, and every tolerance of
# test_torch_train_step holds.
SLICE_GATES = {"s2t": dict(GATES, do_t2s=False), "both": GATES}


@pytest.fixture(scope="module")
def slice_run(run_root):
    os.environ["UDA_CACHED_DATA_DIR"] = str(run_root / "cached_data")
    try:
        batches = _animal_batches(str(run_root / "animal_data"))
    finally:
        del os.environ["UDA_CACHED_DATA_DIR"]
    jmodel, variables, jstyle, style_params, tmodel, tstyle = _models()
    jbatch = jengine.make_adapt_batch(*batches["jax"])
    batch = tengine.make_adapt_batch(*batches["torch"])
    for key, value in jbatch.items():
        np.testing.assert_array_equal(batch[key].numpy(), value, err_msg=key)

    jcfg = jts.StepConfig(**CFG, gather_impl="pallas", pallas_interpret=True)
    jstep = jts.make_adapt_step(jmodel, jcfg, style_model=jstyle)  # one compile: gates traced
    tcfg = tts.StepConfig(**CFG)
    runs = {}
    for case, gates in SLICE_GATES.items():
        jstate, jmetrics, jy = jax.device_get(jstep(
            _jax_state(variables, jcfg), style_params, jbatch, jnp.float32(0.01), KEY,
            *(jnp.asarray(gates[n]) for n in ("do_s2t", "alpha_s2t", "do_t2s", "alpha_t2s"))))
        state = tts.create_state(copy.deepcopy(tmodel), tcfg, seed=None, device="cpu")
        state, metrics, y = tts.make_adapt_step(tcfg, style_model=tstyle, device="cpu")(
            state, batch, 0.01, **gates, occlusion_draws=_jax_draws(KEY, B, K))
        runs[case] = dict(jmetrics=jmetrics, jy=jy, metrics=metrics, y=y)
    return dict(runs, jcfg=jcfg)


def _close_bf16(got, want, what):
    """Within one bf16 ulp of the value (at most 2^-7 relative), or the
    float32 tolerance of the largest value."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = np.maximum(np.abs(want) * 2.0 ** -7, 1e-4 * np.abs(want).max())
    err = np.abs(got - want)
    assert (err <= bound).all(), (what, float((err / bound).max()), int((err > bound).sum()))


@pytest.mark.parametrize("case", sorted(SLICE_GATES))
def test_styled_views_are_bf16_and_clamped(slice_run, case):
    aux, jaux = slice_run[case]["metrics"]["aux"], slice_run[case]["jmetrics"]["aux"]
    for name in ("x_s_styled", "x_t_teas_styled"):
        assert aux[name].dtype == torch.bfloat16, name  # bf16 style IO
        styled = aux[name].float().numpy()
        _close_bf16(styled, jaux[name], name)
        assert (styled != np.asarray(jaux[name])).mean() <= 1e-2, name
        # the clamp: within the animal bounds under mean-only normalization
        lo = np.asarray(ttrain.RECOVER_MIN, np.float32)
        hi = np.asarray(ttrain.RECOVER_MAX, np.float32)
        assert (styled.min(axis=(-3, -2)) >= lo - 1e-2).all(), name
        assert (styled.max(axis=(-3, -2)) <= hi + 1e-2).all(), name
    for name in ("loss_all", "loss_s", "loss_c"):
        _close(slice_run[case]["metrics"][name].numpy(), slice_run[case]["jmetrics"][name],
               1e-3, name)


def test_adapt_step_matches_jax_on_animal_batch(slice_run):
    run = slice_run["s2t"]
    aux, jaux = run["metrics"]["aux"], run["jmetrics"]["aux"]
    np.testing.assert_array_equal(aux["x_t_teas_styled"].float().numpy(),
                                  np.asarray(jaux["x_t_teas_styled"]))
    for name in ("y_t_tea_recon", "activates", "mask_thresh", "y_t_stu_recon"):
        _close(aux[name].numpy(), jaux[name], 1e-3, name)
    np.testing.assert_array_equal(aux["tea_mask"].numpy(), np.asarray(jaux["tea_mask"]))
    assert 0 < aux["tea_mask"].sum() < aux["tea_mask"].numel()
    np.testing.assert_allclose(aux["y_t_tea_rect"].numpy(), np.asarray(jaux["y_t_tea_rect"]),
                               rtol=1e-6, atol=1e-7)
    geom = [np.asarray(g) for g in jts._occlusion_geometry(
        KEY, jnp.asarray(jaux["y_t_tea_recon"]), slice_run["jcfg"])]
    np.testing.assert_array_equal(aux["occlude"].numpy(), geom[0])
    assert geom[0].any()
    np.testing.assert_array_equal(aux["occlusion_rect"].numpy(), np.stack(geom[1:], -1))
    got, want = aux["x_t_stu_final"].numpy(), np.asarray(jaux["x_t_stu_final"])
    assert (got != want).mean() <= 1e-3
    # gather_exact=False: the occluded view holds bf16 values
    np.testing.assert_array_equal(got, torch.from_numpy(got).bfloat16().float().numpy())
    for name in ("loss_all", "loss_s", "loss_c", "acc_s"):
        _close(run["metrics"][name].numpy(), run["jmetrics"][name], 1e-3, name)
    assert int(run["metrics"]["acc_cnt"]) == int(run["jmetrics"]["acc_cnt"])
    # the student's source heatmaps see the styled source, whose bf16
    # rounding differs in ~0.6% of its pixels (2e-3 measured)
    _close(run["y"].numpy(), run["jy"], 1e-2, "y_s")


def _hinted_eval_steps(jmodel, hint):
    """Both packages' eval steps with ``hint`` x the target added to the
    model's heatmaps: a random-init model scores PCK 0 on these frames, and
    the hint moves some argmaxes onto the truth and leaves others."""
    from uda_poseestimation_tpu.models.loss import joints_mse_loss as jmse
    from uda_poseestimation_tpu.ops.pck import keypoint_pck_accuracy as jpck
    from uda_poseestimation_torch.models.loss import joints_mse_loss as tmse
    from uda_poseestimation_torch.ops.pck import keypoint_pck_accuracy as tpck

    @jax.jit
    def jeval(params, stats, x, label, weight):
        y = jmodel.apply({"params": params, "batch_stats": stats}, x, train=False)
        y = y + hint * label
        return y, jmse(y, label, weight[..., 0]), jpck(y, label)[0]

    @torch.no_grad()
    def teval(model, x, label, weight):
        model.eval()
        y = model(x.permute(0, 3, 1, 2)) + hint * label
        return y, tmse(y, label, weight[..., 0]), tpck(y, label)[0]

    return jeval, teval


@pytest.mark.parametrize("hint", [0.0, 3.0])
def test_validation_pck_matches_jax_at_test_batch_1(animal_env, hint):
    """One run_validate of each package, --test-batch 1, on the same weights
    over the source, the target and the horse and tiger sets: the same
    groups, the same values. ``hint`` 0 is the model alone (PCK 0 at random
    init); 3 adds the target to its heatmaps, so that the groups hold values
    between 0 and 1."""
    jmodel, variables, _, _, tmodel, _ = _models()
    jeval, teval = _hinted_eval_steps(jmodel, hint)
    args = argparse.Namespace(val_print_freq=500, image_size=64, heatmap_size=16)
    kw = dict(image_path=animal_env, inp_res=64, out_res=16, sigma=1, scale_factor=0.25,
              rot_factor=30, label_type="Gaussian", train_on_all_cat=True)
    values = []
    for name, animal in (("synthetic_animal_sp_all", "all"), ("real_animal_all", "all"),
                         ("real_animal_all", "horse"), ("real_animal_all", "tiger")):
        jds = jdata.__dict__[name](is_train=False, animal=animal, **kw)
        tds = tdata.__dict__[name](is_train=False, animal=animal, **kw)
        want = jengine.run_validate(jeval, variables["params"], variables["batch_stats"],
                                    jdata.DataLoader(jds, batch_size=1), args)
        got = tengine.run_validate(teval, tmodel, tdata.make_loader(tds, 1), args)
        assert list(got) == list(want) == list(ANIMAL18_GROUPS)
        for group in want:
            assert float(got[group]) == float(want[group]), (name, animal, group)
        values += [float(v) for v in want.values()]
    if hint:
        assert any(0 < v < 1 for v in values), values


# ---------------------------------------------------------------------------
# CPU drives
# ---------------------------------------------------------------------------

def _numbers(line):
    return [float(v) for v in re.findall(r"[-+]?\d+\.\d+(?:e[-+]\d+)?", line)]


def _epoch_lines(text):
    return [line for line in text.splitlines()
            if line.startswith("Epoch: ") and "Target(best)" in line]


def _run_cli(run_root, module, argv):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2",
               UDA_CACHED_DATA_DIR=str(run_root / "cached_data"))
    proc = subprocess.run([sys.executable, "-m", module, *argv], cwd=run_root, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _check_epoch_log(text, categories, groups):
    """The epoch line with its category parts, then Source:, Target: and each
    category, each followed by its group lines; every value finite."""
    lines = text.splitlines()
    (epoch,) = _epoch_lines(text)
    value = r" (-?\d+\.\d+|nan|inf)"
    assert re.fullmatch(r"Epoch: \d+ Source:" + value + " Target:" + value + "".join(
        f" {c.capitalize()}:" + value for c in categories) + r" Target\(best\):" + value,
        epoch), epoch
    assert all(math.isfinite(v) for v in _numbers(epoch)), epoch
    at = lines.index(epoch)
    for header in ["Source:", "Target:"] + [c.capitalize() + ":" for c in categories]:
        at = lines.index(header, at)
        block = lines[at + 1:at + 1 + len(groups)]
        assert [b.split(":")[0] for b in block] == list(groups), header
        assert all(math.isfinite(float(b.split()[1])) for b in block), header
    return epoch


@pytest.fixture(scope="module")
def pretrained(run_root):
    """A checkpoint that the port's ``save_checkpoint`` writes: a
    pose_resnet50 student and teacher (18 keypoints) from seed 3."""
    state = create_state(models.pose_resnet50(num_keypoints=18, dtype=torch.bfloat16),
                         StepConfig(image_size=64, heatmap_size=16), seed=3, device="cpu")
    path = run_root / "pretrained.pth"
    tckpt.save_checkpoint(str(path), {"student": state.student, "teacher": state.teacher,
                                      "epoch": 0, "args": {"arch": "pose_resnet50"}})
    return path


def test_cli_pretrain_epoch_on_cpu(run_root):
    argv = _script_line("train_animal.py") + SMALL + [
        "--image-path", str(run_root / "animal_data"), "--epochs", "1", "--pretrain-epoch",
        "1", "-i", "2", "--log", "logs/pretrain"]
    stdout = _run_cli(run_root, "uda_poseestimation_torch.train_animal", argv)
    (log,) = (run_root / "logs" / "pretrain_pose_resnet50").glob("train-*.txt")
    text = log.read_text()
    lines = text.splitlines()
    first = lines.index("Source train: 3")
    assert lines[first:first + 4] == ["Source train: 3", "Target train: 3", "Source test: 4",
                                      "Target test: 4"]
    _check_epoch_log(text, ("horse", "tiger"), ANIMAL18_GROUPS)
    steps = [line for line in stdout.splitlines() if line.startswith("Epoch: [0][")]
    assert len(steps) == 2 and not any("Loss (c)" in line for line in steps)
    for line in steps:
        assert all(math.isfinite(v) for v in _numbers(line)), line


def test_cli_adapts_from_a_pretrain_checkpoint(run_root, pretrained):
    argv = _script_line("train_animal.py") + SMALL + [
        "--image-path", str(run_root / "animal_data"), "--epochs", "1", "--pretrain-epoch",
        "-1", "-i", "2", "--pretrain", str(pretrained), "--log", "logs/adapt"]
    stdout = _run_cli(run_root, "uda_poseestimation_torch.train_animal", argv)
    (log,) = (run_root / "logs" / "adapt_pose_resnet50").glob("train-*.txt")
    _check_epoch_log(log.read_text(), ("horse", "tiger"), ANIMAL18_GROUPS)
    steps = [line for line in stdout.splitlines() if line.startswith("Epoch: [0][")]
    assert len(steps) == 2 and all("Loss (c)" in line for line in steps)
    for line in steps:
        assert all(math.isfinite(v) for v in _numbers(line)), line


def test_cli_best_pt_reload_bundled(animal_env, run_root, pretrained, monkeypatch, capsys):
    """``--pretrain-epoch 0``: epoch 0 reloads ``best_pt`` (put where the
    pretrain epochs would have saved it) into the student and the teacher,
    then adapts with ``--steps-per-dispatch 2``."""
    restored = []

    def restore(state, checkpoint, **kw):
        out = tckpt.restore_train_state(state, checkpoint, **kw)
        restored.append((kw, all(torch.equal(module.state_dict()[k], v)
                                 for module in (state.student, state.teacher)
                                 for k, v in checkpoint["student"].items())))
        return out

    monkeypatch.setattr(thuman, "restore_train_state", restore)  # run_training's
    monkeypatch.setattr(ttrain, "CompleteLogger", functools.partial(CompleteLogger, now="fixed"))
    want = "checkpoints/reload_pose_resnet50/checkpoints_fixed/best_pt.pth"
    os.makedirs(os.path.dirname(want), exist_ok=True)
    if not os.path.exists(want):
        os.link(pretrained, want)
    ttrain.main(_line_args("train_animal.py", animal_env, [
        "--epochs", "1", "--pretrain-epoch", "0", "-i", "3", "--steps-per-dispatch", "2",
        "--log", "logs/reload"]))
    assert restored == [({"teacher_source": "student"}, True)]
    steps = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("Epoch: [0][")]
    assert len(steps) == 3 and all("Loss (c)" in line for line in steps)
    text = (run_root / "logs" / "reload_pose_resnet50" / "train-fixed.txt").read_text()
    _check_epoch_log(text, ("horse", "tiger"), ANIMAL18_GROUPS)


def test_cli_test_phase_resumes_its_checkpoint(animal_env, run_root, pretrained):
    ttrain.main(_line_args("train_animal.py", animal_env, [
        "--phase", "test", "--resume", str(pretrained), "--log", "logs/test"]))
    (log,) = (run_root / "logs" / "test_pose_resnet50").glob("test-*.txt")
    lines = log.read_text().splitlines()
    (result,) = [line for line in lines if line.startswith("Source: ")]
    assert "Horse: " in result and "Tiger: " in result
    assert all(math.isfinite(v) for v in _numbers(result))
    # the target's groups, then each category's under its name
    assert lines[lines.index(result) + 1].startswith("eye: ")
    assert lines.index("Horse:") < lines.index("Tiger:") and lines[-1].startswith("all: ")


def test_other_cli_adapts_on_animal_pose(fake_animal_pose, run_root):  # noqa: F811
    """train_animal_other's line (synthetic hound/sheep, 14 keypoints, to
    AnimalPose) for one adapt epoch through ``python -m``, from a
    14-keypoint checkpoint, on one tree holding both fixtures."""
    root = Path(fake_animal_pose).parent
    make_animal(str(root))
    add_other_keypoints(str(root))
    os.symlink(run_root / "saved_models", root / "saved_models")
    state = create_state(models.pose_resnet50(num_keypoints=14, dtype=torch.bfloat16),
                         StepConfig(image_size=64, heatmap_size=16), seed=4, device="cpu")
    tckpt.save_checkpoint(str(root / "pretrained14.pth"),
                          {"student": state.student, "teacher": state.teacher, "epoch": 0})
    argv = _script_line("train_animal_other.py") + SMALL + [
        "--image-path", fake_animal_pose, "--epochs", "1", "--pretrain-epoch", "-1", "-i", "1",
        "--pretrain", str(root / "pretrained14.pth"), "--log", "logs/other"]
    stdout = _run_cli(root, "uda_poseestimation_torch.train_animal_other", argv)
    (log,) = (root / "logs" / "other_pose_resnet50").glob("train-*.txt")
    _check_epoch_log(log.read_text(), ("dog", "sheep"), ("eye", "hoof", "knee", "elbow", "all"))
    steps = [line for line in stdout.splitlines() if line.startswith("Epoch: [0][")]
    assert len(steps) == 1 and "Loss (c)" in steps[0]
