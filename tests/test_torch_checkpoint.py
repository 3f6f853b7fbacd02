"""Checkpoints across the two packages, on a tiny PoseResNet (Bottleneck
(1, 1, 1, 1), 5 keypoints).

- JAX ``save_checkpoint`` -> the port's ``load_checkpoint`` +
  ``restore_train_state``: the student, the teacher (or the student again,
  ``teacher_source="student"``) and every BatchNorm buffer equal the JAX
  variables bit for bit; the optax optimizer state is refused with the JAX
  package's log line and the port's optimizer left fresh.
- The port's ``save_checkpoint`` -> JAX ``load_checkpoint`` +
  ``restore_train_state``: the JAX variables equal the port's bit for bit.
- The port -> the port with ``load_optimizer``: parameters, buffers and the
  Adam state equal bit for bit, and one more step from each state gives
  equal losses and parameters.
- ``filtered_update`` takes the entries whose key and shape match and keeps
  the rest, as the JAX package's does.

Tolerance: none; every value is a copy.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uda_poseestimation_tpu.models.pose_resnet import PoseResNet as JPoseResNet
from uda_poseestimation_tpu.models.resnet import Bottleneck as JBottleneck
from uda_poseestimation_tpu.models.resnet import ResNet as JResNet
from uda_poseestimation_tpu.parallel import make_mesh
from uda_poseestimation_tpu.parallel import train_step as jts
from uda_poseestimation_tpu.utils import checkpoint as jckpt
from uda_poseestimation_torch import weights
from uda_poseestimation_torch.models import Bottleneck, PoseResNet, ResNet
from uda_poseestimation_torch.parallel import train_step as tts
from uda_poseestimation_torch.utils import checkpoint as tckpt

K = 5
ARGS = argparse.Namespace(lr=1e-4, lr_step=[45, 60], seed=0)


def _tmodel(k=K):
    return PoseResNet(ResNet(Bottleneck, (1, 1, 1, 1)), k)


def _jstate():
    cfg = jts.StepConfig(image_size=64, heatmap_size=16)
    state = jts.create_state(JPoseResNet(backbone=JResNet(block=JBottleneck,
                                                          stage_sizes=(1, 1, 1, 1)),
                                         num_keypoints=K),
                             jax.random.PRNGKey(3), cfg, batch_size=2)
    # distinct teacher and statistics, so that a swapped entry shows
    rng = np.random.RandomState(0)
    perturb = lambda x: jnp.asarray(np.asarray(x) * 0.5 + rng.rand(*np.shape(x)))  # noqa: E731
    return state.replace(teacher_params=jax.tree_util.tree_map(perturb, state.teacher_params),
                         student_stats=jax.tree_util.tree_map(perturb, state.student_stats),
                         teacher_stats=jax.tree_util.tree_map(perturb, state.teacher_stats))


def _variables(params, stats):
    return {"params": jax.device_get(params), "batch_stats": jax.device_get(stats)}


def _assert_module_equals(module, sd):
    own = module.state_dict()
    for k, v in sd.items():
        assert torch.equal(own[k], torch.as_tensor(np.asarray(v))), k
    assert {k for k in own if not k.endswith("num_batches_tracked")} == set(sd)


def _tstate(seed, cfg=None):
    cfg = cfg or tts.StepConfig(image_size=64, heatmap_size=16)
    return tts.create_state(_tmodel(), cfg, seed=seed, device="cpu")


@pytest.mark.parametrize("teacher_source", ["teacher", "student"])
def test_jax_checkpoint_loads_into_the_port(tmp_path, teacher_source):
    js = _jstate()
    path = str(tmp_path / "best_pt.pth")
    jckpt.save_checkpoint(path, {
        "student": _variables(js.student_params, js.student_stats),
        "teacher": _variables(js.teacher_params, js.teacher_stats),
        "stu_optimizer": js.opt_state,
        "lr_scheduler": {"epoch": 3, "milestones": [45, 60], "gamma": 0.1},
        "epoch": 3, "args": ARGS})
    ckpt = tckpt.load_checkpoint(path)
    assert ckpt["format"] == "uda_poseestimation_tpu" and ckpt["epoch"] == 3
    assert ckpt["args"]["lr_step"] == [45, 60]
    state = _tstate(seed=9)
    fresh_opt = state.optimizer.state_dict()
    logged = []
    tckpt.restore_train_state(state, ckpt, teacher_source=teacher_source,
                              load_optimizer=True, log=logged.append)
    assert logged == ["resume: optimizer state incompatible; reinitialized"]
    assert state.optimizer.state_dict() == fresh_opt
    want_tea = (js.teacher_params, js.teacher_stats) if teacher_source == "teacher" else \
        (js.student_params, js.student_stats)
    _assert_module_equals(state.student, weights.pose_resnet_state_dict(
        _variables(js.student_params, js.student_stats)))
    _assert_module_equals(state.teacher, weights.pose_resnet_state_dict(
        _variables(*want_tea)))


def test_port_checkpoint_loads_into_jax(tmp_path):
    state = _tstate(seed=4)
    with torch.no_grad():  # distinct teacher and statistics
        for p in state.teacher.parameters():
            p.mul_(0.5).add_(0.25)
        for m in (state.student, state.teacher):
            for name, b in m.named_buffers():
                if name.endswith("running_var"):
                    b.add_(torch.rand(b.shape, generator=torch.Generator().manual_seed(1)))
    path = str(tmp_path / "ckpt" / "best.pth")
    tckpt.save_checkpoint(path, {
        "student": state.student, "teacher": state.teacher,
        "stu_optimizer": state.optimizer,
        "lr_scheduler": {"epoch": 1, "milestones": [45, 60], "gamma": 0.1},
        "epoch": 1, "args": ARGS})
    raw = torch.load(path, weights_only=False)
    assert raw["format"] == "uda_poseestimation_torch" and raw["args"] == vars(ARGS)
    assert all(k.startswith("module.") for k in raw["student"])

    ckpt = jckpt.load_checkpoint(path)
    assert ckpt["epoch"] == 1
    js = jckpt.restore_train_state(_jstate(), ckpt, make_mesh(1), load_optimizer=True)
    for module, params, stats in ((state.student, js.student_params, js.student_stats),
                                  (state.teacher, js.teacher_params, js.teacher_stats)):
        want = weights.pose_resnet_state_dict(_variables(params, stats))
        _assert_module_equals(module, want)


def _batch(seed, b=2):
    rng = np.random.RandomState(seed)
    return {"image_s": rng.rand(b, 64, 64, 3).astype(np.float32),
            "target_s": rng.rand(b, K, 16, 16).astype(np.float32),
            "weight_s": np.ones((b, K, 1), np.float32)}


def test_port_resume_restores_the_optimizer(tmp_path):
    state = _tstate(seed=1)
    step = tts.make_pretrain_step(tts.StepConfig(image_size=64, heatmap_size=16),
                                  device="cpu")
    for i in range(2):
        step(state, _batch(i), 1e-3)
    path = str(tmp_path / "best_pt.pth")
    tckpt.save_checkpoint(path, {"student": state.student, "teacher": state.teacher,
                                 "stu_optimizer": state.optimizer, "epoch": 0,
                                 "args": ARGS})
    resumed = _tstate(seed=2)
    tckpt.restore_train_state(resumed, tckpt.load_checkpoint(path), load_optimizer=True,
                              log=pytest.fail)
    for a, b in ((state.student, resumed.student), (state.teacher, resumed.teacher)):
        for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb), ka
    want, got = state.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert want["param_groups"] == got["param_groups"]
    assert want["state"].keys() == got["state"].keys() and len(want["state"]) > 0
    for i, entry in want["state"].items():
        for name, value in entry.items():
            assert torch.equal(value, got["state"][i][name]), (i, name)
    _, m1, _ = step(state, _batch(5), 1e-3)
    _, m2, _ = step(resumed, _batch(5), 1e-3)
    assert float(m1["loss_all"]) == float(m2["loss_all"])
    for pa, pb in zip(state.student.parameters(), resumed.student.parameters()):
        assert torch.equal(pa, pb)


def test_filtered_update_matches_jax():
    own = _tmodel().state_dict()
    loaded = {k: v.numpy() + 1.0 for k, v in _tmodel(k=7).state_dict().items()
              if not k.endswith("num_batches_tracked")}
    loaded["not.in.the.model"] = np.zeros(3, np.float32)
    got = tckpt.filtered_update(own, loaded)
    want = jckpt.filtered_update({k: v.numpy() for k, v in own.items()}, loaded)
    assert list(got) == list(own)
    for k, v in got.items():
        assert v.dtype == own[k].dtype and np.array_equal(v.numpy(), want[k]), k
    # the 7-keypoint head does not fit: kept; the rest is taken
    assert torch.equal(got["head.weight"], own["head.weight"])
    assert torch.equal(got["backbone.conv1.weight"],
                       torch.from_numpy(loaded["backbone.conv1.weight"]))
    assert torch.equal(got["backbone.bn1.num_batches_tracked"],
                       own["backbone.bn1.num_batches_tracked"])
