"""The port's multi-process data parallelism (``parallel/distributed.py``,
``parallel/sync_bn.py``) against the JAX package and against one process.

W gloo ranks, spawned on the CPU (``_torch_dist_worker.py``, a rendezvous
file per group, one thread each, 60 s collective timeout), each take their
contiguous rows of a global batch; they must compute what one process
computes on the whole batch:

- the partition arithmetic, the control stream and the training loaders'
  indices equal the JAX package's (no group needed);
- float64 train-mode BatchNorm over 2 ranks: its output, Flax-rule running
  statistics and the input's and the weight's gradients equal one process's
  ``BatchNorm2d`` on the concatenated batch to 1e-10 relative;
- the adapt step at 2 ranks x 2 rows and 4 ranks x 1 row, each rank given
  its rows of the JAX key's draws, against the JAX step on the whole batch
  (``tests/test_torch_train_step.py``'s models, batch and one-step
  tolerances): the kth-value threshold, the teacher mask and the occlusion
  gate and rectangles exactly equal; losses, PCK and the gathered aux
  tensors at that file's tolerances; the all-reduced gradients and the SGD
  deltas 5e-2 in norm; BatchNorm statistics 1e-3; every rank's updated
  student and teacher bit-equal;
- the pretrain step (s2t off and on) and the eval step's loss and PCK
  likewise at 2 ranks, and ``run_validate`` over a loader with a partial
  last batch equal to one process's group accuracy;
- ``AdaptStepBundler`` at n = 2 under 2 ranks equals two unbundled 2-rank
  steps bit for bit, with the occlusion draws from the generator;
- the ``--device-aug`` pipelines' draws of a rank are its rows of one
  process's global draws.
"""

import argparse
import multiprocessing
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
from test_torch_train_step import (B, CFG, GATES, K, KEY, LR, _batch, _close, _close_norm,
                                   _jax_draws, _jax_state)
from uda_poseestimation_tpu.models import StyleNet as JStyleNet
from uda_poseestimation_tpu.models.pose_resnet import PoseResNet as JPoseResNet
from uda_poseestimation_tpu.models.resnet import Bottleneck as JBottleneck
from uda_poseestimation_tpu.models.resnet import ResNet as JResNet
from uda_poseestimation_tpu.data.loader import DataLoader as JDataLoader
from uda_poseestimation_tpu.parallel import distributed as jdist
from uda_poseestimation_tpu.parallel import train_step as jts
from uda_poseestimation_torch import weights
from uda_poseestimation_torch.data.loader import PartitionSampler
from uda_poseestimation_torch.engine import AnimalDeviceAugPipeline, DeviceAugPipeline
from uda_poseestimation_torch.models import Bottleneck, PoseResNet, ResNet, StyleNet
from uda_poseestimation_torch.parallel import distributed as dist
from uda_poseestimation_torch.parallel import train_step as tts

SPAWN_TIMEOUT_S = 150


def start_ranks(world, job, work_dir):
    """Spawn ``world`` ranks on ``job``; ``join_ranks`` waits for them."""
    os.makedirs(work_dir, exist_ok=True)
    torch.save(job, os.path.join(work_dir, "job.pt"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.run, args=(r, world, str(work_dir)))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, work_dir


def join_ranks(procs, work_dir):
    """The ranks' outputs in rank order. A rank that fails or hangs fails
    the test (all are killed)."""
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert [p.exitcode for p in procs] == [0] * len(procs)
    out = []
    for r in range(len(procs)):  # hundreds of MB: removed once read
        path = os.path.join(work_dir, f"rank{r}.pt")
        out.append(torch.load(path, weights_only=False))
        os.remove(path)
    os.remove(os.path.join(work_dir, "job.pt"))
    return out


# ---------------------------------------------------------------------------
# (a), (b): no group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,epoch", [(0, 0), (12, 3), (2 ** 40 + 5, 7)])
def test_control_rng_matches_jax(seed, epoch):
    want = jdist.control_rng(seed, epoch)
    got = dist.control_rng(seed, epoch)
    np.testing.assert_array_equal(got.rand(8), want.rand(8))
    assert got.randint(0, 2 ** 31 - 1) == want.randint(0, 2 ** 31 - 1)


@pytest.mark.parametrize("rank,world", [(0, 1), (0, 2), (1, 2), (3, 4), (2, 8)])
def test_partition_arithmetic_matches_jax(monkeypatch, rank, world):
    # JAX's partition as a rank of ``world`` sees it
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(jax, "process_count", lambda: world)
    for n in (8, 32, 64):
        assert dist.local_batch_size(n, world) == jdist.local_batch_size(n)
        assert dist.local_rows(n, rank, world) == jdist.local_rows(n)
    if world > 1:
        with pytest.raises(ValueError, match="not divisible"):
            jdist.local_batch_size(world + 1)
        with pytest.raises(ValueError, match="not divisible"):
            dist.local_batch_size(world + 1, world)
        with pytest.raises(ValueError, match="not divisible"):
            dist.local_rows(world + 1, rank, world)


def test_no_group_means_one_process():
    assert not dist.is_active()
    assert (dist.process_count(), dist.process_index(), dist.is_primary(),
            dist.is_multiprocess()) == (1, 0, True, False)
    tree = {"a": torch.arange(4)}
    assert dist.global_draw(lambda n: tree if n == 5 else None, 5) is tree
    assert dist.broadcast_str("2026-01-01") == "2026-01-01"
    args = argparse.Namespace(dist_coordinator=None, dist_num_processes=2,
                              dist_process_id=0, seed=None, batch_size=3)
    assert dist.maybe_initialize_from_args(args) is False and args.seed is None


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.asarray(i)


@pytest.mark.parametrize("world", [2, 4])
def test_partition_sampler_matches_jax_loader(world):
    """Every rank's indices over 3 passes, through a torch DataLoader with
    the sampler, equal JAX's ``DataLoader(partition=(rank, W), seed=s)``."""
    from uda_poseestimation_torch.data import make_loader

    n, seed, batch = 37, 11, 2
    for rank in range(world):
        jax_loader = JDataLoader(_Items(n), batch_size=batch, shuffle=True, drop_last=True,
                                 partition=(rank, world), seed=seed)
        sampler = PartitionSampler(n, rank, world, seed)
        loader = make_loader(_Items(n), batch, drop_last=True, sampler=sampler)
        assert len(loader) == len(jax_loader)
        for _ in range(3):
            want = np.concatenate([np.asarray(b) for b in jax_loader])
            got = np.concatenate([b.numpy() for b in loader])
            np.testing.assert_array_equal(got, want)
        assert sampler.epoch == 3


# ---------------------------------------------------------------------------
# (c)-(f): gloo ranks
# ---------------------------------------------------------------------------

def _models():
    """``test_torch_train_step._models`` with jitted initializers (the
    eager ones take ~20 s more): the same model, scalings and port twins."""
    jmodel = JPoseResNet(backbone=JResNet(block=JBottleneck, stage_sizes=(1, 1, 1, 1)),
                         num_keypoints=K)
    variables = jax.device_get(jax.jit(lambda key: jmodel.init(
        key, jnp.zeros((1, 64, 64, 3)), train=False))(jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_map(np.array, variables["params"])
    for i in range(3):
        params["upsampling"][f"deconv{i}"]["kernel"] *= 30.0
    params["head"]["kernel"] *= 100.0
    variables = {"params": params, "batch_stats": variables["batch_stats"]}
    jstyle = JStyleNet()
    dummy = jnp.zeros((1, 64, 64, 3), jnp.float32)
    style_params = jax.tree_util.tree_map(np.array, jax.device_get(jax.jit(
        lambda key: jstyle.init(key, dummy, dummy))(jax.random.PRNGKey(1))["params"]))
    style_params["decoder"]["conv8"]["Conv_0"]["kernel"] *= 1000.0
    tmodel = weights.load_pose_resnet(PoseResNet(ResNet(Bottleneck, (1, 1, 1, 1)), K),
                                      variables)
    tstyle = weights.load_style_net(StyleNet(), style_params)
    return jmodel, variables, jstyle, style_params, tmodel, tstyle


def _job():
    """The models, batches and draws that the rank jobs read."""
    jmodel, variables, jstyle, style_params, tmodel, tstyle = _models()
    batch = _batch(0)
    rng = np.random.RandomState(5)
    bn_x = rng.randn(4, 3, 5, 5) * 2.0 + 0.5
    job = {"jobs": ["bn", "adapt", "pretrain", "evaluate", "bundle", "views"],
           "num_keypoints": K, "cfg": CFG, "lr": LR, "gates": GATES,
           "pose": tmodel.state_dict(), "style": tstyle.state_dict(), "batch": batch,
           "draws": _jax_draws(KEY, B, K),
           "pretrain_batch": {k: _batch(1)[k] for k in ("image_s", "target_s", "weight_s",
                                                        "image_t_style")},
           "eval_batch": {k: _batch(2)[k] for k in ("image_s", "target_s", "weight_s")},
           "val_args": argparse.Namespace(val_print_freq=100, image_size=64, heatmap_size=16),
           "bundle_batches": [_batch(3), _batch(4)],
           "bundle_gates": [(True, 0.4, False, 0.0), (False, 0.0, True, 0.8)],
           "views_b": 3,
           "x": bn_x, "weight": rng.rand(3) + 0.5, "bias": rng.randn(3),
           "dy": rng.randn(*bn_x.shape)}
    return job, dict(jmodel=jmodel, variables=variables, jstyle=jstyle,
                     style_params=style_params, tmodel=tmodel, tstyle=tstyle)


def _jax_steps(job, m):
    """The JAX adapt step, pretrain step (s2t off and on) and eval step on
    the whole batches."""
    jcfg = jts.StepConfig(**CFG)
    jbatch = {k: v for k, v in job["batch"].items() if k != "image_t_style"}
    jstep = jts.make_adapt_step(m["jmodel"], jcfg, style_model=m["jstyle"])
    jstate, jmetrics, jy = jax.device_get(jstep(
        _jax_state(m["variables"], jcfg), m["style_params"], jbatch, jnp.float32(LR), KEY,
        *(jnp.asarray(GATES[n]) for n in ("do_s2t", "alpha_s2t", "do_t2s", "alpha_t2s"))))
    out = {"adapt": dict(jstate=jstate, jmetrics=jmetrics, jy=jy, jcfg=jcfg), "pretrain": {}}
    pstep = jts.make_pretrain_step(m["jmodel"], jcfg, style_model=m["jstyle"])
    for do_s2t in (False, True):
        out["pretrain"][do_s2t] = jax.device_get(pstep(
            _jax_state(m["variables"], jcfg), m["style_params"], job["pretrain_batch"],
            jnp.float32(LR), jnp.bool_(do_s2t), jnp.float32(0.6)))
    batch = job["eval_batch"]
    out["eval"] = jax.device_get(jts.make_eval_step(m["jmodel"])(
        m["variables"]["params"], m["variables"]["batch_stats"], batch["image_s"],
        batch["target_s"], batch["weight_s"]))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """2 ranks on every job and 4 ranks on the adapt step, spawned together;
    the JAX steps run meanwhile."""
    job, m = _job()
    two = start_ranks(2, job, tmp_path_factory.mktemp("two_ranks"))
    four = start_ranks(4, dict(job, jobs=["adapt"]), tmp_path_factory.mktemp("four_ranks"))
    try:
        jax_out = _jax_steps(job, m)
    finally:
        ranks = {2: join_ranks(*two), 4: join_ranks(*four)}
    return dict(job=job, models=m, jax=jax_out, ranks=ranks)


@pytest.fixture(scope="module")
def two_ranks(run):
    return run["ranks"][2]


@pytest.fixture(scope="module")
def models_and_job(run):
    return run["job"], run["models"]


@pytest.fixture(scope="module")
def jax_adapt(run):
    return run["jax"]["adapt"]


@pytest.fixture(params=[2, 4], ids=["2x2rows", "4x1row"])
def adapt_ranks(request, run):
    return [r["adapt"] for r in run["ranks"][request.param]]


def _gathered(ranks, name):
    return np.concatenate([r["metrics"]["aux"][name] for r in ranks])


def test_sync_bn_float64_matches_one_process(two_ranks, models_and_job):
    from uda_poseestimation_torch.models.resnet import BatchNorm2d

    job = models_and_job[0]
    layer = BatchNorm2d(3).double().train()
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(job["weight"]))
        layer.bias.copy_(torch.from_numpy(job["bias"]))
    x = torch.from_numpy(job["x"]).requires_grad_(True)
    y = layer(x)
    (y * torch.from_numpy(job["dy"])).sum().backward()
    ranks = [r["bn"] for r in two_ranks]

    def close(got, want, what):
        want = np.asarray(want)
        err = np.abs(got - want).max()
        assert err <= 1e-10 * np.abs(want).max(), f"{what}: {err}"

    close(np.concatenate([r["y"] for r in ranks]), y.detach().numpy(), "y")
    close(np.concatenate([r["x_grad"] for r in ranks]), x.grad.numpy(), "x.grad")
    # each rank's weight and bias gradients are its rows' sums
    close(sum(r["weight_grad"] for r in ranks), layer.weight.grad.numpy(), "weight.grad")
    close(sum(r["bias_grad"] for r in ranks), layer.bias.grad.numpy(), "bias.grad")
    for r in ranks:
        close(r["running_mean"], layer.running_mean.numpy(), "running_mean")
        close(r["running_var"], layer.running_var.numpy(), "running_var")
    assert ranks[0]["running_var"].tobytes() == ranks[1]["running_var"].tobytes()


def test_adapt_decisions_equal_jax(adapt_ranks, jax_adapt):
    jaux = jax_adapt["jmetrics"]["aux"]
    for r in adapt_ranks:  # the threshold is the whole batch's, on every rank
        assert float(r["metrics"]["aux"]["mask_thresh"]) == float(
            adapt_ranks[0]["metrics"]["aux"]["mask_thresh"])
    _close(adapt_ranks[0]["metrics"]["aux"]["mask_thresh"], jaux["mask_thresh"], 1e-3,
           "mask_thresh")
    tea_mask = _gathered(adapt_ranks, "tea_mask")
    np.testing.assert_array_equal(tea_mask, np.asarray(jaux["tea_mask"]))
    assert 0 < tea_mask.sum() < tea_mask.size
    geom = [np.asarray(g) for g in jts._occlusion_geometry(
        KEY, jnp.asarray(jaux["y_t_tea_recon"]), jax_adapt["jcfg"])]
    np.testing.assert_array_equal(_gathered(adapt_ranks, "occlude"), geom[0])
    assert 0 < geom[0].sum() < B
    np.testing.assert_array_equal(_gathered(adapt_ranks, "occlusion_rect"),
                                  np.stack(geom[1:], -1))
    np.testing.assert_allclose(_gathered(adapt_ranks, "y_t_tea_rect"),
                               np.asarray(jaux["y_t_tea_rect"]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name,rel", [("x_s_styled", 1e-4), ("x_t_teas_styled", 1e-4),
                                      ("y_t_tea_recon", 1e-3), ("activates", 1e-3),
                                      ("y_t_stu_recon", 1e-3)])
def test_adapt_aux_floats_match_jax(adapt_ranks, jax_adapt, name, rel):
    axis = 1 if name == "x_t_teas_styled" else 0
    got = np.concatenate([r["metrics"]["aux"][name] for r in adapt_ranks], axis=axis)
    _close(got, jax_adapt["jmetrics"]["aux"][name], rel, name)


def test_adapt_losses_match_jax(adapt_ranks, jax_adapt):
    jm = jax_adapt["jmetrics"]
    for r in adapt_ranks:
        for name in ("loss_all", "loss_s", "loss_c", "acc_s"):
            _close(r["metrics"][name], jm[name], 1e-3, name)
        assert int(r["metrics"]["acc_cnt"]) == int(jm["acc_cnt"])
    _close(np.concatenate([r["y"] for r in adapt_ranks]), jax_adapt["jy"], 1e-3, "y_s")


def test_adapt_grads_and_sgd_deltas_match_jax(adapt_ranks, jax_adapt, models_and_job):
    jgrads = weights.pose_resnet_state_dict({"params": jax_adapt["jmetrics"]["aux"]["grads"]})
    variables = models_and_job[1]["variables"]
    jbefore = weights.pose_resnet_state_dict(variables)
    jafter = weights.pose_resnet_state_dict(
        {"params": jax_adapt["jstate"].student_params,
         "batch_stats": jax_adapt["jstate"].student_stats})
    r = adapt_ranks[0]
    for name, g in jgrads.items():
        _close_norm(r["metrics"]["aux"]["grads"][name], g, 5e-2, name)
        _close_norm(r["deltas"][name], jafter[name] - jbefore[name], 5e-2, name)
    _close(r["metrics"]["aux"]["grads"]["head.weight"], jgrads["head.weight"], 1e-3, "head")


def test_adapt_bn_stats_match_jax(adapt_ranks, jax_adapt):
    jstate = jax_adapt["jstate"]
    jtea = weights.pose_resnet_state_dict({"params": jstate.teacher_params,
                                           "batch_stats": jstate.teacher_stats})
    jstu = weights.pose_resnet_state_dict({"params": jstate.student_params,
                                           "batch_stats": jstate.student_stats})
    r = adapt_ranks[0]
    names = [n for n in jtea if "running_" in n]
    assert names
    for name in names:
        _close(r["teacher_stats"][name], jtea[name], 1e-3, "teacher " + name)
        _close(r["student_stats"][name], jstu[name], 1e-3, "student " + name)


def test_adapt_ranks_end_bit_equal(adapt_ranks):
    first = adapt_ranks[0]
    for r in adapt_ranks[1:]:
        for which in ("student", "teacher"):
            assert r[which] == first[which], which
        for name in ("loss_all", "loss_s", "loss_c", "acc_s", "acc_cnt"):
            assert first["metrics"][name].tobytes() == r["metrics"][name].tobytes(), name


@pytest.mark.parametrize("do_s2t", [False, True])
def test_pretrain_step_matches_jax(run, two_ranks, do_s2t):
    m = run["models"]
    jstate, jmetrics, jy = run["jax"]["pretrain"][do_s2t]
    ranks = [r["pretrain"][do_s2t] for r in two_ranks]
    _close(np.concatenate([r["y"] for r in ranks]), jy, 1e-3, "y_s")
    jbefore = weights.pose_resnet_state_dict(m["variables"])
    jafter = weights.pose_resnet_state_dict({"params": jstate.student_params,
                                             "batch_stats": jstate.student_stats})
    for r in ranks:
        for name in ("loss_all", "acc_s"):
            _close(r["metrics"][name], jmetrics[name], 1e-3, name)
        for name in jafter:
            if "running_" in name:
                _close(r["student_stats"][name], jafter[name], 1e-3, name)
    for name in jafter:
        if "running_" not in name and not name.endswith("num_batches_tracked"):
            _close_norm(ranks[0]["deltas"][name], jafter[name] - jbefore[name], 5e-2, name)
    assert ranks[0]["student"] == ranks[1]["student"]


def test_eval_step_and_validation_match(run, two_ranks, models_and_job):
    job, m = models_and_job
    batch = job["eval_batch"]
    jy, jloss, jacc = run["jax"]["eval"]
    ranks = [r["evaluate"] for r in two_ranks]
    _close(np.concatenate([r["y"] for r in ranks]), jy, 1e-4, "y")
    for r in ranks:
        _close(r["loss"], jloss, 1e-4, "loss")
        np.testing.assert_array_equal(r["acc"], np.asarray(jacc))
    from uda_poseestimation_torch.engine import run_validate

    want = run_validate(tts.make_eval_step(device="cpu"), m["tmodel"],
                        worker.val_loader(batch), job["val_args"])
    for r in ranks:
        assert r["validate"] == want


def test_bundler_equals_unbundled_steps_under_two_ranks(two_ranks):
    for r in two_ranks:
        got, want = r["bundle"][True], r["bundle"][False]
        for name, v in want["metrics"].items():
            assert got["metrics"][name].tobytes() == v.tobytes(), name
        for which in ("student", "teacher"):
            assert got[which] == want[which], which
    for which in ("student", "teacher"):
        assert two_ranks[0]["bundle"][True][which] == two_ranks[1]["bundle"][True][which]


def test_view_draws_are_the_ranks_rows(two_ranks, models_and_job):
    from uda_poseestimation_torch.ops.device_aug import AnimalSourceAugConfig, DeviceAugConfig

    b = models_and_job[0]["views_b"]
    cfg = DeviceAugConfig(image_size=32, heatmap_size=8, color=0.25, blur=1.0)
    human = DeviceAugPipeline(cfg, cfg, cfg, k=2, mean=(0.5,) * 3, std=(0.25,) * 3, seed=3,
                              device="cpu")
    animal = AnimalDeviceAugPipeline(cfg, cfg, k=2, mean=(0.5,) * 3, seed=3, device="cpu",
                                     src_cfg=AnimalSourceAugConfig(inp_res=32, out_res=8))
    want = {"human": {"source": human.draw_source(2 * b, 40),
                      "target": human.draw_target(2 * b, 40)},
            "animal": {"target": animal.draw_target(2 * b), "source": animal.draw_source(2 * b)}}
    # (views, samples) leaves of draw_view; (samples,) of draw_rrc and the source
    axis1 = {("human", "source"), ("human", "target", "student"),
             ("human", "target", "teacher"), ("animal", "target", "student"),
             ("animal", "target", "teacher")}

    def check(path, want_tree, got_trees):
        if isinstance(want_tree, dict):
            for k in want_tree:
                check(path + (k,), want_tree[k], [g[k] for g in got_trees])
            return
        axis = 1 if any(path[:len(p)] == p for p in axis1) else 0
        got = np.concatenate(got_trees, axis=axis)
        np.testing.assert_array_equal(got, want_tree.numpy(), err_msg=str(path))

    check((), want, [r["views"] for r in two_ranks])
