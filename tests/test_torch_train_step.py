"""The port's fused steps against the JAX package's, on the same weights,
batch, gates and occlusion draws (64² images, 16² heatmaps, b=4, k=1, both
style directions on, occlusion firing).

Tolerances, each relative to the largest magnitude of the JAX tensor unless
said otherwise:
- integer decisions (the kth-value mask, the occlusion gate and
  rectangles, the argmax-placed rectified targets) must be equal;
- the style net's outputs: 1e-4 (float32 convolutions sum in another order
  in XLA and ATen, ~1e-5 measured); tensors that also pass the tiny
  PoseResNet in train mode (BatchNorm over as few as 16 values per channel
  amplifies that noise, ~2e-4 measured): 1e-3;
- gradients and SGD deltas, per tensor in norm: 5e-2. This tiny model's
  train-mode gradients are not smooth at float32 resolution (ReLU and
  max-pool kinks, BatchNorm over as few as 16 values): a 1e-6 relative
  change of the input moves its float64 gradients by ~1% in norm and ~23%
  in the largest element, and the JAX package's float32 gradients are that
  far from its own float64 ones (tests/grad_precision_probe.py). So the
  backward pass is held in float64 instead
  (``test_student_backward_matches_jax_in_float64``, 1e-5), and the float32
  step only to that sensitivity. The step runs SGD: Adam's first step is
  ~sign(g) and would flip on that noise;
- the occluded student view: its pixels are copies, but the port computes
  its own warp coefficients, whose cos/tan may differ by an ulp and move a
  pixel that sits on a rounding boundary, so at most 0.1% may differ.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uda_poseestimation_tpu.models import StyleNet as JStyleNet
from uda_poseestimation_tpu.models.pose_resnet import PoseResNet as JPoseResNet
from uda_poseestimation_tpu.models.resnet import Bottleneck as JBottleneck
from uda_poseestimation_tpu.models.resnet import ResNet as JResNet
from uda_poseestimation_tpu.ops import generate_target_batch
from uda_poseestimation_tpu.parallel import train_step as jts
from uda_poseestimation_torch import weights
from uda_poseestimation_torch.models import Bottleneck, PoseResNet, ResNet, StyleNet
from uda_poseestimation_torch.parallel import train_step as tts

B, K, KV = 4, 5, 1
LR = 0.01
CFG = dict(image_size=64, heatmap_size=16, sigma=2.0, k=KV, use_sgd=True,
           occlude_rate=0.5, occlude_thresh=-1.0, occlude_size=6, aux_outputs=True)
KEY = jax.random.PRNGKey(1)  # its gate draws occlude 2 of the 4 samples
GATES = dict(do_s2t=True, alpha_s2t=0.7, do_t2s=True, alpha_t2s=0.3)


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= rel * scale, f"{what}: max abs err {err} vs {rel} x {scale}"


def _close_norm(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.linalg.norm(got - want))
    scale = float(np.linalg.norm(want))
    assert err <= rel * scale, f"{what}: norm of err {err} vs {rel} x {scale}"


def _batch(seed):
    rng = np.random.RandomState(seed)
    kp = rng.uniform(8, 56, size=(B, K, 2)).astype(np.float32)
    target, weight = generate_target_batch(kp, np.ones((B, K), np.float32),
                                           (16, 16), 2.0, (64, 64))

    def aug():
        return np.stack([rng.uniform(-30, 30, B), np.round(rng.uniform(-4, 4, B)),
                         np.round(rng.uniform(-4, 4, B)), rng.uniform(-10, 10, B),
                         rng.uniform(-10, 10, B), rng.uniform(0.8, 1.2, B)],
                        -1).astype(np.float32)

    return {
        "image_s": rng.rand(B, 64, 64, 3).astype(np.float32),
        "target_s": np.asarray(target), "weight_s": np.asarray(weight),
        "image_t_stu": rng.rand(B, 64, 64, 3).astype(np.float32),
        "images_t_tea": rng.rand(KV, B, 64, 64, 3).astype(np.float32),
        "image_t_style": rng.rand(B, 64, 64, 3).astype(np.float32),
        "aug_param_stu": aug(), "aug_params_tea": np.stack([aug() for _ in range(KV)]),
    }


def _models():
    """A tiny JAX PoseResNet and StyleNet, and the port's twins with the same
    weights (deconv/head kernels scaled up from their 0.001 init so the
    heatmaps are not flat, and the decoder's last kernel so the styled
    images are O(1))."""
    jmodel = JPoseResNet(backbone=JResNet(block=JBottleneck, stage_sizes=(1, 1, 1, 1)),
                         num_keypoints=K)
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 64, 64, 3)), train=False))
    params = jax.tree_util.tree_map(np.array, variables["params"])
    for i in range(3):
        params["upsampling"][f"deconv{i}"]["kernel"] *= 30.0
    params["head"]["kernel"] *= 100.0
    variables = {"params": params, "batch_stats": variables["batch_stats"]}
    jstyle = JStyleNet()
    dummy = jnp.zeros((1, 64, 64, 3), jnp.float32)
    style_params = jax.tree_util.tree_map(np.array, jax.device_get(
        jstyle.init(jax.random.PRNGKey(1), dummy, dummy)["params"]))
    # the random decoder's output is ~1e-3: images that small leave every
    # BatchNorm dominated by its eps, and the gradients then change by ~1%
    # for a 1e-5 change of the input; scaled up, the styled views are O(1)
    style_params["decoder"]["conv8"]["Conv_0"]["kernel"] *= 1000.0
    tmodel = weights.load_pose_resnet(PoseResNet(ResNet(Bottleneck, (1, 1, 1, 1)), K),
                                      variables)
    tstyle = weights.load_style_net(StyleNet(), style_params)
    return jmodel, variables, jstyle, style_params, tmodel, tstyle


def _jax_state(variables, cfg):
    p, s = variables["params"], variables["batch_stats"]
    return jts.UDAState(step=jnp.zeros((), jnp.int32), student_params=p,
                        student_stats=s,
                        teacher_params=jax.tree_util.tree_map(np.copy, p),
                        teacher_stats=jax.tree_util.tree_map(np.copy, s),
                        opt_state=jts.make_tx(cfg.use_sgd).init(p))


def _jax_draws(key, b, k):
    k_gate, k_choice, k_src1, k_src2 = jax.random.split(key, 4)
    return {"u": np.asarray(jax.random.uniform(k_gate, (b,))),
            "gumbel": np.asarray(jax.random.gumbel(k_choice, (b, k))),
            "u1": np.asarray(jax.random.uniform(k_src1, (b,))),
            "u2": np.asarray(jax.random.uniform(k_src2, (b,)))}


def _sd(module):
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def adapt_run():
    jmodel, variables, jstyle, style_params, tmodel, tstyle = _models()
    batch = _batch(0)
    jbatch = {k: v for k, v in batch.items() if k != "image_t_style"}
    jcfg = jts.StepConfig(**CFG)
    jstep = jts.make_adapt_step(jmodel, jcfg, style_model=jstyle)
    jstate, jmetrics, jy = jstep(_jax_state(variables, jcfg), style_params, jbatch,
                                 jnp.float32(LR), KEY,
                                 *(jnp.asarray(GATES[n]) for n in
                                   ("do_s2t", "alpha_s2t", "do_t2s", "alpha_t2s")))
    jstate, jmetrics, jy = jax.device_get((jstate, jmetrics, jy))

    tcfg = tts.StepConfig(**CFG)
    state = tts.create_state(tmodel, tcfg, seed=None, device="cpu")
    before = _sd(state.student)
    tstep = tts.make_adapt_step(tcfg, style_model=tstyle, device="cpu")
    state, metrics, y = tstep(state, batch, LR, **GATES,
                              occlusion_draws=_jax_draws(KEY, B, K))
    return dict(jstate=jstate, jmetrics=jmetrics, jy=jy, variables=variables,
                state=state, metrics=metrics, y=y, before=before, jcfg=jcfg)


_FLOAT_AUX = {"x_s_styled": 1e-4, "x_t_teas_styled": 1e-4, "y_t_tea_recon": 1e-3,
              "activates": 1e-3, "mask_thresh": 1e-3, "y_t_stu_recon": 1e-3}


@pytest.mark.parametrize("name", sorted(_FLOAT_AUX))
def test_adapt_aux_floats_match(adapt_run, name):
    _close(adapt_run["metrics"]["aux"][name].numpy(),
           adapt_run["jmetrics"]["aux"][name], _FLOAT_AUX[name], name)


def test_adapt_aux_rectified_and_mask_equal(adapt_run):
    aux, jaux = adapt_run["metrics"]["aux"], adapt_run["jmetrics"]["aux"]
    np.testing.assert_array_equal(aux["tea_mask"].numpy(), np.asarray(jaux["tea_mask"]))
    assert 0 < aux["tea_mask"].sum() < aux["tea_mask"].numel()
    # Gaussians placed at the same argmax; exp may differ by an ulp
    np.testing.assert_allclose(aux["y_t_tea_rect"].numpy(),
                               np.asarray(jaux["y_t_tea_rect"]), rtol=1e-6, atol=1e-7)


def test_adapt_occlusion_decisions_equal(adapt_run):
    """The gate and rectangles equal the JAX geometry from the same key and
    the JAX reconstruction; the occluded view differs in at most 0.1% of
    its pixels (see the module docstring)."""
    aux, jaux = adapt_run["metrics"]["aux"], adapt_run["jmetrics"]["aux"]
    geom = [np.asarray(g) for g in jts._occlusion_geometry(
        KEY, jnp.asarray(jaux["y_t_tea_recon"]), adapt_run["jcfg"])]
    np.testing.assert_array_equal(aux["occlude"].numpy(), geom[0])
    assert 0 < geom[0].sum() < B  # some samples occluded, some not
    np.testing.assert_array_equal(aux["occlusion_rect"].numpy(),
                                  np.stack(geom[1:], -1))
    got, want = aux["x_t_stu_final"].numpy(), np.asarray(jaux["x_t_stu_final"])
    assert (got != want).mean() <= 1e-3


def test_adapt_losses_match(adapt_run):
    for name in ("loss_all", "loss_s", "loss_c", "acc_s"):
        _close(adapt_run["metrics"][name].numpy(), adapt_run["jmetrics"][name],
               1e-3, name)
    assert int(adapt_run["metrics"]["acc_cnt"]) == int(adapt_run["jmetrics"]["acc_cnt"])
    _close(adapt_run["y"].numpy(), adapt_run["jy"], 1e-3, "y_s")
    assert adapt_run["state"].step == 1


def test_adapt_grads_and_sgd_deltas_match(adapt_run):
    grads = adapt_run["metrics"]["aux"]["grads"]
    jgrads = weights.pose_resnet_state_dict({"params": adapt_run["jmetrics"]["aux"]["grads"]})
    assert set(grads) == set(jgrads)
    for name, g in jgrads.items():
        _close_norm(grads[name].numpy(), g, 5e-2, name)
    # the head is two layers from the loss: there the gradients agree closely
    _close(grads["head.weight"].numpy(), jgrads["head.weight"], 1e-3, "head")
    before = adapt_run["before"]
    after = _sd(adapt_run["state"].student)
    jbefore = weights.pose_resnet_state_dict(adapt_run["variables"])
    jafter = weights.pose_resnet_state_dict(
        {"params": adapt_run["jstate"].student_params,
         "batch_stats": adapt_run["jstate"].student_stats})
    for name in jgrads:
        _close_norm(after[name] - before[name], jafter[name] - jbefore[name], 5e-2, name)


def test_adapt_teacher_ema_and_bn_stats_match(adapt_run):
    """The teacher is alpha * teacher + (1 - alpha) * student after the
    update (the student's update is held against JAX's above, and the EMA
    formula against ``ema_update`` in test_torch_ops); both models' running
    statistics match the JAX ones."""
    state, jstate = adapt_run["state"], adapt_run["jstate"]
    before = adapt_run["before"]
    tea, stu = _sd(state.teacher), _sd(state.student)
    jtea = weights.pose_resnet_state_dict({"params": jstate.teacher_params,
                                           "batch_stats": jstate.teacher_stats})
    jstu = weights.pose_resnet_state_dict({"params": jstate.student_params,
                                           "batch_stats": jstate.student_stats})
    alpha = CFG.get("teacher_alpha", tts.StepConfig.teacher_alpha)
    for name in jtea:
        if "running_" in name:
            _close(tea[name], jtea[name], 1e-3, "teacher " + name)
            _close(stu[name], jstu[name], 1e-3, "student " + name)
        else:
            np.testing.assert_allclose(
                tea[name], alpha * before[name] + (1.0 - alpha) * stu[name],
                rtol=1e-6, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("do_s2t", [False, True])
def test_pretrain_step_matches(do_s2t):
    jmodel, variables, jstyle, style_params, tmodel, tstyle = _models()
    batch = _batch(1)
    jbatch = {k: batch[k] for k in ("image_s", "target_s", "weight_s", "image_t_style")}
    jcfg = jts.StepConfig(**CFG)
    jstep = jts.make_pretrain_step(jmodel, jcfg, style_model=jstyle)
    jstate, jmetrics, jy = jax.device_get(jstep(
        _jax_state(variables, jcfg), style_params, jbatch, jnp.float32(LR),
        jnp.bool_(do_s2t), jnp.float32(0.6)))

    tcfg = tts.StepConfig(**CFG)
    state = tts.create_state(tmodel, tcfg, seed=None, device="cpu")
    before = _sd(state.student)
    tstep = tts.make_pretrain_step(tcfg, style_model=tstyle, device="cpu")
    state, metrics, y = tstep(state, jbatch, LR, do_s2t=do_s2t, alpha=0.6)
    _close(y.numpy(), jy, 1e-3, "y_s")
    for name in ("loss_all", "acc_s"):
        _close(metrics[name].numpy(), jmetrics[name], 1e-3, name)
    after = _sd(state.student)
    jbefore = weights.pose_resnet_state_dict(variables)
    jafter = weights.pose_resnet_state_dict({"params": jstate.student_params,
                                             "batch_stats": jstate.student_stats})
    for name in jafter:
        if "running_" in name:
            _close(after[name], jafter[name], 1e-3, name)
        elif not name.endswith("num_batches_tracked"):
            _close_norm(after[name] - before[name], jafter[name] - jbefore[name],
                        5e-2, name)


def test_student_backward_matches_jax_in_float64():
    """The student's loss and gradients (two train-mode forwards with the BN
    statistics chained, the inverse warp, JointsMSE + the masked consistency
    loss) equal the JAX package's when both run in float64. Both round the
    heatmaps to float32 at the model output, as the JAX model does, which
    leaves ~1e-7 of error."""
    from uda_poseestimation_tpu.models.loss import cons_loss as jcons
    from uda_poseestimation_tpu.models.loss import joints_mse_loss as jmse
    from uda_poseestimation_tpu.ops.affine import inverse_warp_heatmaps as jwarp
    from uda_poseestimation_torch.models.loss import cons_loss, joints_mse_loss
    from uda_poseestimation_torch.ops.affine import inverse_warp_heatmaps

    _, variables, _, _, tmodel, _ = _models()
    batch = _batch(4)
    rng = np.random.RandomState(4)
    rect = rng.rand(B, K, 16, 16)
    mask = rng.rand(B, K) > 0.5
    x_t = rng.rand(B, 64, 64, 3)
    with jax.enable_x64(True):
        jmodel = JPoseResNet(backbone=JResNet(block=JBottleneck, stage_sizes=(1, 1, 1, 1),
                                              dtype=jnp.float64),
                             num_keypoints=K, dtype=jnp.float64)
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
        stats = f64(variables["batch_stats"])

        def loss_fn(params):
            y_s, mut = jmodel.apply({"params": params, "batch_stats": stats},
                                    f64(batch["image_s"]), train=True,
                                    mutable=["batch_stats"])
            y_t, _ = jmodel.apply({"params": params, "batch_stats": mut["batch_stats"]},
                                  f64(x_t), train=True, mutable=["batch_stats"])
            recon = jwarp(y_t, batch["aug_param_stu"], 4.0)
            return (jmse(y_s, batch["target_s"], batch["weight_s"][..., 0])
                    + jcons(recon, f64(rect), tea_mask=mask))

        jl, jg = jax.device_get(jax.jit(jax.value_and_grad(loss_fn))(
            f64(variables["params"])))
    jgrads = weights.pose_resnet_state_dict({"params": jg})

    model = tmodel.double().train()
    nchw = lambda a: torch.from_numpy(np.asarray(a, np.float64)).permute(0, 3, 1, 2)
    y_s = model(nchw(batch["image_s"]))
    recon = inverse_warp_heatmaps(model(nchw(x_t)),
                                  torch.from_numpy(batch["aug_param_stu"]), 4.0)
    loss = (joints_mse_loss(y_s, torch.from_numpy(batch["target_s"]),
                            torch.from_numpy(batch["weight_s"])[..., 0])
            + cons_loss(recon, torch.from_numpy(rect), tea_mask=torch.from_numpy(mask)))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-6)
    for name, p in model.named_parameters():
        _close(p.grad.numpy(), jgrads[name], 1e-5, name)


def test_eval_step_matches():
    jmodel, variables, _, _, tmodel, _ = _models()
    batch = _batch(2)
    jy, jloss, jacc = jax.device_get(jts.make_eval_step(jmodel)(
        variables["params"], variables["batch_stats"], batch["image_s"],
        batch["target_s"], batch["weight_s"]))
    y, loss, acc = tts.make_eval_step(device="cpu")(
        tmodel, batch["image_s"], batch["target_s"], batch["weight_s"])
    assert not tmodel.training
    _close(y.numpy(), jy, 1e-4, "y")  # eval mode: no batch statistics
    _close(loss.numpy(), jloss, 1e-4, "loss")
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))


def test_finetune_groups_scale_backbone_lr():
    """cfg.finetune puts the backbone in a 0.1x group: with SGD the first
    backbone delta is exactly 0.1x the delta without it."""
    _, _, _, _, tmodel, _ = _models()
    batch = _batch(3)
    deltas = {}
    for finetune in (False, True):
        model = copy.deepcopy(tmodel)
        cfg = tts.StepConfig(**dict(CFG, finetune=finetune))
        state = tts.create_state(model, cfg, seed=None, device="cpu")
        before = _sd(state.student)
        state, _, _ = tts.make_pretrain_step(cfg, device="cpu")(state, batch, LR)
        after = _sd(state.student)
        deltas[finetune] = {k: after[k] - before[k] for k in after}
    key = "backbone.conv1.weight"
    # deltas are differences of float32 parameters: exact to an ulp of the
    # parameter (~7e-9 at these magnitudes)
    np.testing.assert_allclose(deltas[True][key], 0.1 * deltas[False][key],
                               rtol=1e-4, atol=2e-8)
    np.testing.assert_array_equal(deltas[True]["head.weight"], deltas[False]["head.weight"])


def test_create_state_copies_student_into_teacher():
    cfg = tts.StepConfig(**CFG)
    model = PoseResNet(ResNet(Bottleneck, (1, 1, 1, 1)), K)
    state = tts.create_state(model, cfg, seed=7, device="cpu")
    again = tts.create_state(PoseResNet(ResNet(Bottleneck, (1, 1, 1, 1)), K), cfg,
                             seed=7, device="cpu")
    for (name, p), q, r in zip(state.student.named_parameters(),
                               state.teacher.parameters(), again.student.parameters()):
        assert torch.equal(p, q) and p.data_ptr() != q.data_ptr(), name
        assert torch.equal(p, r), name  # the init is a function of the seed
        assert not q.requires_grad


@pytest.mark.parametrize("entry", ["create_state", "make_adapt_step",
                                   "make_pretrain_step", "make_eval_step"])
def test_entry_points_default_to_cuda(entry):
    """With no device the port runs on the card and raises without one; it
    never falls back to the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = tts.StepConfig(**CFG)
    call = {"create_state": lambda: tts.create_state(
                PoseResNet(ResNet(Bottleneck, (1, 1, 1, 1)), K), cfg),
            "make_adapt_step": lambda: tts.make_adapt_step(cfg),
            "make_pretrain_step": lambda: tts.make_pretrain_step(cfg),
            "make_eval_step": lambda: tts.make_eval_step()}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


def test_exact_warp_chain_false_raises():
    """The port has only the reference's exact warp chain; the JAX
    package's fused form is refused, not run as the exact one."""
    with pytest.raises(NotImplementedError, match="exact_warp_chain=True only"):
        tts.StepConfig(**dict(CFG, exact_warp_chain=False))
