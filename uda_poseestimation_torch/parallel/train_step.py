"""The fused pretrain, adapt and eval steps.

PyTorch twin of ``uda_poseestimation_tpu/parallel/train_step.py``:

- ``pretrain``: optional s2t AdaIN stylization, student forward, JointsMSE,
  optimizer step (train_human.py:244-302);
- ``adapt``: the mean-teacher step (train_human.py:305-458): a shared VGG
  encode of [x_s; k teacher views], the drawn style directions, k teacher
  forwards in train mode, inverse-affine heatmap reconstruction, adaptive
  keypoint occlusion (the ``occlusion_warp`` kernel on the card), rectify
  and the global kth-value mask, two student forwards, the loss, the
  optimizer step and the EMA teacher;
- ``eval``: forward, loss and per-keypoint PCK.

The batch keeps the JAX layout: ``image_*`` NHWC (B, H, W, 3),
``images_t_tea`` (k, B, H, W, 3), heatmaps (B, K, h, w), ``aug_param*``
(..., 6). Models run NCHW. The state's modules and optimizer are updated
in place; the steps return the same state object with ``step`` advanced.

Randomness: the style gates and alphas are host values, one draw per
iteration as in the reference. The per-sample occlusion draws come from a
``torch.Generator``, or are passed in as ``occlusion_draws`` so that a test
can feed the draws ``jax.random`` makes in the JAX step.

``view_builder`` (``--device-aug``, ``engine.DeviceAugPipeline``) makes a
step take raw uint8 canvases and build every augmented view itself, on the
step's device: the adapt step draws the views from its occlusion generator
before the occlusion draws (the JAX step splits its key, views first), the
pretrain step from the generator it is given; ``view_draws`` injects them.

``AdaptStepBundler`` and ``PretrainStepBundler`` (``--steps-per-dispatch``)
run n steps per call, on the card as CUDA-graph replays of the step. So the
step may be captured: it never copies from host memory or waits for the
device (its constants are made on the device, an alpha may be a 0-d
tensor, a batch already on the device is used as it is).

Under a process group (``parallel/distributed.py``) each rank passes its
rows of the global batch and the steps keep the whole batch's meaning:
BatchNorm over the global batch (``parallel/sync_bn.py``, more than one
rank), the kth value over every rank's activations, the occlusion draws
made for the global batch of which a rank keeps its rows (injected draws
are the rank's rows), the gradients averaged before the optimizer step, the
losses averaged and the PCK counted over the ranks. The updated state is
then the same on every rank.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import warnings
from typing import Mapping, Optional, Tuple

import torch
from torch import nn

from ..device import DeviceLike, device_scalar, device_vector, resolve_device
from ..models.ema import ema_update
from ..models.loss import cons_loss, joints_mse_loss
from ..models.pose_resnet import backbone_param_mask
from ..models.style_net import StyleNet
from ..ops.adain import adain
from ..ops import launches
from ..ops.affine import chain_coeffs, inverse_affine_coeffs, inverse_warp_heatmaps
from ..ops.heatmap import get_max_preds, rectify
from ..ops.occlusion_warp import occlusion_warp
from ..ops.pck import pck_counts, pck_from_counts
from ..utils import trace
from . import distributed as dist


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Step configuration; the fields and defaults of the JAX StepConfig."""

    image_size: int = 256
    heatmap_size: int = 64
    sigma: float = 2.0
    k: int = 1
    lambda_c: float = 1.0
    teacher_alpha: float = 0.999
    mask_ratio: float = 0.5
    occlude_rate: float = 0.5
    occlude_thresh: float = 0.9
    occlude_size: int = 10
    # styled-image clamp = normalized [0,1] bounds (train_human.py:32-33)
    recover_min: Tuple[float, float, float] = (-2.1179, -2.0357, -1.8044)
    recover_max: Tuple[float, float, float] = (2.2489, 2.4285, 2.64)
    use_sgd: bool = False
    # 0.1x learning rate on backbone params (lib/models/pose_resnet.py:86-91)
    finetune: bool = False
    # True reproduces the reference's 3 chained nearest resamples exactly;
    # the port has only this path (False raises: the JAX package's fused
    # resample and sequential occlusion warp were slower on the card, PERF.md §6)
    exact_warp_chain: bool = True
    # the JAX package's choice of occlusion gather; the port has one path,
    # ``occlusion_warp`` (the CUDA kernel on the card, its plain version on
    # the CPU), and keeps the field so a JAX StepConfig's fields carry over
    gather_impl: str = "auto"
    # no counterpart in the port (a CUDA kernel has no interpret mode);
    # kept for the same reason, and must stay False
    pallas_interpret: bool = False
    # the adapt step also returns its intermediates under metrics["aux"]
    aux_outputs: bool = False
    # False -> the occlusion warp returns bf16-rounded values, equivalent
    # when the models cast their inputs to bf16 anyway
    gather_exact: bool = True
    # dtype of the styled images between the style switch and the pose models
    style_io_dtype: str = "float32"

    def __post_init__(self):
        if not self.exact_warp_chain:
            raise NotImplementedError(
                "the port implements exact_warp_chain=True only")
        if self.pallas_interpret:
            raise ValueError("pallas_interpret has no meaning in the port")
        if self.gather_impl not in ("auto", "pallas", "xla"):
            raise ValueError(f"gather_impl {self.gather_impl!r}")
        if self.style_io_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"style_io_dtype {self.style_io_dtype!r}")

    @property
    def ratio(self) -> float:
        return self.image_size / self.heatmap_size


@dataclasses.dataclass
class UDAState:
    """Training state: the student and its EMA teacher (each with its own
    BatchNorm buffers) and the student's optimizer."""

    step: int
    student: nn.Module
    teacher: nn.Module
    optimizer: torch.optim.Optimizer


def make_tx(model: nn.Module, cfg: StepConfig) -> torch.optim.Optimizer:
    """torch Adam(eps=1e-8) or SGD(momentum 0.9, wd 1e-4, nesterov)
    (train_human.py:136-139). With ``cfg.finetune`` the backbone is its own
    group at 0.1x the learning rate. Each group carries ``lr_scale``; the
    steps set ``lr = lr_scale * lr`` before every update."""
    in_backbone = backbone_param_mask(model)
    backbone, rest = [], []
    for name, p in model.named_parameters():
        (backbone if cfg.finetune and in_backbone[name] else rest).append(p)
    groups = [{"params": rest, "lr_scale": 1.0}]
    if backbone:
        groups.append({"params": backbone, "lr_scale": 0.1})
    if cfg.use_sgd:
        return torch.optim.SGD(groups, lr=0.0, momentum=0.9, weight_decay=1e-4,
                               nesterov=True)
    return torch.optim.Adam(groups, lr=0.0, betas=(0.9, 0.999), eps=1e-8)


def create_state(model: nn.Module, cfg: StepConfig, seed: Optional[int] = 0,
                 device: DeviceLike = None) -> UDAState:
    """Student = ``model`` on ``device``, re-initialized from ``seed`` (None
    keeps its current weights, e.g. loaded ones), rank 0's under a process
    group; teacher = a real copy of the student (OldWeightEMA init)."""
    dev = resolve_device(device)
    if seed is not None:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    model.to(dev)
    dist.broadcast_modules(model)  # rank 0's weights under a group
    teacher = copy.deepcopy(model).requires_grad_(False)
    return UDAState(step=0, student=model, teacher=teacher,
                    optimizer=make_tx(model, cfg))


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _to_device(batch: Mapping, dev: torch.device) -> dict:
    """The batch on ``dev``. Tensors are copied with ``non_blocking``: from
    page-locked memory (the loader's batches on a CUDA run) the copy is
    queued on the stream and the host goes on; from pageable memory it is a
    plain copy, with no wait for the device. A tensor already on ``dev``
    (a CUDA graph's static input) is used as it is."""
    return {k: (v if isinstance(v, torch.Tensor) else torch.tensor(v)).to(
                dev, non_blocking=True)
            for k, v in batch.items() if v is not None}


def _clamp_styled(x, cfg: StepConfig):
    """Clamp NCHW styled images to the per-channel normalized bounds."""
    lo = device_vector(cfg.recover_min, x.device, x.dtype).view(1, 3, 1, 1)
    hi = device_vector(cfg.recover_max, x.device, x.dtype).view(1, 3, 1, 1)
    return torch.maximum(torch.minimum(x, hi), lo)


def _set_lr(optimizer: torch.optim.Optimizer, lr: float):
    for group in optimizer.param_groups:
        group["lr"] = float(lr) * group["lr_scale"]


def _average_grads(model: nn.Module):
    """Under a process group, the gradients averaged over the ranks: each
    rank's loss is the mean over its equal share of the rows, so the average
    is the global batch's gradient."""
    if dist.is_active():
        dist.all_reduce_mean_([p.grad for p in model.parameters() if p.grad is not None])


def _metrics(losses: Mapping, y, label):
    """The steps' metrics: ``losses`` (name -> 0-d tensor, detached) and the
    PCK of ``y`` (per keypoint, the average over the counted keypoints and
    their count). Under a process group the losses are averaged over the
    ranks and the PCK counts summed, in one all-reduce, so both are the
    global batch's."""
    losses = {k: v.detach() for k, v in losses.items()}
    hits, n_valid, _ = pck_counts(y, label)
    if dist.is_active():
        m, k = len(losses), hits.numel()
        dt = next(iter(losses.values())).dtype
        vec = dist.all_reduce_sum(torch.cat([torch.stack(list(losses.values())),
                                             hits.to(dt), n_valid.to(dt)]))
        losses = dict(zip(losses, (vec[:m] / dist.process_count()).unbind()))
        hits, n_valid = vec[m:m + k].float(), vec[m + k:].float()
    return losses, pck_from_counts(hits, n_valid)


# ---------------------------------------------------------------------------
# Adaptive keypoint occlusion (train_human.py:376-413)
# ---------------------------------------------------------------------------

def draw_occlusion(batch_size: int, num_keypoints: int, device,
                   generator: Optional[torch.Generator] = None) -> dict:
    """The per-sample occlusion draws: gate uniform ``u`` (B,), Gumbel noise
    (B, K) for the keypoint choice, and two source-offset uniforms."""
    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=device)

    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(uniform(batch_size, num_keypoints).clamp_(min=tiny)))
    return {"u": uniform(batch_size), "gumbel": gumbel,
            "u1": uniform(batch_size), "u2": uniform(batch_size)}


def _occlusion_geometry(y_t_tea_recon, cfg: StepConfig, draws: Mapping):
    """Per-sample occlusion decisions: gate, rectangle, source offsets."""
    s = cfg.image_size
    dev = y_t_tea_recon.device
    u, gumbel, u1, u2 = (torch.as_tensor(draws[n], dtype=torch.float32, device=dev)
                         for n in ("u", "gumbel", "u1", "u2"))
    conf = y_t_tea_recon.amax(dim=(2, 3))  # (B, K)
    preds, _ = get_max_preds(y_t_tea_recon)  # (B, K, 2) (x, y)
    conf_table = conf >= cfg.occlude_thresh
    do = (conf_table.sum(dim=1) > 0) & (u <= cfg.occlude_rate)
    # uniform choice among confident keypoints (Gumbel-max over the mask)
    choice = torch.where(conf_table, gumbel, float("-inf")).argmax(dim=1)
    pos = preds[torch.arange(preds.shape[0], device=dev), choice]
    pos = (pos * cfg.ratio).to(torch.int32)  # (B, 2) (x, y) at image scale
    # rows from y -> [left, right), cols from x -> [upper, bottom)
    left = (pos[:, 1] - cfg.occlude_size).clamp(min=0)
    right = (pos[:, 1] + cfg.occlude_size).clamp(max=s)
    upper = (pos[:, 0] - cfg.occlude_size).clamp(min=0)
    bottom = (pos[:, 0] + cfg.occlude_size).clamp(max=s)
    left_src = torch.floor(u1 * (s - (right - left) + 1).to(torch.float32)).to(torch.int32)
    upper_src = torch.floor(u2 * (s - (bottom - upper) + 1).to(torch.float32)).to(torch.int32)
    return do, left, right, upper, bottom, left_src, upper_src


def _occlude_batch(x_t_stu_nhwc, y_t_tea_recon, aug_param_stu, cfg: StepConfig,
                   draws: Mapping):
    """Paste random patches over confident predicted keypoints, in the
    single-gather form backward(paste(forward(x))) (exact chain).

    Returns the occluded NHWC images, the per-sample gate (B,) and the
    rectangles (B, 6) [left, right, upper, bottom, left_src, upper_src].
    """
    do, left, right, upper, bottom, left_src, upper_src = _occlusion_geometry(
        y_t_tea_recon, cfg, draws)
    angle, tx, ty, shx, shy, scale = aug_param_stu.to(torch.float32).unbind(-1)
    c1, c2, c3 = chain_coeffs(angle, tx / cfg.ratio, ty / cfg.ratio, shx, shy, scale)
    cb = inverse_affine_coeffs(-angle, -tx / cfg.ratio, -ty / cfg.ratio,
                               -shx, -shy, 1.0 / scale)
    coeffs = torch.stack([cb, c1, c2, c3], dim=1)  # (B, 4, 6)
    rect = torch.stack([left, right, upper, bottom, left_src, upper_src],
                       dim=-1).to(torch.int32)
    imgs = _nchw(x_t_stu_nhwc)  # a channels_last view, no copy
    occluded = occlusion_warp(imgs, coeffs, rect, exact=cfg.gather_exact)
    out = torch.where(do[:, None, None, None], occluded, imgs)
    return _nhwc(out), do, rect


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def _style_views(style_model: StyleNet, x_s, x_t_teas, do_s2t: bool, alpha_s2t,
                 do_t2s: bool, alpha_t2s, cfg: StepConfig):
    """The drawn style directions, both against the ORIGINAL tensors
    (train_human.py:348-356), with one shared VGG encode of [x_s; k views]
    and one batched decode of every drawn target. NHWC in and out."""
    sdtype = torch.bfloat16 if cfg.style_io_dtype == "bfloat16" else torch.float32
    if not (do_s2t or do_t2s):
        return x_s.to(sdtype), x_t_teas.to(sdtype)
    b = x_s.shape[0]
    stacked = torch.cat([x_s[None], x_t_teas]).flatten(0, 1)
    f_all = style_model.encode(_nchw(stacked)).float()
    f_s, f_ts = f_all[:b], f_all[b:].unflatten(0, (cfg.k, b))
    targets = []
    if do_s2t:
        a = device_scalar(alpha_s2t, f_s.device)
        targets.append(a * adain(f_s, f_ts[0]) + (1.0 - a) * f_s)
    if do_t2s:
        a = device_scalar(alpha_t2s, f_s.device)
        targets += [a * adain(f_ts[i], f_s) + (1.0 - a) * f_ts[i]
                    for i in range(cfg.k)]
    g = _nhwc(_clamp_styled(style_model.decode(torch.cat(targets)).to(sdtype), cfg))
    if do_s2t:
        x_s, g = g[:b], g[b:]
    else:
        x_s = x_s.to(sdtype)
    x_t_teas = g.reshape(x_t_teas.shape) if do_t2s else x_t_teas.to(sdtype)
    return x_s, x_t_teas


def make_adapt_step(cfg: StepConfig, style_model: Optional[StyleNet] = None,
                    device: DeviceLike = None, view_builder=None):
    """Mean-teacher adaptation step (train_human.py:305-458).

    Returns ``step(state, batch, lr, do_s2t=False, alpha_s2t=1.0,
    do_t2s=False, alpha_t2s=1.0, generator=None, occlusion_draws=None,
    view_draws=None)`` -> ``(state, metrics, y_s)``. The gates are host
    booleans. ``generator`` draws the occlusion randomness on the step's
    device unless ``occlusion_draws`` ({"u", "gumbel", "u1", "u2"}) is given.
    With ``view_builder(raw_batch, generator=, draws=)`` the batch holds raw
    canvases, from which the view builder makes the step's batch, drawing
    from ``generator`` first unless ``view_draws`` is given.
    """
    dev = resolve_device(device)

    def step(state: UDAState, batch: Mapping, lr: float, do_s2t: bool = False,
             alpha_s2t: float = 1.0, do_t2s: bool = False, alpha_t2s: float = 1.0,
             generator: Optional[torch.Generator] = None,
             occlusion_draws: Optional[Mapping] = None,
             view_draws: Optional[Mapping] = None):
        with trace.span("adapt.step"):
            batch = _to_device(batch, dev)
            if view_builder is not None:
                batch = view_builder(batch, generator=generator, draws=view_draws)
            x_s = batch["image_s"]
            x_t_stu = batch["image_t_stu"]
            x_t_teas = batch["images_t_tea"]
            aug_stu = batch["aug_param_stu"]
            aug_teas = batch["aug_params_tea"]
            label_s = batch["target_s"]
            weight_s = batch["weight_s"]
            student, teacher = state.student, state.teacher
            student.train()
            teacher.train()

            # --- no-grad region: style transfer, teacher, occlusion -------
            with torch.no_grad():
                if style_model is not None:
                    x_s, x_t_teas = _style_views(style_model, x_s, x_t_teas,
                                                 bool(do_s2t), alpha_s2t,
                                                 bool(do_t2s), alpha_t2s, cfg)
                # k teacher forwards in train mode; running stats chain through
                recons = [inverse_warp_heatmaps(teacher(_nchw(x_t_teas[i])),
                                                aug_teas[i], cfg.ratio)
                          for i in range(cfg.k)]
                y_t_tea_recon = torch.stack(recons).mean(dim=0)
                occlusion = None
                if cfg.occlude_rate > -1:
                    b, k = y_t_tea_recon.shape[:2]
                    draws = occlusion_draws
                    if draws is None:  # the global batch's draws, this rank's rows
                        draws = dist.global_draw(
                            lambda n: draw_occlusion(n, k, dev, generator), b)
                    x_t_stu, do, rect = _occlude_batch(x_t_stu, y_t_tea_recon,
                                                       aug_stu, cfg, draws)
                    occlusion = (do, rect)
                # confidence mask: global kth-value over the (B*K) activations
                # (train_human.py:427-430), every rank's rows under a group;
                # kthvalue is 1-indexed like torch's
                activates = y_t_tea_recon.amax(dim=(2, 3))  # (B, K)
                y_t_tea_rect = rectify(y_t_tea_recon, cfg.sigma)
                whole = dist.all_gather_rows(activates) if dist.is_active() else activates
                kth = max(int(cfg.mask_ratio * whole.numel()), 1)
                mask_thresh = torch.kthvalue(whole.reshape(-1), kth).values
                tea_mask = activates > mask_thresh

            # --- grad region: student forwards + losses --------------------
            y_s = student(_nchw(x_s))
            y_t_stu = student(_nchw(x_t_stu))
            y_t_stu_recon = inverse_warp_heatmaps(y_t_stu, aug_stu, cfg.ratio)
            loss_s = joints_mse_loss(y_s, label_s, weight_s[..., 0])
            loss_c = cons_loss(y_t_stu_recon, y_t_tea_rect, tea_mask=tea_mask)
            loss_all = loss_s + cfg.lambda_c * loss_c
            state.optimizer.zero_grad(set_to_none=True)
            loss_all.backward()
            _average_grads(student)
            grads = ({n: p.grad.detach().clone() for n, p in student.named_parameters()}
                     if cfg.aux_outputs else None)
            _set_lr(state.optimizer, lr)
            state.optimizer.step()
            ema_update(teacher, student, cfg.teacher_alpha)

            y_s = y_s.detach()
            losses, (_, acc_avg, acc_cnt) = _metrics(
                {"loss_all": loss_all, "loss_s": loss_s, "loss_c": loss_c}, y_s, label_s)
            metrics = {**losses, "acc_s": acc_avg, "acc_cnt": acc_cnt}
            if cfg.aux_outputs:
                metrics["aux"] = {
                    "x_s_styled": x_s, "x_t_teas_styled": x_t_teas,
                    "x_t_stu_final": x_t_stu,
                    "y_t_tea_recon": y_t_tea_recon, "y_t_tea_rect": y_t_tea_rect,
                    "activates": activates, "mask_thresh": mask_thresh,
                    "tea_mask": tea_mask, "y_t_stu_recon": y_t_stu_recon.detach(),
                    "grads": grads,
                }
                if occlusion is not None:
                    metrics["aux"]["occlude"], metrics["aux"]["occlusion_rect"] = occlusion
            state.step += 1
            return state, metrics, y_s

    return step


def make_pretrain_step(cfg: StepConfig, style_model: Optional[StyleNet] = None,
                       device: DeviceLike = None, view_builder=None):
    """Source-only supervised step (train_human.py:244-302).

    Returns ``step(state, batch, lr, do_s2t=False, alpha=1.0,
    generator=None, view_draws=None)`` -> ``(state, metrics, y_s)``; with
    ``do_s2t`` the source images are stylized against
    ``batch["image_t_style"]`` and clamped. With ``view_builder(raw_batch,
    do_s2t, generator=, draws=)`` (``DeviceAugPipeline.
    pretrain_view_builder``) the batch holds raw canvases, from which the
    view builder makes the source views, and the style image when
    ``do_s2t``, drawing from ``generator`` unless ``view_draws`` is given.
    """
    dev = resolve_device(device)

    def step(state: UDAState, batch: Mapping, lr: float, do_s2t: bool = False,
             alpha: float = 1.0, generator: Optional[torch.Generator] = None,
             view_draws: Optional[Mapping] = None):
        with trace.span("pretrain.step"):
            batch = _to_device(batch, dev)
            if view_builder is not None:
                batch = view_builder(batch, bool(do_s2t), generator=generator,
                                     draws=view_draws)
            x_s = _nchw(batch["image_s"])
            if style_model is not None and do_s2t:
                with torch.no_grad():
                    x_s = _clamp_styled(style_model.stylize(
                        x_s, _nchw(batch["image_t_style"]), alpha), cfg)
            label_s = batch["target_s"]
            student = state.student
            student.train()
            y_s = student(x_s)
            loss = joints_mse_loss(y_s, label_s, batch["weight_s"][..., 0])
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            _average_grads(student)
            _set_lr(state.optimizer, lr)
            state.optimizer.step()
            y_s = y_s.detach()
            losses, (_, acc_avg, acc_cnt) = _metrics({"loss": loss}, y_s, label_s)
            metrics = {"loss_all": losses["loss"], "loss_s": losses["loss"], "acc_s": acc_avg,
                       "acc_cnt": acc_cnt}
            state.step += 1
            return state, metrics, y_s

    return step


# ---------------------------------------------------------------------------
# Step bundling (--steps-per-dispatch): n steps per call
# ---------------------------------------------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def _stack_trees(trees):
    """Per-step output trees (dicts of tensors) -> one tree of stacked (n,
    ...) tensors."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if isinstance(first, Mapping):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return first


def make_capturable(optimizer: torch.optim.Optimizer):
    """Put Adam's step counts on the parameters' device (``capturable``), so
    that a CUDA graph holds the whole update; SGD keeps no host state. A
    checkpoint of either is written in the non-capturable layout
    (``utils/checkpoint.py``)."""
    for group in optimizer.param_groups:
        if "capturable" in group:
            group["capturable"] = True
    for p, st in optimizer.state.items():
        step = st.get("step")
        if isinstance(step, torch.Tensor) and step.device != p.device:
            st["step"] = step.to(device=p.device, dtype=torch.float32)


def _fingerprint(state: UDAState) -> tuple:
    """What a captured step holds as it was at its capture: the storage it
    reads and writes in place (the modules' parameters and buffers, the
    optimizer's state tensors: a checkpoint restore copies into the modules
    but replaces the optimizer's tensors) and the optimizer's
    hyper-parameters."""
    tensors = [*state.student.parameters(), *state.student.buffers(),
               *state.teacher.parameters(), *state.teacher.buffers()]
    tensors += [v for st in state.optimizer.state.values() for v in st.values()
                if isinstance(v, torch.Tensor)]
    groups = tuple(tuple((k, v) for k, v in g.items() if k not in ("params", "lr"))
                   for g in state.optimizer.param_groups)
    return (id(state.student), id(state.teacher), id(state.optimizer), groups,
            *(t.data_ptr() for t in tensors))


def _why(old, new) -> str:
    """Which part of a bundler's key, (lr, generator, fingerprint), moved
    from ``old`` to ``new``."""
    if old is None:
        return "first"
    return next(why for why, a, b in zip(("lr", "generator", "state"), old, new) if a != b)


class _StagedSteps:
    """n calls of one step, in order, each through static inputs: the batch,
    the alphas and the given occlusion draws are copied into buffers that
    the step reads.

    On the CPU every call runs eagerly. On the card the step of each case
    (its style gates, and whether draws are given) runs eagerly the first
    time, on a side stream: that call is the warm-up that makes the
    optimizer's state, the convolutions' plans and the kernels' scratch. The
    next call of the case captures the step into a CUDA graph on that
    stream and replays it; every later call replays it. The graphs share one
    memory pool (they never run at once), and each holds its static outputs.
    Under an NCCL process group the step's collectives are captured too (one
    collective runs eagerly on the side stream before each capture); a gloo
    group's cannot be, so a gloo group on the card raises.
    A graph holds the learning rate, the occlusion generator, the
    optimizer's hyper-parameters and the state's tensors as they were at its
    capture, so a call with another lr or generator, or on a state whose
    hyper-parameters changed or whose tensors moved (a checkpoint restore
    replaces the optimizer's), drops the graphs first. Capture or replay
    errors raise; nothing falls back to the eager step.

    ``eager_steps``, ``captures`` and ``replays`` count what ran; ``tallies``
    holds each graph's kernel launches per replay (``ops/launches.py``);
    ``reset_reasons`` counts why the graphs were dropped: ``first`` (the
    first call on the card), ``lr``, ``generator``, ``state`` (its
    hyper-parameters or tensors), ``buffer`` (a static input of another
    shape or type). Each call's staging, warm-up, capture and replay is a
    span (``utils/trace.py``).
    """

    def __init__(self, step, device: DeviceLike):
        self._step = step
        self.device = resolve_device(device)
        self.eager_steps = self.captures = self.replays = 0
        self.reset_reasons = collections.Counter()
        self._stream = None
        self._static = {}
        self._restaged = False
        self._key = None
        self.reset()

    def reset(self):
        """Drop the graphs (and with them their memory) and the warm-ups."""
        self._graphs = {}
        self._warm = set()
        self._pool = None
        self.tallies = {}

    def _invoke(self, state, static, lr, case, generator):
        raise NotImplementedError

    def _stage(self, name, value):
        """Copy ``value`` (a tensor, array or number) into the static buffer
        ``name``; a buffer of another shape or type is made anew, which drops
        the graphs that read the old one."""
        if not isinstance(value, torch.Tensor):
            value = torch.tensor(value, dtype=torch.float32 if isinstance(value, float)
                                 else None)
        buf = self._static.get(name)
        if buf is None or buf.shape != value.shape or buf.dtype != value.dtype:
            # a buffer changed, or a new one came once something was built
            self._restaged |= buf is not None or bool(self._graphs or self._warm)
            buf = self._static[name] = torch.empty(value.shape, dtype=value.dtype,
                                                   device=self.device)
            self.reset()
        if value.dim() == 0 and value.device.type == "cpu":
            buf.fill_(value.item())  # a fill, not a copy from host memory
        else:
            buf.copy_(value, non_blocking=True)
        return buf

    def _stage_tree(self, prefix, tree):
        return {k: (self._stage_tree(f"{prefix}/{k}", v) if isinstance(v, Mapping)
                    else self._stage(f"{prefix}/{k}", v))
                for k, v in tree.items() if v is not None}

    def _run(self, state, lr, inputs, cases, generator=None):
        """Run the step once per (inputs[j], cases[j]) in order; returns the
        state, the metrics stacked (n,) and the last step's y_s."""
        cuda = self.device.type == "cuda"
        if cuda and not dist.graph_capturable():
            raise RuntimeError(
                "--steps-per-dispatch > 1 on CUDA needs an NCCL process group: "
                "gloo's collectives cannot be captured in a CUDA graph")
        if cuda:
            make_capturable(state.optimizer)
            key = (float(lr), generator, _fingerprint(state))
            if key != self._key:
                self.reset_reasons[_why(self._key, key)] += 1
                self.reset()
        outs, y_s = [], None
        for staged_inputs, case in zip(inputs, cases):
            self._restaged = False
            with trace.span("bundler.stage"):
                static = {k: (self._stage_tree(k, v) if isinstance(v, Mapping)
                              else self._stage(k, v))
                          for k, v in staged_inputs.items() if v is not None}
            if self._restaged:
                self.reset_reasons["buffer"] += 1
            if not cuda:
                _, metrics, y_s = self._invoke(state, static, lr, case, generator)
                self.eager_steps += 1
            elif case not in self._warm:
                with trace.span("bundler.warm_up"):
                    metrics, y_s = self._warm_up(state, static, lr, case, generator)
            else:
                if case not in self._graphs:
                    with trace.span("bundler.capture"):
                        self._capture(state, static, lr, case, generator)
                with trace.span("bundler.replay"):
                    metrics, y_s = self._replay(state, case)
            # a graph's outputs are rewritten by its next replay
            outs.append(_tree_map(torch.clone, metrics))
        if cuda:  # after the run: its first step may have made the optimizer's state
            self._key = (float(lr), generator, _fingerprint(state))
        return state, _stack_trees(outs), y_s.clone()

    def _side_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        return self._stream

    def _warm_up(self, state, static, lr, case, generator):
        stream = self._side_stream()
        with torch.cuda.stream(stream), warnings.catch_warnings():
            # a capturable Adam warns when it steps outside a capture, as here
            warnings.filterwarnings("ignore", message=".*capturable=True")
            _, metrics, y_s = self._invoke(state, static, lr, case, generator)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        self._warm.add(case)
        self.eager_steps += 1
        return metrics, y_s

    def _capture(self, state, static, lr, case, generator):
        dist.warm_up(self._side_stream())  # NCCL's communicator, before the capture
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        step = state.step
        # thread_local: the loader's pin-memory thread keeps calling CUDA
        with launches.recording() as tally, torch.cuda.graph(
                graph, pool=self._pool, stream=self._side_stream(),
                capture_error_mode="thread_local"):
            _, metrics, y_s = self._invoke(state, static, lr, case, generator)
        state.step = step  # the capture ran nothing
        self._graphs[case] = (graph, metrics, y_s, tally)
        self.tallies[case] = launches.per_wrapper(tally)
        self.captures += 1

    def _replay(self, state, case):
        graph, metrics, y_s, tally = self._graphs[case]
        graph.replay()
        launches.replayed(tally)
        state.step += 1
        self.replays += 1
        return metrics, y_s


def _gates(values, n, kind):
    values = [kind(v) for v in values]
    if len(values) != n:
        raise ValueError(f"{n} batches but {len(values)} gate values")
    return values


class AdaptStepBundler(_StagedSteps):
    """--steps-per-dispatch for the adaptation phase: n ``make_adapt_step``
    steps per call (the JAX package's ``AdaptStepBundler``, a ``lax.scan``
    there; ``_StagedSteps`` says how the port runs them).

    ``bundler(state, batches, lr, do_s2t, alpha_s2t, do_t2s, alpha_t2s,
    generator=None, occlusion_draws=None, view_draws=None)``: ``batches`` is
    a list of n host batches, each gate and alpha a sequence of n host
    values (one draw per iteration, as in the reference), ``occlusion_draws``
    None or n draw dicts, and with a ``view_builder`` ``view_draws`` None or
    n view-draw trees (given together with ``occlusion_draws``). Returns
    ``(state, metrics stacked (n,), y_s of the last step)``, what n calls of
    the step in order give. On the card there is one graph per (do_s2t,
    do_t2s) case met, since the style switch branches on them; with a view
    builder the views are built inside it, from the registered generator.
    """

    def __init__(self, cfg: StepConfig, style_model: Optional[StyleNet] = None,
                 device: DeviceLike = None, view_builder=None):
        super().__init__(make_adapt_step(cfg, style_model, device, view_builder), device)
        self._style = style_model is not None

    def _invoke(self, state, static, lr, case, generator):
        do_s2t, do_t2s, drawn = case
        return self._step(state, static["batch"], lr, do_s2t, static["alpha_s2t"],
                          do_t2s, static["alpha_t2s"],
                          generator=None if drawn else generator,
                          occlusion_draws=static["draws"] if drawn else None,
                          view_draws=static.get("view_draws") if drawn else None)

    def __call__(self, state: UDAState, batches, lr: float, do_s2t, alpha_s2t, do_t2s,
                 alpha_t2s, generator: Optional[torch.Generator] = None,
                 occlusion_draws=None, view_draws=None):
        n = len(batches)
        do_s2t, do_t2s = _gates(do_s2t, n, bool), _gates(do_t2s, n, bool)
        alpha_s2t, alpha_t2s = _gates(alpha_s2t, n, float), _gates(alpha_t2s, n, float)
        draws = [None] * n if occlusion_draws is None else list(occlusion_draws)
        views = [None] * n if view_draws is None else list(view_draws)
        inputs = [{"batch": b, "alpha_s2t": a_s, "alpha_t2s": a_t, "draws": d,
                   "view_draws": v}
                  for b, a_s, a_t, d, v in zip(batches, alpha_s2t, alpha_t2s, draws, views)]
        cases = [(s and self._style, t and self._style, d is not None)
                 for s, t, d in zip(do_s2t, do_t2s, draws)]
        return self._run(state, lr, inputs, cases,
                         None if occlusion_draws is not None else generator)


class PretrainStepBundler(_StagedSteps):
    """--steps-per-dispatch for the pretraining phase: n
    ``make_pretrain_step`` steps per call (the JAX package's
    ``PretrainStepBundler``), as ``AdaptStepBundler`` runs adapt steps.

    ``bundler(state, batches, lr, do_s2t, alphas, generator=None,
    view_draws=None)``; a batch whose s2t gate did not fire carries zeros as
    its style image (or style canvases) when style is on, as the engine
    gives it. On the card there is one graph per do_s2t case met. With a
    ``view_builder`` the step builds its views from ``generator`` (the
    graphs register it; the pipeline's own, ``DeviceAugPipeline.generator``)
    unless ``view_draws`` (n trees) is given; the style image is built only
    in the do_s2t case's graph.
    """

    def __init__(self, cfg: StepConfig, style_model: Optional[StyleNet] = None,
                 device: DeviceLike = None, view_builder=None):
        super().__init__(make_pretrain_step(cfg, style_model, device, view_builder), device)
        self._style = style_model is not None

    def _invoke(self, state, static, lr, case, generator):
        do_s2t, drawn = case
        return self._step(state, static["batch"], lr, do_s2t, static["alpha"],
                          generator=None if drawn else generator,
                          view_draws=static.get("view_draws") if drawn else None)

    def __call__(self, state: UDAState, batches, lr: float, do_s2t, alphas,
                 generator: Optional[torch.Generator] = None, view_draws=None):
        n = len(batches)
        do_s2t, alphas = _gates(do_s2t, n, bool), _gates(alphas, n, float)
        views = [None] * n if view_draws is None else list(view_draws)
        inputs = [{"batch": b, "alpha": a, "view_draws": v}
                  for b, a, v in zip(batches, alphas, views)]
        cases = [(d and self._style, v is not None) for d, v in zip(do_s2t, views)]
        return self._run(state, lr, inputs, cases,
                         None if view_draws is not None else generator)


def make_eval_step(device: DeviceLike = None):
    """Inference forward + loss + per-keypoint PCK (train_human.py:461-500).

    Returns ``eval_fn(model, x, label, weight)`` -> ``(y, loss,
    acc_per_kpt)`` with ``x`` NHWC; the model runs in eval mode. Under a
    process group each rank passes its rows of the batch and gets its rows'
    ``y`` and the whole batch's loss and PCK.
    """
    dev = resolve_device(device)

    @torch.no_grad()
    def eval_fn(model: nn.Module, x, label, weight):
        x, label, weight = _to_device({"x": x, "label": label, "weight": weight},
                                      dev).values()
        model.eval()
        y = model(_nchw(x))
        losses, (acc_per_kpt, _, _) = _metrics(
            {"loss": joints_mse_loss(y, label, weight[..., 0])}, y, label)
        return y, losses["loss"], acc_per_kpt

    return eval_fn
