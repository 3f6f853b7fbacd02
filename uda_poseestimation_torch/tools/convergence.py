"""The learning recipe: a small model's PCK must rise, not only compute.

The twin of the repository's ``tests/test_convergence.py``, as functions
with an explicit ``device`` and ``steps_per_dispatch``. The task is
learnable: each keypoint is a blob of its own color at its location.

1. ``pretrain_until``: supervised steps on one fixed source batch until the
   batch's PCK passes 0.95 (at most 200 steps);
2. ``adapt``: the teacher takes the pretrained student's weights, then
   mean-teacher steps on a dimmer, offset target batch with rotated student
   views, the occlusion warp, rectify, the kth-value mask and the EMA
   teacher (at most 80 steps);
3. ``adapt_with_style``: the same with a StyleNet whose random decoder is
   first trained 40 steps on the blob images, and both style gates drawn
   at p=0.5 every iteration (at most 170 steps, until all four gate cases
   ran).

``steps_per_dispatch=1`` runs ``make_pretrain_step``/``make_adapt_step``
once per iteration. ``n > 1`` runs n iterations per call of
``PretrainStepBundler``/``AdaptStepBundler`` (CUDA-graph replays on the
card), and checks PCK after a call instead of after a step. The functions
return what the runs measured and assert nothing: the callers hold the
results to the JAX test's thresholds.

The occlusion draws come from one ``torch.Generator`` per run, where the
JAX test draws from ``PRNGKey(1000 + i)``; so the two recipes match in
kind, not bit for bit.

    python -m uda_poseestimation_torch.tools.convergence [--device cpu] [--repeat 1]

runs both recipes from their seeds ``--repeat`` times, STEPS_PER_DISPATCH
steps a bundler call, as ``chip_smoke.py`` runs them (TF32 off, cuDNN's
deterministic algorithms), and prints one JSON line a run, with whether it
met the JAX test's thresholds. Runs from the same seeds on one card then
agree bit for bit.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models.pose_resnet import PoseResNet
from ..models import resnet as resnet_lib
from ..models.style_net import StyleNet
from ..ops.affine import inverse_warp_heatmaps
from ..ops.heatmap import generate_target_batch
from ..parallel.train_step import (AdaptStepBundler, PretrainStepBundler, StepConfig,
                                   create_state, make_adapt_step, make_eval_step,
                                   make_pretrain_step)

# 64² images through a 3-stage (stride-16) BasicBlock backbone -> 4x4
# features -> 32x32 heatmaps: the deployed configuration's relative PCK
# precision (256², stride 32, 64²) at a size a CPU trains in minutes
SIZE, HM, B, K = 64, 32, 4, 4
SIGMA = 2.0
LR = 5e-3
# the JAX test's step budgets, to which its thresholds are calibrated
PRETRAIN_MAX, ADAPT_MAX, STYLE_ADAPT_MAX, DECODER_STEPS = 200, 80, 170, 40
# steps per bundler call on the card (the CLI's and chip_smoke.py's)
STEPS_PER_DISPATCH = 10
# a color signature per keypoint: the model must find each blob by its color
COLORS = np.array([[1.0, 0.0, 0.0],
                   [0.0, 1.0, 0.0],
                   [0.0, 0.0, 1.0],
                   [1.0, 1.0, 0.0]], np.float32)


def make_blob_batch(rng, shift=False, kp=None):
    """(images (B, S, S, 3), keypoints (B, K, 2) at image scale, target,
    weight), all numpy; ``shift`` makes the target domain (dimmer, offset)."""
    if kp is None:
        kp = rng.uniform(10, SIZE - 10, (B, K, 2)).astype(np.float32)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32)
    d2 = ((xx[None, None] - kp[..., 0, None, None]) ** 2
          + (yy[None, None] - kp[..., 1, None, None]) ** 2)
    blobs = np.exp(-d2 / (2.0 * 3.0 ** 2))  # (B, K, S, S)
    imgs = np.einsum("bkhw,kc->bhwc", blobs, COLORS).astype(np.float32)
    if shift:
        imgs = imgs * 0.55 + 0.25
    target, weight = generate_target_batch(kp, np.ones((B, K), np.float32),
                                           (HM, HM), SIGMA, (SIZE, SIZE))
    return imgs, kp, target.numpy(), weight.numpy()


def identity_aug():
    return np.tile(np.array([0, 0, 0, 0, 0, 1], np.float32), (B, 1))


def make_model() -> PoseResNet:
    return PoseResNet(resnet_lib.ResNet(resnet_lib.BasicBlock, [1, 1, 1]), K)


def make_state(teacher_alpha: float, device=None):
    """The step configuration (k=1, a fast-tracking EMA for short runs) and
    a state from seed 0 on ``device``."""
    cfg = StepConfig(image_size=SIZE, heatmap_size=HM, sigma=SIGMA, k=1,
                     teacher_alpha=teacher_alpha)
    return cfg, create_state(make_model(), cfg, seed=0, device=resolve_device(device))


def _tensors(batch, device):
    return [torch.as_tensor(a, device=device) for a in batch]


def _pck(eval_step, model, imgs, target, weight) -> float:
    _, _, acc = eval_step(model, imgs, target, weight)
    acc = acc.cpu().numpy()
    return float(acc[acc >= 0].mean())


def _graphs(run) -> dict:
    """A bundler's eager steps, CUDA-graph captures and replays (none for a
    plain step)."""
    return ({k: getattr(run, k) for k in ("eager_steps", "captures", "replays")}
            if hasattr(run, "replays") else {})


def _check_due(first: int, last: int, start: int) -> bool:
    """Whether steps ``first..last`` (0-based) hold one at which the JAX
    recipe checks PCK (``i >= start and i % 10 == 0``)."""
    return any(i >= start and i % 10 == 0 for i in range(first, last + 1))


def pretrain_until(state, cfg, src, device=None, steps_per_dispatch=1):
    """Supervised steps on the fixed source batch ``src`` (``make_blob_batch``
    output) until its PCK passes 0.95, at most PRETRAIN_MAX. Returns the first and last losses,
    the final train-batch PCK, the steps run, the seconds and, bundled, the
    bundler's eager steps, captures and replays."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    imgs, _, target, weight = _tensors(src, dev)
    batch = {"image_s": imgs, "target_s": target, "weight_s": weight}
    eval_step = make_eval_step(dev)
    n = steps_per_dispatch
    run = (make_pretrain_step(cfg, None, dev) if n == 1
           else PretrainStepBundler(cfg, None, dev))
    first_loss = None
    done = 0
    while done < PRETRAIN_MAX:
        m = min(n, PRETRAIN_MAX - done)
        if n == 1:
            state, metrics, _ = run(state, batch, LR)
            losses = metrics["loss_all"][None]
        else:
            state, metrics, _ = run(state, [batch] * m, LR, [False] * m, [0.0] * m)
            losses = metrics["loss_all"]
        if first_loss is None:
            first_loss = float(losses[0])
        done += m
        if (_check_due(done - m, done - 1, 20)
                and _pck(eval_step, state.student, imgs, target, weight) > 0.95):
            break
    return dict({"first_loss": first_loss, "last_loss": float(losses[-1]),
                 "pck_src": _pck(eval_step, state.student, imgs, target, weight),
                 "steps": done, "seconds": time.perf_counter() - t0}, **_graphs(run))


def train_decoder(style, src_imgs, tgt_imgs):
    """The decoder pretraining of the style recipe: DECODER_STEPS decoder steps
    (content weight 1, style weight 0.05, Adam at 1e-3), content and style
    swapping between the source and target images every step. Returns the
    first and last losses."""
    from ..adain_engine import make_decoder_step

    step, _ = make_decoder_step(style, content_weight=1.0, style_weight=0.05, lr=1e-3)
    src, tgt = (x.permute(0, 3, 1, 2) for x in (src_imgs, tgt_imgs))
    losses = [float(step(*((src, tgt) if j % 2 == 0 else (tgt, src)))[0])
              for j in range(DECODER_STEPS)]
    return losses[0], losses[-1]


def _adapt_loop(state, cfg, src, tgt, rng, dev, n, style, max_steps, start, seed):
    """Mean-teacher steps on ``tgt``, from a teacher set to the student.
    Per iteration: the student view's rotation, then, with ``style``, the
    s2t gate and alpha and the t2s gate and alpha (the reference's order).
    Stops at the first check where student and teacher PCK pass 0.95 (and,
    with ``style``, every gate case ran)."""
    s_imgs, _, s_target, s_weight = _tensors(src, dev)
    t_imgs, _, t_target, t_weight = _tensors(tgt, dev)
    eval_step = make_eval_step(dev)

    def pcks():
        return tuple(_pck(eval_step, model, t_imgs, t_target, t_weight)
                     for model in (state.student, state.teacher))

    before = _pck(eval_step, state.student, t_imgs, t_target, t_weight)
    # teacher := pretrained student, copied into the teacher's own tensors
    # (the reference reloads best_pt into both, train_human.py:209-213)
    state.teacher.load_state_dict(state.student.state_dict())

    aug_tea = torch.as_tensor(identity_aug(), device=dev)[None]
    generator = torch.Generator(device=dev).manual_seed(seed)
    run = (make_adapt_step(cfg, style, dev) if n == 1
           else AdaptStepBundler(cfg, style, dev))
    t_nchw = t_imgs.permute(0, 3, 1, 2)
    cases, trace, done, metrics = set(), [], 0, None
    t0 = time.perf_counter()
    while done < max_steps:
        m = min(n, max_steps - done)
        batches, gates = [], []
        for _ in range(m):
            aug_stu = identity_aug()
            aug_stu[:, 0] = rng.uniform(-20, 20, B)
            aug_stu = torch.as_tensor(aug_stu, device=dev)
            x_t_stu = inverse_warp_heatmaps(t_nchw, aug_stu, cfg.ratio).permute(0, 2, 3, 1)
            batches.append({"image_s": s_imgs, "target_s": s_target, "weight_s": s_weight,
                            "image_t_stu": x_t_stu, "images_t_tea": t_imgs[None],
                            "aug_param_stu": aug_stu, "aug_params_tea": aug_tea})
            gate = (False, 0.0, False, 0.0)
            if style is not None:
                do_s2t = 0.5 > rng.rand()
                alpha_s2t = float(rng.uniform(0, 1)) if do_s2t else 0.0
                do_t2s = 0.5 > rng.rand()
                alpha_t2s = float(rng.uniform(0, 1)) if do_t2s else 0.0
                gate = (bool(do_s2t), alpha_s2t, bool(do_t2s), alpha_t2s)
            cases.add((gate[0], gate[2]))
            gates.append(gate)
        if n == 1:
            state, metrics, _ = run(state, batches[0], LR, *gates[0], generator=generator)
        else:
            state, metrics, _ = run(state, batches, LR, *map(list, zip(*gates)),
                                    generator=generator)
            metrics = {k: v[-1] for k, v in metrics.items()}
        done += m
        if _check_due(done - m, done - 1, start):
            trace.append((done, *pcks()))
            if (style is None or len(cases) == 4) and min(trace[-1][1:]) > 0.95:
                break
    student, teacher = pcks()
    return {"pck_tgt_before": before, "pck_tgt_student": student,
            "pck_tgt_teacher": teacher, "steps": done,
            "loss_all": float(metrics["loss_all"]), "loss_c": float(metrics["loss_c"]),
            "cases": sorted(cases), "pck_trace": trace,
            "seconds": time.perf_counter() - t0, **_graphs(run)}


def adapt(state, cfg, src, tgt, rng, device=None, steps_per_dispatch=1):
    """Mean-teacher adaptation without style on the target batch ``tgt``
    (``make_blob_batch(rng, shift=True, kp=src_kp)``), from the pretrained
    ``state``, at most ADAPT_MAX steps. Returns the target PCK before (the pretrained student), the
    student's and the teacher's after, the last step's ``loss_all`` and
    ``loss_c``, the steps, the gate cases, the (steps, student, teacher)
    target PCKs of each check, the seconds and, bundled, the bundler's
    eager steps, captures and replays."""
    return _adapt_loop(state, cfg, src, tgt, rng, resolve_device(device),
                       steps_per_dispatch, None, ADAPT_MAX, 20, 1000)


def adapt_with_style(state, cfg, src, tgt, rng, device=None, steps_per_dispatch=1):
    """``adapt`` with the canonical style transfer: a meanstd StyleNet (random
    weights from seed 7) whose decoder ``train_decoder`` trains first, and
    both gates drawn at p=0.5 each iteration, at most STYLE_ADAPT_MAX steps.
    Returns ``adapt``'s record
    plus the decoder's first and last losses."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    style = StyleNet(style_loss_kind="meanstd")
    style.reset_parameters(torch.Generator().manual_seed(7))
    style.to(dev)
    d0, d1 = train_decoder(style, *(torch.as_tensor(x[0], device=dev) for x in (src, tgt)))
    decoder_s = time.perf_counter() - t0
    out = _adapt_loop(state, cfg, src, tgt, rng, dev, steps_per_dispatch, style,
                      STYLE_ADAPT_MAX, 30, 2000)
    return dict(out, decoder_first_loss=d0, decoder_last_loss=d1, decoder_seconds=decoder_s)


def threshold_checks(pre: dict, out: dict) -> dict:
    """What the JAX test asserts of one recipe, by name, from the records of
    ``pretrain_until`` and ``adapt``/``adapt_with_style``: of the plain
    recipe (``test_pipeline_learns``) its pretraining too, of the style
    recipe (``test_pipeline_learns_with_style_transfer``, whose record has
    the decoder's losses) the decoder and the gate cases instead."""
    floor = min(out["pck_tgt_before"] + 0.1, 0.9)
    if "decoder_last_loss" in out:
        checks = {
            "decoder_loss_fell": out["decoder_last_loss"] < out["decoder_first_loss"],
            "all_gate_cases": len(out["cases"]) == 4,
            "losses_finite": math.isfinite(out["loss_all"]),
        }
    else:
        checks = {
            "pretrain_loss_fell_3x": pre["last_loss"] < pre["first_loss"] / 3,
            "train_batch_pck_above_0.9": pre["pck_src"] > 0.9,
            "losses_finite": all(math.isfinite(v) for v in (
                pre["last_loss"], out["loss_all"], out["loss_c"])),
        }
    checks["student_target_pck_rose"] = out["pck_tgt_student"] > floor
    checks["teacher_target_pck_rose"] = out["pck_tgt_teacher"] > floor
    return checks


def main(argv=None):
    p = argparse.ArgumentParser(description="the learning recipe: one JSON line a run")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    p.add_argument("--repeat", type=int, default=1)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, seed, alpha, adapt_fn in (("plain", 0, 0.9, adapt),
                                        ("style", 1, 0.85, adapt_with_style)):
        for rep in range(args.repeat):
            rng = np.random.RandomState(seed)
            cfg, state = make_state(alpha, dev)
            src = make_blob_batch(rng)
            with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                            deterministic=True, allow_tf32=False):
                pre = pretrain_until(state, cfg, src, dev, STEPS_PER_DISPATCH)
                tgt = make_blob_batch(rng, shift=True, kp=src[1])
                out = adapt_fn(state, cfg, src, tgt, rng, dev, STEPS_PER_DISPATCH)
            checks = threshold_checks(pre, out)
            print(json.dumps({"recipe": name, "run": rep, "device": str(dev),
                              "ok": all(checks.values()), "checks": checks,
                              "pretrain": pre, "adapt": out}), flush=True)


if __name__ == "__main__":
    main()
