"""Trainer engine: the host loops around the port's steps.

PyTorch twin of ``uda_poseestimation_tpu/engine.py`` (the reference
implements these loops in train_human.py:244-500), one iteration per step
call; the bundled (``--steps-per-dispatch``, ROADMAP A8) and on-device
augmentation (``--device-aug``, A9) modes are not ported. It keeps what a
user of the JAX engine can observe:

- the same meter names and ``ProgressMeter`` lines;
- the host RNG draws in the reference's order: per iteration one
  ``rand()`` per enabled style gate and one ``uniform`` per gate that fires
  (train_human.py:270-276, 347-356); the adapt loop draws one
  ``randint(0, 2**31 - 1)`` per epoch, before its first iteration, and seeds
  the step's occlusion ``torch.Generator`` on the device from it, where the
  JAX loop makes its per-epoch PRNG key;
- the target iterator advanced exactly where the reference advances it (in
  pretraining only when the s2t gate fires);
- the one-deep software pipeline: step i's metrics are read back (a device
  sync) only after step i+1 has been enqueued, so the host builds the next
  batch while the device works; validation keeps up to 3 batches in flight.

Batches stay on the host until the step copies them to its device
(``parallel/train_step.py``), asynchronously from page-locked memory, which
is what the loader gives when the device is CUDA.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from .ops.pck import get_max_preds_np
from .utils.meter import AverageMeter, AverageMeterList, ProgressMeter


def _f32(x) -> torch.Tensor:
    """A batch leaf as a float32 tensor; a float32 tensor is returned as it
    is (its memory, page-locked or not, is kept)."""
    return torch.as_tensor(x).to(torch.float32)


def _stack_views(views) -> torch.Tensor:
    """(k, B, ...) from a list of k (B, ...) view batches; a single view is a
    view of its batch, so no copy is made."""
    views = [_f32(v) for v in views]
    if len(views) == 1:
        return views[0][None]
    out = torch.stack(views)
    return out.pin_memory() if views[0].is_pinned() else out


def make_source_batch(x_s, label_s, weight_s, image_t_style=None) -> dict:
    batch = {"image_s": _f32(x_s), "target_s": _f32(label_s), "weight_s": _f32(weight_s)}
    if image_t_style is not None:
        batch["image_t_style"] = _f32(image_t_style)
    return batch


def make_adapt_batch(src_tuple, tgt_tuple) -> dict:
    """The adapt step's batch from a source 4-tuple and a target 8-tuple
    (the RHD datasets' contracts, collated)."""
    x_s, label_s, weight_s, _meta_s = src_tuple
    (x_t_stu, _t_stu, _w_stu, meta_t_stu,
     x_t_teas, _t_teas, _w_teas, metas_t_tea) = tgt_tuple
    return {
        "image_s": _f32(x_s),
        "target_s": _f32(label_s),
        "weight_s": _f32(weight_s),
        "image_t_stu": _f32(x_t_stu),
        "images_t_tea": _stack_views(x_t_teas),
        "aug_param_stu": _f32(meta_t_stu["aug_param_stu"]),
        "aug_params_tea": _stack_views([m["aug_param_tea"] for m in metas_t_tea]),
    }


class StyleGate:
    """Host-side per-iteration Bernoulli + alpha draws (reference RNG order),
    from the global ``np.random`` stream (one process; the JAX package's
    process-synchronized stream comes with multi-GPU, ROADMAP A12)."""

    def __init__(self, enabled: bool, freq: float, alpha_range):
        self.enabled = enabled
        self.freq = freq
        self.alpha_range = tuple(alpha_range)

    def draw(self):
        if not self.enabled:
            return False, 0.0
        if self.freq > np.random.rand():
            return True, float(np.random.uniform(*self.alpha_range))
        return False, 0.0


def _device(state) -> torch.device:
    return next(state.student.parameters()).device


def _visualize_source(visualize, x_s, y_s, keypoint2d, i, args):
    pred_s, _ = get_max_preds_np(y_s.float().cpu().numpy())
    ratio = args.image_size / args.heatmap_size
    image = np.asarray(x_s[0])
    visualize(image, pred_s[0] * ratio, "source_{}_pred.jpg".format(i))
    if keypoint2d is not None:
        visualize(image, np.asarray(keypoint2d)[0], "source_{}_label.jpg".format(i))


def run_pretrain_epoch(state, pretrain_step, source_iter, target_iter, epoch, lr, args,
                       visualize=None, style_enabled=False):
    """Source-only supervised epoch (train_human.py:244-302).

    ``pretrain_step(state, batch, lr, do_s2t, alpha)`` is
    ``make_pretrain_step``'s step; with ``style_enabled`` the batch carries
    the target's first teacher view as the style image when the s2t gate
    fires, and zeros otherwise. Returns the state."""
    batch_time = AverageMeter("Time", ":4.2f")
    data_time = AverageMeter("Data", ":3.1f")
    losses_all = AverageMeter("Loss (all)", ":.4e")
    losses_s = AverageMeter("Loss (s)", ":.4e")
    acc_s = AverageMeter("Acc (s)", ":3.2f")
    progress = ProgressMeter(args.iters_per_epoch,
                             [batch_time, data_time, losses_all, losses_s, acc_s],
                             prefix="Epoch: [{}]".format(epoch))

    gate = StyleGate(style_enabled, getattr(args, "s2t_freq", 0.0),
                     getattr(args, "s2t_alpha", (0.0, 1.0)))
    dummy_style = None
    end = time.time()
    pending = None

    def flush(item):
        nonlocal end
        i, n, metrics, y_s, x_s, meta_s = item
        acc_s.update(float(metrics["acc_s"]), int(metrics["acc_cnt"]))  # syncs
        losses_all.update(float(metrics["loss_all"]), n)
        losses_s.update(float(metrics["loss_s"]), n)
        batch_time.update(time.time() - end)
        end = time.time()
        if i % args.print_freq == 0:
            progress.display(i)
            if visualize is not None and meta_s.get("keypoint2d") is not None:
                _visualize_source(visualize, x_s, y_s, meta_s["keypoint2d"], i, args)

    for i in range(args.iters_per_epoch):
        x_s, label_s, weight_s, meta_s = next(source_iter)
        do_s2t, alpha = gate.draw()
        image_t_style = None
        if style_enabled:
            if do_s2t:
                image_t_style = next(target_iter)[4][0]
            else:
                if dummy_style is None:
                    dummy_style = torch.zeros_like(_f32(x_s))
                    if torch.as_tensor(x_s).is_pinned():
                        dummy_style = dummy_style.pin_memory()
                image_t_style = dummy_style
        batch = make_source_batch(x_s, label_s, weight_s, image_t_style)
        data_time.update(time.time() - end)

        state, metrics, y_s = pretrain_step(state, batch, lr, do_s2t, alpha)
        if pending is not None:
            flush(pending)
        pending = (i, len(x_s), metrics, y_s, x_s, meta_s)
    if pending is not None:
        flush(pending)
    return state


def run_adapt_epoch(state, adapt_step, source_iter, target_iter, epoch, lr, args,
                    visualize=None, style_enabled=False):
    """Mean-teacher adaptation epoch (train_human.py:305-458).

    ``adapt_step(state, batch, lr, do_s2t, alpha_s2t, do_t2s, alpha_t2s,
    generator=...)`` is ``make_adapt_step``'s step; its occlusion draws come
    from one generator on the state's device, seeded per epoch from
    ``np.random``. Returns the state."""
    batch_time = AverageMeter("Time", ":4.2f")
    data_time = AverageMeter("Data", ":3.1f")
    losses_all = AverageMeter("Loss (all)", ":.4e")
    losses_s = AverageMeter("Loss (s)", ":.4e")
    losses_c = AverageMeter("Loss (c)", ":.4e")
    acc_s = AverageMeter("Acc (s)", ":3.2f")
    progress = ProgressMeter(args.iters_per_epoch,
                             [batch_time, data_time, losses_all, losses_s,
                              losses_c, acc_s],
                             prefix="Epoch: [{}]".format(epoch))

    s2t = StyleGate(style_enabled, getattr(args, "s2t_freq", 0.0),
                    getattr(args, "s2t_alpha", (0.0, 1.0)))
    t2s = StyleGate(style_enabled, getattr(args, "t2s_freq", 0.0),
                    getattr(args, "t2s_alpha", (0.0, 1.0)))
    generator = torch.Generator(device=_device(state))
    generator.manual_seed(int(np.random.randint(0, 2 ** 31 - 1)))
    end = time.time()
    pending = None

    def flush(item):
        nonlocal end
        i, n, metrics, y_s, src = item
        acc_s.update(float(metrics["acc_s"]), int(metrics["acc_cnt"]))  # syncs
        losses_all.update(float(metrics["loss_all"]), n)
        losses_s.update(float(metrics["loss_s"]), n)
        losses_c.update(float(metrics["loss_c"]), n)
        batch_time.update(time.time() - end)
        end = time.time()
        if i % args.print_freq == 0:
            progress.display(i)
            if visualize is not None:
                _visualize_source(visualize, src[0], y_s, src[3].get("keypoint2d"), i, args)

    for i in range(args.iters_per_epoch):
        src = next(source_iter)
        tgt = next(target_iter)
        batch = make_adapt_batch(src, tgt)
        data_time.update(time.time() - end)

        do_s2t, alpha_s2t = s2t.draw()
        do_t2s, alpha_t2s = t2s.draw()
        state, metrics, y_s = adapt_step(state, batch, lr, do_s2t, alpha_s2t,
                                         do_t2s, alpha_t2s, generator=generator)
        if pending is not None:
            flush(pending)
        pending = (i, len(src[0]), metrics, y_s, src)
    if pending is not None:
        flush(pending)
    return state


def run_validate(eval_step, model, val_loader, args, visualize=None):
    """Evaluation loop returning the group PCK (train_human.py:461-500).

    ``eval_step(model, x, label, weight)`` is ``make_eval_step``'s. A
    partial last batch runs as it is (no padding), so the loss and PCK of a
    batch are those of its real rows, as the JAX package's padded and
    rescaled ones are."""
    batch_time = AverageMeter("Time", ":6.3f")
    losses = AverageMeter("Loss", ":.2e")
    acc = AverageMeterList(list(range(val_loader.dataset.num_keypoints)), ":3.2f",
                           ignore_val=-1)
    progress = ProgressMeter(len(val_loader), [batch_time, losses], prefix="Test: ")
    end = time.time()
    depth = 3  # batches in flight before the oldest one's readback
    pending = deque()

    def flush(item):
        nonlocal end
        i, n, x, y, loss, acc_per_kpt, meta = item
        losses.update(float(loss), n)
        # float32 values, as the JAX package's meters accumulate them
        acc.update(list(acc_per_kpt.cpu().numpy()), n)
        batch_time.update(time.time() - end)
        end = time.time()
        if i % args.val_print_freq == 0:
            progress.display(i)
            if visualize is not None:
                pred, _ = get_max_preds_np(y.float().cpu().numpy())
                ratio = args.image_size / args.heatmap_size
                image = np.asarray(x[0])
                visualize(image, pred[0] * ratio, "val_{}_pred.jpg".format(i))
                visualize(image, np.asarray(meta["keypoint2d"])[0],
                          "val_{}_label.jpg".format(i))

    for i, (x, label, weight, meta) in enumerate(val_loader):
        y, loss, acc_per_kpt = eval_step(model, _f32(x), _f32(label), _f32(weight))
        pending.append((i, len(x), x, y, loss, acc_per_kpt, meta))
        if len(pending) >= depth:
            flush(pending.popleft())
    while pending:
        flush(pending.popleft())
    return val_loader.dataset.group_accuracy(acc.average())
