"""Trainer engine: the host loops around the port's steps.

PyTorch twin of ``uda_poseestimation_tpu/engine.py`` (the reference
implements these loops in train_human.py:244-500): one iteration per step
call, or with ``--steps-per-dispatch n > 1`` and a bundler
(``parallel/train_step.py``) n iterations per bundler call; the on-device
augmentation mode (``--device-aug``, ROADMAP A9) is not ported. It keeps
what a user of the JAX engine can observe:

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
  The bundled loops do the same over bundles: one readback per bundle, each
  iteration's Time the bundle's divided by its steps, a trailing partial
  bundle when n does not divide the epoch, and the same draws, target
  advances and log lines as the loops above (they pass no debug images).

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
                       visualize=None, style_enabled=False, bundler=None):
    """Source-only supervised epoch (train_human.py:244-302).

    ``pretrain_step(state, batch, lr, do_s2t, alpha)`` is
    ``make_pretrain_step``'s step; with ``style_enabled`` the batch carries
    the target's first teacher view as the style image when the s2t gate
    fires, and zeros otherwise. With ``bundler`` (a ``PretrainStepBundler``)
    and ``args.steps_per_dispatch > 1`` the epoch runs n iterations per
    bundler call. Returns the state."""
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
    n_bundle = _steps_per_dispatch(args)
    if n_bundle > 1 and bundler is not None:
        return _run_pretrain_epoch_bundled(
            state, bundler, source_iter, target_iter, lr, args, gate, style_enabled,
            n_bundle, [batch_time, data_time, losses_all, losses_s, acc_s], progress)
    dummy_style = _DummyStyle()
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
            image_t_style = next(target_iter)[4][0] if do_s2t else dummy_style(x_s)
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
                    visualize=None, style_enabled=False, bundler=None):
    """Mean-teacher adaptation epoch (train_human.py:305-458).

    ``adapt_step(state, batch, lr, do_s2t, alpha_s2t, do_t2s, alpha_t2s,
    generator=...)`` is ``make_adapt_step``'s step; its occlusion draws come
    from one generator on the state's device, seeded per epoch from
    ``np.random``. With ``bundler`` (an ``AdaptStepBundler``) and
    ``args.steps_per_dispatch > 1`` the epoch runs n iterations per bundler
    call. Returns the state."""
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
    n_bundle = _steps_per_dispatch(args)
    if n_bundle > 1 and bundler is not None:
        return _run_adapt_epoch_bundled(
            state, bundler, source_iter, target_iter, lr, args, s2t, t2s, generator,
            n_bundle, [batch_time, data_time, losses_all, losses_s, losses_c, acc_s],
            progress)
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


def _steps_per_dispatch(args) -> int:
    return max(1, int(getattr(args, "steps_per_dispatch", 1) or 1))


class _DummyStyle:
    """The zeros a pretrain batch carries as its style image when the s2t
    gate does not fire: made once, page-locked when the source batch is."""

    def __init__(self):
        self.zeros = None

    def __call__(self, x_s):
        if self.zeros is None:
            self.zeros = torch.zeros_like(_f32(x_s))
            if torch.as_tensor(x_s).is_pinned():
                self.zeros = self.zeros.pin_memory()
        return self.zeros


class _Readback:
    """A bundle's stacked metrics on their way to the host: the copy is
    queued behind the bundle when it is enqueued, so reading them waits for
    that bundle only, not for the next one queued after it."""

    def __init__(self, metrics):
        self.metrics = {k: v.to("cpu", non_blocking=True) for k, v in metrics.items()
                        if isinstance(v, torch.Tensor)}
        self.done = None
        if any(v.device.type == "cuda" for v in metrics.values()
               if isinstance(v, torch.Tensor)):
            self.done = torch.cuda.Event()
            self.done.record()

    def get(self) -> dict:
        if self.done is not None:
            self.done.synchronize()
        return {k: v.tolist() for k, v in self.metrics.items()}


def _bundle_flush(meters, progress, args, names):
    """The bundled loops' flush: one readback per bundle, then each of its
    iterations into the meters and the log, Time being the bundle's time
    split evenly (the JAX package's bundled loops)."""
    batch_time, _data_time, *loss_meters, acc_s = meters
    end = [time.time()]

    def flush(item):
        base_i, n_sub, n_img, readback, _batches = item
        m = readback.get()
        dt = (time.time() - end[0]) / n_sub
        for j in range(n_sub):
            acc_s.update(float(m["acc_s"][j]), int(m["acc_cnt"][j]))
            for meter, name in zip(loss_meters, names):
                meter.update(float(m[name][j]), n_img)
            batch_time.update(dt)
            if (base_i + j) % args.print_freq == 0:
                progress.display(base_i + j)
        end[0] = time.time()

    return flush, end


def _run_pretrain_epoch_bundled(state, bundler, source_iter, target_iter, lr, args, gate,
                                style_enabled, n_bundle, meters, progress):
    """n-iterations-per-call pretrain epoch (see run_pretrain_epoch). Per
    iteration it fetches the source, draws the s2t gate and fetches a target
    only when the gate fires, as the unbundled loop does, so both consume
    the same streams."""
    data_time = meters[1]
    flush, end = _bundle_flush(meters, progress, args, ("loss_all", "loss_s"))
    dummy_style = _DummyStyle()
    pending = None
    i = 0
    while i < args.iters_per_epoch:
        n_sub = min(n_bundle, args.iters_per_epoch - i)
        batches, gates = [], []
        for _ in range(n_sub):
            x_s, label_s, weight_s, _meta = next(source_iter)
            do_s2t, alpha = gate.draw()
            image_t_style = None
            if style_enabled:
                image_t_style = next(target_iter)[4][0] if do_s2t else dummy_style(x_s)
            batches.append(make_source_batch(x_s, label_s, weight_s, image_t_style))
            gates.append((do_s2t, alpha))
        data_time.update(time.time() - end[0])

        do_s2t, alphas = zip(*gates)
        state, metrics, _ = bundler(state, batches, lr, do_s2t, alphas)
        readback = _Readback(metrics)
        if pending is not None:
            flush(pending)
        # the host batches stay alive until their bundle is read back
        pending = (i, n_sub, len(batches[0]["image_s"]), readback, batches)
        i += n_sub
    if pending is not None:
        flush(pending)
    return state


def _run_adapt_epoch_bundled(state, bundler, source_iter, target_iter, lr, args, s2t, t2s,
                             generator, n_bundle, meters, progress):
    """n-iterations-per-call adaptation epoch (see run_adapt_epoch). Per
    iteration it fetches the source and the target, then draws s2t and t2s,
    as the unbundled loop does."""
    data_time = meters[1]
    flush, end = _bundle_flush(meters, progress, args, ("loss_all", "loss_s", "loss_c"))
    pending = None
    i = 0
    while i < args.iters_per_epoch:
        n_sub = min(n_bundle, args.iters_per_epoch - i)
        batches, gates = [], []
        for _ in range(n_sub):
            src = next(source_iter)
            tgt = next(target_iter)
            batches.append(make_adapt_batch(src, tgt))
            gates.append((*s2t.draw(), *t2s.draw()))
        data_time.update(time.time() - end[0])

        do_s2t, alpha_s2t, do_t2s, alpha_t2s = zip(*gates)
        state, metrics, _ = bundler(state, batches, lr, do_s2t, alpha_s2t, do_t2s,
                                    alpha_t2s, generator=generator)
        readback = _Readback(metrics)
        if pending is not None:
            flush(pending)
        pending = (i, n_sub, len(batches[0]["image_s"]), readback, batches)
        i += n_sub
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
