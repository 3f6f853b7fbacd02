"""Trainer engine: the host loops around the port's steps.

PyTorch twin of ``uda_poseestimation_tpu/engine.py`` (the reference
implements these loops in train_human.py:244-500): one iteration per step
call, or with ``--steps-per-dispatch n > 1`` and a bundler
(``parallel/train_step.py``) n iterations per bundler call. It keeps what a
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
  The bundled loops do the same over bundles: one readback per bundle, each
  iteration's Time the bundle's divided by its steps, a trailing partial
  bundle when n does not divide the epoch, and the same draws, target
  advances and log lines as the loops above (they pass no debug images);
- ``--device-aug`` (``DeviceAugPipeline`` for the human trainer,
  ``AnimalDeviceAugPipeline`` for the animal ones): the loaders give raw
  uint8 canvases or frames and the views are built on the device, inside
  the adapt step (and the bundled pretrain step) or, in the unbundled
  pretrain loop, just before the step, with the JAX loops' fetch order: the
  target is fetched in pretraining only when s2t fires, and a bundle's
  other iterations carry zero style inputs (``pretrain_style_template``).

Under several processes (``parallel/distributed.py``) each rank runs these
loops on its rows: the control draws come from the epoch's synchronized
stream (``_control_rng``, JAX ``engine._control_rng``), only rank 0 prints
and draws images, and validation splits each batch over the ranks.

Batches stay on the host until the step copies them to its device
(``parallel/train_step.py``), asynchronously from page-locked memory, which
is what the loader gives when the device is CUDA.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .ops.device_aug import (animal_source_views, animal_views, augment_views,
                              draw_animal_source, draw_rrc, draw_view, rrc_views)
from .ops.pck import get_max_preds_np
from .parallel import distributed as dist
from .utils.meter import AverageMeter, AverageMeterList, ProgressMeter


def _f32(x) -> torch.Tensor:
    """A batch leaf as a float32 tensor, page-locked when the loader's was
    (a float32 tensor is returned as it is)."""
    t = torch.as_tensor(x)
    return _pinned_like(t.to(torch.float32), t)


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


def _pinned_like(out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return out.pin_memory() if like.is_pinned() else out


class _DeviceAugBase:
    """What both ``--device-aug`` pipelines share: the device, the
    pipeline's own generator (seeded from ``seed``; the JAX pipeline's key
    stream) and the zero style inputs of a bundled pretrain iteration whose
    s2t gate did not fire."""

    # the unbundled pretrain loop's debug images draw the source's keypoint2d
    host_visualizable = True
    # the pretrain phase takes raw batches too (else only the adapt phase)
    source_on_device = True

    def __init__(self, seed: int, device: DeviceLike):
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._zeros = {}

    @staticmethod
    def dev_canvas(c: torch.Tensor) -> torch.Tensor:
        """uint8 canvases cross host to device 4x smaller; /255 there (the
        host ToTensor's division, within 1 ulp)."""
        return c.to(torch.float32) / 255.0 if c.dtype == torch.uint8 else c

    def _gen(self, generator):
        return self.generator if generator is None else generator

    def style_zeros(self, template, like) -> dict:
        """The zeros of ``template``, made once per shape (page-locked when
        ``like`` is)."""
        key = tuple(sorted((k, s, str(d)) for k, (s, d) in template.items()))
        if key not in self._zeros:
            self._zeros[key] = {k: _pinned_like(torch.zeros(s, dtype=d), like)
                                for k, (s, d) in template.items()}
        return self._zeros[key]

    def _put(self, tensors):
        return tuple(t.to(self.device, non_blocking=True) for t in tensors)


class DeviceAugPipeline(_DeviceAugBase):
    """``--device-aug`` for the human trainer: every augmented view drawn and
    rendered on the device (``ops/device_aug.py``; the JAX package's
    ``DeviceAugPipeline``).

    The host datasets give one canvas per sample (Resize + ToUint8Canvas,
    identity ``aug_param``); the batches cross to the device as uint8,
    page-locked when the loader pins them, and are divided by 255 there.
    ``view_builder`` makes the adapt step's batch from them inside the step
    (``make_adapt_step(view_builder=...)``): the source view, one shared
    RandomResizedCrop base view of the target and from it the student view
    and k teacher views. ``pretrain_view_builder`` does the same for the
    pretrain step, the style image only when s2t fires. The unbundled
    pretrain loop calls ``prep_source`` and ``style_image`` itself.

    Draws come from ``generator`` where one is given (the adapt step's
    occlusion generator), else from ``self.generator``; or injected as
    ``draws``: {"source": ``draw_view`` of (1, B)} and {"target": {"base":
    ``draw_rrc`` of (B,), "student": (1, B), "teacher": (k, B)}}, drawn in
    that order. Under a process group they are drawn for the global batch
    and a rank keeps its rows (injected draws are the rank's rows).
    """

    def __init__(self, cfg_src, cfg_stu, cfg_tea, k: int, mean, std, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__(seed, device)
        self.cfg_src, self.cfg_stu, self.cfg_tea = cfg_src, cfg_stu, cfg_tea
        self.k = k
        self.mean, self.std = tuple(mean), tuple(std)

    def draw_source(self, b: int, canvas: int, generator=None) -> dict:
        g = self._gen(generator)
        return dist.global_draw(
            lambda n: draw_view(self.cfg_src, (1, n), canvas, self.device, g), b, axis=1)

    def draw_target(self, b: int, canvas: int, generator=None) -> dict:
        g = self._gen(generator)
        return {"base": dist.global_draw(
                    lambda n: draw_rrc(self.cfg_src, (n,), canvas, self.device, g), b),
                "student": dist.global_draw(
                    lambda n: draw_view(self.cfg_stu, (1, n), canvas, self.device, g), b,
                    axis=1),
                "teacher": dist.global_draw(
                    lambda n: draw_view(self.cfg_tea, (self.k, n), canvas, self.device, g), b,
                    axis=1)}

    def prep_source(self, canvas, kp, vis, generator=None, draws=None):
        """The source view: (image, target, target_weight, keypoint2d)."""
        c = self.dev_canvas(canvas)
        if draws is None:
            draws = self.draw_source(c.shape[0], c.shape[1], generator)
        out = augment_views(c, kp, vis, self.cfg_src, draws, self.mean, self.std)
        return (out["image"][0], out["target"][0], out["target_weight"][0],
                out["keypoint2d"][0])

    def prep_target(self, canvas, kp, vis, generator=None, draws=None):
        """The target views: (student image, its aug_param, the k teacher
        images (k, B, ...), their aug_params (k, B, 6))."""
        c = self.dev_canvas(canvas)
        if draws is None:
            draws = self.draw_target(c.shape[0], c.shape[1], generator)
        base_img, base_kp = rrc_views(c, kp, draws["base"], self.cfg_src.image_size)
        stu = augment_views(base_img, base_kp, vis, self.cfg_stu, draws["student"],
                            self.mean, self.std, targets=False)
        tea = augment_views(base_img, base_kp, vis, self.cfg_tea, draws["teacher"],
                            self.mean, self.std, targets=False)
        return stu["image"][0], stu["aug_param"][0], tea["image"], tea["aug_param"]

    def view_builder(self, raw_batch, generator=None, draws=None) -> dict:
        """The adapt step's batch from a raw one, on the raw batch's device
        (pass to ``make_adapt_step(view_builder=...)``)."""
        draws = draws or {}
        img_s, tgt_s, w_s, _kp = self.prep_source(
            raw_batch["canvas_s"], raw_batch["kp_s"], raw_batch["vis_s"], generator,
            draws.get("source"))
        x_t_stu, aug_stu, x_t_teas, aug_teas = self.prep_target(
            raw_batch["canvas_t"], raw_batch["kp_t"], raw_batch["vis_t"], generator,
            draws.get("target"))
        return {"image_s": img_s, "target_s": tgt_s, "weight_s": w_s,
                "image_t_stu": x_t_stu, "images_t_tea": x_t_teas,
                "aug_param_stu": aug_stu, "aug_params_tea": aug_teas}

    def pretrain_view_builder(self, style_enabled: bool):
        """The pretrain step's builder, ``build(raw_batch, do_s2t,
        generator=None, draws=None)``: the source views and, when style is
        on and s2t fires, the style image (the first teacher view, as the
        reference feeds it, train_human.py:270-276). Otherwise no style image
        is built: the step reads it only when s2t fires."""

        def build(raw_batch, do_s2t, generator=None, draws=None):
            draws = draws or {}
            img_s, tgt_s, w_s, _kp = self.prep_source(
                raw_batch["canvas_s"], raw_batch["kp_s"], raw_batch["vis_s"], generator,
                draws.get("source"))
            out = {"image_s": img_s, "target_s": tgt_s, "weight_s": w_s}
            if style_enabled and do_s2t:
                out["image_t_style"] = self.prep_target(
                    raw_batch["canvas_t"], raw_batch["kp_t"], raw_batch["vis_t"],
                    generator, draws.get("target"))[2][0]
            return out

        return build

    def _pack_canvas(self, x) -> torch.Tensor:
        """uint8 transport when the canvas is exactly on the uint8/255 grid
        (a uint8 batch passes as it is); any other batch ships as float32.
        A packed batch stays page-locked if it was."""
        x = torch.as_tensor(x)
        if x.dtype == torch.uint8:
            return x
        x = x.to(torch.float32)
        q = torch.round(x * 255.0)
        if x.numel() and float((q / 255.0 - x).abs().max()) < 1e-6:
            return _pinned_like(q.to(torch.uint8), x)
        return x

    def _raw(self, canvas, kp, weight, suffix) -> dict:
        return {"canvas" + suffix: self._pack_canvas(canvas), "kp" + suffix: _f32(kp),
                "vis" + suffix: _f32(weight)[..., 0]}

    def raw_adapt_batch(self, src_tuple, tgt_tuple) -> dict:
        """The raw adapt batch, on the host: the step copies it to its device
        (a bundler stages it)."""
        x, _t, weight, meta = src_tuple
        meta_t = tgt_tuple[3]
        return {**self._raw(x, meta["keypoint2d"], weight, "_s"),
                **self._raw(tgt_tuple[0], meta_t["keypoint2d_ori"],
                            meta_t["target_weight_ori"], "_t")}

    def raw_pretrain_batch(self, src_tuple, tgt_tuple=None) -> dict:
        """The raw pretrain batch of one iteration, on the host; ``tgt_tuple``
        gives the style canvases when the s2t gate fired."""
        x, _t, weight, meta = src_tuple
        batch = self._raw(x, meta["keypoint2d"], weight, "_s")
        if tgt_tuple is not None:
            meta_t = tgt_tuple[3]
            batch.update(self._raw(tgt_tuple[0], meta_t["keypoint2d_ori"],
                                   meta_t["target_weight_ori"], "_t"))
        return batch

    def pretrain_style_template(self, raw_batch) -> dict:
        """{style leaf: (shape, dtype)} of the zeros a bundled pretrain
        iteration whose s2t gate did not fire carries (the target stream is
        fetched only on fired draws); from the source leaves, since source
        and target canvases share the canvas grid and keypoint count."""
        return {"canvas_t": (tuple(raw_batch["canvas_s"].shape), raw_batch["canvas_s"].dtype),
                "kp_t": (tuple(raw_batch["kp_s"].shape), torch.float32),
                "vis_t": (tuple(raw_batch["vis_s"].shape), torch.float32)}

    def raw_source(self, src_tuple):
        """(canvas, keypoints, visibility) of a source batch on the device."""
        x, _t, weight, meta = src_tuple
        return self._put(self._raw(x, meta["keypoint2d"], weight, "_s").values())

    def raw_target(self, tgt_tuple):
        meta = tgt_tuple[3]
        return self._put(self._raw(tgt_tuple[0], meta["keypoint2d_ori"],
                                   meta["target_weight_ori"], "_t").values())

    def style_image(self, tgt_tuple) -> torch.Tensor:
        """The normalized style image of an unbundled pretrain s2t draw: the
        first teacher view, drawn from ``self.generator``."""
        return self.prep_target(*self.raw_target(tgt_tuple))[2][0]


class AnimalDeviceAugPipeline(_DeviceAugBase):
    """``--device-aug`` for the animal trainers: every random view drawn and
    rendered on the device (the JAX package's ``AnimalDeviceAugPipeline``).

    The target's ``_mt`` set gives its uint8 crop at ``inp_res`` with the
    keypoints in the original frame, their visibility, the crop's center and
    scale (``canvas``, ``kp_orig``, ``vis``, ``center``, ``scale`` in the
    student's meta); the student view and the k teacher views are warped
    from it on the device (``animal_views``, normalized by ``mean`` only).
    With ``src_cfg`` the synthetic source's raw set (``raw_mode``) gives its
    decoded uint8 frames with their keypoints, centers and scales, and its
    imgaug chain, flip, crop and targets run on the device too
    (``animal_source_views``, with ``flip_perm`` and ``src_mean``); without,
    the source's host batch passes through (its ``image_s``, ``target_s`` and
    ``weight_s``) and only the adapt phase takes raw batches.

    ``view_builder`` makes the adapt step's batch inside the step;
    ``pretrain_view_builder`` the pretrain step's, whose style image is the
    host-normalized identity teacher view as it is (the ``_mt`` sets
    normalize their teacher views on the host under ``--device-aug`` too:
    what the reference feeds). The source's keypoint2d exists on the device
    only (``host_visualizable``). Draws come from ``generator``, else from
    ``self.generator``, or injected as ``draws``: {"target": {"student":
    ``draw_view`` of (1, B), "teacher": (k, B)}, "source":
    ``draw_animal_source`` of B}, drawn in that order; under a process group
    for the global batch, of which a rank keeps its rows.
    """

    host_visualizable = False

    def __init__(self, cfg_stu, cfg_tea, k: int, mean, seed: int = 0,
                 device: DeviceLike = None, src_cfg=None, flip_perm=None, src_mean=None):
        super().__init__(seed, device)
        self.cfg_stu, self.cfg_tea, self.k = cfg_stu, cfg_tea, k
        self.mean = tuple(float(v) for v in mean)
        self.src_cfg = src_cfg
        self.source_on_device = src_cfg is not None
        self.flip_perm = (None if flip_perm is None else
                          torch.as_tensor(np.asarray(flip_perm, np.int64)).to(self.device))
        self.src_mean = None if src_mean is None else tuple(float(v) for v in src_mean)

    def draw_target(self, b: int, generator=None) -> dict:
        g, size = self._gen(generator), self.cfg_stu.image_size
        return {"student": dist.global_draw(
                    lambda n: draw_view(self.cfg_stu, (1, n), size, self.device, g), b,
                    axis=1),
                "teacher": dist.global_draw(
                    lambda n: draw_view(self.cfg_tea, (self.k, n), size, self.device, g), b,
                    axis=1)}

    def draw_source(self, b: int, generator=None) -> dict:
        g = self._gen(generator)
        return dist.global_draw(lambda n: draw_animal_source(self.src_cfg, n, self.device, g),
                                b)

    def prep_source(self, canvas, pts, center, scale, generator=None, draws=None):
        """The source views: (image, target, target_weight, keypoint2d)."""
        if draws is None:
            draws = self.draw_source(canvas.shape[0], generator)
        out = animal_source_views(canvas, pts, center, scale, self.flip_perm, self.src_cfg,
                                  draws, mean=self.src_mean)
        return out["image"], out["target"], out["target_weight"], out["keypoint2d"]

    def prep_target(self, canvas, kp, vis, center, scale, generator=None, draws=None):
        """The target views: (student image, its aug_param, the k teacher
        images (k, B, ...), their aug_params (k, B, 6))."""
        c = self.dev_canvas(canvas)
        if draws is None:
            draws = self.draw_target(c.shape[0], generator)
        stu, tea = (animal_views(c, kp, vis, center, scale, cfg, draws[name], self.mean,
                                 targets=False)
                    for cfg, name in ((self.cfg_stu, "student"), (self.cfg_tea, "teacher")))
        return stu["image"][0], stu["aug_param"][0], tea["image"], tea["aug_param"]

    def view_builder(self, raw_batch, generator=None, draws=None) -> dict:
        """The adapt step's batch from a raw one, on the raw batch's device
        (pass to ``make_adapt_step(view_builder=...)``)."""
        draws = draws or {}
        x_t_stu, aug_stu, x_t_teas, aug_teas = self.prep_target(
            raw_batch["canvas_t"], raw_batch["kp_t"], raw_batch["vis_t"],
            raw_batch["center_t"], raw_batch["scale_t"], generator, draws.get("target"))
        if self.src_cfg is not None:
            img_s, tgt_s, w_s, _kp = self.prep_source(
                raw_batch["canvas_s"], raw_batch["pts_s"], raw_batch["center_s"],
                raw_batch["scale_s"], generator, draws.get("source"))
        else:
            img_s, tgt_s, w_s = (raw_batch[k] for k in ("image_s", "target_s", "weight_s"))
        return {"image_s": img_s, "target_s": tgt_s, "weight_s": w_s,
                "image_t_stu": x_t_stu, "images_t_tea": x_t_teas,
                "aug_param_stu": aug_stu, "aug_params_tea": aug_teas}

    def pretrain_view_builder(self, style_enabled: bool):
        """The pretrain step's builder, ``build(raw_batch, do_s2t,
        generator=None, draws=None)``: the source views, and the style image
        passed through when style is on and s2t fires. Needs ``src_cfg``."""
        if self.src_cfg is None:
            raise ValueError("the animal pretrain view builder needs src_cfg "
                             "(the source's raw frames on the device)")

        def build(raw_batch, do_s2t, generator=None, draws=None):
            img_s, tgt_s, w_s, _kp = self.prep_source(
                raw_batch["canvas_s"], raw_batch["pts_s"], raw_batch["center_s"],
                raw_batch["scale_s"], generator, (draws or {}).get("source"))
            out = {"image_s": img_s, "target_s": tgt_s, "weight_s": w_s}
            if style_enabled and do_s2t:
                out["image_t_style"] = raw_batch["image_t_style"]
            return out

        return build

    @staticmethod
    def _raw_source(meta) -> dict:
        return {"canvas_s": torch.as_tensor(meta["canvas"]), "pts_s": _f32(meta["pts"]),
                "center_s": _f32(meta["center"]), "scale_s": _f32(meta["scale"])}

    def raw_adapt_batch(self, src_tuple, tgt_tuple) -> dict:
        """The raw adapt batch, on the host: the step copies it to its device
        (a bundler stages it)."""
        meta = tgt_tuple[3]
        canvas_t = torch.as_tensor(meta["canvas"])
        if canvas_t.dtype != torch.uint8:  # a float canvas in [0, 255]
            canvas_t = _f32(canvas_t) / 255.0
        batch = {"canvas_t": canvas_t, "kp_t": _f32(meta["kp_orig"]),
                 "vis_t": _f32(meta["vis"]), "center_t": _f32(meta["center"]),
                 "scale_t": _f32(meta["scale"])}
        if self.src_cfg is not None:
            batch.update(self._raw_source(src_tuple[3]))
        else:
            x_s, label_s, weight_s, _meta = src_tuple
            batch.update(image_s=_f32(x_s), target_s=_f32(label_s), weight_s=_f32(weight_s))
        return batch

    def raw_pretrain_batch(self, src_tuple, tgt_tuple=None) -> dict:
        """The raw pretrain batch of one iteration, on the host; ``tgt_tuple``
        gives the style image when the s2t gate fired."""
        batch = self._raw_source(src_tuple[3])
        if tgt_tuple is not None:
            batch["image_t_style"] = _f32(tgt_tuple[4][0])
        return batch

    def pretrain_style_template(self, raw_batch) -> dict:
        """{style leaf: (shape, dtype)} of the zeros a bundled pretrain
        iteration whose s2t gate did not fire carries: the identity teacher
        view at image size."""
        size = self.cfg_stu.image_size
        return {"image_t_style": ((raw_batch["canvas_s"].shape[0], size, size, 3),
                                  torch.float32)}

    def raw_source(self, src_tuple):
        """(frames, keypoints, centers, scales) of a source batch on the
        device, for ``prep_source``."""
        return self._put(self._raw_source(src_tuple[3]).values())

    def style_image(self, tgt_tuple) -> torch.Tensor:
        """The style image of an unbundled pretrain s2t draw: the identity
        teacher view, as the host normalized it."""
        return self._put([_f32(tgt_tuple[4][0])])[0]


def _stack_host_leaves(batches) -> list:
    """A bundle's batches with the JAX ``_stack_host_leaves`` dtype rule per
    leaf: canvases stay uint8 only when every batch of the bundle packed to
    uint8; in a mixed bundle the uint8 ones are decoded to the float32
    canvas (u8 / 255) first. (The port stages the batches one by one, so
    nothing is stacked; a leaf keeps one dtype across the bundle.)"""
    out = [dict(b) for b in batches]
    for k in batches[0]:
        leaves = [b[k] for b in batches]
        u8 = [torch.as_tensor(x).dtype == torch.uint8 for x in leaves]
        if any(u8) and not all(u8):
            for b, is_u8 in zip(out, u8):
                if is_u8:
                    b[k] = torch.as_tensor(b[k]).to(torch.float32) / 255.0
    return out


class StyleGate:
    """Host-side per-iteration Bernoulli + alpha draws (reference RNG order),
    from ``rng``: the global ``np.random`` stream, or the epoch's
    process-synchronized one (``_control_rng``)."""

    def __init__(self, enabled: bool, freq: float, alpha_range, rng=None):
        self.enabled = enabled
        self.freq = freq
        self.alpha_range = tuple(alpha_range)
        self.rng = np.random if rng is None else rng

    def draw(self):
        if not self.enabled:
            return False, 0.0
        if self.freq > self.rng.rand():
            return True, float(self.rng.uniform(*self.alpha_range))
        return False, 0.0


def _control_rng(args, epoch):
    """The epoch's control stream (style gates and alphas, the occlusion
    generator's seed): the global ``np.random`` (the reference's), or under
    several processes ``distributed.control_rng``, the same on every rank."""
    if dist.is_multiprocess():
        return dist.control_rng(getattr(args, "seed", 0) or 0, epoch)
    return np.random


def _device(state) -> torch.device:
    return next(state.student.parameters()).device


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _visualize_source(visualize, x_s, y_s, keypoint2d, i, args):
    pred_s, _ = get_max_preds_np(y_s.float().cpu().numpy())
    ratio = args.image_size / args.heatmap_size
    image = _host(x_s[0])
    visualize(image, pred_s[0] * ratio, "source_{}_pred.jpg".format(i))
    if keypoint2d is not None:
        visualize(image, _host(keypoint2d)[0], "source_{}_label.jpg".format(i))


def run_pretrain_epoch(state, pretrain_step, source_iter, target_iter, epoch, lr, args,
                       visualize=None, style_enabled=False, bundler=None,
                       device_aug=None):
    """Source-only supervised epoch (train_human.py:244-302).

    ``pretrain_step(state, batch, lr, do_s2t, alpha)`` is
    ``make_pretrain_step``'s step; with ``style_enabled`` the batch carries
    the target's first teacher view as the style image when the s2t gate
    fires, and zeros otherwise. With ``bundler`` (a ``PretrainStepBundler``)
    and ``args.steps_per_dispatch > 1`` the epoch runs n iterations per
    bundler call. With ``device_aug`` (a ``DeviceAugPipeline``, or an
    ``AnimalDeviceAugPipeline`` whose source is on the device) the batches
    are raw canvases: the unbundled loop builds the views on the device
    before each step, the bundler's step builds them itself. Returns the
    state."""
    batch_time = AverageMeter("Time", ":4.2f")
    data_time = AverageMeter("Data", ":3.1f")
    losses_all = AverageMeter("Loss (all)", ":.4e")
    losses_s = AverageMeter("Loss (s)", ":.4e")
    acc_s = AverageMeter("Acc (s)", ":3.2f")
    progress = ProgressMeter(args.iters_per_epoch,
                             [batch_time, data_time, losses_all, losses_s, acc_s],
                             prefix="Epoch: [{}]".format(epoch))

    gate = StyleGate(style_enabled, getattr(args, "s2t_freq", 0.0),
                     getattr(args, "s2t_alpha", (0.0, 1.0)), rng=_control_rng(args, epoch))
    n_bundle = _steps_per_dispatch(args)
    if n_bundle > 1 and bundler is not None:
        return _run_pretrain_epoch_bundled(
            state, bundler, source_iter, target_iter, lr, args, gate, style_enabled,
            n_bundle, [batch_time, data_time, losses_all, losses_s, acc_s], progress,
            device_aug)
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
        if i % args.print_freq == 0 and dist.is_primary():
            progress.display(i)
            if visualize is not None and meta_s.get("keypoint2d") is not None:
                _visualize_source(visualize, x_s, y_s, meta_s["keypoint2d"], i, args)

    for i in range(args.iters_per_epoch):
        x_s, label_s, weight_s, meta_s = next(source_iter)
        do_s2t, alpha = gate.draw()
        if device_aug is not None:
            raw = device_aug.raw_source((x_s, label_s, weight_s, meta_s))
            img_s, tgt_s, w_s, kp_aug = device_aug.prep_source(*raw)
            batch = {"image_s": img_s, "target_s": tgt_s, "weight_s": w_s}
            # the animal source's keypoint2d exists on the device only
            meta_s = {"keypoint2d": kp_aug if device_aug.host_visualizable else None}
            if style_enabled:
                batch["image_t_style"] = (device_aug.style_image(next(target_iter))
                                          if do_s2t else torch.zeros_like(img_s))
        else:
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
                    visualize=None, style_enabled=False, bundler=None, device_aug=None):
    """Mean-teacher adaptation epoch (train_human.py:305-458).

    ``adapt_step(state, batch, lr, do_s2t, alpha_s2t, do_t2s, alpha_t2s,
    generator=...)`` is ``make_adapt_step``'s step; its occlusion draws (and
    with ``device_aug`` its view draws, made first) come from one generator
    on the state's device, seeded per epoch from the control stream
    (``_control_rng``). With
    ``bundler`` (an ``AdaptStepBundler``) and ``args.steps_per_dispatch >
    1`` the epoch runs n iterations per bundler call. With ``device_aug`` (a
    ``DeviceAugPipeline`` or an ``AnimalDeviceAugPipeline``) the batches are
    raw, for a step made with its ``view_builder``. Returns the state."""
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

    ctrl = _control_rng(args, epoch)
    s2t = StyleGate(style_enabled, getattr(args, "s2t_freq", 0.0),
                    getattr(args, "s2t_alpha", (0.0, 1.0)), rng=ctrl)
    t2s = StyleGate(style_enabled, getattr(args, "t2s_freq", 0.0),
                    getattr(args, "t2s_alpha", (0.0, 1.0)), rng=ctrl)
    generator = torch.Generator(device=_device(state))
    generator.manual_seed(int(ctrl.randint(0, 2 ** 31 - 1)))
    n_bundle = _steps_per_dispatch(args)
    if n_bundle > 1 and bundler is not None:
        return _run_adapt_epoch_bundled(
            state, bundler, source_iter, target_iter, lr, args, s2t, t2s, generator,
            n_bundle, [batch_time, data_time, losses_all, losses_s, losses_c, acc_s],
            progress, device_aug)
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
        if i % args.print_freq == 0 and dist.is_primary():
            progress.display(i)
            if visualize is not None:
                _visualize_source(visualize, src[0], y_s, src[3].get("keypoint2d"), i, args)

    for i in range(args.iters_per_epoch):
        src = next(source_iter)
        tgt = next(target_iter)
        if device_aug is not None:
            # raw canvases only: the step builds every view
            batch = device_aug.raw_adapt_batch(src, tgt)
            src = (src[0], None, None, {"keypoint2d": None})
        else:
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
            if (base_i + j) % args.print_freq == 0 and dist.is_primary():
                progress.display(base_i + j)
        end[0] = time.time()

    return flush, end


def _run_pretrain_epoch_bundled(state, bundler, source_iter, target_iter, lr, args, gate,
                                style_enabled, n_bundle, meters, progress, device_aug=None):
    """n-iterations-per-call pretrain epoch (see run_pretrain_epoch). Per
    iteration it fetches the source, draws the s2t gate and fetches a target
    only when the gate fires, as the unbundled loop does, so both consume
    the same streams. With ``device_aug`` an iteration whose gate did not
    fire carries zero style inputs, shaped as a fired one's or, before any
    fired, by ``pretrain_style_template``."""
    data_time = meters[1]
    flush, end = _bundle_flush(meters, progress, args, ("loss_all", "loss_s"))
    dummy_style = _DummyStyle()
    style_tpl = None  # {style leaf: (shape, dtype)} once known
    pending = None
    i = 0
    while i < args.iters_per_epoch:
        n_sub = min(n_bundle, args.iters_per_epoch - i)
        batches, gates, fired = [], [], []
        for _ in range(n_sub):
            src = next(source_iter)
            do_s2t, alpha = gate.draw()
            fired.append(style_enabled and do_s2t)
            if device_aug is not None:
                batches.append(device_aug.raw_pretrain_batch(
                    src, next(target_iter) if fired[-1] else None))
            else:
                x_s, label_s, weight_s, _meta = src
                image_t_style = None
                if style_enabled:
                    image_t_style = next(target_iter)[4][0] if do_s2t else dummy_style(x_s)
                batches.append(make_source_batch(x_s, label_s, weight_s, image_t_style))
            gates.append((do_s2t, alpha))
        if device_aug is not None:
            if style_enabled:
                if style_tpl is None or not all(fired):
                    style_tpl = _style_template(device_aug, batches, fired, style_tpl)
                for b, f in zip(batches, fired):
                    if not f:
                        b.update(device_aug.style_zeros(style_tpl, b["canvas_s"]))
            batches = _stack_host_leaves(batches)
        data_time.update(time.time() - end[0])

        do_s2t, alphas = zip(*gates)
        if device_aug is not None:
            state, metrics, _ = bundler(state, batches, lr, do_s2t, alphas,
                                        generator=device_aug.generator)
        else:
            state, metrics, _ = bundler(state, batches, lr, do_s2t, alphas)
        readback = _Readback(metrics)
        if pending is not None:
            flush(pending)
        # the host batches stay alive until their bundle is read back
        pending = (i, n_sub, _batch_size(batches[0]), readback, batches)
        i += n_sub
    if pending is not None:
        flush(pending)
    return state


def _batch_size(batch) -> int:
    return len(batch["image_s"] if "image_s" in batch else batch["canvas_s"])


def _style_template(device_aug, batches, fired, known):
    """The zero style inputs' spec (JAX ``_run_pretrain_epoch_bundled``): a
    fired batch's own shapes and dtypes when the bundle has one, else the
    spec already known, else ``pretrain_style_template`` of the first."""
    fired_b = next((b for b, f in zip(batches, fired) if f), None)
    if fired_b is not None:
        return {k: (tuple(fired_b[k].shape), fired_b[k].dtype)
                for k in device_aug.pretrain_style_template(fired_b)}
    return known if known is not None else device_aug.pretrain_style_template(batches[0])


def _run_adapt_epoch_bundled(state, bundler, source_iter, target_iter, lr, args, s2t, t2s,
                             generator, n_bundle, meters, progress, device_aug=None):
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
            batches.append(device_aug.raw_adapt_batch(src, tgt) if device_aug is not None
                           else make_adapt_batch(src, tgt))
            gates.append((*s2t.draw(), *t2s.draw()))
        if device_aug is not None:
            batches = _stack_host_leaves(batches)
        data_time.update(time.time() - end[0])

        do_s2t, alpha_s2t, do_t2s, alpha_t2s = zip(*gates)
        state, metrics, _ = bundler(state, batches, lr, do_s2t, alpha_s2t, do_t2s,
                                    alpha_t2s, generator=generator)
        readback = _Readback(metrics)
        if pending is not None:
            flush(pending)
        pending = (i, n_sub, _batch_size(batches[0]), readback, batches)
        i += n_sub
    if pending is not None:
        flush(pending)
    return state


def _pad_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` with zero rows appended up to ``n`` rows."""
    if len(t) == n:
        return t
    return torch.cat([t, t.new_zeros((n - len(t),) + tuple(t.shape[1:]))])


def run_validate(eval_step, model, val_loader, args, visualize=None):
    """Evaluation loop returning the group PCK (train_human.py:461-500).

    ``eval_step(model, x, label, weight)`` is ``make_eval_step``'s. A
    partial last batch runs as it is (no padding), so the loss and PCK of a
    batch are those of its real rows, as the JAX package's padded and
    rescaled ones are. Under several processes every rank iterates the
    whole loader, pads each batch with zero rows to a multiple of the
    processes (PCK skips them by the GT <= 1 rule, their loss is 0) and
    runs its rows; the eval step reduces the loss and PCK over the ranks,
    and the loss is rescaled to the real rows' mean (JAX
    ``engine.run_validate``). Only rank 0 prints and draws."""
    batch_time = AverageMeter("Time", ":6.3f")
    losses = AverageMeter("Loss", ":.2e")
    acc = AverageMeterList(list(range(val_loader.dataset.num_keypoints)), ":3.2f",
                           ignore_val=-1)
    progress = ProgressMeter(len(val_loader), [batch_time, losses], prefix="Test: ")
    world = dist.process_count()
    pad_to = -(-val_loader.batch_size // world) * world if world > 1 else None
    primary = dist.is_primary()
    end = time.time()
    depth = 3  # batches in flight before the oldest one's readback
    pending = deque()

    def flush(item):
        nonlocal end
        i, n, x, y, loss, acc_per_kpt, meta = item
        loss = float(loss)
        if pad_to and n < pad_to:  # the padded rows' zeros are in the mean
            loss *= pad_to / n
        losses.update(loss, n)
        # float32 values, as the JAX package's meters accumulate them
        acc.update(list(acc_per_kpt.cpu().numpy()), n)
        batch_time.update(time.time() - end)
        end = time.time()
        if i % args.val_print_freq == 0 and primary:
            progress.display(i)
            if visualize is not None:
                pred, _ = get_max_preds_np(y.float().cpu().numpy())
                ratio = args.image_size / args.heatmap_size
                image = np.asarray(x[0])
                visualize(image, pred[0] * ratio, "val_{}_pred.jpg".format(i))
                visualize(image, np.asarray(meta["keypoint2d"])[0],
                          "val_{}_label.jpg".format(i))

    for i, (x, label, weight, meta) in enumerate(val_loader):
        x, label, weight = _f32(x), _f32(label), _f32(weight)
        n = len(x)
        if pad_to:
            rows = dist.local_rows(pad_to)
            x, label, weight = (_pad_rows(t, pad_to)[rows] for t in (x, label, weight))
        y, loss, acc_per_kpt = eval_step(model, x, label, weight)
        pending.append((i, n, x, y, loss, acc_per_kpt, meta))
        if len(pending) >= depth:
            flush(pending.popleft())
    while pending:
        flush(pending.popleft())
    return val_loader.dataset.group_accuracy(acc.average())
