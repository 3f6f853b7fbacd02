"""AdaIN decoder pretraining engine: the twin of
``uda_poseestimation_tpu/adain_engine.py`` (reference adain/train/
train_{human,animal}.py).

Trains only the decoder, with Adam(lr) on the content loss plus the
mean/std style loss (the adain/net.py variant, ``StyleNet("meanstd")``),
the reference's 50/50 content/style swap between the source and target
batches, per-iteration log lines of the same format, side-by-side PNG
dumps every ``log_img_interval`` and decoder checkpoints
(``decoder_<exp>.pth.tar``) every ``save_model_interval``. The reference's
``adjust_learning_rate`` decay exists upstream but is never called, so the
learning rate stays constant.

The VGG encoder is frozen (``requires_grad_(False)``): the style and
content encodes record no autograd graph, and only the stylized image's
re-encode carries a gradient, to the decoder.

Across GPUs (the JAX package's ``_pick_decoder_mesh``, which shards the step
over the local chips of one process) the port runs one process a GPU on
``parallel/distributed.py``: the CLIs take the trainers' ``--dist-*`` flags
(``decoder_process_group``) and ``tools/launch_distributed.py`` starts the
ranks. Every rank builds the same global batch (the same loaders, with
torch's generator seeded 0 under a group) and the same swap draw (the
global numpy stream, seeded 0 by the CLIs and consumed alike on every rank),
takes its ``local_rows`` of the content and style batches, and averages the
gradients before Adam; neither network has BatchNorm and the losses are
batch means, so W ranks compute the one-process step. The logged losses are
the global means; rank 0 starts the decoder (broadcast to the others) and
writes the log, the PNGs (global row 0 is its row 0) and the checkpoint.
The global batch must split evenly over the ranks: otherwise the CLI exits
naming the largest count that does, as JAX picks the largest mesh.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import zlib
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch
from PIL import Image

from .device import DeviceLike, resolve_device
from .models.style_net import StyleNet, VGGEncoder, reset_conv_parameters
from .parallel import distributed as dist
from .utils import trace
from .weights import load_by_key


def load_encoder_params(vgg_path: Optional[str],
                        generator: Optional[torch.Generator] = None) -> Mapping:
    """The VGG encoder's state dict from ``vgg_normalised.pth`` (loaded by
    key; the file may hold the whole vgg_normalised), or, when the file is
    missing, a random encoder with a warning: lecun-normal kernels and zero
    biases from ``generator`` (a ``torch.Generator`` seeded 0 by default).
    The JAX package draws its fallback from ``PRNGKey(0)`` with Flax's
    initializers; torch's generator gives other values from the same
    distributions."""
    encoder = VGGEncoder()
    if vgg_path and os.path.exists(vgg_path):
        return load_by_key(encoder, vgg_path).state_dict()
    print(f"WARNING: vgg weights not found at {vgg_path!r}; "
          "using randomly-initialized encoder (style losses will be meaningless)")
    reset_conv_parameters(encoder, generator or torch.Generator().manual_seed(0))
    return encoder.state_dict()


def make_decoder_step(style_net: StyleNet, content_weight: float, style_weight: float,
                      lr: float, optimizer: Optional[torch.optim.Optimizer] = None):
    """The decoder-training step (adain/train/train_human.py:208-215) on
    ``style_net``'s device: ``loss = content_weight * loss_c + style_weight
    * loss_s``, backward into the decoder, one optimizer step.

    ``optimizer`` defaults to ``torch.optim.Adam(decoder, lr)``, whose
    defaults are ``optax.adam``'s; tests inject SGD, as the JAX package's
    ``tx=`` does. Freezes the encoder. Returns ``(step, optimizer)``;
    ``step(content, style)`` takes NCHW batches and returns ``loss``,
    ``loss_c``, ``loss_s`` (0-d) and ``g_t`` as device tensors, without a
    sync. Under a process group each rank passes its rows of the global
    batch: the gradients are averaged over the ranks before the update, and
    the losses returned are the global batch's (``g_t`` stays the rank's)."""
    style_net.encoder.requires_grad_(False)
    params = list(style_net.decoder.parameters())
    if optimizer is None:
        optimizer = torch.optim.Adam(params, lr=lr)

    def step(content, style):
        loss_c, loss_s, g_t = style_net(content, style)
        loss_c = content_weight * loss_c
        loss_s = style_weight * loss_s
        loss = loss_c + loss_s
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        losses = torch.stack([loss, loss_c, loss_s]).detach()
        if dist.is_active():
            dist.all_reduce_mean_([p.grad for p in params] + [losses])
        optimizer.step()
        return (*losses.unbind(), g_t.detach())

    return step, optimizer


def save_side_by_side(path, g_t, content, style_img, denormalize):
    """(stylized | content | style) along the width, as save_image writes
    them: each HWC image through ``clip(denormalize(x), 0, 1)``, then
    ``(im * 255).astype(uint8)``, a truncation."""
    ims = [np.clip(denormalize(np.asarray(x)), 0, 1) for x in (g_t, content, style_img)]
    Image.fromarray((np.concatenate(ims, axis=1) * 255).astype(np.uint8)).save(path)


def decoder_group_size(batch_size: int, world: int) -> int:
    """The largest process count up to ``world`` that divides the decoder's
    global batch (JAX ``_pick_decoder_mesh``'s rule)."""
    return max(n for n in range(1, world + 1) if batch_size % n == 0)


@contextlib.contextmanager
def decoder_process_group(args, batch_size: int):
    """The decoder CLIs' ``--dist-*`` wiring: join the group of
    ``--dist-coordinator`` (``distributed.maybe_initialize_from_args``),
    after checking that the global ``batch_size`` splits over
    ``--dist-num-processes`` (else ``SystemExit`` naming the largest count
    that does), seed torch's generator 0 under a group (every rank's loaders
    then build the same batches) and yield the rank's device, the card
    unless ``--device cpu``; the group is left at the end."""
    world = args.dist_num_processes
    if args.dist_coordinator and batch_size % world:
        raise SystemExit(
            f"decoder training: the global batch of {batch_size} does not split over "
            f"{world} processes; run at most {decoder_group_size(batch_size, world)}")
    # the CLIs seed numpy with 0 and take no --seed: 0 is their seed
    multiproc = dist.maybe_initialize_from_args(
        argparse.Namespace(**dict(vars(args), batch_size=batch_size, seed=0)))
    try:
        device = resolve_device(args.device)
        if multiproc:
            device = dist.rank_device(dist.process_index(), device)
            torch.manual_seed(0)
        yield device
        dist.barrier("end")  # no rank leaves while another still runs
    finally:
        dist.shutdown()


def _check_same_draws(draws):
    """Under several processes, raise unless every rank drew the same swaps
    (they come from each rank's own numpy stream)."""
    if not dist.is_multiprocess():
        return
    code = float(zlib.crc32(bytes(bytearray(draws))))
    spread = torch.tensor([code, -code], dtype=torch.float64, device=dist._comm_device())
    torch.distributed.all_reduce(spread, op=torch.distributed.ReduceOp.MAX)
    if float(spread[0]) != -float(spread[1]):
        raise RuntimeError("the ranks drew different content/style swaps")


def run_decoder_training(args, source_iter, target_iter, denormalize,
                         get_target_view=lambda tgt: tgt[4][0],
                         get_source_image=lambda src: src[0],
                         decoder_state: Optional[Mapping] = None,
                         device: DeviceLike = None):
    """The reference's training loop (adain/train/train_human.py:191-235).

    The iterators give NHWC float32 batches (the loaders' layout) through
    ``get_source_image`` and ``get_target_view``. Writes under
    ``logs/<exp_name>/``: the log ``log_<exp>.txt`` (truncated at start),
    ``save_imgs/save_img_<exp>/<iter>.png`` and
    ``<save_model_dir>/decoder_<exp>.pth.tar``. The decoder starts from
    ``decoder_state`` (a decoder state dict), else from the lecun-normal
    init of a generator seeded 0. Runs on ``device``, the card by default.
    Under a process group (module docstring) each rank runs its rows of
    every batch and rank 0 alone writes files.
    """
    device = resolve_device(device)
    primary = dist.is_primary()
    exp_name = args.exp_name
    log_root = "logs/" + exp_name
    save_model_dir = Path(os.path.join(log_root, args.save_model_dir))
    fname = os.path.join(log_root, "log_" + exp_name + ".txt")
    out = os.path.join(log_root, "save_imgs/save_img_" + exp_name + "/")
    if primary:
        save_model_dir.mkdir(exist_ok=True, parents=True)
        os.makedirs(out, exist_ok=True)
        open(fname, "w").close()

    style = StyleNet(style_loss_kind="meanstd")
    style.encoder.load_state_dict(load_encoder_params(
        getattr(args, "vgg_resolved", None) or args.vgg))
    if decoder_state is None:
        reset_conv_parameters(style.decoder, torch.Generator().manual_seed(0))
    else:
        style.decoder.load_state_dict(decoder_state)
    style.to(device)
    dist.broadcast_modules(style.decoder)  # rank 0's start under a group
    step, _ = make_decoder_step(style, args.content_weight, args.style_weight, args.lr)
    if dist.is_multiprocess() and primary:
        print(f"decoder training sharded over {dist.process_count()} devices")

    # one-deep pipeline, as the JAX engine's: iteration i's losses (and
    # g_t's first image when a PNG is due) are copied to the host behind
    # step i, and read only after step i+1 is launched, waiting for step i
    # alone; the host's batch fetch and log write overlap the device's step.
    # The log lines and PNGs are the same, written one iteration later
    def flush(item):
        j, losses, image, done, content0, style0 = item
        if done is not None:
            with trace.span("decoder.readback"):
                done.synchronize()
        with trace.span("decoder.log"):
            loss, loss_c, loss_s = (float(x) for x in losses)
            if not primary:
                return
            with open(fname, "a") as f:
                f.write("iter: " + str(j) + ", decoder_loss: " + str(loss)
                        + ", content loss: " + str(loss_c)
                        + ", style loss: " + str(loss_s) + "\n")
            if image is not None:
                save_side_by_side(out + str(j) + ".png", image, content0, style0, denormalize)

    pending = None
    swaps = []
    for i in range(args.max_iter):
        with trace.span("decoder.fetch"):
            source_image = torch.as_tensor(get_source_image(next(source_iter)),
                                           dtype=torch.float32)
            target_image = torch.as_tensor(get_target_view(next(target_iter)),
                                           dtype=torch.float32)
            # the swap draws from the global numpy stream of this process (of
            # every rank alike under a group)
            swaps.append(np.random.rand() > 0.5)
            if swaps[-1]:
                content_images, style_images = source_image, target_image
            else:
                content_images, style_images = target_image, source_image
            rows = dist.local_rows(len(content_images)) if dist.is_active() else slice(None)
            content_d, style_d = (x[rows].to(device, non_blocking=True).permute(0, 3, 1, 2)
                                  .contiguous() for x in (content_images, style_images))
        with trace.span("decoder.step"):
            losses_d = step(content_d, style_d)
            losses = [x.to("cpu", non_blocking=True) for x in losses_d[:3]]
            image = (losses_d[3][0].to("cpu", non_blocking=True).permute(1, 2, 0)
                     if i % args.log_img_interval == 0 else None)
            done = None
            if device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
        if pending is not None:
            flush(pending)
        pending = (i, losses, image, done, content_images[0].numpy(), style_images[0].numpy())
        if primary and ((i + 1) % args.save_model_interval == 0 or (i + 1) == args.max_iter):
            # the reference's decoder file (adain/train/train_human.py:228-232):
            # the raw Sequential-index state dict, float32 CPU tensors
            with trace.span("decoder.save"):
                torch.save({k: v.float().cpu() for k, v in style.decoder.state_dict().items()},
                           os.path.join(save_model_dir, "decoder_" + exp_name + ".pth.tar"))
    if pending is not None:
        flush(pending)
    _check_same_draws(swaps)
