"""Human-body and hand UDA trainer of the port (``python -m
uda_poseestimation_torch.train_human``).

The twin of the repository's ``train_human.py`` (the JAX package's trainer,
itself the reference's CLI): the same flags and defaults, including the
ignored legacy ``--lambda_t``, the same log lines, checkpoint names
(``best_pt`` / ``best``) and dict layout, and the same phases: source-only
pretraining for ``--pretrain-epoch`` epochs, then mean-teacher adaptation
from the best pretrained student. It runs the port's steps on one device,
the CUDA card unless ``--device`` asks for another (``--device cpu``).

``--steps-per-dispatch n`` runs n iterations per bundler call in both
phases (``AdaptStepBundler``, ``PretrainStepBundler``): CUDA-graph replays of
the step on the card, the same step run eagerly on the CPU; the first step
of each style-gate case in an epoch runs eagerly on the card too.

``--device-aug`` moves every random view onto the device: the loaders give
uint8 canvases (Resize, ToUint8Canvas) and ``engine.DeviceAugPipeline``
draws and renders the views inside the steps (and their CUDA graphs), with
the JAX package's deviation note (``ops/device_aug.py``). ``--decode-cache
G`` then caches the training sets' decoded canvases, G GB shared by all
loader workers (``data/loader.py::CachedDataset``); without
``--device-aug`` it is ignored, as in JAX.

``--dist-coordinator``, ``--dist-num-processes`` and ``--dist-process-id``
run one process a GPU (NCCL; gloo with ``--device cpu``) as one data-parallel
run over the global batch ``-b`` (``parallel/distributed.py``): each rank
loads its share through a ``PartitionSampler``, its host streams seeded
with ``--seed + rank * 10007``; only rank 0 writes the log, the images and
the checkpoints, and every rank waits for ``best_pt`` before the
pretrain->adapt reload. ``python -m
uda_poseestimation_torch.tools.launch_distributed -n N -- <command>`` starts
N ranks on one host. Without ``--dist-coordinator`` the flags change
nothing. Datasets: every human dataset of the JAX registry
(``data/__init__.py``), so the four ``train_human.py`` lines of ``script``
(f2r, s2h, s2l, r2h) run.

Model weights start from ``create_state(..., seed=--seed)``: the JAX
package's initializers and distributions, drawn from torch's generator, so
the values differ from a JAX run with the same seed.

``run_training`` (models, style net, steps, bundlers, restores and the
epoch loop) is shared with the animal trainers (``train_animal.py``), which
bring their own datasets, normalization and validation.
"""

from __future__ import annotations

import argparse
import random
import time
import warnings
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset

from . import data as datasets
from . import models
from .data import ForeverDataIterator, make_loader
from .data import transforms as T
from .data.loader import CachedDataset, PartitionSampler
from .device import resolve_device
from .engine import DeviceAugPipeline, run_adapt_epoch, run_pretrain_epoch, run_validate
from .models import StyleNet
from .ops.device_aug import DeviceAugConfig
from .parallel import AdaptStepBundler, PretrainStepBundler, StepConfig, create_state, \
    make_adapt_step, make_eval_step, make_pretrain_step
from .parallel import distributed as dist
from .utils import CompleteLogger, multistep_lr
from .utils.checkpoint import load_checkpoint, restore_train_state, save_checkpoint
from .weights import load_style_net_files

# styled-image clamp: normalized [0,1] bounds under ImageNet normalization
# (reference train_human.py:32-33)
RECOVER_MIN = (-2.1179, -2.0357, -1.8044)
RECOVER_MAX = (2.2489, 2.4285, 2.64)
IMAGENET_MEAN = [0.485, 0.456, 0.406]
IMAGENET_STD = [0.229, 0.224, 0.225]
VGG_PATH = "saved_models/vgg_normalised.pth"


def build_transforms(args):
    normalize = T.Normalize(IMAGENET_MEAN, IMAGENET_STD)
    src_train_transform = T.Compose([
        T.RandomResizedCrop(size=args.image_size, scale=args.resize_scale),
        T.RandomAffineRotation(args.rotation_stu, args.shear_stu,
                               args.translate_stu, args.scale_stu),
        T.ColorJitter(brightness=args.color_stu, contrast=args.color_stu,
                      saturation=args.color_stu),
        T.GaussianBlur(high=args.blur_stu),
        T.ToTensor(),
        normalize,
    ])
    base_transform = T.Compose([
        T.RandomResizedCrop(size=args.image_size, scale=args.resize_scale),
    ])
    tgt_train_transform_stu = T.Compose([
        T.RandomAffineRotation(args.rotation_stu, args.shear_stu,
                               args.translate_stu, args.scale_stu),
        T.ColorJitter(brightness=args.color_stu, contrast=args.color_stu,
                      saturation=args.color_stu),
        T.GaussianBlur(high=args.blur_stu),
        T.ToTensor(),
        normalize,
    ])
    tgt_train_transform_tea = T.Compose([
        T.RandomAffineRotation(args.rotation_tea, args.shear_tea,
                               args.translate_tea, args.scale_tea),
        T.ColorJitter(brightness=args.color_tea, contrast=args.color_tea,
                      saturation=args.color_tea),
        T.GaussianBlur(high=args.blur_tea),
        T.ToTensor(),
        normalize,
    ])
    val_transform = T.Compose([T.Resize(args.image_size), T.ToTensor(), normalize])
    return src_train_transform, base_transform, tgt_train_transform_stu, \
        tgt_train_transform_tea, val_transform


def raw_canvas_transforms(args):
    """``--device-aug``'s host transforms: decode and resize only, into
    uint8 canvases; the views are drawn on the device. Returns the source,
    base, student and teacher transforms."""
    raw_view = T.Compose([T.IdentityAffine(), T.ToUint8Canvas()])
    return (T.Compose([T.Resize(args.image_size), T.ToUint8Canvas()]),
            T.Compose([T.Resize(args.image_size)]), raw_view, raw_view)


def device_aug_configs(args):
    """The source, student and teacher ``DeviceAugConfig`` of the CLI's
    flags (the JAX trainer's)."""
    common = dict(image_size=args.image_size, heatmap_size=args.heatmap_size,
                  sigma=args.sigma)
    src = DeviceAugConfig(resize_scale=tuple(args.resize_scale), rotation=args.rotation_stu,
                          shear=tuple(args.shear_stu), translate=tuple(args.translate_stu),
                          scale=tuple(args.scale_stu), color=args.color_stu,
                          blur=args.blur_stu, use_rrc=True, **common)
    stu = DeviceAugConfig(rotation=args.rotation_stu, shear=tuple(args.shear_stu),
                          translate=tuple(args.translate_stu), scale=tuple(args.scale_stu),
                          color=args.color_stu, blur=args.blur_stu, use_rrc=False, **common)
    tea = DeviceAugConfig(rotation=args.rotation_tea, shear=tuple(args.shear_tea),
                          translate=tuple(args.translate_tea), scale=tuple(args.scale_tea),
                          color=args.color_tea, blur=args.blur_tea, use_rrc=False, **common)
    return src, stu, tea


class Data(NamedTuple):
    """The source training set (its keypoint count sizes the model) and the
    four loaders of a run."""
    train_source_dataset: Dataset
    train_source_loader: DataLoader
    val_source_loader: DataLoader
    train_target_loader: DataLoader
    val_target_loader: DataLoader


def build_data(args, pin: bool) -> Data:
    """The datasets of ``-s``, ``--target-train`` and ``-t`` under their
    roots, and their loaders, built in the JAX trainer's order (the
    constructors that reseed the global ``random`` stream do so in the same
    order). ``pin`` page-locks the batches (a CUDA run)."""
    (src_train_transform, base_transform, tgt_train_transform_stu,
     tgt_train_transform_tea, val_transform) = build_transforms(args)
    if args.device_aug:
        (src_train_transform, base_transform, tgt_train_transform_stu,
         tgt_train_transform_tea) = raw_canvas_transforms(args)
    image_size = (args.image_size, args.image_size)
    heatmap_size = (args.heatmap_size, args.heatmap_size)

    def maybe_cache(ds):
        # only the raw-canvas datasets: their transforms draw nothing
        if args.device_aug and args.decode_cache > 0:
            return CachedDataset(ds, max_bytes=args.decode_cache * 1e9)
        return ds

    source_dataset = datasets.__dict__[args.source]
    train_source_dataset = maybe_cache(source_dataset(
        root=args.source_root, transforms=src_train_transform,
        image_size=image_size, heatmap_size=heatmap_size))
    train_source_loader = train_loader(train_source_dataset, args, pin, target=False)
    val_source_dataset = source_dataset(root=args.source_root, split="test",
                                        transforms=val_transform,
                                        image_size=image_size, heatmap_size=heatmap_size)
    val_source_loader = make_loader(val_source_dataset, args.test_batch, pin_memory=pin)

    target_dataset = datasets.__dict__[args.target_train]
    train_target_dataset = maybe_cache(target_dataset(
        root=args.target_root, transforms_base=base_transform,
        transforms_stu=tgt_train_transform_stu, transforms_tea=tgt_train_transform_tea,
        k=args.k, image_size=image_size, heatmap_size=heatmap_size))
    train_target_loader = train_loader(train_target_dataset, args, pin, target=True)
    target_dataset = datasets.__dict__[args.target]
    val_target_dataset = target_dataset(root=args.target_root, split="test",
                                        transforms=val_transform,
                                        image_size=image_size, heatmap_size=heatmap_size)
    val_target_loader = make_loader(val_target_dataset, args.test_batch, pin_memory=pin)
    return Data(train_source_dataset, train_source_loader, val_source_loader,
                train_target_loader, val_target_loader)


def train_loader(dataset, args, pin: bool, target: bool) -> DataLoader:
    """A training set's loader: shuffled whole batches of ``-b``; under
    several processes the rank's share of each global batch, from a
    ``PartitionSampler`` seeded with ``--seed`` (the target's with ``--seed +
    7919``, so that equal-length sets do not pair the same samples every
    pass; JAX ``train_human.py``)."""
    kwargs = dict(num_workers=args.workers, drop_last=True, pin_memory=pin)
    if not dist.is_multiprocess():
        return make_loader(dataset, args.batch_size, shuffle=True, **kwargs)
    sampler = PartitionSampler(len(dataset), dist.process_index(), dist.process_count(),
                               args.seed + (7919 if target else 0))
    return make_loader(dataset, dist.local_batch_size(args.batch_size), sampler=sampler,
                       **kwargs)


def run_main(args: argparse.Namespace, train, logger_cls):
    """A trainer's ``main``: join the process group of ``--dist-*`` (before
    the first CUDA use), pick the device (the rank's GPU under a group), open
    the ``logger_cls`` logger (under a group with rank 0's timestamp on every
    rank, and files on rank 0 only) and run ``train(args, device, logger)``;
    the group is left at the end."""
    multiproc = dist.maybe_initialize_from_args(args)
    try:
        device = resolve_device(args.device)
        stamp = {}
        if multiproc:
            device = dist.rank_device(dist.process_index(), device)
            stamp["now"] = dist.broadcast_str(time.strftime("%Y-%m-%d-%H_%M_%S",
                                                            time.localtime(time.time())))
        logger = logger_cls(args.log + "_" + args.arch, args.phase,
                            file_output=dist.is_primary(), **stamp)
        try:
            train(args, device, logger)
        finally:
            logger.close()
        dist.barrier("end")  # no rank leaves while another still runs
    finally:
        dist.shutdown()


def main(args: argparse.Namespace):
    run_main(args, _train, CompleteLogger)


def _host_seed(args) -> int:
    return args.seed + dist.process_index() * 10007


def seed_host_streams(args, logger):
    """Log the flags; with ``--seed``, seed ``random``, numpy and torch (the
    loaders' shuffles and worker seeds), with ``--seed + rank * 10007``
    under a process group, so that the ranks' per-sample augmentation
    differs (the control draws come from ``distributed.control_rng``)."""
    logger.write(" ".join(f"{k}={v}" for k, v in vars(args).items()))
    if args.seed is not None:
        random.seed(_host_seed(args))
        np.random.seed(_host_seed(args))
        torch.manual_seed(_host_seed(args))
        warnings.warn("You have chosen to seed training.")


def reseed_after_splits(args):
    """Under several processes, seed ``random`` and numpy again after the
    datasets are built: some split constructors seed ``random`` with a
    constant (JAX ``train_human.py``)."""
    if dist.is_multiprocess() and args.seed is not None:
        random.seed(_host_seed(args))
        np.random.seed(_host_seed(args))


class Validation(NamedTuple):
    """One validation's group PCK: the source's, the target's and, for the
    animal trainers, each category's (name, groups)."""
    source: dict
    target: dict
    categories: tuple = ()


def _train(args, device, logger):
    seed_host_streams(args, logger)
    data = build_data(args, pin=device.type == "cuda")
    logger.write("Source train: {}".format(len(data.train_source_loader)))
    logger.write("Target train: {}".format(len(data.train_target_loader)))
    logger.write("Source test: {}".format(len(data.val_source_loader)))
    logger.write("Target test: {}".format(len(data.val_target_loader)))
    reseed_after_splits(args)

    device_aug = None
    if args.device_aug:
        if args.color_stu or args.color_tea:
            warnings.warn(
                "--device-aug applies ColorJitter in a fixed brightness->"
                "contrast->saturation order (the host/reference path shuffles "
                "the order per sample); factor distributions are identical")
        if args.blur_stu or args.blur_tea:
            warnings.warn(
                "--device-aug uses an exact truncated Gaussian for blur "
                "(PIL approximates it with three box blurs); radius draw "
                "distribution is identical")
        device_aug = DeviceAugPipeline(*device_aug_configs(args), k=args.k,
                                       mean=IMAGENET_MEAN, std=IMAGENET_STD,
                                       seed=args.seed if args.seed is not None else 0,
                                       device=device)

    def validate(eval_step, model, visualize):
        return Validation(run_validate(eval_step, model, data.val_source_loader, args),
                          run_validate(eval_step, model, data.val_target_loader, args,
                                       visualize=visualize))

    def report(epoch, acc, best_acc):
        if epoch is None:  # --phase test
            logger.write("Source: {:4.3f} Target: {:4.3f}".format(
                acc.source["all"], acc.target["all"]))
        else:
            logger.write("Epoch: {} Source: {:4.3f} Target: {:4.3f} Target(best): {:4.3f}"
                         .format(epoch, acc.source["all"], acc.target["all"], best_acc))
        for name, value in acc.target.items():
            logger.write("{}: {:4.3f}".format(name, value))

    run_training(args, device, logger, data.train_source_dataset,
                 ForeverDataIterator(data.train_source_loader),
                 ForeverDataIterator(data.train_target_loader),
                 recover=(RECOVER_MIN, RECOVER_MAX),
                 denormalize=lambda image: image * np.asarray(IMAGENET_STD)
                 + np.asarray(IMAGENET_MEAN),
                 validate=validate, report=report, device_aug=device_aug)


def run_training(args, device, logger, train_source_dataset, train_source_iter,
                 train_target_iter, recover, denormalize, validate, report,
                 device_aug=None):
    """What every trainer of the port shares, after its data: the steps'
    ``StepConfig`` (bf16 models, bf16 styled images and the bf16-rounding
    occlusion gather, as the JAX trainers configure them, with the styled
    image clamped to ``recover`` = (min, max)), the student and teacher
    (``--arch`` with the source's keypoint count, from ``--seed``), the
    style net of ``--decoder-name``, the steps and the bundlers of
    ``--steps-per-dispatch``, ``--resume`` / ``--pretrain``, and the epoch
    loop: pretraining for ``--pretrain-epoch`` epochs, then adaptation from
    the best pretrained student (``best_pt``), a validation after each
    epoch, and ``best_pt`` / ``best`` written when the target's PCK beats
    the best so far. ``--phase test`` validates the teacher once.

    ``denormalize(image)`` maps a normalized HWC image back to [0, 1] for
    ``--debug``'s images; ``validate(eval_step, model, visualize)`` returns
    a ``Validation``; ``report(epoch, validation, best)`` writes its lines
    (``epoch`` None for ``--phase test``); ``device_aug`` is a
    ``DeviceAugPipeline`` or an ``AnimalDeviceAugPipeline``
    (``--device-aug``), whose views the pretrain phase takes only when its
    ``source_on_device``."""
    cfg = StepConfig(image_size=args.image_size, heatmap_size=args.heatmap_size,
                     sigma=args.sigma, k=args.k, lambda_c=args.lambda_c,
                     teacher_alpha=args.teacher_alpha, mask_ratio=args.mask_ratio,
                     occlude_rate=args.occlude_rate, occlude_thresh=args.occlude_thresh,
                     occlude_size=args.occlude_size,
                     recover_min=recover[0], recover_max=recover[1],
                     use_sgd=args.SGD, finetune=args.finetune,
                     gather_exact=False, style_io_dtype="bfloat16")
    model = models.__dict__[args.arch](num_keypoints=train_source_dataset.num_keypoints,
                                       dtype=torch.bfloat16)
    state = create_state(model, cfg, seed=args.seed if args.seed is not None else 0,
                         device=device)

    style_model = None
    if args.decoder_name is not None:
        style_model = load_style_net_files(StyleNet(), VGG_PATH, args.decoder_name)
        style_model.to(device=device, dtype=torch.bfloat16)  # frozen: bf16 storage

    # the pretrain phase takes raw batches only where the source's views are
    # built on the device (not so for an animal source without a raw mode)
    pretrain_aug = device_aug if device_aug is not None and device_aug.source_on_device \
        else None
    views = {"adapt": None if device_aug is None else device_aug.view_builder,
             "pretrain": None if pretrain_aug is None
             else pretrain_aug.pretrain_view_builder(style_model is not None)}

    # the unbundled pretrain loop builds its views itself (as JAX's does)
    pretrain_step = make_pretrain_step(cfg, style_model=style_model, device=device)
    adapt_step = make_adapt_step(cfg, style_model=style_model, device=device,
                                 view_builder=views["adapt"])
    eval_step = make_eval_step(device=device)
    bundlers = {}
    if args.steps_per_dispatch > 1:
        bundlers = {"pretrain": PretrainStepBundler(cfg, style_model=style_model, device=device,
                                                    view_builder=views["pretrain"]),
                    "adapt": AdaptStepBundler(cfg, style_model=style_model, device=device,
                                              view_builder=views["adapt"])}
        if args.debug:
            warnings.warn("--steps-per-dispatch: --debug prediction images "
                          "are skipped during bundled epochs")

    def restore(checkpoint, **kwargs):
        restore_train_state(state, checkpoint, **kwargs)
        dist.broadcast_modules(state.student, state.teacher)  # rank 0's
        for bundler in bundlers.values():  # their graphs hold the old tensors
            bundler.reset()

    start_epoch = 0
    if args.resume:
        checkpoint = load_checkpoint(args.resume)
        restore(checkpoint, load_optimizer=True, log=logger.write)
        start_epoch = int(checkpoint.get("epoch", -1)) + 1
    elif args.pretrain:
        restore(load_checkpoint(args.pretrain), teacher_source="student")

    def visualize(image, keypoint2d, name):
        image = np.asarray(image)
        if image.dtype == np.uint8:  # --device-aug raw canvases (JAX denormalizes them too)
            image = image.astype(np.float32) / 255.0
        img_u8 = np.clip(denormalize(image) * 255.0, 0, 255).astype(np.uint8)
        train_source_dataset.visualize(img_u8, keypoint2d,
                                       logger.get_image_path("{}.jpg".format(name)))

    if not dist.is_primary():
        visualize = None  # rank 0 draws the images

    if args.phase == "test":
        report(None, validate(eval_step, state.teacher, visualize), None)
        return

    best_acc = 0
    for epoch in range(start_epoch, args.epochs):
        logger.set_epoch(epoch)
        lr = multistep_lr(args.lr, epoch, args.lr_step, args.lr_factor)

        if epoch < args.pretrain_epoch:
            state = run_pretrain_epoch(
                state, pretrain_step, train_source_iter, train_target_iter, epoch, lr,
                args, visualize if args.debug else None,
                style_enabled=style_model is not None, bundler=bundlers.get("pretrain"),
                device_aug=pretrain_aug)
        else:
            if epoch == args.pretrain_epoch:
                dist.barrier("best_pt")  # rank 0 has written it
                restore(load_checkpoint(logger.get_checkpoint_path("best_pt")),
                        teacher_source="student")
            state = run_adapt_epoch(
                state, adapt_step, train_source_iter, train_target_iter, epoch, lr, args,
                visualize if args.debug else None,
                style_enabled=style_model is not None, bundler=bundlers.get("adapt"),
                device_aug=device_aug)

        eval_model = state.student if epoch < args.pretrain_epoch else state.teacher
        acc = validate(eval_step, eval_model, visualize if args.debug else None)

        if acc.target["all"] > best_acc:
            if dist.is_primary():  # the validation is the same on every rank
                save_checkpoint(
                    logger.get_checkpoint_path(
                        "best_pt" if epoch < args.pretrain_epoch else "best"),
                    {"student": state.student, "teacher": state.teacher,
                     "stu_optimizer": state.optimizer,
                     "lr_scheduler": {"epoch": epoch, "milestones": list(args.lr_step),
                                      "gamma": args.lr_factor},
                     "epoch": epoch,
                     "args": args})
            best_acc = acc.target["all"]
        report(epoch, acc, best_acc)


# --arch's choices: the registry's lowercase callables, by the JAX CLI's rule
# (a stub or a headless backbone among them raises or fails when built, as
# in JAX)
ARCHITECTURES = tuple(name for name in models.__dict__
                      if name.islower() and not name.startswith("__")
                      and callable(models.__dict__[name]))


def build_parser():
    architecture_names = sorted(ARCHITECTURES)

    parser = argparse.ArgumentParser(
        description="Source Only for Keypoint Detection Domain Adaptation")
    parser.add_argument("source_root", help="root path of the source dataset")
    parser.add_argument("target_root", help="root path of the target dataset")
    parser.add_argument("-s", "--source", help="source domain(s)")
    parser.add_argument("-t", "--target", help="target domain(s)")
    parser.add_argument("--target-train", help="target domain(s)")
    parser.add_argument("--resize-scale", nargs="+", type=float, default=(0.6, 1.3),
                        help="scale range for the RandomResizeCrop augmentation")
    parser.add_argument("--image-size", type=int, default=256, help="input image size")
    parser.add_argument("--heatmap-size", type=int, default=64, help="output heatmap size")
    parser.add_argument("--sigma", type=int, default=2, help="")
    parser.add_argument("--k", type=int, default=1, help="")

    parser.add_argument("--rotation_stu", type=int, default=180,
                        help="rotation range of the RandomRotation augmentation")
    parser.add_argument("--color_stu", type=float, default=0.25,
                        help="color range of the jitter augmentation")
    parser.add_argument("--blur_stu", type=float, default=0,
                        help="blur range of the jitter augmentation")
    parser.add_argument("--shear_stu", nargs="+", type=float, default=(-30, 30),
                        help="shear range for the RandomResizeCrop augmentation")
    parser.add_argument("--translate_stu", nargs="+", type=float, default=(0.05, 0.05),
                        help="tranlate range for the RandomResizeCrop augmentation")
    parser.add_argument("--scale_stu", nargs="+", type=float, default=(0.6, 1.3),
                        help="scale range for the RandomResizeCrop augmentation")
    parser.add_argument("--rotation_tea", type=int, default=180,
                        help="rotation range of the RandomRotation augmentation")
    parser.add_argument("--color_tea", type=float, default=0.25,
                        help="color range of the jitter augmentation")
    parser.add_argument("--blur_tea", type=float, default=0,
                        help="blur range of the jitter augmentation")
    parser.add_argument("--shear_tea", nargs="+", type=float, default=(-30, 30),
                        help="shear range for the RandomResizeCrop augmentation")
    parser.add_argument("--translate_tea", nargs="+", type=float, default=(0.05, 0.05),
                        help="tranlate range for the RandomResizeCrop augmentation")
    parser.add_argument("--scale_tea", nargs="+", type=float, default=(0.6, 1.3),
                        help="scale range for the RandomResizeCrop augmentation")
    parser.add_argument("--s2t-freq", type=float, default=0.5)
    parser.add_argument("--s2t-alpha", nargs="+", type=float, default=(0, 1))
    parser.add_argument("--t2s-freq", type=float, default=0.5)
    parser.add_argument("--t2s-alpha", nargs="+", type=float, default=(0, 1))

    parser.add_argument("-a", "--arch", metavar="ARCH", default="pose_resnet101",
                        choices=architecture_names,
                        help="backbone architecture: " + " | ".join(architecture_names)
                             + " (default: pose_resnet101)")
    parser.add_argument("--resume", type=str, default=None,
                        help="where restore model parameters from.")
    parser.add_argument("--pretrain", type=str, default=None,
                        help="where restore model parameters from.")
    parser.add_argument("--decoder-name", type=str, default=None,
                        help="where restore style_net model parameters from.")

    parser.add_argument("-b", "--batch-size", default=16, type=int, metavar="N",
                        help="mini-batch size (default: 32)")
    parser.add_argument("--test-batch", default=32, type=int, metavar="N",
                        help="mini-batch size (default: 32)")
    parser.add_argument("--lr", "--learning-rate", default=0.0001, type=float,
                        metavar="LR", help="initial learning rate", dest="lr")
    parser.add_argument("--lambda_c", default=1.0, type=float)
    # legacy flag from the reference README (never parsed upstream) — ignored
    parser.add_argument("--lambda_t", default=0.0, type=float,
                        help="ignored legacy flag kept for command-line parity")
    parser.add_argument("--teacher_alpha", default=0.999, type=float)
    parser.add_argument("--lr-step", default=[45, 60], type=tuple,
                        help="parameter for lr scheduler")
    parser.add_argument("--lr-factor", default=0.1, type=float,
                        help="parameter for lr scheduler")
    parser.add_argument("-j", "--workers", default=1, type=int, metavar="N",
                        help="number of data loading workers (default: 2)")
    parser.add_argument("--epochs", default=70, type=int, metavar="N",
                        help="number of total epochs to run")
    parser.add_argument("-i", "--iters-per-epoch", default=500, type=int,
                        help="Number of iterations per epoch")
    parser.add_argument("-p", "--print-freq", default=100, type=int, metavar="N",
                        help="print frequency (default: 100)")
    parser.add_argument("--val-print-freq", default=2000, type=int, metavar="N",
                        help="print frequency (default: 100)")
    parser.add_argument("--seed", default=None, type=int,
                        help="seed for initializing training. ")
    parser.add_argument("--log", type=str, default="src_only",
                        help="Where to save logs, checkpoints and debugging images.")
    parser.add_argument("--phase", type=str, default="train", choices=["train", "test"],
                        help="When phase is 'test', only test the model.")
    parser.add_argument("--debug", action="store_true",
                        help="In the debug mode, save images and predictions")
    parser.add_argument("--mask-ratio", type=float, default=0.5, help="")
    parser.add_argument("--SGD", action="store_true", help="")
    parser.add_argument("--finetune", action="store_true",
                        help="0.1x learning rate on the backbone (the reference's\n"
                             "get_parameters finetune param groups)")
    parser.add_argument("--pretrain-epoch", type=int, default=-1, help="pretrain-epoch")
    parser.add_argument("--occlude-rate", type=float, default=0.5)
    parser.add_argument("--occlude-thresh", type=float, default=0.9, help="")
    parser.add_argument("--occlude-size", type=int, default=10, help="")
    parser.add_argument("--device-aug", action="store_true",
                        help="generate the augmented views on the device (host only "
                             "decodes and resizes)")
    parser.add_argument("--decode-cache", type=float, default=0.0,
                        help="GB of decoded-canvas cache shared by the loader workers "
                             "(with --device-aug); 0 disables")
    parser.add_argument("--steps-per-dispatch", type=int, default=1,
                        help="iterations per bundler call (CUDA-graph replays on "
                             "the card); 1 disables")
    parser.add_argument("--dist-coordinator", type=str, default=None,
                        help="host:port of process 0 (or a file:// URL): multi-process "
                             "data parallelism, one process a GPU, each loading "
                             "batch-size/num-processes samples; process 0 writes the "
                             "logs and checkpoints (shared filesystem)")
    parser.add_argument("--dist-num-processes", type=int, default=1,
                        help="total process count (with --dist-coordinator)")
    parser.add_argument("--dist-process-id", type=int, default=0,
                        help="this process's rank (with --dist-coordinator)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device to run on (default: the CUDA card; "
                             "'cpu' runs on the CPU)")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
