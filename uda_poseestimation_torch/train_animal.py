"""Animal UDA trainer of the port, synthetic animals to TigDog (``python -m
uda_poseestimation_torch.train_animal``).

The twin of the repository's ``train_animal.py`` (the JAX package's trainer,
itself the reference's CLI): the same flags and defaults, the ``--lr-step
type=tuple`` quirk, ``--test-batch 1`` and the ignored ``--lambda_t``
included, plus ``--device`` (the card unless ``--device cpu`` is given).
The datasets are built from the flags (``**vars(args)``), normalized by
their own mean files (mean only); the styled images are clamped to the
bounds of [0, 1] under ``ANIMAL_MEAN``. After each epoch it validates the
source, the target and each category of ``eval_categories`` (horse and
tiger here, dog and sheep in ``train_animal_other``), whose loaders it
builds by setting ``args.animal`` to each in turn, as the reference does
(the namespace keeps the last). The log lines, the checkpoint names
(``best_pt`` / ``best``), the ``best_pt`` reload at epoch
``--pretrain-epoch`` and ``--steps-per-dispatch`` are the human trainer's
(``train_human.run_training``).

``--decode-cache G`` caches the datasets' decoded frames, G GB for the
run, shared by the loader workers (``data/util.py::FrameCache``).

``--device-aug`` draws and renders every random view of an iteration on the
device, inside the steps and their CUDA graphs
(``engine.AnimalDeviceAugPipeline``, with the JAX package's deviation notes
in ``ops/device_aug.py``): the target's ``_mt`` set gives its crop and
annotations (``IdentityAffine`` views), and a source with a raw mode (the
synthetic sets) gives its decoded frames, whose imgaug chain, flip, crop and
targets run on the device; ``--decode-cache G`` then also caches those raw
items in a ``CachedDataset`` of G GB (``data/loader.py``), beside the frame
arena of the other sets. A source without a raw mode stays on the host, and
only the adapt phase builds its target views on the device, as in JAX.

``--dist-*`` runs it as one data-parallel run over several processes, as
the human trainer does (``train_human.run_main``): the training loaders give
each rank its share, every rank validates its rows of each batch, and rank
0 writes the files.
"""

from __future__ import annotations

import argparse
from typing import NamedTuple

import cv2
import numpy as np
from torch.utils.data import DataLoader, Dataset

from . import data as datasets
from .data import ForeverDataIterator, make_loader
from .data import transforms as T
from .data.loader import CachedDataset
from .data.util import FLIP_PAIRS, FrameArena
from .engine import AnimalDeviceAugPipeline, run_validate
from .ops.device_aug import AnimalSourceAugConfig, DeviceAugConfig, flip_perm_from_pairs
from .train_human import (ARCHITECTURES, Validation, reseed_after_splits, run_main,
                          run_training, seed_host_streams, train_loader)
from .utils import CompleteLogger

cv2.setNumThreads(1)  # the loader workers' augmentation, one thread each

# styled-image clamp under mean-only animal normalization (reference
# train_animal.py:34-35)
RECOVER_MIN = (-0.3999, -0.3909, -0.3871)
RECOVER_MAX = (0.6001, 0.6091, 0.6129)
ANIMAL_MEAN = [0.3999, 0.3909, 0.3871]


class Data(NamedTuple):
    """The source training set (its keypoint count sizes the model), the
    four loaders of a run and the per-category (name, loader) pairs."""
    train_source_dataset: Dataset
    train_source_loader: DataLoader
    val_source_loader: DataLoader
    train_target_loader: DataLoader
    val_target_loader: DataLoader
    category_loaders: tuple


def source_on_device(args, train_source_dataset) -> bool:
    """Whether the source's views are built on the device: under
    ``--device-aug``, for a source set with a raw mode."""
    return bool(args.device_aug and getattr(train_source_dataset, "raw_mode", False))


def build_data(args, pin: bool, eval_categories) -> Data:
    """The datasets of ``--source``, ``--target_ssl`` and ``--target`` and
    one evaluation set per category, and their loaders, built in the JAX
    trainer's order with its keywords (``**vars(args)``) and the run's
    ``frame_arena``; ``args.animal`` is left at the last category. ``pin``
    page-locks the batches (a CUDA run). Under ``--device-aug`` the target's
    views are identity ones and a raw source's items go through a
    ``CachedDataset`` of ``--decode-cache`` GB (when it is above 0)."""
    if args.device_aug:  # the views are drawn on the device
        tgt_train_transform_stu = T.Compose([T.IdentityAffine(), T.ToTensor()])
        tgt_train_transform_tea = T.Compose([T.IdentityAffine(), T.ToTensor()])
    else:
        tgt_train_transform_stu = T.Compose([
            T.RandomAffineRotation(args.rotation_stu, args.shear_stu,
                                   args.translate_stu, args.scale_stu),
            T.ToTensor(),
        ])
        tgt_train_transform_tea = T.Compose([
            T.RandomAffineRotation(args.rotation_tea, args.shear_tea,
                                   args.translate_tea, args.scale_tea),
            T.ToTensor(),
        ])

    # --decode-cache: one budget for the frames of every dataset of the run
    arena = FrameArena(args.decode_cache * 1e9) if args.decode_cache > 0 else None

    def dataset(name, **kwargs):
        return datasets.__dict__[name](frame_arena=arena, **kwargs, **vars(args))

    def eval_loader(ds):
        return make_loader(ds, args.test_batch, num_workers=args.workers, pin_memory=pin)

    train_source_dataset = dataset(args.source, is_train=True, raw_mode=args.device_aug)
    source_items = train_source_dataset
    if args.decode_cache > 0 and source_on_device(args, train_source_dataset):
        # raw items are decoded frames only, deterministic: memoizable
        source_items = CachedDataset(train_source_dataset, max_bytes=args.decode_cache * 1e9)
    train_source_loader = train_loader(source_items, args, pin, target=False)
    val_source_loader = eval_loader(dataset(args.source, is_train=False))
    train_target_loader = train_loader(
        dataset(args.target_ssl, is_train=True, transforms_stu=tgt_train_transform_stu,
                transforms_tea=tgt_train_transform_tea),
        args, pin, target=True)
    val_target_loader = eval_loader(dataset(args.target, is_train=False))
    category_loaders = []
    for category in eval_categories:
        args.animal = category  # the reference mutates the namespace
        category_loaders.append((category, eval_loader(dataset(args.target, is_train=False))))
    return Data(train_source_dataset, train_source_loader, val_source_loader,
                train_target_loader, val_target_loader, tuple(category_loaders))


def main(args: argparse.Namespace, eval_categories=("horse", "tiger")):
    run_main(args, lambda args, device, logger: _train(args, device, logger,
                                                       eval_categories), CompleteLogger)


def _train(args, device, logger, eval_categories):
    seed_host_streams(args, logger)
    data = build_data(args, device.type == "cuda", eval_categories)
    logger.write("Source train: {}".format(len(data.train_source_loader)))
    logger.write("Target train: {}".format(len(data.train_target_loader)))
    logger.write("Source test: {}".format(len(data.val_source_loader)))
    logger.write("Target test: {}".format(len(data.val_target_loader)))
    reseed_after_splits(args)

    def validate(eval_step, model, visualize):
        return Validation(
            run_validate(eval_step, model, data.val_source_loader, args),
            run_validate(eval_step, model, data.val_target_loader, args, visualize=visualize),
            tuple((category, run_validate(eval_step, model, loader, args,
                                          visualize=visualize))
                  for category, loader in data.category_loaders))

    def groups(acc):
        for name, value in acc.items():
            logger.write("{}: {:4.3f}".format(name, value))

    def report(epoch, acc, best_acc):
        parts = " ".join("{}: {:4.3f}".format(category.capitalize(), groups_acc["all"])
                         for category, groups_acc in acc.categories)
        if epoch is None:  # --phase test
            logger.write("Source: {:4.3f} Target: {:4.3f} {}".format(
                acc.source["all"], acc.target["all"], parts))
        else:
            logger.write("Epoch: {} Source: {:4.3f} Target: {:4.3f} {} Target(best): {:4.3f}"
                         .format(epoch, acc.source["all"], acc.target["all"], parts,
                                 best_acc))
            logger.write("Source:")
            groups(acc.source)
            logger.write("Target:")
        groups(acc.target)
        for category, groups_acc in acc.categories:
            logger.write("{}:".format(category.capitalize()))
            groups(groups_acc)

    run_training(args, device, logger, data.train_source_dataset,
                 ForeverDataIterator(data.train_source_loader),
                 ForeverDataIterator(data.train_target_loader),
                 recover=(RECOVER_MIN, RECOVER_MAX),
                 denormalize=lambda image: image + np.asarray(ANIMAL_MEAN),
                 validate=validate, report=report,
                 device_aug=device_aug_pipeline(args, data.train_source_dataset, device)
                 if args.device_aug else None)


def device_aug_pipeline(args, train_source_dataset, device) -> AnimalDeviceAugPipeline:
    """``--device-aug``'s pipeline (the JAX trainer's): the student's and
    the teachers' affine configs from their flags (no crop, no jitter), the
    target views normalized by ``ANIMAL_MEAN``; with a raw source, its
    ``AnimalSourceAugConfig`` from ``--inp-res``, ``--out-res``, ``--sigma``
    and ``--label-type``, the pair swap of its ``FLIP_DATASET`` and its own
    mean; draws seeded from ``--seed``."""
    common = dict(image_size=args.image_size, heatmap_size=args.heatmap_size,
                  sigma=args.sigma, use_rrc=False, color=0.0)
    aug_stu = DeviceAugConfig(rotation=args.rotation_stu, shear=tuple(args.shear_stu),
                              translate=tuple(args.translate_stu),
                              scale=tuple(args.scale_stu), **common)
    aug_tea = DeviceAugConfig(rotation=args.rotation_tea, shear=tuple(args.shear_tea),
                              translate=tuple(args.translate_tea),
                              scale=tuple(args.scale_tea), **common)
    src = {}
    if source_on_device(args, train_source_dataset):
        src = dict(src_cfg=AnimalSourceAugConfig(inp_res=args.inp_res, out_res=args.out_res,
                                                 sigma=args.sigma, label_type=args.label_type),
                   flip_perm=flip_perm_from_pairs(FLIP_PAIRS[train_source_dataset.FLIP_DATASET],
                                                  train_source_dataset.num_keypoints),
                   src_mean=train_source_dataset.mean)
    return AnimalDeviceAugPipeline(aug_stu, aug_tea, k=args.k, mean=ANIMAL_MEAN,
                                   seed=args.seed if args.seed is not None else 0,
                                   device=device, **src)


def build_parser():
    architecture_names = sorted(ARCHITECTURES)

    parser = argparse.ArgumentParser(
        description="Source Only for Keypoint Detection Domain Adaptation")
    parser.add_argument("--source", default="synthetic_animal_sp", type=str)
    parser.add_argument("--target", default="real_animal", type=str)
    parser.add_argument("--target_ssl", default="real_animal", type=str)
    parser.add_argument("--image-path", default="./animal_data", type=str,
                        help="path to images")
    parser.add_argument("--animal", default="all", type=str,
                        help="horse | tiger | sheep | hound | elephant")
    parser.add_argument("--year", default=2014, type=int, metavar="N",
                        help="year of coco dataset: 2014 (default) | 2017)")
    parser.add_argument("--inp-res", default=256, type=int,
                        help="input resolution (default: 256)")
    parser.add_argument("--out-res", default=64, type=int,
                        help="output resolution (default: 64, to gen GT)")
    parser.add_argument("-f", "--flip", dest="flip", action="store_true",
                        help="flip the input during validation")
    parser.add_argument("--sigma", type=float, default=1, help="")
    parser.add_argument("--scale-factor", type=float, default=0.25,
                        help="Scale factor (data aug).")
    parser.add_argument("--rot-factor", type=float, default=30,
                        help="Rotation factor (data aug).")
    parser.add_argument("--sigma-decay", type=float, default=0,
                        help="Sigma decay rate for each epoch.")
    parser.add_argument("--label-type", metavar="LABELTYPE", default="Gaussian",
                        choices=["Gaussian", "Cauchy"],
                        help="Labelmap dist type: (default=Gaussian)")
    parser.add_argument("--train_on_all_cat", action="store_true",
                        help="whether train on all categories")
    parser.add_argument("--image-size", type=int, default=256, help="input image size")
    parser.add_argument("--heatmap-size", type=int, default=64, help="output heatmap size")
    parser.add_argument("--k", type=int, default=1, help="")

    for role in ("stu", "tea"):
        parser.add_argument(f"--rotation_{role}", type=int, default=180,
                            help="rotation range of the RandomRotation augmentation")
        parser.add_argument(f"--color_{role}", type=float, default=0.25,
                            help="color range of the jitter augmentation")
        parser.add_argument(f"--blur_{role}", type=float, default=0,
                            help="blur range of the jitter augmentation")
        parser.add_argument(f"--shear_{role}", nargs="+", type=float, default=(-30, 30),
                            help="shear range for the RandomResizeCrop augmentation")
        parser.add_argument(f"--translate_{role}", nargs="+", type=float,
                            default=(0.05, 0.05),
                            help="tranlate range for the RandomResizeCrop augmentation")
        parser.add_argument(f"--scale_{role}", nargs="+", type=float, default=(0.6, 1.3),
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
    parser.add_argument("--test-batch", default=1, type=int, metavar="N",
                        help="mini-batch size (default: 1)")
    parser.add_argument("--lr", "--learning-rate", default=0.0001, type=float,
                        metavar="LR", help="initial learning rate", dest="lr")
    parser.add_argument("--lambda_c", default=1.0, type=float)
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
    parser.add_argument("--val-print-freq", default=500, type=int, metavar="N",
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
                        help="generate the views on the device (the host only decodes "
                             "the source's frames and crops the target's)")
    parser.add_argument("--decode-cache", type=float, default=0.0,
                        help="GB of decoded-frame cache of the animal datasets, shared "
                             "by the loader workers; 0 disables")
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
