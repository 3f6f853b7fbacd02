"""AdaIN decoder pretraining on an animal source-target pair:
``python -m uda_poseestimation_torch.adain.train_animal``.

The twin of ``adain/train/train_animal.py`` (the JAX package's CLI, itself
the reference's): the same flags and defaults, plus ``--device`` (the card
unless ``--device cpu`` is given). The datasets are built from the flags
(``**vars(args)``): ``--source`` with ``is_aug=--aug`` and ``--target_ssl``
with the student and teacher transforms of the ``_stu``/``_tea`` flags;
both loaders take batches of ``--batch_size`` (the animal pair respects it,
unlike the human one) with one worker each. Images are normalized by the
datasets' mean only, so ``denormalize`` adds ``ANIMAL_MEAN`` back and
clips to [0, 1]. It runs ``adain_engine.run_decoder_training`` as the human
CLI does: the same log lines, PNGs and ``decoder_<exp>.pth.tar``, which
loads through the port's ``--decoder-name`` and the JAX package's
``load_style_net_params``. The ``--dist-*`` flags train across GPUs as in
``adain.train_human`` (``--batch_size`` must split over the processes).
``--vgg`` falls back to
``<repo>/saved_models/vgg_normalised.pth``, then to a random encoder with a
warning. TF32 is left as the caller has it (see ``adain.train_human``).
"""

import argparse
import os

import numpy as np

from .. import data as datasets
from ..adain_engine import decoder_process_group, run_decoder_training
from ..data import ForeverDataIterator, make_loader
from ..data import transforms as T

ANIMAL_MEAN = np.array([0.3999, 0.3909, 0.3871], np.float32)
REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")


def denormalize(x):
    return np.clip(np.asarray(x) + ANIMAL_MEAN, 0, 1)


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--vgg", type=str, default="models/vgg_normalised.pth")
    parser.add_argument("--image-size", type=int, default=256, help="input image size")
    parser.add_argument("--resize-scale", nargs="+", type=float, default=(0.6, 1.3))
    parser.add_argument("--rotation", type=int, default=180)
    parser.add_argument("--heatmap-size", type=int, default=64)
    parser.add_argument("-j", "--workers", default=4, type=int, metavar="N")
    parser.add_argument("--source", default="synthetic_animal_sp", type=str)
    parser.add_argument("--target", default="real_animal", type=str)
    parser.add_argument("--target_ssl", default="real_animal", type=str)
    parser.add_argument("--image-path", default="./animal_data", type=str,
                        help="path to images")
    parser.add_argument("--animal", default="all", type=str,
                        help="horse | tiger | sheep | hound | elephant")
    parser.add_argument("--year", default=2014, type=int, metavar="N")
    parser.add_argument("--inp-res", default=256, type=int)
    parser.add_argument("--out-res", default=64, type=int)
    parser.add_argument("-f", "--flip", dest="flip", action="store_true")
    parser.add_argument("--sigma", type=float, default=1)
    parser.add_argument("--scale-factor", type=float, default=0.25)
    parser.add_argument("--rot-factor", type=float, default=30)
    parser.add_argument("--sigma-decay", type=float, default=0)
    parser.add_argument("--label-type", metavar="LABELTYPE", default="Gaussian",
                        choices=["Gaussian", "Cauchy"])
    parser.add_argument("--train_on_all_cat", action="store_true")
    parser.add_argument("--aug", action="store_true")
    for role in ("stu", "tea"):
        parser.add_argument(f"--rotation_{role}", type=int, default=180)
        parser.add_argument(f"--color_{role}", type=float, default=0)
        parser.add_argument(f"--blur_{role}", type=float, default=0)
        parser.add_argument(f"--shear_{role}", nargs="+", type=float, default=(0, 0))
        parser.add_argument(f"--translate_{role}", nargs="+", type=float, default=(0, 0))
        parser.add_argument(f"--scale_{role}", nargs="+", type=float, default=(0.6, 1.3))

    parser.add_argument("--save_model_dir", default="./saved_model")
    parser.add_argument("--exp_name", default="./")
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--lr_decay", type=float, default=5e-5)
    parser.add_argument("--max_iter", type=int, default=500000)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--style_weight", type=float, default=1.0)
    parser.add_argument("--content_weight", type=float, default=1.0)
    parser.add_argument("--save_model_interval", type=int, default=10000)
    parser.add_argument("--log_img_interval", type=int, default=5000)
    parser.add_argument("--dist-coordinator", type=str, default=None,
                        help="host:port of process 0 (or a file:// URL): the decoder "
                             "trained over several processes, one a GPU, each taking its "
                             "rows of the global batch; process 0 writes the files")
    parser.add_argument("--dist-num-processes", type=int, default=1,
                        help="total process count (with --dist-coordinator)")
    parser.add_argument("--dist-process-id", type=int, default=0,
                        help="this process's rank (with --dist-coordinator)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device to train on (default: the CUDA card)")
    return parser


def main(args):
    with decoder_process_group(args, args.batch_size) as device:
        _train(args, device)


def _train(args, device):
    np.random.seed(0)
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

    pin = device.type == "cuda"
    train_source_dataset = datasets.__dict__[args.source](
        is_train=True, is_aug=args.aug, **vars(args))
    train_source_loader = make_loader(train_source_dataset, args.batch_size, shuffle=True,
                                      num_workers=1, drop_last=True, pin_memory=pin)
    train_target_dataset = datasets.__dict__[args.target_ssl](
        is_train=True, transforms_stu=tgt_train_transform_stu,
        transforms_tea=tgt_train_transform_tea, **vars(args))
    train_target_loader = make_loader(train_target_dataset, args.batch_size, shuffle=True,
                                      num_workers=1, drop_last=True, pin_memory=pin)

    # the reference reads ../saved_models/vgg_normalised.pth
    args.vgg_resolved = args.vgg if os.path.exists(args.vgg) \
        else os.path.join(REPO, "saved_models", "vgg_normalised.pth")

    run_decoder_training(args, ForeverDataIterator(train_source_loader),
                         ForeverDataIterator(train_target_loader), denormalize,
                         device=device)


if __name__ == "__main__":
    main(build_parser().parse_args())
