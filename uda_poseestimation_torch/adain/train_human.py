"""AdaIN decoder pretraining on a human or hand source-target pair:
``python -m uda_poseestimation_torch.adain.train_human``.

The twin of ``adain/train/train_human.py`` (the JAX package's CLI, itself
the reference's): the same flags and defaults, the ``_stu``/``_tea`` pairs
included, plus ``--device`` (the card unless ``--device cpu`` is given);
the same log lines, PNG dumps and ``decoder_<exp>.pth.tar`` at the same
cadence under ``logs/<exp_name>/`` (``adain_engine.run_decoder_training``).
``--dist-coordinator``/``--dist-num-processes``/``--dist-process-id`` (the
trainers' flags) train across GPUs, one process a GPU, each taking its rows
of the global batch of 4, which 1, 2 or 4 processes split:

    python -m uda_poseestimation_torch.tools.launch_distributed -n 2 -- \\
        python -m uda_poseestimation_torch.adain.train_human <flags...>

As in the reference, both loaders take batches of 4 whatever
``--batch_size`` says, with one worker each; ``--vgg`` falls back to
``<repo>/saved_models/vgg_normalised.pth``, then to a random encoder with a
warning. The decoder file loads through the port's ``train_human
--decoder-name`` and the JAX package's ``load_style_net_params``.

Precision: the CLI leaves PyTorch's TF32 settings as the caller has them.
At PyTorch's defaults cuDNN runs the float32 convolutions in TF32, as the
reference's own trainer ran on the GPU (the JAX step runs float32 at XLA's
default precision). On the H100 that makes the step about 3x faster than
full float32, and moves its losses by ~1e-4 relative (``chip_smoke.py``
phase ``decoder``, PERF.md). ``torch.backends.cudnn.allow_tf32 = False``
before ``main`` gives full float32.
"""

import argparse
import os

import numpy as np

from .. import data as datasets
from ..adain_engine import decoder_process_group, run_decoder_training
from ..data import ForeverDataIterator, make_loader
from ..data import transforms as T

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")


def denormalize(x):
    return np.asarray(x) * IMAGENET_STD + IMAGENET_MEAN


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--source", type=str)
    parser.add_argument("--target", type=str)
    parser.add_argument("--source_root", type=str)
    parser.add_argument("--target_root", type=str)
    parser.add_argument("--vgg", type=str, default="models/vgg_normalised.pth")
    parser.add_argument("--image-size", type=int, default=256, help="input image size")
    parser.add_argument("--resize-scale", nargs="+", type=float, default=(0.6, 1.3),
                        help="scale range for the RandomResizeCrop augmentation")
    parser.add_argument("--rotation", type=int, default=180,
                        help="rotation range of the RandomRotation augmentation")
    parser.add_argument("--heatmap-size", type=int, default=64, help="output heatmap size")
    parser.add_argument("--color", type=float, default=0,
                        help="color range of the jitter augmentation")
    parser.add_argument("--blur", type=float, default=0,
                        help="blur range of the jitter augmentation")
    parser.add_argument("--shear", nargs="+", type=float, default=(0, 0),
                        help="shear range for the RandomResizeCrop augmentation")
    parser.add_argument("--translate", nargs="+", type=float, default=(0, 0),
                        help="tranlate range for the RandomResizeCrop augmentation")
    parser.add_argument("--scale", nargs="+", type=float, default=(0.6, 1.3),
                        help="scale range for the RandomResizeCrop augmentation")
    for role in ("stu", "tea"):
        parser.add_argument(f"--rotation_{role}", type=int, default=180)
        parser.add_argument(f"--color_{role}", type=float, default=0)
        parser.add_argument(f"--blur_{role}", type=float, default=0)
        parser.add_argument(f"--shear_{role}", nargs="+", type=float, default=(0, 0))
        parser.add_argument(f"--translate_{role}", nargs="+", type=float, default=(0, 0))
        parser.add_argument(f"--scale_{role}", nargs="+", type=float, default=(0.6, 1.3))

    parser.add_argument("--save_model_dir", default="./saved_model",
                        help="Directory to save the model")
    parser.add_argument("--exp_name", default="./", help="Directory to save the log")
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
    with decoder_process_group(args, 4) as device:
        _train(args, device)


def _train(args, device):
    np.random.seed(0)
    normalize = T.Normalize(IMAGENET_MEAN, IMAGENET_STD)
    train_transform = T.Compose([
        T.RandomResizedCrop(size=args.image_size, scale=args.resize_scale),
        T.RandomAffineRotation(args.rotation, args.shear, args.translate, args.scale),
        T.ColorJitter(brightness=args.color, contrast=args.color, saturation=args.color),
        T.GaussianBlur(high=args.blur),
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

    image_size = (args.image_size, args.image_size)
    heatmap_size = (args.heatmap_size, args.heatmap_size)
    pin = device.type == "cuda"
    train_source_dataset = datasets.__dict__[args.source](
        root=args.source_root, transforms=train_transform,
        image_size=image_size, heatmap_size=heatmap_size)
    # the reference's batch of 4 for the human pair, whatever --batch_size says
    train_source_loader = make_loader(train_source_dataset, 4, shuffle=True,
                                      num_workers=1, drop_last=True, pin_memory=pin)
    train_target_dataset = datasets.__dict__[args.target](
        root=args.target_root, transforms_base=base_transform,
        transforms_stu=tgt_train_transform_stu, transforms_tea=tgt_train_transform_tea,
        image_size=image_size, heatmap_size=heatmap_size)
    train_target_loader = make_loader(train_target_dataset, 4, shuffle=True,
                                      num_workers=1, drop_last=True, pin_memory=pin)

    # the reference reads ../saved_models/vgg_normalised.pth
    args.vgg_resolved = args.vgg if os.path.exists(args.vgg) \
        else os.path.join(REPO, "saved_models", "vgg_normalised.pth")

    run_decoder_training(args, ForeverDataIterator(train_source_loader),
                         ForeverDataIterator(train_target_loader), denormalize,
                         device=device)


if __name__ == "__main__":
    main(build_parser().parse_args())
