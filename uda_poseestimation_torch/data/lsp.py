"""Leeds Sports Pose datasets (reference lib/datasets/lsp.py and lsp_mt.py).

The port's copy of ``uda_poseestimation_tpu/data/lsp.py``, with the
reference's quirks kept:

- ``joints.mat`` (read with ``scipy.io``) holds the 2000 images; every
  split is all 2000;
- ``download=False`` checks for a ``lsp`` directory under ``root``;
- the 14 LSP joints are reindexed to the 16 body keypoints, pelvis and
  thorax standing in for the missing joints, which the visibility mask
  ``VISIBLE`` turns off; visibility is ``VISIBLE * (1 - occluded)``;
- ``LSP`` uses the fixed transform ResizePad + ToTensor + Normalize
  (ImageNet), whatever ``transforms`` it is given; ``LSP_mt`` puts
  ResizePad before its ``transforms_base``.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.io as scio
from PIL import Image, ImageFile

from ._util import check_exits, download as download_data
from .keypoint_dataset import Body16KeypointDataset
from .transforms import Compose, Normalize, ResizePad, ToTensor
from .util import generate_target

ImageFile.LOAD_TRUNCATED_IMAGES = True

JOINTS_INDEX = (0, 1, 2, 3, 4, 5, 13, 13, 12, 13, 6, 7, 8, 9, 10, 11)
VISIBLE = np.array([1.0] * 6 + [0, 0] + [1.0] * 8, dtype=np.float32)


def _load_samples(root, download):
    if download:
        download_data(root, "images", "lsp_dataset.zip",
                      "https://cloud.tsinghua.edu.cn/f/46ea73c89abc46bfb125/?dl=1")
    else:
        check_exits(root, "lsp")
    samples = []
    annotations = scio.loadmat(os.path.join(root, "joints.mat"))["joints"].transpose((2, 1, 0))
    for i in range(0, 2000):
        samples.append(("im{0:04d}.jpg".format(i + 1), annotations[i]))
    return samples


def _read(ds, index):
    """The image, its 16 keypoints and their (16, 1) visibility."""
    image_name, joints = ds.samples[index]
    image = Image.open(os.path.join(ds.root, "images", image_name))
    visible = VISIBLE * (1 - joints[JOINTS_INDEX, 2])
    return image_name, image, joints[JOINTS_INDEX, :2], visible[:, np.newaxis]


class LSP(Body16KeypointDataset):
    """LSP target evaluation dataset (4-tuple contract, fixed transform)."""

    def __init__(self, root, split="train", task="all", download=True,
                 image_size=(256, 256), transforms=None, **kwargs):
        assert split in ["train", "test", "all"]
        self.split = split
        samples = _load_samples(root, download)
        transforms = Compose([
            ResizePad(image_size[0]),
            ToTensor(),
            Normalize([0.485, 0.456, 0.406], [0.229, 0.224, 0.225]),
        ])
        super().__init__(root, samples, transforms=transforms,
                         image_size=image_size, **kwargs)

    def __getitem__(self, index):
        image_name, image, keypoint2d, visible = _read(self, index)
        image, data = self.transforms(image, keypoint2d=keypoint2d)
        keypoint2d = data["keypoint2d"]

        target, target_weight = generate_target(keypoint2d, visible, self.heatmap_size,
                                                self.sigma, self.image_size)
        meta = {
            "image": image_name,
            "keypoint2d": keypoint2d,
            "keypoint3d": np.zeros((self.num_keypoints, 3)).astype(keypoint2d.dtype),
        }
        return image, target, target_weight, meta


class LSP_mt(Body16KeypointDataset):
    """LSP mean-teacher dataset (8-tuple contract, lsp_mt.py)."""

    def __init__(self, root, split="train", task="all", download=True,
                 image_size=(256, 256), k=1, transforms_base=None,
                 transforms_stu=None, transforms_tea=None, **kwargs):
        assert split in ["train", "test", "all"]
        self.split = split
        samples = _load_samples(root, download)
        self.transforms_base = Compose([ResizePad(image_size[0])]) + transforms_base
        self.transforms_stu = transforms_stu
        self.transforms_tea = transforms_tea
        self.k = k
        super().__init__(root, samples, image_size=image_size, **kwargs)

    def __getitem__(self, index):
        image_name, image, keypoint2d, visible = _read(self, index)
        image, data = self.transforms_base(image, keypoint2d=keypoint2d,
                                           intrinsic_matrix=None)
        keypoint2d = data["keypoint2d"]

        image_stu, data_stu = self.transforms_stu(image, keypoint2d=keypoint2d,
                                                  intrinsic_matrix=None)
        keypoint2d_stu = data_stu["keypoint2d"]

        target_stu, target_weight_stu = generate_target(
            keypoint2d_stu, visible, self.heatmap_size, self.sigma, self.image_size)
        target_ori, target_weight_ori = generate_target(
            keypoint2d, visible, self.heatmap_size, self.sigma, self.image_size)

        meta_stu = {
            "image": image_name,
            "target_small_stu": generate_target(keypoint2d_stu, visible, (8, 8),
                                                self.sigma, self.image_size),
            "keypoint2d_ori": keypoint2d,
            "target_ori": target_ori,
            "target_weight_ori": target_weight_ori,
            "keypoint2d_stu": keypoint2d_stu,
            "aug_param_stu": data_stu["aug_param"],
        }

        images_tea, targets_tea, target_weights_tea, metas_tea = [], [], [], []
        for _ in range(self.k):
            image_tea, data_tea = self.transforms_tea(image, keypoint2d=keypoint2d,
                                                      intrinsic_matrix=None)
            keypoint2d_tea = data_tea["keypoint2d"]
            target_tea, target_weight_tea = generate_target(
                keypoint2d_tea, visible, self.heatmap_size, self.sigma, self.image_size)
            metas_tea.append({
                "image": image_name,
                "target_small_tea": generate_target(keypoint2d_tea, visible, (8, 8),
                                                    self.sigma, self.image_size),
                "keypoint2d_tea": keypoint2d_tea,
                "aug_param_tea": data_tea["aug_param"],
            })
            images_tea.append(image_tea)
            targets_tea.append(target_tea)
            target_weights_tea.append(target_weight_tea)

        return (image_stu, target_stu, target_weight_stu, meta_stu,
                images_tea, targets_tea, target_weights_tea, metas_tea)
