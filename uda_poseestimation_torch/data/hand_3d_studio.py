"""Hand-3D-Studio datasets (reference lib/datasets/hand_3d_studio.py and
hand_3d_studio_mt.py).

The port's copy of ``uda_poseestimation_tpu/data/hand_3d_studio.py``:
``annotation.json`` under ``H3D_crop``, the task filter (noobject / object /
all), the shuffle after ``random.seed(42)`` (which resets the global stream,
as the reference does), test = the first min(0.2 N, 3200) samples, train =
the rest, val / train-val = the next test-sized block / the rest after it.
Visibility is all ones. The frames are square crops.
"""

from __future__ import annotations

import json
import os
import random

import numpy as np
from PIL import Image, ImageFile

from ._util import check_exits, download as download_data
from .keypoint_dataset import Hand21KeypointDataset
from .util import generate_target, keypoint2d_to_3d, mean_teacher_item, normalize_3d

ImageFile.LOAD_TRUNCATED_IMAGES = True

_URL = "https://cloud.tsinghua.edu.cn/f/d4e612e44dc04d8eb01f/?dl=1"


def _load_samples(root, split, task):
    assert split in ["train", "test", "all", "train-val", "val"]
    assert task in ["noobject", "object", "all"]
    annotation_file = os.path.join(root, "annotation.json")
    print("loading from {}".format(annotation_file))
    with open(annotation_file) as f:
        samples = list(json.load(f))
    if task == "noobject":
        samples = [s for s in samples if int(s["without_object"]) == 1]
    elif task == "object":
        samples = [s for s in samples if int(s["without_object"]) == 0]

    random.seed(42)
    random.shuffle(samples)
    samples_split = min(int(len(samples) * 0.2), 3200)
    if split == "train":
        samples = samples[samples_split:]
    elif split == "test":
        samples = samples[:samples_split]
    elif split == "train-val":
        samples = samples[2 * samples_split:]
    elif split == "val":
        samples = samples[samples_split:2 * samples_split]
    return samples


def _open_root(root, download):
    if download:
        download_data(root, "H3D_crop", "H3D_crop.tar", _URL)
    else:
        check_exits(root, "H3D_crop")
    return os.path.join(root, "H3D_crop")


def _read(ds, index):
    sample = ds.samples[index]
    image = Image.open(os.path.join(ds.root, sample["name"]))
    keypoint3d_camera = np.array(sample["keypoint3d"])
    return (sample["name"], image, np.array(sample["keypoint2d"]),
            np.array(sample["intrinsic_matrix"]), keypoint3d_camera[:, 2])


class Hand3DStudio(Hand21KeypointDataset):
    """H3D evaluation / source dataset (4-tuple contract)."""

    def __init__(self, root, split="train", task="noobject", download=True, **kwargs):
        self.split = split
        self.task = task
        root = _open_root(root, download)
        samples = _load_samples(root, split, task)
        super().__init__(root, samples, **kwargs)

    def __getitem__(self, index):
        image_name, image, keypoint2d, intrinsic_matrix, Zc = _read(self, index)
        image, data = self.transforms(image, keypoint2d=keypoint2d,
                                      intrinsic_matrix=intrinsic_matrix)
        keypoint2d = data["keypoint2d"]
        intrinsic_matrix = data["intrinsic_matrix"]
        keypoint3d_camera = keypoint2d_to_3d(keypoint2d, intrinsic_matrix, Zc)

        visible = np.ones((self.num_keypoints, 1), dtype=np.float32)
        target, target_weight = generate_target(keypoint2d, visible, self.heatmap_size,
                                                self.sigma, self.image_size)
        keypoint3d_n = normalize_3d(keypoint3d_camera)
        meta = {
            "image": image_name,
            "target_small": generate_target(keypoint2d, visible, (8, 8),
                                            self.sigma, self.image_size),
            "keypoint2d": keypoint2d,
            "keypoint3d": keypoint3d_n,
        }
        return image, target, target_weight, meta


class Hand3DStudioAll(Hand3DStudio):
    """H3D with task='all' (reference :124-130)."""

    def __init__(self, root, task="all", **kwargs):
        super().__init__(root, task=task, **kwargs)


class Hand3DStudio_mt(Hand21KeypointDataset):
    """H3D mean-teacher dataset (8-tuple contract, hand_3d_studio_mt.py)."""

    def __init__(self, root, split="train", task="noobject", download=True, k=1,
                 transforms_base=None, transforms_stu=None, transforms_tea=None, **kwargs):
        self.split = split
        self.task = task
        root = _open_root(root, download)
        self.transforms_base = transforms_base
        self.transforms_stu = transforms_stu
        self.transforms_tea = transforms_tea
        self.k = k
        samples = _load_samples(root, split, task)
        super().__init__(root, samples, **kwargs)

    def __getitem__(self, index):
        image_name, image, keypoint2d, intrinsic_matrix, Zc = _read(self, index)
        visible = np.ones((self.num_keypoints, 1), dtype=np.float32)
        return mean_teacher_item(self, image_name, image, keypoint2d, intrinsic_matrix, Zc,
                                 visible)


class Hand3DStudioAll_mt(Hand3DStudio_mt):
    """H3D mean-teacher dataset with task='all'."""

    def __init__(self, root, task="all", **kwargs):
        super().__init__(root, task=task, **kwargs)
