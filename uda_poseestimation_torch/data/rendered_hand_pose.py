"""RHD (Rendered Handpose) datasets (reference lib/datasets/rendered_hand_pose.py
and rendered_hand_pose_mt.py).

The port's copy of ``uda_poseestimation_tpu/data/rendered_hand_pose.py``.

Sample extraction parity (:114-170): left/right hands split per frame, a hand
kept when its 1.5x square box side > 64, >16 visible keypoints, and overlap
with the other hand's box < 0.3 of its own area; left hands mirrored to
right at load time. Splits: train/test from the RHD sets, val = every 5th of
train, train-val = the rest, all = train+test.

Images leave the transforms as HWC float32 numpy (the batch's NHWC
layout); ``aug_param`` is a flat (6,) array (see data.transforms). The
sample list reads each frame as 320x320, the RHD frame size (``_get_samples``).
"""

from __future__ import annotations

import os
import pickle

import numpy as np
from PIL import Image

from ._util import check_exits, download as download_data
from .keypoint_dataset import Hand21KeypointDataset
from .transforms import crop, hflip
from .util import (
    area,
    generate_target,
    get_bounding_box,
    intersection,
    keypoint2d_to_3d,
    mean_teacher_item,
    normalize_3d,
    scale_box,
)

LEFT_HAND_INDEX = [0, 4, 3, 2, 1, 8, 7, 6, 5, 12, 11, 10, 9, 16, 15, 14, 13, 20, 19, 18, 17]
RIGHT_HAND_INDEX = [i + 21 for i in LEFT_HAND_INDEX]


def _get_samples(root, task, min_size=64):
    set_name = "training" if task == "train" else "evaluation"
    with open(os.path.join(root, set_name, "anno_%s.pickle" % set_name), "rb") as fi:
        anno_all = pickle.load(fi)

    samples = []
    for sample_id, anno in anno_all.items():
        image_name = os.path.join(set_name, "color", "%.5d.png" % sample_id)
        mask_name = os.path.join(set_name, "mask", "%.5d.png" % sample_id)
        keypoint2d = anno["uv_vis"][:, :2]
        keypoint3d = anno["xyz"]
        intrinsic_matrix = anno["K"]
        visible = anno["uv_vis"][:, 2]

        left_kp = keypoint2d[LEFT_HAND_INDEX]
        left_box = get_bounding_box(left_kp)
        right_kp = keypoint2d[RIGHT_HAND_INDEX]
        right_box = get_bounding_box(right_kp)
        w, h = 320, 320

        for kp_idx, box, other_box, is_left in (
                (LEFT_HAND_INDEX, left_box, right_box, True),
                (RIGHT_HAND_INDEX, right_box, left_box, False)):
            scaled_box = scale_box(box, w, h, 1.5)
            left, upper, right, lower = scaled_box
            size = max(right - left, lower - upper)
            if (size > min_size and np.sum(visible[kp_idx]) > 16
                    and area(*intersection(scaled_box, other_box)) / area(*scaled_box) < 0.3):
                samples.append({
                    "name": image_name,
                    "mask_name": mask_name,
                    "keypoint2d": keypoint2d[kp_idx],
                    "visible": visible[kp_idx],
                    "keypoint3d": keypoint3d[kp_idx],
                    "intrinsic_matrix": intrinsic_matrix,
                    "left": is_left,
                })
    return samples


def _select_split(root, split):
    assert split in ["train", "test", "all", "train-val", "val"]
    if split == "all":
        return _get_samples(root, "train") + _get_samples(root, "test")
    if split == "val":
        samples = _get_samples(root, "train")
        return [e for i, e in enumerate(samples) if i % 5 == 0]
    if split == "train-val":
        samples = _get_samples(root, "train")
        return [e for i, e in enumerate(samples) if i % 5 != 0]
    return _get_samples(root, split)


def _load_cropped_hand(ds, index):
    """Shared open + 1.5x bbox crop + mirror-to-right preamble."""
    sample = ds.samples[index]
    image_path = os.path.join(ds.root, sample["name"])
    keypoint3d_camera = np.array(sample["keypoint3d"])
    keypoint2d = np.array(sample["keypoint2d"])
    intrinsic_matrix = np.array(sample["intrinsic_matrix"])
    Zc = keypoint3d_camera[:, 2]

    bounding_box = get_bounding_box(keypoint2d)
    with Image.open(image_path) as image:
        w, h = image.size
        left, upper, right, lower = scale_box(bounding_box, w, h, 1.5)
        image, keypoint2d = crop(image, upper, left, lower - upper, right - left,
                                 keypoint2d)
        image.load()  # the crop reads the file before it is closed
    if sample["left"] is False:
        image, keypoint2d = hflip(image, keypoint2d)
    visible = np.array(sample["visible"], dtype=np.float32)[:, np.newaxis]
    return sample, image, keypoint2d, intrinsic_matrix, Zc, visible


class RenderedHandPose(Hand21KeypointDataset):
    """RHD eval/source dataset (4-tuple contract)."""

    def __init__(self, root, split="train", task="all", download=True, **kwargs):
        if download:
            download_data(root, "RHD_published_v2", "RHD_v1-1.zip",
                          "https://lmb.informatik.uni-freiburg.de/data/RenderedHandpose/RHD_v1-1.zip")
        else:
            check_exits(root, "RHD_published_v2")
        root = os.path.join(root, "RHD_published_v2")
        self.split = split
        samples = _select_split(root, split)
        super().__init__(root, samples, **kwargs)

    def __getitem__(self, index):
        sample, image, keypoint2d, intrinsic_matrix, Zc, visible = _load_cropped_hand(self, index)
        image, data = self.transforms(image, keypoint2d=keypoint2d,
                                      intrinsic_matrix=intrinsic_matrix)
        keypoint2d = data["keypoint2d"]
        intrinsic_matrix = data["intrinsic_matrix"]
        keypoint3d_camera = keypoint2d_to_3d(keypoint2d, intrinsic_matrix, Zc)

        target, target_weight = generate_target(keypoint2d, visible, self.heatmap_size,
                                                self.sigma, self.image_size)
        keypoint3d_n = normalize_3d(keypoint3d_camera)
        meta = {
            "image": sample["name"],
            "target_small": generate_target(keypoint2d, visible, (8, 8),
                                            self.sigma, self.image_size),
            "keypoint2d": keypoint2d,
            "keypoint3d": keypoint3d_n,
            "z": keypoint3d_n[:, 2],
        }
        return image, target, target_weight, meta


class RenderedHandPose_mt(Hand21KeypointDataset):
    """RHD mean-teacher dataset (8-tuple contract, reference *_mt.py:62-159)."""

    def __init__(self, root, split="train", task="all", download=True, k=1,
                 transforms_base=None, transforms_stu=None, transforms_tea=None, **kwargs):
        if download:
            download_data(root, "RHD_published_v2", "RHD_v1-1.zip",
                          "https://lmb.informatik.uni-freiburg.de/data/RenderedHandpose/RHD_v1-1.zip")
        else:
            check_exits(root, "RHD_published_v2")
        root = os.path.join(root, "RHD_published_v2")
        self.split = split
        self.transforms_base = transforms_base
        self.transforms_stu = transforms_stu
        self.transforms_tea = transforms_tea
        self.k = k
        samples = _select_split(root, split)
        super().__init__(root, samples, **kwargs)

    def __getitem__(self, index):
        sample, image, keypoint2d, intrinsic_matrix, Zc, visible = _load_cropped_hand(self, index)
        return mean_teacher_item(self, sample["name"], image, keypoint2d, intrinsic_matrix,
                                 Zc, visible)
