"""SURREAL dataset (reference lib/datasets/surreal.py).

The port's copy of ``uda_poseestimation_tpu/data/surreal.py``: the
annotations of ``<root>/<split>/run{0,1,2}.json``, the 24 SMPL joints
reindexed to the 16 body keypoints, the shuffle after ``random.seed(42)``
(which resets the global stream, as the reference does), test = the first
min(0.2 N, 3200) of the test directory's samples. Visibility is all ones.
The frames are 240x240.
"""

from __future__ import annotations

import json
import os
import random

import numpy as np
from PIL import Image, ImageFile

from ._util import check_exits, download as download_data
from .keypoint_dataset import Body16KeypointDataset
from .util import generate_target, keypoint2d_to_3d, normalize_3d

ImageFile.LOAD_TRUNCATED_IMAGES = True

# (directory, archive, url) of each part of the processed dataset
_PARTS = (
    ("train/run0", "train0.tgz", "https://cloud.tsinghua.edu.cn/f/b13604f06ff1445c830a/?dl=1"),
    ("train/run1", "train1.tgz", "https://cloud.tsinghua.edu.cn/f/919aefe2de3541c3b940/?dl=1"),
    ("train/run2", "train2.tgz", "https://cloud.tsinghua.edu.cn/f/34864760ad4945b9bcd6/?dl=1"),
    ("val", "val.tgz", "https://cloud.tsinghua.edu.cn/f/16b20f2e76684f848dc1/?dl=1"),
    ("test", "test.tgz", "https://cloud.tsinghua.edu.cn/f/36c72d86e43540e0a913/?dl=1"),
)


class SURREAL(Body16KeypointDataset):
    """SURREAL source dataset (4-tuple contract)."""

    def __init__(self, root, split="train", task="all", download=True, **kwargs):
        assert split in ["train", "test", "val"]
        self.split = split

        for part, archive, url in _PARTS:
            if download:
                download_data(root, part, archive, url)
            else:
                check_exits(root, part)

        all_samples = []
        for part in [0, 1, 2]:
            annotation_file = os.path.join(root, split, "run{}.json".format(part))
            print("loading", annotation_file)
            with open(annotation_file) as f:
                samples = json.load(f)
                for sample in samples:
                    sample["image_path"] = os.path.join(
                        root, self.split, "run{}".format(part), sample["name"])
                all_samples.extend(samples)

        random.seed(42)
        random.shuffle(all_samples)
        samples_split = min(int(len(all_samples) * 0.2), 3200)
        if self.split == "train":
            all_samples = all_samples[samples_split:]
        elif self.split == "test":
            all_samples = all_samples[:samples_split]
        self.joints_index = (7, 4, 1, 2, 5, 8, 0, 9, 12, 15, 20, 18, 13, 14, 19, 21)

        super().__init__(root, all_samples, **kwargs)

    def __getitem__(self, index):
        sample = self.samples[index]
        image_name = sample["name"]
        image = Image.open(sample["image_path"])
        keypoint3d_camera = np.array(sample["keypoint3d"])[self.joints_index, :]
        keypoint2d = np.array(sample["keypoint2d"])[self.joints_index, :]
        intrinsic_matrix = np.array(sample["intrinsic_matrix"])
        Zc = keypoint3d_camera[:, 2]

        image, data = self.transforms(image, keypoint2d=keypoint2d,
                                      intrinsic_matrix=intrinsic_matrix)
        keypoint2d = data["keypoint2d"]
        intrinsic_matrix = data["intrinsic_matrix"]
        keypoint3d_camera = keypoint2d_to_3d(keypoint2d, intrinsic_matrix, Zc)

        visible = np.ones((16, 1), dtype=np.float32)
        target, target_weight = generate_target(keypoint2d, visible, self.heatmap_size,
                                                self.sigma, self.image_size)
        meta = {
            "image": image_name,
            "keypoint2d": keypoint2d,
            "keypoint3d": normalize_3d(keypoint3d_camera),
        }
        return image, target, target_weight, meta
