"""FreiHAND dataset (reference lib/datasets/freihand.py).

The port's copy of ``uda_poseestimation_tpu/data/freihand.py``: the 32560
unique training samples in each of four colour versions (gs, hom, sample,
auto), so 130240 samples for ``task="all"``; keypoint2d projected through
the intrinsics; the shuffle after ``random.seed(42)`` (which resets the
global stream, as the reference does), test = the first min(0.2 N, 3200).
An item is cut out with a 1.5x square box around its keypoints and, as no
sample is a left hand, mirrored. A missing annotation file raises
``FileNotFoundError`` (the JAX package's copy asserts).

One deviation in cost, none in result: the JAX package parses the three
annotation files and projects every sample's keypoints once per colour
version, four times for ``task="all"``; this copy does it once and shares
the parsed lists and projected arrays between the four versions' samples
(no code writes to them), which takes a quarter of the time and memory.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import random
import time

import numpy as np
from PIL import Image

from ._util import download as download_data
from .keypoint_dataset import Hand21KeypointDataset
from .transforms import crop, hflip
from .util import generate_target, get_bounding_box, keypoint2d_to_3d, normalize_3d, scale_box


def _json_load(p):
    with open(p, "r") as fi:  # raises FileNotFoundError, as _util does
        return json.load(fi)


def load_db_annotation(base_path, set_name=None):
    if set_name is None:
        set_name = "training"
    print("Loading FreiHAND dataset index ...")
    t = time.time()
    K_list = _json_load(os.path.join(base_path, "%s_K.json" % set_name))
    mano_list = _json_load(os.path.join(base_path, "%s_mano.json" % set_name))
    xyz_list = _json_load(os.path.join(base_path, "%s_xyz.json" % set_name))
    assert len(K_list) == len(mano_list) == len(xyz_list), "Size mismatch."
    print("Loading of %d samples done in %.2f seconds" % (len(K_list), time.time() - t))
    return list(zip(K_list, mano_list, xyz_list))


def project_points(xyz, K):
    xyz = np.array(xyz)
    K = np.array(K)
    uv = np.matmul(K, xyz.T).T
    return uv[:, :2] / uv[:, -1:]


def db_size(set_name):
    if set_name == "training":
        return 32560
    if set_name == "evaluation":
        return 3960
    raise AssertionError("Invalid choice.")


class sample_version:
    gs = "gs"
    hom = "hom"
    sample = "sample"
    auto = "auto"
    db_size = db_size("training")

    @classmethod
    def valid_options(cls):
        return [cls.gs, cls.hom, cls.sample, cls.auto]

    @classmethod
    def map_id(cls, id, version):
        assert version in cls.valid_options()
        return id + cls.db_size * cls.valid_options().index(version)


def _load_index(root, set_name="training"):
    """Each training sample's (intrinsic_matrix, keypoint3d, keypoint2d),
    read once for all four colour versions."""
    return [(intrinsic_matrix, keypoint3d, project_points(keypoint3d, intrinsic_matrix))
            for intrinsic_matrix, _mano, keypoint3d in load_db_annotation(root, set_name)]


def _version_samples(index, version, set_name="training"):
    """The sample dicts of one colour version (reference get_samples)."""
    rgb, mask = os.path.join(set_name, "rgb", ""), os.path.join(set_name, "mask", "")
    samples = []
    for idx in range(db_size(set_name)):
        image_name = rgb + "%08d.jpg" % sample_version.map_id(idx, version)
        mask_name = mask + "%08d.jpg" % idx
        intrinsic_matrix, keypoint3d, keypoint2d = index[idx]
        samples.append({
            "name": image_name,
            "mask_name": mask_name,
            "keypoint2d": keypoint2d,
            "keypoint3d": keypoint3d,
            "intrinsic_matrix": intrinsic_matrix,
            "left": False,
        })
    return samples


class FreiHand(Hand21KeypointDataset):
    """FreiHAND source dataset (4-tuple contract)."""

    def __init__(self, root, split="train", task="all", download=True, **kwargs):
        if download and not (osp.exists(osp.join(root, "training"))
                             and osp.exists(osp.join(root, "evaluation"))):
            download_data(root, "training", "FreiHAND_pub_v2.zip",
                          "https://lmb.informatik.uni-freiburg.de/data/freihand/FreiHAND_pub_v2.zip")
        assert split in ["train", "test", "all"]
        self.split = split
        assert task in ["all", "gs", "auto", "sample", "hom"]
        self.task = task
        versions = ["gs", "auto", "sample", "hom"] if task == "all" else [task]
        index = _load_index(root)
        samples = [s for version in versions for s in _version_samples(index, version)]
        random.seed(42)
        random.shuffle(samples)
        samples_split = min(int(len(samples) * 0.2), 3200)
        if self.split == "train":
            samples = samples[samples_split:]
        elif self.split == "test":
            samples = samples[:samples_split]
        super().__init__(root, samples, **kwargs)

    def __getitem__(self, index):
        sample = self.samples[index]
        image_name = sample["name"]
        image = Image.open(os.path.join(self.root, image_name))
        keypoint3d_camera = np.array(sample["keypoint3d"])
        keypoint2d = np.array(sample["keypoint2d"])
        intrinsic_matrix = np.array(sample["intrinsic_matrix"])
        Zc = keypoint3d_camera[:, 2]

        bounding_box = get_bounding_box(keypoint2d)
        w, h = image.size
        left, upper, right, lower = scale_box(bounding_box, w, h, 1.5)
        image, keypoint2d = crop(image, upper, left, lower - upper, right - left, keypoint2d)
        if sample["left"] is False:
            image, keypoint2d = hflip(image, keypoint2d)

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
            "keypoint2d": keypoint2d,
            "target_small": generate_target(keypoint2d, visible, (8, 8),
                                            self.sigma, self.image_size),
            "keypoint3d": keypoint3d_n,
            "z": keypoint3d_n[:, 2],
        }
        return image, target, target_weight, meta
