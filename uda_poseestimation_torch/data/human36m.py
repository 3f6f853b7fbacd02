"""Human3.6M datasets (reference lib/datasets/human36m.py and
human36m_mt.py).

The port's copy of ``uda_poseestimation_tpu/data/human36m.py``. On first
use of a part, ``_preprocess`` turns the official annotation files into
``annotations/keypoints2d_<part>.json`` and 512x512 ``crop_images``: every
5th frame, cut out with a 1.5x square box around its keypoints, with the 17
joints reindexed to the 16 body keypoints and joint 7 the midpoint of joints
12 and 13. Train = subjects 1, 5, 6, 7 and 8; test = 3200 draws with
replacement (``random.choices`` after ``random.seed(42)``, which resets the
global stream, as the reference does) from subjects 9 and 11, whatever
their size. Visibility is all ones. ``_preprocess`` loops without a
progress bar: the JAX package's copy uses tqdm, which this package does not
need.
"""

from __future__ import annotations

import json
import os
import random

import numpy as np
from PIL import Image, ImageFile

from .keypoint_dataset import Body16KeypointDataset
from .transforms import crop
from .util import (
    generate_target,
    get_bounding_box,
    keypoint2d_to_3d,
    mean_teacher_item,
    normalize_3d,
    scale_box,
)

ImageFile.LOAD_TRUNCATED_IMAGES = True


def _preprocess(part, root):
    body_index = [3, 2, 1, 4, 5, 6, 0, 11, 8, 10, 16, 15, 14, 11, 12, 13]
    image_size = 512
    print("preprocessing part", part)
    with open(os.path.join(root, "annotations", f"Human36M_subject{part}_camera.json")) as f:
        cameras = json.load(f)
    with open(os.path.join(root, "annotations", f"Human36M_subject{part}_data.json")) as f:
        images = json.load(f)["images"]
    with open(os.path.join(root, "annotations", f"Human36M_subject{part}_joint_3d.json")) as f:
        joints_3d = json.load(f)

    data = []
    for i, image_data in enumerate(images):
        if i % 5 != 0:  # every 5th frame
            continue
        keypoint3d = np.array(joints_3d[str(image_data["action_idx"])][
            str(image_data["subaction_idx"])][str(image_data["frame_idx"])])
        keypoint3d = keypoint3d[body_index, :]
        keypoint3d[7, :] = 0.5 * (keypoint3d[12, :] + keypoint3d[13, :])
        camera = cameras[str(image_data["cam_idx"])]
        R, T = np.array(camera["R"]), np.array(camera["t"])[:, np.newaxis]
        extrinsic_matrix = np.concatenate([R, T], axis=1)
        keypoint3d_camera = np.matmul(extrinsic_matrix, np.hstack(
            (keypoint3d, np.ones((keypoint3d.shape[0], 1)))).T)
        Z_c = keypoint3d_camera[2:3, :]

        f_, c = np.array(camera["f"]), np.array(camera["c"])
        intrinsic_matrix = np.zeros((3, 3))
        intrinsic_matrix[0, 0] = f_[0]
        intrinsic_matrix[1, 1] = f_[1]
        intrinsic_matrix[0, 2] = c[0]
        intrinsic_matrix[1, 2] = c[1]
        intrinsic_matrix[2, 2] = 1
        keypoint2d = np.matmul(intrinsic_matrix, keypoint3d_camera)
        keypoint2d = (keypoint2d[0:2, :] / Z_c).T

        src_image_path = os.path.join(root, "images", image_data["file_name"])
        tgt_image_path = os.path.join(root, "crop_images", image_data["file_name"])
        os.makedirs(os.path.dirname(tgt_image_path), exist_ok=True)
        image = Image.open(src_image_path)

        bounding_box = get_bounding_box(keypoint2d)
        w, h = image.size
        left, upper, right, lower = scale_box(bounding_box, w, h, 1.5)
        image, keypoint2d = crop(image, upper, left, lower - upper + 1,
                                 right - left + 1, keypoint2d)
        Z_c = Z_c.T

        uv1 = np.concatenate([np.copy(keypoint2d), np.ones((16, 1))], axis=1) * Z_c
        keypoint3d_camera = np.matmul(np.linalg.inv(intrinsic_matrix), uv1.T).T

        w, h = image.size
        image = image.resize((image_size, image_size))
        image.save(tgt_image_path)

        zoom_factor = float(w) / float(image_size)
        keypoint2d /= zoom_factor
        intrinsic_matrix[0, 0] /= zoom_factor
        intrinsic_matrix[1, 1] /= zoom_factor
        intrinsic_matrix[0, 2] /= zoom_factor
        intrinsic_matrix[1, 2] /= zoom_factor

        data.append({
            "name": image_data["file_name"],
            "keypoint2d": keypoint2d.tolist(),
            "keypoint3d": keypoint3d_camera.tolist(),
            "intrinsic_matrix": intrinsic_matrix.tolist(),
        })

    with open(os.path.join(root, "annotations", f"keypoints2d_{part}.json"), "w") as f:
        json.dump(data, f)


def _load_samples(root, split):
    assert split in ["train", "test", "all"]
    if split == "train":
        parts = [1, 5, 6, 7, 8]
    elif split == "test":
        parts = [9, 11]
    else:
        parts = [1, 5, 6, 7, 8, 9, 11]

    samples = []
    for part in parts:
        annotation_file = os.path.join(root, "annotations/keypoints2d_{}.json".format(part))
        if not os.path.exists(annotation_file):
            _preprocess(part, root)
        print("loading", annotation_file)
        with open(annotation_file) as f:
            samples.extend(json.load(f))
    random.seed(42)
    if split == "test":
        samples = random.choices(samples, k=3200)
    return samples


def _read(ds, index):
    sample = ds.samples[index]
    image = Image.open(os.path.join(ds.root, "crop_images", sample["name"]))
    keypoint3d_camera = np.array(sample["keypoint3d"])
    return (sample["name"], image, np.array(sample["keypoint2d"]),
            np.array(sample["intrinsic_matrix"]), keypoint3d_camera[:, 2])


class Human36M(Body16KeypointDataset):
    """Human3.6M target evaluation dataset (4-tuple contract)."""

    def __init__(self, root, split="train", task="all", download=True, **kwargs):
        self.split = split
        samples = _load_samples(root, split)
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
        meta = {
            "image": image_name,
            "keypoint2d": keypoint2d,
            "keypoint3d": normalize_3d(keypoint3d_camera),
        }
        return image, target, target_weight, meta


class Human36M_mt(Body16KeypointDataset):
    """Human3.6M mean-teacher dataset (8-tuple contract, human36m_mt.py)."""

    def __init__(self, root, split="train", task="all", download=True, k=1,
                 transforms_base=None, transforms_stu=None, transforms_tea=None, **kwargs):
        self.split = split
        self.transforms_base = transforms_base
        self.transforms_stu = transforms_stu
        self.transforms_tea = transforms_tea
        self.k = k
        samples = _load_samples(root, split)
        super().__init__(root, samples, **kwargs)

    def __getitem__(self, index):
        image_name, image, keypoint2d, intrinsic_matrix, Zc = _read(self, index)
        visible = np.ones((self.num_keypoints, 1), dtype=np.float32)
        return mean_teacher_item(self, image_name, image, keypoint2d, intrinsic_matrix, Zc,
                                 visible)
