"""Synthetic-animal datasets (reference lib/datasets/synthetic_animal_sp_all.py
and synthetic_animal_sp_all_other.py).

The port's copy of ``uda_poseestimation_tpu/data/synthetic_animal.py``:
``clean_data/keypoints_{18,14}.json`` (``generate_data_file`` builds it
from the hard-coded mesh-vertex indices below), the train/valid index
arrays and mean files under ``cached_data/synthetic_animal/``, the imgaug
training augmentation (``data.animal_aug``), a ``random.random() <= 0.5``
horizontal flip with the 'real_animal' / 'animal_pose' pair swap, the
out-of-frame keypoint zeroing, the bounding box clipped to the 640x480
render, the MPII center/scale ``crop_ori`` and ``draw_labelmap_ori``
targets with the -1 offset, and visibility forced to 1. ``raw_mode`` (a
training set under ``--device-aug``) returns the decoded frame and its
annotations only.

The cached_data directory is ``$UDA_CACHED_DATA_DIR``, else
``./cached_data`` (the reference's path relative to the working directory).
Mean files are read with ``torch.load(weights_only=True)``: they hold a
dict of two tensors.
"""

from __future__ import annotations

import glob
import json
import os
import random

import numpy as np
import torch
from PIL import Image

from .animal_aug import AnimalAugmentation
from .keypoint_dataset import Animal14KeypointDataset, Animal18KeypointDataset
from .util import (
    FrameCache,
    color_normalize,
    crop_ori,
    draw_labelmap_ori,
    fliplr,
    im_to_float,
    load_image_ori,
    shufflelr_ori,
    transform,
)

HORSE_IDXS = np.array([1718, 1684, 1271, 1634, 1650, 1643, 1659, 925, 392, 564,
                       993, 726, 1585, 1556, 427, 1548, 967, 877])
TIGER_IDXS = np.array([2753, 2679, 2032, 1451, 1287, 3085, 1632, 229, 1441, 1280,
                       2201, 1662, 266, 158, 270, 152, 219, 129])
HOUND_IDXS = np.array([2028, 2580, 878, 977, 1541, 1734, 799, 1575, 1446, 602,
                       780, 1580, 466, 631])
SHEEP_IDXS = np.array([2046, 1944, 1875, 1900, 1868, 1894, 173, 1829, 1422, 821,
                       622, 575, 1370, 716])


def cached_data_dir() -> str:
    return os.environ.get("UDA_CACHED_DATA_DIR", "./cached_data")


def load_mean_file(path):
    """A mean.pth.tar ({"mean": tensor, "std": tensor}) as numpy float32."""
    meanstd = torch.load(path, map_location="cpu", weights_only=True)
    return (np.asarray(meanstd["mean"], np.float32),
            np.asarray(meanstd["std"], np.float32))


def generate_data_file(data_dir="./animal_data", animal_list=("horse", "tiger"),
                       idx_table=None, out_name="keypoints_18.json"):
    """Build clean_data/<out_name> from per-image kpts.npy (reference :23-64)."""
    idx_table = idx_table or {"horse": HORSE_IDXS, "tiger": TIGER_IDXS,
                              "hound": HOUND_IDXS, "sheep": SHEEP_IDXS}
    data = {}
    for animal in sorted(animal_list):
        img_list = sorted(glob.glob(os.path.join(
            data_dir, "synthetic_animal", animal + "_combineds5r5_texture", "*img.png")))
        print(len(img_list))
        idxs = idx_table[animal]
        cached = os.path.join(cached_data_dir(), "synthetic_animal",
                              animal + "_combineds5r5_texture")
        train_idxs = np.load(os.path.join(cached, "train_idxs.npy")).tolist()
        valid_idxs = np.load(os.path.join(cached, "valid_idxs.npy")).tolist()
        bbox_all, kpts_all = [], []
        for img_path in img_list:
            pts = np.load(img_path[:-7] + "kpts.npy")
            bbox = [min(pts[:, 0]), max(pts[:, 0]), min(pts[:, 1]), max(pts[:, 1])]
            kpts_all.append(pts[idxs].tolist())
            bbox_all.append(bbox)
        data[animal] = {"keypoints": kpts_all, "imgpath": img_list, "bbox": bbox_all,
                        "train_idxs": train_idxs, "valid_idxs": valid_idxs}
    os.makedirs(os.path.join(data_dir, "clean_data"), exist_ok=True)
    with open(os.path.join(data_dir, "clean_data", out_name), "w") as f:
        json.dump(data, f)
    print("Generate data files done")


def _decode_rgb(path):
    """The frame as uint8 HWC, its alpha channel dropped (the reference's
    ``[:3]``)."""
    with Image.open(path) as im:
        return np.ascontiguousarray(np.asarray(im)[:, :, :3])


class _SyntheticAnimalBase:
    """What the 18- and 14-keypoint synthetic datasets share."""

    ANIMALS: tuple
    KEYPOINT_FILE: str
    FLIP_DATASET: str

    def _setup(self, is_train, is_aug, kwargs):
        self.animal = list(self.ANIMALS) if kwargs["animal"] == "all" else [kwargs["animal"]]
        self.nParts = self.num_keypoints
        self.img_folder = kwargs["image_path"]
        self.is_train = is_train
        self.is_aug = is_aug
        self.inp_res = kwargs["inp_res"]
        self.out_res = kwargs["out_res"]
        self.sigma = kwargs["sigma"]
        self.scale_factor = kwargs["scale_factor"]
        self.rot_factor = kwargs["rot_factor"]
        self.label_type = kwargs["label_type"]
        self.train_with_occlusion = True
        # raw mode (a training set under --device-aug): the decoded frame
        # and its annotations only, deterministic, so a CachedDataset may
        # hold its items (and no frame cache does)
        self.raw_mode = bool(kwargs.get("raw_mode", False)) and is_train

        # --decode-cache GB for the split's frames, in the run's frame_arena
        # when the trainer gives one
        self.data_dict = {}
        self.train_set = []
        self.valid_set = []
        self._load_animal()
        self._frames = FrameCache(
            0.0 if self.raw_mode else float(kwargs.get("decode_cache", 0) or 0) * 1e9,
            keys=self.train_set if is_train else self.valid_set,
            arena=kwargs.get("frame_arena"))
        self.mean, self.std = self._compute_mean()
        self.seq = AnimalAugmentation()

    def _load_animal(self):
        data_file_path = "{}/clean_data/{}".format(self.img_folder, self.KEYPOINT_FILE)
        with open(data_file_path, "r") as f:
            data_file = json.load(f)
        for animal in self.animal:
            annot = data_file[animal]
            imgpath = annot["imgpath"]
            if self.img_folder != "animal_data":
                imgpath = [i.replace("animal_data", self.img_folder) for i in imgpath]
            train_idxs = annot["train_idxs"]
            valid_idxs = annot["valid_idxs"]
            print("Animal: {}, training samples: {}, valid samples: {}".format(
                animal, len(train_idxs), len(valid_idxs)))
            self.data_dict.update(dict.fromkeys(imgpath))
            for idx in train_idxs:
                self.train_set.append(imgpath[idx])
                self.data_dict[imgpath[idx]] = {
                    "pts": np.array(annot["keypoints"][idx], dtype=np.float32),
                    "bbox": annot["bbox"][idx]}
            for idx in valid_idxs:
                self.valid_set.append(imgpath[idx])
                self.data_dict[imgpath[idx]] = {
                    "pts": np.array(annot["keypoints"][idx], dtype=np.float32),
                    "bbox": annot["bbox"][idx]}
        print("--Training set : {} samples, Valid set : {} samples".format(
            len(self.train_set), len(self.valid_set)))

    def _compute_mean(self):
        animal = self.animal[0] if len(self.animal) == 1 else "all"
        meanstd_file = os.path.join(cached_data_dir(), "synthetic_animal",
                                    animal + "_combineds5r5_texture", "mean.pth.tar")
        if os.path.isfile(meanstd_file):
            print("load from mean file:", meanstd_file)
            mean, std = load_mean_file(meanstd_file)
        else:
            print("generate mean file")
            mean = np.zeros(3)
            std = np.zeros(3)
            for img_path in self.train_set:
                img = load_image_ori(img_path)  # HWC [0,1]
                mean += img.reshape(-1, 3).mean(0)
                std += img.reshape(-1, 3).std(0)
            mean = (mean / len(self.train_set)).astype(np.float32)
            std = (std / len(self.train_set)).astype(np.float32)
            os.makedirs(os.path.dirname(meanstd_file), exist_ok=True)
            torch.save({"mean": torch.tensor(mean), "std": torch.tensor(std)}, meanstd_file)
        if self.is_train:
            print("    Mean: %.4f, %.4f, %.4f" % tuple(np.asarray(mean)[:3]))
            print("    Std:  %.4f, %.4f, %.4f" % tuple(np.asarray(std)[:3]))
        return np.asarray(mean, np.float32), np.asarray(std, np.float32)

    def __getitem__(self, index):
        dataset = self.train_set if self.is_train else self.valid_set
        img_path = dataset[index]
        x_min, x_max, y_min, y_max = self.data_dict[img_path]["bbox"]
        pts = self.data_dict[img_path]["pts"].copy()

        if self.train_with_occlusion:
            pts[:, 2] = 1
        else:
            pts *= pts[:, 2].reshape(-1, 1)

        # the renders are 640x480 (reference :191-194)
        x_min = np.clip(x_min, 0, 640)
        y_min = np.clip(y_min, 0, 480)
        x_max = np.clip(x_max, 0, 640)
        y_max = np.clip(y_max, 0, 480)
        c = np.array([(x_min + x_max) / 2.0, (y_min + y_max) / 2.0], np.float32)
        s = max(x_max - x_min, y_max - y_min) / 200.0 * 1.25

        img = self._frames.load_u8(img_path, _decode_rgb)

        if self.raw_mode:
            meta = {"index": index, "canvas": np.ascontiguousarray(img),
                    "pts": pts.astype(np.float32),
                    "center": c, "scale": np.float32(s)}
            dummy = np.zeros((1, 1, 3), np.float32)
            return dummy, dummy, pts[:, 2:3].astype(np.float32), meta

        pts_aug = pts[:, :2].copy()
        r = 0
        if self.is_train and self.is_aug:
            img, pts_aug = self.seq(img, pts_aug)

        img = im_to_float(img)  # HWC [0,1]
        pts[:, :2] = pts_aug

        # keypoints outside the render are zeroed entirely (reference :256-258)
        oob = (pts[:, 0] < 0) | (pts[:, 1] < 0) | (pts[:, 0] > 640) | (pts[:, 1] > 480)
        pts[oob] = 0

        if self.is_train and random.random() <= 0.5:
            img = fliplr(img)
            pts = shufflelr_ori(pts, width=img.shape[1], dataset=self.FLIP_DATASET)
            c[0] = img.shape[1] - c[0]

        inp = crop_ori(img, c, s, [self.inp_res, self.inp_res], rot=r)
        inp = color_normalize(inp, self.mean, self.std)

        tpts = pts.copy()
        tpts_inpres = pts.copy()
        nparts = tpts.shape[0]
        target = np.zeros((nparts, self.out_res, self.out_res), np.float32)
        target_weight = tpts[:, 2].copy().reshape(nparts, 1)

        for i in range(nparts):
            if tpts[i, 1] > 0:
                tpts[i, 0:2] = transform(tpts[i, 0:2] + 1, c, s,
                                         [self.out_res, self.out_res], rot=r)
                tpts_inpres[i, 0:2] = transform(tpts_inpres[i, 0:2] + 1, c, s,
                                                [self.inp_res, self.inp_res], rot=r)
                target[i], vis = draw_labelmap_ori(target[i], tpts[i] - 1, self.sigma,
                                                   label_type=self.label_type)
                target_weight[i, 0] *= vis
        tpts[:, 2] = target_weight.reshape(-1)

        meta = {"index": index, "center": c, "scale": s,
                "pts": pts, "tpts": tpts, "keypoint2d": tpts_inpres}
        return inp, target, target_weight.astype(np.float32), meta

    def __len__(self):
        return len(self.train_set) if self.is_train else len(self.valid_set)


class Synthetic_Animal_SP_All(_SyntheticAnimalBase, Animal18KeypointDataset):
    """Synthetic horse and tiger, 18 keypoints (synthetic_animal_sp_all.py:67-313)."""

    ANIMALS = ("horse", "tiger")
    KEYPOINT_FILE = "keypoints_18.json"
    FLIP_DATASET = "real_animal"
    num_keypoints = 18

    def __init__(self, is_train=True, is_aug=True, **kwargs):
        print("init all synthetic animal super augmentation")
        Animal18KeypointDataset.__init__(self, kwargs.get("image_path"), samples=[])
        self._setup(is_train, is_aug, kwargs)


class Synthetic_Animal_SP_All_Other(_SyntheticAnimalBase, Animal14KeypointDataset):
    """Synthetic hound and sheep, 14 keypoints (synthetic_animal_sp_all_other.py)."""

    ANIMALS = ("hound", "sheep")
    KEYPOINT_FILE = "keypoints_14.json"
    FLIP_DATASET = "animal_pose"
    num_keypoints = 14

    def __init__(self, is_train=True, is_aug=True, **kwargs):
        print("init all synthetic animal super augmentation (other)")
        Animal14KeypointDataset.__init__(self, kwargs.get("image_path"), samples=[])
        self._setup(is_train, is_aug, kwargs)


def synthetic_animal_sp_all(**kwargs):
    return Synthetic_Animal_SP_All(**kwargs)


synthetic_animal_sp_all.njoints = 18


def synthetic_animal_sp_all_other(**kwargs):
    return Synthetic_Animal_SP_All_Other(**kwargs)


synthetic_animal_sp_all_other.njoints = 14
