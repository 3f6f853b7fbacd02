"""AnimalPose datasets (reference lib/datasets/animal_pose.py and
animal_pose_mt.py).

The port's copy of ``uda_poseestimation_tpu/data/animal_pose.py``:
annotations from ``cached_data/real_animal_pose/<animal>/{train,test}_anno.npy``
(dicts of image_id, bbox, keypoints, num_keypoints, category_id) and the
``animal-pose/keypoints.json`` image map; the keypoint reindex [0, 1, 13,
14, 15, 16, 9, 10, 11, 12, 5, 6, 7, 8]; the category table cow, sheep,
horse, cat, dog = 1..5; the optional scale, rotation, flip and colour
augmentation (``is_aug``), drawn from the global ``np.random`` and
``random`` streams in the JAX package's order; the mean from
``cached_data/real_animal_pose/<...>/mean.pth.tar``. The ``_mt`` variant is
``real_animal.Real_Animal_All_mt``'s recipe on these samples.
"""

from __future__ import annotations

import json
import os
import random

import numpy as np
from PIL import Image

from .keypoint_dataset import Animal14KeypointDataset
from .synthetic_animal import cached_data_dir, load_mean_file
from .util import (
    FrameCache,
    color_normalize,
    crop_ori,
    draw_labelmap_ori,
    fliplr,
    shufflelr_ori,
    transform,
)

PTS_INDEX = np.array([0, 1, 13, 14, 15, 16, 9, 10, 11, 12, 5, 6, 7, 8])
CAT_TABLE = {"cow": 1, "sheep": 2, "horse": 3, "cat": 4, "dog": 5}


def _clipped_randn_scale(sf):
    return float(np.clip(np.random.randn() * sf + 1, 1 - sf, 1 + sf))


def _clipped_randn_rot(rf):
    return float(np.clip(np.random.randn() * rf, -2 * rf, 2 * rf))


class Animal_Pose(Animal14KeypointDataset):
    """AnimalPose eval dataset (4-tuple, animal_pose.py:19-178)."""

    def __init__(self, is_train=True, is_aug=False, **kwargs):
        print()
        print("==> animal_pose")
        Animal14KeypointDataset.__init__(self, kwargs.get("image_path"), samples=[])
        self.cat_table = dict(CAT_TABLE)
        self.pts_index = PTS_INDEX
        self.img_folder = kwargs["image_path"]
        self.is_train = is_train
        self.inp_res = kwargs["inp_res"]
        self.out_res = kwargs["out_res"]
        self.sigma = kwargs["sigma"]
        self.scale_factor = kwargs["scale_factor"]
        self.rot_factor = kwargs["rot_factor"]
        self.label_type = kwargs["label_type"]
        self.animal = ["dog", "sheep"] if kwargs["animal"] == "all" else [kwargs["animal"]]
        self.train_on_all_cat = kwargs["train_on_all_cat"]
        self.is_aug = is_aug
        with open(os.path.join(self.img_folder, "animal-pose/keypoints.json")) as f:
            self.anno_dict = json.load(f)
        self.train_set = []
        self.val_set = []
        self._load_animal()
        self.mean, self.std = self._compute_mean()
        # --decode-cache GB for the split's frames, in the run's frame_arena
        # when the trainer gives one
        self._frames = FrameCache(
            float(kwargs.get("decode_cache", 0) or 0) * 1e9,
            keys=[self._path(anno) for anno in (self.train_set if is_train else self.val_set)],
            arena=kwargs.get("frame_arena"))

    def _path(self, anno):
        imagename = self.anno_dict["images"][str(anno["image_id"])]
        return os.path.join(self.img_folder, "animal-pose", "images", imagename)

    def _load_animal(self):
        for animal in sorted(self.animal):
            train_anno = np.load(os.path.join(cached_data_dir(), "real_animal_pose",
                                              animal, "train_anno.npy"), allow_pickle=True)
            valid_anno = np.load(os.path.join(cached_data_dir(), "real_animal_pose",
                                              animal, "test_anno.npy"), allow_pickle=True)
            self.train_set += train_anno.tolist()
            self.val_set += valid_anno.tolist()
            print("Animal:{}, number of image:{}, train: {}, valid: {}".format(
                animal, len(train_anno) + len(valid_anno), len(train_anno), len(valid_anno)))
        print("Total number of image:{}, train: {}, valid {}".format(
            len(self.train_set) + len(self.val_set), len(self.train_set), len(self.val_set)))

    def _compute_mean(self):
        animal = "all" if self.train_on_all_cat else self.animal[0]
        meanstd_file = os.path.join(cached_data_dir(), "real_animal_pose", animal,
                                    "mean.pth.tar")
        print("load from mean file:", meanstd_file)
        mean, std = load_mean_file(meanstd_file)
        print("  Real animal  mean: %.4f, %.4f, %.4f" % tuple(mean[:3]))
        print("  Real animal  std:  %.4f, %.4f, %.4f" % tuple(std[:3]))
        return mean, std

    def _load_sample(self, anno_list, index):
        img = self._frames.load(self._path(anno_list[index]))
        pts = np.array(anno_list[index]["keypoints"]).astype(np.float32)[self.pts_index]
        x_min, y_min, x_max, y_max = anno_list[index]["bbox"]
        c = np.array([(x_min + x_max) / 2.0, (y_min + y_max) / 2.0], np.float32)
        s = max(x_max - x_min, y_max - y_min) / 200.0 * 1.25
        return img, pts, c, s

    def _maybe_aug(self, img, pts, c, s):
        r = 0
        if self.is_aug and self.is_train:
            s = s * _clipped_randn_scale(self.scale_factor)
            r = _clipped_randn_rot(self.rot_factor) if random.random() <= 0.6 else 0
            if random.random() <= 0.5:
                img = fliplr(img)
                pts = shufflelr_ori(pts, width=img.shape[1], dataset="animal_pose")
                c[0] = img.shape[1] - c[0]
            for ch in range(3):
                img[..., ch] = np.clip(img[..., ch] * random.uniform(0.8, 1.2), 0, 1)
        return img, pts, c, s, r

    def __getitem__(self, index):
        anno_list = self.train_set if self.is_train else self.val_set
        img, pts, c, s = self._load_sample(anno_list, index)
        nparts = pts.shape[0]
        img, pts, c, s, r = self._maybe_aug(img, pts, c, s)

        inp = crop_ori(img, c, s, [self.inp_res, self.inp_res], rot=r)
        inp = color_normalize(inp, self.mean, self.std)

        tpts = pts.copy()
        tpts_inpres = pts.copy()
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

        meta = {"index": index, "center": c, "scale": s,
                "pts": pts, "tpts": tpts, "keypoint2d": tpts_inpres}
        return inp, target, target_weight.astype(np.float32), meta

    def __len__(self):
        return len(self.train_set) if self.is_train else len(self.val_set)


class Animal_Pose_mt(Animal_Pose):
    """AnimalPose mean-teacher dataset (8-tuple, animal_pose_mt.py)."""

    def __init__(self, is_train=True, is_aug=False, transforms_stu=None,
                 transforms_tea=None, k=1, **kwargs):
        super().__init__(is_train=is_train, is_aug=is_aug, **kwargs)
        self.transforms_stu = transforms_stu
        self.transforms_tea = transforms_tea
        self.k = k

    def __getitem__(self, index):
        anno_list = self.train_set if self.is_train else self.val_set
        img, pts, c, s = self._load_sample(anno_list, index)
        nparts = pts.shape[0]
        img, pts, c, s, r = self._maybe_aug(img, pts, c, s)

        inp = crop_ori(img, c, s, [self.inp_res, self.inp_res], rot=r)
        inp = (inp * 255).astype(np.uint8)
        intrinsic_matrix = np.zeros((3, 3))

        inp_stu = Image.fromarray(inp)
        inp_stu, data_stu = self.transforms_stu(inp_stu, keypoint2d=pts[:, :2],
                                                intrinsic_matrix=intrinsic_matrix)
        pts_stu = np.asarray(data_stu["keypoint2d"], np.float32)
        aug_param_stu = data_stu["aug_param"]
        image_stu = color_normalize(inp_stu, self.mean, self.std)

        tpts_stu = pts_stu.copy()
        tpts_ori = pts.copy()
        tpts_inpres_stu = pts_stu.copy()
        target_ori = np.zeros((nparts, self.out_res, self.out_res), np.float32)
        target_stu = np.zeros((nparts, self.out_res, self.out_res), np.float32)
        target_weight_ori = pts[:, 2].copy().reshape(nparts, 1)
        target_weight_stu = pts[:, 2].copy().reshape(nparts, 1)

        for i in range(nparts):
            if tpts_stu[i, 1] > 0:
                tpts_stu[i, 0:2] = transform(tpts_stu[i, 0:2] + 1, c, s,
                                             [self.out_res, self.out_res], rot=r)
                tpts_ori[i, 0:2] = transform(tpts_ori[i, 0:2] + 1, c, s,
                                             [self.out_res, self.out_res], rot=r)
                tpts_inpres_stu[i, 0:2] = transform(tpts_inpres_stu[i, 0:2] + 1, c, s,
                                                    [self.inp_res, self.inp_res], rot=r)
                target_ori[i], vis_ori = draw_labelmap_ori(
                    target_ori[i], tpts_ori[i] - 1, self.sigma, label_type=self.label_type)
                target_stu[i], vis_stu = draw_labelmap_ori(
                    target_stu[i], tpts_stu[i] - 1, self.sigma, label_type=self.label_type)
                target_weight_stu[i, 0] *= vis_stu
                target_weight_ori[i, 0] *= vis_ori

        meta_stu = {"index": index, "center": c, "scale": s,
                    "aug_param_stu": aug_param_stu, "target_ori": target_ori,
                    "pts": pts_stu, "tpts": tpts_stu, "keypoint2d": tpts_inpres_stu,
                    "target_weight_ori": target_weight_ori.astype(np.float32),
                    # raw-canvas extras for --device-aug (additive keys)
                    "canvas": inp, "vis": pts[:, 2].astype(np.float32),
                    "kp_orig": pts[:, :2].astype(np.float32)}

        images_tea, targets_tea, target_weights_tea, metas_tea = [], [], [], []
        for _ in range(self.k):
            inp_tea = Image.fromarray(inp)
            inp_tea, data_tea = self.transforms_tea(inp_tea, keypoint2d=pts[:, :2],
                                                    intrinsic_matrix=intrinsic_matrix)
            pts_tea = np.asarray(data_tea["keypoint2d"], np.float32)
            aug_param_tea = data_tea["aug_param"]
            image_tea = color_normalize(inp_tea, self.mean, self.std)

            tpts_tea = pts_tea.copy()
            tpts_inpres_tea = pts_tea.copy()
            target_tea = np.zeros((nparts, self.out_res, self.out_res), np.float32)
            target_weight_tea = pts[:, 2].copy().reshape(nparts, 1)

            for i in range(nparts):
                if tpts_tea[i, 1] > 0:
                    tpts_tea[i, 0:2] = transform(tpts_tea[i, 0:2] + 1, c, s,
                                                 [self.out_res, self.out_res], rot=r)
                    tpts_inpres_tea[i, 0:2] = transform(tpts_inpres_tea[i, 0:2] + 1, c, s,
                                                        [self.inp_res, self.inp_res], rot=r)
                    target_tea[i], vis_tea = draw_labelmap_ori(
                        target_tea[i], tpts_tea[i] - 1, self.sigma, label_type=self.label_type)
                    target_weight_tea[i, 0] *= vis_tea

            metas_tea.append({"index": index, "center": c, "scale": s,
                              "aug_param_tea": aug_param_tea, "pts": pts_tea,
                              "tpts": tpts_tea, "keypoint2d": tpts_inpres_tea})
            images_tea.append(image_tea)
            targets_tea.append(target_tea)
            target_weights_tea.append(target_weight_tea.astype(np.float32))

        return (image_stu, target_stu, target_weight_stu.astype(np.float32), meta_stu,
                images_tea, targets_tea, target_weights_tea, metas_tea)


def animal_pose(**kwargs):
    return Animal_Pose(**kwargs)


animal_pose.njoints = 14


def animal_pose_mt(**kwargs):
    return Animal_Pose_mt(**kwargs)


animal_pose_mt.njoints = 14
