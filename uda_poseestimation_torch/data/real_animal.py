"""TigDog real-animal datasets (reference lib/datasets/real_animal_all.py and
real_animal_all_mt.py).

The port's copy of ``uda_poseestimation_tpu/data/real_animal.py``:
behaviorDiscovery2.0's ``ranges.mat`` and ``landmarks/<shot>.mat`` read with
SciPy's ``loadmat``, the tiger keypoint reorder [1..8, 15..18, 13, 14,
9..12] - 1, the video-level train/valid index caches under
``cached_data/real_animal/``, the bounding box of the visible keypoints
+-15 px, the MPII center/scale (s = max(w, h) / 200 * 1.25), the mean of
the *synthetic* statistics, no evaluation-time augmentation (the reference
keeps it commented out), and ``draw_labelmap_ori`` targets with the -1
offset, gated on ``tpts[i, 1] > 0``.

The ``_mt`` variant crops first (``crop_ori``), re-enters PIL at uint8, and
then applies the student and teacher transforms to the *original-frame*
keypoints with a dummy intrinsic matrix, and the crop's ``transform(...,
c, s, ...)`` to their results: a reference quirk kept as it is
(real_animal_all_mt.py:250-322); ``aug_param`` still records the inverse
affine that the adapt step needs. Its ``meta_stu`` also carries the raw
canvas keys ``canvas``, ``vis`` and ``kp_orig``.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image
from scipy.io import loadmat

from .keypoint_dataset import Animal18KeypointDataset
from .synthetic_animal import cached_data_dir, load_mean_file
from .util import (
    FrameCache,
    color_normalize,
    crop_ori,
    draw_labelmap_ori,
    transform,
)

TIGER_REORDER = np.array([1, 2, 3, 4, 5, 6, 7, 8, 15, 16, 17, 18, 13, 14, 9, 10, 11, 12]) - 1


def _load_tigdog(img_folder, animals, is_tune, train_img_set, train_pts_set,
                 valid_img_set, valid_pts_set, tune_img_set=None, tune_pts_set=None):
    for animal in sorted(animals):
        img_list = []
        anno_list = []
        range_path = os.path.join(img_folder, "behaviorDiscovery2.0/ranges", animal, "ranges.mat")
        landmark_path = os.path.join(img_folder, "behaviorDiscovery2.0/landmarks", animal)
        range_file = loadmat(range_path)
        frame_num = 0

        train_idxs = np.load(os.path.join(cached_data_dir(), "real_animal", animal,
                                          "train_idxs_by_video.npy"))
        valid_idxs = np.load(os.path.join(cached_data_dir(), "real_animal", animal,
                                          "valid_idxs_by_video.npy"))
        for video in range_file["ranges"]:
            shot_id = video[0]
            landmark_path_video = os.path.join(landmark_path, str(shot_id) + ".mat")
            if not os.path.isfile(landmark_path_video):
                continue
            landmark_file = loadmat(landmark_path_video)
            for frame in range(video[1], video[2] + 1):
                frame_id = frame - video[1]
                img_name = animal + "/" + "0" * (8 - len(str(frame))) + str(frame) + ".jpg"
                img_list.append([img_name, shot_id, frame_id])
                coord = landmark_file["landmarks"][frame_id][0][0][0][0]
                vis = landmark_file["landmarks"][frame_id][0][0][0][1]
                landmark = np.hstack((coord, vis))
                landmark_18 = landmark[:18, :]
                if animal == "tiger":
                    landmark_18 = landmark_18[TIGER_REORDER]
                anno_list.append(landmark_18)
                frame_num += 1

        for idx in range(train_idxs.shape[0]):
            train_idx = train_idxs[idx]
            if is_tune and idx % 5 == 0:
                tune_img_set.append(img_list[train_idx])
                tune_pts_set.append(anno_list[train_idx])
            else:
                train_img_set.append(img_list[train_idx])
                train_pts_set.append(anno_list[train_idx])
        for idx in range(valid_idxs.shape[0]):
            valid_idx = valid_idxs[idx]
            valid_img_set.append(img_list[valid_idx])
            valid_pts_set.append(anno_list[valid_idx])
        print("Animal:{}, number of frames:{}, train: {}, valid: {}".format(
            animal, frame_num, train_idxs.shape[0], valid_idxs.shape[0]))


def _synthetic_mean(animal_first, train_on_all_cat):
    animal = "all" if train_on_all_cat else animal_first
    meanstd_file = os.path.join(cached_data_dir(), "synthetic_animal",
                                animal + "_combineds5r5_texture", "mean.pth.tar")
    print("load from mean file:", meanstd_file)
    mean, std = load_mean_file(meanstd_file)
    print("  Real animal  mean: %.4f, %.4f, %.4f" % tuple(mean[:3]))
    print("  Real animal  std:  %.4f, %.4f, %.4f" % tuple(std[:3]))
    return mean, std


def _bbox_center_scale(img, pts):
    x_vis = pts[:, 0][pts[:, 0] > 0]
    y_vis = pts[:, 1][pts[:, 1] > 0]
    height, width = img.shape[0], img.shape[1]
    y_min = float(max(np.min(y_vis) - 15, 0.0))
    y_max = float(min(np.max(y_vis) + 15, height))
    x_min = float(max(np.min(x_vis) - 15, 0.0))
    x_max = float(min(np.max(x_vis) + 15, width))
    c = np.array([(x_min + x_max) / 2.0, (y_min + y_max) / 2.0], np.float32)
    s = max(x_max - x_min, y_max - y_min) / 200.0 * 1.25
    return c, s


class Real_Animal_All(Animal18KeypointDataset):
    """TigDog horse+tiger eval dataset (4-tuple, real_animal_all.py:17-263)."""

    def __init__(self, is_train=True, is_tune=False, **kwargs):
        print()
        print("==> real_animal_all")
        Animal18KeypointDataset.__init__(self, kwargs.get("image_path"), samples=[])
        self.img_folder = kwargs["image_path"]
        self.is_train = is_train
        self.is_tune = is_tune
        self.inp_res = kwargs["inp_res"]
        self.out_res = kwargs["out_res"]
        self.sigma = kwargs["sigma"]
        self.scale_factor = kwargs["scale_factor"]
        self.rot_factor = kwargs["rot_factor"]
        self.label_type = kwargs["label_type"]
        self.animal = ["horse", "tiger"] if kwargs["animal"] == "all" else [kwargs["animal"]]
        self.train_on_all_cat = kwargs["train_on_all_cat"]

        self.train_img_set, self.valid_img_set = [], []
        self.train_pts_set, self.valid_pts_set = [], []
        self.tune_img_set, self.tune_pts_set = [], []
        _load_tigdog(self.img_folder, self.animal, self.is_tune,
                     self.train_img_set, self.train_pts_set,
                     self.valid_img_set, self.valid_pts_set,
                     self.tune_img_set, self.tune_pts_set)
        self.mean, self.std = _synthetic_mean(self.animal[0], self.train_on_all_cat)
        # --decode-cache GB (it comes in with **vars(args)) for the split's
        # frames, in the run's frame_arena when the trainer gives one
        self._frames = FrameCache(float(kwargs.get("decode_cache", 0) or 0) * 1e9,
                                  keys=[self._path(a) for a, _, _ in self._split()[0]],
                                  arena=kwargs.get("frame_arena"))

    def _split(self):
        if self.is_train:
            return self.train_img_set, self.train_pts_set
        if self.is_tune:
            return self.tune_img_set, self.tune_pts_set
        return self.valid_img_set, self.valid_pts_set

    def _path(self, name):
        return os.path.join(self.img_folder, "behaviorDiscovery2.0", name)

    def __getitem__(self, index):
        img_list, anno_list = self._split()
        img_path = self._path(img_list[index][0])
        img = self._frames.load(img_path)  # HWC [0,1]
        pts = anno_list[index].astype(np.float32)
        c, s = _bbox_center_scale(img, pts)
        nparts = pts.shape[0]
        r = 0

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
        return len(self._split()[0])


class Real_Animal_All_mt(Real_Animal_All):
    """TigDog mean-teacher dataset (8-tuple, real_animal_all_mt.py:20-335)."""

    def __init__(self, is_train=True, is_tune=False, transforms_stu=None,
                 transforms_tea=None, k=1, **kwargs):
        print()
        print("==> real_animal_all_mt")
        super().__init__(is_train=is_train, is_tune=is_tune, **kwargs)
        self.transforms_stu = transforms_stu
        self.transforms_tea = transforms_tea
        self.k = k

    def __getitem__(self, index):
        img_list, anno_list = self._split()
        img_path = self._path(img_list[index][0])
        img = self._frames.load(img_path)
        pts = anno_list[index].astype(np.float32)
        nparts = pts.shape[0]
        c, s = _bbox_center_scale(img, pts)
        r = 0

        inp = crop_ori(img, c, s, [self.inp_res, self.inp_res], rot=r)
        inp = (inp * 255).astype(np.uint8)  # re-enter PIL like the reference
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


def real_animal_all(**kwargs):
    return Real_Animal_All(**kwargs)


real_animal_all.njoints = 18


def real_animal_all_mt(**kwargs):
    return Real_Animal_All_mt(**kwargs)


real_animal_all_mt.njoints = 18
