"""Host-side (numpy) dataset numerics for the human datasets.

The port's copy of what the human datasets need from
``uda_poseestimation_tpu/data/util.py`` (reference lib/datasets/util.py):
``generate_target`` (:12-70, the reference's paste-window math),
``keypoint2d_to_3d``, ``scale_box``, ``get_bounding_box``, ``area`` and
``intersection``; and two helpers that the datasets' copies share:
``normalize_3d`` and ``mean_teacher_item``, the 8-tuple of the
``*_mt`` datasets that carry 3D keypoints. Every result equals the JAX
package's bit for bit.
"""

from __future__ import annotations

import numpy as np


def generate_target(joints, joints_vis, heatmap_size, sigma, image_size):
    """Gaussian heatmaps for one sample.

    Args: joints (K, 2); joints_vis (K, 1) or (K,); heatmap_size (W, H);
    image_size (W, H). Returns target (K, H, W) float32, weight (K, 1).
    """
    joints = np.asarray(joints, np.float32)
    joints_vis = np.asarray(joints_vis, np.float32).reshape(-1)
    w, h = int(heatmap_size[0]), int(heatmap_size[1])
    stride_x = float(image_size[0]) / w
    stride_y = float(image_size[1]) / h
    mu_x = np.trunc(joints[:, 0] / stride_x + 0.5)
    mu_y = np.trunc(joints[:, 1] / stride_y + 0.5)
    in_bounds = (mu_x >= 0) & (mu_x < w) & (mu_y >= 0) & (mu_y < h)
    weight = np.where(in_bounds, joints_vis, 0.0).astype(np.float32)

    # the reference's paste window (util.py:42-68), fractional sigma
    # included: ul = int(mu - 3σ), br = int(mu + 3σ + 1) (int() truncates
    # toward zero), a (2*3σ+1)-sized patch whose peak sits at index size//2,
    # pasted over [max(0, ul), min(br, bound))
    tmp = 3.0 * sigma
    x0 = float((2.0 * tmp + 1.0) // 2)
    xs = np.arange(w, dtype=np.float32)[None, None, :]
    ys = np.arange(h, dtype=np.float32)[None, :, None]
    ul_x = np.trunc(mu_x - tmp)[:, None, None]
    ul_y = np.trunc(mu_y - tmp)[:, None, None]
    br_x = np.trunc(mu_x + tmp + 1.0)[:, None, None]
    br_y = np.trunc(mu_y + tmp + 1.0)[:, None, None]
    dx = xs - (ul_x + x0)
    dy = ys - (ul_y + x0)
    g = np.exp(-(dx * dx + dy * dy) / (2.0 * sigma ** 2))
    g *= ((xs >= ul_x) & (xs < np.minimum(br_x, w))
          & (ys >= ul_y) & (ys < np.minimum(br_y, h)))
    target = np.where((weight > 0.5)[:, None, None], g, 0.0).astype(np.float32)
    return target, weight[:, None]


def keypoint2d_to_3d(keypoint2d, intrinsic_matrix, Zc):
    uv1 = np.concatenate([np.copy(keypoint2d), np.ones((keypoint2d.shape[0], 1))],
                         axis=1).T * Zc
    return np.matmul(np.linalg.inv(intrinsic_matrix), uv1).T


def scale_box(box, image_width, image_height, scale, pad=False):
    """Square box of side scale*max(w,h), clamped to the image unless pad."""
    left, upper, right, lower = box
    center_x, center_y = (left + right) / 2, (upper + lower) / 2
    w, h = right - left, lower - upper
    side_with = min(round(scale * max(w, h)), min(image_width, image_height))
    left = round(center_x - side_with / 2)
    right = left + side_with - 1
    upper = round(center_y - side_with / 2)
    lower = upper + side_with - 1
    if not pad:
        if left < 0:
            left = 0
            right = side_with - 1
        if right >= image_width:
            right = image_width - 1
            left = image_width - side_with
        if upper < 0:
            upper = 0
            lower = side_with - 1
        if lower >= image_height:
            lower = image_height - 1
            upper = image_height - side_with
    return left, upper, right, lower


def get_bounding_box(keypoint2d):
    return (np.min(keypoint2d[:, 0]), np.min(keypoint2d[:, 1]),
            np.max(keypoint2d[:, 0]), np.max(keypoint2d[:, 1]))


def area(left, upper, right, lower):
    return max(right - left + 1, 0) * max(lower - upper + 1, 0)


def intersection(box_a, box_b):
    la, ua, ra, lo_a = box_a
    lb, ub, rb, lo_b = box_b
    return max(la, lb), max(ua, ub), min(ra, rb), min(lo_a, lo_b)


def normalize_3d(keypoint3d):
    """Center on joint 9 and scale joint 0's offset from it to unit length."""
    kp = keypoint3d - keypoint3d[9:10, :]
    return kp / np.sqrt(np.sum(kp[0, :] ** 2))


def mean_teacher_item(ds, image_name, image, keypoint2d, intrinsic_matrix, Zc, visible):
    """The 8-tuple of a mean-teacher dataset with 3D keypoints (reference
    rendered_hand_pose_mt.py:62-159, and the same in hand_3d_studio_mt.py and
    human36m_mt.py): ``ds.transforms_base`` once, then the student view and
    ``ds.k`` teacher views of its output, in this order of draws."""
    image, data = ds.transforms_base(image, keypoint2d=keypoint2d,
                                     intrinsic_matrix=intrinsic_matrix)
    keypoint2d = data["keypoint2d"]
    intrinsic_matrix = data["intrinsic_matrix"]

    image_stu, data_stu = ds.transforms_stu(image, keypoint2d=keypoint2d,
                                            intrinsic_matrix=intrinsic_matrix)
    keypoint2d_stu = data_stu["keypoint2d"]
    keypoint3d_stu = keypoint2d_to_3d(keypoint2d_stu, data_stu["intrinsic_matrix"], Zc)

    target_stu, target_weight_stu = generate_target(
        keypoint2d_stu, visible, ds.heatmap_size, ds.sigma, ds.image_size)
    target_ori, target_weight_ori = generate_target(
        keypoint2d, visible, ds.heatmap_size, ds.sigma, ds.image_size)

    keypoint3d_n_stu = normalize_3d(keypoint3d_stu)
    meta_stu = {
        "image": image_name,
        "target_small_stu": generate_target(keypoint2d_stu, visible, (8, 8),
                                            ds.sigma, ds.image_size),
        "keypoint2d_ori": keypoint2d,
        "target_ori": target_ori,
        "target_weight_ori": target_weight_ori,
        "keypoint2d_stu": keypoint2d_stu,
        "keypoint3d_stu": keypoint3d_n_stu,
        "aug_param_stu": data_stu["aug_param"],
        "z_stu": keypoint3d_n_stu[:, 2],
    }

    images_tea, targets_tea, target_weights_tea, metas_tea = [], [], [], []
    for _ in range(ds.k):
        image_tea, data_tea = ds.transforms_tea(image, keypoint2d=keypoint2d,
                                                intrinsic_matrix=intrinsic_matrix)
        keypoint2d_tea = data_tea["keypoint2d"]
        keypoint3d_tea = keypoint2d_to_3d(keypoint2d_tea, data_tea["intrinsic_matrix"], Zc)

        target_tea, target_weight_tea = generate_target(
            keypoint2d_tea, visible, ds.heatmap_size, ds.sigma, ds.image_size)
        keypoint3d_n_tea = normalize_3d(keypoint3d_tea)
        metas_tea.append({
            "image": image_name,
            "target_small_tea": generate_target(keypoint2d_tea, visible, (8, 8),
                                                ds.sigma, ds.image_size),
            "keypoint2d_tea": keypoint2d_tea,
            "keypoint3d_tea": keypoint3d_n_tea,
            "aug_param_tea": data_tea["aug_param"],
            "z_tea": keypoint3d_n_tea[:, 2],
        })
        images_tea.append(image_tea)
        targets_tea.append(target_tea)
        target_weights_tea.append(target_weight_tea)

    return (image_stu, target_stu, target_weight_stu, meta_stu,
            images_tea, targets_tea, target_weights_tea, metas_tea)
