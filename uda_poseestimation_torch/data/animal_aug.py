"""The synthetic-animal training augmentation (the reference's imgaug
``Sequential``, synthetic_animal_sp_all.py:134-153).

The port's copy of ``uda_poseestimation_tpu/data/animal_aug.py``, an
OpenCV/numpy reimplementation: each of [Affine, AdditiveGaussianNoise,
GaussianBlur, ContrastNormalization] applied with p=0.5 in a random order,

- Affine: per-axis scale U(0.5, 1.5), translate U(-5%, +5%), rotate
  U(-30, 30) degrees, shear U(-20, 20) degrees, nearest or bilinear
  (drawn), constant fill U(0, 255);
- AdditiveGaussianNoise: std 0.5*255, per channel with p=0.5;
- GaussianBlur: sigma U(1, 5);
- ContrastNormalization: alpha U(0.5, 2.0) about 128, per channel with p=0.5.

The parameter distributions and the keypoint transform are imgaug's; its
own random stream is not reproduced. The draws come from the global
``np.random`` stream (or ``rng``) in the JAX package's order, so the same
state gives the same image and keypoints bit for bit. OpenCV is imported
when an image is warped or blurred.
"""

from __future__ import annotations

import numpy as np


def affine_matrix_from_params(w, h, sx, sy, tx, ty, rot, shear):
    """imgaug's Affine matrix: the skimage-style scale/rotate/shear about the
    image center, then a pixel translation."""
    a = np.array([
        [sx * np.cos(rot), -sy * np.sin(rot + shear), 0.0],
        [sx * np.sin(rot), sy * np.cos(rot + shear), 0.0],
        [0.0, 0.0, 1.0],
    ])
    cx, cy = w / 2.0 - 0.5, h / 2.0 - 0.5
    to_c = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], float)
    from_c = np.array([[1, 0, cx], [0, 1, cy], [0, 0, 1]], float)
    m = from_c @ a @ to_c
    m[0, 2] += tx
    m[1, 2] += ty
    return m


class AnimalAugmentation:
    """Callable (image uint8 HWC, keypoints (K, 2)) -> augmented pair."""

    def __init__(self, p=0.5, rng=None):
        self.p = p
        self.rng = rng or np.random

    def _affine_matrix(self, w, h):
        r = self.rng
        sx = r.uniform(0.5, 1.5)
        sy = r.uniform(0.5, 1.5)
        tx = r.uniform(-0.05, 0.05) * w
        ty = r.uniform(-0.05, 0.05) * h
        rot = np.deg2rad(r.uniform(-30, 30))
        shear = np.deg2rad(r.uniform(-20, 20))
        order = int(r.random_sample() < 0.5)
        cval = r.uniform(0, 255)
        return affine_matrix_from_params(w, h, sx, sy, tx, ty, rot, shear), order, cval

    @staticmethod
    def _apply_affine(img, kps, m, order, cval):
        import cv2

        h, w = img.shape[:2]
        flags = cv2.INTER_NEAREST if order == 0 else cv2.INTER_LINEAR
        out = cv2.warpAffine(img, m[:2], (w, h), flags=flags,
                             borderMode=cv2.BORDER_CONSTANT,
                             borderValue=(cval, cval, cval))
        ones = np.ones((kps.shape[0], 1), kps.dtype)
        new_kps = (m @ np.concatenate([kps, ones], axis=1).T).T[:, :2]
        return out, new_kps.astype(np.float32)

    def _noise(self, img):
        r = self.rng
        per_channel = r.random_sample() < 0.5
        scale = 0.5 * 255
        if per_channel:
            noise = r.randn(*img.shape) * scale
        else:
            noise = r.randn(*img.shape[:2])[..., None] * scale
        return np.clip(img.astype(np.float64) + noise, 0, 255).astype(np.uint8)

    def _blur(self, img):
        import cv2

        sigma = self.rng.uniform(1.0, 5.0)
        return cv2.GaussianBlur(img, (0, 0), sigmaX=sigma, sigmaY=sigma)

    def _contrast(self, img):
        r = self.rng
        per_channel = r.random_sample() < 0.5
        if per_channel:
            alpha = r.uniform(0.5, 2.0, size=(1, 1, img.shape[2]))
        else:
            alpha = r.uniform(0.5, 2.0)
        out = (img.astype(np.float64) - 128.0) * alpha + 128.0
        return np.clip(out, 0, 255).astype(np.uint8)

    def __call__(self, image, keypoints):
        """image: uint8 HWC; keypoints: (K, 2) float. Returns the augmented pair."""
        r = self.rng
        img = np.asarray(image)
        kps = np.asarray(keypoints, np.float32)
        order = list(range(4))
        r.shuffle(order)
        for i in order:
            if r.random_sample() >= self.p:
                continue
            if i == 0:
                h, w = img.shape[:2]
                m, interp_order, cval = self._affine_matrix(w, h)
                img, kps = self._apply_affine(img, kps, m, interp_order, cval)
            elif i == 1:
                img = self._noise(img)
            elif i == 2:
                img = self._blur(img)
            else:
                img = self._contrast(img)
        return img, kps
