"""Generic (non-keypoint) transforms (reference lib/transforms/__init__.py).

The port's copy of ``uda_poseestimation_tpu/data/generic_transforms.py``:
images are PIL or HWC numpy arrays (CHW where a transform says so). No
trainer calls these; the registry exports them as the reference's and the
JAX package's do, the unused ``NormalizeAndTranspose``,
``DeNormalizeAndTranspose`` and ``RandomErasing`` included.
"""

from __future__ import annotations

import math
import random

import numpy as np
from PIL import Image


class ResizeImage:
    """Resize a PIL image to (size, size) or (h, w) (reference :9-29)."""

    def __init__(self, size):
        if isinstance(size, int):
            self.size = (int(size), int(size))
        else:
            self.size = size

    def __call__(self, img):
        th, tw = self.size
        return img.resize((th, tw))

    def __repr__(self):
        return self.__class__.__name__ + "(size={0})".format(self.size)


class MultipleApply:
    """Apply several transforms to one image, returning all results (:32-63)."""

    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, image):
        return [t(image) for t in self.transforms]

    def __repr__(self):
        s = self.__class__.__name__ + "("
        for t in self.transforms:
            s += "\n    {0}".format(t)
        return s + "\n)"


class Denormalize:
    """Invert a mean/std normalization on HWC arrays (:66-85)."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, image):
        return np.asarray(image, np.float32) * self.std + self.mean


class NormalizeAndTranspose:
    """BGR mean-subtraction + HWC->CHW (:88-113; unused upstream)."""

    def __init__(self, mean=(104.00698793, 116.66876762, 122.67891434)):
        self.mean = np.array(mean, dtype=np.float32)

    def __call__(self, image):
        if isinstance(image, Image.Image):
            image = np.asarray(image, np.float32)
        image = np.asarray(image, np.float32)
        image = image[:, :, ::-1]  # RGB -> BGR
        image = image - self.mean
        return image.transpose((2, 0, 1)).copy()


class DeNormalizeAndTranspose:
    """CHW->HWC + BGR mean-addition (:116-131; unused upstream)."""

    def __init__(self, mean=(104.00698793, 116.66876762, 122.67891434)):
        self.mean = np.array(mean, dtype=np.float32)

    def __call__(self, image):
        image = np.asarray(image, np.float32).transpose((1, 2, 0))
        image = image + self.mean
        return image[:, :, ::-1]


class RandomErasing:
    """Random rectangle erasing on CHW float arrays (:134-182; unused upstream)."""

    def __init__(self, probability=0.5, sl=0.02, sh=0.4, r1=0.3,
                 mean=(0.4914, 0.4822, 0.4465)):
        self.probability = probability
        self.mean = mean
        self.sl = sl
        self.sh = sh
        self.r1 = r1

    def __call__(self, img):
        if random.uniform(0, 1) >= self.probability:
            return img
        img = np.array(img, copy=True)
        for _ in range(100):
            area = img.shape[1] * img.shape[2]
            target_area = random.uniform(self.sl, self.sh) * area
            aspect_ratio = random.uniform(self.r1, 1 / self.r1)
            h = int(round(math.sqrt(target_area * aspect_ratio)))
            w = int(round(math.sqrt(target_area / aspect_ratio)))
            if w < img.shape[2] and h < img.shape[1]:
                x1 = random.randint(0, img.shape[1] - h)
                y1 = random.randint(0, img.shape[2] - w)
                if img.shape[0] == 3:
                    img[0, x1:x1 + h, y1:y1 + w] = self.mean[0]
                    img[1, x1:x1 + h, y1:y1 + w] = self.mean[1]
                    img[2, x1:x1 + h, y1:y1 + w] = self.mean[2]
                else:
                    img[0, x1:x1 + h, y1:y1 + w] = self.mean[0]
                return img
        return img

    def __repr__(self):
        return self.__class__.__name__ + "(p={})".format(self.probability)
