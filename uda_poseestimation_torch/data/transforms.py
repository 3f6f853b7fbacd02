"""Keypoint-aware host transforms (reference lib/transforms/keypoint_detection.py).

The port's copy of the transforms that the human trainer's
``build_transforms`` uses, from ``uda_poseestimation_tpu/data/transforms.py``:
``Compose``, ``ToTensor``, ``Normalize``, ``Resize``, ``RandomResizedCrop``,
``RandomAffineRotation``, ``ColorJitter``, ``GaussianBlur`` and the helpers
they call. Geometry is PIL + numpy with torchvision's matrix conventions:

- ``affine``: PIL ``Image.transform(AFFINE, inverse_matrix)`` about the
  center (w*0.5+0.5, h*0.5+0.5) with NEAREST resampling, keypoints moved by
  the forward RSS matrix (keypoint_detection.py:137-167), and the *inverse*
  parameters recorded as ``aug_param``, a flat (6,) float32 array (angle,
  tx, ty, shear_x, shear_y, scale);
- ``Compose`` threads keyword arguments through the transforms as the
  reference does (:197-213), so keypoint2d / intrinsic_matrix / aug_param
  flow the same way;
- ``ToTensor`` returns HWC float32 numpy in [0, 1], the layout of the
  step's batch (NHWC); the loader turns batches into tensors.

Randomness comes from the global ``random`` and ``np.random`` streams with
the JAX package's draws in its order, so the same seeds give the same
images, keypoints and ``aug_param`` bit for bit.
"""

from __future__ import annotations

import math
import numbers
import random
import warnings

import numpy as np
from PIL import Image, ImageEnhance, ImageFilter


# ---------------------------------------------------------------------------
# functional
# ---------------------------------------------------------------------------

def _inverse_affine_matrix(center, angle, translate, scale, shear):
    """torchvision _get_inverse_affine_matrix (output->input, 6 coeffs)."""
    rot = math.radians(angle)
    sx = math.radians(shear[0])
    sy = math.radians(shear[1])
    cx, cy = center
    tx, ty = translate

    a = math.cos(rot - sy) / math.cos(sy)
    b = -math.cos(rot - sy) * math.tan(sx) / math.cos(sy) - math.sin(rot)
    c = math.sin(rot - sy) / math.cos(sy)
    d = -math.sin(rot - sy) * math.tan(sx) / math.cos(sy) + math.cos(rot)

    matrix = [d, -b, 0.0, -c, a, 0.0]
    matrix = [m / scale for m in matrix]
    matrix[2] += matrix[0] * (-cx - tx) + matrix[1] * (-cy - ty)
    matrix[5] += matrix[3] * (-cx - tx) + matrix[4] * (-cy - ty)
    matrix[2] += cx
    matrix[5] += cy
    return matrix


def pil_affine(image: Image.Image, angle, translate, scale, shear,
               resample=Image.NEAREST):
    """torchvision F.affine semantics for PIL images."""
    w, h = image.size
    center = (w * 0.5 + 0.5, h * 0.5 + 0.5)
    matrix = _inverse_affine_matrix(center, angle, translate, scale, shear)
    return image.transform((w, h), Image.AFFINE, matrix, resample)


def resize(image, size: int, interpolation=Image.BILINEAR,
           keypoint2d=None, intrinsic_matrix=None):
    width, height = image.size
    assert width == height
    factor = float(size) / float(width)
    image = image.resize((size, size), interpolation)
    keypoint2d = np.copy(keypoint2d) * factor
    if intrinsic_matrix is not None:
        intrinsic_matrix = np.copy(intrinsic_matrix)
        intrinsic_matrix[0][0] *= factor
        intrinsic_matrix[0][2] *= factor
        intrinsic_matrix[1][1] *= factor
        intrinsic_matrix[1][2] *= factor
    return image, keypoint2d, intrinsic_matrix


def crop(image, top, left, height, width, keypoint2d):
    image = image.crop((left, top, left + width, top + height))
    keypoint2d = np.copy(keypoint2d)
    keypoint2d[:, 0] -= left
    keypoint2d[:, 1] -= top
    return image, keypoint2d


def resized_crop(img, top, left, height, width, size, interpolation=Image.BILINEAR,
                 keypoint2d=None, intrinsic_matrix=None):
    img, keypoint2d = crop(img, top, left, height, width, keypoint2d)
    return resize(img, size, interpolation, keypoint2d, intrinsic_matrix)


def hflip(image, keypoint2d):
    width, height = image.size
    image = image.transpose(Image.FLIP_LEFT_RIGHT)
    keypoint2d = np.copy(keypoint2d)
    keypoint2d[:, 0] = width - 1.0 - keypoint2d[:, 0]
    return image, keypoint2d


def affine(image: Image.Image, angle, shear_x, shear_y, trans_x, trans_y, scale,
           keypoint2d):
    """Image + keypoint affine; returns (image, keypoints, aug_param (6,))."""
    image = pil_affine(image, angle, translate=[trans_x, trans_y],
                       shear=[shear_x, shear_y], scale=scale)
    aug_param = np.array([-angle, -trans_x, -trans_y, -shear_x, -shear_y, 1.0 / scale],
                         np.float32)

    rad = np.deg2rad(angle)
    sx = np.deg2rad(shear_x)
    sy = np.deg2rad(shear_y)
    keypoint2d = np.copy(keypoint2d)
    a = np.cos(rad - sy) / np.cos(sy)
    b = -np.cos(rad - sy) * np.tan(sx) / np.cos(sy) - np.sin(rad)
    c = np.sin(rad - sy) / np.cos(sy)
    d = -np.sin(rad - sy) * np.tan(sx) / np.cos(sy) + np.cos(rad)
    rotation_matrix = np.array([[scale * a, scale * b], [scale * c, scale * d]])

    width, height = image.size
    keypoint2d[:, 0] -= width / 2
    keypoint2d[:, 1] -= height / 2
    keypoint2d = np.matmul(rotation_matrix, keypoint2d.T).T
    keypoint2d[:, 0] += width / 2 + trans_x
    keypoint2d[:, 1] += height / 2 + trans_y
    return image, keypoint2d, aug_param


# ---------------------------------------------------------------------------
# composable transforms (kwargs-threading protocol)
# ---------------------------------------------------------------------------

class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, image, **kwargs):
        for t in self.transforms:
            image, kwargs = t(image, **kwargs)
        return image, kwargs


class ToTensor:
    """PIL -> HWC float32 [0,1] numpy (the batch's NHWC layout)."""

    def __call__(self, image, **kwargs):
        # torchvision ToTensor divides by 255 based on the SOURCE dtype, not
        # the value range (an almost-black uint8 image must still be scaled)
        src = np.asarray(image)
        arr = src.astype(np.float32)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if src.dtype == np.uint8:
            arr = arr / 255.0
        return arr, kwargs


class Normalize:
    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, image, **kwargs):
        image = (np.asarray(image, np.float32) - self.mean) / self.std
        return image, kwargs


class ColorJitter:
    """Brightness/contrast/saturation jitter with torchvision draw semantics
    (uniform factor in [max(0,1-v), 1+v], random op order)."""

    def __init__(self, brightness=0, contrast=0, saturation=0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation

    @staticmethod
    def _factor(v):
        return random.uniform(max(0.0, 1.0 - v), 1.0 + v)

    def __call__(self, image, **kwargs):
        ops = []
        if self.brightness:
            f = self._factor(self.brightness)
            ops.append(lambda im, f=f: ImageEnhance.Brightness(im).enhance(f))
        if self.contrast:
            f = self._factor(self.contrast)
            ops.append(lambda im, f=f: ImageEnhance.Contrast(im).enhance(f))
        if self.saturation:
            f = self._factor(self.saturation)
            ops.append(lambda im, f=f: ImageEnhance.Color(im).enhance(f))
        random.shuffle(ops)
        for op in ops:
            image = op(image)
        return image, kwargs


class GaussianBlur:
    def __init__(self, low=0, high=0.8):
        self.low = low
        self.high = high

    def __call__(self, image, **kwargs):
        radius = np.random.uniform(low=self.low, high=self.high)
        image = image.filter(ImageFilter.GaussianBlur(radius))
        return image, kwargs


class Resize:
    def __init__(self, size, interpolation=Image.BILINEAR):
        assert isinstance(size, int)
        self.size = size
        self.interpolation = interpolation

    def __call__(self, image, keypoint2d, intrinsic_matrix=None, **kwargs):
        image, keypoint2d, intrinsic_matrix = resize(
            image, self.size, self.interpolation, keypoint2d, intrinsic_matrix)
        kwargs.update(keypoint2d=keypoint2d, intrinsic_matrix=intrinsic_matrix)
        return image, kwargs


def _pair(v, symmetric: bool):
    """A number ``v`` as (-v, v) (``symmetric``) or (v, v); a pair as given."""
    if isinstance(v, numbers.Number):
        return (-v, v) if symmetric else (v, v)
    return v


class RandomAffineRotation:
    """Random affine (angle/shear/translate/scale) storing the inverse
    ``aug_param``."""

    def __init__(self, degrees, shear, translate, scale):
        if isinstance(degrees, numbers.Number) and degrees < 0:
            raise ValueError("If degrees is a single number, it must be positive.")
        self.degrees = _pair(degrees, True)
        self.shear = _pair(shear, True)
        self.translate = _pair(translate, False)
        self.scale = _pair(scale, False)

    @staticmethod
    def get_params(degrees, shears, translate, scale, img_size):
        angle = random.uniform(degrees[0], degrees[1])
        shear_x = shear_y = 0.0
        shear_x = random.uniform(shears[0], shears[1])
        if len(shears) == 4:
            shear_y = random.uniform(shears[2], shears[3])
        max_dx = float(translate[0] * img_size[0])
        max_dy = float(translate[1] * img_size[1])
        trans_x = int(round(random.uniform(-max_dx, max_dx)))
        trans_y = int(round(random.uniform(-max_dy, max_dy)))
        scale = random.uniform(scale[0], scale[1])
        return angle, shear_x, shear_y, trans_x, trans_y, scale

    def __call__(self, image, keypoint2d, **kwargs):
        params = self.get_params(self.degrees, self.shear, self.translate,
                                 self.scale, image.size)
        angle, shear_x, shear_y, trans_x, trans_y, scale = params
        image, keypoint2d, aug_param = affine(image, angle, shear_x, shear_y,
                                              trans_x, trans_y, scale, keypoint2d)
        kwargs["aug_param"] = aug_param
        kwargs.update(keypoint2d=keypoint2d)
        return image, kwargs


class RandomResizedCrop:
    """Square random crop (aspect 1) + resize (reference :456-522)."""

    def __init__(self, size, scale=(0.6, 1.3), interpolation=Image.BILINEAR):
        self.size = size
        if scale[0] > scale[1]:
            warnings.warn("range should be of kind (min, max)")
        self.interpolation = interpolation
        self.scale = scale

    @staticmethod
    def get_params(img, scale):
        width, height = img.size
        area = height * width
        for _ in range(10):
            target_area = random.uniform(*scale) * area
            aspect_ratio = 1
            w = int(round(math.sqrt(target_area * aspect_ratio)))
            h = int(round(math.sqrt(target_area / aspect_ratio)))
            if 0 < w <= width and 0 < h <= height:
                i = random.randint(0, height - h)
                j = random.randint(0, width - w)
                return i, j, h, w
        return 0, 0, height, width

    def __call__(self, image, keypoint2d, intrinsic_matrix=None, **kwargs):
        i, j, h, w = self.get_params(image, self.scale)
        image, keypoint2d, intrinsic_matrix = resized_crop(
            image, i, j, h, w, self.size, self.interpolation, keypoint2d, intrinsic_matrix)
        kwargs.update(keypoint2d=keypoint2d, intrinsic_matrix=intrinsic_matrix)
        return image, kwargs
