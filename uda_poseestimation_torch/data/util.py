"""Host-side (numpy) dataset numerics.

The port's copy of ``uda_poseestimation_tpu/data/util.py`` (reference
lib/datasets/util.py). For the human datasets: ``generate_target`` (:12-70,
the reference's paste-window math), ``keypoint2d_to_3d``, ``scale_box``,
``get_bounding_box``, ``area`` and ``intersection``, and two helpers that
their copies share, ``normalize_3d`` and ``mean_teacher_item`` (the 8-tuple
of the ``*_mt`` datasets that carry 3D keypoints). For the animal datasets
(the Stacked-Hourglass helpers of the reference): ``im_to_float``,
``fliplr``, ``shufflelr_ori`` and its ``FLIP_PAIRS``, ``get_transform``,
``transform``, ``crop_ori`` with the ``scipy.misc`` stand-ins ``imresize``
and ``imrotate`` (PIL after a min-max ``_bytescale``, a per-crop contrast
stretch of float input kept for parity), ``color_normalize``,
``draw_labelmap_ori`` (Gaussian and Cauchy; visibility is zeroed when the
3-sigma window crosses the map's edge) and ``load_image_ori``; and
``FrameCache``, the frame cache of ``--decode-cache``. Every result equals
the JAX package's bit for bit.
"""

from __future__ import annotations

import mmap
import multiprocessing

import numpy as np
from PIL import Image


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


# ---------------------------------------------------------------------------
# the animal datasets' helpers (reference util.py:137-368)
# ---------------------------------------------------------------------------

def im_to_float(img):
    """HWC uint8/float -> HWC float32 in [0, 1] (im_to_torch minus layout)."""
    img = np.asarray(img, np.float32)
    if img.max() > 1:
        img = img / 255.0
    return img


def fliplr(x):
    """Horizontal flip of HWC (or NHWC) float image(s)."""
    return np.ascontiguousarray(x[..., :, ::-1, :]).astype(np.float32) \
        if x.ndim >= 3 else np.ascontiguousarray(np.fliplr(x))


FLIP_PAIRS = {
    "mpii": ([0, 5], [1, 4], [2, 3], [10, 15], [11, 14], [12, 13]),
    "real_animal": ([0, 1], [3, 4], [5, 6], [8, 9], [10, 11], [12, 13],
                    [14, 15], [16, 17]),
    "animal_pose": ([0, 1], [2, 3], [4, 5], [6, 7], [8, 9], [10, 11], [12, 13]),
}


def shufflelr_ori(x, width, dataset):
    """Flip keypoint x-coords and swap left/right pairs (util.py:186-224)."""
    x = np.array(x, np.float32, copy=True)
    x[:, 0] = width - x[:, 0]
    for a, b in FLIP_PAIRS[dataset]:
        tmp = x[a].copy()
        x[a] = x[b]
        x[b] = tmp
    return x


def get_transform(center, scale, res, rot=0):
    """MPII center/scale(200px)/rot pixel-map matrix (util.py:289-316)."""
    h = 200 * scale
    t = np.zeros((3, 3))
    t[0, 0] = float(res[1]) / h
    t[1, 1] = float(res[0]) / h
    t[0, 2] = res[1] * (-float(center[0]) / h + 0.5)
    t[1, 2] = res[0] * (-float(center[1]) / h + 0.5)
    t[2, 2] = 1
    if rot != 0:
        rot = -rot
        rot_mat = np.zeros((3, 3))
        rot_rad = rot * np.pi / 180
        sn, cs = np.sin(rot_rad), np.cos(rot_rad)
        rot_mat[0, :2] = [cs, -sn]
        rot_mat[1, :2] = [sn, cs]
        rot_mat[2, 2] = 1
        t_mat = np.eye(3)
        t_mat[0, 2] = -res[1] / 2
        t_mat[1, 2] = -res[0] / 2
        t_inv = t_mat.copy()
        t_inv[:2, 2] *= -1
        t = np.dot(t_inv, np.dot(rot_mat, np.dot(t_mat, t)))
    return t


def transform(pt, center, scale, res, invert=0, rot=0):
    """Map a pixel between the original and the crop frame (util.py:226-233)."""
    t = get_transform(center, scale, res, rot=rot)
    if invert:
        t = np.linalg.inv(t)
    new_pt = np.array([pt[0] - 1, pt[1] - 1, 1.0]).T
    new_pt = np.dot(t, new_pt)
    return new_pt[:2].astype(int) + 1


def _bytescale(data):
    """scipy.misc.bytescale with defaults: min-max stretch to [0, 255] uint8."""
    data = np.asarray(data)
    if data.dtype == np.uint8:
        return data
    cmin = float(data.min())
    cmax = float(data.max())
    cscale = cmax - cmin
    if cscale == 0:
        cscale = 1
    scale = 255.0 / cscale
    bytedata = (data - cmin) * scale
    return (bytedata.clip(0, 255) + 0.5).astype(np.uint8)


_RESAMPLE = {"nearest": Image.NEAREST, "bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC}


def imresize(arr, size, interp="bilinear"):
    """scipy.misc.imresize: bytescale, then a PIL resize to ``size`` (H, W);
    returns uint8 HWC."""
    arr = np.asarray(arr)
    if arr.ndim == 3:
        img = Image.fromarray(_bytescale(arr), mode="RGB" if arr.shape[2] == 3 else None)
    else:
        img = Image.fromarray(_bytescale(arr), mode="L")
    img = img.resize((int(size[1]), int(size[0])), _RESAMPLE[interp])
    return np.asarray(img)


def imrotate(arr, angle, interp="bilinear"):
    """scipy.misc.imrotate: bytescale, then a PIL rotate (no expand)."""
    img = Image.fromarray(_bytescale(np.asarray(arr)))
    return np.asarray(img.rotate(angle, _RESAMPLE[interp]))


def crop_ori(img, center, scale, res, rot=0):
    """Center/scale crop with the reference's resampling (util.py:235-287):
    HWC float [0, 1] in, HWC float32 [0, 1] of shape ``res`` out."""
    img = np.asarray(img, np.float32)
    ht, wd = img.shape[0], img.shape[1]
    sf = scale * 200.0 / res[0]
    if sf < 2:
        sf = 1
    else:
        new_size = int(np.floor(max(ht, wd) / sf))
        new_ht = int(np.floor(ht / sf))
        new_wd = int(np.floor(wd / sf))
        if new_size < 2:
            return np.zeros((res[0], res[1], img.shape[2]) if img.ndim > 2
                            else (res[0], res[1]), np.float32)
        img = imresize(img, [new_ht, new_wd])
        center = np.asarray(center) * 1.0 / sf
        scale = scale / sf

    ul = np.array(transform([0, 0], center, scale, res, invert=1))
    br = np.array(transform(res, center, scale, res, invert=1))

    pad = int(np.linalg.norm(br - ul) / 2 - float(br[1] - ul[1]) / 2)
    if rot != 0:
        ul -= pad
        br += pad

    new_shape = [br[1] - ul[1], br[0] - ul[0]]
    if img.ndim > 2:
        new_shape += [img.shape[2]]
    new_img = np.zeros(new_shape, dtype=img.dtype)

    new_x = max(0, -ul[0]), min(br[0], img.shape[1]) - ul[0]
    new_y = max(0, -ul[1]), min(br[1], img.shape[0]) - ul[1]
    old_x = max(0, ul[0]), min(img.shape[1], br[0])
    old_y = max(0, ul[1]), min(img.shape[0], br[1])
    new_img[new_y[0]:new_y[1], new_x[0]:new_x[1]] = img[old_y[0]:old_y[1], old_x[0]:old_x[1]]

    if rot != 0:
        new_img = imrotate(new_img, rot)
        new_img = new_img[pad:-pad, pad:-pad]

    return im_to_float(imresize(new_img, res))


def color_normalize(x, mean, std=None):
    """Subtract the per-channel mean (the reference never divides by std;
    util.py:318-324). HWC."""
    x = np.asarray(x, np.float32)
    if x.ndim == 2 or (x.ndim == 3 and x.shape[2] == 1):
        x = np.repeat(np.atleast_3d(x), 3, axis=2)
    return x - np.asarray(mean, np.float32)[None, None, :]


def draw_labelmap_ori(img, pt, sigma, label_type="Gaussian"):
    """One Gaussian or Cauchy peak drawn onto an (H, W) map; returns (map,
    visibility bit), the bit 0 when the 3-sigma window crosses the map's
    edge (util.py:326-363)."""
    img = np.asarray(img, np.float32).copy()
    pt = np.asarray(pt).astype(np.int32)
    ul = [int(pt[0] - 3 * sigma), int(pt[1] - 3 * sigma)]
    br = [int(pt[0] + 3 * sigma + 1), int(pt[1] + 3 * sigma + 1)]
    if br[0] >= img.shape[1] or br[1] >= img.shape[0] or ul[0] < 0 or ul[1] < 0:
        return img, 0

    size = 6 * sigma + 1
    x = np.arange(0, size, 1, float)
    y = x[:, np.newaxis]
    x0 = y0 = size // 2
    if label_type == "Gaussian":
        g = np.exp(-((x - x0) ** 2 + (y - y0) ** 2) / (2 * sigma ** 2))
    else:  # Cauchy
        g = sigma / (((x - x0) ** 2 + (y - y0) ** 2 + sigma ** 2) ** 1.5)

    g_x = max(0, -ul[0]), min(br[0], img.shape[1]) - ul[0]
    g_y = max(0, -ul[1]), min(br[1], img.shape[0]) - ul[1]
    img_x = max(0, ul[0]), min(br[0], img.shape[1])
    img_y = max(0, ul[1]), min(br[1], img.shape[0])
    img[img_y[0]:img_y[1], img_x[0]:img_x[1]] = g[g_y[0]:g_y[1], g_x[0]:g_x[1]]
    return img, 1


def load_image_ori(img_path):
    """An RGB image as HWC float32 in [0, 1] (util.py:365-368 minus layout)."""
    with Image.open(img_path) as im:
        return im_to_float(np.asarray(im.convert("RGB")))


# ---------------------------------------------------------------------------
# --decode-cache's frame cache
# ---------------------------------------------------------------------------

class FrameArena:
    """The shared memory of ``--decode-cache``: ``max_bytes`` of anonymous
    shared mapping, its fill level and one lock, which forked loader
    workers inherit. A trainer makes one and gives it to every dataset of
    its run (``frame_arena=``), so the run's frames share one budget."""

    def __init__(self, max_bytes: float):
        self.max_bytes = int(max_bytes)
        self.data = mmap.mmap(-1, max(self.max_bytes, 1))  # pages committed as written
        self._used_map = mmap.mmap(-1, 8)
        self.used = np.frombuffer(self._used_map, dtype=np.int64)
        self.lock = multiprocessing.get_context("fork").Lock()


# a key's row in a cache's table: (offset in the arena, bytes, h, w,
# channels); after the rows, the cache's counters
_NBYTES, _ROW = 1, 5
_HITS, _MISSES, _ITEMS, _COUNTERS = range(4)


class FrameCache:
    """The decoded-frame cache of the animal datasets (``--decode-cache``).

    Training revisits the same frames every epoch, and the PIL decode is
    most of an item's time. Frames are stored as uint8: the round trip
    uint8 -> /255 is exact for a PIL-decoded image, so a cached load is bit
    for bit a fresh one. ``max_bytes <= 0`` disables the cache (the
    reference relies on the OS page cache).

    The JAX package's cache is a dict that its loader's threads share. The
    port's loader forks worker processes, so a dict would fill once per
    worker. Here the frames go to shared memory mapped before the fork: an
    ``arena`` (a ``FrameArena``, the trainer's for the whole run, else one
    of ``max_bytes`` for this cache alone), and a table per cache of where
    each of its ``keys`` (the dataset's frame paths, known when it is
    built) lies. A frame decoded by any worker is a hit for every process
    after it, and the arena's budget bounds the frames of every cache that
    fills it, not each worker's. A frame that no longer fits, or whose path
    is not a key, loads uncached. ``hits``, ``misses``, ``items_cached``
    (this cache's) and ``bytes_used`` (the arena's) count over all
    processes. Needs the fork start method: shared memory cannot be pickled.
    """

    def __init__(self, max_bytes: float = 0.0, keys=(), arena: FrameArena = None):
        self.max_bytes = float(max_bytes or 0)
        self._rows, self._table = {}, None
        if self.max_bytes <= 0:
            return
        self._rows = {key: i for i, key in enumerate(dict.fromkeys(keys))}
        self._arena = arena if arena is not None else FrameArena(self.max_bytes)
        self._table_map = mmap.mmap(-1, (_ROW * len(self._rows) + _COUNTERS) * 8)
        self._table = np.frombuffer(self._table_map, dtype=np.int64)

    def _counter(self, which: int) -> int:
        return 0 if self._table is None else int(self._table[_ROW * len(self._rows) + which])

    @property
    def hits(self) -> int:
        return self._counter(_HITS)

    @property
    def misses(self) -> int:
        return self._counter(_MISSES)

    @property
    def items_cached(self) -> int:
        return self._counter(_ITEMS)

    @property
    def bytes_used(self) -> int:
        return 0 if self._table is None else int(self._arena.used[0])

    def _get(self, path):
        """The cached uint8 frame of ``path``, or None (a miss)."""
        row = self._rows.get(path)
        if row is None:
            return None
        t, c = self._table, _ROW * len(self._rows)
        with self._arena.lock:
            offset, nbytes, h, w, ch = (int(v) for v in t[_ROW * row:_ROW * (row + 1)])
            t[c + (_HITS if nbytes else _MISSES)] += 1
        if not nbytes:
            return None
        return np.frombuffer(self._arena.data, dtype=np.uint8, count=nbytes,
                             offset=offset).reshape((h, w, ch) if ch else (h, w)).copy()

    def _put(self, path, u8):
        row = self._rows.get(path)
        if row is None:
            return
        u8 = np.ascontiguousarray(u8, dtype=np.uint8)
        shape = u8.shape if u8.ndim == 3 else u8.shape + (0,)  # 0: a 2-D frame
        t, arena = self._table, self._arena
        with arena.lock:
            used = int(arena.used[0])
            if t[_ROW * row + _NBYTES] or used + u8.nbytes > arena.max_bytes:
                return
            arena.data[used:used + u8.nbytes] = u8.tobytes()
            t[_ROW * row:_ROW * (row + 1)] = (used, u8.nbytes, *shape)
            arena.used[0] = used + u8.nbytes
            t[_ROW * len(self._rows) + _ITEMS] += 1

    def load(self, path):
        """``load_image_ori(path)``, cached."""
        if self.max_bytes <= 0:
            return load_image_ori(path)
        hit = self._get(path)
        if hit is not None:
            return hit.astype(np.float32) / 255.0
        img = load_image_ori(path)
        self._put(path, np.round(img * 255.0).astype(np.uint8))
        return img

    def load_u8(self, path, decode_fn):
        """``decode_fn(path)``, a uint8 HWC frame, cached."""
        if self.max_bytes <= 0:
            return decode_fn(path)
        hit = self._get(path)
        if hit is not None:
            return hit
        u8 = decode_fn(path)
        self._put(path, u8)
        return u8
