"""Fake datasets and random style weights for the port's drives.

The twin of the repository's ``tools/make_fixtures.py``: the same RHD and
animal trees, byte for byte from the same seeds (PNG and JPEG frames,
annotation pickles, JSON, ``.mat`` and ``.npy`` files; a ``.mat`` header's
time of writing aside), and random StyleNet weights in the reference's
state-dict files, made with the port's ``StyleNet``. No file is downloaded.

    python -m uda_poseestimation_torch.tools.fixtures rhd DIR
    python -m uda_poseestimation_torch.tools.fixtures rhd_shifted DIR
    python -m uda_poseestimation_torch.tools.fixtures rhd_shifted_hard DIR
    python -m uda_poseestimation_torch.tools.fixtures animal DIR
    python -m uda_poseestimation_torch.tools.fixtures style [DIR]

An RHD tree mirrors the layout that ``data/rendered_hand_pose.py`` reads:
``RHD_published_v2/{training,evaluation}/color/*.png`` and
``anno_*.pickle`` with ``uv_vis``, ``xyz`` and ``K``. Each frame carries a
bright Gaussian blob at each keypoint, so that a short run can learn.
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np
from PIL import Image


def _shift_domain(img, xx, yy):
    """Strong appearance shift with the geometry kept, the fixture's twin of
    a synthetic-to-real gap: a gamma curve, a contrast squeeze, a color cast
    and a stripe texture. The blobs keep their places and channels, so the
    task is unchanged; only the image statistics move."""
    img = img ** 1.7                                   # gamma
    img = 0.28 + 0.5 * img                             # contrast squeeze
    img = img + np.array([0.13, -0.07, 0.05], np.float32)  # color cast
    img = img + 0.10 * np.sin((xx + 0.5 * yy) / 9.0)[..., None]  # texture
    return img


def _shift_domain_hard(img, xx, yy):
    """The harder shift (``rhd_shifted_hard``): a multiplicative texture in
    two orientations over the global curves. It lies outside the span of
    the trainer's ColorJitter, which rescales blob and background together;
    ``make_rhd(shift="hard")`` also dims and widens the blobs."""
    img = img ** 1.5                                   # gamma
    img = 0.24 + 0.6 * img                             # contrast squeeze
    img = img + np.array([0.10, -0.06, 0.04], np.float32)  # color cast
    tex = (0.62 + 0.38 * np.sin((xx + 0.5 * yy) / 7.0)
           * np.sin((yy - 0.7 * xx) / 11.0))
    return img * tex[..., None]                        # local modulation


def make_rhd(root, n_train=96, n_eval=16, size=320, shift=False):
    """A fake RHD tree under ``root``: ``shift`` False (clean), True (the
    shifted target, ``_shift_domain``) or "hard" (``_shift_domain_hard``
    over dimmer, broader blobs on a busier background). A shifted tree
    draws its keypoints from another seed, so it is not image-paired with
    the clean one."""
    base = os.path.join(root, "RHD_published_v2")
    for set_name, n, seed in (("training", n_train, 0), ("evaluation", n_eval, 1)):
        color = os.path.join(base, set_name, "color")
        mask = os.path.join(base, set_name, "mask")
        os.makedirs(color, exist_ok=True)
        os.makedirs(mask, exist_ok=True)
        rng = np.random.RandomState(seed + (10 if shift else 0))
        anno = {}
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
        # "hard" also changes the object's appearance: an SNR reduction
        # that no global jitter can mimic
        amp, sig, bg = (0.62, 8.0, 0.34) if shift == "hard" else (1.0, 6.0, 0.15)
        for i in range(n):
            kp = rng.uniform(60, size - 60, (21, 2)).astype(np.float32)
            img = rng.rand(size, size, 3).astype(np.float32) * bg
            for j in range(21):
                g = np.exp(-((xx - kp[j, 0]) ** 2 + (yy - kp[j, 1]) ** 2) / (2 * sig ** 2))
                img[..., j % 3] += amp * g
            if shift == "hard":
                img = _shift_domain_hard(img, xx, yy)
            elif shift:
                img = _shift_domain(img, xx, yy)
            img = np.clip(img, 0, 1)
            Image.fromarray((img * 255).astype(np.uint8)).save(
                os.path.join(color, "%.5d.png" % i))
            uv = np.zeros((42, 3))
            uv[:21, :2] = kp
            uv[:21, 2] = 1
            uv[21:, :2] = 5.0  # the right hand far away and invisible
            anno[i] = {
                "uv_vis": uv,
                "xyz": rng.rand(42, 3) + 1.0,
                "K": np.array([[320.0, 0, 160], [0, 320.0, 160], [0, 0, 1]]),
            }
        with open(os.path.join(base, set_name, "anno_%s.pickle" % set_name), "wb") as f:
            pickle.dump(anno, f)
    print("fake RHD at", root)


def _blob_frame(rng, h, w, kp, bg, sigma):
    """A (h, w) RGB frame: uniform noise times ``bg`` plus a Gaussian blob of
    ``sigma`` at each keypoint, in channel ``j % 3``, as uint8."""
    img = rng.rand(h, w, 3).astype(np.float32) * bg
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for j in range(len(kp)):
        g = np.exp(-((xx - kp[j, 0]) ** 2 + (yy - kp[j, 1]) ** 2) / (2 * sigma ** 2))
        img[..., j % 3] += g
    return Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))


def make_animal(root, n_per_animal=8, frames_per_shot=4):
    """Fake synthetic-animal (source) and TigDog (target) trees for horse and
    tiger, byte-equal to the repository's ``tools/make_fixtures.make_animal``
    from the same seed:

        <root>/animal_data/synthetic_animal/<animal>_combineds5r5_texture/*.png
        <root>/animal_data/clean_data/keypoints_18.json
        <root>/animal_data/behaviorDiscovery2.0/{ranges,landmarks,<animal>}/...
        <root>/cached_data/...   (set UDA_CACHED_DATA_DIR to it)

    scipy writes the TigDog ``.mat`` files (its header holds the time of
    writing); torch writes the ``mean.pth.tar`` statistics."""
    import json

    import torch
    from scipy.io import savemat

    data_dir = os.path.join(root, "animal_data")
    cached = os.path.join(root, "cached_data")
    rng = np.random.RandomState(0)

    # the synthetic source: 640x480 renders, 18 keypoints a frame
    data = {}
    for animal in ("horse", "tiger"):
        img_dir = os.path.join(data_dir, "synthetic_animal", f"{animal}_combineds5r5_texture")
        os.makedirs(img_dir, exist_ok=True)
        imgpaths, kpts_all, bbox_all = [], [], []
        for i in range(n_per_animal):
            p = os.path.join(img_dir, f"{i:04d}_img.png")
            kp = np.concatenate([rng.uniform(150, 500, (18, 1)), rng.uniform(100, 380, (18, 1)),
                                 np.ones((18, 1))], axis=1)
            _blob_frame(rng, 480, 640, kp, 0.2, 8.0).save(p)
            imgpaths.append(os.path.relpath(p, root))
            kpts_all.append(kp.tolist())
            bbox_all.append([float(kp[:, 0].min()), float(kp[:, 0].max()),
                             float(kp[:, 1].min()), float(kp[:, 1].max())])
        n_train = max(2, int(n_per_animal * 0.75))
        data[animal] = {"keypoints": kpts_all, "imgpath": imgpaths, "bbox": bbox_all,
                        "train_idxs": list(range(n_train)),
                        "valid_idxs": list(range(n_train, n_per_animal))}
        cdir = os.path.join(cached, "synthetic_animal", f"{animal}_combineds5r5_texture")
        os.makedirs(cdir, exist_ok=True)
        torch.save({"mean": torch.tensor([0.4, 0.39, 0.38]),
                    "std": torch.tensor([0.25, 0.24, 0.23])},
                   os.path.join(cdir, "mean.pth.tar"))
    alldir = os.path.join(cached, "synthetic_animal", "all_combineds5r5_texture")
    os.makedirs(alldir, exist_ok=True)
    torch.save({"mean": torch.tensor([0.3999, 0.3909, 0.3871]),
                "std": torch.tensor([0.2589, 0.2431, 0.2291])},
               os.path.join(alldir, "mean.pth.tar"))
    os.makedirs(os.path.join(data_dir, "clean_data"), exist_ok=True)
    with open(os.path.join(data_dir, "clean_data", "keypoints_18.json"), "w") as f:
        json.dump(data, f)

    # the TigDog target: two shots of 320x240 frames an animal
    for animal in ("horse", "tiger"):
        rdir = os.path.join(data_dir, "behaviorDiscovery2.0", "ranges", animal)
        ldir = os.path.join(data_dir, "behaviorDiscovery2.0", "landmarks", animal)
        idir = os.path.join(data_dir, "behaviorDiscovery2.0", animal)
        for d in (rdir, ldir, idir):
            os.makedirs(d, exist_ok=True)
        ranges, frame = [], 1
        for shot in (1, 2):
            ranges.append([shot, frame, frame + frames_per_shot - 1])
            cells = np.empty((frames_per_shot, 1), dtype=object)
            for fi in range(frames_per_shot):
                kp = np.concatenate([rng.uniform(60, 260, (18, 1)),
                                     rng.uniform(40, 200, (18, 1))], axis=1)
                name = "%08d.jpg" % frame
                _blob_frame(rng, 240, 320, kp, 0.2, 6.0).save(os.path.join(idir, name))
                rec = np.zeros((1, 1), dtype=[("coord", "O"), ("vis", "O")])
                rec[0, 0]["coord"] = kp
                rec[0, 0]["vis"] = np.ones((18, 1))
                cells[fi, 0] = rec
                frame += 1
            savemat(os.path.join(ldir, f"{shot}.mat"), {"landmarks": cells})
        savemat(os.path.join(rdir, "ranges.mat"), {"ranges": np.asarray(ranges, np.int64)})
        n_frames = 2 * frames_per_shot
        cdir = os.path.join(cached, "real_animal", animal)
        os.makedirs(cdir, exist_ok=True)
        idxs = rng.permutation(n_frames)
        np.save(os.path.join(cdir, "train_idxs_by_video.npy"),
                np.sort(idxs[: n_frames * 3 // 4]))
        np.save(os.path.join(cdir, "valid_idxs_by_video.npy"),
                np.sort(idxs[n_frames * 3 // 4:]))
    print("fake animal data at", root, "(set UDA_CACHED_DATA_DIR=%s)" % cached)


# the seed of the random style weights
STYLE_SEED = 1


def make_style_weights(out_dir="saved_models"):
    """Random StyleNet weights (lecun-normal kernels, zero biases, drawn from
    a ``torch.Generator`` seeded STYLE_SEED) in the reference's files:
    ``vgg_normalised.pth`` and ``decoder_rand.pth``, enough to drive
    ``--decoder-name <out_dir>/decoder_rand.pth``."""
    import torch

    from ..models import StyleNet

    style = StyleNet()
    style.reset_parameters(torch.Generator().manual_seed(STYLE_SEED))
    os.makedirs(out_dir, exist_ok=True)
    torch.save(style.encoder.state_dict(), os.path.join(out_dir, "vgg_normalised.pth"))
    torch.save(style.decoder.state_dict(), os.path.join(out_dir, "decoder_rand.pth"))
    print("random style-net weights at", out_dir)


_RHD_KINDS = {"rhd": False, "rhd_shifted": True, "rhd_shifted_hard": "hard"}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    kind = argv[0] if argv else "rhd"
    if kind == "style":
        make_style_weights(argv[1] if len(argv) > 1 else "saved_models")
    elif kind == "animal":
        if len(argv) < 2:
            raise SystemExit("usage: fixtures animal DIR")
        make_animal(argv[1])
    elif kind in _RHD_KINDS:
        if len(argv) < 2:
            raise SystemExit(f"usage: fixtures {kind} DIR")
        make_rhd(argv[1], shift=_RHD_KINDS[kind])
    else:
        raise SystemExit(f"unknown fixture kind {kind}: "
                         f"{', '.join([*_RHD_KINDS, 'animal', 'style'])}")


if __name__ == "__main__":
    main()
