"""Export a trained PoseResNet to a portable serving artifact (``torch.export``).

The twin of the repository's ``tools/export_inference.py``. ``export_model``
traces the inference module -- images -> heatmaps plus the argmax decode
(``ops.heatmap.get_max_preds``, the reference's ``utils.get_max_preds``,
utils.py:54-75) -- with ``torch.export`` and a named dynamic batch, and
``save_artifact`` writes the ``ExportedProgram`` with the weights inside it.
A serving process loads and calls it with ``torch`` alone: no model code, no
checkpoint parsing, no import of this package.

The artifact holds a program for one device type, the one it was exported
on: the bf16 model's autocast region records its device type, so a CPU
artifact moved to the card would run its convolutions in float32. Its
metadata records that type, and ``load_artifact`` raises for another one.

    python -m uda_poseestimation_torch.tools.export_inference CKPT OUT.pt2 \\
        [--arch pose_resnet101] [--num-keypoints 21] [--image-size 256] \\
        [--which teacher] [--device cuda|cpu] [--selfcheck]

Serving side (the artifact's own device type; images (B, S, S, 3) float32):

    import torch
    program = torch.export.load("OUT.pt2").module()
    heatmaps, preds, maxvals = program(images)
"""

from __future__ import annotations

import argparse
import json
import os
import time
import zipfile
from typing import Any, Dict

import numpy as np
import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from .. import models
from ..device import DeviceLike, resolve_device
from ..ops.heatmap import get_max_preds
from ..utils.checkpoint import filtered_update, load_checkpoint

# the artifact's metadata file (``extra_files`` of ``torch.export.save``)
META_FILE = "uda_poseestimation_meta.json"
FORMAT = "uda_poseestimation_torch.export/1"
# the selfcheck's rules (tools/export_inference.py:147-161): float32 and
# bf16 tolerances on the heatmaps, and the top-2 margin above which the
# artifact's argmax must equal the direct forward's
TOLERANCES = {torch.float32: dict(rtol=0.0, atol=1e-5, margin=2e-5),
              torch.bfloat16: dict(rtol=2e-2, atol=4e-3, margin=8e-3)}


class InferenceModel(nn.Module):
    """images (B, S, S, 3) float32 NHWC -> heatmaps (B, K, S/4, S/4) float32
    (a four-stage backbone's), preds (B, K, 2) and maxvals (B, K, 1): the
    JAX artifact's contract (``build_inference_fn``), preds zeroed where
    maxval <= 0."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images):
        heatmaps = self.model(images.permute(0, 3, 1, 2))  # float32 in any dtype
        preds, maxvals = get_max_preds(heatmaps)
        return heatmaps, preds, maxvals


def export_model(model: nn.Module, image_size: int, device: DeviceLike = None):
    """``torch.export`` a PoseResNet's ``InferenceModel`` with the batch a
    named dynamic dimension ``b`` >= 1. The model is moved to ``device``,
    put in eval mode and frozen in place; its weights become part of the
    returned ``ExportedProgram``."""
    dev = resolve_device(device)
    inference = InferenceModel(model).to(dev).eval().requires_grad_(False)
    example = torch.zeros(2, image_size, image_size, 3, device=dev)
    batch = torch.export.Dim("b", min=1)
    return torch.export.export(inference, (example,), dynamic_shapes=({0: batch},))


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def artifact_meta(model: nn.Module, arch: str, image_size: int) -> Dict[str, Any]:
    """What an artifact of ``model`` records beside the device type."""
    return {"arch": arch, "num_keypoints": model.head.out_channels,
            "image_size": image_size, "dtype": dtype_name(model.dtype)}


def save_artifact(exported, path: str, meta: Dict[str, Any]) -> Dict[str, Any]:
    """Write ``exported`` to ``path`` with ``meta`` and the device its
    weights live on (the device type it was exported for). Returns the
    metadata written."""
    weight = next(iter(exported.state_dict.values()))
    meta = dict(meta, format=FORMAT, device_type=weight.device.type,
                device=str(weight.device))
    with open(path, "wb") as f:
        torch.export.save(exported, f, extra_files={META_FILE: json.dumps(meta)})
    return meta


def read_meta(path: str) -> Dict[str, Any]:
    """An artifact's metadata, read without loading its program."""
    with zipfile.ZipFile(path) as archive:
        names = [n for n in archive.namelist() if n.endswith("/extra/" + META_FILE)]
        if not names:
            raise ValueError(f"{path}: not an artifact of export_inference (no {META_FILE})")
        return json.loads(archive.read(names[0]))


def load_artifact(path: str, device: DeviceLike = None):
    """Load an artifact for ``device`` (None: the card). Returns the
    ``ExportedProgram`` and its metadata. Raises when the artifact was
    exported for another device type: it is never moved there."""
    dev = resolve_device(device)
    meta = read_meta(path)
    if meta["device_type"] != dev.type:
        raise ValueError(
            f"{path} was exported for {meta['device_type']} and cannot serve on "
            f"{dev.type}: its autocast region and device checks are "
            f"{meta['device_type']}'s. Export it again with --device {dev.type}")
    with open(path, "rb") as f:
        exported = torch.export.load(f)
    weight = next(iter(exported.state_dict.values()))
    if dev.index is not None and weight.device != dev:
        # another card of the same type: the program stays the same
        exported = torch.export.passes.move_to_device_pass(exported, dev)
    return exported, meta


def load_model(checkpoint: str, arch: str, num_keypoints: int, which: str = "teacher",
               dtype: torch.dtype = torch.bfloat16, device: DeviceLike = None):
    """A checkpoint of the port, the JAX package or the reference -> an
    eval-mode ``arch`` PoseResNet of ``dtype`` on ``device``, from the
    checkpoint's ``which`` entry, else its ``student``, else the file itself
    as a state dict, by the reference's key-filtered load. The unfused
    backbone, whatever ``UDA_BN_FUSE`` says."""
    model = getattr(models, arch)(num_keypoints=num_keypoints, dtype=dtype, fuse_bn=False)
    ckpt = load_checkpoint(checkpoint)
    entry = ckpt.get(which) or ckpt.get("student") or ckpt
    model.load_state_dict(filtered_update(model.state_dict(), entry))
    return model.to(resolve_device(device)).eval()


class _ConvolutionDtypes(TorchDispatchMode):
    """Records the input and weight dtypes of every convolution that runs,
    after autocast has cast them."""

    def __init__(self):
        super().__init__()
        self.dtypes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket is torch.ops.aten.convolution:
            self.dtypes.update((args[0].dtype, args[1].dtype))
        return func(*args, **(kwargs or {}))


def convolution_dtypes(fn, *args):
    """Call ``fn(*args)``; return its outputs and the set of dtypes its
    convolutions ran in."""
    with _ConvolutionDtypes() as mode:
        out = fn(*args)
    return out, mode.dtypes


def hold_outputs(got, want, dtype: torch.dtype) -> Dict[str, Any]:
    """Hold an artifact's outputs ``got`` (heatmaps, preds, maxvals) against
    a direct forward's ``want`` on the same images by the JAX selfcheck's
    rules for ``dtype``: heatmaps within its tolerance, preds equal wherever
    the direct forward's top-2 margin is decisive, and preds equal to the
    argmax decode of the artifact's own heatmaps. Raises on a failure;
    returns the counts."""
    hm, preds, _ = got
    ref_hm, ref_preds, _ = want
    with torch.no_grad():
        own_preds, _ = get_max_preds(hm)
    tol = TOLERANCES[dtype]
    hm, ref = hm.cpu().numpy(), ref_hm.cpu().numpy()
    np.testing.assert_allclose(hm, ref, rtol=tol["rtol"], atol=tol["atol"])
    # the argmax may flip where two peaks sit within the tolerance: require
    # equality only where the reference's top-2 margin exceeds it
    top2 = np.partition(ref.reshape(ref.shape[0], ref.shape[1], -1), -2, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > tol["margin"]
    eq = (preds == ref_preds).all(dim=-1).cpu().numpy()
    if (decisive & ~eq).any():
        raise AssertionError(f"exported preds disagree on {(decisive & ~eq).sum()} "
                             f"decisively-peaked keypoints")
    np.testing.assert_array_equal(preds.cpu().numpy(), own_preds.cpu().numpy())
    return {"heatmaps": tuple(hm.shape), "equal": float(eq.mean()),
            "decisive": int(decisive.sum()), "max_abs_err": float(np.abs(hm - ref).max())}


def selfcheck(path: str, inference: InferenceModel, image_size: int,
              device: DeviceLike = None) -> Dict[str, Any]:
    """Load the artifact at ``path`` and hold it against a direct forward of
    ``inference`` on random inputs (``hold_outputs``); its convolutions must
    run in the model's dtype. Raises on a failure; returns the counts."""
    dev = resolve_device(device)
    exported, _ = load_artifact(path, dev)
    dtype = inference.model.dtype
    x = torch.from_numpy(np.random.RandomState(0).rand(
        2, image_size, image_size, 3).astype(np.float32)).to(dev)
    with torch.no_grad():
        got, conv_dtypes = convolution_dtypes(exported.module(), x)
        want = inference(x)
    if conv_dtypes != {dtype}:
        raise AssertionError(f"the artifact's convolutions ran in {conv_dtypes}, "
                             f"the model computes in {dtype}")
    return dict(hold_outputs(got, want, dtype), convolution_dtype=dtype_name(dtype))


def main(argv=None) -> Dict[str, Any]:
    p = argparse.ArgumentParser(
        description="Export a PoseResNet checkpoint to a torch.export artifact")
    p.add_argument("checkpoint")
    p.add_argument("out")
    p.add_argument("--arch", default="pose_resnet101")
    p.add_argument("--num-keypoints", type=int, default=21)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--which", default="teacher", choices=["teacher", "student"],
                   help="which net to export (the reference validates the "
                        "teacher after the pretrain phase)")
    p.add_argument("--device", default=None,
                   help="the device type the artifact serves on (default: "
                        "the card; 'cpu' for a CPU canary)")
    p.add_argument("--selfcheck", action="store_true",
                   help="load the written artifact and compare it against a "
                        "direct forward on random inputs")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    model = load_model(args.checkpoint, args.arch, args.num_keypoints, args.which,
                       device=dev)
    t0 = time.perf_counter()
    exported = export_model(model, args.image_size, dev)
    export_s = time.perf_counter() - t0
    meta = save_artifact(exported, args.out,
                         artifact_meta(model, args.arch, args.image_size))
    size = os.path.getsize(args.out)
    print(f"exported {args.which} {args.arch} (K={args.num_keypoints}, "
          f"{args.image_size}px, device={meta['device_type']}, {meta['dtype']}) -> "
          f"{args.out} ({size / 1e6:.1f} MB, {export_s:.1f} s)", flush=True)
    out = {"meta": meta, "bytes": size, "export_s": export_s}

    if args.selfcheck:
        check = selfcheck(args.out, InferenceModel(model), args.image_size, dev)
        print(f"selfcheck ok: heatmaps {check['heatmaps']}, preds self-consistent, "
              f"{check['equal']:.1%} equal ({check['decisive']} decisive, all equal), "
              f"convolutions in {check['convolution_dtype']}", flush=True)
        out["selfcheck"] = check
    return out


if __name__ == "__main__":
    main()
