"""Checkpoints in the reference's layout, readable by both packages.

The reference saves ``{student, teacher, stu_optimizer, lr_scheduler, epoch,
args}`` as ``best_pt.pth`` / ``best.pth`` when the target's 'all' PCK
improves (train_human.py:226-237), with the student and teacher as
DataParallel (``module.``-prefixed) state dicts. ``save_checkpoint`` writes
that layout with ``torch.save``, plus a ``format`` tag; the optimizer entry
is the torch optimizer's ``state_dict()``, in a non-capturable optimizer's
layout whatever the optimizer (``_reference_layout``).

``load_checkpoint`` reads the port's files, the JAX package's (whose
student and teacher are the same ``module.`` state dicts, written by
``export_pose_resnet``, with no ``num_batches_tracked``) and the
reference's. It returns the student and teacher as plain state dicts of
tensors without the prefix. An optimizer state crosses only from the port
to the port: the JAX package's is an optax tree, which
``restore_train_state`` reports as incompatible and leaves the fresh
optimizer in place, as the JAX package does.

The files are pickles (``weights_only=False``: they hold numpy arrays and
the run's arguments); load only checkpoints that these programs wrote.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

FORMAT_TAG = "uda_poseestimation_torch"
_PREFIX = "module."


def _cpu(obj):
    """A copy of ``obj`` with every tensor detached and on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def _reference_layout(opt_sd: Dict[str, Any]) -> Dict[str, Any]:
    """An optimizer state dict as a non-capturable optimizer writes it: a
    bundled step's Adam on the card is ``capturable`` (its step counts live
    on the device; ``parallel.make_capturable``), which the file does not
    record, so it resumes into the unbundled path and the CPU as well. The
    step counts are on the CPU already (``_cpu``)."""
    for group in opt_sd.get("param_groups", ()):
        if group.get("capturable"):
            group["capturable"] = False
    return opt_sd


def save_checkpoint(path: str, payload: Dict[str, Any]):
    """``torch.save`` a checkpoint dict in the reference's layout.

    ``student`` / ``teacher`` may be modules or state dicts (saved
    ``module.``-prefixed), ``stu_optimizer`` an optimizer or its state dict,
    ``args`` a namespace or a dict (saved as a dict).
    """
    payload = dict(payload)
    for key in ("student", "teacher"):
        entry = payload.get(key)
        if entry is not None:
            sd = entry.state_dict() if isinstance(entry, nn.Module) else entry
            payload[key] = {_PREFIX + k: _cpu(v) for k, v in sd.items()}
    opt = payload.get("stu_optimizer")
    if isinstance(opt, torch.optim.Optimizer):
        payload["stu_optimizer"] = _reference_layout(_cpu(opt.state_dict()))
    if isinstance(payload.get("args"), argparse.Namespace):
        payload["args"] = dict(vars(payload["args"]))
    payload["format"] = FORMAT_TAG
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(payload, path)


def _unprefixed(sd: Mapping[str, Any]) -> Dict[str, Any]:
    if any(k.startswith(_PREFIX) for k in sd):
        return {k[len(_PREFIX):]: v for k, v in sd.items() if k.startswith(_PREFIX)}
    return dict(sd)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a checkpoint of the port, the JAX package or the reference."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if not isinstance(ckpt, dict):
        raise ValueError(f"{path}: not a checkpoint dict ({type(ckpt).__name__})")
    out = dict(ckpt)
    for key in ("student", "teacher"):
        entry = ckpt.get(key)
        if entry is None:
            continue
        if "params" in entry:
            raise ValueError(
                f"{path}: {key} is a Flax variable tree, which only the JAX "
                "package reads (a model other than PoseResNet)")
        out[key] = _unprefixed(entry)
    if isinstance(out.get("args"), argparse.Namespace):
        out["args"] = dict(vars(out["args"]))
    return out


def filtered_update(own: Mapping[str, torch.Tensor], loaded: Mapping[str, Any]):
    """The reference's key-filtered load (train_human.py:163-167): a copy of
    the state dict ``own`` that takes each entry of ``loaded`` (a tensor or
    a numpy array) whose key and shape match, and keeps the rest, e.g. the
    ``num_batches_tracked`` a JAX-written file does not have."""
    out = dict(own)
    for k, v in own.items():
        if k in loaded and tuple(np.shape(loaded[k])) == tuple(v.shape):
            out[k] = torch.as_tensor(loaded[k]).to(dtype=v.dtype, device=v.device)
    return out


def restore_train_state(state, checkpoint: Mapping[str, Any], *,
                        teacher_source: str = "teacher", load_optimizer: bool = False,
                        log=None):
    """Apply a loaded checkpoint onto a ``UDAState`` in place, as the
    reference's resume and pretrain loads do (train_human.py:153-167,
    240-257): the student from ``student``, the teacher from
    ``teacher_source`` (``"student"`` on the pretrain path, where both start
    from the pretrained student), each through ``filtered_update``. The
    student's optimizer state is restored only with ``load_optimizer``; one
    that does not fit (an optax tree from the JAX package) is logged through
    ``log`` and the fresh optimizer kept. Returns ``state``."""
    for module, key in ((state.student, "student"), (state.teacher, teacher_source)):
        module.load_state_dict(filtered_update(module.state_dict(), checkpoint[key]))
    opt_sd = checkpoint.get("stu_optimizer")
    if load_optimizer and opt_sd is not None:
        try:  # raises before it changes anything when the groups do not fit
            state.optimizer.load_state_dict(opt_sd)
        except (KeyError, TypeError, ValueError):
            if log is not None:
                log("resume: optimizer state incompatible; reinitialized")
    return state
