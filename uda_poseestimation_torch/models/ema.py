"""Mean-teacher EMA (reference utils.py:9-25, OldWeightEMA).

PyTorch twin of ``uda_poseestimation_tpu/models/ema.py``: the teacher's
*parameters* become ``alpha * teacher + (1 - alpha) * student``; BatchNorm
buffers are not averaged (the teacher's running stats evolve through its
own train-mode forwards). Unlike the JAX functions, which return new trees,
``ema_update`` updates the teacher module in place.

The classes that no trainer calls are kept for the reference's API, over
modules or state dicts (name -> tensor): ``ema_init`` and ``OldWeightEMA``
(the teacher as a copy of the student), and ``ModelEMA`` (lib/models/ema.py,
which averages parameters and copies every buffer from the student, as the
reference's ``esd[k].copy_(msd[j])`` does).
"""

from __future__ import annotations

import copy
from typing import Iterable, Mapping, Optional, Union

import torch
from torch import nn

Tree = Union[nn.Module, Mapping[str, torch.Tensor]]


@torch.no_grad()
def ema_update(teacher: nn.Module, student: nn.Module, alpha: float = 0.999):
    t_params = [p for p in teacher.parameters()]
    s_params = [p.detach() for p in student.parameters()]
    if len(t_params) != len(s_params):
        raise ValueError("teacher and student have different parameter lists")
    torch._foreach_mul_(t_params, alpha)
    torch._foreach_add_(t_params, torch._foreach_mul(s_params, 1.0 - alpha))


def ema_init(student: Tree) -> Tree:
    """The teacher's start (OldWeightEMA.__init__): a copy of the student, a
    module (deep copy, frozen) or a state dict (tensors cloned)."""
    if isinstance(student, nn.Module):
        return copy.deepcopy(student).requires_grad_(False)
    return {k: v.detach().clone() for k, v in student.items()}


def _param_names(tree: Tree, params: Optional[Iterable[str]]):
    if isinstance(tree, nn.Module):
        return {n for n, _ in tree.named_parameters()}
    return set(tree) if params is None else set(params)


def _tensors(tree: Tree) -> Mapping[str, torch.Tensor]:
    return tree.state_dict(keep_vars=True) if isinstance(tree, nn.Module) else tree


@torch.no_grad()
def _average(ema: Tree, student: Tree, decay: float, params):
    """``ema``'s parameters <- decay * ema + (1 - decay) * student, in place,
    and the rest copied from the student. ``params`` names the parameters of
    a state dict (all of its entries by default)."""
    names = _param_names(ema, params)
    mine, theirs = _tensors(ema), _tensors(student)
    if set(mine) != set(theirs):
        raise ValueError("the EMA and the student hold different entries")
    for k, e in mine.items():
        s = theirs[k].detach()
        if k in names:
            e.mul_(decay).add_(s * (1.0 - decay))
        else:
            e.copy_(s)


class OldWeightEMA:
    """The reference's stateful teacher (utils.py:9-25): ``params`` starts
    as a copy of the student's (``ema_init``) and ``step(student)`` moves it
    by ``alpha``. Over modules only the parameters are averaged (the
    buffers stay the teacher's), as ``ema_update``."""

    def __init__(self, teacher: Tree, student: Tree, alpha: float = 0.999):
        del teacher  # replaced by the student's copy, as in the reference
        self.params = ema_init(student)
        self.alpha = alpha

    @torch.no_grad()
    def step(self, student: Tree) -> Tree:
        if isinstance(self.params, nn.Module):
            ema_update(self.params, student, self.alpha)
        else:
            for k, t in self.params.items():
                t.mul_(self.alpha).add_(student[k].detach() * (1.0 - self.alpha))
        return self.params


class ModelEMA:
    """Deep-copy EMA (lib/models/ema.py:6-44, unused upstream): ``update``
    averages the parameters by ``decay`` and copies every buffer (the
    BatchNorm statistics) from the student. Over state dicts, ``params``
    names the parameter entries (default: every entry)."""

    def __init__(self, model: Tree, decay: float = 0.9999,
                 params: Optional[Iterable[str]] = None):
        self.ema = ema_init(model)
        self.decay = decay
        self.params = None if params is None else set(params)

    def update(self, model: Tree) -> Tree:
        _average(self.ema, model, self.decay, self.params)
        return self.ema
