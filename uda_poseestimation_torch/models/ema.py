"""Mean-teacher EMA (reference utils.py:9-25, OldWeightEMA).

PyTorch twin of ``ema_update`` in ``uda_poseestimation_tpu/models/ema.py``:
the teacher's *parameters* become ``alpha * teacher + (1 - alpha) *
student``; BatchNorm buffers are not averaged (the teacher's running stats
evolve through its own train-mode forwards). Unlike the JAX function, which
returns a new tree, this updates the teacher module in place.
"""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def ema_update(teacher: nn.Module, student: nn.Module, alpha: float = 0.999):
    t_params = [p for p in teacher.parameters()]
    s_params = [p.detach() for p in student.parameters()]
    if len(t_params) != len(s_params):
        raise ValueError("teacher and student have different parameter lists")
    torch._foreach_mul_(t_params, alpha)
    torch._foreach_add_(t_params, torch._foreach_mul(s_params, 1.0 - alpha))
