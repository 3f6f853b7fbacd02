"""The trainers' MultiStep learning-rate rule and the reference's ramps.

The port's copy of ``uda_poseestimation_tpu/utils/schedules.py``:
``multistep_lr`` (torch MultiStepLR as the reference steps it) and the ramp
functions of utils.py:28-52, which no trainer calls. The reference steps
MultiStepLR once per epoch *before* training that epoch
(train_human.py:200-202), so the factor for epoch ``e`` counts the
milestones ``m <= e + 1``.

``--lr-step`` is parsed with ``type=tuple`` in both trainers
(train_human.py:466): given on the command line, ``--lr-step 45`` becomes
the tuple of its characters ``("4", "5")``; the default ``[45, 60]`` stays
a list of ints. ``int(m)`` below accepts both, as the JAX package does.
"""

from __future__ import annotations

import numpy as np


def sigmoid_rampup(current: float, rampup_length: float) -> float:
    """Exponential rampup (arXiv:1610.02242), utils.py:28-35."""
    if rampup_length == 0:
        return 1.0
    current = np.clip(current, 0.0, rampup_length)
    phase = 1.0 - current / rampup_length
    return float(np.exp(-5.0 * phase * phase))


def cosine_rampdown(current: float, rampdown_length: float) -> float:
    """Cosine rampdown (arXiv:1608.03983), utils.py:38-42."""
    current = np.clip(current, 0.0, rampdown_length)
    return float(0.5 * (np.cos(np.pi * current / rampdown_length) + 1))


def rev_sigmoid(progress: float) -> float:
    progress = np.clip(progress, 0, 1)
    return float(1.0 / (1 + np.exp(10 * progress - 5)))


def sigmoid(progress: float) -> float:
    progress = np.clip(progress, 0, 1)
    return float(1.0 / (1 + np.exp(5 - 10 * progress)))


def multistep_lr(base_lr: float, epoch: int, milestones, gamma: float = 0.1) -> float:
    """The learning rate used while training 0-indexed ``epoch``."""
    n = sum(1 for m in milestones if int(m) <= int(epoch) + 1)
    return base_lr * (gamma ** n)
