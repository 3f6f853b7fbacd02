"""The trainers' MultiStep learning-rate rule.

The port's copy of ``multistep_lr`` from
``uda_poseestimation_tpu/utils/schedules.py`` (torch MultiStepLR as the
reference steps it). The reference steps MultiStepLR once per epoch *before*
training that epoch (train_human.py:200-202), so the factor for epoch ``e``
counts the milestones ``m <= e + 1``.

``--lr-step`` is parsed with ``type=tuple`` in both trainers
(train_human.py:466): given on the command line, ``--lr-step 45`` becomes
the tuple of its characters ``("4", "5")``; the default ``[45, 60]`` stays
a list of ints. ``int(m)`` below accepts both, as the JAX package does.
"""

from __future__ import annotations


def multistep_lr(base_lr: float, epoch: int, milestones, gamma: float = 0.1) -> float:
    """The learning rate used while training 0-indexed ``epoch``."""
    n = sum(1 for m in milestones if int(m) <= int(epoch) + 1)
    return base_lr * (gamma ** n)
