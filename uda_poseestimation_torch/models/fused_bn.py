"""The fused train-mode 1x1-conv + BatchNorm pair of the Bottleneck.

Counterpart of ``uda_poseestimation_tpu/models/fused_bn.py``
(``Conv1x1Stats`` + ``StatsBatchNorm``). It runs an existing
``nn.Conv2d`` (1x1, no bias) and ``BatchNorm2d`` pair, so the modules, the
state dict and checkpoints are the same whether the fusion is on or off; only
the train-mode forward changes:

- the conv and the statistics come from one ``conv1x1_bn_stats`` call (the
  ``matmul_stats`` kernel on the card), in the compute dtype: autocast's
  dtype when autocast is on, else the input's, as the JAX module casts x and
  its kernel to ``dtype``;
- mean = s1 / n and the one-pass var = max(0, s2 / n - mean^2) (Flax's
  ``_compute_stats``), not the two-pass variance of ``F.batch_norm``;
- the running statistics follow Flax, ra = 0.9 * ra + 0.1 * batch with the
  biased variance, and ``num_batches_tracked`` advances;
- the output is (y - mean) * (rsqrt(var + eps) * scale) + bias in that
  operation order, cast to the compute dtype.
"""

from __future__ import annotations

import torch
import torch.distributed as tdist
from torch import nn

from ..ops.bn_fuse import conv1x1_bn_stats


def _compute_dtype(x) -> torch.dtype:
    dev = x.device.type
    if torch.is_autocast_enabled(dev):
        return torch.get_autocast_dtype(dev)
    return x.dtype


def conv1x1_bn_train(conv: nn.Conv2d, bn: nn.BatchNorm2d, x):
    """Train-mode ``bn(conv(x))`` through the fused conv + statistics GEMM.
    One process only: its statistics are the rank's, so under a group of
    several processes it raises (the JAX package keeps the fused path to a
    mesh of one device)."""
    if tdist.is_available() and tdist.is_initialized() and tdist.get_world_size() > 1:
        raise NotImplementedError(
            "UDA_BN_FUSE=1 (fuse_bn) runs on one process; the fused BatchNorm "
            "has no whole-batch statistics across processes")
    dt = _compute_dtype(x)
    y, s1, s2 = conv1x1_bn_stats(x.to(dt), conv.weight.to(dt), conv.stride[0])
    n = y.numel() // y.shape[1]
    mean = s1 / n
    var = torch.clamp_min(s2 / n - mean * mean, 0.0)
    with torch.no_grad():
        bn.running_mean.mul_(1.0 - bn.momentum).add_(mean * bn.momentum)
        bn.running_var.mul_(1.0 - bn.momentum).add_(var * bn.momentum)
        bn.num_batches_tracked.add_(1)
    shape = (1, -1, 1, 1)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    out = (y - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)
    return out.to(dt)
