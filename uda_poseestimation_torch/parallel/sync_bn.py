"""Train-mode BatchNorm over the global batch of a process group.

The JAX package takes BatchNorm statistics over the logically global batch
of its mesh (MIGRATION.md:110-113). The port's ranks each hold their rows,
so ``models/resnet.py::BatchNorm2d`` routes its train-mode forward here
whenever a group of more than one process is up: the teacher's k chained
forwards as well as the student's.

- forward: the per-channel sum, sum of squares and count are summed over
  the ranks in one all-reduce; the output is normalized by the global mean
  and the *biased* global variance (E[x^2] - E[x]^2, clamped at 0, Flax's
  ``_compute_stats``), and the running statistics follow the Flax rule with
  the global batch's biased variance;
- backward: the two per-channel sums that the input's gradient needs,
  sum(dy) and sum(dy * x_hat), are summed over the ranks in one
  all-reduce; the weight's and the bias's gradients stay the rank's own
  sums, which the step then averages with the other gradients (each rank's
  loss is the mean over its rows, so the averaged gradients are the global
  batch's).

``torch.nn.SyncBatchNorm`` keeps torch's unbiased running variance, and
its kernels have no CPU version. This is stock PyTorch: the JAX package
leaves the same arithmetic to XLA's fusion.
"""

from __future__ import annotations

import torch
import torch.distributed as tdist
from torch import nn

_DIMS = (0, 2, 3)


def _shape(t):
    return t.view(1, -1, 1, 1)


class _SyncBatchNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float):
        dt = torch.promote_types(x.dtype, torch.float32)  # float64 stays float64
        xf = x.to(dt)
        c = x.shape[1]
        stats = torch.cat([xf.sum(_DIMS), (xf * xf).sum(_DIMS),
                           torch.full((1,), x.numel() // c, dtype=dt, device=x.device)])
        tdist.all_reduce(stats)
        n = stats[2 * c:]
        mean = stats[:c] / n
        var = torch.clamp_min(stats[c:2 * c] / n - mean * mean, 0.0)
        invstd = torch.rsqrt(var + eps)
        x_hat = (xf - _shape(mean)) * _shape(invstd)
        y = x_hat * _shape(weight.to(dt)) + _shape(bias.to(dt))
        ctx.save_for_backward(x_hat, weight, invstd, n)
        ctx.x_dtype = x.dtype
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x_hat, weight, invstd, n = ctx.saved_tensors
        dyf = dy.to(x_hat.dtype)
        c = x_hat.shape[1]
        sum_dy = dyf.sum(_DIMS)
        sum_dy_xhat = (dyf * x_hat).sum(_DIMS)
        sums = torch.cat([sum_dy, sum_dy_xhat])
        grad_weight, grad_bias = sum_dy_xhat.to(weight.dtype), sum_dy.to(weight.dtype)
        tdist.all_reduce(sums)
        mean_dy, mean_dy_xhat = sums[:c] / n, sums[c:] / n
        dx = (dyf - _shape(mean_dy) - x_hat * _shape(mean_dy_xhat)) \
            * _shape(invstd * weight.to(x_hat.dtype))
        return dx.to(ctx.x_dtype), grad_weight, grad_bias, None


def sync_batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """Train-mode ``bn(x)`` over the group's global batch (see the module
    docstring); updates ``bn``'s running statistics by the Flax rule."""
    with torch.autocast(x.device.type, enabled=False):
        y, mean, var = _SyncBatchNorm.apply(x, bn.weight, bn.bias, bn.eps)
    with torch.no_grad():
        bn.running_mean.mul_(1.0 - bn.momentum).add_(mean.to(bn.running_mean.dtype)
                                                     * bn.momentum)
        bn.running_var.mul_(1.0 - bn.momentum).add_(var.to(bn.running_var.dtype)
                                                    * bn.momentum)
        bn.num_batches_tracked.add_(1)
    return y
