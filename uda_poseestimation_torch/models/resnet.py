"""Headless ResNet backbones (NCHW), torchvision V1 layout.

PyTorch twin of ``uda_poseestimation_tpu/models/resnet.py`` with the
``direct`` stem: 7x7/s2 conv (pad 3), BN, ReLU, 3x3/s2 max-pool (pad 1),
four stages, and the stride-32 layer4 map out. Module names are the
reference's torch state-dict keys (``conv1``, ``bn1``,
``layer1.0.conv1``, ``layer2.0.downsample.0``, ...), so reference
checkpoints load directly.

BatchNorm follows Flax, not torch (see ``BatchNorm2d``).

``fuse_bn`` (the JAX package's ``UDA_BN_FUSE=1``, read when ``None``)
routes each train-mode Bottleneck's conv1, conv3 and downsample 1x1 convs and
their BatchNorms through the fused conv + statistics GEMM
(``models/fused_bn.py``, the ``matmul_stats`` kernel on the card). Eval mode
and the modules, hence the state dict, are the same either way.
"""

from __future__ import annotations

import collections
import math
import os
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .fused_bn import conv1x1_bn_train


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with the JAX package's (Flax) running-statistics rule.

    Flax ``BatchNorm(momentum=0.9)`` updates ``var`` with the *biased* batch
    variance; ``torch.nn.BatchNorm2d`` uses the unbiased one, which would
    make every later eval forward differ by n/(n-1). Here momentum is 0.1 in
    torch terms and the running variance takes the biased batch variance.
    Train-mode outputs normalize by the biased variance in both frameworks.

    The batch statistics come from the fused ``F.batch_norm`` itself: it runs
    with momentum 1 into two scratch buffers, which then hold exactly this
    batch's mean and unbiased variance (the scratch always holds finite
    values from the last batch, and 0 * finite + stat == stat).
    """

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.register_buffer("_batch_mean", torch.zeros(num_features),
                             persistent=False)
        self.register_buffer("_batch_var", torch.zeros(num_features),
                             persistent=False)

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        y = F.batch_norm(x, self._batch_mean, self._batch_var, self.weight,
                         self.bias, True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(
                self._batch_mean * self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(
                self._batch_var * (self.momentum * (n - 1) / n))
            self.num_batches_tracked.add_(1)
        return y


def conv3x3(in_planes: int, out_planes: int, stride: int = 1):
    return nn.Conv2d(in_planes, out_planes, 3, stride=stride, padding=1, bias=False)


def conv1x1(in_planes: int, out_planes: int, stride: int = 1):
    return nn.Conv2d(in_planes, out_planes, 1, stride=stride, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, fuse_bn: bool = False):
        # fuse_bn is accepted for a uniform constructor and ignored, as in
        # the JAX package: the block's only 1x1 conv is its shortcut
        super().__init__()
        self.conv1 = conv3x3(inplanes, planes, stride)
        self.bn1 = BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = conv3x3(planes, planes)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = (nn.Sequential(conv1x1(inplanes, planes, stride),
                                         BatchNorm2d(planes))
                           if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, fuse_bn: bool = False):
        super().__init__()
        self.fuse_bn = fuse_bn
        self.conv1 = conv1x1(inplanes, planes)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = conv3x3(planes, planes, stride)  # torchvision v1: stride on 3x3
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = conv1x1(planes, planes * self.expansion)
        self.bn3 = BatchNorm2d(planes * self.expansion)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (nn.Sequential(
            conv1x1(inplanes, planes * self.expansion, stride),
            BatchNorm2d(planes * self.expansion)) if downsample else None)

    def _conv_bn_1x1(self, conv, bn, x):
        """``bn(conv(x))``, fused in train mode when ``fuse_bn`` is on."""
        if self.fuse_bn and self.training:
            return conv1x1_bn_train(conv, bn, x)
        return bn(conv(x))

    def forward(self, x):
        identity = x if self.downsample is None else self._conv_bn_1x1(*self.downsample, x)
        y = self.relu(self._conv_bn_1x1(self.conv1, self.bn1, x))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self._conv_bn_1x1(self.conv3, self.bn3, y)
        return self.relu(y + identity)


class ResNet(nn.Module):
    """Headless ResNet: NCHW in, stride-32 NCHW feature map out."""

    def __init__(self, block, stage_sizes: Sequence[int],
                 fuse_bn: Optional[bool] = None):
        super().__init__()
        self.block = block
        # None reads the JAX package's flag, with its meaning
        self.fuse_bn = (os.environ.get("UDA_BN_FUSE") == "1" if fuse_bn is None
                        else bool(fuse_bn))
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.num_stages = len(stage_sizes)
        inplanes, planes = 64, 64
        for stage, num_blocks in enumerate(stage_sizes):
            blocks = []
            for i in range(num_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                # projection shortcut where spatial or channel dims change
                downsample = i == 0 and (stride != 1 or block.expansion != 1)
                blocks.append(block(inplanes, planes, stride, downsample,
                                    fuse_bn=self.fuse_bn))
                inplanes = planes * block.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            planes *= 2

    @property
    def out_features(self) -> int:
        return 512 * self.block.expansion

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x


def trunc_normal_(tensor, std: float, generator: Optional[torch.Generator]):
    """In-place normal(0, std) truncated to +-2 std (inverse-CDF sampling)."""
    with torch.no_grad():
        lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, \
                 (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
        tensor.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=generator)
        tensor.erfinv_().mul_(std * math.sqrt(2.0))
    return tensor


def lecun_normal_(weight, generator: Optional[torch.Generator]):
    """Flax's ``lecun_normal``: truncated normal with variance 1/fan_in."""
    fan_in = weight[0].numel()
    # the stddev of a unit normal truncated to +-2 is 0.87962566103423978
    return trunc_normal_(weight, math.sqrt(1.0 / fan_in) / 0.87962566103423978,
                         generator)


def reset_resnet_(module: nn.Module, generator: Optional[torch.Generator]):
    """Flax-style init: lecun-normal convs, unit BN scale, zero BN bias and
    fresh running statistics."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            lecun_normal_(m.weight, generator)
        elif isinstance(m, nn.BatchNorm2d):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            m.reset_running_stats()


def fused_gemm_shapes(backbone: ResNet, b: int, size: int) -> collections.Counter:
    """(M, K, N) -> calls per train-mode forward of ``matmul_stats`` in a
    fused ResNet backbone at batch ``b`` and ``size``² images: each
    Bottleneck's conv1 at its input resolution, conv3 and the projection
    shortcut at its output resolution (the stem and the max-pool divide the
    size by 4)."""
    counts = collections.Counter()
    hw = size // 4
    for block in backbone.modules():
        if not isinstance(block, Bottleneck):
            continue
        out_hw = hw // block.conv2.stride[0]
        counts[(b * hw * hw, block.conv1.in_channels, block.conv1.out_channels)] += 1
        counts[(b * out_hw * out_hw, block.conv3.in_channels, block.conv3.out_channels)] += 1
        if block.downsample is not None:
            conv = block.downsample[0]
            counts[(b * out_hw * out_hw, conv.in_channels, conv.out_channels)] += 1
        hw = out_hw
    return counts


def _make(block, stage_sizes):
    def ctor(fuse_bn: Optional[bool] = None):
        return ResNet(block, stage_sizes, fuse_bn=fuse_bn)
    return ctor


resnet18 = _make(BasicBlock, [2, 2, 2, 2])
resnet34 = _make(BasicBlock, [3, 4, 6, 3])
resnet50 = _make(Bottleneck, [3, 4, 6, 3])
resnet101 = _make(Bottleneck, [3, 4, 23, 3])
