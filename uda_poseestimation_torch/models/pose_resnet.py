"""PoseResNet (Simple Baseline): ResNet backbone + deconv heatmap head.

PyTorch twin of ``uda_poseestimation_tpu/models/pose_resnet.py`` (reference
lib/models/pose_resnet.py:11-126): three ConvTranspose2d(k4, s2, p1) + BN +
ReLU layers (2048->256->256->256 for Bottleneck backbones), then a 1x1 head
to the keypoints. NCHW images in, NCHW float32 heatmaps out. Module names
are the reference's state-dict keys (``backbone.*``, ``upsampling.{0..8}``,
``head``).

``dtype=torch.bfloat16`` runs the forward under bf16 autocast with float32
parameters and BatchNorm statistics, like the JAX model's ``dtype``.
``fuse_bn`` selects the backbone's fused 1x1-conv + BatchNorm-statistics
path in train mode (``models/resnet.py``); None reads ``UDA_BN_FUSE``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from . import resnet as resnet_lib
from .resnet import BatchNorm2d


class Upsampling(nn.Sequential):
    """[ConvTranspose2d(k, s2, p1), BN, ReLU] x 3 (pose_resnet.py:11-56)."""

    def __init__(self, in_features: int, hidden_dims: Sequence[int] = (256, 256, 256),
                 bias: bool = False):
        layers = []
        for dim in hidden_dims:
            layers += [nn.ConvTranspose2d(in_features, dim, 4, stride=2, padding=1,
                                          bias=bias),
                       BatchNorm2d(dim), nn.ReLU(inplace=True)]
            in_features = dim
        super().__init__(*layers)


class PoseResNet(nn.Module):
    """Simple Baseline keypoint detector: (B, 3, H, W) -> (B, K, H/4, W/4)."""

    def __init__(self, backbone: resnet_lib.ResNet, num_keypoints: int,
                 feature_dim: int = 256, deconv_with_bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = backbone
        self.upsampling = Upsampling(backbone.out_features, bias=deconv_with_bias)
        self.head = nn.Conv2d(feature_dim, num_keypoints, 1)
        self.dtype = dtype

    def forward(self, x):
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            y = self.head(self.upsampling(self.backbone(x)))
        return y.float()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The JAX package's init: lecun-normal backbone convs, N(0, 0.001)
        deconv and head kernels, zero head bias, unit/zero BN."""
        resnet_lib.reset_resnet_(self, generator)
        with torch.no_grad():
            for m in self.upsampling.modules():
                if isinstance(m, nn.ConvTranspose2d):
                    m.weight.normal_(0.0, 0.001, generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()
            self.head.weight.normal_(0.0, 0.001, generator=generator)
            self.head.bias.zero_()


def pose_resnet101(num_keypoints: int, deconv_with_bias: bool = False,
                   dtype: torch.dtype = torch.float32,
                   fuse_bn: Optional[bool] = None) -> PoseResNet:
    """Simple Baseline with ResNet-101 (reference pose_resnet.py:102-112).
    The reference's 0.1x backbone learning rate is ``StepConfig.finetune``."""
    return PoseResNet(resnet_lib.resnet101(fuse_bn=fuse_bn), num_keypoints,
                      deconv_with_bias=deconv_with_bias, dtype=dtype)


def pose_resnet50(num_keypoints: int, deconv_with_bias: bool = False,
                  dtype: torch.dtype = torch.float32,
                  fuse_bn: Optional[bool] = None) -> PoseResNet:
    """Simple Baseline with ResNet-50 (reference pose_resnet.py:116-126)."""
    return PoseResNet(resnet_lib.resnet50(fuse_bn=fuse_bn), num_keypoints,
                      deconv_with_bias=deconv_with_bias, dtype=dtype)
