"""AdaIN style-transfer network: VGG19-normalised encoder + learned decoder.

PyTorch twin of ``uda_poseestimation_tpu/models/style_net.py`` (reference
lib/models/Style_net.py), NCHW:

- ``VGGEncoder``: the first 31 layers of ``vgg_normalised`` (up to relu4_1):
  a 1x1 RGB recentering conv, reflect-padded valid 3x3 convs and 2x2/2
  ceil-mode max-pools, with the four AdaIN taps relu1_1..relu4_1;
- ``Decoder``: 9 reflect-padded 3x3 convs with three nearest 2x upsamples.

Both are ``nn.Sequential`` with the reference's layer indices, so
``vgg_normalised.pth`` and decoder checkpoints load by key. The style
network is frozen in training and has no BatchNorm; its parameters may be
stored in bf16 (``StyleNet().to(torch.bfloat16)``), and the inputs are cast
to the parameters' dtype as the JAX module casts to its ``dtype``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import device_scalar
from ..ops.adain import adain
from .resnet import lecun_normal_

# relu1_1 / relu2_1 / relu3_1 / relu4_1 end after these Sequential indices
_ENCODER_TAPS = (3, 10, 17, 30)


def _conv_block(cin: int, cout: int, relu: bool = True):
    layers = [nn.ReflectionPad2d(1), nn.Conv2d(cin, cout, 3)]
    return layers + [nn.ReLU()] if relu else layers


def _pool():
    return nn.MaxPool2d(2, 2, ceil_mode=True)


def _up():
    return nn.Upsample(scale_factor=2, mode="nearest")


class VGGEncoder(nn.Sequential):
    """vgg_normalised truncated at relu4_1 (Style_net.py:64-118)."""

    def __init__(self):
        super().__init__(
            nn.Conv2d(3, 3, 1), *_conv_block(3, 64),
            *_conv_block(64, 64), _pool(), *_conv_block(64, 128),
            *_conv_block(128, 128), _pool(), *_conv_block(128, 256),
            *_conv_block(256, 256), *_conv_block(256, 256), *_conv_block(256, 256),
            _pool(), *_conv_block(256, 512))

    def forward(self, x, return_intermediate: bool = False):
        feats = []
        for i, layer in enumerate(self):
            x = layer(x)
            if i in _ENCODER_TAPS:
                feats.append(x)
        return feats if return_intermediate else x


class Decoder(nn.Sequential):
    """AdaIN decoder (Style_net.py:32-62)."""

    def __init__(self):
        super().__init__(
            *_conv_block(512, 256), _up(),
            *_conv_block(256, 256), *_conv_block(256, 256), *_conv_block(256, 256),
            *_conv_block(256, 128), _up(),
            *_conv_block(128, 128), *_conv_block(128, 64), _up(),
            *_conv_block(64, 64), *_conv_block(64, 3, relu=False))


class StyleNet(nn.Module):
    """AdaIN Net (Style_net.py:121-177): ``encode``, ``decode`` and
    ``stylize`` (the runtime transfer the trainers use)."""

    def __init__(self):
        super().__init__()
        self.encoder = VGGEncoder()
        self.decoder = Decoder()

    @property
    def dtype(self) -> torch.dtype:
        return self.encoder[0].weight.dtype

    def encode(self, x):
        return self.encoder(x.to(self.dtype))

    def decode(self, t):
        return self.decoder(t.to(self.dtype))

    def stylize(self, content, style, alpha=1.0):
        """AdaIN transfer only (no losses); float32 out. ``alpha`` is a
        number or a 0-d tensor (a CUDA graph's static input)."""
        style_feat = self.encode(style).float()
        content_feat = self.encode(content).float()
        alpha = device_scalar(alpha, content.device)
        t = alpha * adain(content_feat, style_feat) + (1.0 - alpha) * content_feat
        return self.decode(t).float()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The JAX package's init: lecun-normal kernels, zero biases."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    lecun_normal_(m.weight, generator)
                    m.bias.zero_()
