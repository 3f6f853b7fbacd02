"""AdaIN style-transfer network: VGG19-normalised encoder + learned decoder.

PyTorch twin of ``uda_poseestimation_tpu/models/style_net.py`` (reference
lib/models/Style_net.py, and adain/net.py for the decoder pretraining), NCHW:

- ``VGGEncoder``: the first 31 layers of ``vgg_normalised`` (up to relu4_1):
  a 1x1 RGB recentering conv, reflect-padded valid 3x3 convs and 2x2/2
  ceil-mode max-pools, with the four AdaIN taps relu1_1..relu4_1;
- ``Decoder``: 9 reflect-padded 3x3 convs with three nearest 2x upsamples;
- ``StyleNet``: ``encode``, ``decode``, ``stylize`` (the runtime transfer)
  and the training forward with the content loss and one of the two style
  losses: Gram-matrix MSE (Style_net.py:156-161, "gram") or the AdaIN
  paper's mean/std MSE (adain/net.py:137-146, "meanstd").

Both are ``nn.Sequential`` with the reference's layer indices, so
``vgg_normalised.pth`` and decoder checkpoints load by key. The style
network is frozen in the adaptation step and has no BatchNorm; its
parameters may be stored in bf16 (``StyleNet().to(torch.bfloat16)``), and
the inputs are cast to the parameters' dtype as the JAX module casts to its
``dtype``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import device_scalar
from ..ops.adain import adain, calc_mean_std, gram_matrix
from .resnet import lecun_normal_

# relu1_1 / relu2_1 / relu3_1 / relu4_1 end after these Sequential indices
_ENCODER_TAPS = (3, 10, 17, 30)


class _ReflectPad1Fn(torch.autograd.Function):
    """``F.pad(x, (1, 1, 1, 1), mode="reflect")`` with a backward that folds
    each border column, then each border row, onto the one it mirrors by
    plain slice additions. ReflectionPad2d's CUDA backward adds with
    atomics, whose order varies, so that the decoder trained from one seed
    differed from run to run."""

    @staticmethod
    def forward(ctx, x):
        return F.pad(x, (1, 1, 1, 1), mode="reflect")

    @staticmethod
    def backward(ctx, g):
        g_w = g[..., 1:-1].clone()
        g_w[..., 1] += g[..., 0]
        g_w[..., -2] += g[..., -1]
        g_hw = g_w[..., 1:-1, :].clone()
        g_hw[..., 1, :] += g_w[..., 0, :]
        g_hw[..., -2, :] += g_w[..., -1, :]
        return g_hw


class ReflectionPad1(nn.Module):
    """``nn.ReflectionPad2d(1)`` with a deterministic backward."""

    def forward(self, x):
        return _ReflectPad1Fn.apply(x)


def _conv_block(cin: int, cout: int, relu: bool = True):
    layers = [ReflectionPad1(), nn.Conv2d(cin, cout, 3)]
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


def reset_conv_parameters(module: nn.Module, generator: Optional[torch.Generator] = None):
    """The JAX package's init of every conv in ``module``: lecun-normal
    kernels, zero biases."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, generator)
                m.bias.zero_()


class StyleNet(nn.Module):
    """AdaIN Net (Style_net.py:121-177 / adain/net.py:102-162).

    ``forward(content, style, alpha) -> (loss_c, loss_s, g_t)``; ``stylize``
    is the transfer alone, which the adaptation step runs. ``style_loss_kind``
    is "gram" (Style_net.py, the default, as in JAX) or "meanstd"
    (adain/net.py, the decoder pretraining's).
    """

    def __init__(self, style_loss_kind: str = "gram"):
        super().__init__()
        if style_loss_kind not in ("gram", "meanstd"):
            raise ValueError(f"style_loss_kind {style_loss_kind!r}: 'gram' or 'meanstd'")
        self.style_loss_kind = style_loss_kind
        self.encoder = VGGEncoder()
        self.decoder = Decoder()

    @property
    def dtype(self) -> torch.dtype:
        return self.encoder[0].weight.dtype

    def encode(self, x):
        return self.encoder(x.to(self.dtype))

    def encode_with_intermediate(self, x):
        return self.encoder(x.to(self.dtype), return_intermediate=True)

    def decode(self, t):
        return self.decoder(t.to(self.dtype))

    def _transfer(self, content_feat, style_feat, alpha):
        """AdaIN of float32 relu4_1 features, mixed with the content's by
        ``alpha``: a number or a 0-d tensor (a CUDA graph's static input)."""
        alpha = device_scalar(alpha, content_feat.device)
        return alpha * adain(content_feat, style_feat) + (1.0 - alpha) * content_feat

    def stylize(self, content, style, alpha=1.0):
        """AdaIN transfer only (no losses); float32 out."""
        style_feat = self.encode(style).float()
        content_feat = self.encode(content).float()
        return self.decode(self._transfer(content_feat, style_feat, alpha)).float()

    def _style_loss(self, x, target):
        x, target = x.float(), target.float()
        if self.style_loss_kind == "gram":
            return F.mse_loss(gram_matrix(x), gram_matrix(target))
        m_x, s_x = calc_mean_std(x)
        m_t, s_t = calc_mean_std(target)
        return F.mse_loss(m_x, m_t) + F.mse_loss(s_x, s_t)

    def forward(self, content, style, alpha=1.0):
        """The training forward: ``loss_c`` is the MSE of the stylized
        image's relu4_1 against the AdaIN target ``t`` (not the content's
        features), ``loss_s`` the style loss of its four taps against the
        style image's, summed. With a frozen encoder (``requires_grad_(False)``)
        the style and content encodes record no autograd graph: only the
        stylized image's re-encode carries a gradient, to the decoder."""
        style_feats = self.encode_with_intermediate(style)
        content_feat = self.encode(content).float()
        t = self._transfer(content_feat, style_feats[-1].float(), alpha)
        g_t = self.decode(t)
        g_t_feats = self.encode_with_intermediate(g_t)
        loss_c = F.mse_loss(g_t_feats[-1].float(), t)
        loss_s = self._style_loss(g_t_feats[0], style_feats[0])
        for i in range(1, 4):
            loss_s = loss_s + self._style_loss(g_t_feats[i], style_feats[i])
        return loss_c, loss_s, g_t.float()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The JAX package's init: lecun-normal kernels, zero biases."""
        reset_conv_parameters(self, generator)
