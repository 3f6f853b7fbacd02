"""Plain float32 models of the benchmark's configurations.

- ``PoseResNet``: SimpleBaseline (Xiao et al., arXiv:1804.06208) on a
  torchvision-v1 ResNet (7x7/s2 stem, 3x3/s2 max-pool, Bottleneck stages,
  stride on the 3x3), three ConvTranspose2d(4, s2, p1) + BN + ReLU layers of
  256 and a 1x1 head to the keypoints.
- ``StyleNet``: AdaIN (Huang & Belongie, arXiv:1703.06868): the
  vgg_normalised encoder to relu4_1 (a 1x1 recentering conv, reflect-padded
  3x3 convs, 2x2 ceil-mode max-pools) and its mirrored decoder (nearest 2x
  upsamples), with the content loss and the mean/std style loss.

Module names follow the published state-dict keys (``backbone.layer1.0.conv1``,
``upsampling.{0..8}``, ``head``, ``encoder.{i}``, ``decoder.{i}``), so one
weight dict loads into these modules and into the program's.

Departures from the published description, each the program's too:
- BatchNorm's running variance takes the biased batch variance (Flax's rule;
  torch's takes the unbiased one); train-mode outputs are the same.
- ``PoseResNet.forward`` returns float32 heatmaps whatever the input's dtype.

Nothing here computes in another precision unless asked: the ``QConv2d`` and
``QConvTranspose2d`` modules round their operands to float8 when a control
sets ``fp8`` on them (``precision.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .precision import fp8_operand


class QConv2d(nn.Conv2d):
    """``nn.Conv2d`` whose input and weight go through ``fp8_operand`` when
    ``self.fp8`` is set (the float8 control); plain otherwise."""

    fp8 = False

    def forward(self, x):
        if self.fp8:
            return self._conv_forward(fp8_operand(x), fp8_operand(self.weight), self.bias)
        return super().forward(x)


class QConvTranspose2d(nn.ConvTranspose2d):
    fp8 = False

    def forward(self, x):
        if not self.fp8:
            return super().forward(x)
        return F.conv_transpose2d(fp8_operand(x), fp8_operand(self.weight), self.bias,
                                  self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm, eps 1e-5, torch momentum 0.1, running variance updated
    with the biased batch variance."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        dims = (0, 2, 3)
        mean = x.mean(dim=dims)
        var = x.var(dim=dims, unbiased=False)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(mean * self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var * self.momentum)
            self.num_batches_tracked.add_(1)
        inv = torch.rsqrt(var + self.eps)
        return ((x - mean[None, :, None, None]) * (inv * self.weight)[None, :, None, None]
                + self.bias[None, :, None, None])


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int, downsample: bool):
        super().__init__()
        self.conv1 = QConv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = QConv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = QConv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = (nn.Sequential(QConv2d(inplanes, planes * 4, 1, stride=stride,
                                                 bias=False), BatchNorm2d(planes * 4))
                           if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(self.bn3(self.conv3(y)) + identity)


class ResNet(nn.Module):
    """Headless Bottleneck ResNet, stride-32 features out."""

    def __init__(self, stage_sizes=(3, 4, 23, 3)):
        super().__init__()
        self.conv1 = QConv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.num_stages = len(stage_sizes)
        inplanes, planes = 64, 64
        for stage, n in enumerate(stage_sizes):
            blocks = []
            for i in range(n):
                stride = 2 if stage > 0 and i == 0 else 1
                blocks.append(Bottleneck(inplanes, planes, stride, downsample=i == 0))
                inplanes = planes * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            planes *= 2
        self.out_features = inplanes

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, stride=2, padding=1)
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x


class PoseResNet(nn.Module):
    """(B, 3, H, W) -> (B, K, H/4, W/4) float32 heatmaps."""

    def __init__(self, num_keypoints: int, stage_sizes=(3, 4, 23, 3), deconv_dim: int = 256):
        super().__init__()
        self.backbone = ResNet(stage_sizes)
        layers, cin = [], self.backbone.out_features
        for _ in range(3):
            layers += [QConvTranspose2d(cin, deconv_dim, 4, stride=2, padding=1, bias=False),
                       BatchNorm2d(deconv_dim), nn.ReLU()]
            cin = deconv_dim
        self.upsampling = nn.Sequential(*layers)
        self.head = QConv2d(deconv_dim, num_keypoints, 1)

    def forward(self, x):
        return self.head(self.upsampling(self.backbone(x.float()))).float()


# --- AdaIN --------------------------------------------------------------------

_ENCODER_TAPS = (3, 10, 17, 30)  # relu1_1 .. relu4_1


def _block(cin, cout, relu=True):
    layers = [nn.ReflectionPad2d(1), QConv2d(cin, cout, 3)]
    return layers + [nn.ReLU()] if relu else layers


class VGGEncoder(nn.Sequential):
    def __init__(self):
        pool = lambda: nn.MaxPool2d(2, 2, ceil_mode=True)  # noqa: E731
        super().__init__(
            QConv2d(3, 3, 1), *_block(3, 64), *_block(64, 64), pool(),
            *_block(64, 128), *_block(128, 128), pool(), *_block(128, 256),
            *_block(256, 256), *_block(256, 256), *_block(256, 256), pool(),
            *_block(256, 512))

    def forward(self, x, taps: bool = False):
        feats = []
        for i, layer in enumerate(self):
            x = layer(x)
            if i in _ENCODER_TAPS:
                feats.append(x)
        return feats if taps else x


class Decoder(nn.Sequential):
    def __init__(self):
        up = lambda: nn.Upsample(scale_factor=2, mode="nearest")  # noqa: E731
        super().__init__(
            *_block(512, 256), up(), *_block(256, 256), *_block(256, 256),
            *_block(256, 256), *_block(256, 128), up(), *_block(128, 128),
            *_block(128, 64), up(), *_block(64, 64), *_block(64, 3, relu=False))


def calc_mean_std(feat, eps: float = 1e-5):
    """Per (sample, channel) spatial mean and std, unbiased variance + eps."""
    n, c = feat.shape[:2]
    x = feat.reshape(n, c, -1)
    return (x.mean(dim=2).reshape(n, c, 1, 1),
            torch.sqrt(x.var(dim=2, unbiased=True) + eps).reshape(n, c, 1, 1))


def adain(content, style, eps: float = 1e-5):
    s_mean, s_std = calc_mean_std(style, eps)
    c_mean, c_std = calc_mean_std(content, eps)
    return (content - c_mean) / c_std * s_std + s_mean


class StyleNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = VGGEncoder()
        self.decoder = Decoder()

    def encode(self, x):
        return self.encoder(x.float())

    def decode(self, t):
        return self.decoder(t.float())

    def _style_loss(self, x, target):
        """The AdaIN paper's mean/std loss (adain/net.py)."""
        m_x, s_x = calc_mean_std(x)
        m_t, s_t = calc_mean_std(target)
        return F.mse_loss(m_x, m_t) + F.mse_loss(s_x, s_t)

    def forward(self, content, style, alpha: float = 1.0):
        """The decoder-training forward: ``loss_c`` of the stylized image's
        relu4_1 against the AdaIN target, ``loss_s`` over the four taps."""
        style_feats = self.encoder(style.float(), taps=True)
        content_feat = self.encode(content)
        t = alpha * adain(content_feat, style_feats[-1]) + (1.0 - alpha) * content_feat
        g_t = self.decode(t)
        g_feats = self.encoder(g_t, taps=True)
        loss_c = F.mse_loss(g_feats[-1].float(), t.float())
        loss_s = sum(self._style_loss(g.float(), s.float())
                     for g, s in zip(g_feats, style_feats))
        return loss_c, loss_s, g_t.float()
