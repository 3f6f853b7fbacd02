"""Models of the port: PoseResNet, StyleNet, losses and the mean-teacher EMA."""

from .ema import ema_update
from .loss import cons_loss, joints_mse_loss
from .pose_resnet import PoseResNet, Upsampling, pose_resnet50, pose_resnet101
from .resnet import (BasicBlock, BatchNorm2d, Bottleneck, ResNet, resnet18,
                     resnet34, resnet50, resnet101)
from .style_net import Decoder, StyleNet, VGGEncoder

__all__ = [
    "BasicBlock", "BatchNorm2d", "Bottleneck", "Decoder", "PoseResNet", "ResNet",
    "StyleNet", "Upsampling", "VGGEncoder", "cons_loss", "ema_update",
    "joints_mse_loss", "pose_resnet50", "pose_resnet101", "resnet18", "resnet34",
    "resnet50", "resnet101",
]
