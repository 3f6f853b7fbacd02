"""Model registry: the names of ``uda_poseestimation_tpu/models/__init__.py``
(the reference resolves ``--arch`` by ``models.__dict__[args.arch]``,
train_human.py:117), plus the port's module classes.
``switches`` warns, at import, for each of the JAX package's opt-in layer
switches that is set: the port has only the default forms.
"""

from . import loss, switches
from . import style_net as Style_net  # noqa: N812 (the reference's submodule name)
from .ema import ModelEMA, OldWeightEMA, ema_init, ema_update
from .pose_resnet import (PoseResNet, Upsampling, backbone_param_mask, pose_resnet50,
                          pose_resnet101, trans_pose_resnet, trans_pose_resnet50)
from .resnet import (BasicBlock, BatchNorm2d, Bottleneck, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152, resnext50_32x4d, resnext101_32x8d,
                     wide_resnet50_2, wide_resnet101_2)
from .style_net import Decoder, StyleNet, VGGEncoder

__all__ = [
    "BasicBlock", "BatchNorm2d", "Bottleneck", "Decoder", "ModelEMA", "OldWeightEMA",
    "PoseResNet", "ResNet", "StyleNet", "Style_net", "Upsampling",
    "VGGEncoder", "backbone_param_mask", "ema_init", "ema_update", "loss", "pose_resnet50",
    "pose_resnet101", "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "resnext50_32x4d", "resnext101_32x8d", "trans_pose_resnet", "trans_pose_resnet50",
    "wide_resnet50_2", "wide_resnet101_2",
]
