"""The FLOP and byte counts against hand counts, and against PyTorch's
FLOP counter over the reference's modules on the meta device."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops
from benchmark.reference import models

from .conftest import ROOT

HAND = json.loads((ROOT / "benchmark/configs/hand_r101.json").read_text())
ADAIN = json.loads((ROOT / "benchmark/configs/adain_vgg19.json").read_text())


def _pose():
    return flops.pose_resnet_layers(256, 21, (3, 4, 23, 3), 256)


def test_hand_counts():
    assert sum(_pose()) == pytest.approx(24.2e9, rel=0.01)
    assert sum(flops.vgg_encoder_layers(256)) == pytest.approx(31.6e9, rel=0.01)
    assert sum(flops.decoder_layers(256)) == pytest.approx(31.6e9, rel=0.01)
    one = flops.adapt_step_flops(HAND, 32, 1)
    assert one == pytest.approx(8.5e12, rel=0.02)
    assert flops.adapt_step_flops(HAND, 32, 0) < one < flops.adapt_step_flops(HAND, 32, 2)
    assert flops.decoder_step_flops(ADAIN) == pytest.approx(0.89e12, rel=0.02)
    assert flops.serve_batch_flops(HAND, 64) == pytest.approx(1.55e12, rel=0.01)
    assert flops.occlusion_warp_bytes(32, 3, 256) == 2 * 32 * 3 * 256 * 256 * 4 + 32 * 24 * 5


def _counted(fn):
    with FlopCounterMode(display=False) as mode:
        fn()
    return mode.get_total_flops()


@pytest.mark.parametrize("size", [64, 256])
def test_forward_counts_match_torch(size):
    with torch.device("meta"):
        pose = models.PoseResNet(21)
        net = models.StyleNet()
        x = torch.empty(2, 3, size, size)
        t = torch.empty(2, 512, size // 8, size // 8)
    assert _counted(lambda: pose(x)) == 2 * sum(
        flops.pose_resnet_layers(size, 21, (3, 4, 23, 3), 256))
    assert _counted(lambda: net.encoder(x)) == 2 * sum(flops.vgg_encoder_layers(size))
    assert _counted(lambda: net.decoder(t)) == 2 * sum(flops.decoder_layers(size))


def test_train_counts_match_torch():
    with torch.device("meta"):
        pose = models.PoseResNet(21, (1, 1, 1, 1))
        x = torch.empty(2, 3, 64, 64)
    want = 2 * flops.train_flops(flops.pose_resnet_layers(64, 21, (1, 1, 1, 1), 256))
    assert _counted(lambda: pose(x).sum().backward()) == want
