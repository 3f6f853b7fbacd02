"""The tile plan of the ``matmul_stats`` kernel (``ops/bn_fuse.py::_plan``):
which variant runs, the tile width and the grid, for the 15
(M, K, N) of pose_resnet101's fused 1x1 convs at b=32, 256² images, and for
ragged and unaligned shapes. The plan is pure Python, so it is checked here
on the CPU; the kernel it drives is checked on the card
(``tests/test_torch_bn_fuse.py -m gpu``, ``chip_smoke.py``)."""

import pytest
import torch

from uda_poseestimation_torch.models.resnet import fused_gemm_shapes, resnet101
from uda_poseestimation_torch.ops.bn_fuse import _plan, tma_describable

SMS = 132  # an H100 SXM
POSE_SHAPES = sorted(fused_gemm_shapes(resnet101(fuse_bn=True), 32, 256))
# ragged M, N and K; K not a multiple of 8; N not a multiple of 8; tiny
RAGGED = [(200, 70, 130), (77, 64, 33), (1000, 72, 200), (77, 64, 40), (256, 4096, 256),
          (1, 8, 8), (1000, 24, 200)]
SHAPES = POSE_SHAPES + RAGGED


def _cdiv(a, b):
    return -(-a // b)


def test_pose_resnet101_shapes():
    """The helper finds pose_resnet101's 70 fused GEMMs per forward in 15
    shapes, 45 of them the two layer-3 shapes."""
    counts = fused_gemm_shapes(resnet101(fuse_bn=True), 32, 256)
    assert sum(counts.values()) == 70 and len(counts) == 15
    assert counts[(8192, 256, 1024)] == 23 and counts[(8192, 1024, 256)] == 22


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_tma_exactly_where_a_tensor_map_describes_the_operands(m, k, n, aligned):
    plan = _plan(m, k, n, SMS, torch.bfloat16, aligned)
    describable = aligned and k % 8 == 0 and n % 8 == 0
    assert tma_describable(k, n, aligned) == describable
    assert plan.variant == ("tma" if describable else "mma_sync")
    if (m, k, n) in POSE_SHAPES and aligned:
        assert plan.variant == "tma"  # the main path never takes mma_sync


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_tile_no_wider_than_n(m, k, n):
    """BN is 64 or 128 and no wider than N rounded up to 64: N <= 64 runs
    64-wide tiles, not half-empty 128-wide ones."""
    plan = _plan(m, k, n, SMS)
    if plan.variant == "tma":
        assert plan.bn == (64 if n <= 512 else 128) and plan.bn <= _cdiv(n, 64) * 64
        assert plan.bm == 128 and plan.stages == (4 if plan.bn == 128 else 8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_grid_covers_every_row_tile(m, k, n, dtype):
    """The tma variant's row groups take every row tile between them; the
    other variants launch one block row per row tile, the count the
    launcher checks against the partial rows it is given."""
    plan = _plan(m, k, n, SMS, dtype)
    tiles_m = _cdiv(m, plan.bm)
    if plan.variant == "tma":
        assert 1 <= plan.groups <= tiles_m
    else:
        assert plan.groups == tiles_m
    assert plan.ctas == _cdiv(n, plan.bn) * plan.groups


@pytest.mark.parametrize("m,k,n", POSE_SHAPES)
def test_pose_resnet101_shapes_fill_the_card(m, k, n):
    """Each shape launches 132 blocks, or as many row groups as fit in one
    wave: a block walks several row tiles, so one more group of ``tiles_n``
    blocks would start a second wave (it runs at one block per SM), and
    fewer row tiles per block would not come sooner."""
    plan = _plan(m, k, n, SMS)
    tiles_n = _cdiv(n, plan.bn)
    assert plan.variant == "tma" and plan.ctas <= SMS
    assert plan.ctas >= SMS or plan.ctas + tiles_n > SMS


@pytest.mark.parametrize("m,k,n,sms,want", [
    ((1000, 72, 200, SMS, ("tma", 128, 64, 8, 8, 32))),
    ((256, 4096, 256, SMS, ("tma", 128, 64, 8, 2, 8))),
    ((2048, 2048, 512, SMS, ("tma", 128, 64, 8, 16, 128))),
    ((4096, 2048, 512, 114, ("tma", 128, 64, 8, 14, 112))),
    ((8192, 256, 1024, SMS, ("tma", 128, 128, 4, 16, 128)))])
def test_grid_is_one_wave_of_row_groups(m, k, n, sms, want):
    """A grid under one wave gives each row tile its own block; a larger
    one as many row groups as one wave holds, on a card of any SM count."""
    assert _plan(m, k, n, sms) == want


def test_forced_and_f32_variants():
    assert _plan(8192, 1024, 256, SMS, variant="mma_sync") == (
        "mma_sync", 128, 128, 2, 64, 128)
    assert _plan(200, 70, 130, SMS, torch.float32).variant == "simt"
    with pytest.raises(ValueError, match="no tma plan"):
        _plan(200, 70, 130, SMS, variant="tma")
    with pytest.raises(ValueError, match="only the simt"):
        _plan(200, 72, 136, SMS, torch.float32, variant="tma")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        _plan(200, 72, 136, SMS, torch.float16)
