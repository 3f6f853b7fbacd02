"""The warp gather: the port's plain version against the JAX package's
``warp_gather_onehot`` (Pallas, interpret mode), and the CUDA kernel against
the plain version on the card.

Every comparison is exact: the function copies values (or their bf16
rounding) or writes 0, so any difference is a bug. The JAX kernel's one-hot
dots are exact on the CPU (each output sums one product with zeros, and its
``exact=True`` hi/lo split re-adds to the f32 value), so the plain version
equals it bit for bit. The JAX package is imported inside the tests that use
it, so that the card test also runs where only PyTorch is installed:
``python -m pytest --noconftest tests/test_torch_warp_gather.py -m gpu``.
"""

import numpy as np
import pytest
import torch

from uda_poseestimation_torch.ops.warp_gather import (
    vector_path, warp_gather, warp_gather_plain)


def _inputs(seed, b=3, k=5, h=16, w=16):
    """Maps, and index pairs that mostly lie in the map, some of them just
    outside it on each side, with about 10% of the mask off."""
    rng = np.random.RandomState(seed)
    hms = (rng.randn(b, k, h, w) * 2.5).astype(np.float32)
    ix = rng.randint(-2, w + 2, (b, h * w)).astype(np.int32)
    iy = rng.randint(-2, h + 2, (b, h * w)).astype(np.int32)
    valid = rng.rand(b, h * w) > 0.1
    return hms, ix, iy, valid


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("size", [16, 64])
@pytest.mark.parametrize("exact", [True, False])
def test_plain_matches_pallas_interpret(exact, size):
    """warp_gather_plain == JAX warp_gather_onehot(interpret=True), bit for
    bit; at 64x64 the JAX kernel's grid has two pixel tiles per sample."""
    from uda_poseestimation_tpu.ops.pallas_warp import warp_gather_onehot

    hms, ix, iy, valid = _inputs(size + exact, h=size, w=size)
    want = np.asarray(warp_gather_onehot(hms, ix, iy, valid, interpret=True, exact=exact))
    got = warp_gather_plain(*_torch(hms, ix, iy, valid), exact=exact).numpy()
    np.testing.assert_array_equal(got, want)
    outside = (ix < 0) | (ix >= size) | (iy < 0) | (iy >= size)
    assert outside.any() and (valid & ~outside).any()


def test_plain_is_the_indexed_gather():
    """The definition, element by element in numpy."""
    hms, ix, iy, valid = _inputs(3)
    b, k, h, w = hms.shape
    want = np.zeros_like(hms).reshape(b, k, h * w)
    for i in range(b):
        for p in range(h * w):
            if valid[i, p] and 0 <= ix[i, p] < w and 0 <= iy[i, p] < h:
                want[i, :, p] = hms[i, :, iy[i, p], ix[i, p]]
    got = warp_gather_plain(*_torch(hms, ix, iy, valid)).numpy()
    np.testing.assert_array_equal(got, want.reshape(b, k, h, w))
    got_bf16 = warp_gather_plain(*_torch(hms, ix, iy, valid), exact=False)
    np.testing.assert_array_equal(
        got_bf16.numpy(),
        torch.from_numpy(want).to(torch.bfloat16).float().reshape(b, k, h, w).numpy())


def test_wrapper_on_cpu_is_the_plain_version():
    args = _torch(*_inputs(4))
    before = warp_gather.launches
    for exact in (True, False):
        assert torch.equal(warp_gather(*args, exact=exact),
                           warp_gather_plain(*args, exact=exact))
    assert warp_gather.launches == before  # only kernel launches count


def test_wrapper_rejects_bad_inputs():
    hms, ix, iy, valid = _torch(*_inputs(5))
    with pytest.raises(ValueError, match="float32"):
        warp_gather(hms.double(), ix, iy, valid)
    with pytest.raises(ValueError, match="int32"):
        warp_gather(hms, ix.long(), iy, valid)
    with pytest.raises(ValueError, match="bool"):
        warp_gather(hms, ix, iy, valid.to(torch.int32))
    with pytest.raises(ValueError, match=r"\(3, 256\)"):
        warp_gather(hms, ix[:, :100], iy, valid)


# the card tests' edge shapes: one pixel; ragged H*W and K; the heatmap
# warp's; 64 KB maps
_CARD_SHAPES = [(1, 1, 1, 1), (3, 5, 17, 23), (32, 21, 64, 64), (2, 33, 128, 128)]


def _draws(shape):
    """Inputs at ``shape`` whose indices leave the map on each side: for one
    pixel, a draw beyond each side and one inside."""
    b, k, h, w = shape
    hms, ix, iy, valid = _inputs(sum(shape), b, k, h, w)
    if h * w == 1:
        return [(hms, np.full((b, 1), x, np.int32), np.full((b, 1), y, np.int32),
                 np.ones((b, 1), bool)) for x, y in ((-1, 0), (1, 0), (0, -1), (0, 1), (0, 0))]
    assert (ix < 0).any() and (ix >= w).any() and (iy < 0).any() and (iy >= h).any()
    return [(hms, ix, iy, valid)]


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("shape", _CARD_SHAPES[:2], ids=str)
def test_plain_matches_pallas_interpret_at_edge_shapes(shape, exact):
    """warp_gather_plain == JAX warp_gather_onehot(interpret=True) at the
    card tests' small edge shapes (one pixel, ragged H*W and K), indices
    outside the map on each side."""
    from uda_poseestimation_tpu.ops.pallas_warp import warp_gather_onehot

    for draw in _draws(shape):
        want = np.asarray(warp_gather_onehot(*draw, interpret=True, exact=exact))
        got = warp_gather_plain(*_torch(*draw), exact=exact).numpy()
        np.testing.assert_array_equal(got, want)


def _vector_args(b, k, h, w, ix_offset=0, valid_offset=0):
    """CPU tensors of the kernel's shapes; ix and valid shifted by that many
    elements off their allocations' alignment."""
    hms = torch.zeros(b, k, h, w)
    ix = torch.zeros(b * h * w + ix_offset, dtype=torch.int32)[ix_offset:].view(b, h * w)
    iy = torch.zeros(b, h * w, dtype=torch.int32)
    valid = torch.ones(b * h * w + valid_offset, dtype=torch.bool)[valid_offset:]
    return hms, ix, iy, valid.view(b, h * w), torch.empty_like(hms)


_VECTOR_CASES = [
    ((32, 21, 64, 64), 0, 0, True),     # the heatmap warp's shape
    ((2, 33, 128, 128), 0, 0, True),
    ((2, 3, 4, 5), 0, 0, True),         # H*W = 20, a multiple of 4
    ((3, 5, 17, 23), 0, 0, False),      # ragged H*W
    ((1, 1, 1, 1), 0, 0, False),
    ((32, 21, 64, 64), 1, 0, False),    # ix 4 bytes off 16
    ((32, 21, 64, 64), 4, 0, True),     # ix 16 bytes on
    ((32, 21, 64, 64), 0, 1, False),    # the mask 1 byte off 4
    ((32, 21, 64, 64), 0, 4, True),
]


@pytest.mark.parametrize("shape,ix_offset,valid_offset,want", _VECTOR_CASES,
                         ids=[f"{s}-{i}-{v}" for s, i, v, _ in _VECTOR_CASES])
def test_vector_path(shape, ix_offset, valid_offset, want):
    """Where the kernel may use its 16-byte index loads and stores."""
    assert vector_path(*_vector_args(*shape, ix_offset, valid_offset)) is want


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [True, False])
def test_kernel_matches_plain_on_card(cuda, exact):
    """The CUDA kernel equals the plain version on the card at the heatmap
    warp's shape (32, 21, 64, 64), and counts its launches."""
    args = [t.to(cuda) for t in _torch(*_inputs(6, b=32, k=21, h=64, w=64))]
    before = warp_gather.launches
    got = warp_gather(*args, exact=exact)
    torch.cuda.synchronize()
    assert torch.equal(got, warp_gather_plain(*args, exact=exact))
    assert warp_gather.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _CARD_SHAPES, ids=str)
def test_kernel_shapes_on_card(cuda, shape):
    """The kernel equals the plain version bit for bit at the edge shapes
    (one pixel; ragged H*W and K; the heatmap warp's; 64 KB maps), with
    indices outside the map on each side, both ``exact``; with ix off
    16-byte alignment (scalar loads and stores); and a second call equals
    the first."""
    for draw in _draws(shape):
        _check_shape_on_card(cuda, *(t.to(cuda) for t in _torch(*draw)))


def _check_shape_on_card(cuda, hms, ix, iy, valid):
    shifted = torch.empty(ix.numel() + 1, dtype=torch.int32, device=cuda)[1:].view_as(ix)
    for idx in (ix, shifted.copy_(ix)):
        for exact in (True, False):
            before = warp_gather.launches
            got = warp_gather(hms, idx, iy, valid, exact=exact)
            again = warp_gather(hms, idx, iy, valid, exact=exact)
            want = warp_gather_plain(hms, idx, iy, valid, exact=exact)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (idx.data_ptr() % 16, exact)
            assert torch.equal(again, got)
            assert warp_gather.launches == before + 2
