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

from uda_poseestimation_torch.ops.warp_gather import warp_gather, warp_gather_plain


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
