"""The occlusion warp: the port's plain version against the JAX package, and
the CUDA kernel against the plain version on the card.

Every comparison is exact: the function only rounds indices and copies
values (or their bf16 rounding), so any difference is a bug. The JAX
package is imported inside the tests that use it, so that the card test
also runs where only PyTorch is installed:
``python -m pytest tests/test_torch_occlusion_warp.py -m gpu``.
"""

import numpy as np
import pytest
import torch

from uda_poseestimation_torch.ops.occlusion_warp import (
    occlusion_indices_plain, occlusion_warp, occlusion_warp_plain)


def _aug(rng, b, ties):
    if ties:  # zero angle/shear, integer translations, scale 0.5 or 2
        return np.stack([np.zeros(b), np.round(rng.uniform(-12, 12, b)),
                         np.round(rng.uniform(-12, 12, b)), np.zeros(b), np.zeros(b),
                         rng.choice([0.5, 2.0], b)], -1).astype(np.float32)
    return np.stack([rng.uniform(-60, 60, b), np.round(rng.uniform(-12, 12, b)),
                     np.round(rng.uniform(-12, 12, b)), rng.uniform(-30, 30, b),
                     rng.uniform(-30, 30, b), rng.uniform(0.6, 1.3, b)],
                    -1).astype(np.float32)


def _inputs(seed, b=2, c=3, size=64, ties=False):
    """Images, the JAX step's (B, 4, 6) coefficients and (B, 6) rectangles,
    with the rectangles touching the image borders in turn."""
    from uda_poseestimation_tpu.ops import affine as jaff

    rng = np.random.RandomState(seed)
    imgs = rng.rand(b, c, size, size).astype(np.float32)
    aug = _aug(rng, b, ties)
    ratio = 4.0
    angle, tx, ty, shx, shy, scale = (aug[:, i] for i in range(6))
    c1, c2, c3 = jaff.chain_coeffs(angle, tx / ratio, ty / ratio, shx, shy, scale)
    cb = jaff.inverse_affine_coeffs(-angle, -tx / ratio, -ty / ratio, -shx, -shy,
                                    1.0 / scale)
    coeffs = np.stack([np.asarray(m) for m in (cb, c1, c2, c3)], 1).astype(np.float32)
    half = 10
    rect = []
    for i in range(b):
        cy, cx = [(0, size - 1), (size - 1, 0), (size // 2, size // 3)][i % 3]
        left, right = max(cy - half, 0), min(cy + half, size)
        upper, bottom = max(cx - half, 0), min(cx + half, size)
        left_src = int(rng.rand() * (size - (right - left) + 1))
        upper_src = int(rng.rand() * (size - (bottom - upper) + 1))
        rect.append([left, right, upper, bottom, left_src, upper_src])
    return imgs, coeffs, np.asarray(rect, np.int32)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("exact", [True, False])
def test_plain_matches_pallas_interpret(exact, ties):
    """occlusion_warp_plain == JAX occlusion_warp_onehot(interpret=True)."""
    from uda_poseestimation_tpu.ops.pallas_warp import occlusion_warp_onehot

    imgs, coeffs, rect = _inputs(3 + ties, ties=ties)
    want = np.asarray(occlusion_warp_onehot(imgs, coeffs, rect, interpret=True,
                                            exact=exact))
    got = occlusion_warp_plain(torch.from_numpy(imgs), torch.from_numpy(coeffs),
                               torch.from_numpy(rect), exact=exact).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).mean() > 0.0  # some pixels fell outside the source


@pytest.mark.parametrize("ties", [False, True])
def test_plain_matches_xla_branch(ties):
    """The plain version equals the JAX step's XLA occlusion branch
    (train_step.py:334-358): the step with every sample occluded, its
    rectangles from the same draws."""
    import jax
    import jax.numpy as jnp

    from uda_poseestimation_tpu.ops import affine as jaff
    from uda_poseestimation_tpu.parallel.train_step import (
        StepConfig, _occlude_batch, _occlusion_geometry)

    cfg = StepConfig(image_size=64, heatmap_size=16, occlude_rate=1.0,
                     occlude_thresh=-1.0, gather_impl="xla")
    rng = np.random.RandomState(7 + ties)
    b = 4
    imgs = rng.rand(b, 64, 64, 3).astype(np.float32)
    hm = rng.rand(b, 5, 16, 16).astype(np.float32)
    aug = _aug(rng, b, ties)
    key = jax.random.PRNGKey(ties)
    want = np.asarray(_occlude_batch(key, jnp.asarray(imgs), jnp.asarray(hm),
                                     jnp.asarray(aug), cfg))
    geom = [np.asarray(g) for g in _occlusion_geometry(key, jnp.asarray(hm), cfg)]
    assert geom[0].all()
    rect = np.stack(geom[1:], -1).astype(np.int32)
    angle, tx, ty, shx, shy, scale = (aug[:, i] for i in range(6))
    c1, c2, c3 = jaff.chain_coeffs(angle, tx / 4.0, ty / 4.0, shx, shy, scale)
    cb = jaff.inverse_affine_coeffs(-angle, -tx / 4.0, -ty / 4.0, -shx, -shy, 1.0 / scale)
    coeffs = np.stack([np.asarray(m) for m in (cb, c1, c2, c3)], 1)
    got = occlusion_warp_plain(torch.from_numpy(imgs).permute(0, 3, 1, 2),
                               torch.from_numpy(coeffs), torch.from_numpy(rect))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_wrapper_on_cpu_is_the_plain_version():
    imgs, coeffs, rect = _inputs(11)
    args = [torch.from_numpy(a) for a in (imgs, coeffs, rect)]
    before = occlusion_warp.launches
    for exact in (True, False):
        assert torch.equal(occlusion_warp(*args, exact=exact),
                           occlusion_warp_plain(*args, exact=exact))
    assert occlusion_warp.launches == before  # only kernel launches count


def test_wrapper_rejects_bad_inputs():
    imgs, coeffs, rect = (torch.from_numpy(a) for a in _inputs(12))
    with pytest.raises(ValueError, match="power-of-two"):
        occlusion_warp(imgs[..., :48, :48].contiguous(), coeffs, rect)
    with pytest.raises(ValueError, match="float32"):
        occlusion_warp(imgs.double(), coeffs, rect)
    with pytest.raises(ValueError, match="int32"):
        occlusion_warp(imgs, coeffs, rect.long())
    with pytest.raises(ValueError, match=r"\(2, 4, 6\)"):
        occlusion_warp(imgs, coeffs[:, :3], rect)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("exact", [True, False])
def test_kernel_matches_plain_on_card(cuda, exact, ties):
    """The CUDA kernel equals the plain version on the card, values and index
    maps (read through an image whose pixel values are their index + 1), for
    contiguous NCHW and channels_last inputs."""
    imgs, coeffs, rect = _inputs(5 + ties, b=8, size=256, ties=ties)
    imgs, coeffs, rect = (torch.from_numpy(a).to(cuda) for a in (imgs, coeffs, rect))
    for x in (imgs, imgs.contiguous(memory_format=torch.channels_last)):
        got = occlusion_warp(x, coeffs, rect, exact=exact)
        torch.cuda.synchronize()
        assert torch.equal(got, occlusion_warp_plain(x, coeffs, rect, exact=exact))
    iota = torch.arange(1, 256 * 256 + 1, device=cuda, dtype=torch.float32)
    iota = iota.view(1, 1, 256, 256).expand(8, 1, 256, 256).contiguous()
    ix, iy, valid = occlusion_indices_plain(coeffs, rect, 256)
    idx = torch.where(valid, iy * 256 + ix + 1, 0).to(torch.float32)
    assert torch.equal(occlusion_warp(iota, coeffs, rect)[:, 0], idx)
