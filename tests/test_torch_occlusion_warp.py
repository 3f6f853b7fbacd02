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


def _inputs(seed, b=2, c=3, size=64, ties=False, jax_coeffs=True):
    """Images, the JAX step's (B, 4, 6) coefficients (or, with
    ``jax_coeffs=False``, the port's, for the card, which has no JAX) and
    (B, 6) rectangles, with the rectangles touching the image borders in
    turn."""
    rng = np.random.RandomState(seed)
    imgs = rng.rand(b, c, size, size).astype(np.float32)
    aug = _aug(rng, b, ties)
    ratio = 4.0
    if jax_coeffs:
        from uda_poseestimation_tpu.ops import affine as aff

        angle, tx, ty, shx, shy, scale = (aug[:, i] for i in range(6))
    else:
        from uda_poseestimation_torch.ops import affine as aff

        angle, tx, ty, shx, shy, scale = torch.from_numpy(aug).unbind(-1)
    c1, c2, c3 = aff.chain_coeffs(angle, tx / ratio, ty / ratio, shx, shy, scale)
    cb = aff.inverse_affine_coeffs(-angle, -tx / ratio, -ty / ratio, -shx, -shy,
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


# 1.5 * 2^23: (v + R) - R rounds v to an integer, half to even, in f32
_ROUND = 12582912.0


def _extreme(coeffs, rect):
    """Coefficients and rectangles that push stage values out of range, one
    kind per sample (b >= 6): |v| >= 2^22 inside int32, beyond int32, +inf,
    -inf, NaN (a NaN coefficient, and inf * 0), and a rectangle value beyond
    2^22 (the kernel's integer remap)."""
    coeffs, rect = coeffs.copy(), rect.copy()
    coeffs[0, 0, :2] *= 1e5     # cb: |v| up to ~3e6-1e7, some >= 2^22
    coeffs[1, 3, 0] = 3e9       # c3: beyond int32 for most pixels
    coeffs[1, 1, 4] = -1e12
    coeffs[2, 3, 2] = np.inf    # c3 x: +inf
    coeffs[2, 2, 5] = -np.inf   # c2 y: -inf
    coeffs[3, 2, 0] = np.nan    # c2 x: NaN, which converts to 0 and stays valid
    coeffs[4, 0, 3] = np.inf    # cb y: inf * (y - half), and inf * 0 where
    coeffs[4, 0, 4] = 0.0       # the product meets a zero coefficient
    coeffs[4, 0, 0] = np.inf
    rect[5, 4] = 1 << 23        # remapped rows land far outside the map
    rect[5, 0], rect[5, 1] = 0, 1 << 30
    rect[4, 5] = -(1 << 31)     # a column shift that wraps in int32
    rect[4, 2], rect[4, 3] = 5, (1 << 31) - 1
    return coeffs, rect


def _float_chain(coeffs, rect, size):
    """The CUDA kernel's float-only index chain in torch f32, on centered
    coordinates: round half to even as (v + 1.5*2^23) - 1.5*2^23; d = r -
    half; `valid` from !(|d| > half) (NaN stays valid); the clip
    fmin(fmax(d, -half), half) (NaN -> -half, the centered 0); the
    rectangle remap against bounds clamped to [-1, size], moving by the
    int32 shifts (left_src - left, upper_src - upper) in float where both are
    below 2^22, through int32 otherwise (per sample, as the kernel decides
    per block). Returns source column, row (B, H, W) int64 and valid."""
    f32 = torch.float32
    coeffs, rect = torch.as_tensor(coeffs), torch.as_tensor(rect)
    b = coeffs.shape[0]
    half = torch.tensor((size - 1) / 2.0, dtype=f32)
    grid = torch.arange(size, dtype=f32) - half
    ys, xs = (t.expand(b, size, size) for t in torch.meshgrid(grid, grid, indexing="ij"))
    valid = torch.ones((b, size, size), dtype=torch.bool)

    def stage(m, xs, ys, valid):
        m = m[:, :, None, None]
        x_in = ((m[:, 0] * xs + m[:, 1] * ys) + m[:, 2]) + half
        y_in = ((m[:, 3] * xs + m[:, 4] * ys) + m[:, 5]) + half
        dx, dy = ((x_in + _ROUND) - _ROUND) - half, ((y_in + _ROUND) - _ROUND) - half
        valid = valid & ~(dx.abs() > half) & ~(dy.abs() > half)
        return (torch.fmin(torch.fmax(dx, -half), half),
                torch.fmin(torch.fmax(dy, -half), half), valid)

    xs, ys, valid = stage(coeffs[:, 0], xs, ys, valid)
    r = rect.long().view(b, 6, 1, 1)
    lo_y, hi_y, lo_x, hi_x = (r[:, i].clamp(-1, size).to(f32) - half for i in range(4))
    inside = (ys >= lo_y) & (ys < hi_y) & (xs >= lo_x) & (xs < hi_x)

    def wrap(v):  # int32 arithmetic
        return (v + 2 ** 31) % 2 ** 32 - 2 ** 31

    moved = []
    for c, d in ((ys, wrap(r[:, 4] - r[:, 0])), (xs, wrap(r[:, 5] - r[:, 2]))):
        in_float = c + torch.where(inside, d.to(f32), 0.0)
        q = (c + half).long()
        in_int = wrap(torch.where(inside, q + d, q)).to(f32) - half
        moved.append((in_float, in_int, d.abs() < 2 ** 22))
    small = moved[0][2] & moved[1][2]
    ys, xs = (torch.where(small, f, i) for f, i, _ in moved)
    for i in (3, 2, 1):
        xs, ys, valid = stage(coeffs[:, i], xs, ys, valid)
    return (xs + half).long(), (ys + half).long(), valid


def _jax_chain(coeffs, rect, size):
    """JAX's in-kernel index math (pallas_warp._chain_indices) on full
    grids, sample by sample, on the CPU."""
    import functools

    import jax

    from uda_poseestimation_tpu.ops.pallas_warp import _chain_indices

    fn = jax.jit(functools.partial(_chain_indices, size * size, size, size, 0))
    out = [[np.asarray(t).reshape(size, size) for t in fn(c, r)]
           for c, r in zip(coeffs, rect)]
    return tuple(np.stack(t) for t in zip(*out))


_CHAIN_CASES = [("random", 3, False), ("ties", 4, True), ("extreme", 13, False),
                ("extreme_ties", 14, True)]


@pytest.mark.parametrize("case,seed,ties", _CHAIN_CASES, ids=[c[0] for c in _CHAIN_CASES])
def test_float_chain_matches_plain_and_jax(case, seed, ties):
    """The kernel's float-only chain equals occlusion_indices_plain and JAX's
    _chain_indices exactly (ix, iy and valid of every pixel), on random and
    tie-provoking draws and on out-of-range stage values."""
    size = 32
    imgs, coeffs, rect = _inputs(seed, b=6, size=size, ties=ties)
    if case.startswith("extreme"):
        coeffs, rect = _extreme(coeffs, rect)
    ix, iy, valid = _float_chain(coeffs, rect, size)
    px, py, pvalid = occlusion_indices_plain(torch.from_numpy(coeffs),
                                             torch.from_numpy(rect), size)
    assert torch.equal(valid, pvalid)
    assert torch.equal(ix, px) and torch.equal(iy, py)
    jx, jy, jvalid = _jax_chain(coeffs, rect, size)
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    np.testing.assert_array_equal(ix.numpy(), jx)
    np.testing.assert_array_equal(iy.numpy(), jy)
    assert 0 < valid.float().mean() < 1


def test_extreme_warp_matches_pallas_interpret():
    """Out-of-range stage values through the whole warp: the plain version
    equals JAX's occlusion_warp_onehot(interpret=True) on the extreme
    coefficients, values and (through an iota image) index maps."""
    from uda_poseestimation_tpu.ops.pallas_warp import occlusion_warp_onehot

    size = 16
    imgs, coeffs, rect = _inputs(15, b=6, size=size)
    coeffs, rect = _extreme(coeffs, rect)
    iota = np.broadcast_to(np.arange(1, size * size + 1, dtype=np.float32)
                           .reshape(1, 1, size, size), (6, 1, size, size))
    for x in (imgs, np.ascontiguousarray(iota)):
        want = np.asarray(occlusion_warp_onehot(x, coeffs, rect, interpret=True))
        got = occlusion_warp_plain(torch.from_numpy(x), torch.from_numpy(coeffs),
                                   torch.from_numpy(rect))
        np.testing.assert_array_equal(got.numpy(), want)


def test_round_trick_is_rint():
    """(v + 1.5*2^23) - 1.5*2^23 in f32 equals torch.round for |v| < 2^22,
    ties included; beyond, it keeps the sign and stays >= 2^22 in magnitude
    (out of every map, as the saturated integer is); inf stays inf."""
    rng = np.random.RandomState(0)
    halves = np.arange(-4096, 4096, dtype=np.float32) + 0.5
    v = np.concatenate([halves, rng.uniform(-2 ** 22, 2 ** 22, 20000),
                        np.float32(2 ** 22) - np.arange(1, 64) / 8]).astype(np.float32)
    t = torch.from_numpy(v)
    assert torch.equal((t + _ROUND) - _ROUND, torch.round(t))
    big = torch.from_numpy(np.concatenate([
        rng.uniform(2 ** 22, 2 ** 31, 1000), 10.0 ** np.arange(7, 38),
        [2 ** 22, 2 ** 22 + 0.5, np.inf]]).astype(np.float32))
    for sign in (1, -1):
        r = (sign * big + _ROUND) - _ROUND
        assert bool((r * sign >= 2 ** 22).all())


def test_to_int32_saturates_as_jax():
    """The plain chain's float -> int32 conversion on the CPU: NaN -> 0 and
    out-of-range values saturate, as XLA's (and CUDA's) do, so the plain
    index chain equals JAX's compose_nearest_indices on non-finite stages."""
    import jax.numpy as jnp

    from uda_poseestimation_tpu.ops import affine as jaff
    from uda_poseestimation_torch.ops.affine import compose_nearest_indices

    size = 16
    _, coeffs, rect = _inputs(16, b=6, size=size)
    coeffs, _ = _extreme(coeffs, rect)
    grid = np.arange(size, dtype=np.float32) - (size - 1) / 2.0
    ys, xs = np.meshgrid(grid, grid, indexing="ij")
    for row in range(4):
        m = coeffs[:, row]
        got = compose_nearest_indices([torch.from_numpy(m)],
                                      torch.from_numpy(xs).expand(6, size, size),
                                      torch.from_numpy(ys).expand(6, size, size),
                                      torch.ones((6, size, size), dtype=torch.bool),
                                      size, size)
        for i in range(6):
            want = jaff.compose_nearest_indices([jnp.asarray(m[i])], jnp.asarray(xs),
                                                jnp.asarray(ys),
                                                jnp.ones((size, size), bool), size, size)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))


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


def _card(cuda, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in arrays]


def _check_on_card(imgs, coeffs, rect):
    """The kernel against the plain version on the card: NCHW and
    channels_last, both ``exact``, a second call bit-equal to the first, the
    output in the input's memory format; then the index maps, read through
    an image whose pixel values are their index + 1."""
    b, _, size, _ = imgs.shape
    for fmt in (torch.contiguous_format, torch.channels_last):
        x = imgs.contiguous(memory_format=fmt)
        for exact in (True, False):
            got = occlusion_warp(x, coeffs, rect, exact=exact)
            again = occlusion_warp(x, coeffs, rect, exact=exact)
            want = occlusion_warp_plain(x, coeffs, rect, exact=exact)
            torch.cuda.synchronize()
            assert got.is_contiguous(memory_format=fmt)
            assert torch.equal(got, want), (fmt, exact)
            assert torch.equal(again, got), (fmt, exact)
    iota = torch.arange(1, size * size + 1, device=imgs.device, dtype=torch.float32)
    iota = iota.view(1, 1, size, size).expand(b, 1, size, size).contiguous()
    ix, iy, valid = occlusion_indices_plain(coeffs, rect, size)
    idx = torch.where(valid, iy * size + ix + 1, 0).to(torch.float32)
    assert torch.equal(occlusion_warp(iota, coeffs, rect)[:, 0], idx)


@pytest.mark.gpu
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("exact", [True, False])
def test_kernel_matches_plain_on_card(cuda, exact, ties):
    """The CUDA kernel equals the plain version on the card, values and index
    maps (read through an image whose pixel values are their index + 1), for
    contiguous NCHW and channels_last inputs."""
    imgs, coeffs, rect = _card(cuda, *_inputs(5 + ties, b=8, size=256, ties=ties,
                                              jax_coeffs=False))
    for x in (imgs, imgs.contiguous(memory_format=torch.channels_last)):
        got = occlusion_warp(x, coeffs, rect, exact=exact)
        torch.cuda.synchronize()
        assert torch.equal(got, occlusion_warp_plain(x, coeffs, rect, exact=exact))
    iota = torch.arange(1, 256 * 256 + 1, device=cuda, dtype=torch.float32)
    iota = iota.view(1, 1, 256, 256).expand(8, 1, 256, 256).contiguous()
    ix, iy, valid = occlusion_indices_plain(coeffs, rect, 256)
    idx = torch.where(valid, iy * 256 + ix + 1, 0).to(torch.float32)
    assert torch.equal(occlusion_warp(iota, coeffs, rect)[:, 0], idx)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("b", [1, 33])
@pytest.mark.parametrize("size", [2, 16, 64, 256, 512])
def test_kernel_shapes_on_card(cuda, size, b, c):
    """Bit-equal at every tile geometry (one partial tile below 32, 1-256
    tiles a side), batch 1 and 33, one to five channels (five: two channel
    chunks), both layouts and both ``exact``, and repeatable."""
    _check_on_card(*_card(cuda, *_inputs(size + b + c, b=b, c=c, size=size,
                                         ties=size == 64, jax_coeffs=False)))


@pytest.mark.gpu
@pytest.mark.parametrize("size", [16, 64])
def test_kernel_extreme_coefficients_on_card(cuda, size):
    """Out-of-range stage values (|v| >= 2^22, beyond int32, +-inf, NaN) and
    a rectangle beyond 2^22: values and index maps equal the plain version,
    whose conversions saturate as the first kernel's cvt did."""
    imgs, coeffs, rect = _inputs(17, b=6, size=size, jax_coeffs=False)
    _check_on_card(*_card(cuda, imgs, *_extreme(coeffs, rect)))
