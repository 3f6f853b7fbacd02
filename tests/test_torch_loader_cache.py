"""The port's decoded-canvas cache (``data/loader.py::CachedDataset``): the
JAX package's ``tests/test_loader_cache.py`` against it, plus what the
port's forked loader workers add: one cache in shared memory, so an item
decoded by any worker is a hit for every worker afterwards, counted in the
parent, and the byte budget is spent once for the run.

Tolerance: fp16 storage of float canvases off the uint8 grid, 2e-3 (as in
the JAX test); everything else exact.
"""

import numpy as np
import torch

from uda_poseestimation_tpu.data.loader import CachedDataset as JCachedDataset
from uda_poseestimation_torch.data.loader import CachedDataset, make_loader


class CountingDataset:
    num_keypoints = 4

    def __init__(self, n=6):
        self.n = n
        self.calls = 0
        rng = np.random.RandomState(0)
        self.canvases = rng.rand(n, 32, 32, 3).astype(np.float32) * 5 - 2.5
        self.kps = rng.rand(n, 4, 2).astype(np.float32) * 32

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.calls += 1
        return (self.canvases[i], self.kps[i],
                {"keypoint2d": self.kps[i], "index": i})


class U8Dataset(CountingDataset):
    """Canvases exactly on the uint8/255 grid (PIL-decoded)."""

    def __init__(self, n=6):
        super().__init__(n)
        rng = np.random.RandomState(1)
        self.canvases = rng.randint(0, 256, (n, 32, 32, 3)).astype(np.float32) / 255.0


def test_cache_hits_and_values():
    base = CountingDataset()
    ds = CachedDataset(base)
    first = [ds[i] for i in range(len(ds))]
    assert base.calls == len(base)
    second = [ds[i] for i in range(len(ds))]
    assert base.calls == len(base)  # no re-decode on the second epoch
    assert (ds.misses, ds.hits, ds.items_cached) == (6, 6, 6)
    jds = JCachedDataset(CountingDataset())
    [jds[i] for i in range(len(jds))]
    jsecond = [jds[i] for i in range(len(jds))]

    for (c1, k1, m1), (c2, k2, m2), (jc, _, _) in zip(first, second, jsecond):
        # canvases round-trip through fp16 storage, as in JAX; small arrays
        # stay exact
        np.testing.assert_allclose(c2, c1, atol=2e-3)
        np.testing.assert_array_equal(c2, jc)
        assert c2.dtype == np.float32
        np.testing.assert_array_equal(k2, k1)
        np.testing.assert_array_equal(m2["keypoint2d"], m1["keypoint2d"])
        assert m2["index"] == m1["index"]

    # attribute passthrough (num_keypoints, etc.)
    assert ds.num_keypoints == 4
    assert len(ds) == len(base)


def test_cache_u8_grid_canvases_lossless():
    """Canvases on the uint8/255 grid round-trip BIT-EXACTLY (uint8
    storage), so the uint8 transport stays on downstream of the cache; uint8
    canvases (ToUint8Canvas) are stored as they are."""
    ds = CachedDataset(U8Dataset())
    first = [ds[i][0].copy() for i in range(len(ds))]
    second = [ds[i][0] for i in range(len(ds))]
    for c1, c2 in zip(first, second):
        np.testing.assert_array_equal(c2, c1)
        assert c2.dtype == np.float32

    class Raw(U8Dataset):
        def __getitem__(self, i):
            item = super().__getitem__(i)
            return (np.round(item[0] * 255).astype(np.uint8),) + item[1:]

    raw = CachedDataset(Raw())
    a = [raw[i][0].copy() for i in range(len(raw))]
    b = [raw[i][0] for i in range(len(raw))]
    for c1, c2 in zip(a, b):
        assert c2.dtype == np.uint8
        np.testing.assert_array_equal(c2, c1)


def _item_bytes():
    """The stored size of one CountingDataset item (all are alike)."""
    ds = CachedDataset(CountingDataset(n=1))
    ds[0]
    return ds.bytes_used


def test_cache_byte_bound():
    base = CountingDataset()
    ds = CachedDataset(base, max_bytes=_item_bytes() * 2.5)
    for i in range(len(ds)):
        ds[i]
    cached = ds.items_cached
    assert cached == 2  # bounded, not unbounded
    assert ds.bytes_used <= ds.max_bytes
    base.calls = 0
    for i in range(len(ds)):
        ds[i]
    assert base.calls == len(base) - cached  # uncached items pass through


def test_cache_cap_hit_logged_once(capsys):
    """Crossing the byte budget emits ONE visible line (items cached /
    dataset size), as in JAX; an under-budget cache never logs."""
    base = CountingDataset()
    ds = CachedDataset(base, max_bytes=_item_bytes() * 2.5)
    for _ in range(2):  # two epochs: the line must not repeat
        for i in range(len(ds)):
            ds[i]
    out = capsys.readouterr().out
    lines = [line for line in out.splitlines() if "cache budget full" in line]
    assert len(lines) == 1
    assert f"{ds.items_cached}/{len(base)} items" in lines[0]

    ds_big = CachedDataset(CountingDataset(), max_bytes=1e9)
    for i in range(len(ds_big)):
        ds_big[i]
    assert "cache budget full" not in capsys.readouterr().out


def test_cache_composes_with_loader():
    base = CountingDataset()
    ds = CachedDataset(base)
    loader = make_loader(ds, batch_size=3)
    b1 = next(iter(loader))
    b2 = next(iter(loader))
    np.testing.assert_allclose(b2[0], b1[0], atol=2e-3)
    assert base.calls == 3


class WorkerDataset(U8Dataset):
    """Records the loader worker that decodes each item (0 in the main
    process)."""

    def __getitem__(self, i):
        c, k, meta = super().__getitem__(i)
        info = torch.utils.data.get_worker_info()
        return c, k, dict(meta, worker=0 if info is None else info.id)


def test_forked_workers_share_one_cache():
    """Two forked workers over three passes: the first pass decodes every
    item once (in both workers), every later fetch is a hit, whichever
    worker it lands on, and the parent reads the counts; the bytes are
    those of one process caching the same items."""
    n = 12
    ds = CachedDataset(WorkerDataset(n=n), max_bytes=1e6)
    loader = make_loader(ds, batch_size=3, shuffle=True, num_workers=2)
    torch.manual_seed(0)
    decoders = set()
    for epoch in range(3):
        seen = []
        for _c, _k, meta in loader:
            seen += meta["index"].tolist()
            decoders |= set(meta["worker"].tolist())
        assert sorted(seen) == list(range(n))
        assert (ds.misses, ds.hits) == (n, n * epoch), epoch
    assert decoders == {0, 1}
    assert ds.items_cached == n
    assert ds.dataset.calls == 0  # the parent decoded nothing

    single = CachedDataset(WorkerDataset(n=n), max_bytes=1e6)
    for i in range(n):
        single[i]
    assert ds.bytes_used == single.bytes_used
