#!/usr/bin/env python3
"""A/B probe of the port's two gather kernels on one GPU: another checkout's
``occlusion_warp`` and ``warp_gather`` against this tree's, in one process.

    python3 probe_gathers.py --parent DIR [--out FILE] [--iters N]

``DIR`` holds another checkout of the repository (for example the parent
commit unpacked by ``git archive``). Its ``uda_poseestimation_torch`` package
is imported under another name and called through its own wrappers, so it
builds its own sources and the two C interfaces may differ. Each kernel is
first checked bit-equal to its plain version, then timed like
``chip_smoke.cuda_ms`` (CUDA events, L2 flushed before each launch) in turns
parent, this, this, parent:

- occlusion_warp at the main path's call (32, 3, 256, 256), channels_last,
  ``exact=False`` and ``exact=True``; and the same call with the last stage
  moved 10^4 pixels off the map, so that every pixel is invalid: the index
  chain and the stores run, no gather load is issued (chain and stores
  only); beside it the gather half alone (this tree's ``warp_gather`` on the
  call's index maps over the NCHW copy, and ``torch.gather`` on them);
- warp_gather at (32, 21, 64, 64) on uniformly random indices and on the
  heatmap reconstruction's index maps.

Each measurement is taken with the L2 flushed as ``cuda_ms`` does (128 MB
written, so the timed kernel pays the write-back of dirty lines) and with a
clean flush (128 MB read). Beside the kernels: an empty launch (one element
zeroed) and a copy of the same bytes, the method's floor.

One JSON line per measurement; ``--out`` also writes them as a list.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import sys

REPO = os.path.dirname(os.path.abspath(__file__))


def _import_checkout(root, name="parent_port"):
    """The ``uda_poseestimation_torch`` package of the checkout at ``root``,
    imported as ``name``; returns its occlusion_warp and warp_gather."""
    pkg = os.path.join(os.path.abspath(root), "uda_poseestimation_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    occ = importlib.import_module(f"{name}.ops.occlusion_warp").occlusion_warp
    gather = importlib.import_module(f"{name}.ops.warp_gather").warp_gather
    return occ, gather


def _time(fn, iters, flush):
    """``chip_smoke.cuda_ms`` with ``flush`` a callable."""
    import torch

    from chip_smoke import SLEEP_CYCLES

    fn()
    pairs = []
    for _ in range(iters):
        flush()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _turns(fns, iters, flushes):
    """Times of each of ``fns`` (name -> fn) under each flush (name ->
    callable), in turns a, b, ..., b, a: both runs of each."""
    names = list(fns)
    out = {}
    for how, flush in flushes.items():
        runs = {n: [] for n in names}
        for n in names + names[::-1]:
            runs[n].append(_time(fns[n], iters, flush))
        out[how] = runs
    return out


def _baselines(x):
    """An empty launch and a copy of x's bytes (read and write once)."""
    one = x.new_zeros(1)
    out = x.new_empty(x.shape)
    return {"empty launch": one.zero_, "copy": lambda: out.copy_(x)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", required=True, help="another checkout's root")
    parser.add_argument("--out", default=None, help="also write the lines here (JSON)")
    parser.add_argument("--iters", type=int, default=50)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("probe_gathers: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import MAIN_B, MAIN_K, heatmap_indices, nvidia_smi_line, warp_inputs
    from uda_poseestimation_torch.ops.occlusion_warp import (
        occlusion_indices_plain, occlusion_warp, occlusion_warp_plain)
    from uda_poseestimation_torch.ops.warp_gather import warp_gather, warp_gather_plain

    lines = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    device = torch.device("cuda", 0)
    emit({"probe": "env", "device": torch.cuda.get_device_name(device),
          "nvidia_smi": nvidia_smi_line(), "parent": os.path.abspath(args.parent)})
    parent_occ, parent_gather = _import_checkout(args.parent)
    occ = {"parent": parent_occ, "this": occlusion_warp}
    gather = {"parent": parent_gather, "this": warp_gather}

    flush = torch.empty(128 * 2**20 // 4, device=device)
    flushes = {"dirty": flush.zero_, "clean": flush.sum}
    b, size = MAIN_B, 256
    imgs, coeffs, rect = warp_inputs(4, b, size, False, device)
    x = imgs.contiguous(memory_format=torch.channels_last)
    off_map = coeffs.clone()
    off_map[:, 1, 2] += 1e4  # c1, the last stage: every pixel leaves the map
    off_map[:, 1, 5] += 1e4
    for exact in (False, True):
        for c, what in ((coeffs, "full"), (off_map, "chain and stores only")):
            want = occlusion_warp_plain(x, c, rect, exact=exact)
            for label, fn in occ.items():
                if not torch.equal(fn(x, c, rect, exact=exact), want):
                    raise AssertionError(f"occlusion_warp ({label}, {what}) != plain")
            if what != "full" and bool(want.any()):
                raise AssertionError("the off-map coefficients left a pixel in the map")
            fns = {t: (lambda f=f, c=c: f(x, c, rect, exact=exact)) for t, f in occ.items()}
            if what == "full":
                fns.update(_baselines(x))
            emit({"probe": "occlusion_warp", "what": what, "shape": list(x.shape),
                  "channels_last": True, "exact": exact,
                  "ms": _turns(fns, args.iters, flushes)})

    # the gather half alone: the same call's index maps over the NCHW copy
    ix, iy, valid = occlusion_indices_plain(coeffs, rect, size)
    ix, iy, valid = (t.reshape(b, size * size) for t in (ix.int(), iy.int(), valid))
    nchw = imgs.contiguous()
    src = torch.where(valid, iy * size + ix, 0).long()[:, None].expand(b, 3, size * size)
    emit({"probe": "occlusion_gather_half", "shape": list(nchw.shape), "exact": False,
          "ms": _turns({"warp_gather": lambda: warp_gather(nchw, ix, iy, valid, exact=False),
                        "torch.gather": lambda: nchw.view(b, 3, -1).gather(2, src)},
                       args.iters, flushes)})

    # warp_gather: random indices, then the heatmap reconstruction's maps
    k, h = MAIN_K, 64
    gen = torch.Generator(device=device).manual_seed(0)
    hms = torch.randn(b, k, h, h, device=device, generator=gen)
    inputs = {
        "random": (torch.randint(-2, h + 2, (b, h * h), device=device, generator=gen,
                                 dtype=torch.int32),
                   torch.randint(-2, h + 2, (b, h * h), device=device, generator=gen,
                                 dtype=torch.int32),
                   torch.rand(b, h * h, device=device, generator=gen) > 0.1),
        "heatmap": tuple(heatmap_indices(b, h, 0, device))}
    for name, (gx, gy, gv) in inputs.items():
        want = warp_gather_plain(hms, gx, gy, gv)
        for label, fn in gather.items():
            if not torch.equal(fn(hms, gx, gy, gv), want):
                raise AssertionError(f"warp_gather ({label}) != plain on {name} indices")
        fns = {t: (lambda f=f: f(hms, gx, gy, gv)) for t, f in gather.items()}
        fns.update(_baselines(hms))
        emit({"probe": "warp_gather", "indices": name, "shape": list(hms.shape),
              "ms": _turns(fns, args.iters, flushes)})

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
