"""Launch counts of the port's kernel wrappers, CUDA graphs included.

Each wrapper (``occlusion_warp``, ``matmul_stats``, ``warp_gather``) keeps a
plain integer ``launches``, and ``matmul_stats`` a count per variant too,
raised through ``count`` where the wrapper launches its kernel. A launch
made while a CUDA graph captures does not run then: it runs on every replay
of the graph. So inside ``recording()`` ``count`` adds such a launch to the
capture's tally, and ``replayed(tally)`` adds the tally to the counts once
per replay. A kernel captured outside ``recording()`` raises: its replays
would go uncounted.
"""

from __future__ import annotations

import collections
import contextlib

import torch

_tallies: list = []  # the tallies of the captures in progress, innermost last


def _add(wrapper, variant, n: int):
    wrapper.launches += n
    if variant is not None:
        wrapper.launches_by_variant[variant] += n


def count(wrapper, variant=None):
    """One launch of ``wrapper``'s kernel (of ``variant``, for a wrapper that
    counts by variant), made now or, while a graph captures, on each replay."""
    if torch.cuda.is_current_stream_capturing():
        if not _tallies:
            raise RuntimeError(
                f"{wrapper.__name__} was captured into a CUDA graph outside "
                "launches.recording(): its replays would not be counted")
        _tallies[-1][(wrapper, variant)] += 1
    else:
        _add(wrapper, variant, 1)


@contextlib.contextmanager
def recording():
    """A tally of the launches captured inside the block, by (wrapper,
    variant)."""
    tally = collections.Counter()
    _tallies.append(tally)
    try:
        yield tally
    finally:
        _tallies.pop()


def replayed(tally, times: int = 1):
    """Count ``times`` replays of a graph whose capture made ``tally``."""
    for (wrapper, variant), n in tally.items():
        _add(wrapper, variant, n * times)


def per_wrapper(tally) -> dict:
    """A tally's launches by wrapper name, variants summed."""
    out = collections.Counter()
    for (wrapper, _variant), n in tally.items():
        out[wrapper.__name__] += n
    return dict(out)
