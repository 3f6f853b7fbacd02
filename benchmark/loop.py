"""The pieces the drivers share: the window's clock, the feeds that serve a
seeded pool of batches and end the window, and the device helpers."""

from __future__ import annotations

import gc
import time

import torch
from torch.profiler import record_function


class Clock:
    """The measured window: ``start(seconds)`` opens it; ``expired`` once
    ``seconds`` have passed. Before ``start`` it never expires."""

    def __init__(self):
        self.t0 = None
        self.deadline = None

    def start(self, seconds: float):
        self.t0 = time.perf_counter()
        self.deadline = self.t0 + seconds

    def elapsed(self) -> float:
        return 0.0 if self.t0 is None else time.perf_counter() - self.t0

    @property
    def expired(self) -> bool:
        return self.deadline is not None and time.perf_counter() >= self.deadline


class Feed:
    """An iterator over ``pool`` (cycled) that a program's loop draws from;
    with ``clock`` it raises StopIteration once the window is over, which
    ends the program's loop there. ``served`` counts the items given."""

    def __init__(self, pool, clock: Clock = None, pick=lambda item: item):
        self.pool = pool
        self.clock = clock
        self.pick = pick
        self.served = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.clock is not None and self.clock.expired:
            raise StopIteration
        with record_function("bench.batch"):
            item = self.pick(self.pool[self.served % len(self.pool)])
        self.served += 1
        return item


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def release(device):
    """Free what the program held before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def leaf_norms(named) -> dict:
    """name -> float64 norm of each tensor of ``named`` (name, tensor) pairs."""
    return {n: float(t.detach().double().norm()) for n, t in named}
