"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), loaded with ``ctypes``. The library is keyed by a hash of its
source and the flags and kept in ``csrc/_build/`` (git-ignored), so the first
launch in a fresh checkout builds it and later processes reuse it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# every kernel of the port, one source each
KERNELS = ("occlusion_warp", "matmul_stats", "warp_gather")

_lock = threading.Lock()
_loaded: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the port's CUDA kernels are built from source at first use")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(*names: str) -> list:
    """Compile each ``csrc/<name>.cu`` whose library does not exist yet, one
    ``nvcc`` process per source, all started together; returns the library
    paths in the order of ``names``.

    Each compiler writes to a per-process temporary name that is renamed into
    place, so concurrent processes never load a half-written file.
    """
    outs = [library_path(name) for name in names]
    jobs = []
    for name, out in zip(names, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((name, cmd, tmp, out, proc))
    failed = []
    for name, cmd, tmp, out, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"nvcc failed ({proc.returncode}) building {name}:\n"
                          f"{' '.join(cmd)}\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build(name)[0]))
        return _loaded[name]
