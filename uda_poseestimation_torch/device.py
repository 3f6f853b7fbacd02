"""The port's default-device rule.

Every entry point takes ``device=``. ``None`` means the card,
``torch.device("cuda")``; without CUDA that raises instead of falling back to
the CPU quietly. The CPU runs only when a caller asks for it, as the tests do
with ``device="cpu"``.

``device_scalar`` and ``device_vector`` make the steps' constants on their
device without a copy from host memory, which a CUDA graph's capture forbids.
``full_f32`` runs float32 products in full float32 where the JAX package
asks for ``precision="float32"``.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Return the device an entry point runs on (see the module docstring)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "uda_poseestimation_torch runs on a CUDA device by default and "
            "none is available; pass device='cpu' to run on the CPU")
    return dev


def device_scalar(value, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``value`` as a 0-d ``dtype`` tensor on ``device``.

    A tensor is converted (a no-op for one already there, such as a CUDA
    graph's static input); a Python number is written by a fill on the
    device. Neither copies from host memory: such a copy waits for the
    device, which a CUDA graph's capture forbids, and costs the host-paced
    step a round trip. ``torch.full`` rounds a number to ``dtype`` as
    ``torch.tensor`` does.
    """
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    return torch.full((), value, dtype=dtype, device=device)


def device_vector(values, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A 1-d ``dtype`` tensor of Python numbers on ``device``, made by fills
    as ``device_scalar`` makes one."""
    return torch.stack([torch.full((), v, dtype=dtype, device=device) for v in values])


@contextlib.contextmanager
def full_f32(device: torch.device):
    """float32 products: TF32 and autocast off inside, restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.autocast(device.type, enabled=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
