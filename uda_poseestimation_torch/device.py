"""The port's default-device rule.

Every entry point takes ``device=``. ``None`` means the card,
``torch.device("cuda")``; without CUDA that raises instead of falling back to
the CPU quietly. The CPU runs only when a caller asks for it, as the tests do
with ``device="cpu"``.
"""

from __future__ import annotations

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
