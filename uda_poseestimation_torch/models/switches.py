"""The JAX package's opt-in layer switches, which the port does not have.

``UDA_STEM_MODE`` (``s2d``, ``im2col``) or ``UDA_STEM_S2D=1``,
``UDA_PHASE_DECONV=1``, ``UDA_SUBPIXEL_DECODER=1`` and ``UDA_VGG_IM2COL=1``
each select, in the JAX package, another evaluation of the same parameters
(equal to the default up to float32 summation order). Each was slower than
the default on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6), so the port
runs the default whatever they say. This module reads them once, at import,
and warns for each one set.
"""

from __future__ import annotations

import os
import warnings

# each switch -> the values that select the JAX package's other form
UNPORTED = {"UDA_STEM_MODE": ("s2d", "im2col"), "UDA_STEM_S2D": ("1",),
            "UDA_PHASE_DECONV": ("1",), "UDA_SUBPIXEL_DECODER": ("1",),
            "UDA_VGG_IM2COL": ("1",)}


def warn_unported(environ=os.environ):
    """Warn for each switch that ``environ`` sets to a value selecting the
    JAX package's other form; returns their names."""
    names = [name for name, values in UNPORTED.items() if environ.get(name) in values]
    for name in names:
        warnings.warn(f"{name}={environ[name]} selects nothing in the port: the JAX "
                      "package's form was slower than the default on an NVIDIA H100 "
                      "(PERF.md §6), so the port runs the default", stacklevel=2)
    return names


warn_unported()
