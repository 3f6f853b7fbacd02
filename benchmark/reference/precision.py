"""The reference's precisions: float32 with TF32 off, and the controls.

A control is the reference put in the program's place and computed one
precision below what the configuration states:
- ``fp8`` below bfloat16: every convolution's input and weight rounded to
  float8 e4m3 with a per-tensor scale (amax to 448) in the forward pass, and
  the gradient flowing back through each rounded operand to float8 e5m2
  (amax to 57344), the usual float8 training recipe; sums stay float32;
- ``bf16`` below TF32: bfloat16 autocast over the whole computation.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x, dtype, top):
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = amax / top
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _Fp8Operand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def fp8_operand(x):
    return _Fp8Operand.apply(x)


def set_fp8(module: torch.nn.Module, on: bool = True):
    """Round every convolution of ``module`` to float8 (``models.QConv2d``)."""
    for m in module.modules():
        if hasattr(type(m), "fp8"):
            m.fp8 = on
    return module


@contextlib.contextmanager
def computing_in(precision: str, device: torch.device):
    """float32 with TF32 off (``f32``; also under ``fp8``, whose rounding the
    modules do), or bfloat16 autocast (``bf16``)."""
    if precision not in ("f32", "fp8", "bf16"):
        raise ValueError(f"precision {precision!r}")
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.autocast(device.type, dtype=torch.bfloat16, enabled=precision == "bf16"):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
