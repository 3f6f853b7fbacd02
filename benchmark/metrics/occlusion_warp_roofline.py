"""Kernel B1 (csrc/occlusion_warp.cu): its bytes at 3.35 TB/s over its
device time a launch (%)."""

from benchmark.readers import kernel_roofline_pct


def read(run, cell):
    return kernel_roofline_pct(run, "occlusion_warp", "b1_bytes")
