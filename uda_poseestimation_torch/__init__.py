"""PyTorch/CUDA port of uda_poseestimation_tpu.

Module names follow the JAX package so each piece has an obvious
counterpart: ``ops`` (warps, heatmaps, PCK, AdaIN statistics and the
kernels' wrappers), ``models`` (PoseResNet, StyleNet, the fused 1x1-conv +
BatchNorm pair, losses, EMA), ``parallel.train_step`` (the fused pretrain,
adapt and eval steps) and ``weights`` (Flax variables into the port's
modules). Internals are NCHW; the step's batch keeps the JAX layout (NHWC
images, NCHW heatmaps).

The hand-written Hopper kernels (``csrc/occlusion_warp.cu``,
``csrc/matmul_stats.cu``, ``csrc/warp_gather.cu``) are built with ``nvcc``
at their first launch (``_build.py``); importing the package needs neither a
card nor a compiler.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    # imported on first use, so that a torch-free module of the package
    # (the launcher) starts without importing torch
    if name == "resolve_device":
        from .device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
