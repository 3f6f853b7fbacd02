"""The benchmark of uda_poseestimation_torch (see run.py and PERF.md)."""
