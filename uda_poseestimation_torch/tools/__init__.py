"""The port's tools, the twins of the repository's ``tools/``.

``fixtures`` writes the blob-image RHD trees and random style weights,
``convergence`` is the small pretrain-then-adapt recipe whose PCK must rise,
``run_benchmarks`` runs the six ``script`` lines through the port's CLIs and
``run_gain_drive`` drives adaptation against a source-only control at the
deployed configuration. ``launch_distributed`` starts a trainer's local
ranks. ``export_inference`` writes a ``torch.export`` serving artifact and
``serve_benchmark`` times it. Each runs as ``python -m
uda_poseestimation_torch.tools.<name>``.
"""
