"""Probe: how far apart are the two packages' bf16 serving artifacts?

    JAX_PLATFORMS=cpu python tests/serving_bf16_probe.py

Prints, on the CPU, for input seeds 0-5, the port's ``torch.export``
artifact against the JAX package's ``jax.export`` artifact, both bf16 and
for the CPU, built from the same weights as ``tests/test_torch_serving.py``
builds them: the tiny BasicBlock [1, 1] PoseResNet (b=4) and the
JAX-written pose_resnet50 checkpoint through both packages' loaders (b=2).
For each: the largest heatmap difference, the largest heatmap magnitude,
the largest excess of a difference over 2e-2 of the JAX value (the atol
that rtol 2e-2 leaves to cover), the largest maxval difference, the share
of keypoints whose top-2 margin exceeds 8e-3, and how many of those have
different preds. These numbers set the bf16 tolerance of
tests/test_torch_serving.py.
"""

import os
import pathlib
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

TESTS = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(TESTS.parent), str(TESTS)]

import test_torch_serving as t  # noqa: E402
from tools import export_inference as jax_export  # noqa: E402
from uda_poseestimation_torch.tools import export_inference as ei  # noqa: E402


def _report(name, jax_artifact, program, b):
    for seed in range(6):
        x = t._images(seed, b)
        want = [np.asarray(o) for o in jax_artifact.call(x)]
        got = t._call(program, x)
        diff = np.abs(got[0] - want[0])
        decisive = t._decisive(want[0], 8e-3)
        eq = (got[1] == want[1]).all(axis=-1)
        print(f"{name} seed {seed}: max |diff| {diff.max():.4g}, max |hm| "
              f"{np.abs(want[0]).max():.4g}, max(|diff| - 2e-2 |hm|) "
              f"{(diff - 2e-2 * np.abs(want[0])).max():.4g}, maxvals "
              f"{np.abs(got[2] - want[2]).max():.4g}, decisive {decisive.mean():.2f}, "
              f"decisive preds differing {(decisive & ~eq).sum()}")


def main():
    torch.set_num_threads(2)
    jmodel = t.JPoseResNet(backbone=t.JResNet(block=t.JBasic, stage_sizes=(1, 1)),
                           num_keypoints=t.K)
    x = jnp.zeros((1, t.SIZE, t.SIZE, 3), jnp.float32)
    variables = t._scaled(jax.jit(lambda r: jmodel.init(r, x, train=False))(
        jax.random.PRNGKey(0)), 1)
    jbf16 = t.JPoseResNet(backbone=t.JResNet(block=t.JBasic, stage_sizes=(1, 1),
                                             dtype=jnp.bfloat16),
                          num_keypoints=t.K, dtype=jnp.bfloat16)
    restored = jax.export.deserialize(bytearray(
        jax_export.export_model(jbf16, variables, t.SIZE, ["cpu"]).serialize()))
    model = t._port_tiny(variables, torch.bfloat16)
    _report("tiny", restored, ei.export_model(model, t.SIZE, "cpu").module(), 4)

    from uda_poseestimation_tpu.models import pose_resnet50
    from uda_poseestimation_tpu.utils.checkpoint import save_checkpoint

    r50 = pose_resnet50(num_keypoints=t.K, dtype=jnp.bfloat16)
    entry = t._scaled(jax.jit(lambda r: r50.init(r, x, train=False))(
        jax.random.PRNGKey(2)), 3)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "best.pth")
        save_checkpoint(ckpt, {"student": entry, "teacher": entry, "epoch": 0})
        jm, jv = jax_export.load_variables(ckpt, "pose_resnet50", t.K, t.SIZE)
        restored = jax.export.deserialize(bytearray(
            jax_export.export_model(jm, jv, t.SIZE, ["cpu"]).serialize()))
        model = ei.load_model(ckpt, "pose_resnet50", t.K, device="cpu")
    _report("pose_resnet50", restored, ei.export_model(model, t.SIZE, "cpu").module(), 2)


if __name__ == "__main__":
    main()
