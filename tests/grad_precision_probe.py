"""Probe: how exact are float32 train-mode gradients of the tiny test model?

    JAX_PLATFORMS=cpu python tests/grad_precision_probe.py

Prints, on the CPU, for the tiny PoseResNet of tests/test_torch_train_step.py
(Bottleneck (1,1,1,1), b=4, 64² images, same weights in both packages):

- the JAX package's float32 gradients against its float64 ones, with Flax's
  fast variance (the default) and with the two-pass variance;
- the port's float32 gradients against its float64 ones;
- the two packages' float64 gradients against each other;
- how far a 1e-6 relative change of the input moves the port's float64
  gradients (the model's own sensitivity, which bounds how closely two
  float32 implementations can agree);
- the fused 1x1-conv + BatchNorm path (``fuse_bn=True``, the JAX package's
  ``UDA_BN_FUSE=1``): the port's float64 gradients against JAX's unfused
  and fused float64 ones (both packages' fused GEMMs accumulate in float32
  even for float64 inputs).

Errors are the largest per-tensor value of max|a - b| / max|b| and of
||a - b|| / ||b||. These numbers justify the gradient tolerances of
tests/test_torch_train_step.py, tests/test_torch_bn_fuse.py and
chip_smoke.py (PERF.md, ROADMAP C).
"""

import copy
import os
import pathlib
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import flax.linen.normalization as flax_norm  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_train_step as T  # noqa: E402
from uda_poseestimation_tpu.models.pose_resnet import PoseResNet as JPoseResNet  # noqa: E402
from uda_poseestimation_tpu.models.resnet import Bottleneck as JBottleneck  # noqa: E402
from uda_poseestimation_tpu.models.resnet import ResNet as JResNet  # noqa: E402
from uda_poseestimation_torch.models import Bottleneck  # noqa: E402


def errors(a, b):
    rel_max = max(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max() for k in b)
    rel_norm = max(np.linalg.norm(a[k] - b[k]) / np.linalg.norm(b[k]) for k in b)
    return f"max-rel {rel_max:.3g}, norm-rel {rel_norm:.3g}"


def main():
    _, variables, _, _, tmodel, _ = T._models()
    rng = np.random.RandomState(0)
    x = rng.randn(4, 64, 64, 3)
    g_out = rng.randn(4, 5, 16, 16)

    def jax_grads(dtype, fuse=False):
        model = JPoseResNet(backbone=JResNet(block=JBottleneck, stage_sizes=(1, 1, 1, 1),
                                             dtype=dtype, fuse_bn=fuse),
                            num_keypoints=5, dtype=dtype)
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), t)
        stats = cast(variables["batch_stats"])

        def loss(p):
            y, _ = model.apply({"params": p, "batch_stats": stats}, jnp.asarray(x, dtype),
                               train=True, mutable=["batch_stats"])
            return jnp.sum(y * g_out)

        g = jax.device_get(jax.grad(loss)(cast(variables["params"])))
        return {k: np.asarray(v, np.float64)
                for k, v in T.weights.pose_resnet_state_dict({"params": g}).items()}

    def port_grads(dtype, inp, fuse=False):
        m = copy.deepcopy(tmodel).to(dtype).train()
        for block in m.modules():
            if isinstance(block, Bottleneck):
                block.fuse_bn = fuse
        y = m.head(m.upsampling(m.backbone(torch.tensor(inp, dtype=dtype).permute(0, 3, 1, 2))))
        (y * torch.tensor(g_out, dtype=dtype)).sum().backward()
        return {n: p.grad.double().numpy() for n, p in m.named_parameters()}

    with jax.enable_x64(True):
        j64 = jax_grads(jnp.float64)
        j32 = jax_grads(jnp.float32)
        j64_fused = jax_grads(jnp.float64, fuse=True)
        fast = flax_norm._compute_stats
        flax_norm._compute_stats = lambda *a, **k: fast(*a, **{**k, "use_fast_variance": False})
        try:
            j32_two_pass = jax_grads(jnp.float32)
            j64_two_pass = jax_grads(jnp.float64)
        finally:
            flax_norm._compute_stats = fast
    t64, t32 = port_grads(torch.float64, x), port_grads(torch.float32, x)
    noisy = x * (1 + 1e-6 * np.random.RandomState(1).randn(*x.shape))
    t64_noisy = port_grads(torch.float64, noisy)
    t64_fused = port_grads(torch.float64, x, fuse=True)

    print("JAX f32 vs JAX f64 (fast variance):    ", errors(j32, j64))
    print("JAX f32 vs JAX f64 (two-pass variance):", errors(j32_two_pass, j64_two_pass))
    print("port f32 vs port f64:                  ", errors(t32, t64))
    print("port f64 vs JAX f64:                   ", errors(t64, j64))
    print("port f64, input x (1 + 1e-6 noise):    ", errors(t64_noisy, t64))
    print("port fused f64 vs JAX unfused f64:     ", errors(t64_fused, j64))
    print("port fused f64 vs JAX fused f64:       ", errors(t64_fused, j64_fused))


if __name__ == "__main__":
    main()
