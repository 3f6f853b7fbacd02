"""The port's serving path (``uda_poseestimation_torch/tools/export_inference.py``
and ``serve_benchmark.py``) against the JAX package's
(``tools/export_inference.py``, ``tools/serve_benchmark.py``).

The same weights go into both packages (``weights.load_pose_resnet``) and
the same numpy images into both artifacts: the port's ``torch.export``
artifact, exported and loaded on the CPU, and the JAX package's
``jax.export`` artifact for the CPU, deserialized and called. The model is
the tiny BasicBlock [1, 1] PoseResNet at 32², K = 3, with its deconv and
head kernels scaled up so that the heatmaps are of order one and their
peaks decisive (their init std is 0.001); the checkpoint path uses a
JAX-written pose_resnet50 at 32², as ``tests/test_export.py`` does.

Tolerances:
- float32: heatmaps and maxvals within 1e-5 of the largest heatmap
  magnitude (XLA's and ATen's CPU convolutions sum in different orders);
  preds equal where the top-2 margin is decisive (2e-5, the JAX selfcheck's).
- bf16: rtol 2e-2, as in the JAX selfcheck, but atol 1.2e-2, not its
  4e-3, which holds one package's artifact against its own direct forward.
  Both packages round to bf16 after every op (convolution, BatchNorm,
  ReLU, residual add), but compute inside the convolutions and BatchNorms
  differently (oneDNN against XLA), so one-ulp differences add up layer by
  layer: measured on the CPU at six input seeds
  (``tests/serving_bf16_probe.py``), the heatmaps (largest magnitude
  0.7-0.9) differ by at most 0.0098, and by at most 0.0080 more than 2e-2
  of the JAX value (tiny model 0.0060, pose_resnet50 0.0080).
  Preds must be equal where the margin exceeds the JAX selfcheck's 8e-3
  (they were at every seed).
"""

import json
import os
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import export_inference as jax_export
from uda_poseestimation_tpu.models.pose_resnet import PoseResNet as JPoseResNet
from uda_poseestimation_tpu.models.resnet import BasicBlock as JBasic
from uda_poseestimation_tpu.models.resnet import ResNet as JResNet
from uda_poseestimation_torch import weights
from uda_poseestimation_torch.models import BasicBlock, PoseResNet, ResNet
from uda_poseestimation_torch.ops.heatmap import get_max_preds
from uda_poseestimation_torch.tools import export_inference as ei
from uda_poseestimation_torch.tools import serve_benchmark as sb

SIZE, K = 32, 3
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# heatmaps and maxvals: atol, rtol; the decisive top-2 margin
TOL = {"float32": dict(atol=None, rtol=0.0, margin=2e-5),
       "bfloat16": dict(atol=1.2e-2, rtol=2e-2, margin=8e-3)}
F32_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the Tier-1 run puts six test processes on the
    host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _scaled(variables, seed):
    """Non-trivial running statistics, and deconv and head kernels at a
    scale whose outputs the ReLUs do not all cut."""
    rng = np.random.RandomState(seed)
    stats = jax.tree_util.tree_map(
        lambda v: (v + 0.05 * rng.randn(*v.shape)).astype(np.float32),
        jax.device_get(variables["batch_stats"]))
    params = jax.tree_util.tree_map(np.array, jax.device_get(variables["params"]))
    for i in range(3):
        params["upsampling"][f"deconv{i}"]["kernel"] *= 30.0
    params["head"]["kernel"] *= 100.0
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def tiny_variables():
    jmodel = JPoseResNet(backbone=JResNet(block=JBasic, stage_sizes=(1, 1)), num_keypoints=K)
    x = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    return _scaled(jax.jit(lambda r: jmodel.init(r, x, train=False))(jax.random.PRNGKey(0)), 1)


def _port_tiny(variables, dtype):
    model = PoseResNet(ResNet(BasicBlock, (1, 1)), K, dtype=dtype)
    return weights.load_pose_resnet(model, variables)


@pytest.fixture(scope="module")
def artifacts(tiny_variables, tmp_path_factory):
    """Each dtype's JAX artifact (deserialized) and the port's (saved, then
    loaded), from the same weights."""
    out = {}
    for name, (jdtype, tdtype) in DTYPES.items():
        jmodel = JPoseResNet(backbone=JResNet(block=JBasic, stage_sizes=(1, 1), dtype=jdtype),
                             num_keypoints=K, dtype=jdtype)
        restored = jax.export.deserialize(bytearray(
            jax_export.export_model(jmodel, tiny_variables, SIZE, ["cpu"]).serialize()))
        model = _port_tiny(tiny_variables, tdtype)
        path = str(tmp_path_factory.mktemp("serving") / f"tiny_{name}.pt2")
        meta = ei.save_artifact(ei.export_model(model, SIZE, "cpu"), path,
                                ei.artifact_meta(model, "tiny", SIZE))
        exported, loaded_meta = ei.load_artifact(path, "cpu")
        out[name] = dict(name=name, jax=restored, model=model, path=path, meta=meta,
                         loaded_meta=loaded_meta, program=exported.module())
    return out


@pytest.fixture(params=sorted(DTYPES))
def pair(request, artifacts):
    return artifacts[request.param]


def _images(seed, b):
    return np.random.RandomState(seed).rand(b, SIZE, SIZE, 3).astype(np.float32)


def _call(program, x):
    with torch.no_grad():
        return [o.numpy() for o in program(torch.from_numpy(x))]


def _decisive(heatmaps, margin):
    flat = heatmaps.reshape(heatmaps.shape[0], heatmaps.shape[1], -1)
    top2 = np.partition(flat, -2, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > margin


def test_artifact_matches_jax_artifact(pair):
    """The port's CPU artifact against the JAX artifact on the same images:
    heatmaps and maxvals within the dtype's tolerance, preds equal wherever
    the JAX heatmaps' top-2 margin is decisive (most keypoints)."""
    x = _images(1, 4)
    want_hm, want_preds, want_mv = (np.asarray(o) for o in pair["jax"].call(x))
    hm, preds, mv = _call(pair["program"], x)
    # the two-stage backbone's stride is 8, and the three deconvs undo it
    assert hm.shape == want_hm.shape == (4, K, SIZE, SIZE) and hm.dtype == np.float32
    assert preds.shape == (4, K, 2) and mv.shape == (4, K, 1)
    tol = TOL[pair["name"]]
    atol = tol["atol"] if tol["atol"] is not None else F32_REL * float(np.abs(want_hm).max())
    np.testing.assert_allclose(hm, want_hm, rtol=tol["rtol"], atol=atol)
    np.testing.assert_allclose(mv, want_mv, rtol=tol["rtol"], atol=atol)
    decisive = _decisive(want_hm, tol["margin"])
    assert decisive.mean() > 0.5
    eq = (preds == want_preds).all(axis=-1)
    assert eq[decisive].all(), f"{(decisive & ~eq).sum()} decisive keypoints differ"
    # the decode is the artifact's own argmax of its heatmaps
    own, _ = get_max_preds(torch.from_numpy(hm))
    np.testing.assert_array_equal(preds, own.numpy())


def test_artifact_metadata(pair):
    """The artifact records its device type, arch, K, S and dtype, and
    reads back as it was written."""
    assert pair["loaded_meta"] == pair["meta"] == ei.read_meta(pair["path"])
    assert {k: pair["meta"][k] for k in ("arch", "num_keypoints", "image_size", "dtype",
                                         "device_type")} == {
        "arch": "tiny", "num_keypoints": K, "image_size": SIZE, "dtype": pair["name"],
        "device_type": "cpu"}


@pytest.mark.parametrize("b", [1, 5])
def test_dynamic_batch(pair, b):
    """One artifact serves any batch, b = 1 too, and equals a direct
    forward of the module it was exported from."""
    x = _images(b, b)
    hm, preds, mv = _call(pair["program"], x)
    assert hm.shape == (b, K, SIZE, SIZE) and preds.shape == (b, K, 2)
    assert np.isfinite(hm).all()
    with torch.no_grad():
        want = [o.numpy() for o in ei.InferenceModel(pair["model"])(torch.from_numpy(x))]
    for got, ref in zip((hm, preds, mv), want):
        np.testing.assert_array_equal(got, ref)


_TORCH_ONLY_CHILD = """
import sys, torch
images, *paths = sys.argv[1:]
outputs = []
for path in paths:
    with torch.no_grad():
        outputs.append(torch.export.load(path).module()(torch.load(images)))
mods = sorted(m for m in sys.modules if m.split(".")[0] in (
    "uda_poseestimation_torch", "uda_poseestimation_tpu", "tools", "jax", "flax"))
assert not mods, mods
torch.save(outputs, images + ".out")
"""


def test_artifacts_load_in_a_torch_only_process(artifacts, tmp_path):
    """A process that imports only torch (isolated mode, the repository not
    on its path) loads each artifact and computes what this process does."""
    x = _images(7, 3)
    images = str(tmp_path / "images.pt")
    torch.save(torch.from_numpy(x), images)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-I", "-c", _TORCH_ONLY_CHILD, images,
                           *(a["path"] for a in artifacts.values())],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for got, pair in zip(torch.load(images + ".out"), artifacts.values()):
        for g, want in zip(got, _call(pair["program"], x)):
            np.testing.assert_array_equal(g.numpy(), want)


def test_artifact_convolutions_run_in_the_model_dtype(pair):
    """The autocast region is recorded for the device type the artifact was
    exported on, and its convolutions run in the model's dtype: in the
    graph (every convolution node's value) and when it runs."""
    dtype = DTYPES[pair["name"]][1]
    exported, _ = ei.load_artifact(pair["path"], "cpu")
    convs, autocast = [], []
    for gm in exported.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for node in gm.graph.nodes:
                if node.op != "call_function":
                    continue
                if node.target in (torch.ops.aten.conv2d.default,
                                   torch.ops.aten.conv_transpose2d.input):
                    convs.append(node.meta["val"].dtype)
                if node.target is torch.ops.higher_order.wrap_with_autocast:
                    autocast.append(node.args[:2])
    assert len(convs) == 10 and set(convs) == {dtype}, convs
    if dtype == torch.bfloat16:
        assert autocast == [("cpu", torch.bfloat16)]
    _, ran = ei.convolution_dtypes(pair["program"], torch.from_numpy(_images(3, 2)))
    assert ran == {dtype}


def _with_meta(src, dst, **changes):
    """A copy of the artifact ``src`` whose metadata has ``changes``."""
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for item in zin.infolist():
            data = zin.read(item)
            if item.filename.endswith("/extra/" + ei.META_FILE):
                data = json.dumps(dict(json.loads(data), **changes)).encode()
            zout.writestr(item, data)


def test_load_artifact_refuses_another_device_type(pair, tmp_path, monkeypatch):
    """An artifact exported for one device type is never loaded for
    another; a file without the metadata is refused; without CUDA the
    default device (the card) raises."""
    other = str(tmp_path / "cuda.pt2")
    _with_meta(pair["path"], other, device_type="cuda", device="cuda:0")
    with pytest.raises(ValueError, match="exported for cuda"):
        ei.load_artifact(other, "cpu")
    plain = str(tmp_path / "plain.pt2")
    torch.export.save(torch.export.export(torch.nn.Linear(2, 2), (torch.zeros(1, 2),)), plain)
    with pytest.raises(ValueError, match="no uda_poseestimation_meta.json"):
        ei.load_artifact(plain, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ei.load_artifact(pair["path"])


@pytest.mark.parametrize("entry", ["export_model", "export_main", "serve_main"])
def test_entry_points_default_to_the_card(entry, tmp_path, monkeypatch):
    """device=None (no --device) means the card; without one it raises
    before any work, instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {"export_model": lambda: ei.export_model(PoseResNet(ResNet(BasicBlock, (1, 1)), K),
                                                     SIZE),
             "export_main": lambda: ei.main([str(tmp_path / "none.pth"),
                                             str(tmp_path / "out.pt2")]),
             "serve_main": lambda: sb.main(["--arch", "pose_resnet50", "--image-size", "32"])}
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
    assert not (tmp_path / "out.pt2").exists()


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A pose_resnet50 checkpoint written by the JAX package's
    ``save_checkpoint`` (teacher and student), bf16 as its CLI builds it."""
    from uda_poseestimation_tpu.models import pose_resnet50
    from uda_poseestimation_tpu.utils.checkpoint import save_checkpoint

    model = pose_resnet50(num_keypoints=K, dtype=jnp.bfloat16)
    x = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    entry = _scaled(jax.jit(lambda r: model.init(r, x, train=False))(jax.random.PRNGKey(2)), 3)
    path = str(tmp_path_factory.mktemp("ckpt") / "best.pth")
    save_checkpoint(path, {"student": entry, "teacher": entry, "epoch": 0})
    return path


def test_export_cli_from_jax_checkpoint(jax_checkpoint, tmp_path, capsys):
    """The CLI end to end on a JAX-written checkpoint on the CPU: the
    selfcheck passes, and the artifact's heatmaps hold against the JAX CLI's
    artifact of the same file at the bf16 tolerance, preds equal where
    decisive."""
    out = str(tmp_path / "model.pt2")
    result = ei.main([jax_checkpoint, out, "--arch", "pose_resnet50", "--num-keypoints",
                      str(K), "--image-size", str(SIZE), "--device", "cpu", "--selfcheck"])
    stdout = capsys.readouterr().out
    assert "selfcheck ok" in stdout and "convolutions in bfloat16" in stdout, stdout[-2000:]
    assert "exported teacher pose_resnet50 (K=3, 32px, device=cpu, bfloat16)" in stdout
    assert result["meta"]["dtype"] == "bfloat16" and result["bytes"] == os.path.getsize(out)

    jout = str(tmp_path / "model.jaxexp")
    jax_export.main([jax_checkpoint, jout, "--arch", "pose_resnet50", "--num-keypoints",
                     str(K), "--image-size", str(SIZE), "--platforms", "cpu"])
    with open(jout, "rb") as f:
        restored = jax.export.deserialize(bytearray(f.read()))
    x = _images(4, 2)
    want_hm, want_preds, _ = (np.asarray(o) for o in restored.call(x))
    exported, _ = ei.load_artifact(out, "cpu")
    hm, preds, _ = _call(exported.module(), x)
    tol = TOL["bfloat16"]
    np.testing.assert_allclose(hm, want_hm, rtol=tol["rtol"], atol=tol["atol"])
    decisive = _decisive(want_hm, tol["margin"])
    eq = (preds == want_preds).all(axis=-1)
    assert decisive.any() and eq[decisive].all()


def _record(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_serve_benchmark_built(capsys):
    """Without --artifact the harness exports a random pose_resnet50 (bf16),
    loads it back and emits the JSON contract."""
    rec = sb.main(["--device", "cpu", "--arch", "pose_resnet50", "--image-size", "32",
                   "--batch", "2", "--reps", "2"])
    assert _record(capsys) == rec
    assert rec["unit"] == "images/sec/chip" and rec["batch"] == 2
    assert rec["value"] > 0 and rec["ms_per_batch"] > 0 and rec["latency_ms_median"] > 0
    assert rec["latency_ms_p90"] is None  # fewer than 10 reps
    assert "pose_resnet50" in rec["metric"] and "bfloat16" in rec["metric"]
    assert rec["dtype"] == "bfloat16" and rec["device"] == "cpu"


def test_serve_benchmark_prebuilt_artifact(pair, capsys):
    """--artifact times a saved artifact as it is; the dtype label is the
    artifact's recorded dtype."""
    rec = sb.main(["--device", "cpu", "--artifact", pair["path"], "--image-size", str(SIZE),
                   "--batch", "2", "--reps", "10"])
    assert _record(capsys) == rec
    assert rec["value"] > 0 and rec["batch"] == 2
    assert os.path.basename(pair["path"]) in rec["metric"]
    assert rec["dtype"] == pair["name"] and f" {pair['name']}," in rec["metric"]
    assert rec["latency_ms_p90"] >= rec["latency_ms_median"] > 0
    assert rec["artifact_bytes"] == os.path.getsize(pair["path"])
