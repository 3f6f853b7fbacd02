"""The rank processes of tests/test_torch_distributed.py and
tests/test_torch_adain_distributed.py.

Each rank joins a gloo group through a rendezvous file, runs the jobs of
``job.pt`` in order on its rows of the global batch, and saves what they
return to ``rank<r>.pt``. Imports torch and the port only (the ranks are
spawned: no JAX to start, no state inherited from the test process).
"""

import hashlib
import os
import sys

import numpy as np
import torch

B_AXIS1 = ("images_t_tea", "aug_params_tea")  # (k, B, ...) leaves


def rows_of(batch, rows):
    return {k: (v[:, rows] if k in B_AXIS1 else v[rows]) for k, v in batch.items()}


def _np(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree


def _sd(module):
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def _digests(module):
    """Each state tensor's bytes as a digest: the ranks' states are held
    bit-equal without shipping every rank's copy (the models are ~60 MB)."""
    return {k: hashlib.sha256(v.detach().numpy().tobytes()).hexdigest()
            for k, v in module.state_dict().items()}


def _stats(module):
    return {k: v for k, v in _sd(module).items() if "running_" in k}


def _primary_only(value):
    """``value`` on rank 0, None elsewhere (what only the JAX comparison
    reads)."""
    from uda_poseestimation_torch.parallel import distributed as dist

    return value if dist.is_primary() else None


def _deltas(before, module):
    return {k: v - before[k] for k, v in _sd(module).items()
            if not k.endswith("num_batches_tracked")}


def _models(job):
    from uda_poseestimation_torch.models import Bottleneck, PoseResNet, ResNet, StyleNet

    model = PoseResNet(ResNet(Bottleneck, (1, 1, 1, 1)), job["num_keypoints"])
    model.load_state_dict(job["pose"])
    style = StyleNet()
    style.load_state_dict(job["style"])
    return model, style


def bn(job):
    """A float64 ``BatchNorm2d`` in train mode on the rank's rows of ``x``,
    backward from sum(y * dy)."""
    from uda_poseestimation_torch.models.resnet import BatchNorm2d
    from uda_poseestimation_torch.parallel import distributed as dist

    rows = dist.local_rows(len(job["x"]))
    layer = BatchNorm2d(job["x"].shape[1]).double().train()
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(job["weight"]))
        layer.bias.copy_(torch.from_numpy(job["bias"]))
    x = torch.from_numpy(job["x"][rows]).requires_grad_(True)
    y = layer(x)
    (y * torch.from_numpy(job["dy"][rows])).sum().backward()
    return {"y": _np(y), "x_grad": _np(x.grad), "weight_grad": _np(layer.weight.grad),
            "bias_grad": _np(layer.bias.grad), "running_mean": _np(layer.running_mean),
            "running_var": _np(layer.running_var)}


def adapt(job):
    """One adapt step on the rank's rows with its rows of the injected
    global draws."""
    from uda_poseestimation_torch.parallel import distributed as dist
    from uda_poseestimation_torch.parallel import train_step as tts

    cfg = tts.StepConfig(**job["cfg"])
    model, style = _models(job)
    state = tts.create_state(model, cfg, seed=None, device="cpu")
    before = _sd(state.student)
    rows = dist.local_rows(len(job["batch"]["image_s"]))
    step = tts.make_adapt_step(cfg, style_model=style, device="cpu")
    draws = {k: v[rows] for k, v in job["draws"].items()}
    state, metrics, y = step(state, rows_of(job["batch"], rows), job["lr"], **job["gates"],
                             occlusion_draws=draws)
    metrics = _np(metrics)
    metrics["aux"]["grads"] = _primary_only(metrics["aux"]["grads"])
    return {"metrics": metrics, "y": _np(y),
            "deltas": _primary_only(_deltas(before, state.student)),
            "student_stats": _stats(state.student), "teacher_stats": _stats(state.teacher),
            "student": _digests(state.student), "teacher": _digests(state.teacher)}


def pretrain(job):
    from uda_poseestimation_torch.parallel import distributed as dist
    from uda_poseestimation_torch.parallel import train_step as tts

    cfg = tts.StepConfig(**job["cfg"])
    out = {}
    for do_s2t in (False, True):
        model, style = _models(job)
        state = tts.create_state(model, cfg, seed=None, device="cpu")
        before = _sd(state.student)
        rows = dist.local_rows(len(job["pretrain_batch"]["image_s"]))
        step = tts.make_pretrain_step(cfg, style_model=style, device="cpu")
        state, metrics, y = step(state, rows_of(job["pretrain_batch"], rows), job["lr"],
                                 do_s2t=do_s2t, alpha=0.6)
        out[do_s2t] = {"metrics": _np(metrics), "y": _np(y),
                       "deltas": _primary_only(_deltas(before, state.student)),
                       "student_stats": _stats(state.student),
                       "student": _digests(state.student)}
    return out


def evaluate(job):
    """The eval step on the rank's rows, and ``run_validate`` over a loader
    whose last batch is partial."""
    from uda_poseestimation_torch.engine import run_validate
    from uda_poseestimation_torch.parallel import distributed as dist
    from uda_poseestimation_torch.parallel import train_step as tts

    model, _ = _models(job)
    batch = job["eval_batch"]
    rows = dist.local_rows(len(batch["image_s"]))
    y, loss, acc = tts.make_eval_step(device="cpu")(
        model, *(batch[k][rows] for k in ("image_s", "target_s", "weight_s")))
    return {"y": _np(y), "loss": _np(loss), "acc": _np(acc),
            "validate": run_validate(tts.make_eval_step(device="cpu"), model,
                                     val_loader(batch), job["val_args"])}


class _Items(torch.utils.data.Dataset):
    """The eval batch's rows as loader items, with the group accuracy of
    the RHD sets (the mean over the keypoints)."""

    def __init__(self, batch):
        self.batch = batch
        self.num_keypoints = batch["target_s"].shape[1]

    def __len__(self):
        return len(self.batch["image_s"])

    def __getitem__(self, i):
        b = self.batch
        return (b["image_s"][i], b["target_s"][i], b["weight_s"][i],
                {"keypoint2d": np.zeros((self.num_keypoints, 2), np.float32)})

    @staticmethod
    def group_accuracy(accuracies):
        return {"all": float(np.mean(accuracies)), "per_kpt": list(accuracies)}


def val_loader(batch):
    """Batches of 3 over the eval batch's rows: the last one partial."""
    from uda_poseestimation_torch.data import make_loader

    return make_loader(_Items(batch), 3)


def bundle(job):
    """Two adapt steps through an ``AdaptStepBundler`` and two unbundled
    steps, from equal states and generators (the draws made for the global
    batch)."""
    from uda_poseestimation_torch.parallel import distributed as dist
    from uda_poseestimation_torch.parallel import train_step as tts

    cfg = tts.StepConfig(**dict(job["cfg"], aux_outputs=False))
    batches = job["bundle_batches"]
    rows = dist.local_rows(len(batches[0]["image_s"]))
    local = [rows_of(b, rows) for b in batches]
    gates = job["bundle_gates"]
    out = {}
    for bundled in (False, True):
        model, style = _models(job)
        state = tts.create_state(model, cfg, seed=None, device="cpu")
        gen = torch.Generator().manual_seed(17)
        if bundled:
            bundler = tts.AdaptStepBundler(cfg, style_model=style, device="cpu")
            state, metrics, _ = bundler(state, local, job["lr"], *zip(*gates), generator=gen)
        else:
            step = tts.make_adapt_step(cfg, style_model=style, device="cpu")
            ms = []
            for b, g in zip(local, gates):
                state, m, _ = step(state, b, job["lr"], *g, generator=gen)
                ms.append(m)
            metrics = {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
        out[bundled] = {"metrics": _np(metrics), "student": _digests(state.student),
                        "teacher": _digests(state.teacher)}
    return out


def views(job):
    """The ``--device-aug`` pipelines' draws for the rank's rows."""
    from uda_poseestimation_torch.engine import AnimalDeviceAugPipeline, DeviceAugPipeline
    from uda_poseestimation_torch.ops.device_aug import AnimalSourceAugConfig, DeviceAugConfig

    b = job["views_b"]
    cfg = DeviceAugConfig(image_size=32, heatmap_size=8, color=0.25, blur=1.0)
    human = DeviceAugPipeline(cfg, cfg, cfg, k=2, mean=(0.5,) * 3, std=(0.25,) * 3, seed=3,
                              device="cpu")
    animal = AnimalDeviceAugPipeline(cfg, cfg, k=2, mean=(0.5,) * 3, seed=3, device="cpu",
                                     src_cfg=AnimalSourceAugConfig(inp_res=32, out_res=8))
    return {"human": _np({"source": human.draw_source(b, 40),
                          "target": human.draw_target(b, 40)}),
            "animal": _np({"target": animal.draw_target(b), "source": animal.draw_source(b)})}


def decoder(job):
    """One AdaIN decoder step (``adain_engine.make_decoder_step``, SGD) on the
    rank's rows of the content and style batches."""
    from uda_poseestimation_torch import adain_engine
    from uda_poseestimation_torch.models import StyleNet
    from uda_poseestimation_torch.parallel import distributed as dist

    net = StyleNet("meanstd")
    net.load_state_dict(job["style_net"])
    lr = job["decoder_lr"]
    step, _ = adain_engine.make_decoder_step(
        net, 1.0, 2.0, lr, optimizer=torch.optim.SGD(net.decoder.parameters(), lr=lr))
    rows = dist.local_rows(len(job["content"]))
    nchw = lambda a: torch.from_numpy(a[rows]).permute(0, 3, 1, 2).contiguous()  # noqa: E731
    *losses, g_t = step(nchw(job["content"]), nchw(job["style_imgs"]))
    return {"losses": [float(x) for x in losses], "g_t": _np(g_t),
            "decoder": _primary_only(_sd(net.decoder)), "digests": _digests(net.decoder)}


JOBS = {"bn": bn, "adapt": adapt, "pretrain": pretrain, "evaluate": evaluate,
        "bundle": bundle, "views": views, "decoder": decoder}


def run(rank: int, world: int, work_dir: str):
    """One rank: join, run ``job.pt``'s jobs, save ``rank<r>.pt``."""
    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from uda_poseestimation_torch.parallel import distributed as dist

    job = torch.load(os.path.join(work_dir, "job.pt"), weights_only=False)
    dist.initialize("file://" + os.path.join(work_dir, "rendezvous"), world, rank,
                    device="cpu", timeout_s=60)
    try:
        out = {name: JOBS[name](job) for name in job["jobs"]}
        torch.save(out, os.path.join(work_dir, f"rank{rank}.pt"))
    finally:
        dist.shutdown()
