"""Driver of the adaptation epoch: ``engine.run_adapt_epoch`` over the
benchmark's seeded pool, unbundled or through an ``AdaptStepBundler``.

Set-up builds one training state from the seed's weights and drives it
through the window's own call and feed: an epoch of one iteration, then one
of two (the start check: the reference follows these steps from the seed;
each epoch's first call of a gate case runs eagerly), then each style case
of the step twice more, so that every shape and gate case the window meets
has run and, bundled, has been captured. Then the replay check: from a copy
of the state, calls of the window's own size run through the same step or
bundler, which replays its captured graphs, with gates drawn from the seed
by the engine's rule; the reference follows them from the copy. The window
then starts at an epoch's start, as an epoch of ``iters_per_epoch`` users'
iterations does, with its graph captures, and the feed ends it after
``--seconds``.

``run_adapt_epoch`` returns only the state: the step it is handed is the
benchmark's ``Recorder``, which forwards to the program's step or bundler
and keeps what each call returns, the gates and the occlusion seed it was
given.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from benchmark import compare, flops, inputs
from benchmark.loop import Clock, Feed, leaf_norms, memory_peak, release, sync
from benchmark.reference.precision import computing_in, set_fp8
from benchmark.reference.steps import AdaptReference, occlusion_draws
from benchmark.trace import SubWindow

LOSSES = ("loss_all", "loss_s", "loss_c")


class Recorder:
    """The step or bundler ``run_adapt_epoch`` calls, forwarding to the
    program's; keeps the losses, gates and occlusion seed of each call while
    ``keep`` is set, counts steps, and serves the trace's sub-window."""

    def __init__(self, inner, bundled: bool, on_call=None):
        self.inner = inner
        self.bundled = bundled
        self.on_call = on_call
        self.keep = False
        self.kept = []
        self.steps = 0

    def __call__(self, state, batches, lr, do_s2t, alpha_s2t, do_t2s, alpha_t2s,
                 generator=None):
        with torch.profiler.record_function("bench.bundle" if self.bundled else "bench.step"):
            state, metrics, y_s = self.inner(state, batches, lr, do_s2t, alpha_s2t, do_t2s,
                                             alpha_t2s, generator=generator)
        gates = (list(zip(do_s2t, alpha_s2t, do_t2s, alpha_t2s)) if self.bundled
                 else [(do_s2t, alpha_s2t, do_t2s, alpha_t2s)])
        self.steps += len(gates)
        if self.keep:
            self.kept.append((gates, generator.initial_seed(),
                              {k: metrics[k].detach().reshape(-1).clone() for k in LOSSES},
                              y_s.detach().clone()))
        if self.on_call is not None:
            self.on_call(gates)
        return state, metrics, y_s


def _engine_args(cfg, traffic, iters):
    """The trainer flags ``run_adapt_epoch`` reads."""
    return argparse.Namespace(
        iters_per_epoch=iters, print_freq=traffic["print_freq"],
        steps_per_dispatch=traffic["steps_per_dispatch"], s2t_freq=cfg["s2t_freq"],
        s2t_alpha=tuple(cfg["s2t_alpha"]), t2s_freq=cfg["t2s_freq"],
        t2s_alpha=tuple(cfg["t2s_alpha"]))


def host_pool(cfg, traffic, seed, device):
    """The pool of (source, target) tuples in the loaders' format."""
    pin = device.type == "cuda"
    pool = []
    for b in inputs.adapt_batches(cfg, traffic, seed, device, traffic["pool"]):
        h = inputs.to_host(b, pin)
        src = (h["image_s"], h["target_s"], h["weight_s"], {})
        tgt = (h["image_t_stu"], None, None, {"aug_param_stu": h["aug_param_stu"]},
               [h["images_t_tea"][0]], None, None, [{"aug_param_tea": h["aug_params_tea"][0]}])
        pool.append((src, tgt))
    return pool


def build_program(cfg, seed, device):
    """The program's state and style net, loaded with the seed's weights."""
    from uda_poseestimation_torch.models import StyleNet
    from uda_poseestimation_torch.models.pose_resnet import PoseResNet
    from uda_poseestimation_torch.models.resnet import Bottleneck, ResNet
    from uda_poseestimation_torch.parallel import StepConfig, create_state

    step_cfg = StepConfig(
        image_size=cfg["image_size"], heatmap_size=cfg["heatmap_size"], sigma=cfg["sigma"],
        k=cfg["k"], lambda_c=cfg["lambda_c"], teacher_alpha=cfg["teacher_alpha"],
        mask_ratio=cfg["mask_ratio"], occlude_rate=cfg["occlude_rate"],
        occlude_thresh=cfg["occlude_thresh"], occlude_size=cfg["occlude_size"],
        gather_exact=cfg["gather_exact"], style_io_dtype=cfg["style_io_dtype"])
    dtype = getattr(torch, cfg["precision"])
    model = PoseResNet(ResNet(Bottleneck, cfg["stage_sizes"], fuse_bn=False),
                       cfg["num_keypoints"], dtype=dtype).to(device)
    model.load_state_dict(inputs.pose_weights(cfg, seed, device))
    state = create_state(model, step_cfg, seed=None, device=device)
    style = StyleNet().to(device=device, dtype=getattr(torch, cfg["style_dtype"]))
    style.load_state_dict(inputs.style_weights(seed, device, getattr(torch, cfg["style_dtype"])))
    return state, style, step_cfg


def _draw_gates(rs, n, cfg):
    """``n`` iterations' (do_s2t, alpha_s2t, do_t2s, alpha_t2s) by the
    engine's rule (train_human.py's order)."""
    gates = []
    for _ in range(n):
        g = []
        for freq, (lo, hi) in ((cfg["s2t_freq"], cfg["s2t_alpha"]),
                               (cfg["t2s_freq"], cfg["t2s_alpha"])):
            if freq > rs.rand():
                g += [True, float(rs.uniform(lo, hi))]
            else:
                g += [False, 0.0]
        gates.append(tuple(g))
    return gates


def replay_draws(seed: int, epochs, cfg):
    """The engine's control draws, worked out again from the seed: per epoch
    the occlusion generator's seed, then per iteration the s2t and t2s
    gates."""
    rs = np.random.RandomState(seed % 2 ** 32)
    out = []
    for n in epochs:
        occ = int(rs.randint(0, 2 ** 31 - 1))
        out.append((occ, _draw_gates(rs, n, cfg)))
    return out


def replay_gates(seed: int, calls, cfg):
    """The replay check's gates, per call, from a stream of the seed's own."""
    rs = np.random.RandomState((seed + 1) % 2 ** 32)
    return [_draw_gates(rs, n, cfg) for n in calls]


def snapshot(state, generator) -> dict:
    """The program's state as the replay check starts from it, copied to
    the host: both models' weights, Adam's state by parameter name and the
    occlusion generator's."""
    def host(t):
        return t.detach().to("cpu", copy=True)

    names = {p: n for n, p in state.student.named_parameters()}
    return {"student": {k: host(v) for k, v in state.student.state_dict().items()},
            "teacher": {k: host(v) for k, v in state.teacher.state_dict().items()},
            "adam": {names[p]: {k: host(v) if torch.is_tensor(v) else v for k, v in st.items()}
                     for p, st in state.optimizer.state.items()},
            "rng": generator.get_state()}


def replay_stage(cfg, tr, seed, state, inner, bundled, pool, lr, generator, device):
    """The replay check's program side: from a snapshot of ``state``, the
    calls of ``tr["replay_calls"]`` steps through ``inner`` (the window's
    step or bundler) with ``generator`` (whose graphs are captured). Returns
    the snapshot and what the comparison reads: each step's losses, the
    first step's heatmaps, the first gradient (from Adam's moment before and
    after the first step), the change of both models, and how many steps
    did not replay a graph (bundled on the card; else None)."""
    from uda_poseestimation_torch import engine

    snap = snapshot(state, generator)
    beta1 = state.optimizer.param_groups[0]["betas"][0]
    counted = bundled and device.type == "cuda"
    replays0 = inner.replays if counted else 0
    calls = replay_gates(seed, tr["replay_calls"], cfg)
    prog = {"losses": [], "draws": [], "heatmaps_s": {}}
    k = 0
    for j, gates in enumerate(calls):
        batches = [engine.make_adapt_batch(*pool[(k + i) % len(pool)]) for i in range(len(gates))]
        runs = [(batches, gates)] if bundled else [([b], [g]) for b, g in zip(batches, gates)]
        for bs, gs in runs:
            if bundled:
                state, metrics, y_s = inner(state, bs, lr, *zip(*gs), generator=generator)
            else:
                state, metrics, y_s = inner(state, bs[0], lr, *gs[0], generator=generator)
            values = {n: metrics[n].detach().reshape(-1).tolist() for n in LOSSES}
            prog["losses"] += [{n: values[n][i] for n in LOSSES} for i in range(len(gs))]
        prog["draws"] += [(None, g) for g in gates]
        k += len(gates)
        prog["heatmaps_s"][k - 1] = y_s.detach().float().cpu()  # the call's last step's
        if j == 0:
            adam = state.optimizer.state
            prog["grad_first"] = leaf_norms(
                (n, (adam[p]["exp_avg"] - beta1 * snap["adam"][n]["exp_avg"].to(device))
                 / (1.0 - beta1))
                for n, p in state.student.named_parameters()
                if "exp_avg" in adam.get(p, {}) and n in snap["adam"])
    sync(device)
    for model in ("student", "teacher"):
        prog[f"change_{model}"] = leaf_norms(
            (n, p - snap[model][n].to(device))
            for n, p in getattr(state, model).named_parameters())
    prog["missed"] = k - (inner.replays - replays0) if counted else None
    return snap, prog


def _follow(ref, cfg, batches, steps, device, precision, half_batch):
    """The reference's steps ``steps``: [(generator, gates)], in order, on
    ``batches`` (cycled); its losses, first gradient and source heatmaps."""
    if precision == "fp8":
        for m in ref.modules():
            set_fp8(m)
    out = {"losses": [], "grad_first": None, "occluded": [], "heatmaps_s": {}}
    with computing_in(precision, device):
        for i, (gen, g) in enumerate(steps):
            d = occlusion_draws(cfg["batch"], cfg["num_keypoints"], gen, device)
            out["losses"].append(ref.step(batches[i % len(batches)], g, d,
                                          half_batch=half_batch))
            out["occluded"].append(ref.occluded)
            out["heatmaps_s"][i] = ref.y_s
            if i == 0:
                out["occlusion_first"] = ref.occlusion_call
                out["grad_first"] = leaf_norms(
                    (n, p.grad) for n, p in ref.student.named_parameters())
    return out


def _changes(ref, student0, teacher0, device):
    return {"change_student": leaf_norms((n, p - student0[n].to(device))
                                         for n, p in ref.student.named_parameters()),
            "change_teacher": leaf_norms((n, p - teacher0[n].to(device))
                                         for n, p in ref.teacher.named_parameters())}


def reference_run(cfg, traffic, seed, device, epochs, precision="f32", half_batch=False):
    """The reference's start check: the checked epochs' steps from the
    seed's weights; losses, first gradients and changes, and the draws as
    (occlusion seed, gates) per step."""
    draws = replay_draws(seed, epochs, cfg)
    batches = inputs.adapt_batches(cfg, traffic, seed, device, sum(epochs))
    w0 = inputs.pose_weights(cfg, seed, device)
    ref = AdaptReference(w0, inputs.style_weights(seed, device, getattr(torch, cfg["style_dtype"])),
                         cfg["num_keypoints"], cfg, device, tuple(cfg["stage_sizes"]))
    steps = []
    for occ, gates in draws:
        gen = torch.Generator(device=device)
        gen.manual_seed(occ)
        steps += [(gen, g) for g in gates]
    out = _follow(ref, cfg, batches, steps, device, precision, half_batch)
    out.update(_changes(ref, w0, w0, device),
               draws=[(occ, g) for occ, gates in draws for g in gates])
    return out


def reference_replay(cfg, traffic, seed, device, snap, precision="f32", half_batch=False):
    """The reference's replay check: the replay calls' steps from the
    program's snapshot (both models, Adam's state, the generator's)."""
    batches = inputs.adapt_batches(cfg, traffic, seed, device, traffic["pool"])
    ref = AdaptReference(snap["student"],
                         inputs.style_weights(seed, device, getattr(torch, cfg["style_dtype"])),
                         cfg["num_keypoints"], cfg, device, tuple(cfg["stage_sizes"]),
                         teacher_weights=snap["teacher"], adam_state=snap["adam"])
    gen = torch.Generator(device=device)
    gen.set_state(snap["rng"])
    gates = [g for call in replay_gates(seed, traffic["replay_calls"], cfg) for g in call]
    out = _follow(ref, cfg, batches, [(gen, g) for g in gates], device, precision, half_batch)
    out.update(_changes(ref, snap["student"], snap["teacher"], device),
               draws=[(None, g) for g in gates])
    return out


def adapt_numbers(prog, ref) -> dict:
    """The training numbers, and ``loss_source``: the largest gap of the
    source's supervised loss over the steps, |program - reference| /
    |reference|, which no decision of the teacher moves."""
    gaps = [abs(p.get("loss_s", math.nan) - r["loss_s"]) / max(abs(r["loss_s"]), 1e-30)
            for p, r in zip(prog["losses"], ref["losses"])]
    gap = max(gaps) if gaps else math.inf
    return dict(compare.training_numbers(prog, ref),
                loss_source=gap if math.isfinite(gap) else math.inf)


def replay_numbers(prog, ref) -> dict:
    """The replay check's numbers, named ``replay_<number>``."""
    return {f"replay_{k}": v for k, v in adapt_numbers(prog, ref).items()}


def occlusion_stage(cfg, imgs, coeffs, rect, want) -> int:
    """Kernel B1 by itself on the first step's operands as the reference
    worked them out (its teacher's decisions): the elements where the
    program's ``occlusion_warp`` differs from the reference's warp, rounded
    to bfloat16 where the configuration has the kernel round."""
    from uda_poseestimation_torch.ops.occlusion_warp import occlusion_warp

    got = occlusion_warp(imgs, coeffs, rect, exact=cfg["gather_exact"])
    if not cfg["gather_exact"]:
        want = want.to(torch.bfloat16).float()
    return int((got != want).sum())


def run(cell, device, control_kinds=()) -> dict:
    from uda_poseestimation_torch import engine
    from uda_poseestimation_torch.parallel import AdaptStepBundler, make_adapt_step

    cfg, tr = cell.config, dict(cell.traffic, image_size=cell.config["image_size"])
    t_start = time.perf_counter()
    setup_parts = {}
    if device.type == "cuda":  # kernel B1's library: nvcc builds it in a checkout's first run
        from uda_poseestimation_torch._build import load

        load("occlusion_warp")
        setup_parts["kernel_build_s"] = time.perf_counter() - t_start
    np.random.seed(cell.seed % 2 ** 32)  # the engine's control stream
    state, style, step_cfg = build_program(cfg, cell.seed, device)
    bundled = tr["steps_per_dispatch"] > 1
    inner = (AdaptStepBundler(step_cfg, style_model=style, device=device) if bundled
             else make_adapt_step(step_cfg, style_model=style, device=device))
    pool = host_pool(cfg, tr, cell.seed, device)
    clock = Clock()
    src_feed = Feed(pool, clock, pick=lambda item: item[0])
    tgt_feed = Feed(pool, pick=lambda item: item[1])
    rec = Recorder(inner, bundled)
    lr = cfg["lr"]

    def epoch(n, index):
        args = _engine_args(cfg, tr, n)
        return engine.run_adapt_epoch(
            state, rec if not bundled else None, src_feed, tgt_feed, index, lr, args,
            style_enabled=True, bundler=rec if bundled else None)

    # the checked steps: an epoch of one step, then one of two
    checked = tuple(tr["checked_epochs"])
    rec.keep = True
    w0 = {n: p.detach().clone() for n, p in state.student.named_parameters()}
    epoch(checked[0], 0)
    sync(device)
    beta1 = state.optimizer.param_groups[0]["betas"][0]
    grad_first = leaf_norms(
        (n, state.optimizer.state[p]["exp_avg"] / (1.0 - beta1))
        for n, p in state.student.named_parameters() if "exp_avg" in state.optimizer.state[p])
    for i, n in enumerate(checked[1:]):
        epoch(n, 1 + i)
    sync(device)
    prog = {
        "grad_first": grad_first,
        "change_student": leaf_norms((n, p - w0[n]) for n, p in state.student.named_parameters()),
        "change_teacher": leaf_norms((n, p - w0[n]) for n, p in state.teacher.named_parameters()),
        "losses": [], "draws": []}
    prog["heatmaps_s"] = {}
    for gates, occ, losses, y_s in rec.kept:
        prog["draws"] += [(occ, tuple(bool(v) if j % 2 == 0 else float(v)
                                      for j, v in enumerate(g))) for g in gates]
        values = {k: v.tolist() for k, v in losses.items()}
        prog["losses"] += [{k: values[k][j] for k in LOSSES} for j in range(len(gates))]
        prog["heatmaps_s"][len(prog["losses"]) - 1] = y_s  # the call's last step's
    rec.keep, rec.kept = False, []
    del w0
    # each gate case twice more, through the same call: every shape warm,
    # and bundled every case's graph captured (a bundle of two: eager, then
    # captured and replayed)
    warm_gen = torch.Generator(device=device)
    warm_gen.manual_seed(0)
    batch0 = engine.make_adapt_batch(*pool[0])
    for s2t in (False, True):
        for t2s in (False, True):
            if bundled:
                inner(state, [batch0] * 2, lr, [s2t] * 2, [0.5] * 2, [t2s] * 2, [0.5] * 2,
                      generator=warm_gen)
            else:
                for _ in range(2):
                    inner(state, batch0, lr, s2t, 0.5, t2s, 0.5, generator=warm_gen)
    snap, replay = replay_stage(cfg, tr, cell.seed, state, inner, bundled, pool, lr,
                                warm_gen, device)
    setup_parts["driver_s"] = time.perf_counter() - t_start

    # the window: epochs from their start until the feed ends it
    sub = SubWindow(device, tr["trace_after_s"], tr["trace_s"]) if cell.trace else None
    counters = {}
    epoch_t0 = [None]

    def on_call(gates):
        if sub is not None:
            if sub.active:
                sub.count_step(len(gates), flops=sum(
                    flops.adapt_step_flops(cfg, cfg["batch"], int(g[0]) + int(g[2]))
                    for g in gates))
            sub.due(clock.elapsed())
        if bundled and "epoch_start_s" not in counters and inner.replays > counters["replays0"]:
            counters["epoch_start_s"] = time.perf_counter() - epoch_t0[0]

    rec.on_call = on_call
    steps0 = rec.steps
    counters["replays0"] = getattr(inner, "replays", 0)
    counters["captures0"] = getattr(inner, "captures", 0)
    clock.start(cell.seconds)
    index = len(checked)
    while not clock.expired:
        epoch_t0[0] = time.perf_counter()
        try:
            epoch(tr["iters_per_epoch"], index)
        except StopIteration:
            break
        index += 1
    sync(device)
    window_s = time.perf_counter() - clock.t0
    if sub is not None:
        sub.end()
    steps = rec.steps - steps0
    counters.update(captures=getattr(inner, "captures", 0) - counters["captures0"],
                    replays=getattr(inner, "replays", 0) - counters["replays0"],
                    window_steps=steps, epochs=index - len(checked) + 1)
    peak = memory_peak(device)
    trace = sub.summary() if sub is not None else {}
    del state, style, inner, rec, pool, src_feed, tgt_feed
    release(device)

    ref = reference_run(cfg, tr, cell.seed, device, checked)
    numbers = adapt_numbers(prog, ref)
    detail = compare.training_detail(prog, ref)
    exact = {"draws_differ": (int(prog["draws"] != ref["draws"]), 0),
             "occlusion_warp_mismatch": (occlusion_stage(cfg, *ref.pop("occlusion_first")), 0)}
    ref_replay = reference_replay(cfg, tr, cell.seed, device, snap)
    numbers.update(replay_numbers(replay, ref_replay))
    detail["replay"] = compare.training_detail(replay, ref_replay)
    if replay["missed"] is not None:
        exact["replay_missed"] = (replay["missed"], 0)
    controls = {}
    for kind in control_kinds:
        kw = {"control": dict(precision="fp8"), "half_batch": dict(half_batch=True)}[kind]
        other = reference_run(cfg, tr, cell.seed, device, checked, **kw)
        other_replay = reference_replay(cfg, tr, cell.seed, device, snap, **kw)
        controls[kind] = dict(adapt_numbers(other, ref),
                              **replay_numbers(other_replay, ref_replay),
                              detail=dict(compare.training_detail(other, ref), replay=
                                          compare.training_detail(other_replay, ref_replay)))
    checks = compare.judge(numbers, cell.limits["numbers"], exact=exact)
    return {
        "window_t0": clock.t0, "setup_parts": setup_parts, "window_s": window_s,
        "e2e": {tr["metrics"]["rate"]: steps * cfg["batch"] / window_s},
        "attempted": steps, "failed": 0,
        "checks": checks, "correct": all(c["ok"] for c in checks),
        "memory_peak_bytes": peak, "trace": trace, "counters": counters,
        "b1_bytes": flops.occlusion_warp_bytes(cfg["batch"], 3, cfg["image_size"]),
        "info": {"checked_losses": prog["losses"], "replay_losses": replay["losses"],
                 "replay_reference_losses": ref_replay["losses"], "draws": prog["draws"],
                 "occluded": ref["occluded"],
                 "replay_draws": replay["draws"], "replay_missed": replay["missed"],
                 "numbers": numbers, "detail": detail},
        "controls": controls,
    }


def control_numbers(cell, seed: int, device, kind: str) -> dict:
    """The numbers the reference gives in the program's place: as the
    control (one precision below the configuration's, ``fp8``) or with a
    planted fault (``half_batch``), against the float32 reference; the
    replay check's from the snapshot of a run of the program from ``seed``
    (set-up only: no window)."""
    cell.seed, cell.seconds, cell.trace = seed, 0.0, False
    return run(cell, device, control_kinds=(kind,))["controls"][kind]
