"""Driver of AdaIN decoder pretraining: ``adain_engine.run_decoder_training``
over the benchmark's in-memory feeds of NHWC float32 batches.

One call of the program's loop serves set-up and window alike: its first
``warm_iters`` iterations are set-up (the checked steps, iteration 0's
image dump, every shape warm), then the feed synchronizes the device and
opens the window, and ends the loop ``--seconds`` later.

The loop keeps its step and optimizer to itself; the benchmark reads the
first gradient and the parameters' change with an optimizer post-step hook
(``torch.optim``'s global hook, removed after the checked steps) and each
step's losses from the loop's log file.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import tempfile
import time

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from benchmark import compare, flops, inputs
from benchmark.loop import Clock, Feed, leaf_norms, memory_peak, release, sync
from benchmark.reference.precision import computing_in
from benchmark.reference.steps import DecoderReference
from benchmark.trace import SubWindow

EXP = "bench_decoder"
LINE = re.compile(r"iter: (\d+), decoder_loss: (\S+), content loss: (\S+), style loss: (\S+)")


def weights(seed, device):
    w = inputs.style_weights(seed, device)
    enc = {k[len("encoder."):]: v for k, v in w.items() if k.startswith("encoder.")}
    dec = {k[len("decoder."):]: v for k, v in w.items() if k.startswith("decoder.")}
    return enc, dec


def pools(cfg, traffic, seed, device):
    tr = dict(traffic, batch=cfg["batch"])
    src = inputs.image_batches(tr, cfg["image_size"], seed, device, traffic["pool"], stream=5)
    tgt = inputs.image_batches(tr, cfg["image_size"], seed, device, traffic["pool"], stream=6)
    return src, tgt


def swaps(seed: int, n: int) -> list:
    """The loop's content/style swaps, worked out again: one ``rand() > 0.5``
    an iteration from the numpy stream the benchmark seeds."""
    rs = np.random.RandomState(seed % 2 ** 32)
    return [bool(rs.rand() > 0.5) for _ in range(n)]


def reference_run(cfg, traffic, seed, device, n, precision="f32", half_batch=False):
    enc, dec = weights(seed, device)
    src, tgt = pools(cfg, traffic, seed, device)
    ref = DecoderReference(enc, dec, cfg, device)
    losses, grad_first = [], None
    with computing_in(precision, device):
        for i, swap in enumerate(swaps(seed, n)):
            s, t = src[i % len(src)], tgt[i % len(tgt)]
            content, style = (s, t) if swap else (t, s)
            losses.append(ref.step(content.permute(0, 3, 1, 2), style.permute(0, 3, 1, 2),
                                   half_batch=half_batch))
            if grad_first is None:
                grad_first = leaf_norms((n_, p.grad) for n_, p in
                                        ref.net.decoder.named_parameters())
    return {"losses": losses, "grad_first": grad_first,
            "change_student": leaf_norms((k, p - dec[k]) for k, p in
                                         ref.net.decoder.named_parameters())}


class _Snapshots:
    """An optimizer post-step hook: the first gradient (Adam's first moment
    after one step over 1 - beta1) and the parameters after ``n`` steps."""

    def __init__(self, n: int):
        self.n, self.steps = n, 0
        self.grad_first = self.params = None
        self.handle = register_optimizer_step_post_hook(self)

    def __call__(self, optimizer, args, kwargs):
        self.steps += 1
        named = [(str(i), p) for i, p in enumerate(optimizer.param_groups[0]["params"])]
        if self.steps == 1:
            beta1 = optimizer.param_groups[0]["betas"][0]
            self.grad_first = leaf_norms((n, optimizer.state[p]["exp_avg"] / (1.0 - beta1))
                                         for n, p in named if "exp_avg" in optimizer.state[p])
        if self.steps == self.n:
            self.params = [p.detach().clone() for _, p in named]
            self.handle.remove()


def run(cell, device) -> dict:
    from uda_poseestimation_torch import adain_engine

    cfg, tr = cell.config, cell.traffic
    t_start = time.perf_counter()
    np.random.seed(cell.seed % 2 ** 32)  # the loop's swap draws
    enc, dec = weights(cell.seed, device)
    tmp = tempfile.mkdtemp(prefix="bench_vgg_")
    vgg = os.path.join(tmp, "vgg_encoder.pth")
    torch.save({k: v.cpu() for k, v in enc.items()}, vgg)
    src_dev, tgt_dev = pools(cfg, tr, cell.seed, device)
    pin = device.type == "cuda"
    src_pool = [inputs.to_host(x, pin) for x in src_dev]
    tgt_pool = [inputs.to_host(x, pin) for x in tgt_dev]
    del src_dev, tgt_dev
    names = [k for k in dec if k.endswith("weight") or k.endswith("bias")]

    clock = Clock()
    sub = SubWindow(device, tr["trace_after_s"], tr["trace_s"]) if cell.trace else None
    step_flops = flops.decoder_step_flops(cfg)
    marks = {}

    class WindowFeed(Feed):
        def __next__(self):
            if self.served == tr["warm_iters"] and clock.t0 is None:
                sync(device)
                marks["setup_s"] = time.perf_counter() - t_start
                clock.start(cell.seconds)
            if sub is not None and clock.t0 is not None:
                if sub.active:
                    sub.count_step(1, flops=step_flops)
                sub.due(clock.elapsed())
            return super().__next__()

    src_feed = WindowFeed(src_pool, clock)
    tgt_feed = Feed(tgt_pool)
    args = argparse.Namespace(
        exp_name=EXP, save_model_dir="./saved_model", vgg=vgg, lr=cfg["lr"],
        max_iter=tr["max_iter"], content_weight=cfg["content_weight"],
        style_weight=cfg["style_weight"], save_model_interval=tr["save_model_interval"],
        log_img_interval=tr["log_img_interval"])
    n_check = tr["checked_steps"]
    snaps = _Snapshots(n_check)
    try:
        adain_engine.run_decoder_training(
            args, src_feed, tgt_feed, lambda x: np.asarray(x) * np.array(inputs.IMAGENET_STD)
            + np.array(inputs.IMAGENET_MEAN), get_target_view=lambda t: t,
            get_source_image=lambda s: s, decoder_state=dec, device=device)
        finished = True
    except StopIteration:
        finished = False
    finally:
        snaps.handle.remove()
        shutil.rmtree(tmp, ignore_errors=True)
    sync(device)
    window_s = time.perf_counter() - clock.t0
    if sub is not None:
        sub.end()
    steps = src_feed.served - tr["warm_iters"]
    peak = memory_peak(device)
    trace = sub.summary() if sub is not None else {}

    log = os.path.join("logs", EXP, f"log_{EXP}.txt")
    with open(log) as f:
        rows = {int(m[1]): m for m in (LINE.match(line) for line in f) if m}
    prog = {"losses": [{"loss": float(rows[i][2]), "loss_c": float(rows[i][3]),
                        "loss_s": float(rows[i][4])} if i in rows else {}
                       for i in range(n_check)],
            "grad_first": {names[int(k)]: v for k, v in (snaps.grad_first or {}).items()},
            "change_student": ({names[i]: float((p - dec[names[i]]).double().norm())
                                for i, p in enumerate(snaps.params)} if snaps.params else {})}
    del snaps
    release(device)
    ref = reference_run(cfg, tr, cell.seed, device, n_check)
    numbers = compare.training_numbers(prog, ref)
    checks = compare.judge(numbers, cell.limits["numbers"],
                           exact={"loop_ended_before_window": (int(finished), 0)})
    return {
        "window_t0": clock.t0, "setup_parts": marks, "window_s": window_s,
        "e2e": {tr["metrics"]["rate"]: steps * cfg["batch"] / window_s},
        "attempted": steps, "failed": 0, "checks": checks,
        "correct": all(c["ok"] for c in checks), "memory_peak_bytes": peak, "trace": trace,
        "counters": {"window_steps": steps},
        "info": {"checked_losses": prog["losses"], "reference_losses": ref["losses"],
                 "numbers": numbers},
    }


def control_numbers(cell, seed: int, device, kind: str) -> dict:
    """The reference in the program's place, in bfloat16 (one precision
    below TF32) or with half of each batch left out, against the float32
    reference."""
    cfg, tr = cell.config, cell.traffic
    n = tr["checked_steps"]
    ref = reference_run(cfg, tr, seed, device, n)
    kw = {"control": dict(precision="bf16"), "half_batch": dict(half_batch=True)}[kind]
    return compare.training_numbers(reference_run(cfg, tr, seed, device, n, **kw), ref)
