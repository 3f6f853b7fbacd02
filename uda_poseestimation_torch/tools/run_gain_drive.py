"""Adaptation-gain drive: does mean-teacher adaptation lift target PCK?

The twin of the repository's ``tools/run_gain_drive.py``, through the
port's CLI. No real dataset is needed: the pair comes from ``fixtures``:

- source: ``rhd``, the clean blob-learnable RHD tree;
- target: ``rhd_shifted``, the same task under a strong appearance shift
  (``--shift hard``: ``rhd_shifted_hard``). Its keypoints come from another
  seed, so it is not image-paired with the source.

Two runs at the deployed configuration (pose_resnet101, 256², b=32,
``--device-aug --decode-cache 2 --steps-per-dispatch 8``, seed 0):

1. ``adapt``: ``--pretrain-epoch`` epochs on the source, then mean-teacher
   adaptation on the shifted target;
2. ``control``: the same schedule kept source-only for every epoch.

The gate: the adapt run's best target PCK in its adaptation phase must
reach its frozen-pretrain level (its own target PCK at epoch
``pretrain_epoch - 1``) plus ``--min-gain``, else the drive exits 1 with the
numbers. The JAX drive prints its margins and checks none. The gate shows
that the run trains on; it does not tell adaptation from more source
training, since the control's own margin (its best target PCK over the same
epochs less its own level at ``pretrain_epoch - 1``) can pass it too. That
margin and the mean delta against the control are printed and recorded in
``<log-root>/gain.json``, not held to a limit.

    python -m uda_poseestimation_torch.tools.run_gain_drive run [--epochs 8 --pretrain-epoch 3 -i 75]
    python -m uda_poseestimation_torch.tools.run_gain_drive parse <adapt_log_dir> <control_log_dir>

``run`` writes the fixtures, runs both drives one after the other, then
reports. ``parse`` reads an existing pair of CompleteLogger directories
(the ``<log>_<arch>`` directories holding ``train-*.txt``; the latest file
of each only).
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import statistics
import subprocess
import sys

from . import fixtures
from .run_benchmarks import _EPOCH_RE, REPO


def parse_curve(log_dir: str):
    """-> sorted [(epoch, source_pck, target_pck)] from the latest
    train-*.txt in ``log_dir`` (CompleteLogger writes one per run; files of
    earlier or killed runs must not leak into the curve)."""
    txts = sorted(glob.glob(os.path.join(log_dir, "train-*.txt")))
    if not txts:
        return []
    rows = {}
    with open(txts[-1]) as f:
        for m in _EPOCH_RE.finditer(f.read()):
            rows[int(m.group(1))] = (float(m.group(2)), float(m.group(3)))
    return [(e,) + rows[e] for e in sorted(rows)]


def _margin(curve, pretrain_epoch: int):
    """(target PCK at epoch ``pretrain_epoch - 1``, best target PCK from
    epoch ``pretrain_epoch`` on, the second less the first), NaN where an
    epoch is missing."""
    frozen = dict((e, t) for e, _, t in curve).get(pretrain_epoch - 1, float("nan"))
    later = [t for e, _, t in curve if e >= pretrain_epoch]
    best = max(later) if later else float("nan")
    return frozen, best, best - frozen


def report(adapt_dir: str, control_dir: str, pretrain_epoch: int) -> dict:
    """Print both curves side by side and return the record: the curves, the
    frozen-pretrain level, the adaptation phase's best target PCK, the
    margin between them, the control's margin over the same epochs, and the
    mean delta against the control over the adaptation phase (NaN where no
    epoch pairs up)."""
    a = parse_curve(adapt_dir)
    c = parse_curve(control_dir)
    if not a or not c:
        raise SystemExit(f"no epoch-summary lines found (adapt={adapt_dir}: "
                         f"{len(a)} rows, control={control_dir}: {len(c)} "
                         f"rows); pass the CompleteLogger <log>_<arch> dirs")
    print(f"{'epoch':>5} {'phase':>8} {'adapt tgt':>9} {'control tgt':>11} {'delta':>7}")
    cd = {e: t for e, _, t in c}
    gain_rows = []
    for e, _, tgt in a:
        phase = "pretrain" if e < pretrain_epoch else "adapt"
        ctl = cd.get(e)
        delta = (tgt - ctl) if ctl is not None else float("nan")
        if e >= pretrain_epoch and ctl is not None:
            gain_rows.append(delta)
        print(f"{e:>5} {phase:>8} {tgt:>9.3f} "
              f"{'--' if ctl is None else '%11.3f' % ctl} {delta:>7.3f}")
    control_delta = statistics.mean(gain_rows) if gain_rows else float("nan")
    if gain_rows:
        print(f"adaptation-phase mean delta (adapt - source-only control): "
              f"{control_delta:+.3f}")
    frozen, best, margin = _margin(a, pretrain_epoch)
    c_frozen, c_best, c_margin = _margin(c, pretrain_epoch)
    print(f"frozen-pretrain target PCK (epoch {pretrain_epoch - 1}): {frozen:.3f}; "
          f"best adaptation-phase target PCK: {best:.3f}; margin {margin:+.3f}")
    print(f"control over the same epochs: {c_frozen:.3f} -> best {c_best:.3f}; "
          f"margin {c_margin:+.3f}")
    return {"adapt": a, "control": c, "pretrain_epoch": pretrain_epoch,
            "frozen_pretrain": frozen, "best_adapt": best, "margin": margin,
            "control_margin": c_margin, "control_delta": control_delta}


def check_margin(record: dict, min_gain: float):
    """Exit 1 with the numbers unless the margin is at least ``min_gain``
    (a missing frozen level or adaptation phase fails too)."""
    margin = record["margin"]
    if math.isnan(margin) or margin < min_gain:
        raise SystemExit(
            f"adaptation gain below the margin: best adaptation-phase target PCK "
            f"{record['best_adapt']:.3f} - frozen-pretrain {record['frozen_pretrain']:.3f} "
            f"= {margin:+.3f} < {min_gain}")
    print(f"margin {margin:+.3f} >= {min_gain}: ok")


def drive_cmd(args, log, pretrain_epoch):
    return [sys.executable, "-m", "uda_poseestimation_torch.train_human",
            args.source_root, args.target_root,
            "-s", "RenderedHandPose", "-t", "RenderedHandPose",
            "--target-train", "RenderedHandPose_mt",
            "-a", args.arch, "-b", str(args.batch_size),
            "--test-batch", str(args.batch_size),
            "--epochs", str(args.epochs),
            "--pretrain-epoch", str(pretrain_epoch),
            "-i", str(args.iters), "--seed", str(args.seed),
            "--device-aug", "--decode-cache", "2",
            "--steps-per-dispatch", "8", "-p", "25", "--log", log]


def main(argv=None):
    logs = os.path.join(REPO, "logs", "gain_drive")
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=["run", "parse"])
    p.add_argument("dirs", nargs="*",
                   help="parse: <adapt>_<arch> and <control>_<arch> dirs")
    p.add_argument("--shift", choices=["v1", "hard"], default="v1",
                   help="which rhd_shifted fixture variant to (re)generate")
    p.add_argument("--source-root", default=os.path.join(logs, "fake_rhd"))
    p.add_argument("--target-root", default=os.path.join(logs, "fake_rhd_shifted"))
    p.add_argument("--log-root", default=logs,
                   help="the runs' --log parent; keep 'logs' in the path, so "
                        "that the checkpoints go to the 'checkpoints' twin")
    p.add_argument("-a", "--arch", default="pose_resnet101")
    p.add_argument("-b", "--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--pretrain-epoch", type=int, default=3)
    p.add_argument("-i", "--iters", type=int, default=75)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--min-gain", type=float, default=0.03,
                   help="required margin of the adaptation phase's best target "
                        "PCK over the frozen-pretrain level")
    args = p.parse_args(argv)

    if args.mode == "parse":
        if len(args.dirs) != 2:
            p.error("parse needs exactly two dirs: <adapt_log_dir> <control_log_dir> "
                    "(the <log>_<arch> directories)")
        record = report(args.dirs[0], args.dirs[1], args.pretrain_epoch)
    else:
        fixtures.make_rhd(args.source_root)
        fixtures.make_rhd(args.target_root, shift={"v1": True, "hard": "hard"}[args.shift])
        for name, pe in (("adapt", args.pretrain_epoch), ("control", args.epochs)):
            log = os.path.join(args.log_root, name)
            print(f"=== drive: {name} (pretrain-epoch {pe}) -> {log}_{args.arch}",
                  flush=True)
            subprocess.run(drive_cmd(args, log, pe), check=True, cwd=REPO)
        record = report(os.path.join(args.log_root, f"adapt_{args.arch}"),
                        os.path.join(args.log_root, f"control_{args.arch}"),
                        args.pretrain_epoch)
        os.makedirs(args.log_root, exist_ok=True)
        with open(os.path.join(args.log_root, "gain.json"), "w") as f:
            json.dump(dict(record, min_gain=args.min_gain), f, indent=2)
    check_margin(record, args.min_gain)
    return record


if __name__ == "__main__":
    main()
