"""Accuracy harness: the six canonical UDA benchmarks through the port.

The twin of the repository's ``tools/run_benchmarks.py``. The reference
publishes its PCK@0.05 results only in the ECCV'22 paper
(arXiv:2204.00172); its README and ``script`` give the command lines. Point
this harness at the real dataset roots and it runs each canonical line
through the port's CLI (``python -m uda_poseestimation_torch.train_human``,
``.train_animal``, ``.train_animal_other``) with every argument after the
trainer equal to the JAX harness's, reads the best target ``all`` PCK from
each run's log and writes a markdown and JSON table beside the paper's
numbers (``PAPER_PCK``, to be filled in once verified).

    python -m uda_poseestimation_torch.tools.run_benchmarks --data-root /data
    python -m uda_poseestimation_torch.tools.run_benchmarks --data-root /data --only RHD2H3D
    python -m uda_poseestimation_torch.tools.run_benchmarks --data-root /data --dry-run
    # knobs appended verbatim to every trainer command:
    python -m uda_poseestimation_torch.tools.run_benchmarks --data-root /data \\
        --extra --epochs 2 --pretrain-epoch 1 -i 5 --device-aug

The dataset roots are expected under --data-root (``--root NAME=PATH``
overrides one): FreiHand, RHD, surreal_processed, Human36M, lsp, H3D_crop,
animal_data. The trainers run from the repository's root, where the
``--decoder-name saved_models/...`` paths point.

Results are parsed from the trainer's ``train-<ts>.txt`` by the
epoch-summary line ("Epoch: N Source: A Target: B Target(best): C",
train_human.py:238-240) and the "name: value" PCK lines of the target's
groups after it. Unlike the JAX harness, the epoch pattern also accepts the
animal trainers' line, which prints each category's PCK before
``Target(best)``, and their group block, which follows a ``Target:`` line.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The paper's values (PCK@0.05, target 'all'), not verified offline: fill in
# from arXiv:2204.00172. None renders as "?" and leaves the delta empty.
PAPER_PCK = {
    "FreiHand2RHD": None,
    "SURREAL2Human36M": None,
    "SURREAL2LSP": None,
    "RHD2H3D": None,
    "SynAnimal2AnimalPose": None,
    "SynAnimal2TigDog": None,
}


def _common(rotation: int, decoder: str) -> list[str]:
    """The flags every benchmark shares (``script``, the reference's
    README.md:82-111): student and teacher augmentation, the mean-teacher and
    AdaIN style schedule, occlusion; the rotation is the benchmark's."""
    return [
        "--debug", "--seed", "0", "--lambda_c", "1",
        "--pretrain-epoch", "40",
        "--rotation_stu", str(rotation), "--shear_stu", "-30", "30",
        "--translate_stu", "0.05", "0.05", "--scale_stu", "0.6", "1.3",
        "--color_stu", "0.25", "--blur_stu", "0",
        "--rotation_tea", str(rotation), "--shear_tea", "-30", "30",
        "--translate_tea", "0.05", "0.05", "--scale_tea", "0.6", "1.3",
        "--color_tea", "0.25", "--blur_tea", "0",
        "-b", "32", "--mask-ratio", "0.5", "--k", "1",
        "--decoder-name", decoder,
        "--s2t-freq", "0.5", "--s2t-alpha", "0", "1",
        "--t2s-freq", "0.5", "--t2s-alpha", "0", "1",
        "--occlude-rate", "0.5", "--occlude-thresh", "0.9",
    ]


def _human(src_root, tgt_root, s, t, tt, log, rotation, decoder):
    return {
        "trainer": "uda_poseestimation_torch.train_human",
        "argv": ["{root}/" + src_root, "{root}/" + tgt_root,
                 "-s", s, "-t", t, "--target-train", tt,
                 "--log", "{log}/" + log, "--lambda_t", "0"]
                + _common(rotation, decoder),
    }


def _animal(trainer, source, target, target_ssl, log, decoder):
    return {
        "trainer": trainer,
        "argv": ["--image-path", "{root}/animal_data",
                 "--source", source, "--target", target,
                 "--target_ssl", target_ssl, "--train_on_all_cat",
                 "--log", "{log}/" + log]
                + _common(60, decoder),
    }


# the six canonical benchmarks (``script`` lines 6-11)
BENCHMARKS = {
    "FreiHand2RHD": _human(
        "FreiHand", "RHD", "FreiHand", "RenderedHandPose",
        "RenderedHandPose_mt", "f2r_exp/syn2real", 180,
        "saved_models/decoder_f2r_0_1.pth.tar"),
    "SURREAL2Human36M": _human(
        "surreal_processed", "Human36M", "SURREAL", "Human36M",
        "Human36M_mt", "s2h_exp/syn2real", 60,
        "saved_models/decoder_s2h_0_1.pth.tar"),
    "SURREAL2LSP": _human(
        "surreal_processed", "lsp", "SURREAL", "LSP", "LSP_mt",
        "s2l_exp/syn2real", 60, "saved_models/decoder_s2l_0_1.pth.tar"),
    "RHD2H3D": _human(
        "RHD", "H3D_crop", "RenderedHandPose", "Hand3DStudio",
        "Hand3DStudio_mt", "r2h_exp/syn2real", 180,
        "saved_models/decoder_r2h_0_1.pth.tar"),
    "SynAnimal2AnimalPose": _animal(
        "uda_poseestimation_torch.train_animal_other", "synthetic_animal_sp_all_other",
        "animal_pose", "animal_pose_mt", "syn2animal_pose/syn2real",
        "saved_models/decoder_animal_0_1.pth.tar"),
    "SynAnimal2TigDog": _animal(
        "uda_poseestimation_torch.train_animal", "synthetic_animal_sp_all",
        "real_animal_all", "real_animal_all_mt", "syn2real_animal/syn2real",
        "saved_models/decoder_animal_0_1.pth.tar"),
}

# the epoch summary; the animal trainers print "<Category>: <pck>" parts
# between the target's PCK and Target(best)
_EPOCH_RE = re.compile(
    r"Epoch: (\d+) Source: (\d+\.\d+) Target: (\d+\.\d+) "
    r"(?:[A-Za-z]+: \d+\.\d+ )*Target\(best\): (\d+\.\d+)")
# the target's "group: value" block: after the human summary line, or after
# the "Target:" line of the animal trainers' report
_GROUPS_RE = re.compile(
    r"(?:Target\(best\): \d+\.\d+|^Target:)\n((?:[\w ]+: \d+\.\d+\n?)+)", re.M)


def build_command(spec, data_root, log_root, extra):
    """The canonical argv of one benchmark, as ``python -m <trainer> ...``."""
    argv = [a.format(root=data_root.rstrip("/"), log=log_root.rstrip("/"))
            for a in spec["argv"]]
    return [sys.executable, "-m", spec["trainer"]] + argv + extra


def parse_result(log_arg, arch="pose_resnet101"):
    """Best target 'all' PCK and the last block of target groups from the
    trainer's log. ``log_arg`` is the value given to --log; CompleteLogger
    appends ``_<arch>`` and writes train-<timestamp>.txt inside."""
    root = f"{log_arg}_{arch}"
    txts = sorted(glob.glob(os.path.join(root, "train-*.txt")))
    if not txts:
        return None
    with open(txts[-1]) as f:
        text = f.read()
    epochs = _EPOCH_RE.findall(text)
    if not epochs:
        return None
    best = max(float(b) for _, _, _, b in epochs)
    groups = {}
    for block in _GROUPS_RE.findall(text):
        groups = {k: float(v) for k, v in re.findall(r"([\w ]+): (\d+\.\d+)", block)}
    return {"best_target_all_pck": best, "epochs_seen": len(epochs),
            "final_groups": groups, "log": txts[-1]}


def render_table(results):
    lines = ["| benchmark | target 'all' PCK@0.05 | paper | delta |",
             "|---|---|---|---|"]
    for name, res in results.items():
        paper = PAPER_PCK.get(name)
        if res is None or isinstance(res, str):
            got, delta = (res or "FAILED"), "—"
        else:
            got = f"{res['best_target_all_pck']:.3f}"
            delta = (f"{res['best_target_all_pck'] - paper:+.3f}"
                     if paper is not None else "—")
        lines.append(f"| {name} | {got} | "
                     f"{paper if paper is not None else '? (fill from arXiv:2204.00172)'} | {delta} |")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data-root", required=True,
                   help="directory containing the dataset roots")
    p.add_argument("--log-root", default="logs/benchmarks")
    p.add_argument("--only", nargs="*", default=None,
                   help=f"subset of {list(BENCHMARKS)}")
    p.add_argument("--root", action="append", default=[], metavar="NAME=PATH",
                   help="override a dataset root dir name, e.g. RHD=/x/rhd")
    p.add_argument("--arch", default="pose_resnet101",
                   help="arch suffix CompleteLogger appends to --log dirs")
    p.add_argument("--dry-run", action="store_true",
                   help="print the commands without running")
    p.add_argument("--out", default=None,
                   help="write the JSON results here (default <log-root>/results.json)")
    p.add_argument("--extra", nargs=argparse.REMAINDER, default=[],
                   help="everything after --extra is appended verbatim to every "
                        "trainer command (size and device knobs)")
    args = p.parse_args(argv)

    overrides = dict(kv.split("=", 1) for kv in args.root)
    names = args.only or list(BENCHMARKS)
    unknown = set(names) - set(BENCHMARKS)
    if unknown:
        p.error(f"unknown benchmark(s) {sorted(unknown)}; choose from {list(BENCHMARKS)}")

    results = {}
    for name in names:
        cmd = build_command(BENCHMARKS[name], args.data_root, args.log_root, args.extra)
        for i, a in enumerate(cmd):  # --root NAME=PATH on the materialized paths
            for sub, path in overrides.items():
                if a == os.path.join(args.data_root.rstrip("/"), sub):
                    cmd[i] = path
        log_arg = cmd[cmd.index("--log") + 1]
        print(f"[{name}] {' '.join(cmd)}", flush=True)
        if args.dry_run:
            results[name] = "DRY-RUN"
            continue
        t0 = time.time()
        proc = subprocess.run(cmd, cwd=REPO)
        dt = time.time() - t0
        if proc.returncode != 0:
            print(f"[{name}] FAILED rc={proc.returncode} after {dt:.0f}s",
                  file=sys.stderr, flush=True)
            results[name] = f"FAILED (rc={proc.returncode})"
            continue
        res = parse_result(log_arg, arch=args.arch)
        results[name] = res if res else "NO-RESULT (log parse failed)"
        print(f"[{name}] done in {dt:.0f}s -> {res and res['best_target_all_pck']}",
              flush=True)

    table = render_table(results)
    print("\n" + table)
    if not args.dry_run:
        out = args.out or os.path.join(args.log_root, "results.json")
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump({"results": results, "paper": PAPER_PCK, "table": table}, f,
                      indent=2, default=str)
        print(f"\nresults written to {out}")
    return results


if __name__ == "__main__":
    main()
