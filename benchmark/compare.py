"""The comparison that decides ``correct``: the numbers compared and their
limits (``limits/<cell>.json``, each set from measured readings, see
PERF.md).

Training: the program's first steps against the reference's, from the same
weights, batches and draws:
- ``loss`` (each of the step's losses, every step): |program - reference| /
  |reference|, the largest; ``loss_first`` the same of the first step;
- ``heatmaps_first``: the student's heatmaps of the first step's source
  batch, ||program - reference|| / ||reference|| (the adaptation step);
  ``heatmaps_first_styled`` in its place where the first step's s2t gate
  fired, the source then styled by the bfloat16 style switch, whose own
  rounding the student carries (each run reads one of the two);
- ``grad_first``: the first gradient as the optimizer got it, by the worst
  leaf: the gap between the program's norm and the reference's over the
  larger of the reference's norm of that leaf and the median leaf's;
  ``grad_first_median`` the median leaf's gap;
- ``change_student`` / ``change_teacher``: the same of the parameters'
  change after the checked steps, over the leaves whose first gradient in
  the reference is at least a thousandth of the median leaf's (the others
  move under Adam by round-off alone).

The adaptation cells read these numbers of two stages. The start: the
first steps from the seed's weights, each epoch's first call of a gate case
eager. The replays, named ``replay_<number>``: from a snapshot of the
program's state once every gate case's graph is captured, calls of the
window's size through the same step or bundler, which replays its graphs;
the reference goes on from the snapshot (both models, Adam's moments and
step, the occlusion generator's state), and ``replay_missed`` counts the
steps that did not replay a graph.

Serving: a seeded sample of the window's requests against the reference's
forward of the same images:
- ``heatmap``: the largest |program - reference| over the reference's
  largest |value| of the request;
- ``pred``: the widest gap by which the reference's heatmap at the
  program's answer lies below the reference's own maximum, over the same
  largest |value| (0 where the program picks the reference's best); where
  the decode zeroes an answer (maxval not positive), the gap is how far
  the reference's maximum lies above 0;
- ``maxval``: the largest |program - reference| of the maxima, over the
  reference's largest |maximum|.
"""

from __future__ import annotations

import math
import statistics
from typing import Mapping

import torch


def _leaf_gap(prog: Mapping, ref: Mapping, leaves, median: bool = False) -> float:
    """The worst (or with ``median`` the median) leaf's gap of norms, each
    over the larger of the reference's norm of the leaf and of the median
    leaf."""
    med = statistics.median(ref[k] for k in ref)
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves]
    if not gaps:
        return 0.0
    return statistics.median(gaps) if median else max(gaps)


def relative_l2(got, want) -> float:
    """||got - want|| / ||want||, in float64."""
    want = want.double()
    return float((got.to(want.device).double() - want).norm()
                 / want.norm().clamp(min=1e-300))


def training_detail(prog: Mapping, ref: Mapping) -> dict:
    """Where the training numbers come from: each loss's gap by step, and
    of each leaf measure the median leaf's gap and the five worst leaves."""
    out = {"loss_by_step": [{k: abs(p.get(k, math.nan) - v) / max(abs(v), 1e-30)
                             for k, v in r.items()}
                            for p, r in zip(prog["losses"], ref["losses"])]}
    if "heatmaps_s" in ref:
        out["heatmaps_s_by_step"] = {i: relative_l2(prog["heatmaps_s"][i], ref["heatmaps_s"][i])
                                     for i in prog.get("heatmaps_s", {}) if i in ref["heatmaps_s"]}
    for name in ("grad_first", "change_student", "change_teacher"):
        r, p = ref.get(name), prog.get(name) or {}
        if not r or set(p) != set(r):
            continue
        med = statistics.median(r.values())
        gaps = sorted(((abs(p[k] - r[k]) / max(r[k], med, 1e-30), k) for k in r), reverse=True)
        out[name] = {"median_leaf_norm": med,
                     "median_gap": statistics.median(g for g, _ in gaps),
                     "worst": [[k, g, r[k]] for g, k in gaps[:5]]}
    return out


def training_numbers(prog: Mapping, ref: Mapping) -> dict:
    """``prog``/``ref``: {"losses": [{name: value} per step], "grad_first":
    {leaf: norm}, "change_student": {leaf: norm}, "change_teacher": {leaf:
    norm}}. Missing or non-finite values read as infinitely far."""
    out = {}
    if len(prog["losses"]) != len(ref["losses"]):
        return {"loss": math.inf}
    gaps = []
    for p, r in zip(prog["losses"], ref["losses"]):
        for k, rv in r.items():
            pv = p.get(k, math.nan)
            gaps.append(abs(pv - rv) / max(abs(rv), 1e-30) if math.isfinite(pv) else math.inf)
    out["loss"] = max(gaps)
    out["loss_first"] = max(gaps[:len(ref["losses"][0])])
    if "heatmaps_s" in ref:
        got = prog.get("heatmaps_s", {}).get(0)
        gap = math.inf if got is None else relative_l2(got, ref["heatmaps_s"][0])
        styled = ref["draws"][0][1][0]  # the first step's s2t gate
        out["heatmaps_first"] = None if styled else gap
        out["heatmaps_first_styled"] = gap if styled else None
    g_ref = ref["grad_first"]
    if set(prog["grad_first"]) != set(g_ref):
        return dict(out, grad_first=math.inf)
    out["grad_first"] = _leaf_gap(prog["grad_first"], g_ref, g_ref)
    out["grad_first_median"] = _leaf_gap(prog["grad_first"], g_ref, g_ref, median=True)
    med = statistics.median(g_ref.values())
    moving = [k for k, v in g_ref.items() if v >= 1e-3 * med]
    for name in ("change_student", "change_teacher"):
        if name not in ref:
            continue
        p, r = prog.get(name, {}), ref[name]
        if set(p) != set(r):
            out[name] = math.inf
        else:
            out[name] = _leaf_gap(p, {k: r[k] for k in moving}, moving)
    return {k: (v if v is None or math.isfinite(v) else math.inf) for k, v in out.items()}


def serving_numbers(prog, ref) -> dict:
    """``prog``/``ref``: (heatmaps, preds, maxvals) of one request, tensors.

    Each number is on the scale of the request's largest reference heatmap
    value. ``pred``: how far below the reference's best the answer lies.
    Where the program's maxval is not positive, the decode's rule zeroes the
    preds: the answer is then (0, 0), and its gap is how far the
    reference's best lies above 0 (an answer other than (0, 0) reads 1)."""
    hm_p, preds_p, max_p = (t.double() for t in prog)
    hm_r, _, max_r = (t.double() for t in ref)
    b, k, h, w = hm_r.shape
    scale = hm_r.abs().amax().clamp(min=1e-30)
    flat = hm_r.reshape(b, k, h * w)
    idx = (preds_p[..., 1] * w + preds_p[..., 0]).long().clamp(0, h * w - 1)
    top = flat.amax(dim=2)
    argmax_gap = top - flat.gather(2, idx[..., None])[..., 0]
    zero_gap = torch.where((preds_p == 0).all(dim=-1), top.clamp(min=0), scale)
    pred_gap = torch.where(max_p[..., 0] <= 0, zero_gap, argmax_gap) / scale
    return {
        "heatmap": float((hm_p - hm_r).abs().amax() / scale),
        "pred": float(pred_gap.amax()),
        "maxval": float((max_p - max_r).abs().amax() / max_r.abs().amax().clamp(min=1e-30)),
    }


def judge(numbers: Mapping, limits: Mapping, exact: Mapping = None) -> list:
    """Each number the cell's limits name, beside its limit: [{"name",
    "value", "limit", "ok"}]; a number the run could not read fails, one
    that its draws do not give (None) is left out.
    ``exact`` numbers must equal their limit."""
    out = []
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        if value is None:  # a number this run's draws do not give
            continue
        ok = math.isfinite(value) and value <= limit
        out.append({"name": name, "value": value, "limit": limit, "ok": bool(ok)})
    for name, (value, want) in (exact or {}).items():
        out.append({"name": name, "value": value, "limit": want, "ok": value == want})
    return out
