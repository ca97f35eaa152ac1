"""The numbers a training cell's output check compares, each against a
limit of limits/<workload>.json.

  loss_gap    the widest gap of the first steps' losses, |program -
              reference| / |reference|;
  grad_gap    the worst leaf's gap of first-step gradient norms (as the
              optimizer gets it), |program - reference| / max(the
              reference's norm of the leaf, of the median leaf);
  update_gap  the same of the parameters' change after the first steps;
  first_loss_gap, median_grad_gap, median_update_gap, mean_grad_gap,
  mean_update_gap
              the steadier forms: the first step's loss alone, and the
              median or the mean of the leaves' gaps in place of the worst
              leaf's;
  first_<term>_gap
              the first step's gap of one loss term the step reports
              (loss_rpn_reg, ...), whose inputs no sampling decides.

A cell compares the numbers its limits file names (PERF.md says why
each cell compares which).

Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of both leaf gaps: the loss does not reach them (the
custom model's FPN output convolutions above level 0), so they move by
the weight decay alone, alike on both sides."""

from __future__ import annotations

import math
import statistics
from typing import Dict

SMALL_GRAD = 1e-3
TRAIN_NUMBERS = ("loss_gap", "grad_gap", "update_gap", "first_loss_gap",
                 "median_grad_gap", "median_update_gap", "mean_grad_gap",
                 "mean_update_gap")


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep):
    med = statistics.median(ref[n] for n in keep)
    return [abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in keep]


def train_numbers(prog: Dict, ref: Dict, details: bool = False
                  ) -> Dict[str, float]:
    """prog, ref: {"loss": [..], "grad": {leaf: norm}, "delta": {leaf:
    norm}} (ref as reference/train.py:follow returns it). With
    `details`, also each step's loss gap, the median leaf's update gap,
    the three leaves that set each leaf gap ([leaf, gap, reference
    norm]) and the leaves left out."""
    loss = max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(prog["loss"], ref["loss"]))
    med = statistics.median(ref["grad"].values())
    keep = [n for n, g in ref["grad"].items() if g >= SMALL_GRAD * med]
    grads = _leaf_gaps(prog["grad"], ref["grad"], keep)
    updates = _leaf_gaps(prog["delta"], ref["delta"], keep)
    out = {"loss_gap": loss, "grad_gap": max(grads),
           "update_gap": max(updates),
           "first_loss_gap": abs(prog["loss"][0] - ref["loss"][0])
           / max(abs(ref["loss"][0]), 1e-30),
           "median_grad_gap": statistics.median(grads),
           "median_update_gap": statistics.median(updates),
           "mean_grad_gap": statistics.fmean(grads),
           "mean_update_gap": statistics.fmean(updates)}
    if prog.get("terms") and ref.get("terms"):
        p1, r1 = prog["terms"][0], ref["terms"][0]
        out.update({f"first_{k}_gap": abs(p1[k] - r1[k])
                    / max(abs(r1[k]), 1e-30) for k in r1 if k in p1})
    out = {k: (v if math.isfinite(v) else float("inf"))
           for k, v in out.items()}
    if details:
        dmed = statistics.median(ref["delta"][n] for n in keep)

        def worst(key, m):
            gaps = sorted(((abs(prog[key][n] - ref[key][n]) /
                            max(ref[key][n], m), n) for n in keep),
                          reverse=True)[:3]
            return [[n, g, ref[key][n]] for g, n in gaps]

        out.update(
            term_gaps=[{k: abs(p[k] - r[k]) / max(abs(r[k]), 1e-30)
                        for k in r} for p, r in
                       zip(prog.get("terms", []), ref.get("terms", []))],
            step_loss_gaps=[abs(p - r) / abs(r) for p, r in
                            zip(prog["loss"], ref["loss"])],
            leaf_grad_gaps=dict(zip(keep, grads)),
            worst_grad=worst("grad", med), worst_update=worst("delta", dmed),
            left_out=sorted(set(ref["grad"]) - set(keep)))
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number the limits name at or under its limit; no limits,
    not correct."""
    return bool(limits) and all(numbers.get(k, float("inf")) <= lim
                                for k, lim in limits.items())


def rows_differ(pairs) -> float:
    """Rows ([B, K, ...] tensors compared pair by pair, a row differing
    where any of its values does in any pair) in which two results
    part: 0 for an exact match."""
    differ = None
    for a, b in pairs:
        rows = (a != b).reshape(a.shape[0], a.shape[1], -1).any(-1)
        differ = rows if differ is None else differ | rows
    return float(differ.sum())
