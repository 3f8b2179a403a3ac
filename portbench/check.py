"""The comparison that decides ``correct``: the numbers a run compares with
the plain reference, each held to the limit its cell file states.

Training (the first three steps of the very object the window then drives):
  * ``g_loss_step<k>``, ``d_loss_step<k>``: per step k, the relative gap
    of G_loss and of D_loss, |program - reference| / |reference|;
  * ``step1.<metric>``: the same of each other metric the first step
    reports (its loss terms, the discriminators' mean scores);
  * ``step1.worst_real_term``: the worst of those over the loss terms on
    real images (a name with "loss" in it ending in ``_real``: the
    discriminators' scores of the data path's images, both targets);
  * ``grad_leaf`` / ``grad_median_leaf``: the first gradient as Adam got
    it (the program's read back from its first moments after one step, m /
    (1 - beta1)), per parameter leaf the gap of the program's norm and the
    reference's, over the larger of the reference's norm of that leaf and
    of the median leaf; the worst leaf / the median leaf;
  * ``change_leaf`` / ``change_median_leaf``: as ``grad_leaf`` of each
    leaf's change after three steps.
Both leave out the leaves whose first reference gradient is under a
thousandth of the median leaf's: a conv bias that InstanceNorm cancels has
a gradient that is rounding on either side, and Adam moves it by round-off
alone. A run computes the numbers its cell's ``limits`` name;
``calibrate.py`` all of them.
Serving: ``image_rms``: per sampled request, the RMS of the difference of
the served images and the reference's, over the RMS of the reference's; the
worst request.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Mapping, Sequence

#: a leaf whose reference gradient is under this share of the median
#: leaf's is left out of ``change_leaf``
STILL_LEAF = 1e-3


def rel(a: float, b: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_gaps(program: Mapping[str, float], reference: Mapping[str, float],
              keep: Sequence[str] = None) -> list:
    """Per leaf of `keep` (all by default), |norm gap| over max(its
    reference norm, the median leaf's reference norm); a leaf the program
    lacks reads inf."""
    keys = list(reference) if keep is None else list(keep)
    median = statistics.median(reference[k] for k in reference)
    out = []
    for k in keys:
        p = program.get(k, math.nan)
        out.append(abs(p - reference[k]) / max(reference[k], median, 1e-30)
                   if math.isfinite(p) else math.inf)
    return out


def leaf_gap(program, reference, keep=None) -> float:
    """The worst leaf of ``leaf_gaps``."""
    return max(leaf_gaps(program, reference, keep), default=0.0)


def worst_leaves(program: Mapping[str, float], reference: Mapping[str, float],
                 keep: Sequence[str] = None, top: int = 5):
    """The `top` leaves of ``leaf_gap``: (gap, name, program, reference)."""
    keys = list(reference) if keep is None else list(keep)
    median = statistics.median(reference.values())
    rows = [(abs(program.get(k, math.nan) - reference[k])
             / max(reference[k], median, 1e-30), k, program.get(k),
             reference[k]) for k in keys]
    return sorted(rows, key=lambda r: -r[0] if math.isfinite(r[0])
                  else -math.inf)[:top]


def moving_leaves(ref_grad: Mapping[str, float]):
    median = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= STILL_LEAF * median]


def training_numbers(prog: dict, ref: dict, wanted=None) -> Dict[str, float]:
    """`prog` and `ref` hold "losses" [(G, D) per step], "metrics" (the
    first step's), "grad" and "change" {leaf: norm}; the numbers of
    `wanted` (all by default). A reference that could not run ({}) makes
    each of them inf."""
    if not ref:
        return {k: math.inf for k in wanted or ()}
    out = {}
    for k, (r, p) in enumerate(zip(ref["losses"], prog["losses"]
                                   + [(math.nan, math.nan)] * len(
                                       ref["losses"])), 1):
        out[f"g_loss_step{k}"] = rel(p[0], r[0])
        out[f"d_loss_step{k}"] = rel(p[1], r[1])
    for k, v in ref.get("metrics", {}).items():
        if k not in ("G_loss", "D_loss"):
            out[f"step1.{k}"] = rel(prog.get("metrics", {}).get(k, math.nan), v)
    real = [v for k, v in out.items()
            if k.startswith("step1.") and "loss" in k and k.endswith("_real")]
    if real:
        out["step1.worst_real_term"] = max(real)
    keep = moving_leaves(ref["grad"])
    for name in ("grad", "change"):
        if wanted is None or any(w.startswith(name) for w in wanted):
            gaps = leaf_gaps(prog[name], ref[name], keep)
            out[f"{name}_leaf"] = max(gaps, default=0.0)
            out[f"{name}_median_leaf"] = statistics.median(gaps)
    return out if wanted is None else {k: out.get(k, math.inf)
                                       for k in wanted}


def verdict(numbers: Mapping[str, float], limits: Mapping[str, float]):
    """(correct, [(name, value, limit)]): every limited number at or under
    its limit, and every limit's number present."""
    rows = [(k, numbers.get(k, math.inf), lim) for k, lim in limits.items()]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
