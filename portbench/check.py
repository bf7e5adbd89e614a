"""The comparison that decides ``correct``: the program's first training
steps against the reference's, from the same weights and batches.

Four numbers; a cell compares those its ``limits/<workload>.json`` gives a
limit (``limits``), and the run prints the others beside them:

* ``loss_gap``: the largest |loss − reference loss| / |reference loss| over
  the checked steps;
* ``grad_gap``: the worst leaf's |‖g‖ − ‖g_ref‖| at the first step (the
  gradient as the optimizer gets it, after the clip), over the larger of the
  reference's norm of that leaf and of the median leaf;
* ``update_gap``: the same of each leaf's change ‖p − p₀‖ after the last
  checked step, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf with no gradient to speak of moves
  by round-off alone);
* ``grad_err``: the relative error of the whole first gradient, ‖g − g_ref‖
  / ‖g_ref‖ over every leaf, each leaf's part estimated from the entries
  ``harness.sample_index`` draws from the seed.  A norm moves only at second
  order under errors that are as often up as down; the difference moves at
  first order, so a step down in precision shows here.

A reading that is not finite makes its number infinite.
"""

from __future__ import annotations

import math
import statistics

import torch

NUMBERS = ("loss_gap", "grad_gap", "update_gap", "grad_err")
#: leaves whose reference gradient norm is below this share of the median
#: leaf's are left out of the change's numbers
MOVED_FLOOR = 1e-3


def relative_error(prog: dict, ref: dict, sizes: dict, keys) -> float:
    """‖p − r‖ / ‖r‖ over the leaves ``keys``, each leaf's sum of squares
    estimated as its size times the mean square of its sampled entries."""
    num = den = 0.0
    for k in keys:
        num += sizes[k] * float(torch.mean((prog[k].double() - ref[k].double()).square()))
        den += sizes[k] * float(torch.mean(ref[k].double().square()))
    err = math.sqrt(num / den) if den > 0 else math.inf
    return err if math.isfinite(err) else math.inf


def worst(gap, scale: dict, keys) -> tuple[float, str]:
    """(the worst leaf's ``gap(k)`` over max(scale[k], the median scale), that leaf)."""
    med = statistics.median(scale[k] for k in keys)
    out = (0.0, "")
    for k in keys:
        g = gap(k)
        out = max(out, (g / max(scale[k], med) if math.isfinite(g) else math.inf, k))
    return out


def gaps(prog: dict, ref: dict, sizes: dict) -> tuple[dict, dict]:
    """(the four numbers, the leaf each leaf-wise number was worst at);
    ``sizes`` gives each leaf's number of entries."""
    loss = max((abs(p - r) / abs(r) if math.isfinite(p) and math.isfinite(r) else math.inf)
               for p, r in zip(prog["losses"], ref["losses"], strict=True))
    every = sorted(ref["grad_norms"])
    floor = MOVED_FLOOR * statistics.median(ref["grad_norms"].values())
    moved = [k for k in every if ref["grad_norms"][k] >= floor]
    out, at = {"loss_gap": loss}, {}
    for name, keys in (("grad", every), ("update", moved)):
        p, r = prog[f"{name}_norms"], ref[f"{name}_norms"]
        out[f"{name}_gap"], at[f"{name}_gap"] = worst(lambda k: abs(p[k] - r[k]), r, keys)
    out["grad_err"] = relative_error(prog["grad_samples"], ref["grad_samples"], sizes, every)
    return {k: out[k] for k in NUMBERS}, at


def passes(numbers: dict, limits: dict) -> bool:
    """Every number that has a limit is at most its limit."""
    return all(numbers[k] <= lim for k, lim in limits.items())
