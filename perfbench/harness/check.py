"""The comparison that decides ``correct`` for a training cell.

Both sides report, over the first K steps on the same weights and
batches: each step's loss, each trainable leaf's first gradient norm (the
program's from its optimizer's state after step 1) and each leaf's change
over the K steps (the program's from the fp32 master copy the next step
reads).  A leaf is a weight, or the stack of one weight over a stack's
layers.  The numbers compared:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the worst leaf's gap between the two gradient norms, over
  the larger of the reference's norm of that leaf and of the median leaf;
* ``change_gap``: the same for the change, over the leaves whose
  reference gradient is at least a thousandth of the median leaf's
  (a leaf below that moves under Adam by round-off alone).

Each is held to the cell's limit (``limits/<cell>.json``)."""

from __future__ import annotations

import math
import statistics

NAMES = ("loss_gap", "grad_gap", "change_gap")
TINY = 1e-3


def _rel(a: float, b: float, base: float) -> float:
    gap = abs(a - b) / base if base > 0 else math.inf
    return gap if math.isfinite(gap) else math.inf


def gaps(prog: dict, ref: dict) -> dict:
    out = dict.fromkeys(NAMES, math.inf)
    lp, lr = prog["losses"], ref["losses"]
    if len(lp) == len(lr):
        out["loss_gap"] = max(_rel(a, b, abs(b)) for a, b in zip(lp, lr))
    gr, gp = ref["grad1"], prog["grad1"]
    if set(gp) != set(gr) or set(prog["change"]) != set(ref["change"]):
        return out
    med = statistics.median(gr.values())
    out["grad_gap"] = max(_rel(gp[k], g, max(g, med))
                          for k, g in gr.items())
    kept = [k for k, g in gr.items() if g >= TINY * med]
    cr, cp = ref["change"], prog["change"]
    medc = statistics.median(cr[k] for k in kept)
    out["change_gap"] = max(_rel(cp[k], cr[k], max(cr[k], medc))
                            for k in kept)
    return out


def judge(found: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}); a value that is not a finite
    number is reported as null and fails."""
    checks, ok = {}, True
    for name in NAMES:
        v, lim = found.get(name, math.inf), float(limits[name])
        fin = isinstance(v, float) and math.isfinite(v)
        ok = ok and fin and v <= lim
        checks[name] = {"value": v if fin else None, "limit": lim}
    return ok, checks
