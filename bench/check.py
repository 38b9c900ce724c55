"""How ``correct`` is decided: the program's first steps against the plain
reference's, on the same weights and batches.

Each side gives :class:`Readings`: each checked step's loss; the norm of
each leaf's step-1 gradient as AdamW takes it (the program's worked out
from its first moment after one step, ``m / (1 - b1)``); and the norm of
each leaf's change over the checked steps.  Three numbers are compared,
each with its limit in the cell's ``limits/<cell>.json``:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: by the worst leaf, the gap between the two sides' gradient
  norms over the reference's norm of that leaf or of the median leaf,
  whichever is larger;
* ``change_gap``: the same of the change, over the leaves whose reference
  gradient is at least a thousandth of the median leaf's (a leaf whose
  gradient is nought to rounding moves under AdamW by round-off alone).

A non-finite reading is an infinite gap."""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
#: a leaf's reference gradient below this share of the median leaf's is
#: left out of the change
MIN_GRAD_SHARE = 1e-3


@dataclass
class Readings:
    losses: list
    grads: dict        # leaf -> norm
    changes: dict      # leaf -> norm


def _gap(a: float, b: float, floor: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), floor) if max(abs(b), floor) > 0 \
        else (0.0 if a == b else math.inf)


def _worst_leaf(prog: dict, ref: dict, leaves) -> tuple:
    """(the worst leaf's gap, its name)."""
    leaves = list(leaves)
    if set(prog) != set(ref):
        return math.inf, "leaves differ"
    floor = statistics.median(ref[n] for n in leaves)
    return max((_gap(prog[n], ref[n], floor), n) for n in leaves)


def left_out(ref: Readings) -> list[str]:
    """The leaves the change is not compared on (see the module's
    docstring)."""
    median = statistics.median(ref.grads.values())
    return sorted(n for n, g in ref.grads.items()
                  if g < MIN_GRAD_SHARE * median)


def gaps(prog: Readings, ref: Readings) -> dict:
    """{number: (value, where)}."""
    if len(prog.losses) != len(ref.losses):
        loss = (math.inf, "steps differ")
    else:
        loss = max((_gap(a, b, 0.0), f"step {i + 1}") for i, (a, b) in
                   enumerate(zip(prog.losses, ref.losses)))
    out = set(left_out(ref))
    return {"loss_gap": loss,
            "grad_gap": _worst_leaf(prog.grads, ref.grads, ref.grads),
            "change_gap": _worst_leaf(
                prog.changes, ref.changes,
                [n for n in ref.grads if n not in out])}


def judge(found: dict, limits: dict) -> tuple[bool, dict]:
    """-> (correct, {number: {"value", "limit", "at"}}): correct where
    every number lies at or under its limit."""
    out, ok = {}, True
    for name in NUMBERS:
        value, where = found[name]
        limit = limits[name]
        if not value <= limit:
            ok = False
        out[name] = {"value": value, "limit": limit, "at": where}
    return ok, out
