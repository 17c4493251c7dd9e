"""The comparison that decides ``correct`` for a training cell.

The program's first steps (the window's own step on rows that all
differ) against the reference's, from the same seed:

- ``loss1_gap``: step 1's loss, |program − reference| / reference. Later
  steps' losses are read (``loss2_gap``) but not compared: after one
  AdamW step every weight has moved by the learning rate times the sign
  of its gradient, so rounding that flips the sign of a near-zero
  gradient moves the next loss as much in the program as in the float8
  control (the readings are in PERF.md);
- ``grad_gap``: each weight's gradient norm at step 1 (the program's
  read from its optimizer's first moment), the gap of the two norms over
  the reference's norm of that weight or of the median weight, whichever
  is larger, the worst weight;
- ``change_gap``: the same of each weight's change over the steps
  followed, leaving out weights whose reference gradient is under a
  thousandth of the median weight's (they move by round-off alone).

A cell's file gives the limit of each number it compares; a number
whose readings gave no upper reading (PERF.md) is read and printed but
not compared. A compared number with a NaN or an infinity fails.
"""

from __future__ import annotations

import math
import statistics

NUMBERS = ("loss1_gap", "grad_gap", "change_gap", "proj_gap_median",
           "proj_gap_max")

#: A weight moves by round-off alone when its reference gradient norm is
#: under this share of the median weight's.
STILL = 1e-3


def _worst(prog: dict, ref: dict, names) -> tuple[float, str]:
    names = list(names)
    floor = statistics.median(ref[n] for n in names)
    worst, where = -1.0, ""
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], floor)
        if not math.isfinite(gap):
            return math.inf, n
        if gap > worst:
            worst, where = gap, n
    return worst, where


def _proj_gaps(prog: dict, ref: dict) -> dict[str, float]:
    """Each weight's ‖P(g_program − g_reference)‖ / ‖P g_reference‖ over
    the seeded projections P: the relative difference of the two
    gradients, estimated."""
    out = {}
    for n, q in ref.items():
        diff = math.sqrt(sum((a - b) ** 2 for a, b in zip(prog[n], q)))
        size = math.sqrt(sum(b * b for b in q))
        out[n] = diff / size if size > 0 else math.inf
    return out


def needs_projections(limits: dict) -> bool:
    """Whether a cell compares a ``proj_gap_*`` number: only then do the
    program and the reference project their gradients."""
    return any(k.startswith("proj_gap") for k in limits)


def readings(prog: dict, ref: dict) -> dict:
    """The compared numbers, and for each the weight or step that set it.
    The ``proj_gap_*`` numbers are there when both sides projected."""
    loss = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]
    loss = [x if math.isfinite(x) else math.inf for x in loss]
    g = ref["grad_norms"]
    grad_gap, grad_at = _worst(prog["grad_norms"], g, g)
    floor = statistics.median(g.values())
    moving = [n for n, v in g.items() if v >= STILL * floor]
    change_gap, change_at = _worst(prog["change_norms"], ref["change_norms"], moving)
    out = {f"loss{i + 1}_gap": x for i, x in enumerate(loss)}
    out.update(
        grad_gap=grad_gap, change_gap=change_gap,
        at={"loss1_gap": "step 1", "grad_gap": grad_at, "change_gap": change_at},
        still=sorted(set(g) - set(moving)),
    )
    if prog.get("grad_proj") is not None and ref.get("grad_proj") is not None:
        proj = _proj_gaps(prog["grad_proj"], ref["grad_proj"])
        out.update(proj_gap_median=statistics.median(proj.values()),
                   proj_gap_max=max(proj.values()))
        out["at"].update(proj_gap_median="median weight",
                         proj_gap_max=max(proj, key=proj.get))
    return out


def decide(numbers: dict, limits: dict) -> bool:
    """True when every number ``limits`` names is finite and within it."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= limit
               for k, limit in limits.items())


def lines(numbers: dict, limits: dict) -> list[str]:
    """One line a number: the compared ones last, each beside its limit."""
    read = [f"read {k} {numbers[k]!r} (not compared)"
            for k in sorted(numbers) if "_gap" in k and k not in limits]
    return read + [f"check {k} {numbers[k]!r} limit {limit!r} ({numbers['at'][k]})"
                   for k, limit in limits.items()]
