"""The comparison that decides ``correct`` for a train cell.

Each side (the program, the reference, or the control in the program's
place) gives its readings of the first steps from the same seeded weights
and batches: each step's loss, each leaf's norm of the first gradient as
the optimizer got it (clipped), and each leaf's norm of the change of its
float32 master weights over the steps. The numbers, each against the
reference:

* ``loss_gap``: ``|L - L_ref| / |L_ref|``, the largest over the steps;
* ``grad_gap``: ``|n - n_ref| / max(n_ref, median n_ref)`` of the
  gradient norms, the largest over the leaves (``grad_gap_median``: the
  median leaf's);
* ``change_gap``: the same of the change norms, the largest over the
  leaves whose reference gradient is at least a thousandth of the median
  leaf's (a leaf whose gradient is nought to rounding moves under Adam by
  round-off alone).

A configuration's ``limits`` name the numbers its cells compare, each with
its limit; a run is correct where each of those is within its limit.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Tuple

__all__ = ["NUMBERS", "gaps", "verdict"]

NUMBERS = ("loss_gap", "grad_gap", "grad_gap_median", "change_gap")
EXCLUDE_BELOW = 1e-3  # of the median leaf's reference gradient norm


def _leaf_gaps(got: Dict[str, float], ref: Dict[str, float], names) -> Dict[str, float]:
    """Each leaf's ``|got - ref| / max(ref, median ref)``."""
    floor = statistics.median(ref[n] for n in names)
    out = {}
    for n in names:
        denom = max(ref[n], floor)
        out[n] = (abs(got[n] - ref[n]) / denom if denom > 0 and math.isfinite(got[n])
                  else math.inf)
    return out


def _worst(got: Dict[str, float], ref: Dict[str, float], names) -> Tuple[float, str]:
    per = _leaf_gaps(got, ref, names)
    at = max(per, key=per.get)
    return per[at], at


def gaps(got: dict, ref: dict) -> Dict[str, object]:
    """The three numbers of ``got`` against ``ref`` (each a dict of
    ``losses``, ``grad_norms``, ``change_norms``), with the leaf each
    widest gap is at and the leaves left out of the change."""
    losses = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
              for a, b in zip(got["losses"], ref["losses"])]
    if len(got["losses"]) != len(ref["losses"]):
        losses.append(math.inf)
    names = sorted(ref["grad_norms"])
    if sorted(got["grad_norms"]) != names or sorted(got["change_norms"]) != names:
        raise ValueError("the two sides' leaves differ")
    grad, grad_at = _worst(got["grad_norms"], ref["grad_norms"], names)
    floor = statistics.median(ref["grad_norms"][n] for n in names)
    moved = [n for n in names if ref["grad_norms"][n] >= EXCLUDE_BELOW * floor]
    change, change_at = _worst(got["change_norms"], ref["change_norms"], moved)
    return {"loss_gap": max(losses), "grad_gap": grad, "change_gap": change,
            "grad_gap_at": grad_at, "change_gap_at": change_at,
            "left_out": sorted(set(names) - set(moved)),
            "loss_gaps": losses,
            "grad_gap_median": statistics.median(
                _leaf_gaps(got["grad_norms"], ref["grad_norms"], names).values())}


def verdict(found: Dict[str, object], limits: Dict[str, float]) -> bool:
    """Correct where the limits name known numbers and each is finite and
    within its limit."""
    if not limits or set(limits) - set(NUMBERS):
        return False
    return all(math.isfinite(found[k]) and found[k] <= v for k, v in limits.items())
