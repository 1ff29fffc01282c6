"""The numbers compared for ``correct``, as gaps between the program's
readings and the plain reference's.

* ``loss``: the largest relative gap of a step's loss over the steps the
  reference follows;
* ``grad``, ``change``: by the worst leaf, the gap between the program's
  norm and the reference's (not the norm of their difference), measured
  against the larger of the reference's norm of that leaf and of the
  median leaf.  ``change`` leaves out the leaves whose reference gradient
  is under a thousandth of the median leaf's (nought to rounding: AdamW
  moves them by round-off alone).
"""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional, Tuple

MOVED = 1e-3


def loss_gaps(prog: Iterable[float], ref: Iterable[float]) -> list:
    """Each step's relative loss gap; inf where the steps differ in number."""
    prog, ref = list(prog), list(ref)
    if len(prog) != len(ref) or not ref:
        return [float("inf")]
    return [abs(a - b) / abs(b) for a, b in zip(prog, ref)]


def median_leaf(prog: Dict[str, float], ref: Dict[str, float], keep: Iterable[str]) -> float:
    """The median over ``keep`` of the leaves' gaps (for the log: how far
    the worst leaf stands from the rest)."""
    median = statistics.median(abs(ref[k]) for k in ref)
    return statistics.median(abs(prog.get(k, float("inf")) - ref[k]) / max(abs(ref[k]), median,
                                                                           1e-30) for k in keep)


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keep: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """(the largest gap, its leaf); a leaf the program lacks reads inf."""
    names = sorted(ref if keep is None else keep)
    median = statistics.median(abs(ref[k]) for k in ref)
    gaps = {k: abs(prog.get(k, float("inf")) - ref[k]) / max(abs(ref[k]), median, 1e-30)
            for k in names}
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def moved(names: Iterable[str], ref_grad: Dict[str, float], leaf_of=lambda k: k) -> list:
    """The names whose leaf's reference gradient (``leaf_of`` maps a name
    to the leaf whose gradient moves it) is at least ``MOVED`` x the
    median leaf's."""
    median = statistics.median(ref_grad.values())
    return [k for k in names if ref_grad[leaf_of(k)] >= MOVED * median]
