"""The comparison that decides ``correct``: the numbers read from the
program against the reference, each held to the limit its workload file
gives it.
"""

from __future__ import annotations

import statistics

from portbench.common import check_line

# a leaf whose step-1 reference gradient is under this share of the
# median leaf's moves under Adam by round-off alone: it is left out of
# the change's comparison
STILL_LEAF = 1e-3


def counted_leaves(ref_grad_norms: dict) -> list:
    """Leaves whose reference gradient is not nought to rounding."""
    med = statistics.median(ref_grad_norms.values())
    return sorted(n for n, g in ref_grad_norms.items()
                  if g >= STILL_LEAF * med)


def worst_leaf_gap(prog: dict, ref: dict, names) -> tuple[float, str]:
    """The largest gap between the program's norm of a leaf and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    names = list(names)
    med = statistics.median(ref[n] for n in names)
    worst, where = 0.0, ""
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med)
        if gap >= worst:
            worst, where = gap, n
    return worst, where


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: ``losses``, ``grad_norms`` (step 1) and
    ``change_norms`` (after the last compared step)."""
    leaves = counted_leaves(ref["grad_norms"])
    loss_gap = max(abs(a - b) for a, b in zip(prog["losses"], ref["losses"]))
    grad_gap, grad_leaf = worst_leaf_gap(prog["grad_norms"],
                                         ref["grad_norms"], ref["grad_norms"])
    change_gap, change_leaf = worst_leaf_gap(prog["change_norms"],
                                             ref["change_norms"], leaves)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "grad_leaf": grad_leaf,
            "change_leaf": change_leaf,
            "leaves_left_out": len(ref["grad_norms"]) - len(leaves)}


def judge(numbers: dict, limits: dict) -> list[dict]:
    """Each limited number beside its limit; a number that is missing or
    not finite fails."""
    out = []
    for name, limit in limits.items():
        value = numbers.get(name)
        ok = value is not None and value == value and value <= limit
        out.append(check_line(name, value, limit, ok))
    return out
