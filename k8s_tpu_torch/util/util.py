"""The port's own copy of ``k8s_tpu/util/util.py``'s ``quantile_nearest``:
the one nearest-rank quantile that the request recorder
(``models/requestlog.py``) and the bench harnesses (``harness/``) share,
so their percentiles cannot drift apart."""

from __future__ import annotations


def quantile_nearest(sorted_vals, q: float) -> float:
    """Nearest-rank quantile of an ascending-sorted sequence (0.0 for
    empty input)."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[int(idx)]
