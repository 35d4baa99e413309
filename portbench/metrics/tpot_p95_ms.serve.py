"""The 95th percentile of the mean gap between a request's output tokens,
over every request sent in the window (one that never finished counting
as never served), as the engine's request recorder
(``models/requestlog.py``) stamps it, in ms."""

from portbench.common import quantile_nearest


def read(record):
    vals = sorted(float("inf") if r["e2e_s"] is None else r["tpot_s"]
                  for r in record.get("recorder", {}).get("requests", [])
                  if r["e2e_s"] is None or r["tpot_s"] is not None)
    v = quantile_nearest(vals, 0.95)
    return None if v is None else 1e3 * v
