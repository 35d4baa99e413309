"""The 95th percentile of the wait from submit to admission into a slot,
over every request sent in the window (one never admitted counting as
waiting for ever), as the engine's request recorder
(``models/requestlog.py``) stamps it, in ms."""

from portbench.common import quantile_nearest


def read(record):
    vals = sorted(float("inf") if r["queue_wait_s"] is None
                  else r["queue_wait_s"]
                  for r in record.get("recorder", {}).get("requests", []))
    v = quantile_nearest(vals, 0.95)
    return None if v is None else 1e3 * v
