"""The 95th percentile of the time from submit to the first token, over
every request sent in the window (one that got no first token counting
as never served), as the engine's request recorder
(``models/requestlog.py``) stamps it, in ms."""

from portbench.common import quantile_nearest


def read(record):
    vals = sorted(float("inf") if r["ttft_s"] is None else r["ttft_s"]
                  for r in record.get("recorder", {}).get("requests", []))
    v = quantile_nearest(vals, 0.95)
    return None if v is None else 1e3 * v
