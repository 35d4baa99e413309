"""Trace export: a bounded in-memory ring buffer with JSON serialization.
The port's own copy of ``k8s_tpu/trace/export.py``.

The exporter is the /debug/traces data source: a serving pod's last N
interesting traces, queryable without any external collector.  Finished
root span trees are serialized to plain dicts at export time (immutable
snapshots: a served trace can never be half-mutated by a live span) and
stored FIFO; when the buffer is full the oldest trace is evicted, also
under concurrent writers (one lock covers the append+evict pair).
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from collections import deque

DEFAULT_CAPACITY = 256


class RingBufferExporter:
    """Bounded FIFO of finished root span trees (as JSON-able dicts)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._traces: deque[dict] = deque(maxlen=capacity)
        self._exported = 0
        self._evicted = 0

    def export(self, root) -> None:
        """Store one finished root (a Span or an already-built dict).
        Serialization happens outside the lock; the append+evict pair is
        atomic under it, so eviction order stays FIFO no matter how many
        threads finish roots concurrently."""
        trace = root if isinstance(root, dict) else root.to_dict()
        with self._lock:
            if len(self._traces) == self._traces.maxlen:
                self._evicted += 1
            self._traces.append(trace)
            self._exported += 1

    def snapshot(self) -> list[dict]:
        """Oldest-first copy of the buffered traces."""
        with self._lock:
            return list(self._traces)

    def stats(self) -> dict:
        with self._lock:
            return {"buffered": len(self._traces),
                    "capacity": self.capacity,
                    "exported_total": self._exported,
                    "evicted_total": self._evicted}

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()


def select_traces(traces: list[dict], limit: int = 50,
                  job: str | None = None) -> list[dict]:
    """The /debug/traces view: slowest-first, optionally filtered to roots
    whose ``job`` attribute matches (exact or substring — callers pass
    "ns/name" or just the name)."""
    if job:
        traces = [t for t in traces
                  if job in str((t.get("attributes") or {}).get("job", ""))]
    traces = sorted(traces, key=lambda t: -t.get("duration_ms", 0.0))
    return traces[:max(limit, 0)]


def debug_traces_response(tracer, query_string: str = "") -> tuple[int, str, str]:
    """(status, body, content_type) for a /debug/traces endpoint — shared
    by the metrics server and the dashboard backend so both speak the same
    contract.  Tracing off is a 404 with an explicit "tracing disabled"
    body (distinguishable from a route typo's bare 404).

    Query params: ``n`` (max traces, default 50), ``job`` (filter).
    """
    if not tracer.enabled:
        return (404,
                "tracing disabled: set K8S_TPU_TRACE_SAMPLE to a rate in "
                "(0, 1] to enable span export\n",
                "text/plain")
    q = urllib.parse.parse_qs(query_string or "")
    try:
        limit = int(q.get("n", ["50"])[0])
    except ValueError:
        limit = 50
    job = (q.get("job", [None])[0]) or None
    traces = select_traces(tracer.exporter.snapshot(), limit=limit, job=job)
    body = json.dumps({
        "traces": traces,
        "count": len(traces),
        "exporter": tracer.exporter.stats(),
        "sample_rate": tracer.sample_rate,
        "slow_threshold_ms": round(tracer.slow_threshold_s * 1e3, 3),
    })
    return 200, body, "application/json"
