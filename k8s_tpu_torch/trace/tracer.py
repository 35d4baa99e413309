"""Tracing core: thread-safe spans with contextvar parenting.  The port's
own copy of ``k8s_tpu/trace/tracer.py``, with the same names and
behaviour; its locks are plain ``threading.Lock`` objects.

- **Zero-cost when off.** ``K8S_TPU_TRACE_SAMPLE`` unset or 0 makes
  ``start_span`` return one shared no-op span: no allocation, no
  contextvar write, one float compare.
- **Contextvar parenting.** The current span lives in a ``ContextVar``,
  so spans nest across thread pools when tasks are wrapped with
  :func:`bind_current_context` (each task gets its own ``Context`` copy;
  a shared copy cannot be entered concurrently).
- **Head + tail sampling.** When tracing is on, every root is recorded
  and the keep decision happens at root finish: head-sampled (trace-id
  coin flip at rate ``K8S_TPU_TRACE_SAMPLE``), slower than
  ``K8S_TPU_TRACE_SLOW_MS`` (default 250), or any span in the tree
  errored.

Stdlib only.
"""

from __future__ import annotations

import contextvars
import os
import random
import threading
import time
from typing import Optional

_current_span: contextvars.ContextVar = contextvars.ContextVar(
    "k8s_tpu_trace_span", default=None
)

DEFAULT_SLOW_THRESHOLD_S = 0.25


def _new_id(bits: int) -> str:
    """Random lowercase-hex id (W3C trace-context format: 128-bit trace
    ids, 64-bit span ids)."""
    return f"{random.getrandbits(bits):0{bits // 4}x}"


def _sample_rate_from_env() -> float:
    """K8S_TPU_TRACE_SAMPLE clamped to [0, 1]; garbage disables (the safe
    default for a knob that buys overhead)."""
    raw = os.environ.get("K8S_TPU_TRACE_SAMPLE", "")
    try:
        rate = float(raw)
    except ValueError:
        return 0.0
    return min(max(rate, 0.0), 1.0)


def _slow_threshold_from_env() -> float:
    raw = os.environ.get("K8S_TPU_TRACE_SLOW_MS", "")
    try:
        ms = float(raw)
    except ValueError:
        return DEFAULT_SLOW_THRESHOLD_S
    return max(ms, 0.0) / 1000.0


class Span:
    """One timed operation in a trace tree.

    Context-manager use (``with tracer.start_span("sync"): ...``) sets the
    span current for its block so children parent to it; manual use
    (construct, then :meth:`finish`) records the span without making it
    current — the REST client's per-attempt spans work this way.  A span
    attaches itself to its parent at finish; a finished root hands its
    whole tree to the tracer for the keep/drop decision.
    """

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "head_sampled",
        "attributes", "events", "children", "status", "status_message",
        "start_wall", "start", "end", "_tracer", "_parent", "_token",
        "_lock",
    )

    def __init__(self, tracer: "Tracer", name: str,
                 parent: Optional["Span"], trace_id: str,
                 head_sampled: bool, attributes: Optional[dict] = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_id(64)
        self.parent_id = parent.span_id if parent is not None else None
        self.head_sampled = head_sampled
        self.attributes: dict = dict(attributes or {})
        self.events: list[dict] = []
        self.children: list[Span] = []
        self.status = "ok"
        self.status_message = ""
        self.start_wall = time.time()
        self.start = time.monotonic()
        self.end: Optional[float] = None
        self._tracer = tracer
        self._parent = parent
        self._token = None
        self._lock = threading.Lock()

    # -- recording -----------------------------------------------------------

    @property
    def duration_s(self) -> float:
        end = self.end if self.end is not None else time.monotonic()
        return end - self.start

    def set_attribute(self, key: str, value) -> None:
        with self._lock:
            self.attributes[key] = value

    def add_event(self, name: str, **attributes) -> None:
        evt = {"name": name,
               "offset_ms": round((time.monotonic() - self.start) * 1e3, 3)}
        if attributes:
            evt["attributes"] = attributes
        with self._lock:
            self.events.append(evt)

    def set_error(self, exc_or_message) -> None:
        with self._lock:
            self.status = "error"
            if isinstance(exc_or_message, BaseException):
                self.status_message = (
                    f"{type(exc_or_message).__name__}: {exc_or_message}")
            else:
                self.status_message = str(exc_or_message)

    def has_error(self) -> bool:
        """True when this span or any descendant recorded an error."""
        with self._lock:
            if self.status == "error":
                return True
            children = list(self.children)
        return any(c.has_error() for c in children)

    # -- lifecycle -----------------------------------------------------------

    def __enter__(self) -> "Span":
        self._token = _current_span.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc is not None:
            self.set_error(exc)
        self.finish()
        return False

    def finish(self) -> None:
        if self.end is not None:
            return  # idempotent
        self.end = time.monotonic()
        if self._token is not None:
            try:
                _current_span.reset(self._token)
            except ValueError:
                # finished from a different Context (executor task that
                # outlived its copy); the copy dies with the task anyway
                pass
            self._token = None
        if self._parent is not None:
            with self._parent._lock:
                self._parent.children.append(self)
        else:
            self._tracer._finish_root(self)

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        """JSON-able snapshot of the subtree rooted here."""
        with self._lock:
            attributes = dict(self.attributes)
            events = list(self.events)
            children = list(self.children)
            # status and status_message are written together under the
            # lock (set_error); snapshot them in the same critical
            # section so a concurrent set_error can't tear the pair
            status = self.status
            status_message = self.status_message
        out = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_unix": round(self.start_wall, 6),
            "duration_ms": round(self.duration_s * 1e3, 3),
            "status": status,
            "attributes": attributes,
            "events": events,
            "children": [c.to_dict() for c in
                         sorted(children, key=lambda c: c.start)],
        }
        if status_message:
            out["status_message"] = status_message
        return out


class _NoopSpan:
    """Shared do-nothing span returned whenever tracing is off."""

    trace_id = None
    span_id = None
    parent_id = None
    head_sampled = False
    status = "ok"
    duration_s = 0.0
    attributes: dict = {}
    events: list = []
    children: list = []

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set_attribute(self, key, value) -> None:
        pass

    def add_event(self, name, **attributes) -> None:
        pass

    def set_error(self, exc_or_message) -> None:
        pass

    def finish(self) -> None:
        pass

    def has_error(self) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Span factory + sampling policy + exporter binding (thread-safe)."""

    def __init__(self, sample_rate: Optional[float] = None,
                 slow_threshold_s: Optional[float] = None, exporter=None):
        from k8s_tpu_torch.trace.export import RingBufferExporter

        self.exporter = exporter if exporter is not None else RingBufferExporter()
        self.sample_rate = (_sample_rate_from_env()
                            if sample_rate is None else sample_rate)
        self.slow_threshold_s = (_slow_threshold_from_env()
                                 if slow_threshold_s is None
                                 else slow_threshold_s)

    def configure(self, sample_rate: Optional[float] = None,
                  slow_threshold_s: Optional[float] = None,
                  exporter=None) -> "Tracer":
        """Re-apply settings; None re-reads the environment (so a test or
        binary that just set ``K8S_TPU_TRACE_SAMPLE`` can pick it up on an
        already-imported module)."""
        self.sample_rate = (_sample_rate_from_env()
                            if sample_rate is None else
                            min(max(sample_rate, 0.0), 1.0))
        self.slow_threshold_s = (_slow_threshold_from_env()
                                 if slow_threshold_s is None
                                 else slow_threshold_s)
        if exporter is not None:
            self.exporter = exporter
        return self

    @property
    def enabled(self) -> bool:
        return self.sample_rate > 0.0

    def start_span(self, name: str, **attributes):
        """A child of the current span, or a new root.  Enter it (``with``)
        to make it current for its block; an un-entered span still records
        and attaches to its construction-time parent on finish()."""
        if not self.enabled:
            return NOOP_SPAN
        parent = _current_span.get()
        if parent is None or parent is NOOP_SPAN:
            return Span(self, name, None, _new_id(128),
                        random.random() < self.sample_rate, attributes)
        return Span(self, name, parent, parent.trace_id,
                    parent.head_sampled, attributes)

    def start_span_under(self, parent_ctx, name: str, **attributes):
        """A span explicitly parented under a REMOTE context —
        ``parent_ctx`` is the ``(trace_id, span_id, sampled)`` tuple
        :func:`k8s_tpu_torch.trace.parse_traceparent` returns (the serving
        ingress's inbound W3C header, or a server span handed across
        threads to the engine).  ``None`` falls back to
        :meth:`start_span`, so call sites need no branching.

        The span joins the remote TRACE (same trace_id, parent_id = the
        remote span id) but is a local root: it finishes through the
        tail-based keep decision with the inbound sampled flag as its
        head-sampling vote, so a sampled upstream keeps the local
        subtree and an unsampled one still keeps slow/errored spans."""
        if parent_ctx is None:
            return self.start_span(name, **attributes)
        if not self.enabled:
            return NOOP_SPAN
        trace_id, parent_span_id, sampled = parent_ctx
        parent = _current_span.get()
        if parent is not None and parent is not NOOP_SPAN \
                and parent.trace_id == trace_id:
            # already inside the same trace (the handler thread's server
            # span): nest normally instead of forking a second root
            return Span(self, name, parent, trace_id,
                        parent.head_sampled, attributes)
        span = Span(self, name, None, trace_id, bool(sampled), attributes)
        span.parent_id = parent_span_id
        return span

    def record_span(self, name: str, duration_s: float, **attributes):
        """Record an already-elapsed interval ending now as a child of the
        current span (e.g. the workqueue wait that preceded a sync).
        Returns the span, or None when tracing is off / no span is
        current — a parentless retroactive interval is not a trace."""
        if not self.enabled:
            return None
        parent = _current_span.get()
        if parent is None or parent is NOOP_SPAN:
            return None
        span = Span(self, name, parent, parent.trace_id,
                    parent.head_sampled, attributes)
        span.start -= duration_s
        span.start_wall -= duration_s
        span.finish()
        return span

    def _finish_root(self, root: Span) -> None:
        """Tail-based keep decision: head-sampled, slow, or errored."""
        if (root.head_sampled
                or root.duration_s >= self.slow_threshold_s
                or root.has_error()):
            self.exporter.export(root)


def current_span():
    """The active span, or None (never the no-op span)."""
    span = _current_span.get()
    return None if span is None or span is NOOP_SPAN else span


def current_trace_id() -> Optional[str]:
    span = current_span()
    return span.trace_id if span is not None else None


def bind_current_context(fn):
    """Wrap ``fn`` so it runs under a *copy* of the calling context —
    the bridge that carries span parenting onto ThreadPoolExecutor tasks.
    Each call copies its own Context: one Context object cannot be entered
    by two tasks concurrently, so bind once per submitted task."""
    ctx = contextvars.copy_context()

    def _bound(*args, **kwargs):
        return ctx.run(fn, *args, **kwargs)

    return _bound
