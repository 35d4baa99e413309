"""Span tracing for the port's serving path: the port's own copy of the
stdlib package ``k8s_tpu/trace`` (same names, same behaviour, same
``/debug/traces`` body).

Module-level convenience API over one process-wide :class:`Tracer`:

    from k8s_tpu_torch import trace

    with trace.span_under(inbound, "serve_request", prompt_len=n) as sp:
        ctx = trace.span_context(sp) or inbound   # hand to another thread
        ...

Sampling knobs (read at import; ``trace.configure()`` re-reads):

- ``K8S_TPU_TRACE_SAMPLE``: head sample rate in [0, 1]; 0/unset = off.
- ``K8S_TPU_TRACE_SLOW_MS``: tail keep-if-slow threshold (default 250);
  slow or errored traces are always kept once tracing is on.

Stdlib only.
"""

from __future__ import annotations

from typing import Optional

from k8s_tpu_torch.trace.export import (  # noqa: F401 (public surface)
    RingBufferExporter,
    debug_traces_response,
    select_traces,
)
from k8s_tpu_torch.trace.propagation import (  # noqa: F401
    format_traceparent,
    parse_traceparent,
)
from k8s_tpu_torch.trace.tracer import (  # noqa: F401
    NOOP_SPAN,
    Span,
    Tracer,
    bind_current_context,
    current_span,
    current_trace_id,
)

# The process-wide tracer every instrumentation site records through
# (binaries inherit env config; tests call configure()).
TRACER = Tracer()


def configure(sample_rate: Optional[float] = None,
              slow_threshold_s: Optional[float] = None,
              exporter=None) -> Tracer:
    """Reconfigure the global tracer; None args re-read the environment."""
    return TRACER.configure(sample_rate=sample_rate,
                            slow_threshold_s=slow_threshold_s,
                            exporter=exporter)


def enabled() -> bool:
    return TRACER.enabled


def span(name: str, **attributes):
    """Start a span on the global tracer (context manager)."""
    return TRACER.start_span(name, **attributes)


def record_span(name: str, duration_s: float, **attributes):
    """Retroactive child of the current span (interval ending now)."""
    return TRACER.record_span(name, duration_s, **attributes)


def span_under(parent_ctx, name: str, **attributes):
    """A span under an explicit remote ``(trace_id, span_id, sampled)``
    context (the :func:`parse_traceparent` shape): how the serving
    ingress parents the engine's prefill/decode/exclusive spans under an
    inbound W3C ``traceparent`` across threads and processes.  ``None``
    falls back to :func:`span`."""
    return TRACER.start_span_under(parent_ctx, name, **attributes)


def span_context(span) -> Optional[tuple]:
    """The ``(trace_id, span_id, sampled)`` tuple of a live span, or
    None for a no-op/absent span: the hand-off shape for parenting work
    on another thread under it."""
    if span is None or getattr(span, "trace_id", None) is None:
        return None
    return span.trace_id, span.span_id, span.head_sampled


def current_traceparent() -> Optional[str]:
    """W3C traceparent for the current span, or None."""
    sp = current_span()
    if sp is None:
        return None
    return format_traceparent(sp.trace_id, sp.span_id, sp.head_sampled)


def debug_traces(limit: int = 50, job: Optional[str] = None) -> list[dict]:
    """Buffered traces, slowest-first (the /debug/traces view)."""
    return select_traces(TRACER.exporter.snapshot(), limit=limit, job=job)
