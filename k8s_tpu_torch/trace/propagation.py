"""W3C trace-context propagation (https://www.w3.org/TR/trace-context/):
the port's own copy of ``k8s_tpu/trace/propagation.py``.

Only the ``traceparent`` header is implemented — the piece that lets an
apiserver audit log line or kubelet log be joined back to the operator
span that caused it.  ``tracestate`` is deliberately omitted (nothing in
this control plane consumes it).
"""

from __future__ import annotations

import re
from typing import Optional

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


def format_traceparent(trace_id: str, span_id: str,
                       sampled: bool = True) -> str:
    """``00-<trace-id>-<parent-span-id>-<flags>`` (version 00)."""
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


def parse_traceparent(header: Optional[str]):
    """(trace_id, span_id, sampled) or None for anything malformed.

    Per spec: version ff is invalid, as are all-zero trace/span ids.
    Uppercase hex is rejected (the spec requires lowercase on the wire).
    """
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip())
    if m is None:
        return None
    version, trace_id, span_id, flags = m.groups()
    if version == "ff":
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id, bool(int(flags, 16) & 0x01)
