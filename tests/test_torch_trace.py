"""The port's span-tracing package (``k8s_tpu_torch.trace``) against the
reference's ``k8s_tpu.trace``: traceparent parsing and formatting, head
sampling and keep-if-slow decisions under the same environment and random
state, ring-buffer eviction, the ``select_traces`` view and the
``/debug/traces`` bodies for the same buffered traces."""

from __future__ import annotations

import json
import random

import pytest

from k8s_tpu import trace as jtrace
from k8s_tpu_torch import trace as ttrace

HEADERS = [
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-00",
    "01-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-03",
    "  00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01  ",
    "ff-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-00000000000000000000000000000000-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-0000000000000000-01",
    "00-4BF92F3577B34DA6A3CE929D0E0E4736-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e473-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7",
    "garbage",
    "",
    None,
]


@pytest.mark.parametrize("header", HEADERS, ids=range(len(HEADERS)))
def test_parse_traceparent_is_the_references(header):
    assert ttrace.parse_traceparent(header) == \
        jtrace.parse_traceparent(header)


@pytest.mark.parametrize("sampled", [True, False])
def test_format_traceparent_is_the_references(sampled):
    tid, sid = "ab" * 16, "cd" * 8
    got = ttrace.format_traceparent(tid, sid, sampled)
    assert got == jtrace.format_traceparent(tid, sid, sampled)
    assert ttrace.parse_traceparent(got) == (tid, sid, sampled)


@pytest.mark.parametrize("sample,slow", [
    ("", ""), ("0.25", "40"), ("2", "-5"), ("-1", "x"), ("nope", "1000"),
])
def test_env_knobs_read_as_the_references(monkeypatch, sample, slow):
    monkeypatch.setenv("K8S_TPU_TRACE_SAMPLE", sample)
    monkeypatch.setenv("K8S_TPU_TRACE_SLOW_MS", slow)
    j, t = jtrace.Tracer(), ttrace.Tracer()
    assert (t.sample_rate, t.slow_threshold_s, t.enabled) == \
        (j.sample_rate, j.slow_threshold_s, j.enabled)
    # configure() re-reads the environment, and clamps an explicit rate
    j.configure(sample_rate=3.0), t.configure(sample_rate=3.0)
    assert t.sample_rate == j.sample_rate == 1.0


def _run(pkg, rate, slow_s, seed, error=False, sleep=False):
    """One root with a child and a retroactive span on a fresh tracer;
    returns the exporter's snapshot (kept or not) with timings dropped."""
    import time

    tracer = pkg.Tracer(sample_rate=rate, slow_threshold_s=slow_s,
                        exporter=pkg.RingBufferExporter(8))
    random.seed(seed)
    try:
        with tracer.start_span("root", job="ns/a") as root:
            tracer.record_span("queue_wait", 0.002, depth=3)
            with tracer.start_span("child", n=1) as child:
                child.add_event("mark", k="v")
                if sleep:
                    time.sleep(0.02)
                if error:
                    raise RuntimeError("boom")
    except RuntimeError:
        pass
    assert root.trace_id is not None
    return [_strip(t) for t in tracer.exporter.snapshot()]


def _strip(node: dict) -> dict:
    """A span dict without wall-clock fields."""
    out = {k: v for k, v in node.items()
           if k not in ("start_unix", "duration_ms")}
    out["events"] = [{k: v for k, v in e.items() if k != "offset_ms"}
                     for e in node["events"]]
    out["children"] = [_strip(c) for c in node["children"]]
    return out


@pytest.mark.parametrize("rate,slow_s,error,sleep", [
    (1.0, 10.0, False, False),   # head-sampled: kept
    (1e-12, 10.0, False, False),  # not sampled, fast, ok: dropped
    (1e-12, 0.01, False, True),  # not sampled but slow: kept
    (1e-12, 10.0, True, False),  # not sampled but errored: kept
    (0.5, 10.0, False, False),   # the coin decides, from the same draw
])
def test_keep_decisions_and_ids_are_the_references(rate, slow_s, error,
                                                   sleep):
    for seed in range(4):
        j = _run(jtrace, rate, slow_s, seed, error, sleep)
        t = _run(ttrace, rate, slow_s, seed, error, sleep)
        # the same random state draws the same ids and the same coin
        assert t == j


def test_tracing_off_is_the_shared_noop():
    t = ttrace.Tracer(sample_rate=0.0)
    sp = t.start_span("x", a=1)
    assert sp is ttrace.NOOP_SPAN and t.record_span("y", 0.1) is None
    assert t.start_span_under(("a" * 32, "b" * 16, True), "z") \
        is ttrace.NOOP_SPAN
    assert ttrace.span_context(sp) is None and ttrace.span_context(None) \
        is None


@pytest.mark.parametrize("sampled", [True, False])
def test_span_under_joins_and_nests_as_the_references(sampled):
    ctx = ("1" * 32, "2" * 16, sampled)
    trees = []
    for pkg in (jtrace, ttrace):
        tracer = pkg.Tracer(sample_rate=1.0, slow_threshold_s=100.0,
                            exporter=pkg.RingBufferExporter(4))
        random.seed(11)
        with tracer.start_span_under(ctx, "serve_request", max_new=3) as s:
            # the handler thread's own span: nests, no second root
            with tracer.start_span_under(ctx, "inner"):
                pass
            handoff = pkg.span_context(s)
        with tracer.start_span_under(handoff, "prefill", chunks=2):
            pass
        with tracer.start_span_under(None, "decode_step", active=1):
            pass
        trees.append([_strip(t) for t in tracer.exporter.snapshot()])
    assert trees[1] == trees[0]
    roots = {t["name"]: t for t in trees[1]}
    # the inbound flag is the joined roots' head-sampling vote; a fresh
    # root (decode_step) draws its own
    assert "decode_step" in roots
    assert ("serve_request" in roots) == ("prefill" in roots) == sampled
    if sampled:
        srv = roots["serve_request"]
        assert srv["parent_id"] == "2" * 16
        assert [c["name"] for c in srv["children"]] == ["inner"]
        assert roots["prefill"]["trace_id"] == "1" * 32
        assert roots["prefill"]["parent_id"] == srv["span_id"]


def test_ring_eviction_is_the_references():
    exps = (jtrace.RingBufferExporter(3), ttrace.RingBufferExporter(3))
    for i in range(5):
        for e in exps:
            e.export({"name": f"t{i}", "duration_ms": float(i),
                      "attributes": {}})
    assert exps[1].snapshot() == exps[0].snapshot()
    assert [t["name"] for t in exps[1].snapshot()] == ["t2", "t3", "t4"]
    assert exps[1].stats() == exps[0].stats() == {
        "buffered": 3, "capacity": 3, "exported_total": 5,
        "evicted_total": 2}
    for e in exps:
        e.clear()
    assert exps[1].stats() == exps[0].stats()
    for pkg in (jtrace, ttrace):
        with pytest.raises(ValueError, match="capacity"):
            pkg.RingBufferExporter(0)


TRACES = [
    {"name": "a", "duration_ms": 3.0, "attributes": {"job": "ns/alpha"}},
    {"name": "b", "duration_ms": 9.5, "attributes": {"job": "ns/beta"}},
    {"name": "c", "duration_ms": 1.0, "attributes": {}},
    {"name": "d", "duration_ms": 9.5, "attributes": {"job": "ns/alpha"}},
    {"name": "e"},
]


@pytest.mark.parametrize("limit,job", [
    (50, None), (2, None), (0, None), (-1, None), (50, "alpha"),
    (1, "ns/alpha"), (50, "gamma"),
])
def test_select_traces_is_the_references(limit, job):
    assert ttrace.select_traces(list(TRACES), limit=limit, job=job) == \
        jtrace.select_traces(list(TRACES), limit=limit, job=job)


@pytest.mark.parametrize("query", ["", "n=2", "n=x", "job=alpha",
                                   "n=1&job=beta"])
def test_debug_traces_response_is_the_references(query):
    bodies = []
    for pkg in (jtrace, ttrace):
        tracer = pkg.Tracer(sample_rate=0.5, slow_threshold_s=0.123,
                            exporter=pkg.RingBufferExporter(4))
        for t in TRACES:
            tracer.exporter.export(dict(t))
        bodies.append(pkg.debug_traces_response(tracer, query))
    assert bodies[1] == bodies[0]
    code, body, ctype = bodies[1]
    assert code == 200 and ctype == "application/json"
    assert json.loads(body)["exporter"]["evicted_total"] == 1


def test_debug_traces_disabled_is_the_references_404():
    got = [pkg.debug_traces_response(pkg.Tracer(sample_rate=0.0), "")
           for pkg in (jtrace, ttrace)]
    assert got[1] == got[0] and got[1][0] == 404


def test_module_api_on_the_global_tracer():
    old = (ttrace.TRACER.sample_rate, ttrace.TRACER.slow_threshold_s)
    ttrace.configure(sample_rate=1.0, slow_threshold_s=100.0,
                     exporter=ttrace.RingBufferExporter(4))
    try:
        assert ttrace.enabled()
        with ttrace.span("root", job="x") as sp:
            tp = ttrace.current_traceparent()
            assert ttrace.parse_traceparent(tp) == (sp.trace_id, sp.span_id,
                                                    sp.head_sampled)
            assert ttrace.record_span("waited", 0.001) is not None
            bound = ttrace.bind_current_context(ttrace.current_trace_id)
        assert bound() == sp.trace_id and ttrace.current_span() is None
        (got,) = ttrace.debug_traces(job="x")
        assert [c["name"] for c in got["children"]] == ["waited"]
    finally:
        ttrace.configure(sample_rate=old[0], slow_threshold_s=old[1],
                         exporter=ttrace.RingBufferExporter())
