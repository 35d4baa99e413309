"""Span tracing on the serving path: the JAX server and the port's
``LmServer`` (tiny, CPU, the same parameters) take the same requests with
the same W3C ``traceparent``, and their span trees must match: names,
parent names and every attribute that is not a timing.

Lanes: single-flight, the engine (greedy), the batched speculative lane,
the exclusive lane (a sampled request with batch sampling off), and a
disaggregated migration with a ``kv_src`` fetch: ``kv_migrate`` and
``kv_fetch`` spans, the ``trace_id`` on the migrate frame and in the
decode pod's request recorder.  With tracing off there are no spans, and
the recorder still keeps the inbound trace id."""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import pytest
import torch

from k8s_tpu import trace as jtrace
from k8s_tpu.models import requestlog as jax_requestlog
from k8s_tpu.models import server as jax_server
from k8s_tpu.models.transformer import Transformer as JaxTransformer
from k8s_tpu.models.transformer import TransformerConfig as JaxConfig
from k8s_tpu.util.metrics import Registry as JaxRegistry
from k8s_tpu_torch import trace as ttrace
from k8s_tpu_torch.models import bridge, requestlog
from k8s_tpu_torch.models import server as server_mod
from k8s_tpu_torch.models.transformer import TransformerConfig
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

SHAPE = dict(vocab_size=256, hidden=32, ffn_hidden=64, layers=2, heads=4,
             kv_heads=2, max_seq_len=128, remat=False)
WAIT = 60
TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"
PARENT = "00f067aa0ba902b7"
TRACEPARENT = f"00-{TRACE_ID}-{PARENT}-01"


@pytest.fixture(scope="module")
def model():
    cj = JaxConfig(dtype=jnp.float32, **SHAPE)
    ct = TransformerConfig(dtype=torch.float32, **SHAPE)
    params = JaxTransformer(cj).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 5), jnp.int32))["params"]
    return cj, ct, params, bridge.params_from_jax(jax.device_get(params))


@pytest.fixture(scope="module")
def stacks(model):
    """Each package's servers, built under request recorders of the
    test module's own: single-flight, an engine with batch sampling off
    (a sampled request takes the exclusive lane), and a prefill/decode
    pair over loopback kv-transfer."""
    cj, ct, params, sd = model
    jrec, trec = jax_requestlog.RequestRecorder(), requestlog.RequestRecorder()
    jax_requestlog.set_active(jrec)
    requestlog.set_active(trec)
    made = []

    def jax_lm(**kw):
        lm = jax_server.LmServer(config=cj, params=params,
                                 registry=JaxRegistry(), **kw)
        h = jax_server.serve(lm)
        made.append((h, lm))
        return lm, "http://%s:%d" % h.server_address[:2]

    def port_lm(**kw):
        lm = server_mod.LmServer(config=ct, params=sd, device="cpu", **kw)
        h = server_mod.serve(lm)
        made.append((h, lm))
        return lm, "http://%s:%d" % h.server_address[:2]

    out = {}
    try:
        for name, build in (("jax", jax_lm), ("port", port_lm)):
            dec, durl = build(slots=2, role="decode")
            out[name] = {
                "single": build(slots=0)[1],
                "engine": build(slots=2, batch_sampling=False)[1],
                "prefill": build(slots=2, role="prefill"),
                "decode": (dec, durl),
                "dest": f"127.0.0.1:{dec.serving_info()['kvxfer_port']}",
                "recorder": jrec if name == "jax" else trec,
            }
        yield out
    finally:
        for h, lm in made:
            h.shutdown()
            h.server_close()
            lm.close()
        jax_requestlog.set_active(None)
        requestlog.set_active(None)


@pytest.fixture()
def tracing():
    """Both packages' global tracers on (every root kept), each with a
    fresh ring; off again after the test."""
    exps = {"jax": jtrace.RingBufferExporter(1024),
            "port": ttrace.RingBufferExporter(1024)}
    jtrace.configure(sample_rate=1.0, slow_threshold_s=1e9,
                     exporter=exps["jax"])
    ttrace.configure(sample_rate=1.0, slow_threshold_s=1e9,
                     exporter=exps["port"])
    yield exps
    for pkg in (jtrace, ttrace):
        pkg.configure(sample_rate=0.0, exporter=pkg.RingBufferExporter())


def post(url, body, traceparent=TRACEPARENT):
    headers = {"Content-Type": "application/json"}
    if traceparent:
        headers["traceparent"] = traceparent
    req = urllib.request.Request(url + "/v1/generate",
                                 data=json.dumps(body).encode(),
                                 headers=headers, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get(url, path):
    try:
        with urllib.request.urlopen(url + path, timeout=WAIT) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _walk(node):
    yield node
    for c in node["children"]:
        yield from _walk(c)


def _attrs(span, dests):
    # kv_dest / kv_src name each package's own receiver port
    return {k: dests.get(v, v) if isinstance(v, str) else v
            for k, v in span["attributes"].items()}


def span_tree(exporter, dests=None) -> dict:
    """The trace's spans as sorted ``(name, parent name, attributes)``
    rows, and the attributes of every ``decode_step`` span (each its own
    root, as in the reference's engine)."""
    dests = dests or {}
    spans = [s for t in exporter.snapshot() for s in _walk(t)]
    names = {s["span_id"]: s["name"] for s in spans}
    names[PARENT] = "<inbound>"
    rows = sorted(
        (s["name"], names.get(s["parent_id"], "<missing>"),
         json.dumps(_attrs(s, dests), sort_keys=True))
        for s in spans if s["trace_id"] == TRACE_ID)
    steps = sorted(json.dumps(s["attributes"], sort_keys=True)
                   for s in spans if s["name"] == "decode_step")
    return {"trace": rows, "decode_steps": steps}


LANES = {
    "single_flight": ("single", {"tokens": [3, 5, 7, 11],
                                 "max_new_tokens": 5}),
    "engine": ("engine", {"tokens": list(range(1, 40)),
                          "max_new_tokens": 8}),
    "spec_lane": ("engine", {"tokens": [4, 5, 6, 4, 5, 6, 4, 5, 6, 4],
                             "max_new_tokens": 7, "speculative": 3}),
    "exclusive": ("engine", {"tokens": [9, 8, 7, 6], "max_new_tokens": 6,
                             "temperature": 0.9, "seed": 3}),
}


@pytest.mark.parametrize("lane", list(LANES))
def test_span_trees_are_the_references(stacks, tracing, lane):
    which, body = LANES[lane]
    got = {}
    for name in ("jax", "port"):
        code, out = post(stacks[name][which], body)
        assert code == 200, out
        got[name] = span_tree(tracing[name])
        if not body.get("temperature"):
            # a sampled request draws from each package's own generator
            got[name]["tokens"] = out
    assert got["port"] == got["jax"]
    rows = got["port"]["trace"]
    assert any(r[:2] == ("serve_request", "<inbound>") for r in rows)
    engine_span = {"single_flight": None, "engine": "prefill",
                   "spec_lane": "prefill",
                   "exclusive": "exclusive_generate"}[lane]
    if engine_span:
        assert any(r[:2] == (engine_span, "serve_request") for r in rows)
        assert got["port"]["decode_steps"] or lane == "exclusive"
    else:
        assert len(rows) == 1 and not got["port"]["decode_steps"]
    if lane == "spec_lane":
        assert any('"spec": 1' in s for s in got["port"]["decode_steps"])


def test_disagg_migration_and_fetch_spans(stacks, tracing, monkeypatch):
    frames = []
    port_pre = stacks["port"]["prefill"][0]
    migrate = port_pre._kv_sender.migrate

    def spy(dest, statics, *a, **kw):
        frames.append(dict(statics))
        return migrate(dest, statics, *a, **kw)
    monkeypatch.setattr(port_pre._kv_sender, "migrate", spy)
    body = {"tokens": [(i * 7 + 3) % 256 for i in range(30)],
            "max_new_tokens": 6}
    fetch = {"tokens": [(i * 5 + 1) % 256 for i in range(40)],
             "max_new_tokens": 2}
    got = {}
    for name in ("jax", "port"):
        st = stacks[name]
        purl = st["prefill"][1]
        code, out = post(purl, {**body, "kv_dest": st["dest"]})
        assert code == 200, out
        code, out2 = post(purl, {**fetch, "kv_src": st["dest"]})
        assert code == 200, out2
        got[name] = span_tree(tracing[name], {st["dest"]: "<decode pod>"})
        got[name]["tokens"] = (out, out2)
        # the decode pod's recorder has the migrated request under the
        # caller's trace id, carried by the migrate frame
        recs = [r for r in st["recorder"].snapshot()
                if r.get("trace_id") == TRACE_ID]
        got[name]["recorded_kinds"] = sorted(r["kind"] for r in recs)
    assert got["port"] == got["jax"]
    names = {r[0] for r in got["port"]["trace"]}
    assert {"serve_request", "prefill", "kv_migrate", "kv_fetch"} <= names
    assert [f["trace_id"] for f in frames] == [TRACE_ID]
    assert len(got["port"]["recorded_kinds"]) >= 3


def test_tracing_off_keeps_the_trace_id_in_the_recorder(stacks):
    for pkg in (jtrace, ttrace):
        pkg.configure(sample_rate=0.0, exporter=pkg.RingBufferExporter(8))
    body = {"tokens": [21, 22, 23, 24, 25], "max_new_tokens": 4}
    for name, pkg in (("jax", jtrace), ("port", ttrace)):
        url = stacks[name]["engine"]
        assert post(url, body)[0] == 200
        assert pkg.TRACER.exporter.snapshot() == []
        code, text = get(url, "/debug/traces")
        assert code == 404 and "tracing disabled" in text
        last = stacks[name]["recorder"].snapshot()[-1]
        assert last["trace_id"] == TRACE_ID and last["prompt_len"] == 5


def test_debug_traces_serves_the_tree(stacks, tracing):
    url = stacks["port"]["engine"]
    assert post(url, {"tokens": [1, 2, 3], "max_new_tokens": 3})[0] == 200
    code, text = get(url, "/debug/traces?n=500")
    assert code == 200
    body = json.loads(text)
    assert body["sample_rate"] == 1.0 and body["count"] >= 2
    mine = [t for t in body["traces"] if t["trace_id"] == TRACE_ID]
    assert {t["name"] for t in mine} == {"serve_request", "prefill"}
    code, text = get(url, "/debug")
    entry = {e["path"]: e for e in json.loads(text)["endpoints"]}
    assert entry["/debug/traces"]["active"]
