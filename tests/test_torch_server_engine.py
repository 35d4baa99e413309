"""The port's HTTP server in its default mode, the continuous-batching
engine (``LmServer(slots=2, device="cpu")``), against the JAX server's
engine on the same parameters, in-process on the CPU over real sockets:
greedy tokens (grouped-query attention included), 503 with
``Retry-After`` on a full queue, ``/healthz``
503 after an engine crash, the ``/debug`` endpoints with the reference's
keys, and the refusals of later slices."""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import pytest
import torch

from k8s_tpu.models import requestlog as jax_requestlog
from k8s_tpu.models.server import LmServer as JaxLmServer
from k8s_tpu.models.server import serve as jax_serve
from k8s_tpu.models.transformer import Transformer as JaxTransformer
from k8s_tpu.models.transformer import TransformerConfig as JaxConfig
from k8s_tpu.util.metrics import Registry as JaxRegistry
from k8s_tpu_torch import trace
from k8s_tpu_torch.models import bridge, requestlog, serving
from k8s_tpu_torch.models.server import LmServer, serve
from k8s_tpu_torch.models.transformer import TransformerConfig
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = dict(vocab_size=256, hidden=32, ffn_hidden=64, layers=2, heads=4,
             kv_heads=4, max_seq_len=128, remat=False)
WAIT = 60


@pytest.fixture(scope="module")
def model():
    cj = JaxConfig(dtype=jnp.float32, **SHAPE)
    ct = TransformerConfig(dtype=torch.float32, **SHAPE)
    params = JaxTransformer(cj).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 5), jnp.int32))["params"]
    return cj, ct, params, bridge.params_from_jax(jax.device_get(params))


@pytest.fixture(scope="module")
def servers(model):
    """Both packages' servers with two engine slots."""
    cj, ct, params, sd = model
    jlm = JaxLmServer(config=cj, params=params, slots=2,
                      registry=JaxRegistry())
    tlm = LmServer(config=ct, params=sd, slots=2, device="cpu")
    jh, th = jax_serve(jlm), serve(tlm)
    yield ("http://%s:%d" % jh.server_address[:2],
           "http://%s:%d" % th.server_address[:2], tlm)
    for h, lm in ((jh, jlm), (th, tlm)):
        h.shutdown()
        h.server_close()
        lm.close()


@pytest.fixture()
def own_server(model):
    """A port server of the test's own, closed after it."""
    made = []

    def build(**kw):
        _, ct, _, sd = model
        lm = LmServer(config=ct, params=sd, device="cpu", **kw)
        httpd = serve(lm)
        made.append((httpd, lm))
        return lm, "http://%s:%d" % httpd.server_address[:2]
    yield build
    for httpd, lm in made:
        httpd.shutdown()
        httpd.server_close()
        lm.close()


def _post(url, payload, timeout=WAIT):
    req = urllib.request.Request(
        url + "/v1/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def _get(url, path):
    try:
        with urllib.request.urlopen(url + path, timeout=WAIT) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.mark.parametrize("payload", [
    {"tokens": [3, 5, 7], "max_new_tokens": 8},
    {"tokens": [9] * 20, "max_new_tokens": 5},
    {"text": "the cat", "max_new_tokens": 6},
    {"tokens": list(range(1, 40)), "max_new_tokens": 12},
], ids=["tokens", "long", "text", "blocks"])
def test_same_greedy_answer_as_jax_engine(servers, payload):
    jurl, turl, _ = servers
    jcode, jbody, _ = _post(jurl, payload)
    tcode, tbody, _ = _post(turl, payload)
    assert jcode == tcode == 200
    assert tbody == jbody


def test_concurrent_requests_and_prefix_hit(servers):
    jurl, turl, lm = servers
    payloads = [{"tokens": [(7 * i + j) % 256 for j in range(5 + 3 * i)],
                 "max_new_tokens": 6} for i in range(5)]
    got = [None] * len(payloads)

    def run(i):
        got[i] = _post(turl, payloads[i])[:2]
    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    for p, g in zip(payloads, got):
        assert g == _post(jurl, p)[:2]
    hits = lm.engine.stats()["prefix_hits"]
    again = _post(turl, payloads[-1])[:2]
    assert again == got[-1] and lm.engine.stats()["prefix_hits"] == hits + 1
    lm.engine.debug_check_blocks()


def test_eos_is_stripped_like_jax_server(servers):
    jurl, turl, _ = servers
    first = _post(turl, {"tokens": [3, 5, 7], "max_new_tokens": 1})[1]
    payload = {"tokens": [3, 5, 7], "max_new_tokens": 6,
               "eos": first["tokens"][0]}
    assert _post(turl, payload)[:2] == _post(jurl, payload)[:2] == \
        (200, {"tokens": []})


def test_sampled_request_same_on_either_lane(own_server):
    payload = {"tokens": [1, 2, 3, 4], "max_new_tokens": 8,
               "temperature": 0.8, "top_k": 50, "seed": 7}
    batched, burl = own_server(slots=2)
    exclusive, xurl = own_server(slots=2, batch_sampling=False)
    a, b = _post(burl, payload)[:2], _post(xurl, payload)[:2]
    assert a[0] == 200 and a == b and len(a[1]["tokens"]) == 8
    assert batched.metrics["sampled_batched"].value == 1
    assert exclusive.engine.stats()["completed"] == 1
    assert exclusive.engine.stats()["steps"] == 0  # never rode a slot


def test_speculative_still_400(servers):
    """Speculative requests are served now (tests/test_torch_engine_spec.py);
    a bad draft_k still answers 400 naming the field, as the JAX
    server's does."""
    jurl, turl, _ = servers
    for payload in ({"tokens": [1, 2], "speculative": 1,
                     "max_new_tokens": 4},
                    {"tokens": [1, 2], "speculative": -3,
                     "max_new_tokens": 4}):
        code, body, _ = _post(turl, payload)
        assert code == 400 and body["field"] == "speculative"
        assert _post(jurl, payload)[:2] == (code, body)
    code, body, _ = _post(turl, {"tokens": [1, 2, 1, 2], "speculative": 4,
                                 "max_new_tokens": 4})
    assert code == 200 and len(body["tokens"]) == 4


def test_gqa_same_greedy_answer_as_jax_engine(model):
    """kv_heads 2 under heads 4 (the served model has 32 over 8): both
    packages' engine servers give the same greedy answers, concurrent
    requests and a prefix hit included."""
    cj, ct = (dataclasses.replace(c, kv_heads=2) for c in model[:2])
    params = JaxTransformer(cj).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 5), jnp.int32))["params"]
    jlm = JaxLmServer(config=cj, params=params, slots=2,
                      registry=JaxRegistry())
    tlm = LmServer(config=ct, params=bridge.params_from_jax(
        jax.device_get(params)), slots=2, device="cpu")
    jh, th = jax_serve(jlm), serve(tlm)
    jurl, turl = ("http://%s:%d" % h.server_address[:2] for h in (jh, th))
    try:
        payloads = [{"tokens": [(7 * i + j) % 256 for j in range(5 + 9 * i)],
                     "max_new_tokens": 6} for i in range(4)]
        payloads.append({"text": "the cat", "max_new_tokens": 6})
        got = [None] * len(payloads)

        def run(i):
            got[i] = _post(turl, payloads[i])[:2]
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(payloads))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        for p, g in zip(payloads, got):
            assert g[0] == 200 and g == _post(jurl, p)[:2]
        assert _post(turl, payloads[3])[:2] == got[3]
        assert tlm.engine.stats()["prefix_hits"] >= 1
        tlm.engine.debug_check_blocks()
    finally:
        for h, lm in ((jh, jlm), (th, tlm)):
            h.shutdown()
            h.server_close()
            lm.close()


def test_full_queue_answers_503_with_retry_after(own_server):
    lm, url = own_server(slots=1, queue_limit=1)
    release, started = threading.Event(), threading.Event()

    def blocker():
        started.set()
        release.wait(WAIT)
        return [0]
    park = threading.Thread(target=lambda: lm.engine.submit_exclusive(
        blocker, timeout=WAIT), daemon=True)
    park.start()
    try:
        assert started.wait(WAIT)
        queued = threading.Thread(target=lambda: _post(
            url, {"tokens": [1, 2], "max_new_tokens": 2}), daemon=True)
        queued.start()
        deadline = time.monotonic() + WAIT
        while lm.engine.queue_depth() < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        code, body, headers = _post(url, {"tokens": [3], "max_new_tokens": 2})
        assert code == 503 and "queue full" in body["error"]
        assert int(headers["Retry-After"]) >= 1
        # shedding is not unreadiness
        assert _get(url, "/healthz")[0] == 200
        assert "serve_rejected_total 1" in _get(url, "/metrics")[1]
    finally:
        release.set()
    park.join(WAIT)
    queued.join(WAIT)


def test_healthz_503_after_engine_crash(own_server):
    lm, url = own_server(slots=1)
    assert _get(url, "/healthz")[0] == 200

    def boom(*a, **k):
        raise RuntimeError("synthetic device failure")
    lm.engine._step_fn = boom
    code, _, _ = _post(url, {"tokens": [1, 2, 3], "max_new_tokens": 4})
    assert code == 500
    code, body = _get(url, "/healthz")
    assert code == 503 and json.loads(body)["status"] == "engine crashed"


def test_healthz_reports_the_engine(servers):
    jurl, turl, _ = servers
    jinfo = json.loads(_get(jurl, "/healthz")[1])["serving"]
    code, body = _get(turl, "/healthz")
    info = json.loads(body)["serving"]
    assert code == 200 and info["engine"] == "continuous-batching"
    assert info["slots"] == 2 and info["paged"] and info["block_size"] == 16
    assert set(info) - {"device"} <= set(jinfo)
    for key in ("slots", "queue_limit", "paged", "block_size",
                "pool_blocks", "batch_sampling", "request_log"):
        assert info[key] == jinfo[key], key


def test_debug_endpoints_have_the_references_keys(model, monkeypatch):
    """Each package's server built under its own request recorder."""
    cj, ct, params, sd = model
    monkeypatch.setenv("K8S_TPU_REQUEST_LOG", "1")
    jax_requestlog.set_active(None)
    requestlog.set_active(None)
    jlm = JaxLmServer(config=cj, params=params, slots=2,
                      registry=JaxRegistry())
    tlm = LmServer(config=ct, params=sd, slots=2, device="cpu")
    jh, th = jax_serve(jlm), serve(tlm)
    jurl, turl = ("http://%s:%d" % h.server_address[:2] for h in (jh, th))
    try:
        for url in (jurl, turl):
            assert _post(url, {"tokens": [5, 6, 7], "max_new_tokens": 3}
                         )[0] == 200
        got = {}
        for path in ("/debug/requests", "/debug/engine?n=4"):
            (jc, jb), (tc, tb) = _get(jurl, path), _get(turl, path)
            assert jc == tc == 200, path
            got[path] = json.loads(jb), json.loads(tb)
            assert set(got[path][1]) == set(got[path][0]), path
        j, t = got["/debug/requests"]
        assert set(t["requests"][-1]) == set(j["requests"][-1])
        assert t["requests"][-1]["ttft_s"] is not None
        assert t["requests"][-1]["retire"] == "max_tokens"
        j, t = got["/debug/engine?n=4"]
        assert set(t["rollup"]) == set(j["rollup"])
        assert set(t["steps"][-1]) == set(j["steps"][-1])
    finally:
        for h, lm in ((jh, jlm), (th, tlm)):
            h.shutdown()
            h.server_close()
            lm.close()
        jax_requestlog.set_active(None)
        requestlog.set_active(None)


def test_debug_index_and_missing_slices(servers):
    _, turl, _ = servers
    code, body = _get(turl, "/debug")
    paths = {e["path"]: e for e in json.loads(body)["endpoints"]}
    assert code == 200
    assert set(paths) >= {"/debug/requests", "/debug/engine",
                          "/debug/traces"}
    code, body = _get(turl, "/debug/compiles")
    assert code == 404 and "no counterpart" in body
    assert not paths["/debug/compiles"]["active"]
    # span tracing is ported: the index marks it active once it is on,
    # and /debug/traces answers with the engine's spans
    trace.configure(sample_rate=1.0, exporter=trace.RingBufferExporter(64))
    try:
        _post(turl, {"tokens": [8, 9], "max_new_tokens": 3})
        code, body = _get(turl, "/debug/traces")
        assert code == 200
        names = {t["name"] for t in json.loads(body)["traces"]}
        assert {"serve_request", "prefill", "decode_step"} <= names
        paths = {e["path"]: e for e in
                 json.loads(_get(turl, "/debug")[1])["endpoints"]}
        assert paths["/debug/traces"]["active"]
    finally:
        trace.configure(sample_rate=0.0,
                        exporter=trace.RingBufferExporter())


def test_metrics_carry_the_engine_families(servers):
    _, turl, _ = servers
    _post(turl, {"tokens": [8, 9], "max_new_tokens": 3})
    text = _get(turl, "/metrics")[1]
    for name in ("serve_batch_occupancy", "serve_prefix_hits_total",
                 "serve_prefill_tokens_saved_total",
                 "serve_sampled_batched_total", "serve_kv_blocks_in_use",
                 "serve_ttft_seconds_count", "serve_tpot_seconds_count",
                 "serve_queue_wait_seconds_count",
                 "serve_step_duration_seconds_count",
                 "serve_prefill_convoy_total", "serve_rejected_total"):
        assert name in text, name


@pytest.mark.parametrize("env,match", [
    ({"K8S_TPU_SERVE_ROLE": "prefill"}, ("role", "prefill")),
    ({"K8S_TPU_SERVE_MESH": "2"}, ("placement", "local")),
    ({"K8S_TPU_SERVE_SPILL_MB": "64"}, ("spill_enabled", True)),
], ids=["role", "mesh", "spill"])
def test_later_slices_refused_by_name(model, monkeypatch, env, match):
    """The role, spill and mesh knobs are all ported: the server
    constructs and reports them in /healthz.  ``K8S_TPU_SERVE_MESH`` is
    read by the server's entry point (``main`` routes the gang there); an
    ``LmServer`` built in process without a placement serves locally."""
    _, ct, _, sd = model
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if isinstance(match, str):
        with pytest.raises(NotImplementedError, match=match):
            LmServer(config=ct, params=sd, device="cpu")
        return
    lm = LmServer(config=ct, params=sd, device="cpu")
    httpd = serve(lm)
    try:
        url = "http://%s:%d" % httpd.server_address[:2]
        info = json.loads(_get(url, "/healthz")[1])["serving"]
        assert info[match[0]] == match[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        lm.close()


def test_slots_default_from_env(model, monkeypatch):
    _, ct, _, sd = model
    monkeypatch.setenv("K8S_TPU_SERVE_SLOTS", "3")
    lm = LmServer(config=ct, params=sd, device="cpu")
    try:
        assert lm.serving_info()["slots"] == 3
        assert lm.model is lm.engine.model  # the exclusive lane's model
    finally:
        lm.close()
    monkeypatch.setenv("K8S_TPU_SERVE_SLOTS", "0")
    lm = LmServer(config=ct, params=sd, device="cpu")
    try:
        assert lm.engine is None
        assert lm.serving_info()["engine"] == "single-flight"
    finally:
        lm.close()


def test_cli_defaults_to_the_engine(model, tmp_path):
    _, ct, _, sd = model
    serving.export_serving(str(tmp_path), ct, sd)
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("K8S_TPU_SERVE_SLOTS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_tpu_torch.models.server",
         f"--train_dir={tmp_path}", "--port=0", "--max_new_tokens=4",
         "--queue=5", "--prefix-blocks=0", "--device=cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines: queue.Queue = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line)
    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    try:
        url = None
        while url is None:
            line = lines.get(timeout=120)
            if line.startswith("READY "):
                url = line.split()[1]
        code, body, _ = _post(url, {"tokens": [3, 5, 7]})
        assert code == 200 and len(body["tokens"]) == 4
        info = json.loads(_get(url, "/healthz")[1])["serving"]
        assert info["engine"] == "continuous-batching"
        assert (info["slots"], info["queue_limit"]) == (4, 5)
        assert info["pool_blocks"] == 1 + 4 * 8  # no prefix blocks
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        reader.join(30)
        proc.stdout.close()
