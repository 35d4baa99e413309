"""The port's single-flight HTTP server (k8s_tpu_torch/models/server.py)
against the JAX server's single-flight lane, in-process on the CPU over
real sockets, plus the port's serving artifacts and CLI."""

from __future__ import annotations

import json
import os
import queue
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import pytest
import torch

from k8s_tpu.models import serving as jax_serving
from k8s_tpu.models.server import LmServer as JaxLmServer
from k8s_tpu.models.server import serve as jax_serve
from k8s_tpu.models.transformer import Transformer as JaxTransformer
from k8s_tpu.models.transformer import TransformerConfig as JaxConfig
from k8s_tpu.util.metrics import Registry as JaxRegistry
from k8s_tpu_torch import trace
from k8s_tpu_torch.models import bridge, serving
from k8s_tpu_torch.models.server import LmServer, parse_request, serve
from k8s_tpu_torch.models.transformer import TransformerConfig
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = dict(vocab_size=256, hidden=32, ffn_hidden=64, layers=2, heads=4,
             kv_heads=4, max_seq_len=128, remat=False)


@pytest.fixture(scope="module")
def model():
    cj = JaxConfig(dtype=jnp.float32, **SHAPE)
    ct = TransformerConfig(dtype=torch.float32, **SHAPE)
    params = JaxTransformer(cj).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 5), jnp.int32))["params"]
    return cj, ct, params, bridge.params_from_jax(jax.device_get(params))


@pytest.fixture(scope="module")
def servers(model):
    cj, ct, params, sd = model
    jlm = JaxLmServer(config=cj, params=params, slots=0,
                      registry=JaxRegistry())
    tlm = LmServer(config=ct, params=sd, slots=0, device="cpu")
    jh, th = jax_serve(jlm), serve(tlm)
    yield ("http://%s:%d" % jh.server_address[:2],
           "http://%s:%d" % th.server_address[:2], tlm)
    for h, lm in ((jh, jlm), (th, tlm)):
        h.shutdown()
        lm.close()


def _post(url, payload, path="/v1/generate", timeout=120):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, path):
    try:
        with urllib.request.urlopen(url + path, timeout=30) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.mark.parametrize("payload", [
    {"tokens": [3, 5, 7], "max_new_tokens": 8},
    {"tokens": [9] * 20, "max_new_tokens": 5},
    {"text": "the cat", "max_new_tokens": 6},
], ids=["tokens", "long", "text"])
def test_same_answer_as_jax_server(servers, payload):
    jurl, turl, _ = servers
    jcode, jbody = _post(jurl, payload)
    tcode, tbody = _post(turl, payload)
    assert jcode == tcode == 200
    assert tbody == jbody


def test_eos_is_stripped_like_jax_server(servers):
    jurl, turl, _ = servers
    first = _post(turl, {"tokens": [3, 5, 7], "max_new_tokens": 1})[1]
    payload = {"tokens": [3, 5, 7], "max_new_tokens": 6,
               "eos": first["tokens"][0]}
    assert _post(turl, payload) == _post(jurl, payload) == (200,
                                                            {"tokens": []})


def test_sampled_request_repeats_under_one_seed(servers):
    _, turl, _ = servers
    payload = {"tokens": [1, 2, 3], "max_new_tokens": 8,
               "temperature": 0.8, "top_k": 50, "seed": 7}
    a, b = _post(turl, payload), _post(turl, payload)
    assert a[0] == 200 and a == b and len(a[1]["tokens"]) == 8


@pytest.mark.parametrize("payload,field", [
    ({}, "text"),
    ({"text": "a", "tokens": [1]}, "text"),
    ({"tokens": ["x"]}, "tokens"),
    ({"tokens": []}, "tokens"),
    ({"tokens": [999]}, "tokens"),
    ({"tokens": [1], "max_new_tokens": 0}, "max_new_tokens"),
    ({"tokens": [1] * 100, "max_new_tokens": 40}, "max_new_tokens"),
    ({"tokens": [1], "max_new_tokens": "many"}, "max_new_tokens"),
    ({"tokens": [1], "temperature": -1}, "temperature"),
    ({"tokens": [1], "top_k": -2}, "top_k"),
    ({"tokens": [1], "speculative": 1}, "speculative"),
    ({"tokens": [1, 2], "speculative": "four"}, "speculative"),
])
def test_bad_fields_answer_400(servers, payload, field):
    _, turl, _ = servers
    code, body = _post(turl, payload)
    assert code == 400 and body["field"] == field, body


def test_parse_request_matches_jax_fields(model):
    from k8s_tpu.models.server import parse_request as jax_parse

    cj, ct, _, _ = model
    req = {"text": "hi", "max_new_tokens": 3, "temperature": 0.5,
           "top_k": 4, "eos": 10, "seed": 9}
    a, b = parse_request(ct, req, 16), jax_parse(cj, req, 16)
    for f in ("echo_text", "max_new_tokens", "temperature", "top_k", "eos",
              "seed"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.ids.tolist() == b.ids.tolist()


def test_healthz_metrics_and_404(servers):
    _, turl, lm = servers
    assert _post(turl, {"tokens": [4]})[0] == 200
    code, body = _get(turl, "/healthz")
    health = json.loads(body)
    assert code == 200 and health["status"] == "ok"
    assert health["serving"]["engine"] == "single-flight"
    assert health["model"]["layers"] == 2
    code, text = _get(turl, "/metrics")
    assert code == 200
    assert 'serve_requests_total{result="ok"}' in text
    assert "serve_tokens_total" in text and "serve_queue_depth 0" in text
    assert "serve_request_duration_seconds_count" in text
    assert _get(turl, "/nope")[0] == 404
    # span tracing is ported: /debug/traces serves the span ring
    trace.configure(sample_rate=1.0, exporter=trace.RingBufferExporter(8))
    try:
        assert _post(turl, {"tokens": [4]})[0] == 200
        code, body = _get(turl, "/debug/traces")
        assert code == 200
        assert [t["name"] for t in json.loads(body)["traces"]] == \
            ["serve_request"]
    finally:
        trace.configure(sample_rate=0.0,
                        exporter=trace.RingBufferExporter())
    assert _get(turl, "/debug/traces")[0] == 404  # tracing off again
    code, body = _get(turl, "/debug")  # the index, as the reference's
    assert code == 200 and "/debug/requests" in body
    assert _post(turl, {"tokens": [1]}, path="/v2/other")[0] == 404
    code, body = _post(turl, None)
    assert code == 400


def test_later_slices_are_refused(model):
    _, ct, _, sd = model
    lm = LmServer(config=ct, params=sd, slots=2, device="cpu")
    try:  # the engine is this slice's: slots > 0 now builds it
        assert lm.engine is not None and lm.serving_info()["slots"] == 2
    finally:
        lm.close()
    with pytest.raises(ValueError, match="config"):
        LmServer(device="cpu")


def test_cuda_device_without_cuda_raises(model):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    _, ct, _, sd = model
    with pytest.raises(RuntimeError, match="cuda"):
        LmServer(config=ct, params=sd)


def test_artifact_round_trip_with_overrides(model, tmp_path):
    _, ct, _, sd = model
    serving.export_serving(str(tmp_path), ct, sd)
    config, params = serving.load_for_serving(
        str(tmp_path), kv_cache="int8", param_dtype="bfloat16", device="cpu")
    assert config == TransformerConfig(dtype=torch.float32,
                                       kv_cache_dtype="int8", **SHAPE)
    assert set(params) == set(sd)
    assert all(p.dtype == torch.bfloat16 for p in params.values())
    with pytest.raises(ValueError, match="kv_cache"):
        serving.load_for_serving(str(tmp_path), kv_cache="fp8", device="cpu")


def test_reads_the_jax_exports_config(model, tmp_path):
    cj, ct, params, _ = model
    jax_serving.export_serving(str(tmp_path), cj, params)
    assert serving.load_config(str(tmp_path)) == ct
    with pytest.raises(FileNotFoundError, match="orbax"):
        serving.load_serving(str(tmp_path), device="cpu")


def test_cli_serves_an_export(model, tmp_path):
    _, ct, _, sd = model
    serving.export_serving(str(tmp_path), ct, sd)
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_tpu_torch.models.server",
         f"--train_dir={tmp_path}", "--port=0", "--max_new_tokens=4",
         "--device=cpu"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: queue.Queue = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line)

    threading.Thread(target=pump, daemon=True).start()
    try:
        url = None
        while url is None:
            line = lines.get(timeout=120)
            if line.startswith("READY "):
                url = line.split()[1]
        code, body = _post(url, {"tokens": [3, 5, 7]})
        assert code == 200 and len(body["tokens"]) == 4
    finally:
        proc.terminate()
        proc.wait(timeout=30)
