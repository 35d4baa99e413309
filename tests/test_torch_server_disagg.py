"""Disaggregated serving and the spill tier through the port's HTTP server
(k8s_tpu_torch/models/server.py): two port ``LmServer``s on the CPU,
``role="prefill"`` and ``role="decode"``, over real sockets (HTTP and the
kv-transfer plane), on the same parameters as the JAX server.

Roles and the receiver in ``/healthz``; a migrated request's tokens are
the local ones (greedy ones the JAX server's too) and the counters move;
a repeated prefix is deduplicated on the wire; a bad ``kv_dest`` is a
400, a dead one a 502, a receiver out of blocks a 503; the request
recorder bills the hop to ``migrate`` on both sides; ``kvxfer_int8``
serves; ``kv_src`` fetches a cached prefix from its holder; an
exclusive-lane request with a ``kv_dest`` is served locally; a JAX
prefill server migrates a greedy request to a port decode server; and
``--role``, ``--spill-mb`` and the kvxfer flags parse as the
reference's."""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import pytest
import torch

from k8s_tpu.models import server as jax_server
from k8s_tpu.models.transformer import Transformer as JaxTransformer
from k8s_tpu.models.transformer import TransformerConfig as JaxConfig
from k8s_tpu.util.metrics import Registry as JaxRegistry
from k8s_tpu_torch.models import bridge, requestlog
from k8s_tpu_torch.models import server as server_mod
from k8s_tpu_torch.models.server import LmServer, serve
from k8s_tpu_torch.models.transformer import TransformerConfig
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

SHAPE = dict(vocab_size=256, hidden=32, ffn_hidden=64, layers=2, heads=4,
             kv_heads=2, max_seq_len=128, remat=False)
WAIT = 60


@pytest.fixture(scope="module")
def model():
    cj = JaxConfig(dtype=jnp.float32, **SHAPE)
    ct = TransformerConfig(dtype=torch.float32, **SHAPE)
    params = JaxTransformer(cj).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 5), jnp.int32))["params"]
    return cj, ct, params, bridge.params_from_jax(jax.device_get(params))


@pytest.fixture()
def servers(model):
    """``build(**kw)``: a served port LmServer on the CPU and its URL;
    every server is closed after the test."""
    made = []

    def build(**kw):
        _, ct, _, sd = model
        lm = LmServer(config=ct, params=sd, device="cpu",
                      **{"slots": 2, **kw})
        httpd = serve(lm)
        made.append((httpd, lm))
        return lm, "http://%s:%d" % httpd.server_address[:2]
    yield build
    for httpd, lm in made:
        httpd.shutdown()
        httpd.server_close()
        lm.close()


def prompt_of(n, salt=3):
    return [(i * 7 + salt) % 256 for i in range(n)]


def post(url, body):
    req = urllib.request.Request(url + "/v1/generate",
                                 data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def get(url, path):
    with urllib.request.urlopen(url + path, timeout=WAIT) as r:
        return r.read().decode()


def dest(lm):
    return f"127.0.0.1:{lm.serving_info()['kvxfer_port']}"


def test_roles_and_receiver_surface(servers):
    pre, purl = servers(role="prefill")
    dec, durl = servers(role="decode", spill_mb=4)
    for url, role in ((purl, "prefill"), (durl, "decode")):
        info = json.loads(get(url, "/healthz"))["serving"]
        assert info["role"] == role
        for key in ("kvxfer_port", "kvxfer_int8", "kvxfer_dedup",
                    "kv_exports", "kv_imports", "kv_blocks_out",
                    "kv_blocks_in", "spill_enabled", "spill_blocks",
                    "spill_bytes", "spill_demotions", "spill_promotions",
                    "spill_evictions", "kv_blocks_deduped",
                    "kv_prefix_fetched"):
            assert key in info, key
    assert json.loads(get(durl, "/healthz"))["serving"]["kvxfer_port"] \
        == dec._kv_receiver.port
    assert json.loads(get(durl, "/healthz"))["serving"]["spill_enabled"]
    assert pre._kv_receiver is None  # prefill pods never seat
    assert dec._kv_sender is None    # decode pods never export


@pytest.mark.parametrize("kw", [{}, {"temperature": 1.0, "seed": 5}],
                         ids=["greedy", "sampled"])
def test_migration_identity_and_counters(servers, model, kw):
    pre, purl = servers(role="prefill")
    dec, durl = servers(role="decode")
    p = prompt_of(30, salt=17)
    body = {"tokens": p, "max_new_tokens": 8, **kw}
    code, local, _ = post(purl, body)
    code2, routed, _ = post(purl, {**body, "kv_dest": dest(dec)})
    assert code == code2 == 200 and routed == local
    if not kw:
        cj, _, params, _ = model
        jlm = jax_server.LmServer(config=cj, params=params, slots=2,
                                  registry=JaxRegistry())
        try:
            want = jlm.generate(jax_server.parse_request(cj, body, 8))
        finally:
            jlm.close()
        assert routed == want
    assert pre.engine.stats()["kv_exports"] == 1
    assert dec.engine.stats()["kv_imports"] == 1
    assert dec.engine.stats()["kv_blocks_in"] == 2
    assert "serve_kv_blocks_migrated_total 2" in get(durl, "/metrics")
    text = get(purl, "/metrics")
    assert "serve_kv_migrate_seconds_count 1" in text
    # the repeat ships only the block the decode pod lacks
    code, again, _ = post(purl, {**body, "kv_dest": dest(dec)})
    assert code == 200 and again == local
    assert "serve_kvxfer_dedup_blocks_skipped_total 1" in \
        get(purl, "/metrics")
    assert dec.engine.stats()["kv_blocks_deduped"] == 1
    assert 'serve_kv_prefix_cached{fp="' in get(durl, "/metrics")
    pre.engine.debug_check_blocks()
    dec.engine.debug_check_blocks()


def test_bad_and_dead_kv_dest(servers):
    _, purl = servers(role="prefill")
    code, body, _ = post(purl, {"tokens": prompt_of(12), "kv_dest": "x"})
    assert code == 400 and body["field"] == "kv_dest"
    code, body, _ = post(purl, {"tokens": prompt_of(12), "kv_src": 5})
    assert code == 400 and body["field"] == "kv_src"
    code, body, _ = post(purl, {"tokens": prompt_of(12),
                                "max_new_tokens": 4,
                                "kv_dest": "127.0.0.1:1"})
    assert code == 502 and "kv migration" in body["error"]


def test_receiver_out_of_blocks_is_503(servers, monkeypatch):
    pre, purl = servers(role="prefill")
    dec, _ = servers(role="decode")
    from k8s_tpu_torch.models.engine import PoolExhausted

    def full(*a, **k):
        raise PoolExhausted(3, 0)
    monkeypatch.setattr(dec.engine, "submit_prefilled", full)
    code, body, headers = post(purl, {"tokens": prompt_of(30),
                                      "max_new_tokens": 4,
                                      "kv_dest": dest(dec)})
    assert code == 503 and headers.get("Retry-After") == "1"
    assert "pool" in body["error"].lower()


def test_request_recorder_sees_the_hop(servers, monkeypatch):
    monkeypatch.setenv("K8S_TPU_REQUEST_LOG", "1")
    requestlog.set_active(None)
    try:
        pre, purl = servers(role="prefill")
        dec, durl = servers(role="decode")
        assert pre.engine._reqlog is not None
        code, _, _ = post(purl, {"tokens": prompt_of(31, salt=29),
                                 "max_new_tokens": 6,
                                 "kv_dest": dest(dec)})
        assert code == 200
        entries = json.loads(get(durl, "/debug/requests?n=16"))["requests"]
        sender = [e for e in entries if e["kind"] == "prefill_export"]
        seated = [e for e in entries if e["kind"] == "migrated"]
        assert sender and seated
        assert sender[-1]["retire"] == "migrated"
        assert sender[-1]["phase_s"]["migrate"] > 0
        assert seated[-1]["phase_s"]["migrate"] > 0
        full = requestlog.active().request(sender[-1]["id"])
        assert full["migrate"] == {"direction": "out", "blocks": 2,
                                   "peer": dest(dec)}
        assert requestlog.active().request(
            seated[-1]["id"])["migrate"]["direction"] == "in"
    finally:
        requestlog.set_active(None)


def test_wire_int8_path_serves(servers):
    pre, purl = servers(role="prefill", kvxfer_int8=True)
    dec, _ = servers(role="decode")
    code, out, _ = post(purl, {"tokens": prompt_of(30),
                               "max_new_tokens": 6, "kv_dest": dest(dec)})
    assert code == 200 and len(out["tokens"]) == 6
    assert dec.engine.stats()["kv_imports"] == 1
    assert pre.serving_info()["kvxfer_int8"]


def test_kv_src_fetches_a_cached_prefix(servers):
    pre, purl = servers(role="prefill")
    dec, durl = servers(role="decode")
    q = prompt_of(50, salt=1)
    code, _, _ = post(durl, {"tokens": q, "max_new_tokens": 2})
    assert code == 200  # the decode pod now caches q's chain
    q2 = q[:45] + [9, 9, 9]
    code, want, _ = post(purl, {"tokens": q2, "max_new_tokens": 4})
    pre2, purl2 = servers(role="prefill")
    code, got, _ = post(purl2, {"tokens": q2, "max_new_tokens": 4,
                                "kv_src": dest(dec)})
    assert code == 200 and got == want
    st = pre2.engine.stats()
    assert st["kv_prefix_fetched"] == 2 and st["prefix_hits"] == 1
    assert st["prefix_tokens_saved"] == 32  # the tail only prefilled
    assert dec._kv_receiver.stats()["fetch_blocks_out"] == 2
    # a dead holder costs nothing but the fetch: the request still serves
    code, again, _ = post(purl, {"tokens": q2, "max_new_tokens": 4,
                                 "kv_src": "127.0.0.1:1"})
    assert code == 200 and again == want


def test_exclusive_routed_request_serves_locally(servers):
    pre, purl = servers(role="prefill", batch_sampling=False)
    dec, _ = servers(role="decode")
    code, out, _ = post(purl, {"tokens": prompt_of(30),
                               "max_new_tokens": 6, "temperature": 1.0,
                               "seed": 3, "kv_dest": dest(dec)})
    assert code == 200 and len(out["tokens"]) == 6
    assert pre.engine.stats()["kv_exports"] == 0
    assert dec.engine.stats()["kv_imports"] == 0


def test_jax_prefill_server_migrates_to_a_port_decode_server(servers,
                                                              model):
    cj, _, params, _ = model
    dec, _ = servers(role="decode")
    jpre = jax_server.LmServer(config=cj, params=params, slots=2,
                               role="prefill", registry=JaxRegistry())
    try:
        body = {"tokens": prompt_of(40, salt=7), "max_new_tokens": 7}
        want = jpre.generate(jax_server.parse_request(cj, body, 7))
        got = jpre.generate(jax_server.parse_request(
            cj, {**body, "kv_dest": dest(dec)}, 7))
    finally:
        jpre.close()
    assert got == want
    assert dec.engine.stats()["kv_imports"] == 1
    dec.engine.debug_check_blocks()


@pytest.mark.parametrize("argv", [
    [], ["--role", "prefill"], ["--role", "decode", "--kvxfer-port", "0"],
    ["--spill-mb", "256"], ["--kvxfer-int8", "1", "--kvxfer-dedup", "0"]],
    ids=["none", "prefill", "decode", "spill", "int8_nodedup"])
def test_flags_parse_as_the_references(monkeypatch, argv):
    seen = {}

    class Stop(Exception):
        pass

    def capture(which):
        def ctor(*a, **kw):
            seen[which] = {k: kw.get(k) for k in (
                "role", "kvxfer_port", "kvxfer_int8", "spill_mb",
                "kvxfer_dedup")}
            raise Stop
        return ctor
    monkeypatch.setattr(jax_server, "LmServer", capture("jax"))
    monkeypatch.setattr(server_mod, "LmServer", capture("port"))
    for mod in (jax_server, server_mod):
        with pytest.raises(Stop):
            mod.main(["--train_dir", "/nonexistent", *argv])
    assert seen["port"] == seen["jax"]
    with pytest.raises(SystemExit):
        server_mod.main(["--train_dir", "d", "--role", "both"])
