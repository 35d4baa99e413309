"""The port engine's batched speculative lane
(k8s_tpu_torch/models/engine.py ``_spec_step``, placement.py
``PagedCompute.spec_step``, decode.py ``spec_verify_rows``) and the
server's ``speculative`` field, on the CPU.

Exactness: at a fixed seed a batched spec slot emits token for token
what the port's exclusive lane (``make_speculative_generate_fn``) emits
for the same batch-1 request, greedy and sampled; greedy batched spec
also equals vanilla greedy and the JAX engine's batched spec on the same
parameters (``bridge.params_from_jax``).  The tiny f32 model runs
grouped-query attention (4 heads over 2 kv heads).  Covered: a
mixed-width step with plain greedy and sampled rows beside two
``draft_k`` groups, EOS, the int8 pool, a join mid-decode, shared prefix
blocks left bit-identical, exact refcounts, the counters and request
recorder, the refusals, and ``speculative`` over HTTP on the batched
lane, the exclusive lane and single-flight.  Every wait carries a
timeout and every engine and server is shut down.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_tpu.models import engine as jax_engine
from k8s_tpu.models.server import LmServer as JaxLmServer
from k8s_tpu.models.server import serve as jax_serve
from k8s_tpu.models.transformer import Transformer as JaxTransformer
from k8s_tpu.models.transformer import TransformerConfig as JaxConfig
from k8s_tpu.util import metrics as jax_metrics
from k8s_tpu_torch.models import bridge, decode, requestlog
from k8s_tpu_torch.models import engine as engine_lib
from k8s_tpu_torch.models.engine import Engine
from k8s_tpu_torch.models.server import LmServer, serve
from k8s_tpu_torch.models.transformer import Transformer, TransformerConfig
from k8s_tpu_torch.util import metrics as metrics_mod
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

WAIT = 60
SHAPE = dict(vocab_size=61, hidden=32, ffn_hidden=64, layers=2, heads=4,
             kv_heads=2, max_seq_len=64, remat=False)


def configs(**kw):
    return (JaxConfig(dtype=jnp.float32, **{**SHAPE, **kw}),
            TransformerConfig(dtype=torch.float32, **{**SHAPE, **kw}))


def prompt_of(length, seed=0):
    return np.asarray([(seed * 13 + i * 7 + length) % 61
                       for i in range(length)], np.int64)


@pytest.fixture(scope="module")
def params():
    p = JaxTransformer(configs()[0]).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 5), jnp.int32))["params"]
    return p, bridge.params_from_jax(jax.device_get(p))


@pytest.fixture(scope="module")
def models(params):
    """Port models by config overrides (the exclusive lane's)."""
    built = {}

    def get(**kw):
        key = tuple(sorted(kw.items()))
        if key not in built:
            built[key] = Transformer(configs(**kw)[1], params[1],
                                     device="cpu")
        return built[key]
    return get


def exclusive(models, p, n, draft_k, eos=None, temperature=0.0, top_k=None,
              seed=0, **kw):
    """The port's exclusive-lane speculative program, truncated after the
    first EOS as the engine reports."""
    m = models(**kw)
    fn = decode.cached_speculative_fn(
        m.config, n, draft_k=draft_k, eos_id=eos, temperature=temperature,
        top_k=top_k if temperature > 0 else None)
    row = fn(m, torch.as_tensor(p)[None],
             torch.Generator().manual_seed(seed))[0].tolist()
    return row[:row.index(eos) + 1] if eos in row else row


def vanilla(models, p, n, eos=None, temperature=0.0, top_k=None, seed=0):
    m = models()
    fn = decode._cached_generate_fn(m.config, n, temperature, top_k, eos, 0)
    row = fn(m, torch.as_tensor(p)[None],
             torch.Generator().manual_seed(seed))[0].tolist()
    return row[:row.index(eos) + 1] if eos in row else row


@pytest.fixture(scope="module")
def jax_eng(params):
    eng = jax_engine.Engine(configs()[0], params[0], slots=2,
                            queue_limit=16)
    yield eng
    eng.shutdown()


@pytest.fixture()
def make(params):
    built = []

    def build(slots=2, **kw):
        cfg_kw = {k: kw.pop(k) for k in ("kv_cache_dtype", "window_size",
                                         "prefill_chunk") if k in kw}
        eng = Engine(configs(**cfg_kw)[1], params[1], slots=slots,
                     queue_limit=kw.pop("queue_limit", 64), device="cpu",
                     **kw)
        built.append(eng)
        return eng
    yield build
    for eng in built:
        eng.shutdown()


def concurrently(fns):
    out = [None] * len(fns)

    def run(i):
        out[i] = fns[i]()
    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads), "a request hung"
    return out


# -- exactness ------------------------------------------------------------------


@pytest.mark.parametrize("temp,top_k,draft_k,seed", [
    (0.0, None, 4, 0), (0.0, None, 2, 3), (1.0, None, 4, 7),
    (0.7, 5, 3, 11), (1.3, None, 4, 42),
])
def test_fixed_seed_batched_spec_is_the_exclusive_lane(make, models, temp,
                                                       top_k, draft_k, seed):
    eng = make()
    p = prompt_of(9, seed=seed)
    got = eng.submit(p, 12, temperature=temp, top_k=top_k, seed=seed,
                     speculative=draft_k, timeout=WAIT)
    assert got == exclusive(models, p, 12, draft_k, temperature=temp,
                            top_k=top_k, seed=seed)
    if temp == 0.0:
        assert got == vanilla(models, p, 12)


@pytest.mark.parametrize("draft_k", [2, 3, 4])
def test_greedy_batched_spec_is_the_jax_engines(make, models, jax_eng,
                                                draft_k):
    eng = make()
    prompts = [prompt_of(7, seed=2), np.asarray([5, 9, 5, 9, 5, 9, 5, 9])]
    got = concurrently([lambda p=p: eng.submit(p, 10, speculative=draft_k,
                                               timeout=WAIT)
                        for p in prompts])
    for p, toks in zip(prompts, got):
        assert toks == jax_eng.submit(p.astype(np.int32), 10,
                                      speculative=draft_k)
        assert toks == vanilla(models, p, 10)
    eng.debug_check_blocks()


def test_spec_eos_truncates_like_exclusive_and_jax(make, models, jax_eng):
    eng = make()
    p = prompt_of(6, seed=9)
    eos = exclusive(models, p, 10, 4)[3]
    got = eng.submit(p, 10, eos_id=eos, speculative=4, timeout=WAIT)
    assert got == exclusive(models, p, 10, 4, eos=eos) and got[-1] == eos
    assert got == jax_eng.submit(p.astype(np.int32), 10, eos_id=eos,
                                 speculative=4)


def test_mixed_width_batch_all_lanes_exact(make, models):
    """Spec slots of two draft_k groups, a greedy slot, a sampled slot
    and a sampled spec slot share the batch; every lane matches its own
    exclusive-lane oracle and refcounts stay exact."""
    eng = make(slots=4)
    cases = {
        "spec4": (prompt_of(8, 1), 16, dict(speculative=4)),
        "spec2": (prompt_of(9, 3), 14, dict(speculative=2)),
        "spec4_sampled": (prompt_of(11, 5), 12,
                          dict(speculative=4, temperature=1.1, seed=9)),
        "greedy": (prompt_of(5, 2), 12, {}),
        "sampled": (prompt_of(7, 4), 10, dict(temperature=0.9, seed=5)),
    }
    got = concurrently([lambda c=c: eng.submit(c[0], c[1], timeout=WAIT,
                                               **c[2])
                        for c in cases.values()])
    for (name, (p, n, kw)), toks in zip(cases.items(), got):
        if "speculative" in kw:
            want = exclusive(models, p, n, kw["speculative"],
                             temperature=kw.get("temperature", 0.0),
                             seed=kw.get("seed", 0))
        else:
            want = vanilla(models, p, n, temperature=kw.get(
                "temperature", 0.0), seed=kw.get("seed", 0))
        assert toks == want, f"lane {name} corrupted by the mixed batch"
    eng.debug_check_blocks()
    ks = {tuple(t) for t in eng.stats()["decode_step_ks"]}
    assert any(k == 2 and spec for k, _, spec in ks)
    assert any(k == 4 and spec for k, _, spec in ks)


def test_int8_pool_stays_exact(make, models):
    eng = make(kv_cache_dtype="int8")
    p = prompt_of(9, seed=5)
    assert eng.submit(p, 8, speculative=4, timeout=WAIT) == \
        exclusive(models, p, 8, 4, kv_cache_dtype="int8")
    eng.debug_check_blocks()


def test_spec_join_mid_greedy_decode(make, models):
    eng = make()
    long_p, spec_p = prompt_of(9, seed=1), prompt_of(6, seed=21)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "long", eng.submit(long_p, 24, timeout=WAIT)))
    t.start()
    deadline = time.time() + WAIT
    while eng.stats()["steps"] < 3 and time.time() < deadline:
        time.sleep(0.002)
    out["spec"] = eng.submit(spec_p, 8, speculative=4, timeout=WAIT)
    t.join(WAIT)
    assert out["long"] == vanilla(models, long_p, 24)
    assert out["spec"] == exclusive(models, spec_p, 8, 4)


def test_spec_leaves_shared_blocks_bit_identical(make, models):
    """A spec slot's verify writes W lanes a step; the write mask routes
    every lane into the slot's own blocks, so prefix-tree blocks stay
    bit-identical through the spec churn."""
    eng = make(block_size=8, prefix_blocks=8)
    donor = prompt_of(16, seed=40)  # exactly two 8-token blocks
    first = eng.submit(donor, 2, timeout=WAIT)
    blocks = []

    def walk(node):
        for c in node.children.values():
            blocks.append(c.block)
            walk(c)
    walk(eng._tree.root)
    assert len(blocks) >= 2
    snap = [leaf[blocks].clone() for node in eng._pool
            for leaf in node.values()]
    for i in range(3):
        p = prompt_of(9 + i, seed=41 + i)
        assert eng.submit(p, 10, speculative=4, timeout=WAIT) == \
            exclusive(models, p, 10, 4)
    after = [leaf[blocks] for node in eng._pool for leaf in node.values()]
    assert all(torch.equal(a, b) for a, b in zip(snap, after))
    assert eng.submit(donor, 2, timeout=WAIT) == first
    eng.debug_check_blocks()


# -- counters, recorder, refusals -------------------------------------------------


def test_counters_metrics_and_recorder(make, monkeypatch):
    monkeypatch.setenv("K8S_TPU_REQUEST_LOG", "1")
    requestlog.set_active(None)
    try:
        metrics = metrics_mod.serving_metrics(metrics_mod.Registry())
        eng = make(metrics=metrics)
        eng.submit(np.asarray([5, 9, 5, 9, 5, 9, 5, 9]), 12, speculative=4,
                   timeout=WAIT)
        st = eng.stats()
        assert st["spec_steps"] >= 1
        assert st["spec_proposed"] == 3 * st["spec_steps"]
        assert 0 < st["spec_accepted"] <= st["spec_proposed"]
        assert st["spec_mean_accepted"] == pytest.approx(
            st["spec_accepted"] / st["spec_steps"], abs=1e-3)
        assert metrics["spec_proposed"].value == st["spec_proposed"]
        assert metrics["spec_accepted"].value == st["spec_accepted"]
        rec = requestlog.active().snapshot()[-1]
        assert rec["speculative"] == 4 and rec["tokens"] == 12
        assert rec["spec"]["chunks"] == st["spec_steps"]
        assert rec["spec"]["accepted"] == st["spec_accepted"]
        assert rec["phase_s"]["spec_reject"] > 0
        steps = requestlog.active().engine_steps()
        assert steps and all(s["spec_group"] == 4 for s in steps)
    finally:
        requestlog.set_active(None)


def test_spec_validation(make):
    eng = make()
    with pytest.raises(ValueError, match="draft_k"):
        eng.submit(prompt_of(5), 4, speculative=1, timeout=WAIT)
    with pytest.raises(ValueError, match="prompt_len >= 2"):
        eng.submit(prompt_of(1), 4, speculative=4, timeout=WAIT)
    with pytest.raises(ValueError, match="headroom"):
        # passes the plain capacity bound, fails the spec headroom
        eng.submit(prompt_of(5), SHAPE["max_seq_len"] - 4, speculative=4,
                   timeout=WAIT)
    win = make(window_size=8, prefill_chunk=4)
    with pytest.raises(ValueError, match="paged"):
        win.submit(prompt_of(5), 4, speculative=4, timeout=WAIT)
    assert eng.stats()["completed"] == 0 and eng.healthy


def test_env_batch_spec(monkeypatch):
    monkeypatch.delenv("K8S_TPU_SERVE_BATCH_SPEC", raising=False)
    assert engine_lib.env_batch_spec() is True
    for off in ("0", "false", "no", "OFF"):
        monkeypatch.setenv("K8S_TPU_SERVE_BATCH_SPEC", off)
        assert engine_lib.env_batch_spec() is False
    monkeypatch.setenv("K8S_TPU_SERVE_BATCH_SPEC", "1")
    assert engine_lib.env_batch_spec() is True


def test_spec_metric_families_are_the_references():
    """Every serving family of the reference's is the port's, name and
    help text, the kv-transfer and spill tiers' included."""
    ref = jax_metrics.serving_metrics(jax_metrics.Registry())
    got = metrics_mod.serving_metrics(metrics_mod.Registry())
    assert set(got) == set(ref)
    for key in got:
        assert (got[key].name, got[key].help) == \
            (ref[key].name, ref[key].help), key
    assert got["spec_proposed"].name == "serve_spec_proposed_total"
    assert got["spec_accepted"].name == "serve_spec_accepted_total"


# -- over HTTP ------------------------------------------------------------------------


def _post(url, payload):
    req = urllib.request.Request(
        url + "/v1/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def http_servers(params):
    """The port's server on the batched lane, with ``batch_spec`` off
    (the exclusive lane) and single-flight, and the JAX server's engine,
    over the same parameters."""
    cj, ct = configs()
    lms = {"batched": LmServer(config=ct, params=params[1], slots=2,
                               device="cpu"),
           "exclusive": LmServer(config=ct, params=params[1], slots=2,
                                 batch_spec=False, device="cpu"),
           "single": LmServer(config=ct, params=params[1], slots=0,
                              device="cpu"),
           "jax": JaxLmServer(config=cj, params=params[0], slots=2,
                              registry=jax_metrics.Registry())}
    httpds = {k: (jax_serve if k == "jax" else serve)(lm)
              for k, lm in lms.items()}
    yield lms, {k: "http://%s:%d" % h.server_address[:2]
                for k, h in httpds.items()}
    for k in lms:
        httpds[k].shutdown()
        httpds[k].server_close()
        lms[k].close()


def test_speculative_over_http_on_every_lane(http_servers):
    lms, urls = http_servers
    greedy = {"tokens": [5, 9, 5, 9, 5, 9, 5], "max_new_tokens": 10,
              "speculative": 4}
    sampled = {"tokens": [3, 17, 41, 8, 25], "max_new_tokens": 8,
               "speculative": 3, "temperature": 0.8, "top_k": 20,
               "seed": 7}
    want = _post(urls["jax"], greedy)
    assert want[0] == 200 and len(want[1]["tokens"]) == 10
    for lane in ("batched", "exclusive", "single"):
        assert _post(urls[lane], greedy) == want, lane
    got = {lane: _post(urls[lane], sampled)
           for lane in ("batched", "exclusive", "single")}
    assert got["batched"] == got["exclusive"] == got["single"]
    assert got["batched"][0] == 200 and len(got["batched"][1]["tokens"]) == 8
    assert lms["batched"].engine.stats()["spec_steps"] > 0
    assert lms["exclusive"].engine.stats()["spec_steps"] == 0
    info = lms["batched"].serving_info()
    assert info["batch_spec"] and not lms["exclusive"].serving_info()[
        "batch_spec"]
    assert info["spec_proposed"] > 0
    jinfo = lms["jax"].serving_info()
    assert {"batch_spec", "spec_proposed", "spec_accepted",
            "spec_mean_accepted"} <= set(jinfo) & set(info)


def test_speculative_refusals_over_http(http_servers):
    _, urls = http_servers
    for lane in ("batched", "single", "jax"):
        code, body = _post(urls[lane], {"tokens": [1, 2], "speculative": 1,
                                        "max_new_tokens": 4})
        assert code == 400 and body["field"] == "speculative", lane
        # a one-token prompt has nothing to draft from: the exclusive
        # lane refuses it, as the reference's does
        code, body = _post(urls[lane], {"tokens": [4], "speculative": 4,
                                        "max_new_tokens": 4})
        assert code == 400 and "prompt_len >= 2" in body["error"], lane
        code, body = _post(urls[lane], {"tokens": [4] * 10,
                                        "max_new_tokens": 54,
                                        "speculative": 4})
        assert code == 400 and "headroom" in body["error"], lane
