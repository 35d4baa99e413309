"""The port's continuous-batching engine (k8s_tpu_torch/models/engine.py)
against the JAX package's engine on the CPU, and on its own.

Greedy tokens must be the JAX engine's on the same prompts and the same
parameters (carried across by ``bridge.params_from_jax``): mixed prompt
lengths, a join mid-decode, EOS, a single-token request, more requests
than slots, a prefix hit, a copy-on-write divergence, the last prompt
token never shared, a windowed config (dense rows) and an int8 pool.
Within the port, a fixed-seed sampled request gives the exclusive lane's
tokens on the batched lane.  Every wait carries a timeout and every
engine is shut down, so a hung engine thread fails a test instead of
stalling the run.
"""

from __future__ import annotations

import math
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_tpu.models import decode as jax_decode
from k8s_tpu.models import engine as jax_engine
from k8s_tpu.models.transformer import Transformer as JaxTransformer
from k8s_tpu.models.transformer import TransformerConfig as JaxConfig
from k8s_tpu_torch.models import bridge, decode, requestlog
from k8s_tpu_torch.models import engine as engine_lib
from k8s_tpu_torch.models.engine import (
    DEFAULT_QUEUE,
    DEFAULT_SLOTS,
    MAX_STEP_TOKENS,
    Engine,
    EngineClosed,
    QueueFull,
)
from k8s_tpu_torch.models.transformer import TransformerConfig
from k8s_tpu_torch.util import metrics as metrics_mod

WAIT = 60  # seconds any one request or thread may take here
SHAPE = dict(vocab_size=61, hidden=32, ffn_hidden=64, layers=2, heads=4,
             kv_heads=4, max_seq_len=64, remat=False)
# the engine settings the comparisons run under, by name
SETUPS = {
    "default": ({}, dict(slots=2, queue_limit=32)),
    "prefix": ({}, dict(slots=2, queue_limit=32, block_size=8,
                        prefix_blocks=24)),
    "window": (dict(window_size=8, prefill_chunk=4),
               dict(slots=2, queue_limit=32)),
    "int8": (dict(kv_cache_dtype="int8"), dict(slots=2, queue_limit=32)),
}


def prompt_of(length, seed=0):
    return np.asarray([(seed * 13 + i * 7 + length) % 61
                       for i in range(length)], np.int64)


@pytest.fixture(scope="module")
def params():
    cj = JaxConfig(dtype=jnp.float32, **SHAPE)
    p = JaxTransformer(cj).init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 5), jnp.int32))["params"]
    return p, bridge.params_from_jax(jax.device_get(p))


def configs(name):
    extra = SETUPS[name][0]
    return (JaxConfig(dtype=jnp.float32, **SHAPE, **extra),
            TransformerConfig(dtype=torch.float32, **SHAPE, **extra))


@pytest.fixture(scope="module")
def ref(params):
    """``ref(setup, prompt, n, eos=None)``: the JAX engine's greedy
    tokens, one JAX engine per setup, built on first use."""
    engines = {}

    def run(setup, prompt, n, eos=None):
        if setup not in engines:
            engines[setup] = jax_engine.Engine(configs(setup)[0], params[0],
                                               **SETUPS[setup][1])
        return engines[setup].submit(np.asarray(prompt, np.int32), n,
                                     eos_id=eos)
    yield run
    for eng in engines.values():
        eng.shutdown()


@pytest.fixture()
def make(params):
    """``make(setup, **overrides)``: a port engine on the CPU, shut down
    after the test."""
    built = []

    def build(setup="default", **kw):
        eng = Engine(configs(setup)[1], params[1],
                     **{**SETUPS[setup][1], **kw}, device="cpu")
        built.append(eng)
        return eng
    yield build
    for eng in built:
        eng.shutdown()


def exclusive(setup, sd, prompt, n, eos=None, temperature=0.0, top_k=None,
              seed=0):
    """The port's exclusive lane (the single-flight program), truncated
    after the first EOS as the engine reports."""
    row = decode.generate(configs(setup)[1], sd, np.asarray(prompt)[None],
                          n, seed=seed, temperature=temperature,
                          top_k=top_k, eos_id=eos, device="cpu")[0].tolist()
    return row[:row.index(eos) + 1] if eos in row else row


def concurrently(fns):
    """Run the callables on threads; their results in order."""
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


def wait_for(cond, what):
    deadline = time.time() + WAIT
    while not cond() and time.time() < deadline:
        time.sleep(0.002)
    assert cond(), what


# -- against the JAX engine ---------------------------------------------------


class TestAgainstJaxEngine:
    def test_mixed_prompt_lengths(self, make, ref):
        eng = make()
        prompts = [prompt_of(n, seed=i)
                   for i, n in enumerate((3, 7, 13, 5, 21))]
        got = concurrently([lambda p=p: eng.submit(p, 8, timeout=WAIT)
                            for p in prompts])
        for p, toks in zip(prompts, got):
            assert toks == ref("default", p, 8), f"prompt {len(p)}"
        eng.debug_check_blocks()

    def test_join_mid_decode(self, make, ref):
        eng = make()
        long_p, short_p = prompt_of(9, seed=1), prompt_of(4, seed=2)
        out = {}
        t = threading.Thread(target=lambda: out.setdefault(
            "long", eng.submit(long_p, 24, timeout=WAIT)))
        t.start()
        wait_for(lambda: eng.stats()["steps"] >= 3, "long request idle")
        out["short"] = eng.submit(short_p, 5, timeout=WAIT)
        t.join(WAIT)
        assert out["long"] == ref("default", long_p, 24)
        assert out["short"] == ref("default", short_p, 5)

    def test_eos_truncates(self, make, ref):
        eng = make()
        p = prompt_of(6, seed=3)
        eos = ref("default", p, 8)[3]
        got = eng.submit(p, 8, eos_id=eos, timeout=WAIT)
        assert got == ref("default", p, 8, eos) and got[-1] == eos

    def test_single_token_request_retires_at_prefill(self, make, ref):
        eng = make()
        p = prompt_of(5, seed=4)
        assert eng.submit(p, 1, timeout=WAIT) == ref("default", p, 1)
        assert eng.stats()["steps"] == 0

    def test_more_requests_than_slots(self, make, ref):
        eng = make()
        prompts = [prompt_of(3 + i, seed=i) for i in range(7)]
        got = concurrently([lambda p=p: eng.submit(p, 6, timeout=WAIT)
                            for p in prompts])
        st = eng.stats()
        assert st["completed"] == 7 and st["peak_active"] <= 2
        assert st["active"] == 0 and st["queue_depth"] == 0
        for p, toks in zip(prompts, got):
            assert toks == ref("default", p, 6)
        eng.debug_check_blocks()

    def test_prefix_hit_attaches_full_blocks(self, make, ref):
        eng = make("prefix")
        p = prompt_of(20, seed=9)  # two full 8-token blocks + 4
        a = eng.submit(p, 6, timeout=WAIT)
        assert eng.stats()["prefix_hits"] == 0
        b = eng.submit(p, 6, timeout=WAIT)
        st = eng.stats()
        assert a == b == ref("prefix", p, 6)
        assert st["prefix_hits"] == 1 and st["prefix_tokens_saved"] == 16
        eng.debug_check_blocks()

    def test_divergent_tail_copy_on_write(self, make, ref):
        eng = make("prefix")
        common = [int(x) for x in prompt_of(12, seed=5)]
        p1 = np.asarray(common + [1, 2, 3, 4, 5])
        p2 = np.asarray(common + [9, 8, 7])
        r1 = eng.submit(p1, 6, timeout=WAIT)
        r2 = eng.submit(p2, 6, timeout=WAIT)
        st = eng.stats()
        assert r1 == ref("prefix", p1, 6) and r2 == ref("prefix", p2, 6)
        assert st["cow_copies"] == 1 and st["prefix_hits"] == 1
        # the donor's tree blocks were never written
        assert eng.submit(p1, 6, timeout=WAIT) == r1
        eng.debug_check_blocks()

    def test_last_prompt_token_never_shared(self, make, ref):
        eng = make("prefix")
        p = prompt_of(16, seed=21)  # exactly two blocks
        a = eng.submit(p, 4, timeout=WAIT)
        b = eng.submit(p, 4, timeout=WAIT)
        assert a == b == ref("prefix", p, 4)
        assert eng.stats()["prefix_tokens_saved"] == 15

    def test_windowed_config_uses_dense_rows(self, make, ref):
        eng = make("window")
        assert not eng.paged and eng.stats()["pool_blocks"] == 0
        prompts = [prompt_of(n, seed=30 + n) for n in (5, 19, 11)]
        got = concurrently([lambda p=p: eng.submit(p, 12, timeout=WAIT)
                            for p in prompts])
        for p, toks in zip(prompts, got):
            assert toks == ref("window", p, 12)
        assert set(eng.stats()["prefill_programs"]) <= {1, 2, 4}

    def test_int8_pool(self, make, ref):
        eng = make("int8")
        prompts = [prompt_of(9, seed=5), prompt_of(17, seed=6)]
        got = concurrently([lambda p=p: eng.submit(p, 6, timeout=WAIT)
                            for p in prompts])
        for p, toks in zip(prompts, got):
            assert toks == ref("int8", p, 6)
        eng.debug_check_blocks()


@pytest.mark.parametrize("setup", ["default", "window"])
def test_bucket_set_and_split_are_the_references(setup):
    cj, ct = configs(setup)
    assert decode.prefill_buckets_for(ct) == jax_decode.prefill_buckets_for(cj)
    for n in range(1, 70):
        assert decode.split_prefill(n, (1, 2, 4, 8)) == \
            jax_decode.split_prefill(n, (1, 2, 4, 8))


# -- within the port: the batched sampling lane ------------------------------


class TestBatchedSampling:
    @pytest.mark.parametrize("temp,top_k,seed", [
        (1.0, None, 5), (0.7, 5, 11), (1.3, 3, 42)])
    def test_sampled_is_the_exclusive_lane(self, make, params, temp, top_k,
                                           seed):
        eng = make()
        p = prompt_of(9, seed=seed)
        assert eng.submit(p, 8, temperature=temp, top_k=top_k, seed=seed,
                          timeout=WAIT) == \
            exclusive("default", params[1], p, 8, temperature=temp,
                      top_k=top_k, seed=seed)

    def test_mixed_greedy_and_sampled_concurrently(self, make, params):
        eng = make(slots=4)
        cases = [(prompt_of(7, 1), 8, 0.0, None, 0),
                 (prompt_of(13, 2), 6, 0.7, 5, 11),
                 (prompt_of(5, 3), 10, 1.3, None, 42),
                 (prompt_of(21, 4), 8, 1.0, 7, 7)]
        got = concurrently([
            lambda c=c: eng.submit(c[0], c[1], temperature=c[2], top_k=c[3],
                                   seed=c[4], timeout=WAIT) for c in cases])
        for (p, n, t, k, s), toks in zip(cases, got):
            assert toks == exclusive("default", params[1], p, n,
                                     temperature=t, top_k=k, seed=s)

    def test_sampled_eos_and_windowed_rows(self, make, params):
        eng = make("window")
        p = prompt_of(10, seed=13)
        full = exclusive("window", params[1], p, 10, temperature=0.8, seed=2)
        eos = full[4]
        assert eng.submit(p, 10, eos_id=eos, temperature=0.8, seed=2,
                          timeout=WAIT) == exclusive(
            "window", params[1], p, 10, eos=eos, temperature=0.8, seed=2)

    def test_seed_determinism(self, make):
        eng = make()
        p = prompt_of(6, seed=8)
        a, b, c = (eng.submit(p, 8, temperature=1.0, seed=s, timeout=WAIT)
                   for s in (11, 11, 12))
        assert a == b and c != a

    def test_bad_sampling_args_rejected(self, make):
        eng = make()
        with pytest.raises(ValueError, match="temperature"):
            eng.submit(prompt_of(3), 2, temperature=-0.5, timeout=WAIT)
        with pytest.raises(ValueError, match="top_k"):
            eng.submit(prompt_of(3), 2, temperature=1.0, top_k=0,
                       timeout=WAIT)
        with pytest.raises(ValueError, match="max_seq_len"):
            eng.submit(prompt_of(5), SHAPE["max_seq_len"] + 10, timeout=WAIT)


# -- block refcounts, eviction, the bucket contract ---------------------------


class TestBlocks:
    def test_churn_keeps_refcounts_exact(self, make, params):
        eng = make("prefix", slots=3, prefix_blocks=8)
        base = [int(x) for x in prompt_of(16, seed=30)]

        def request(i):
            if i % 3 == 0:
                p = np.asarray(base + [i % 61])
            elif i % 3 == 1:
                p = np.asarray(base[:9] + [(i * 7) % 61, i % 61])
            else:
                p = prompt_of(5 + i % 7, seed=100 + i)
            return p, (0.0 if i % 2 == 0 else 0.9), 3 + i % 5

        per_phase = 12  # submitters a phase: four times the slots
        for phase in range(2):
            ids = range(per_phase * phase, per_phase * (phase + 1))
            switch = sys.getswitchinterval()
            sys.setswitchinterval(1e-5)  # interleave submitters and loop
            try:
                got = concurrently([
                    lambda r=request(i), i=i: eng.submit(
                        r[0], r[2], temperature=r[1], seed=i, timeout=WAIT)
                    for i in ids])
            finally:
                sys.setswitchinterval(switch)
            assert eng.stats()["active"] == 0
            eng.debug_check_blocks()  # refcounts == held references
            for i, toks in zip(ids, got):
                p, t, n = request(i)
                assert toks == exclusive("default", params[1], p, n,
                                         temperature=t, seed=i), i
        assert eng.stats()["prefix_hits"] >= 4

    def test_retire_keeps_shared_blocks_alive(self, make, params):
        eng = make("prefix", prefix_blocks=2)
        p_long = prompt_of(20, seed=6)
        eng.submit(p_long, 2, timeout=WAIT)  # seeds the tree
        out = {}
        t = threading.Thread(target=lambda: out.setdefault(
            "long", eng.submit(p_long, 24, timeout=WAIT)))
        t.start()
        wait_for(lambda: eng.stats()["steps"] >= 2, "long request idle")
        short = [eng.submit(p_long, 2, timeout=WAIT) for _ in range(4)]
        t.join(WAIT)
        expect = exclusive("default", params[1], p_long, 24)
        assert out["long"] == expect
        assert all(s == expect[:2] for s in short)
        eng.debug_check_blocks()

    def test_tree_eviction_under_tiny_pool(self, make, params):
        """The tree grows into the free list until an allocation must
        evict least-recently-hit leaves; outputs stay exact."""
        eng = make("prefix", prefix_blocks=1)
        for i in range(10):  # distinct prompts: two tree blocks each
            p = prompt_of(18, seed=50 + i)
            assert eng.submit(p, 4, timeout=WAIT) == \
                exclusive("default", params[1], p, 4)
            eng.debug_check_blocks()
        st = eng.stats()
        assert st["tree_evictions"] >= 1
        assert st["blocks_in_use"] == st["tree_nodes"] < st["pool_blocks"]

    def test_pool_floor(self, make):
        eng = make(prefix_blocks=0)
        maxb = math.ceil(SHAPE["max_seq_len"] / eng.block_size)
        assert eng.pool_blocks == 1 + 2 * maxb
        assert eng.stats()["tree_nodes"] == 0 and eng._tree is None
        auto = make()
        assert auto.pool_blocks == 1 + 2 * maxb + 2 * maxb

    def test_prefill_chunks_stay_in_the_bucket_set(self, make):
        """The bounded-shape contract the reference's compile ledger
        guards: whatever the prompt lengths and prefix hits, every
        prefill chunk is a bucket size and every decode width a power of
        two up to MAX_STEP_TOKENS."""
        eng = make("prefix")
        rs = np.random.RandomState(7)
        base = prompt_of(30, seed=7)
        for i in range(10):
            cut = int(rs.randint(1, 30))
            tail = rs.randint(0, 61, int(rs.randint(1, 12)))
            eng.submit(np.concatenate([base[:cut], tail]), 3, timeout=WAIT)
        st = eng.stats()
        assert st["prefix_hits"] >= 1
        assert set(st["prefill_programs"]) <= set(st["buckets"])
        assert {k for k, _, _ in st["decode_step_ks"]} <= \
            {1 << i for i in range(MAX_STEP_TOKENS.bit_length())}
        assert st["model_calls"] == st["prefill_chunks"] + st["steps"]

    def test_block_size_must_be_a_bucket(self, make):
        with pytest.raises(ValueError, match="block_size"):
            make(block_size=6)
        with pytest.raises(ValueError, match="include 1"):
            make(buckets=(2, 4))


# -- queue, shutdown, crash, exclusive lane -----------------------------------


def _blocked(eng):
    """Park the engine thread in an exclusive-lane callable; returns the
    event that releases it and the parked submitter's thread."""
    release, started = threading.Event(), threading.Event()

    def blocker():
        started.set()
        release.wait(WAIT)
        return [0]
    t = threading.Thread(target=lambda: eng.submit_exclusive(
        blocker, timeout=WAIT), daemon=True)
    t.start()
    assert started.wait(WAIT), "exclusive blocker never ran"
    return release, t


class TestLifecycle:
    def test_queue_full_raises(self, make):
        metrics = metrics_mod.serving_metrics(metrics_mod.Registry())
        eng = make(slots=1, queue_limit=1, metrics=metrics)
        release, t = _blocked(eng)
        try:
            t2 = threading.Thread(target=lambda: eng.submit(
                prompt_of(3), 2, timeout=WAIT), daemon=True)
            t2.start()
            wait_for(lambda: eng.queue_depth() == 1, "request never queued")
            with pytest.raises(QueueFull) as ei:
                eng.submit(prompt_of(4), 2, timeout=WAIT)
            assert ei.value.retry_after_s > 0 and ei.value.limit == 1
            assert metrics["rejected"].value == 1
        finally:
            release.set()
        t.join(WAIT)
        t2.join(WAIT)

    def test_timeout_removes_queued_request(self, make):
        eng = make(slots=1)
        release, t = _blocked(eng)
        try:
            with pytest.raises(TimeoutError):
                eng.submit(prompt_of(3), 2, timeout=0.05)
            assert eng.queue_depth() == 0
        finally:
            release.set()
        t.join(WAIT)

    def test_shutdown_fails_pending_and_rejects_new(self, make):
        eng = make(slots=1)
        assert eng.submit(prompt_of(3), 2, timeout=WAIT)
        release, t = _blocked(eng)
        err = {}

        def pending():
            try:
                eng.submit(prompt_of(4), 2, timeout=WAIT)
            except EngineClosed as e:
                err["e"] = e
        t2 = threading.Thread(target=pending)
        t2.start()
        wait_for(lambda: eng.queue_depth() == 1, "request never queued")
        closer = threading.Thread(target=eng.shutdown)
        closer.start()
        wait_for(lambda: eng._closed, "shutdown never began")
        release.set()
        for th in (t2, t, closer):
            th.join(WAIT)
        assert "e" in err
        eng.shutdown()
        with pytest.raises(EngineClosed):
            eng.submit(prompt_of(3), 2, timeout=WAIT)
        assert eng.healthy  # closed is not crashed

    def test_bad_request_does_not_kill_the_loop(self, make, params):
        eng = make(slots=1)
        bad = np.asarray([SHAPE["vocab_size"] + 5, 1, 2])  # out of vocab
        with pytest.raises(IndexError):
            eng.submit(bad, 3, timeout=WAIT)
        assert eng.healthy
        p = prompt_of(3)
        assert eng.submit(p, 2, timeout=WAIT) == \
            exclusive("default", params[1], p, 2)
        eng.debug_check_blocks()

    def test_loop_crash_flips_healthy(self, make):
        eng = make(slots=1)
        assert eng.healthy

        def boom(*a, **k):
            raise RuntimeError("synthetic device failure")
        eng._step_fn = boom
        with pytest.raises((RuntimeError, EngineClosed)):
            eng.submit(prompt_of(4), 4, timeout=WAIT)
        wait_for(lambda: not eng.healthy, "crash did not flip healthy")
        with pytest.raises(EngineClosed):
            eng.submit(prompt_of(3), 2, timeout=WAIT)

    def test_exclusive_lane(self, make):
        eng = make()
        assert eng.submit_exclusive(lambda: "ran", timeout=WAIT) == "ran"

        def boom():
            raise RuntimeError("exclusive lane failure")
        with pytest.raises(RuntimeError, match="exclusive lane failure"):
            eng.submit_exclusive(boom, timeout=WAIT)
        assert eng.submit(prompt_of(3), 2, timeout=WAIT)
        assert eng.stats()["completed"] == 2

    @pytest.mark.parametrize("call", [
        lambda e: e.submit(prompt_of(3), 2, speculative=4),
        lambda e: e.prefill_export(prompt_of(3), 2),
        lambda e: e.submit_prefilled({}),
        lambda e: e.prefix_index(),
        lambda e: e.dedup_have([]),
        lambda e: e.fetch_prefix(None),
        lambda e: e.import_prefix(None),
    ], ids=["speculative", "prefill_export", "submit_prefilled",
            "prefix_index", "dedup_have", "fetch_prefix", "import_prefix"])
    def test_later_slices_refused_by_name(self, make, call):
        eng = make()
        with pytest.raises(NotImplementedError, match="not ported"):
            call(eng)

    def test_spill_tier_and_mesh_refused(self, params, monkeypatch):
        monkeypatch.setenv("K8S_TPU_SERVE_SPILL_MB", "16")
        with pytest.raises(NotImplementedError, match="spill"):
            Engine(configs("default")[1], params[1], slots=1, device="cpu")
        monkeypatch.delenv("K8S_TPU_SERVE_SPILL_MB")
        with pytest.raises(NotImplementedError, match="parallel/"):
            Engine(configs("default")[1], params[1], slots=1, device="cpu",
                   placement=object())

    def test_cuda_default_without_cuda_raises(self, params):
        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA device")
        with pytest.raises(RuntimeError, match="cuda"):
            Engine(configs("default")[1], params[1], slots=1)


class TestObservability:
    def test_metrics_families_move(self, make):
        registry = metrics_mod.Registry()
        metrics = metrics_mod.serving_metrics(registry)
        eng = make("prefix", metrics=metrics)
        p = prompt_of(20, seed=9)
        eng.submit(p, 5, timeout=WAIT)
        eng.submit(p, 5, temperature=0.5, seed=1, timeout=WAIT)
        assert metrics["prefix_hits"].value == 1
        assert metrics["prefill_saved"].value == 16
        assert metrics["sampled_batched"].value == 1
        assert metrics["tokens"].value == 10
        assert metrics["blocks_in_use"].value == \
            eng.stats()["blocks_in_use"]
        text = registry.expose()
        for name in ("ttft", "queue_wait", "tpot"):
            assert f"serve_{name}_seconds_count 2" in text, name
        assert "serve_step_duration_seconds_count" in text
        assert "serve_batch_occupancy 1" in text

    def test_request_log_records_timelines(self, make, monkeypatch):
        monkeypatch.setenv("K8S_TPU_REQUEST_LOG", "1")
        requestlog.set_active(None)
        try:
            eng = make()
            eng.submit(prompt_of(7), 4, timeout=WAIT)
            eng.submit_exclusive(lambda: [1], timeout=WAIT)
            rec = requestlog.active()
            assert rec is not None and eng.stats()["request_log"]
            done = rec.snapshot()
            assert [r["retire"] for r in done] == ["max_tokens", "ok"]
            assert done[0]["ttft_s"] is not None and done[0]["tokens"] == 4
            code, _, _ = requestlog.debug_engine_response("n=4")
            assert code == 200
        finally:
            requestlog.set_active(None)


# -- knobs --------------------------------------------------------------------


class TestEnvKnobs:
    def test_defaults(self, monkeypatch):
        for name in ("SLOTS", "QUEUE", "PREFIX_BLOCKS", "BATCH_SAMPLING"):
            monkeypatch.delenv(f"K8S_TPU_SERVE_{name}", raising=False)
        assert engine_lib.env_slots() == DEFAULT_SLOTS == 4
        assert engine_lib.env_queue() == DEFAULT_QUEUE == 64
        assert engine_lib.env_prefix_blocks() is None
        assert engine_lib.env_batch_sampling() is True
        assert engine_lib.DEFAULT_BLOCK == 16 and MAX_STEP_TOKENS == 4

    def test_overrides_and_garbage(self, monkeypatch):
        monkeypatch.setenv("K8S_TPU_SERVE_SLOTS", "7")
        monkeypatch.setenv("K8S_TPU_SERVE_QUEUE", "3")
        monkeypatch.setenv("K8S_TPU_SERVE_PREFIX_BLOCKS", "12")
        assert (engine_lib.env_slots(), engine_lib.env_queue(),
                engine_lib.env_prefix_blocks()) == (7, 3, 12)
        monkeypatch.setenv("K8S_TPU_SERVE_SLOTS", "banana")
        monkeypatch.setenv("K8S_TPU_SERVE_QUEUE", "-2")
        monkeypatch.setenv("K8S_TPU_SERVE_PREFIX_BLOCKS", "-4")
        assert (engine_lib.env_slots(), engine_lib.env_queue(),
                engine_lib.env_prefix_blocks()) == (DEFAULT_SLOTS,
                                                    DEFAULT_QUEUE, 0)
        for off in ("0", "false", "no", "OFF"):
            monkeypatch.setenv("K8S_TPU_SERVE_BATCH_SAMPLING", off)
            assert engine_lib.env_batch_sampling() is False

    def test_env_sizes_the_engine(self, params, monkeypatch):
        monkeypatch.setenv("K8S_TPU_SERVE_SLOTS", "3")
        monkeypatch.setenv("K8S_TPU_SERVE_QUEUE", "5")
        monkeypatch.setenv("K8S_TPU_SERVE_PREFIX_BLOCKS", "0")
        eng = Engine(configs("default")[1], params[1], device="cpu")
        try:
            st = eng.stats()
            assert (st["slots"], st["queue_limit"], st["pool_blocks"]) == \
                (3, 5, 1 + 3 * 4)
        finally:
            eng.shutdown()

    def test_same_defaults_as_the_reference(self):
        assert (DEFAULT_SLOTS, DEFAULT_QUEUE, engine_lib.DEFAULT_BLOCK,
                MAX_STEP_TOKENS) == (
            jax_engine.DEFAULT_SLOTS, jax_engine.DEFAULT_QUEUE,
            jax_engine.DEFAULT_BLOCK, jax_engine.MAX_STEP_TOKENS)


def test_stats_keys_are_the_references_for_ported_features(make, params):
    """Every stats() key of the reference's that is not a later slice's
    (speculative, disaggregated, spill) is here, with the same meaning."""
    eng = make()
    jeng = jax_engine.Engine(configs("default")[0], params[0], slots=2,
                             queue_limit=32)
    try:
        later = ("spec_", "kv_", "spill_")
        want = {k for k in jeng.stats() if not k.startswith(later)}
    finally:
        jeng.shutdown()
    assert want <= set(eng.stats())
