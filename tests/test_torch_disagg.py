"""The port engine's disaggregation seams and spill tier
(k8s_tpu_torch/models/engine.py) against the JAX package's engine on the
CPU, on ``tiny_test`` in f32 with the same parameters
(``bridge.params_from_jax``).

- ``prefill_export`` gives the JAX engine's first token and block chain
  (the tolerance ``tests/test_torch_paged.py`` holds the pool at);
- export then ``submit_prefilled`` gives the port's local tokens for
  greedy, sampled, top-k and speculative requests at a fixed seed, and
  greedy gives the JAX engine's local tokens; a JAX engine's greedy
  export seats on the port engine too;
- an int8 pool migrates bit-exact; a graft never touches donor blocks;
- refusals: receive-side ``PoolExhausted``, block size, manifest, shape,
  int8 against fp content, a generator state of another device type, a
  windowed config; a first-token EOS never migrates;
- dedup (``dedup_have``, ``skip``, ``DedupStale``), ``prefix_index`` and
  fleet fetch (``fetch_prefix`` into ``import_prefix``);
- the same spill traffic on both engines gives the same demotions,
  promotions and prefix hits, and the re-asked answer comes back
  through the promote path unchanged, on an fp and an int8 pool.

Every wait carries a timeout and every engine is shut down."""

from __future__ import annotations

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_tpu.models import engine as jax_engine
from k8s_tpu.models import transformer as jt
from k8s_tpu_torch.models import bridge, kvtier
from k8s_tpu_torch.models import transformer as tt
from k8s_tpu_torch.models.engine import DedupStale, Engine, PoolExhausted

WAIT = 60


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(**kw):
    return (dataclasses.replace(jt.tiny_test(), dtype=jnp.float32, **kw),
            dataclasses.replace(tt.tiny_test(), dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def params():
    cj, _ = configs()
    p = jt.Transformer(cj).init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 5), jnp.int32))["params"]
    return p, bridge.params_from_jax(jax.device_get(p))


@pytest.fixture()
def make(params):
    """``make(jax=False, kv=None, window=None, **engine_kw)``: an engine
    of either package, shut down after the test."""
    built = []

    def build(jax_side=False, kv=None, window=None, **kw):
        extra = {"kv_cache_dtype": kv} if kv else {}
        if window:
            extra.update(window_size=window, prefill_chunk=8)
        cj, ct = configs(**extra)
        kw = {"slots": 2, "queue_limit": 16, **kw}
        eng = jax_engine.Engine(cj, params[0], **kw) if jax_side \
            else Engine(ct, params[1], device="cpu", **kw)
        built.append(eng)
        return eng
    yield build
    for eng in built:
        eng.shutdown()


def prompt_of(n, salt=3):
    return np.asarray([(i * 7 + salt) % 256 for i in range(n)], np.int64)


def seat(dst, exp, max_new, **kw):
    """``submit_prefilled`` of an export on ``dst``."""
    return dst.submit_prefilled(
        exp["ids"], exp["blocks"], first_token=exp["first"],
        key=exp["key"], max_new_tokens=max_new,
        eos_id=kw.get("eos_id"), temperature=kw.get("temperature", 0.0),
        top_k=kw.get("top_k"), speculative=kw.get("speculative", 0),
        block_size=exp["block_size"], timeout=WAIT)


def migrate(src, dst, prompt, max_new, **kw):
    exp = src.prefill_export(prompt, max_new, timeout=WAIT, **kw)
    return exp["tokens"] if exp["done"] else seat(dst, exp, max_new, **kw)


def block_bytes(eng, block):
    return {p: a.copy() for p, a in eng._gather_fn(
        eng._pool, [block]).items()}


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
def test_export_matches_the_jax_engine(make, kv):
    p = prompt_of(37)
    je, te = make(jax_side=True, kv=kv), make(kv=kv)
    jx = je.prefill_export(np.asarray(p, np.int32), 8)
    tx = te.prefill_export(p, 8, timeout=WAIT)
    assert (tx["first"], tx["n_blocks"], tx["block_size"], tx["done"]) == \
        (jx["first"], jx["n_blocks"], jx["block_size"], jx["done"])
    assert set(tx["blocks"]) == set(jx["blocks"])
    for path, want in jx["blocks"].items():
        got = tx["blocks"][path]
        assert got.shape == want.shape and got.dtype == want.dtype, path
        # only the written positions: the last block's tail is stale
        got = got.reshape(-1, *got.shape[2:])[:len(p)]
        want = np.asarray(want).reshape(-1, *want.shape[2:])[:len(p)]
        if got.dtype == np.int8:
            assert np.abs(got.astype(int) - want).max() <= 1, path
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert tx["key"].dtype == np.uint8
    assert tx["key"].size == torch.Generator().get_state().numel()
    assert te.stats()["kv_exports"] == 1
    assert te.stats()["kv_blocks_out"] == tx["n_blocks"] == 3


@pytest.mark.parametrize("kw", [
    {}, {"temperature": 1.0, "seed": 42},
    {"temperature": 0.7, "top_k": 5, "seed": 9},
    {"speculative": 3, "seed": 4}],
    ids=["greedy", "sampled", "top_k", "speculative"])
def test_migrated_tokens_equal_local(make, kw):
    a, b = make(), make()
    p = prompt_of(21)
    local = a.submit(p, 10, timeout=WAIT, **kw)
    assert migrate(a, b, p, 10, **kw) == local
    if not kw:
        je = make(jax_side=True)
        assert local == je.submit(np.asarray(p, np.int32), 10)
    a.debug_check_blocks()
    b.debug_check_blocks()
    assert b.stats()["kv_imports"] == 1
    assert b.stats()["kv_blocks_in"] == 2


def test_jax_greedy_export_seats_on_the_port(make):
    """The reference's manifest (threefry key, ml_dtypes-free f32 blocks)
    seats a greedy request, which never draws, on the port engine."""
    je, te = make(jax_side=True), make()
    p = prompt_of(29, salt=5)
    exp = je.prefill_export(np.asarray(p, np.int32), 9)
    assert exp["key"].dtype == np.uint32
    assert seat(te, exp, 9) == je.submit(np.asarray(p, np.int32), 9)
    with pytest.raises(ValueError, match="generator state"):
        seat(te, exp, 9, temperature=1.0)
    te.debug_check_blocks()


def test_generator_state_of_another_device_refused(make):
    a, b = make(), make()
    exp = a.prefill_export(prompt_of(20), 4, temperature=1.0, timeout=WAIT)
    exp["key"] = np.zeros(16, np.uint8)  # a CUDA generator's state size
    with pytest.raises(ValueError, match="same device type"):
        seat(b, exp, 4, temperature=1.0)
    assert b.stats()["kv_imports"] == 0 and b.stats()["blocks_in_use"] == 0


def test_migrated_prefix_immediately_shareable(make):
    a, b = make(), make()
    p = prompt_of(33, salt=11)
    local = a.submit(p, 6, timeout=WAIT)
    assert migrate(a, b, p, 6) == local
    hits = b.stats()["prefix_hits"]
    assert b.submit(p, 6, timeout=WAIT) == local
    assert b.stats()["prefix_hits"] == hits + 1


def test_first_token_eos_never_migrates(make):
    a = make()
    p = prompt_of(9)
    first = a.submit(p, 1, timeout=WAIT)[0]
    exp = a.prefill_export(p, 4, eos_id=first, timeout=WAIT)
    assert exp["done"] and exp["tokens"] == [first]
    assert exp["n_blocks"] == 0 and exp["blocks"] == {}
    assert a.stats()["kv_blocks_out"] == 0
    a.debug_check_blocks()


def test_int8_pool_migrates_bit_exact(make):
    a, b = make(kv="int8"), make(kv="int8")
    p = prompt_of(25)
    exp = a.prefill_export(p, 8, temperature=1.0, timeout=WAIT)
    k_paths = [pa for pa in exp["blocks"] if pa.endswith("/k")]
    assert k_paths and all(exp["blocks"][pa].dtype == np.int8
                           for pa in k_paths)
    assert any(pa.endswith("k_scale") for pa in exp["blocks"])
    local = a.submit(p, 8, temperature=1.0, timeout=WAIT)
    assert seat(b, exp, 8, temperature=1.0) == local
    # the grafted blocks hold the exported bytes exactly
    table = [n.block for n in b._tree.match(p, len(p) - 1)[0]]
    got = b._gather_fn(b._pool, table)
    for path, arr in exp["blocks"].items():
        assert got[path].tobytes() == arr[:len(table)].tobytes(), path


def test_graft_never_touches_donor_blocks(make):
    a, b = make(), make()
    template = prompt_of(35, salt=23)
    b.submit(template, 6, timeout=WAIT)  # seeds b's tree
    donors = [n.block for n in
              b._tree.match(template, len(template) - 1)[0]]
    assert donors
    before = {d: block_bytes(b, d) for d in donors}
    other = prompt_of(30, salt=41)
    assert migrate(a, b, other, 6) == a.submit(other, 6, timeout=WAIT)
    for d in donors:
        after = block_bytes(b, d)
        for pa in before[d]:
            assert before[d][pa].tobytes() == after[pa].tobytes()
    diverged = np.concatenate([template[:-2], [7, 9]])
    assert b.submit(diverged, 6, timeout=WAIT) == \
        a.submit(diverged, 6, timeout=WAIT)
    b.debug_check_blocks()


def test_receive_side_pool_exhausted(make):
    """A chain that cannot fit even after evicting every unpinned tree
    leaf refuses before queuing; it seats once the blocks free."""
    a = make()
    b = make(slots=1, prefix_blocks=0)
    exp = a.prefill_export(prompt_of(33, salt=5), 8, timeout=WAIT)
    done, out = threading.Event(), {}

    def hog():
        out["t"] = b.submit(prompt_of(100), 28, timeout=WAIT)
        done.set()
    threading.Thread(target=hog, daemon=True).start()
    deadline = time.monotonic() + WAIT
    while b.stats()["blocks_in_use"] < 7 and time.monotonic() < deadline:
        time.sleep(0.002)
    with pytest.raises(PoolExhausted) as ei:
        seat(b, exp, 8)
    assert ei.value.needed > ei.value.available
    assert done.wait(WAIT)
    assert seat(b, exp, 8) == a.submit(prompt_of(33, salt=5), 8,
                                       timeout=WAIT)
    b.debug_check_blocks()


@pytest.mark.parametrize("breakage,match", [
    ("block_size", "block_size"), ("manifest", "manifest"),
    ("shape", "shape")])
def test_import_refusals(make, breakage, match):
    a, b = make(), make()
    exp = a.prefill_export(prompt_of(20), 4, timeout=WAIT)
    blocks = dict(exp["blocks"])
    victim = next(iter(blocks))
    bs = exp["block_size"]
    if breakage == "block_size":
        bs *= 2
    elif breakage == "manifest":
        del blocks[victim]
    else:
        blocks[victim] = blocks[victim][:, :-1]
    with pytest.raises(ValueError, match=match):
        b.submit_prefilled(exp["ids"], blocks, first_token=exp["first"],
                           key=exp["key"], max_new_tokens=4, block_size=bs,
                           timeout=WAIT)
    assert b.stats()["blocks_in_use"] == 0


def test_int8_pool_refuses_fp_content(make):
    a, b = make(kv="int8"), make(kv="int8")
    exp = a.prefill_export(prompt_of(20), 4, timeout=WAIT)
    exp["blocks"] = {pa: (arr.astype(np.float32) if pa.endswith("/k")
                          else arr) for pa, arr in exp["blocks"].items()}
    with pytest.raises(ValueError, match="int8"):
        seat(b, exp, 4)


def test_windowed_engine_refuses_disagg(make):
    eng = make(window=16, slots=1)
    with pytest.raises(ValueError, match="paged"):
        eng.prefill_export(prompt_of(10), 4)
    with pytest.raises(ValueError, match="paged"):
        eng.submit_prefilled(prompt_of(10), {}, first_token=1,
                             key=np.zeros(2, np.uint32), max_new_tokens=4)
    assert not eng.disagg_capable


def test_dedup_skip_and_stale(make):
    a, b = make(), make()
    p = prompt_of(40, salt=13)
    local = a.submit(p, 6, timeout=WAIT)
    assert migrate(a, b, p, 6) == local
    fps = kvtier.chain_fingerprints(p, 16, max_blocks=(len(p) - 1) // 16)
    assert b.dedup_have(fps) == 2 == len(fps)
    assert set(fps) <= set(b.prefix_index())
    exp = a.prefill_export(p, 6, timeout=WAIT)
    shipped = {pa: arr[2:] for pa, arr in exp["blocks"].items()}
    toks = b.submit_prefilled(exp["ids"], shipped, first_token=exp["first"],
                              key=exp["key"], max_new_tokens=6, skip=2,
                              timeout=WAIT)
    assert toks == local
    assert b.stats()["kv_blocks_deduped"] == 2
    # a promise the receiver cannot keep
    c = make()
    with pytest.raises(DedupStale):
        c.submit_prefilled(exp["ids"], shipped, first_token=exp["first"],
                           key=exp["key"], max_new_tokens=6, skip=2,
                           timeout=WAIT)
    with pytest.raises(ValueError, match="out of range"):
        c.submit_prefilled(exp["ids"], {pa: arr[3:] for pa, arr
                                        in exp["blocks"].items()},
                           first_token=exp["first"], key=exp["key"],
                           max_new_tokens=6, skip=3, timeout=WAIT)
    for e in (a, b, c):
        e.debug_check_blocks()


def test_fetch_prefix_into_import_prefix(make):
    """A holder serves a prompt's cached chain (tree blocks, extended from
    the spill tier), and a requester grafts it and prefills only the
    tail; both engines' blocks stay consistent."""
    holder = make(slots=1, block_size=8, prefix_blocks=6, spill_mb=1)
    req = make()
    p = prompt_of(45, salt=17)
    want = holder.submit(p, 5, timeout=WAIT)
    # push the last 3 of p's 5 tree blocks into the spill tier
    for n, salt in ((60, 50), (60, 51), (48, 52)):
        holder.submit(prompt_of(n, salt=salt), 1, timeout=WAIT)
    st = holder.stats()
    assert st["spill_demotions"] == 3
    assert len(holder._tree.match(p, len(p) - 1)[0]) == 2
    got = holder.fetch_prefix(p, timeout=WAIT)
    assert got["n_blocks"] == 5 and got["block_size"] == 8
    # the spill-extended rows are the bytes demoted (f32 via int8)
    assert all(a.shape[0] == 5 for a in got["blocks"].values())
    assert holder.stats()["spill_promotions"] == st["spill_promotions"]
    assert holder.fetch_prefix(prompt_of(45, salt=99), timeout=WAIT) is None
    # the requester uses 16-token blocks: fetch from one of its own kind
    twin = make()
    twin.submit(p, 5, timeout=WAIT)
    man = twin.fetch_prefix(p, timeout=WAIT)
    assert man["n_blocks"] == 2
    assert req.import_prefix(p, man["blocks"], man["n_blocks"],
                             timeout=WAIT) == 2
    assert req.stats()["kv_prefix_fetched"] == 2
    assert req.submit(p, 5, timeout=WAIT) == want
    assert req.stats()["prefix_tokens_saved"] == 2 * 16  # the tail prefills
    for e in (holder, req, twin):
        e.debug_check_blocks()


def _spill_traffic(eng, jax_side):
    """One fixed request sequence through a small pool: A, a flood of
    distinct prompts that demotes A's chain, A again."""
    cast = (lambda x: np.asarray(x, np.int32)) if jax_side else (lambda x: x)
    kw = {} if jax_side else {"timeout": WAIT}
    a = prompt_of(30, salt=1)
    first = eng.submit(cast(a), 5, **kw)
    for s in range(6):
        eng.submit(cast(prompt_of(40, salt=20 + s)), 2, **kw)
    mid = eng.stats()
    again = eng.submit(cast(a), 5, **kw)
    st = eng.stats()
    return first, again, {k: (mid[k], st[k]) for k in (
        "spill_demotions", "spill_promotions", "prefix_hits",
        "tree_evictions", "spill_blocks", "spill_bytes")}


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
def test_spill_counters_equal_the_jax_engines(make, kv):
    kw = dict(slots=1, block_size=8, prefix_blocks=4, spill_mb=1, kv=kv)
    jf, ja, jst = _spill_traffic(make(jax_side=True, **kw), True)
    te = make(**kw)
    tf, ta, tst = _spill_traffic(te, False)
    assert tst == jst
    assert tst["spill_promotions"][1] > tst["spill_promotions"][0]
    assert tst["spill_demotions"][0] >= 3  # A's whole chain demoted
    assert tf == jf and ta == ja
    assert ta == tf  # the promoted chain answers as before
    te.debug_check_blocks()
