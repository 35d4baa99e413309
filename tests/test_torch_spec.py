"""The port's speculative decoding (k8s_tpu_torch/models/decode.py)
against ``k8s_tpu.models.decode`` on the CPU.

Greedy speculative tokens and model-call counts must be the reference's
(JAX-initialised parameters through ``bridge.params_from_jax``) and the
port's vanilla greedy tokens, on the tiny f32 model with grouped-query
attention (4 heads over 2 kv heads): draft_k 2, 3 and 4, EOS, the int8
cache, a windowed ring with ``prefill_chunk >= draft_k``, and the
capacity edge.  The building blocks (``lookup_draft_host``,
``spec_accept_greedy``) must equal the reference's on the same inputs.
Sampled speculation cannot be compared across frameworks (threefry and
torch's generators differ), so ``spec_accept_sampled`` is held to the
exact sampling distribution: at V = 8 the first emitted token's
frequencies over 4000 generator seeds must lie within a total-variation
distance of 0.05 of ``softmax(x)`` (the expected distance of a
4000-sample empirical of 8 outcomes is ~0.016).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_tpu.models import decode as jd
from k8s_tpu.models import transformer as jt
from k8s_tpu_torch.models import bridge
from k8s_tpu_torch.models import decode as td
from k8s_tpu_torch.models import transformer as tt

SHAPE = dict(vocab_size=61, hidden=32, ffn_hidden=64, layers=2, heads=4,
             kv_heads=2, max_seq_len=64, remat=False)


def configs(**kw):
    return (jt.TransformerConfig(dtype=jnp.float32, **{**SHAPE, **kw}),
            tt.TransformerConfig(dtype=torch.float32, **{**SHAPE, **kw}))


@pytest.fixture(scope="module")
def params():
    cj = configs()[0]
    p = jt.Transformer(cj).init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 5), jnp.int32))["params"]
    return p, bridge.params_from_jax(jax.device_get(p))


def model(ct, sd):
    return tt.Transformer(ct, sd, device="cpu")


def spec_both(params, prompt, steps, draft_k, eos=None, **kw):
    """(reference tokens, reference stats, port tokens, port stats)."""
    cj, ct = configs(**kw)
    ref, rst = jd.make_speculative_generate_fn(
        cj, steps, draft_k=draft_k, eos_id=eos, return_stats=True)(
        params[0], jnp.asarray(prompt, jnp.int32))
    out, st = td.make_speculative_generate_fn(
        ct, steps, draft_k=draft_k, eos_id=eos, return_stats=True)(
        model(ct, params[1]), torch.as_tensor(np.asarray(prompt),
                                              dtype=torch.long))
    return np.asarray(ref), rst, out.numpy(), st


def vanilla(params, prompt, steps, eos=None, **kw):
    ct = configs(**kw)[1]
    return td.make_generate_fn(ct, steps, eos_id=eos)(
        model(ct, params[1]), torch.as_tensor(np.asarray(prompt),
                                              dtype=torch.long)).numpy()


RANDOM = (np.arange(14, dtype=np.int32).reshape(2, 7) * 5) % 61
REPETITIVE = np.asarray([[7, 11, 7, 11, 7, 11, 7, 11],
                         [3, 3, 3, 3, 3, 3, 3, 3]], np.int32)


# -- building blocks -----------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_lookup_draft_host_is_the_references(seed):
    rs = np.random.RandomState(seed)
    for _ in range(20):
        # a small alphabet so 2-grams recur
        ctx = rs.randint(0, 1 + seed, int(rs.randint(2, 30))).tolist()
        for k in (2, 3, 4, 6):
            assert td.lookup_draft_host(ctx, k) == \
                jd.lookup_draft_host(ctx, k), (ctx, k)
    with pytest.raises(ValueError, match="context >= 2"):
        td.lookup_draft_host([5], 4)


@pytest.mark.parametrize("draft_k", [2, 3, 4])
def test_spec_accept_greedy_is_the_references(draft_k):
    rs = np.random.RandomState(draft_k)
    logits = rs.standard_normal((16, draft_k, 9)).astype(np.float32)
    greedy = logits.argmax(-1)
    # drafts that match the argmax for a random prefix, then may miss
    draft = greedy[:, :-1].copy()
    cut = rs.randint(0, draft_k, 16)
    for b in range(16):
        draft[b, cut[b]:] = rs.randint(0, 9, draft_k - 1 - cut[b])
    acc_j, bonus_j = jd.spec_accept_greedy(jnp.asarray(logits),
                                           jnp.asarray(draft, jnp.int32))
    acc_t, bonus_t = td.spec_accept_greedy(torch.from_numpy(logits),
                                           torch.from_numpy(draft).long())
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    np.testing.assert_array_equal(bonus_t.numpy(), np.asarray(bonus_j))


def test_capacity_message_is_the_references():
    cj, ct = configs(max_seq_len=16)
    with pytest.raises(ValueError, match="headroom") as ej:
        jd.check_speculative_capacity(cj, 5, 10, 4)
    with pytest.raises(ValueError, match="headroom") as et:
        td.check_speculative_capacity(ct, 5, 10, 4)
    assert str(et.value) == str(ej.value)
    td.check_speculative_capacity(ct, 4, 10, 4)
    td.check_speculative_capacity(configs(window_size=4)[1], 50, 50, 4)


# -- greedy: the reference's tokens and calls, and vanilla greedy's ------------


@pytest.mark.parametrize("draft_k", [2, 3, 4])
@pytest.mark.parametrize("prompt", [RANDOM, REPETITIVE],
                         ids=["random", "repetitive"])
def test_greedy_spec_is_the_references_and_vanilla(params, prompt, draft_k):
    ref, rst, out, st = spec_both(params, prompt, 16, draft_k)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, vanilla(params, prompt, 16))
    assert st["model_calls"] == int(rst["model_calls"])
    assert st["tokens_per_call"] == pytest.approx(
        float(rst["tokens_per_call"]), rel=1e-6)


def test_repetitive_prompt_needs_fewer_calls(params):
    ct = configs()[1]
    _, st = td.make_speculative_generate_fn(
        ct, 16, draft_k=4, return_stats=True)(
        model(ct, params[1]), torch.as_tensor(REPETITIVE, dtype=torch.long))
    assert st["tokens_per_call"] > 1.0 and st["model_calls"] < 17, st


def test_eos_truncation_is_the_references(params):
    prompt = (np.arange(10, dtype=np.int32).reshape(2, 5) * 7) % 61
    eos = int(vanilla(params, prompt, 12)[0, 3])
    ref, rst, out, st = spec_both(params, prompt, 12, 3, eos=eos)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, vanilla(params, prompt, 12, eos=eos))
    assert eos in out[0].tolist()
    assert st["model_calls"] == int(rst["model_calls"])


def test_int8_cache_is_the_references(params):
    prompt = (np.arange(14, dtype=np.int32).reshape(2, 7) * 9) % 61
    ref, _, out, _ = spec_both(params, prompt, 8, 4,
                               kv_cache_dtype="int8")
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        out, vanilla(params, prompt, 8, kv_cache_dtype="int8"))


@pytest.mark.parametrize("kw,steps,draft_k", [
    (dict(window_size=8, prefill_chunk=4), 20, 4),
    (dict(window_size=6, prefill_chunk=3, max_seq_len=16), 16, 3),
    (dict(window_size=8, prefill_chunk=4, kv_cache_dtype="int8"), 12, 4),
], ids=["ring_wraps", "past_max_seq_len", "ring_int8"])
def test_windowed_ring_is_the_references(params, kw, steps, draft_k):
    prompt = (np.arange(12, dtype=np.int32).reshape(2, 6) * 11) % 61
    ref, _, out, _ = spec_both(params, prompt, steps, draft_k, **kw)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, vanilla(params, prompt, steps, **kw))


def test_capacity_edge(params):
    """Lp = 5 would write the final chunk's last draft at position
    max_seq_len and evict prompt token 0 mid-call: refused, with the
    reference's message.  Lp = 4 is the largest admissible prompt, and
    stays exact at the edge."""
    cj, ct = configs(max_seq_len=16)
    jfn = jd.make_speculative_generate_fn(cj, 10, draft_k=4)
    tfn = td.make_speculative_generate_fn(ct, 10, draft_k=4)
    m = model(ct, params[1])
    for lp in (6, 5):
        with pytest.raises(ValueError, match="headroom") as ej:
            jfn(params[0], jnp.zeros((1, lp), jnp.int32))
        with pytest.raises(ValueError, match="headroom") as et:
            tfn(m, torch.zeros((1, lp), dtype=torch.long))
        assert str(et.value) == str(ej.value)
    p4 = (np.arange(8, dtype=np.int32).reshape(2, 4) * 7) % 61
    out = tfn(m, torch.as_tensor(p4, dtype=torch.long)).numpy()
    np.testing.assert_array_equal(out, np.asarray(jfn(params[0], p4)))
    np.testing.assert_array_equal(out, vanilla(params, p4, 10,
                                               max_seq_len=16))


def test_refusals_are_the_references(params):
    ct = configs()[1]
    cases = [
        (dict(config=configs(window_size=8)[1], max_new_tokens=4),
         "sliding-window"),
        (dict(config=configs(window_size=8, prefill_chunk=2)[1],
              max_new_tokens=8, draft_k=4), "prefill_chunk >= draft_k"),
        (dict(config=ct, max_new_tokens=4, draft_k=1), "draft_k"),
        (dict(config=ct, max_new_tokens=0), "max_new_tokens"),
        (dict(config=ct, max_new_tokens=4, temperature=-1.0),
         "temperature"),
        (dict(config=ct, max_new_tokens=4, top_k=5), "top_k"),
        (dict(config=ct, max_new_tokens=4, temperature=1.0, top_k=0),
         "top_k"),
    ]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            td.make_speculative_generate_fn(**kw)
    m = model(ct, params[1])
    with pytest.raises(ValueError, match="prompt_len >= 2"):
        td.make_speculative_generate_fn(ct, 4)(
            m, torch.zeros((1, 1), dtype=torch.long))
    with pytest.raises(ValueError, match="rng"):
        td.make_speculative_generate_fn(ct, 4, temperature=0.8)(
            m, torch.zeros((1, 3), dtype=torch.long))
    with pytest.raises(ValueError, match="another config"):
        td.make_speculative_generate_fn(configs(max_seq_len=32)[1], 4)(
            m, torch.zeros((1, 3), dtype=torch.long))


def test_cached_speculative_fn_reuses_the_build():
    ct = configs()[1]
    a = td.cached_speculative_fn(ct, 8, draft_k=3)
    assert td.cached_speculative_fn(ct, 8, draft_k=3) is a
    assert td.cached_speculative_fn(ct, 8, draft_k=4) is not a


# -- sampled: the exact distribution, the draw schedule, the support ----------


def test_sampled_acceptance_is_the_sampling_distribution():
    """At V = 8, over 4000 generator seeds: the first emitted token
    (draft[0] if accepted, else the residual draw) is distributed as
    softmax(x[0]); given draft[0] accepted, the second as softmax(x[1]).
    TV bound 0.05 each (expected ~0.016 and ~0.025)."""
    V, N = 8, 4000
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.standard_normal((1, 3, V)).astype(np.float32))
    p = torch.softmax(x[0], dim=-1).numpy()
    draft = torch.tensor([[int(p[0].argmax()), int(p[1].argmax())]])
    first, second = np.zeros(V), np.zeros(V)
    # thousands of tiny calls: one intra-op thread, or a loaded host's
    # thread barriers cost more than the arithmetic
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for seed in range(N):
            gen = torch.Generator().manual_seed(seed)
            acc, bonus = td.spec_accept_sampled(x, draft, gen)
            acc, bonus = int(acc[0]), int(bonus[0])
            first[int(draft[0, 0]) if acc >= 1 else bonus] += 1
            if acc >= 1:
                second[int(draft[0, 1]) if acc >= 2 else bonus] += 1
    finally:
        torch.set_num_threads(threads)
    tv1 = 0.5 * np.abs(first / first.sum() - p[0]).sum()
    tv2 = 0.5 * np.abs(second / second.sum() - p[1]).sum()
    assert tv1 < 0.05 and tv2 < 0.05, (tv1, tv2)
    assert first.sum() == N and second.sum() > N / 4


def test_sampled_draw_schedule():
    """One verify draws torch.rand((B, K-1)) then torch.rand((B, V))
    from the generator, in that order, and nothing else."""
    x = torch.from_numpy(np.random.RandomState(1).standard_normal(
        (2, 4, 8)).astype(np.float32))
    draft = torch.tensor([[1, 2, 3], [4, 5, 6]])
    a = torch.Generator().manual_seed(3)
    td.spec_accept_sampled(x, draft, a)
    b = torch.Generator().manual_seed(3)
    torch.rand((2, 3), generator=b)
    torch.rand((2, 8), generator=b)
    assert torch.equal(torch.rand(5, generator=a), torch.rand(5, generator=b))


def test_sampled_spec_is_seeded_and_respects_top_k(params):
    ct = configs()[1]
    m = model(ct, params[1])
    prompt = torch.as_tensor((np.arange(10).reshape(2, 5) * 7) % 61)
    fn = td.make_speculative_generate_fn(ct, 8, draft_k=3, temperature=0.8)

    def run(seed):
        return fn(m, prompt, torch.Generator().manual_seed(seed))
    assert torch.equal(run(3), run(3)) and not torch.equal(run(3), run(4))
    # the first emitted token's context is the prompt for every row, so
    # under top_k=2 it must come from the prefix distribution's top 2
    base = torch.tensor([[3, 17, 41, 8, 25]])
    with torch.inference_mode():
        top2 = set(torch.topk(m(base)[0, -1], 2).indices.tolist())
    fn = td.make_speculative_generate_fn(ct, 2, draft_k=3, temperature=1.0,
                                         top_k=2)
    out = fn(m, base.repeat(256, 1), torch.Generator().manual_seed(0))
    assert set(out[:, 0].tolist()) <= top2


def test_spec_verify_rows_is_the_exclusive_lanes_math():
    """Row b of a mixed-width verify equals the exclusive lane's batch-1
    acceptance on that row with the same generator seed, and width-1 rows
    equal sample_logits_rows."""
    V, W = 11, 4
    rs = np.random.RandomState(5)
    logits = torch.from_numpy(rs.standard_normal((4, W, V)).astype(
        np.float32))
    chunk = torch.from_numpy(rs.randint(0, V, (4, W)))
    temps, topks, widths = [0.0, 0.9, 0.0, 1.2], [0, 3, 0, 0], [W, W, 1, 1]
    gens = [torch.Generator().manual_seed(s) for s in range(4)]
    emit, n = td.spec_verify_rows(logits, chunk, gens, temps, topks, widths)
    acc, bonus = td.spec_accept_greedy(logits[:1], chunk[:1, 1:])
    assert int(n[0]) == int(acc[0]) + 1
    assert emit[0, :int(n[0])].tolist() == \
        chunk[0, 1:1 + int(acc[0])].tolist() + [int(bonus[0])]
    x = td._process_logits(logits[1:2], 0.9, 3)
    acc, bonus = td.spec_accept_sampled(x, chunk[1:2, 1:],
                                        torch.Generator().manual_seed(1))
    assert emit[1, :int(n[1])].tolist() == \
        chunk[1, 1:1 + int(acc[0])].tolist() + [int(bonus[0])]
    rows = td.sample_logits_rows(
        logits[2:, 0], [None, torch.Generator().manual_seed(3)],
        temps[2:], topks[2:])
    assert n[2:].tolist() == [1, 1] and emit[2:, 0].tolist() == \
        rows.tolist()


def test_prompt_shapes_reach_the_model_unchanged(params):
    """A batch of one and a batch of three give the same row-0 tokens."""
    ct = configs()[1]
    m = model(ct, params[1])
    fn = td.make_speculative_generate_fn(ct, 10, draft_k=3)
    three = torch.as_tensor(np.stack([RANDOM[0], RANDOM[1], RANDOM[0]]),
                            dtype=torch.long)
    out3 = fn(m, three)
    assert torch.equal(out3[0], fn(m, three[:1])[0])
    assert torch.equal(out3[0], out3[2])
