"""The port's beam search and chunked prefill
(k8s_tpu_torch/models/decode.py) against ``k8s_tpu.models.decode`` on
the CPU, on the tiny f32 model with grouped-query attention (4 heads over
2 kv heads) and JAX-initialised parameters carried by
``bridge.params_from_jax``.

Beam tokens must be the reference's and its scores within 1e-4
(absolute and relative): beam 1 against greedy (dense, windowed and int8
caches, the last proving the scales reorder with their vectors), a beam
wider than the vocabulary, EOS freezing and the length penalty; a beam
wide enough never to prune must find the brute-force argmax.  Chunked
prefill must give the reference's chunked tokens and the port's
unchunked ones, with ``Lp % C`` zero and not, on full, windowed and
int8 caches.
"""

from __future__ import annotations

import itertools

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
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

SHAPE = dict(vocab_size=61, hidden=32, ffn_hidden=64, layers=2, heads=4,
             kv_heads=2, max_seq_len=64, remat=False)
TOL = dict(rtol=1e-4, atol=1e-4)


def configs(**kw):
    return (jt.TransformerConfig(dtype=jnp.float32, **{**SHAPE, **kw}),
            tt.TransformerConfig(dtype=torch.float32, **{**SHAPE, **kw}))


def jax_params(**kw):
    p = jt.Transformer(configs(**kw)[0]).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 5), jnp.int32))["params"]
    return p, bridge.params_from_jax(jax.device_get(p))


@pytest.fixture(scope="module")
def params():
    return jax_params()


def prompt_of(b, n, mul, vocab=61):
    return (np.arange(b * n, dtype=np.int32).reshape(b, n) * mul) % vocab


def beam_both(params, prompt, steps, beam, eos=None, pad=0, alpha=0.0,
              **kw):
    cj, ct = configs(**kw)
    ref, rs = jd.make_beam_generate_fn(
        cj, steps, beam_size=beam, eos_id=eos, pad_id=pad,
        length_penalty=alpha)(params[0], jnp.asarray(prompt))
    out, sc = td.make_beam_generate_fn(
        ct, steps, beam_size=beam, eos_id=eos, pad_id=pad,
        length_penalty=alpha)(tt.Transformer(ct, params[1], device="cpu"),
                              torch.as_tensor(prompt, dtype=torch.long))
    return np.asarray(ref), np.asarray(rs), out.numpy(), sc.numpy()


def port_greedy(params, prompt, steps, **kw):
    ct = configs(**kw)[1]
    return td.make_generate_fn(ct, steps)(
        tt.Transformer(ct, params[1], device="cpu"),
        torch.as_tensor(prompt, dtype=torch.long)).numpy()


def seq_logprob(ct, sd, prompt, cont):
    """Teacher-forced log-prob of ``cont`` [B, T] after ``prompt`` on the
    port's model: the scoring oracle for beam search."""
    m = tt.Transformer(ct, sd, device="cpu")
    seq = torch.cat([torch.as_tensor(prompt, dtype=torch.long),
                     torch.as_tensor(cont, dtype=torch.long)], dim=1)
    with torch.inference_mode():
        lp = torch.log_softmax(m(seq).float(), dim=-1)
    Lp, T = prompt.shape[1], cont.shape[1]
    return np.asarray([sum(float(lp[b, Lp - 1 + t, int(cont[b, t])])
                           for t in range(T)) for b in range(len(cont))])


# -- beam search ----------------------------------------------------------------


def test_beam_is_the_references_and_scores_the_sequence(params):
    prompt = prompt_of(2, 5, 3)
    ref, rs, out, sc = beam_both(params, prompt, 5, 4)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_allclose(sc, rs, **TOL)
    np.testing.assert_allclose(
        sc, seq_logprob(configs()[1], params[1], prompt, out), **TOL)


@pytest.mark.parametrize("kw", [{}, dict(window_size=4),
                                dict(kv_cache_dtype="int8")],
                         ids=["dense", "window", "int8"])
def test_beam1_is_greedy(params, kw):
    """Beam 1 equals greedy on the same cache: for int8 an exact
    same-machinery identity that proves the scale leaves reorder with
    their vectors through the beam gather."""
    prompt = prompt_of(2, 5, 7)
    ref, rs, out, sc = beam_both(params, prompt, 6, 1, **kw)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_allclose(sc, rs, **TOL)
    np.testing.assert_array_equal(out, port_greedy(params, prompt, 6, **kw))


def test_int8_beam_is_the_references(params):
    ref, rs, out, sc = beam_both(params, prompt_of(2, 5, 3), 6, 4,
                                 kv_cache_dtype="int8")
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_allclose(sc, rs, **TOL)


def test_beam_wider_than_vocab():
    p = jax_params(vocab_size=7)
    ref, rs, out, sc = beam_both(p, prompt_of(2, 5, 1, 7), 4, 12,
                                 vocab_size=7)
    assert out.shape == (2, 4) and np.isfinite(sc).all()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_allclose(sc, rs, **TOL)


def test_beam_eos_freezes_to_pad(params):
    prompt = prompt_of(2, 5, 7)
    probe, _, _, _ = beam_both(params, prompt, 8, 4)
    eos = int(probe[0, 3])  # a token the winning beam actually emits
    ref, rs, out, sc = beam_both(params, prompt, 8, 4, eos=eos, pad=60)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_allclose(sc, rs, **TOL)
    assert any(eos in row.tolist() for row in out), out
    for row in out.tolist():
        if eos in row:
            assert all(x == 60 for x in row[row.index(eos) + 1:]), row


def test_length_penalty(params):
    """No EOS: every beam has length T, so the score is the winner's raw
    log-prob over ((5 + T) / 6) ** alpha."""
    prompt, T, alpha = prompt_of(2, 5, 11), 5, 0.8
    ref, rs, out, sc = beam_both(params, prompt, T, 4, alpha=alpha)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_allclose(sc, rs, **TOL)
    raw = seq_logprob(configs()[1], params[1], prompt, out)
    np.testing.assert_allclose(sc, raw / (((5.0 + T) / 6.0) ** alpha),
                               **TOL)


def test_wide_beam_is_exact_search():
    """A beam of V^(T-1) never prunes, so it returns the brute-force
    argmax continuation."""
    V, T = 5, 3
    ct = configs(vocab_size=V)[1]
    sd = bridge.init_params(ct, seed=1, device="cpu")
    prompt = np.arange(4, dtype=np.int32).reshape(1, 4) % V
    toks, score = td.make_beam_generate_fn(ct, T, beam_size=V ** (T - 1))(
        tt.Transformer(ct, sd, device="cpu"),
        torch.as_tensor(prompt, dtype=torch.long))
    cands = np.asarray(list(itertools.product(range(V), repeat=T)))
    lps = seq_logprob(ct, sd, np.repeat(prompt, len(cands), 0), cands)
    assert tuple(toks[0].tolist()) == tuple(cands[lps.argmax()])
    np.testing.assert_allclose(float(score[0]), lps.max(), **TOL)


def test_beam_guards(params):
    ct = configs()[1]
    with pytest.raises(ValueError, match="beam_size"):
        td.make_beam_generate_fn(ct, 4, beam_size=0)
    with pytest.raises(ValueError, match="max_new_tokens"):
        td.make_beam_generate_fn(ct, 0, beam_size=2)
    m = tt.Transformer(ct, params[1], device="cpu")
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        td.make_beam_generate_fn(ct, 30, beam_size=2)(
            m, torch.zeros((1, 40), dtype=torch.long))


# -- chunked prefill ------------------------------------------------------------


def chunked_both(params, prompt, steps, **kw):
    """(reference chunked, port chunked, port unchunked) greedy tokens."""
    cj, ct = configs(**kw)
    ref = jd.make_generate_fn(cj, steps, chunked_prefill=True)(
        params[0], jnp.asarray(prompt), jax.random.PRNGKey(0))
    m = tt.Transformer(ct, params[1], device="cpu")
    p = torch.as_tensor(prompt, dtype=torch.long)
    out = td.make_generate_fn(ct, steps, chunked_prefill=True)(m, p)
    plain = td.make_generate_fn(ct, steps)(m, p)
    return np.asarray(ref), out.numpy(), plain.numpy()


@pytest.mark.parametrize("kw,lp,mul", [
    (dict(prefill_chunk=4), 12, 7),             # Lp % C == 0
    (dict(prefill_chunk=4), 10, 7),             # 2 (remainder) + 4 + 4
    (dict(prefill_chunk=8), 3, 5),              # shorter than one chunk
    (dict(window_size=6, prefill_chunk=4), 10, 11),
    (dict(window_size=24, prefill_chunk=8, kv_cache_dtype="int8"), 10, 13),
], ids=["divides", "remainder", "short", "window", "window_int8"])
def test_chunked_prefill_is_the_references_and_unchunked(params, kw, lp,
                                                         mul):
    ref, out, plain = chunked_both(params, prompt_of(2, lp, mul), 6, **kw)
    np.testing.assert_array_equal(out, ref)
    if "kv_cache_dtype" not in kw:
        # an int8 chunked prefill attends the quantized K/V of its own
        # earlier chunks, the unchunked one the exact prompt
        np.testing.assert_array_equal(out, plain)


def test_rolling_prefill_wraps_past_max_seq_len(params):
    """A prompt many windows long, past max_seq_len, streams through a
    5-slot ring (window 4 + chunk 2 - 1), wrapping it 8 times."""
    ref, out, plain = chunked_both(
        params, prompt_of(2, 40, 13), 6, window_size=4, prefill_chunk=2,
        max_seq_len=16)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, plain)


def test_chunked_prefill_guard():
    with pytest.raises(ValueError, match="prefill_chunk >= 1"):
        td.make_generate_fn(configs(prefill_chunk=0)[1], 4,
                            chunked_prefill=True)
