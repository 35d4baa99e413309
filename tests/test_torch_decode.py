"""The port's generation loop (k8s_tpu_torch/models/decode.py) against
``k8s_tpu.models.decode.generate`` on the CPU.

Greedy tokens must be identical to the reference's (JAX-initialised
parameters through the bridge).  Sampled tokens cannot be compared across
frameworks (threefry and torch's generators give different numbers), so
sampling is held to determinism under one seed, to the top-k mask, and to
``top_k=1`` being the greedy argmax.
"""

import dataclasses

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

NEW = 12


def _pair(**kw):
    cj = dataclasses.replace(jt.tiny_test(), **kw)
    ct = dataclasses.replace(tt.tiny_test(), **kw)
    params = jt.Transformer(cj).init(
        jax.random.PRNGKey(2), jnp.zeros((1, 8), jnp.int32))["params"]
    return cj, ct, params, bridge.params_from_jax(jax.device_get(params))


@pytest.fixture(scope="module")
def base():
    return _pair()


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (1, n)).astype(
        np.int32)


def _greedy_both(cj, ct, params, sd, prompt, eos=None):
    ref = np.asarray(jd.generate(cj, params, prompt, NEW, eos_id=eos))
    out = td.generate(ct, sd, prompt, NEW, eos_id=eos, device="cpu")
    assert out.dtype == torch.long and tuple(out.shape) == ref.shape
    return ref, out.numpy()


@pytest.mark.parametrize("prompt_len", [1, 5, 13])
def test_greedy_tokens_match_reference(base, prompt_len):
    ref, out = _greedy_both(*base, _prompt(prompt_len))
    np.testing.assert_array_equal(out, ref)


def test_greedy_with_eos_freezes_like_reference(base):
    prompt = _prompt(5)
    free, _ = _greedy_both(*base, prompt)
    eos = int(free[0, 2])  # the third emitted token ends the generation
    ref, out = _greedy_both(*base, prompt, eos=eos)
    np.testing.assert_array_equal(out, ref)
    assert out[0, 2] == eos and (out[0, 3:] == 0).all()


@pytest.mark.parametrize("kw", [
    {"kv_cache_dtype": "int8"},
    {"window_size": 8, "use_flash_attention": True, "use_fused_norm": True},
], ids=["int8", "window"])
def test_greedy_matches_reference_on_cache_variants(kw):
    ref, out = _greedy_both(*_pair(**kw), _prompt(13, seed=1))
    np.testing.assert_array_equal(out, ref)


def test_sampling_is_deterministic_under_one_seed(base):
    _, ct, _, sd = base
    prompt = _prompt(6)

    def run(seed):
        return td.generate(ct, sd, prompt, NEW, seed=seed, temperature=0.8,
                           top_k=20, device="cpu")

    a, b = run(7), run(7)
    assert torch.equal(a, b)
    assert ((a >= 0) & (a < ct.vocab_size)).all()


def test_top_k_one_is_greedy(base):
    _, ct, _, sd = base
    prompt = _prompt(6, seed=2)
    greedy = td.generate(ct, sd, prompt, NEW, device="cpu")
    sampled = td.generate(ct, sd, prompt, NEW, seed=3, temperature=1.3,
                          top_k=1, device="cpu")
    assert torch.equal(greedy, sampled)


def test_samples_stay_inside_top_k():
    logits = torch.from_numpy(
        np.random.RandomState(4).standard_normal((64, 50)).astype(np.float32))
    top = torch.topk(logits, 3, dim=-1).indices
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = td.sample_logits(logits, gen, temperature=2.0, top_k=3)
        assert (tok[:, None] == top).any(dim=1).all()
    with pytest.raises(ValueError, match="Generator"):
        td.sample_logits(logits, None, temperature=1.0)
    with pytest.raises(ValueError, match="top_k"):
        td.sample_logits(logits, gen, temperature=1.0, top_k=0)


def test_capacity_error_matches_reference(base):
    cj, ct, params, sd = base
    prompt = _prompt(100)
    with pytest.raises(ValueError, match="exceeds max_seq_len") as ej:
        jd.generate(cj, params, prompt, 30)
    with pytest.raises(ValueError, match="exceeds max_seq_len") as et:
        td.generate(ct, sd, prompt, 30, device="cpu")
    assert str(et.value) == str(ej.value)
    # exactly at the bound is fine: the last token is never fed back
    assert td.generate(ct, sd, prompt, 29, device="cpu").shape == (1, 29)


def test_generate_fn_guards(base):
    _, ct, _, sd = base
    with pytest.raises(ValueError, match="max_new_tokens"):
        td.make_generate_fn(ct, 0)
    other = tt.Transformer(dataclasses.replace(ct, rope_theta=1.0), sd,
                           device="cpu")
    with pytest.raises(ValueError, match="another config"):
        td.make_generate_fn(ct, 2)(other, torch.zeros(1, 3, dtype=torch.long))
