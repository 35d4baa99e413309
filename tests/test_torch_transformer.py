"""The port's Transformer (k8s_tpu_torch/models/transformer.py) against
the JAX model on the CPU, through the parameter bridge.

JAX-initialised parameters go through ``bridge.params_from_jax``; token
inputs come from numpy with a seed.  Logits of the train and prefill
passes and of every decode-mode step must agree at 1e-4 in f32 (the
reference's kernels run in Pallas interpret mode, the port's wrappers take
their plain versions), and at test_ops.py's 5e-2 in bf16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_tpu.models import paged as jax_paged
from k8s_tpu.models import transformer as jt
from k8s_tpu_torch.models import bridge
from k8s_tpu_torch.models import paged as tpaged
from k8s_tpu_torch.models import transformer as tt
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

TOL = 1e-4


def _configs(**kw):
    """The same configuration in both frameworks."""
    jdt = kw.pop("dtype", "float32")
    return (dataclasses.replace(jt.tiny_test(), dtype=getattr(jnp, jdt), **kw),
            dataclasses.replace(tt.tiny_test(), dtype=getattr(torch, jdt),
                                **kw))


def _tokens(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.int32)


def _jax_params(cfg):
    return jt.Transformer(cfg).init(jax.random.PRNGKey(1),
                                    jnp.zeros((1, 8), jnp.int32))["params"]


def _pair(**kw):
    cj, ct = _configs(**kw)
    params = _jax_params(cj)
    model = tt.Transformer(ct, bridge.params_from_jax(jax.device_get(params)),
                           device="cpu")
    return cj, params, model


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def _check_all_modes(cj, params, model, prompt, steps=3, tol=TOL):
    jm = jt.Transformer(cj)
    train = jax.jit(lambda p, t: jm.apply({"params": p}, t))
    prefill = jax.jit(lambda p, t: jm.apply({"params": p}, t, mode="prefill",
                                            mutable=["cache"]))
    decode = jax.jit(lambda p, c, t, pos: jm.apply(
        {"params": p, "cache": c}, t, positions=pos, mode="decode",
        mutable=["cache"]))
    np.testing.assert_allclose(
        model(_t(prompt)).numpy(),
        np.asarray(train(params, jnp.asarray(prompt))), atol=tol, rtol=tol)
    lj, varz = prefill(params, jnp.asarray(prompt))
    cache = model.new_cache()
    lt = model(_t(prompt), mode="prefill", cache=cache)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=tol, rtol=tol)
    B, L = prompt.shape
    for step in range(steps):
        tok = _tokens((B, 1), seed=10 + step)
        pos = np.full((B, 1), L + step, np.int32)
        lj, varz = decode(params, varz["cache"], jnp.asarray(tok),
                          jnp.asarray(pos))
        lt = model(_t(tok), positions=_t(pos), mode="decode", cache=cache)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=tol,
                                   rtol=tol)
    return cache, varz["cache"]


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_logits_match_reference(kernels, kv_heads):
    cj, params, model = _pair(use_flash_attention=kernels,
                              use_fused_norm=kernels, kv_heads=kv_heads)
    _check_all_modes(cj, params, model, _tokens((2, 13)))


def test_windowed_ring_cache_matches_reference():
    # a prompt longer than the window wraps the ring buffer during prefill
    cj, params, model = _pair(window_size=8, use_flash_attention=True,
                              use_fused_norm=True)
    cache, _ = _check_all_modes(cj, params, model, _tokens((1, 13), 3),
                                steps=6)
    assert cache[0]["k"].shape[1] == 8


def test_int8_cache_matches_reference():
    cj, params, model = _pair(kv_cache_dtype="int8")
    cache, jcache = _check_all_modes(cj, params, model, _tokens((2, 11), 4))
    # the stored cache agrees: the projections feeding quantize_kv differ
    # in the last f32 bit between frameworks, so a code may sit one step
    # over a rounding boundary (quantize_kv itself is bit-identical below)
    layer = jcache["layer_0"]["attn"]
    assert cache[0]["k"].dtype == torch.int8
    for name in ("k", "v"):
        diff = cache[0][name].int().numpy() - np.asarray(layer[name], np.int32)
        assert np.abs(diff).max() <= 1
        np.testing.assert_allclose(cache[0][name + "_scale"].numpy(),
                                   np.asarray(layer[name + "_scale"]),
                                   rtol=1e-6)
    np.testing.assert_array_equal(cache[0]["pos"].numpy(),
                                  np.asarray(layer["pos"]))


def test_quantize_kv_bit_identical():
    x = np.random.RandomState(5).standard_normal((3, 7, 2, 16)).astype(
        np.float32)
    x[0, 0, 0] = 0.0  # an all-zero vector hits the scale floor
    x[1, 2, 1, :4] = [0.5, -0.5, 1.5, 2.5]  # exact halves after scaling
    qj, sj = jax_paged.quantize_kv(jnp.asarray(x))
    qt, st = tpaged.quantize_kv(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_bf16_matches_reference(kernels):
    cj, params, model = _pair(dtype="bfloat16", use_flash_attention=kernels,
                              use_fused_norm=kernels)
    tokens = _tokens((2, 16), 6)
    ref = jt.Transformer(cj).apply({"params": params}, jnp.asarray(tokens))
    out = model(_t(tokens))
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-2,
                               rtol=5e-2)


def test_bridge_round_trip_is_exact():
    cj, ct = _configs(kv_heads=2)
    tree = jax.device_get(_jax_params(cj))
    back = bridge.params_to_jax(bridge.params_from_jax(tree), ct)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(np.asarray(a), b)


def test_bridge_reads_bf16_leaves():
    cj, ct = _configs()
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.bfloat16)),
                                  jax.device_get(_jax_params(cj)))
    sd = bridge.params_from_jax(tree)
    assert sd["embedding"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        sd["embedding"].float().numpy(),
        np.asarray(tree["embedding"]).astype(np.float32))


def test_init_params_loads_and_is_seeded():
    cfg = dataclasses.replace(tt.tiny_test(), kv_heads=2)
    a = bridge.init_params(cfg, seed=3, device="cpu")
    b = bridge.init_params(cfg, seed=3, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    model = tt.Transformer(cfg, a, device="cpu")
    assert set(model.state_dict()) == set(a)
    logits = model(torch.zeros(1, 4, dtype=torch.long))
    assert logits.shape == (1, 4, cfg.vocab_size)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("kw,exc", [
    ({"num_experts": 2}, NotImplementedError),
    ({"use_ring_attention": True}, ValueError),
])
def test_later_slices_raise(kw, exc):
    cfg = dataclasses.replace(tt.tiny_test(), **kw)
    if cfg.num_experts:
        # MoE is ported: the config builds and runs every mode
        # (tests/test_torch_moe.py holds it against the reference)
        params = bridge.init_params(cfg, seed=0, device="cpu")
        model = tt.Transformer(cfg, params, device="cpu")
        aux = []
        logits = model(torch.zeros(1, 4, dtype=torch.long), aux_losses=aux)
        assert logits.shape == (1, 4, cfg.vocab_size) and len(aux) == 2
        assert isinstance(model.layers[0].moe_mlp, tt.MoeMLP)
        return
    # the sp ring is ported (tests/test_torch_ring.py and
    # test_torch_sp_train.py hold it against the reference): without a
    # mesh the setting is inert, as in the reference, and decode modes
    # refuse it
    params = bridge.init_params(tt.tiny_test(), seed=0, device="cpu")
    toks = torch.arange(4)[None]
    ring = tt.Transformer(cfg, params, device="cpu")
    plain = tt.Transformer(tt.tiny_test(), params, device="cpu")
    assert torch.equal(ring(toks), plain(toks))
    with pytest.raises(exc, match="sp ring"):
        ring(toks, mode="prefill", cache=ring.new_cache())
