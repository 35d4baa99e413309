"""Serving tensor parallelism in the port (parallel/sharding.py's serving
specs, models/paged.py's ``*_tp`` head slices, a tp rank of the served
Transformer) against the JAX package on the CPU.

Each rank's shard from ``shard_serve_params`` must be the JAX params
sliced by the reference's ``serve_tp_param_specs``, carried over by
``bridge.params_from_jax`` (tp 1, 2, 4); the pool specs and
``check_serve_tp_config``'s refusals must be the reference's; the paged
write and attention on each rank's head slice, concatenated, must agree
with the reference's ``shard_map`` islands over a 4-device CPU mesh
(f32 and int8 pools, 1e-5); and the tp ranks of a served model, run as
``ThreadRing`` threads, must give the whole model's logits (1e-5).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_tpu.models import paged as jax_paged
from k8s_tpu.models.transformer import Transformer as JaxTransformer
from k8s_tpu.models.transformer import TransformerConfig as JaxConfig
from k8s_tpu.parallel import sharding as jax_sharding
from k8s_tpu.parallel.mesh import MeshConfig, make_mesh
from k8s_tpu_torch.models import bridge, paged
from k8s_tpu_torch.models import transformer as tt
from k8s_tpu_torch.parallel import collectives, sharding
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

SHAPE = dict(vocab_size=61, hidden=64, ffn_hidden=128, layers=2, heads=8,
             kv_heads=4, max_seq_len=64, remat=False)
TP = 4
N, BS, HKV, H, D = 11, 4, 4, 8, 8


@pytest.fixture(scope="module")
def jax_params():
    cfg = JaxConfig(dtype=jnp.float32, **SHAPE)
    return jax.device_get(JaxTransformer(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 5), jnp.int32))["params"])


def _rank_slice(a, spec, rank, tp):
    a = np.asarray(a)
    for dim, axis in enumerate(tuple(spec)):
        if axis == "tp":
            n = a.shape[dim] // tp
            a = np.take(a, np.arange(rank * n, (rank + 1) * n), axis=dim)
    return a


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_shards_are_the_jax_arrays_sliced_by_the_reference_specs(
        jax_params, tp):
    specs = jax_sharding.serve_tp_param_specs(jax_params)
    full = bridge.params_from_jax(jax_params)
    for rank in range(tp):
        want = bridge.params_from_jax(jax.tree.map(
            lambda a, s: _rank_slice(a, s, rank, tp), jax_params, specs,
            is_leaf=lambda x: isinstance(x, np.ndarray)))
        got = sharding.shard_serve_params(full, rank, tp)
        assert set(got) == set(want)
        for name in want:
            assert got[name].is_contiguous() or tp == 1, name
            np.testing.assert_array_equal(got[name].numpy(),
                                          want[name].numpy(), err_msg=name)
        # replicated tensors are shared, not copied
        assert got["embedding"] is full["embedding"]


def test_param_specs_name_the_megatron_split():
    sd = bridge.init_params(tt.TransformerConfig(**SHAPE), 0, "cpu")
    specs = sharding.serve_tp_param_specs(sd)
    assert specs["layers.0.attn.q_proj.weight"] == ("tp", None)
    assert specs["layers.1.mlp.up_proj.weight"] == ("tp", None)
    assert specs["layers.0.attn.o_proj.weight"] == (None, "tp")
    assert specs["layers.1.mlp.down_proj.weight"] == (None, "tp")
    assert specs["embedding"] == ()
    assert specs["final_norm.scale"] == ()
    assert specs["layers.0.attn_norm.scale"] == ()


@pytest.mark.parametrize("shape", [(N, BS, HKV, D), (N, BS, HKV), (N,)],
                         ids=["kv", "scale", "other"])
def test_pool_specs_are_the_references(shape):
    want = tuple(jax_sharding.serve_pool_spec(np.zeros(shape)))
    assert sharding.serve_pool_spec(shape) == want
    pool = [{"k": torch.zeros(N, BS, HKV, D),
             "k_scale": torch.zeros(N, BS, HKV)}]
    assert sharding.serve_pool_specs(pool) == [
        {"k": (None, None, "tp", None), "k_scale": (None, None, "tp")}]


@pytest.mark.parametrize("change,tp", [
    (dict(heads=6, kv_heads=2), 4),
    (dict(kv_heads=2), 4),
    (dict(ffn_hidden=130), 4),
    (dict(num_experts=4), 2),
    (dict(heads=6, kv_heads=3, ffn_hidden=130), 4),
], ids=["heads", "kv_heads", "ffn", "moe", "all"])
def test_check_serve_tp_config_gives_the_references_message(change, tp):
    jcfg = dataclasses.replace(JaxConfig(dtype=jnp.float32, **SHAPE),
                               **change)
    tcfg = dataclasses.replace(tt.TransformerConfig(**SHAPE), **change)
    with pytest.raises(ValueError) as want:
        jax_sharding.check_serve_tp_config(jcfg, tp)
    with pytest.raises(ValueError) as got:
        sharding.check_serve_tp_config(tcfg, tp)
    assert str(got.value) == str(want.value)
    assert "does not shard" in str(got.value)


def test_rank_config_keeps_the_head_width():
    cfg = tt.TransformerConfig(**SHAPE)
    assert sharding.serve_rank_config(cfg, 1) is cfg
    r = sharding.serve_rank_config(cfg, 4)
    assert (r.heads, r.kv_heads, r.ffn_hidden) == (2, 1, 32)
    assert r.dims_per_head == cfg.dims_per_head == 8


def _pool_case(seed, int8, B=3, Lc=3, maxb=4):
    rs = np.random.RandomState(seed)
    if int8:
        leaf = rs.randint(-127, 128, (N, BS, HKV, D)).astype(np.int8)
        scale = rs.uniform(0.01, 0.1, (N, BS, HKV)).astype(np.float32)
    else:
        leaf = rs.randn(N, BS, HKV, D).astype(np.float32)
        scale = None
    blocks = rs.permutation(np.arange(1, N))
    tables = np.zeros((B, maxb), np.int32)
    lengths = np.zeros(B, np.int32)
    positions = np.full((B, Lc), -1, np.int32)
    used = 0
    for b in range(B):
        nb = 1 + rs.randint(maxb - 1)
        tables[b, :nb] = blocks[used:used + nb]
        used += nb
        lengths[b] = rs.randint(0, nb * BS - Lc + 1)
        width = Lc if b == 0 else (0 if b == 1 else 1)
        positions[b, :width] = lengths[b] + np.arange(width)
    x = rs.randn(B, Lc, HKV, D).astype(np.float32)
    vleaf = rs.permutation(leaf.reshape(-1)).reshape(leaf.shape)
    vscale = None if scale is None else scale[::-1].copy()
    q = rs.randn(B, Lc, H, D).astype(np.float32)
    return leaf, scale, vleaf, vscale, tables, lengths, positions, x, q


def _heads(a, rank, total):
    """Rank ``rank``'s slice of axis 2 (the head axis) as a tensor."""
    if a is None:
        return None
    n = a.shape[2] // TP
    assert a.shape[2] == total
    return torch.from_numpy(np.ascontiguousarray(a[:, :, rank * n:(rank + 1)
                                                   * n]))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_tp_head_slices_match_the_reference_islands(seed, int8):
    """Write-then-attend on each of four ranks' head slices, concatenated,
    against the reference's shard_map'd write and attention over four CPU
    devices: the pools bit for bit, the output within 1e-5."""
    leaf, scale, vleaf, vscale, tables, lengths, positions, x, q = \
        _pool_case(seed, int8)
    mesh = make_mesh(MeshConfig(tp=TP), jax.devices()[:TP])

    @jax.jit
    def reference(leaf, scale, vleaf, vscale, tables, lengths, positions,
                  x, q):
        j = {}
        for name, lf, sc in (("k", leaf, scale), ("v", vleaf, vscale)):
            j[name] = jax_paged.paged_kv_write_tp(
                mesh, lf, tables, positions, x, scale_leaf=sc,
                quantize=int8)
        return j, jax_paged.paged_attention_tp(
            mesh, q, j["k"][0], j["v"][0], tables, lengths, positions,
            k_scale=j["k"][1], v_scale=j["v"][1], dtype=jnp.float32)

    j, want = reference(leaf, scale, vleaf, vscale, tables, lengths,
                        positions, x, q)
    outs, pools = [], {"k": [], "v": [], "k_scale": [], "v_scale": []}
    tb, ln, ps = (torch.from_numpy(a) for a in (tables, lengths, positions))
    for r in range(TP):
        t = {}
        for name, lf, sc in (("k", leaf, scale), ("v", vleaf, vscale)):
            t[name] = paged.paged_kv_write_tp(
                TP, HKV, _heads(lf, r, HKV), tb, ps, _heads(x, r, HKV),
                scale_leaf=_heads(sc, r, HKV), quantize=int8)
            pools[name].append(t[name][0])
            if int8:
                pools[name + "_scale"].append(t[name][1])
        outs.append(paged.paged_attention_tp(
            TP, H, HKV, _heads(q, r, H), t["k"][0], t["v"][0], tb, ln, ps,
            k_scale=t["k"][1], v_scale=t["v"][1], dtype=torch.float32))
    for name in ("k", "v"):
        np.testing.assert_array_equal(
            torch.cat(pools[name], dim=2).numpy(), np.asarray(j[name][0]))
        if int8:
            np.testing.assert_array_equal(
                torch.cat(pools[name + "_scale"], dim=2).numpy(),
                np.asarray(j[name][1]))
    np.testing.assert_allclose(torch.cat(outs, dim=2).numpy(),
                               np.asarray(want), atol=1e-5, rtol=0)


def test_tp_functions_refuse_a_whole_pool():
    leaf, scale, vleaf, _, tables, lengths, positions, x, q = \
        _pool_case(3, False)
    tb, ln, ps = (torch.from_numpy(a) for a in (tables, lengths, positions))
    with pytest.raises(ValueError, match="not one tp rank's slice"):
        paged.paged_kv_write_tp(TP, HKV, torch.from_numpy(leaf), tb, ps,
                                _heads(x, 0, HKV))
    with pytest.raises(ValueError, match="queries"):
        paged.paged_attention_tp(TP, H, HKV, torch.from_numpy(q),
                                 _heads(leaf, 0, HKV), _heads(vleaf, 0, HKV),
                                 tb, ln, ps, dtype=torch.float32)
    with pytest.raises(ValueError, match="pool v"):
        paged.paged_attention_tp(TP, H, HKV, _heads(q, 0, H),
                                 _heads(leaf, 0, HKV),
                                 torch.from_numpy(vleaf), tb, ln, ps,
                                 dtype=torch.float32)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_ranks_of_the_served_model_give_its_logits(tp):
    """The rank models (each its shard, the ring summing o_proj's and
    down_proj's partial sums) as ThreadRing threads: a full forward and
    one cached decode step give the whole model's logits on every rank."""
    cfg = tt.TransformerConfig(dtype=torch.float32, **SHAPE)
    sd = bridge.init_params(cfg, 3, "cpu")
    whole = tt.Transformer(cfg, sd, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 9),
                         generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        cache = whole.new_cache()
        want = whole(toks[:, :8], mode="prefill", cache=cache)
        want_step = whole(toks[:, 8:], positions=torch.full((2, 1), 8),
                          mode="decode", cache=cache)

    def rank(ring):
        m = tt.Transformer(sharding.serve_rank_config(cfg, ring.size),
                           sharding.shard_serve_params(sd, ring.rank,
                                                       ring.size),
                           device="cpu", tp=ring)
        with torch.inference_mode():
            c = m.new_cache()
            out = m(toks[:, :8], mode="prefill", cache=c)
            step = m(toks[:, 8:], positions=torch.full((2, 1), 8),
                     mode="decode", cache=c)
        return out, step, c[0]["k"].shape[2]

    for out, step, kv in collectives.ThreadRing.run(tp, rank, timeout=60):
        assert kv == cfg.kv_heads // tp
        np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(step.numpy(), want_step.numpy(),
                                   atol=1e-5, rtol=0)
