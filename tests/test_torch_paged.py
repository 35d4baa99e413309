"""The port's paged KV cache (k8s_tpu_torch/models/paged.py, kvblocks.py,
placement.py) against the JAX package's on the CPU.

Pools, block tables, lengths and positions are drawn from numpy with a
seed and go through both packages: ``paged_kv_write`` must store exactly
what the reference stores (write-masked lanes at position -1 change no
bit), ``paged_attention`` must agree within 1e-5 in f32, the two
``kvblocks`` copies must answer a randomized operation sequence alike, and
the engine's prefill body over the pool must give the reference's logits
(1e-4, the model-level tolerance of test_torch_transformer.py) and pool.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_tpu.models import kvblocks as jax_kvblocks
from k8s_tpu.models import paged as jax_paged
from k8s_tpu.models import placement as jax_placement
from k8s_tpu.models import transformer as jt
from k8s_tpu_torch.models import bridge, kvblocks, paged, placement
from k8s_tpu_torch.models import transformer as tt
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

N, BS, HKV, H, D = 11, 4, 2, 4, 8


def _pool_case(seed, int8, B=3, Lc=3, maxb=4):
    """A pool of recycled garbage, per-row tables of distinct live blocks
    (null-padded), each row's written length, this chunk's positions
    (-1 lanes included: one whole inactive row and a short row) and the
    chunk's vectors."""
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
    return leaf, scale, tables, lengths, positions, x


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_paged_kv_write_is_the_references(seed, int8):
    leaf, scale, tables, _, positions, x = _pool_case(seed, int8)
    want, want_s = jax_paged.paged_kv_write(
        jnp.asarray(leaf), jnp.asarray(tables), jnp.asarray(positions),
        jnp.asarray(x), scale_leaf=None if scale is None
        else jnp.asarray(scale), quantize=int8)
    got, got_s = paged.paged_kv_write(
        _t(leaf), _t(tables), _t(positions), _t(x), scale_leaf=_t(scale),
        quantize=int8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if int8:
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_masked_lanes_change_no_bit(int8):
    leaf, scale, tables, _, positions, x = _pool_case(5, int8)
    got, got_s = paged.paged_kv_write(
        _t(leaf), _t(tables), _t(np.full_like(positions, -1)), _t(x),
        scale_leaf=_t(scale), quantize=int8)
    np.testing.assert_array_equal(got.numpy(), leaf)
    if int8:
        np.testing.assert_array_equal(got_s.numpy(), scale)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_paged_attention_matches_reference(seed, int8):
    """Write-then-attend, as the decode step does, over garbage above
    each row's length; GQA groups of two."""
    leaf, scale, tables, lengths, positions, x = _pool_case(seed, int8)
    rs = np.random.RandomState(100 + seed)
    vleaf = rs.permutation(leaf.reshape(-1)).reshape(leaf.shape)
    vscale = None if scale is None else scale[::-1].copy()
    q = rs.randn(*positions.shape, H, D).astype(np.float32)
    j, t = {}, {}
    for name, lf, sc in (("k", leaf, scale), ("v", vleaf, vscale)):
        j[name] = jax_paged.paged_kv_write(
            jnp.asarray(lf), jnp.asarray(tables), jnp.asarray(positions),
            jnp.asarray(x), scale_leaf=None if sc is None
            else jnp.asarray(sc), quantize=int8)
        t[name] = paged.paged_kv_write(
            _t(lf), _t(tables), _t(positions), _t(x), scale_leaf=_t(sc),
            quantize=int8)
    want = jax_paged.paged_attention(
        jnp.asarray(q), j["k"][0], j["v"][0], jnp.asarray(tables),
        jnp.asarray(lengths), jnp.asarray(positions), k_scale=j["k"][1],
        v_scale=j["v"][1], dtype=jnp.float32)
    got = paged.paged_attention(
        _t(q), t["k"][0], t["v"][0], _t(tables), _t(lengths),
        _t(positions), k_scale=t["k"][1], v_scale=t["v"][1],
        dtype=torch.float32)
    assert got.shape == (*positions.shape, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def _kvblocks_script(mod, seed, steps=300):
    """A randomized sequence of pool and tree operations; returns what
    each one answered."""
    rs = np.random.RandomState(seed)
    bs = 4
    pool, tree = mod.BlockPool(24), mod.PrefixTree(bs)
    held: list[int] = []
    prompts = [list(rs.randint(0, 5, rs.randint(2, 20))) for _ in range(12)]
    out = []
    for _ in range(steps):
        op = rs.randint(6)
        if op == 0:
            b = pool.alloc()
            out.append(("alloc", b))
            if b is not None:
                held.append(b)
        elif op == 1 and held:
            b = held[rs.randint(len(held))]
            pool.retain(b)
            held.append(b)
            out.append(("retain", b, pool.refcount(b)))
        elif op == 2 and held:
            b = held.pop(rs.randint(len(held)))
            out.append(("release", b, pool.release(b)))
        elif op == 3:
            ids = prompts[rs.randint(len(prompts))]
            full, part = tree.match(ids, len(ids) - 1)
            out.append(("match", [n.block for n in full],
                        None if part is None else (part[0].block, part[1])))
        elif op == 4:
            ids = prompts[rs.randint(len(prompts))]
            nb = len(ids) // bs
            blocks = [pool.alloc() for _ in range(nb)]
            if None in blocks:
                for b in blocks:
                    if b is not None:
                        pool.release(b)
                out.append(("insert", None))
                continue
            created = tree.insert(tree.match(ids, len(ids) - 1)[0], ids,
                                  blocks)
            for node in created:
                pool.retain(node.block)
            for b in blocks:
                pool.release(b)
            out.append(("insert", [n.block for n in created]))
        elif op == 5:
            victim = tree.evict_leaf(pinned=lambda b: pool.refcount(b) > 1)
            if victim is not None:
                pool.release(victim.block)
            out.append(("evict", None if victim is None else victim.block))
        out.append(("state", pool.used_blocks, pool.free_blocks, tree.nodes))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_kvblocks_copies_answer_alike(seed):
    assert _kvblocks_script(kvblocks, seed) == \
        _kvblocks_script(jax_kvblocks, seed)


def test_kvblocks_pool_invariants():
    pool = kvblocks.BlockPool(3)
    a, b = pool.alloc(), pool.alloc()
    assert {a, b} == {1, 2} and pool.alloc() is None  # block 0 is null
    pool.retain(a)
    assert not pool.release(a) and pool.release(a)
    assert pool.alloc() == a
    with pytest.raises(ValueError):
        kvblocks.BlockPool(1)


def _jax_nodes(tree):
    """The JAX pool's per-layer cache nodes, in layer order."""
    nodes = []
    jax_placement.map_cache(tree, lambda n: nodes.append(n) or n)
    return nodes


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
def test_prefill_body_matches_reference(kv):
    """The engine's prefill body (``PagedCompute.prefill_paged``) over a
    shuffled table: two chunks into the pool, then a one-token chunk;
    logits and every pool leaf against the reference's body."""
    cj = dataclasses.replace(jt.tiny_test(), dtype=jnp.float32,
                             kv_cache_dtype=kv)
    ct = dataclasses.replace(tt.tiny_test(), dtype=torch.float32,
                             kv_cache_dtype=kv)
    params = jt.Transformer(cj).init(jax.random.PRNGKey(2),
                                     jnp.zeros((1, 8), jnp.int32))["params"]
    model = tt.Transformer(
        ct, bridge.params_from_jax(jax.device_get(params)), device="cpu")
    jc = jax_placement.PagedCompute(cj)
    tc = placement.PagedCompute(model)
    bs, nblocks = 8, 7
    jpool = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype),
        jc.pool_manifest(params, nblocks, bs))
    tpool = tc.build_pool(nblocks, bs, "cpu")
    table = np.asarray([5, 2, 6, 1, 0, 0], np.int32)
    ids = np.random.RandomState(3).randint(0, ct.vocab_size, 29)
    jprefill = jax.jit(jc.prefill_paged)
    off = 0
    for c in (16, 8, 4, 1):
        chunk = ids[off:off + c][None]
        pos = (off + np.arange(c, dtype=np.int32))[None]
        jpool, jl = jprefill(params, jpool, jnp.asarray(table),
                                     jnp.asarray(chunk), jnp.asarray(pos))
        with torch.inference_mode():
            tl = tc.prefill_paged(tpool, torch.from_numpy(table).long(),
                                  chunk, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        off += c
    for jn, tn in zip(_jax_nodes(jpool), tpool, strict=True):
        assert set(tn) == {k for k in jn if k != "pos"}
        for name, leaf in tn.items():
            want = np.asarray(jn[name])
            if leaf.dtype == torch.int8:
                # one int8 step where the two sides' f32 K/V straddle a
                # rounding boundary
                assert np.abs(leaf.numpy().astype(int) - want).max() <= 1
            else:
                np.testing.assert_allclose(leaf.numpy(), want, atol=1e-5,
                                           rtol=1e-5)


def test_paged_decode_matches_dense_cache():
    """Within the port: a paged decode step over a shuffled table gives
    the dense cache's logits for the same tokens and positions."""
    cfg = tt.tiny_test()
    model = tt.Transformer(cfg, bridge.init_params(cfg, 4, "cpu"),
                           device="cpu")
    comp = placement.PagedCompute(model)
    toks = torch.from_numpy(np.random.RandomState(6).randint(0, 256, 14))
    with torch.inference_mode():
        dense = model.new_cache()
        want = model(toks[None, :13], mode="prefill", cache=dense)[:, -1]
        pool = comp.build_pool(9, 4, "cpu")
        table = torch.tensor([[7, 3, 8, 1]])
        got = comp.prefill_paged(pool, table[0], toks[None, :13].numpy(),
                                 np.arange(13)[None])
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)
        pos = torch.tensor([[13]])
        want = model(toks[None, 13:], positions=pos, mode="decode",
                     cache=dense)
        got = model(toks[None, 13:], positions=pos, mode="decode",
                    cache=comp.paged_cache(pool, table, torch.tensor([13])))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)


def test_windowed_config_refuses_paged_decode():
    cfg = dataclasses.replace(tt.tiny_test(), window_size=8)
    model = tt.Transformer(cfg, bridge.init_params(cfg, 0, "cpu"),
                           device="cpu")
    cache = [{"table": torch.zeros(1, 1, dtype=torch.long),
              "len": torch.zeros(1, dtype=torch.long)} for _ in range(2)]
    with pytest.raises(ValueError, match="full cache"):
        model(torch.zeros(1, 1, dtype=torch.long),
              positions=torch.zeros(1, 1, dtype=torch.long), mode="decode",
              cache=cache)


def test_only_the_local_placement_is_ported():
    """The engine takes the local placement and the mesh one (tensor-
    parallel serving); anything else is refused by name."""
    from k8s_tpu_torch.models import mesh_serve

    with pytest.raises(TypeError, match="neither a LocalPlacement"):
        placement.check_placement(object())
    local = placement.LocalPlacement("cpu")
    assert placement.check_placement(local) is local
    assert local.info()["placement"] == "local"
    mesh = mesh_serve.MeshPlacement(tt.tiny_test(), device="cpu")
    assert placement.check_placement(mesh) is mesh
    assert mesh.info() == {"num_processes": 1, "mesh_shape": {"tp": 1},
                           "tp_degree": 1, "placement": "mesh"}
