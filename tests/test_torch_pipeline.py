"""The port's pipeline schedules (``k8s_tpu_torch/parallel/pipeline.py``)
against the JAX package's (``k8s_tpu/parallel/pipeline.py``) on the
virtual 8-device CPU mesh.

The schedule helpers (bubble, peak residuals, the interleaved
simulation and base ticks, the device-major chunk permutation) must be
equal over a grid of (M, S, v).  The schedules run the same numpy
weights: the JAX side under ``shard_map`` over a mesh with pp = S, the
port's ranks as threads of this process over ``ThreadRing`` (a data ring
of 2 where the JAX mesh has fsdp 2).  GPipe's outputs, and the 1F1B and
interleaved losses and every gradient (each stage's, the embedding
``pre`` and the head ``post``), at 2e-5 in f32: the same f32 products in
two libraries (a few ulps each) through up to 8 tanh stages, as
``tests/test_torch_ring.py``'s values.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_tpu.parallel import pipeline as jpl
from k8s_tpu.parallel.mesh import MeshConfig, make_mesh
from k8s_tpu_torch.parallel import pipeline as tpl
from k8s_tpu_torch.parallel.collectives import ThreadRing
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

TOL = 2e-5
V, D = 16, 8

GRID = list(itertools.product((1, 2, 4, 6, 8, 12), (1, 2, 3, 4), (1, 2, 3)))


@pytest.mark.parametrize("M,S,v", GRID)
def test_schedule_helpers_equal_the_reference(M, S, v):
    for sched in ("gpipe", "1f1b", "interleaved"):
        assert tpl.bubble_fraction(sched, M, S, v) == \
            jpl.bubble_fraction(sched, M, S, v)
        assert tpl.peak_activation_microbatches(sched, M, S, v) == \
            jpl.peak_activation_microbatches(sched, M, S, v)
    assert tpl._simulate_interleaved(M, S, v) == \
        jpl._simulate_interleaved(M, S, v)
    assert [tpl._interleaved_base(m, S, v) for m in range(M)] == \
        [jpl._interleaved_base(m, S, v) for m in range(M)]
    chunks = np.arange(S * v)
    for inverse in (False, True):
        assert tpl.interleave_chunks(list(chunks), S, v, inverse) == \
            list(jpl.interleave_chunks(chunks, S, v, inverse))


def test_unknown_schedule_refused_as_the_reference():
    for fn in (tpl.bubble_fraction, tpl.peak_activation_microbatches):
        with pytest.raises(ValueError, match="unknown schedule 'zb'"):
            fn("zb", 4, 2)


# -- the schedules against JAX ----------------------------------------------


def _mesh(pp, fsdp=1):
    cfg = MeshConfig(pp=pp, fsdp=fsdp)
    return make_mesh(cfg, jax.devices()[:cfg.num_devices])


def _j_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _t_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _j_pre(p, tok):
    return p["emb"][tok]


def _t_pre(p, tok):
    return p["emb"][tok]


def _j_head(p, x):
    return x @ p["head"]


def _t_head(p, x):
    return x @ p["head"]


def _j_ce(p, x, t):
    logits = _j_head(p, x)
    lse = jax.nn.logsumexp(logits, -1)
    picked = jnp.take_along_axis(logits, t[..., None], -1)[..., 0]
    return jnp.mean(lse - picked)


def _t_ce(p, x, t):
    logits = _t_head(p, x)
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, t[..., None])[..., 0]).mean()


def _j_mse(o, t):
    return jnp.mean((o - t) ** 2)


def _t_mse(o, t):
    return ((o - t) ** 2).mean()


def _weights(C, seed):
    rng = np.random.default_rng(seed)
    chunks = [{"w": (rng.standard_normal((D, D)) * 0.3).astype(np.float32),
               "b": (rng.standard_normal(D) * 0.1).astype(np.float32)}
              for _ in range(C)]
    pre = {"emb": (rng.standard_normal((V, D)) * 0.5).astype(np.float32)}
    post = {"head": (rng.standard_normal((D, V)) * 0.5).astype(np.float32)}
    return chunks, pre, post


def _stack(chunks):
    return {k: jnp.stack([c[k] for c in chunks]) for k in chunks[0]}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=what)


def _run(S, fn, data=1):
    """fn(pp ring, data rings) on S x data threads; results in rank order
    (pp major)."""
    return ThreadRing.run_mesh(data, 1, lambda r: fn(r.pp, (r.sp,)), pp=S)


def _rows(x, data_ring):
    n = len(x) // data_ring.size
    return x[data_ring.rank * n:(data_ring.rank + 1) * n]


@pytest.mark.parametrize("S,M,hetero", [(2, 4, True), (4, 8, True),
                                        (4, 4, False)])
def test_gpipe_forward_matches_jax(S, M, hetero):
    chunks, pre, post = _weights(S, seed=S + M)
    rng = np.random.default_rng(3)
    if hetero:
        x = rng.integers(0, V, (2 * M, 3)).astype(np.int32)
        ends = dict(pre_fn=_j_pre, pre_params=pre, post_fn=_j_head,
                    post_params=post)
    else:
        x = rng.standard_normal((2 * M, D)).astype(np.float32)
        ends = {}
    want = jpl.pipeline_apply(_mesh(S), _j_stage, _stack(chunks),
                              jnp.asarray(x), num_microbatches=M, **ends)

    def body(ring, data):
        tends = dict(pre_fn=_t_pre, pre_params=_torch(pre) if ring.rank == 0
                     else None, post_fn=_t_head,
                     post_params=_torch(post), act=torch.zeros(2, 3, D)) \
            if hetero else {}
        return tpl.pipeline_apply(ring, _t_stage, _torch(chunks[ring.rank]),
                                  torch.from_numpy(x).long() if hetero
                                  else torch.from_numpy(x),
                                  num_microbatches=M, **tends)

    outs = _run(S, body)
    assert all(o is None for o in outs[:-1])
    _close(outs[-1], want, "GPipe outputs")


def _check_grads(res, S, v, j_loss, j_chunks, j_pre, j_post, hetero):
    """Every rank's loss, its chunks' gradients, and the end gradients on
    the first and last rank, against the reference's."""
    for s, (loss, grads) in enumerate(res):
        _close(float(loss), float(j_loss), f"loss on rank {s}")
        g_chunks, g_pre, g_post = grads if hetero else (grads, None, None)
        if v == 1:
            g_chunks = [g_chunks]
        for q, g in enumerate(g_chunks):
            c = q * S + s  # the rank's q-th chunk, in natural order
            for k, t in g.items():
                _close(t, j_chunks[k][c], f"rank {s} chunk {c} {k}")
        if hetero:
            assert (g_pre is not None) == (s == 0)
            assert (g_post is not None) == (s == S - 1)
            for got, want in ((g_pre, j_pre), (g_post, j_post)):
                for k, t in (got or {}).items():
                    _close(t, want[k], f"rank {s} end {k}")


@pytest.mark.parametrize("S,M,data,hetero", [
    (2, 4, 1, True), (4, 8, 1, True), (2, 2, 1, True), (4, 4, 2, False)])
def test_1f1b_loss_and_grads_match_jax(S, M, data, hetero):
    chunks, pre, post = _weights(S, seed=10 * S + M)
    rng = np.random.default_rng(4)
    B = 4 * M
    if hetero:
        x = rng.integers(0, V, (B, 3)).astype(np.int32)
        y = rng.integers(0, V, (B, 3)).astype(np.int32)
        ends = dict(pre_fn=_j_pre, pre_params=pre, post_fn=_j_ce,
                    post_params=post)
    else:
        x = rng.standard_normal((B, D)).astype(np.float32)
        y = np.sin(x)
        ends = {}
    mesh = _mesh(S, data)
    out = jpl.pipeline_train_step_1f1b(
        mesh, _j_stage, _stack(chunks), jnp.asarray(x), jnp.asarray(y),
        None if hetero else _j_mse, num_microbatches=M,
        batch_axes=("fsdp",), **ends)
    j_loss, j_grads = out
    j_chunks, j_pre, j_post = j_grads if hetero else (j_grads, None, None)

    def body(ring, data_rings):
        tx, ty = (_rows(torch.from_numpy(a), data_rings[0]) for a in (x, y))
        if hetero:
            tx, ty = tx.long(), ty.long()
            tends = dict(pre_fn=_t_pre, post_fn=_t_ce,
                         pre_params=_torch(pre) if ring.rank == 0 else None,
                         post_params=_torch(post) if ring.rank == S - 1
                         else None, act=torch.zeros(len(tx) // M, 3, D))
        else:
            tends = {}
        return tpl.pipeline_train_step_1f1b(
            ring, _t_stage, _torch(chunks[ring.rank]), tx, ty,
            None if hetero else _t_mse, num_microbatches=M,
            batch_rings=data_rings, **tends)

    res = _run(S, body, data)
    _check_grads(res[::data], S, 1, j_loss, j_chunks, j_pre, j_post, hetero)


@pytest.mark.parametrize("S,v,M,hetero", [
    (2, 2, 4, False), (4, 2, 8, False), (2, 3, 6, False), (2, 2, 4, True),
    (4, 2, 8, True)])
def test_interleaved_loss_and_grads_match_jax(S, v, M, hetero):
    C = S * v
    chunks, pre, post = _weights(C, seed=C + M)
    rng = np.random.default_rng(5)
    B = 2 * M
    if hetero:
        x = rng.integers(0, V, (B, 3)).astype(np.int32)
        y = rng.integers(0, V, (B, 3)).astype(np.int32)
        ends = dict(pre_fn=_j_pre, pre_params=pre, post_fn=_j_ce,
                    post_params=post)
    else:
        x = rng.standard_normal((B, D)).astype(np.float32)
        y = np.sin(x)
        ends = {}
    j_loss, j_grads = jpl.pipeline_train_step_interleaved(
        _mesh(S), _j_stage, _stack(chunks), jnp.asarray(x), jnp.asarray(y),
        None if hetero else _j_mse, num_microbatches=M, num_virtual=v,
        **ends)
    j_chunks, j_pre, j_post = j_grads if hetero else (j_grads, None, None)

    def body(ring, data_rings):
        mine = [_torch(chunks[q * S + ring.rank]) for q in range(v)]
        tx, ty = torch.from_numpy(x), torch.from_numpy(y)
        if hetero:
            tx, ty = tx.long(), ty.long()
            tends = dict(pre_fn=_t_pre, post_fn=_t_ce,
                         pre_params=_torch(pre) if ring.rank == 0 else None,
                         post_params=_torch(post) if ring.rank == S - 1
                         else None, act=torch.zeros(B // M, 3, D))
        else:
            tends = {}
        stats = {}
        out = tpl.pipeline_train_step_interleaved(
            ring, _t_stage, mine, tx, ty, None if hetero else _t_mse,
            num_microbatches=M, num_virtual=v, stats=stats, **tends)
        return out, stats["peak_stashed"]

    res = _run(S, body)
    _check_grads([r[0] for r in res], S, v, j_loss, j_chunks, j_pre, j_post,
                 hetero)
    # the stash never holds more than the reference's memory figure
    assert max(r[1] for r in res) <= \
        jpl.peak_activation_microbatches("interleaved", M, S, v)


def test_refusals_name_what_the_reference_names():
    x = torch.zeros(8, D)
    p = {"w": torch.zeros(D, D), "b": torch.zeros(D)}

    def one(fn, **kw):
        return ThreadRing.run(2, lambda ring: fn(ring, **kw))

    with pytest.raises(ValueError, match="exactly one of loss_fn / post_fn"):
        one(lambda ring: tpl.pipeline_train_step_1f1b(
            ring, _t_stage, p, x, x, num_microbatches=2))
    with pytest.raises(ValueError, match="batch 8 not divisible into 3"):
        one(lambda ring: tpl.pipeline_train_step_1f1b(
            ring, _t_stage, p, x, x, _t_mse, num_microbatches=3))
    with pytest.raises(ValueError, match="not divisible by data shards 2"):
        ThreadRing.run_mesh(2, 1, lambda r: tpl.pipeline_train_step_1f1b(
            r.pp, _t_stage, p, x[:2], x[:2], _t_mse, num_microbatches=4,
            batch_rings=(r.sp,)), pp=2)
    with pytest.raises(ValueError, match="groups of 2 .* 3 is not a multiple"):
        one(lambda ring: tpl.pipeline_train_step_interleaved(
            ring, _t_stage, [p, p], x[:6], x[:6], _t_mse,
            num_microbatches=3, num_virtual=2))
    with pytest.raises(ValueError, match="num_virtual must be >= 1"):
        one(lambda ring: tpl.pipeline_train_step_interleaved(
            ring, _t_stage, [], x, x, _t_mse, num_microbatches=2,
            num_virtual=0))
    with pytest.raises(ValueError, match="num_virtual=2 chunks"):
        one(lambda ring: tpl.pipeline_train_step_interleaved(
            ring, _t_stage, [p], x, x, _t_mse, num_microbatches=2,
            num_virtual=2))
    with pytest.raises(ValueError, match="needs act="):
        one(lambda ring: tpl.pipeline_apply(
            ring, _t_stage, p, x.long(), num_microbatches=2,
            pre_fn=_t_pre, pre_params=None))
