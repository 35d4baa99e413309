"""The port's ring collectives and sequence-parallel attention
(``k8s_tpu_torch/parallel/``) against the JAX package's on the virtual
8-device CPU mesh.

The JAX side runs under ``shard_map`` (ring-flash's Pallas kernels in
interpret mode); the port's ranks run as threads of this process over
``ThreadRing`` (its kernels' plain versions on the CPU), each on its
chunk of the same numpy inputs, and the chunks are joined back.  Values
at 2e-5 and gradients (of ``sum(sin(out))``) at 5e-5 in f32, the
reference's own tolerances (``tests/test_parallel.py``).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

try:  # jax >= 0.8
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

from k8s_tpu.parallel import collectives as jcoll
from k8s_tpu.parallel.mesh import MeshConfig, make_mesh
from k8s_tpu.parallel.ring_attention import ring_attention as j_ring
from k8s_tpu.parallel.ring_flash import ring_flash_attention as j_ring_flash
from k8s_tpu.parallel.ulysses import ulysses_attention as j_ulysses
from k8s_tpu_torch.parallel import collectives as tcoll
from k8s_tpu_torch.parallel import ring_attention as t_ring
from k8s_tpu_torch.parallel import ring_flash as t_ring_flash
from k8s_tpu_torch.parallel import ulysses as t_ulysses
from k8s_tpu_torch.parallel.collectives import ThreadRing

VAL_TOL, GRAD_TOL = 2e-5, 5e-5
B, L, D, SP = 2, 32, 16, 4


def _mesh(**axes):
    cfg = MeshConfig(**axes)
    return make_mesh(cfg, jax.devices()[:cfg.num_devices])


def _inputs(H, Hkv, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, L, h, D)) * 0.5).astype(np.float32)
            for h in (H, Hkv, Hkv)]


def _jax_run(fn, q, k, v):
    """``sum(sin(fn(q, k, v)))``'s output and gradients, one compile."""
    def loss(q, k, v):
        out = fn(q, k, v)
        return jnp.sum(jnp.sin(out)), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _port_run(fn, q, k, v, sp, tp=1):
    """``fn(rings, q, k, v)`` on each rank's chunk, backward of
    ``sum(sin(out))`` in each rank; returns the output and gradients
    joined over sp, and checks that every tp rank holds the same."""
    Lc = L // sp

    def body(rings):
        s = rings.sp.rank
        ins = [torch.from_numpy(x[:, s * Lc:(s + 1) * Lc].copy())
               .requires_grad_() for x in (q, k, v)]
        out = fn(rings, *ins)
        out.sin().sum().backward()
        return [out.detach()] + [t.grad for t in ins]

    res = ThreadRing.run_mesh(sp, tp, body)
    for s in range(sp):
        for t in range(1, tp):
            for a, b in zip(res[s * tp], res[s * tp + t]):
                assert torch.equal(a, b), "tp ranks disagree"
    return [torch.cat([res[s * tp][i] for s in range(sp)], dim=1).numpy()
            for i in range(4)]


def _close(got, want):
    for name, g, w, tol in zip(("out", "dq", "dk", "dv"), got, want,
                               (VAL_TOL,) + (GRAD_TOL,) * 3):
        np.testing.assert_allclose(g, w, atol=tol, err_msg=name)


# -- collectives --------------------------------------------------------------


def _port_collective(name, x, w=None):
    n = 8
    rows = x.shape[0] // n

    def body(ring):
        r = ring.rank
        if name == "shift":
            xs = torch.from_numpy(x[r * rows:(r + 1) * rows])
            return (tcoll.ring_shift(xs, ring),
                    tcoll.ring_shift(xs, ring, reverse=True))
        if name == "all_gather":
            return tcoll.ring_all_gather(
                torch.from_numpy(x[r * rows:(r + 1) * rows]), ring)
        if name == "reduce_scatter":
            cols = x.shape[1] // n
            return tcoll.ring_reduce_scatter(
                torch.from_numpy(x[:, r * cols:(r + 1) * cols]), ring)
        xs = torch.from_numpy(x[r * rows:(r + 1) * rows].copy()
                              ).requires_grad_()
        wt = torch.from_numpy(w.copy()).requires_grad_()
        y = tcoll.collective_matmul(xs, wt, ring)
        (y ** 2).sum().backward()
        return y.detach(), wt.grad, xs.grad

    return ThreadRing.run(n, body)


@pytest.mark.parametrize("name", ["shift", "all_gather", "reduce_scatter",
                                  "matmul"])
def test_collectives_match_jax(name):
    mesh = _mesh(sp=8)
    rng = np.random.default_rng(7)
    if name == "shift":
        x = np.arange(8.0, dtype=np.float32)[:, None] * np.ones((1, 3),
                                                                 np.float32)

        @partial(shard_map, mesh=mesh, in_specs=P("sp"),
                 out_specs=(P("sp"), P("sp")), check_vma=False)
        def f(x):
            return (jcoll.ring_shift(x, "sp"),
                    jcoll.ring_shift(x, "sp", reverse=True))

        down, up = f(x)
        res = _port_collective(name, x)
        np.testing.assert_array_equal(
            torch.cat([r[0] for r in res]).numpy(), np.asarray(down))
        np.testing.assert_array_equal(
            torch.cat([r[1] for r in res]).numpy(), np.asarray(up))
    elif name == "all_gather":
        x = rng.standard_normal((16, 4)).astype(np.float32)

        @partial(shard_map, mesh=mesh, in_specs=P("sp"),
                 out_specs=P("sp", None), check_vma=False)
        def f(x):
            return jcoll.ring_all_gather(x, "sp")

        want = np.asarray(f(x)).reshape(8, 8, 2, 4)
        for r, got in enumerate(_port_collective(name, x)):
            np.testing.assert_allclose(got.numpy(), want[r], atol=1e-6)
    elif name == "reduce_scatter":
        x = rng.standard_normal((8, 8 * 4)).astype(np.float32)

        @partial(shard_map, mesh=mesh, in_specs=P(None, "sp"),
                 out_specs=P("sp"), check_vma=False)
        def f(x):
            return jcoll.ring_reduce_scatter(x, "sp")[None]

        want = np.asarray(f(x))
        got = np.stack([r.numpy() for r in _port_collective(name, x)])
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:  # collective_matmul: the value and the gradient (JAX's test)
        x = rng.standard_normal((16, 8)).astype(np.float32)
        w = rng.standard_normal((8, 4)).astype(np.float32)

        @partial(shard_map, mesh=mesh, in_specs=(P("sp"), P(None, None)),
                 out_specs=P(None, None), check_vma=False)
        def mm(x_shard, w):
            return jcoll.collective_matmul(x_shard, w, "sp")

        want_y = np.asarray(mm(x, w))
        want_gw = np.asarray(jax.grad(lambda w: jnp.sum(mm(x, w) ** 2))(w))
        want_gx = np.asarray(jax.grad(lambda x: jnp.sum((x @ w) ** 2))(x))
        res = _port_collective(name, x, w)
        for r, (y, gw, gx) in enumerate(res):
            np.testing.assert_allclose(y.numpy(), want_y, atol=1e-5)
            np.testing.assert_allclose(gw.numpy(), want_gw, atol=1e-4)
            # every rank's loss is the whole product's: a shard's gradient
            # sums the 8 ranks' contributions
            np.testing.assert_allclose(gx.numpy() / 8,
                                       want_gx[r * 2:(r + 1) * 2], atol=1e-4)


# -- attention ------------------------------------------------------------------


@pytest.mark.parametrize("causal,tp", [(True, 1), (False, 1), (True, 2)],
                         ids=["causal", "full", "causal_tp2"])
def test_plain_ring_matches_jax(causal, tp):
    sp = SP // tp
    q, k, v = _inputs(4, 4, seed=1)
    mesh = _mesh(sp=sp, tp=tp)
    want = _jax_run(lambda q, k, v: j_ring(mesh, q, k, v, causal=causal),
                    q, k, v)
    got = _port_run(lambda rings, q, k, v: t_ring.ring_attention(
        rings, q, k, v, causal=causal), q, k, v, sp, tp)
    _close(got, want)


RING_FLASH_CASES = {
    # name: (H, Hkv, causal, layout, window, tp)
    "contiguous_causal": (4, 4, True, "contiguous", None, 1),
    "contiguous_full": (4, 4, False, "contiguous", None, 1),
    "zigzag": (4, 4, True, "zigzag", None, 1),
    "gqa_contiguous": (4, 2, True, "contiguous", None, 1),
    "gqa_zigzag": (4, 1, True, "zigzag", None, 1),
    # hops = ceil((window - 1) / chunk) at chunk 8: 0, 1 (a band hop),
    # 2 (a whole chunk through the kernel, then a band hop)
    "window_0_hops": (4, 2, True, "contiguous", 1, 1),
    "window_1_hop": (4, 2, True, "contiguous", 6, 1),
    "window_2_hops": (4, 2, True, "contiguous", 16, 1),
    "gqa_zigzag_tp2": (4, 2, True, "zigzag", None, 2),
}


@pytest.mark.parametrize("case", list(RING_FLASH_CASES))
def test_ring_flash_matches_jax(case):
    H, Hkv, causal, layout, window, tp = RING_FLASH_CASES[case]
    sp = SP // tp
    q, k, v = _inputs(H, Hkv, seed=2)
    mesh = _mesh(sp=sp, tp=tp)
    want = _jax_run(lambda q, k, v: j_ring_flash(
        mesh, q, k, v, causal=causal, layout=layout, window=window,
        block_q=8, block_k=8), q, k, v)
    got = _port_run(lambda rings, q, k, v: t_ring_flash.ring_flash_attention(
        rings, q, k, v, causal=causal, layout=layout, window=window),
        q, k, v, sp, tp)
    _close(got, want)


@pytest.mark.parametrize("use_flash,causal", [(False, True), (True, True),
                                              (True, False)],
                         ids=["plain", "flash", "flash_full"])
def test_ulysses_matches_jax(use_flash, causal):
    q, k, v = _inputs(4, 4, seed=3)
    mesh = _mesh(sp=SP)
    want = _jax_run(lambda q, k, v: j_ulysses(
        mesh, q, k, v, causal=causal, use_flash=use_flash, block_q=16,
        block_k=16), q, k, v)
    got = _port_run(lambda rings, q, k, v: t_ulysses.ulysses_attention(
        rings, q, k, v, causal=causal, use_flash=use_flash), q, k, v, SP)
    _close(got, want)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ulysses_local_scale_matches_jax(causal):
    """``ulysses_attention_local(scale=)`` on the flash path, at a scale
    other than ``D ** -0.5``: the reference's local body under shard_map
    (which hands ``scale`` to its kernel) against the port's rank body."""
    from k8s_tpu.parallel.ulysses import ulysses_attention_local as j_local

    q, k, v = _inputs(4, 4, seed=5)
    mesh = _mesh(sp=SP)
    spec = P(None, "sp", None, None)
    fn = shard_map(partial(j_local, axis_name="sp", causal=causal,
                           scale=0.4, use_flash=True, block_q=16,
                           block_k=16),
                   mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                   check_vma=False)
    want = _jax_run(fn, q, k, v)
    got = _port_run(lambda rings, q, k, v: t_ulysses.ulysses_attention_local(
        q, k, v, rings.sp, causal=causal, scale=0.4, use_flash=True),
        q, k, v, SP)
    _close(got, want)
    # the default scale gives another answer: scale reached the kernel
    base = _port_run(lambda rings, q, k, v: t_ulysses.ulysses_attention_local(
        q, k, v, rings.sp, causal=causal, use_flash=True), q, k, v, SP)
    assert np.abs(base[0] - got[0]).max() > 1e-3


def test_ring_flash_lse_and_direct_backward():
    """The forward/backward pair the card drives directly (no autograd):
    o and lse against the whole-sequence flash, dq/dk/dv against its
    backward, for every variant, and the zigzag lse back in the
    contiguous layout."""
    from k8s_tpu_torch.ops import flash_attention as flash

    rng = np.random.default_rng(4)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (B, h, L, D)).astype(np.float32)) for h in (4, 2, 2, 4))
    scale = D ** -0.5
    for causal, layout, window in ((True, "contiguous", None),
                                   (True, "zigzag", None),
                                   (True, "contiguous", 12)):
        o_ref, lse_ref = flash.flash_fwd_plain(q, k, v, scale, causal, window)
        g_ref = flash.flash_bwd_plain(q, k, v, o_ref, lse_ref, do, scale,
                                      causal, window)
        kw = dict(causal=causal, layout=layout, window=window)
        Lc = L // SP

        def body(ring):
            sl = slice(ring.rank * Lc, (ring.rank + 1) * Lc)
            o, lse, saved = t_ring_flash.ring_flash_forward(
                q[:, :, sl], k[:, :, sl], v[:, :, sl], ring, **kw)
            return o, lse, t_ring_flash.ring_flash_backward(
                saved, do[:, :, sl], ring, **kw)

        res = ThreadRing.run(SP, body)
        join = lambda xs: torch.cat(xs, dim=2)  # noqa: E731
        torch.testing.assert_close(join([r[0] for r in res]), o_ref,
                                   atol=VAL_TOL, rtol=0)
        torch.testing.assert_close(join([r[1] for r in res]),
                                   lse_ref[..., 0], atol=VAL_TOL, rtol=0)
        for i, g in enumerate(g_ref):
            torch.testing.assert_close(join([r[2][i] for r in res]), g,
                                       atol=GRAD_TOL, rtol=0)


def test_refusals_match_the_reference():
    x, kv = torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 3, 16)
    odd = torch.zeros(1, 7, 4, 16)
    solo = tcoll.Ring()
    local = t_ring_flash.ring_flash_attention_local
    cases = [
        (lambda: local(x, kv, kv, solo), "Hkv dividing H"),
        (lambda: local(x, x, x, solo, causal=False, layout="zigzag"),
         "CAUSAL"),
        (lambda: local(odd, odd, odd, solo, layout="zigzag"),
         "even per-rank chunk"),
        (lambda: local(x, x, x, solo, causal=False, window=4),
         "causal=True"),
        (lambda: local(x, x, x, solo, layout="ring"), "unknown ring layout"),
    ]
    for fn, match in cases:
        with pytest.raises(ValueError, match=match):
            fn()

    def body(rings):
        with pytest.raises(ValueError, match="divisible"):
            t_ulysses.ulysses_attention(rings, x[:, :, :2], x[:, :, :2],
                                        x[:, :, :2])
        with pytest.raises(ValueError, match="H == Hkv"):
            t_ulysses.ulysses_attention(rings, x, x[:, :, :2], x[:, :, :2])
        return True

    assert ThreadRing.run_mesh(4, 1, body) == [True] * 4


def test_thread_ring_aborts_the_other_ranks():
    def body(ring):
        if ring.rank == 1:
            raise KeyError("rank 1 fails")
        return ring.shift(torch.ones(2))

    with pytest.raises(KeyError, match="rank 1 fails"):
        ThreadRing.run(3, body, timeout=30)
