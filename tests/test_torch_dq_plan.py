"""The dq kernel's plan (k8s_tpu_torch/ops/flash_attention.py:_dq_plan),
its walk, the delta it computes and the wrapper's checks, on the CPU.

``_dq_plan`` decides from the shape alone how the dq kernel covers a
problem: its body, the q rows a block owns, the keys of each tile it
streams, and its grid of one block per (batch and head, q tile).
``_dq_block_tiles`` is the kernel's walk of one block, written out in
Python.  The tests hold that every visible (q, k) pair is covered exactly
once and no tile is visited for nothing (against brute force from
``_keep_mask``), that walking the tiles with the kernel's formulas, delta
included, gives the JAX reference's dq (Pallas in interpret mode) and
``flash_bwd_plain``'s, that an ``o`` the tiled bodies cannot read (not
16-byte aligned, expanded) keeps the tiled body and reaches it as a
contiguous copy, and that the launch hands the C entry point its operands
in the order it reads them.  The kernels themselves are held
against the plain versions on the card by chip_smoke.py.  Inputs are made
with numpy from a seed.
"""

import contextlib
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_tpu.ops.flash_attention import _flash_bwd as jax_flash_bwd
from k8s_tpu.ops.flash_attention import _flash_fwd as jax_flash_fwd
from k8s_tpu_torch.ops import _common
from k8s_tpu_torch.ops import flash_attention as flash
from k8s_tpu_torch.ops.flash_attention import (
    NEG_INF,
    _bwd_operands,
    _check_launch,
    _dq_block_tiles,
    _dq_plan,
    _keep_mask,
    flash_bwd_plain,
)

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32

# (B, H, Hkv, L, Lk, D, causal, window, dtype): the main-path shapes, ragged
# lengths (1000, 301), GQA groups 1 and 4, windows under one tile (48, 1),
# bidirectional Lk != L, and the small-head and f32 bodies.
PLAN_CASES = [
    (8, 12, 12, 1024, 1024, 64, True, None, BF16),   # gpt2_train
    (1, 32, 8, 509, 509, 128, True, None, BF16),     # llama_509
    (1, 32, 8, 2048, 2048, 128, True, 256, BF16),    # window_2048
    (2, 4, 4, 1000, 1000, 64, True, None, BF16),
    (2, 8, 2, 301, 301, 128, True, None, F16),
    (1, 8, 2, 509, 509, 128, True, 48, BF16),
    (1, 4, 4, 77, 77, 64, True, 1, BF16),
    (1, 8, 2, 301, 1000, 128, False, None, BF16),
    (2, 4, 1, 100, 257, 64, False, None, BF16),
    (2, 8, 2, 301, 301, 32, True, None, F16),
    (1, 4, 4, 77, 77, 16, True, 4, F32),
]


def _visible(L, Lk, causal, window):
    keep = _keep_mask(L, Lk, causal, window, "cpu")
    return np.ones((L, Lk), dtype=bool) if keep is None else keep.numpy()


@pytest.mark.parametrize("dtype,D,body,rows", [
    (BF16, 128, "wgmma", 128), (F16, 64, "wgmma", 128),
    (BF16, 32, "mma", 64), (F16, 16, "mma", 64), (F32, 128, "fma", 64),
    (F32, 16, "fma", 64)])
def test_plan_body_by_type_and_head_dim(dtype, D, body, rows):
    plan = _dq_plan(2, 4, 300, D, dtype)
    assert (plan.body, plan.block_rows, plan.block_keys) == (body, rows, rows)
    assert plan.grid == (2 * 4, -(-300 // rows))


@pytest.mark.parametrize("B,H,L,blocks", [
    (8, 12, 1024, 768),   # gpt2_train
    (1, 32, 509, 128),    # llama_509: 4 of 132 SMs idle, no split
    (1, 32, 2048, 512),   # llama_2048
])
def test_plan_blocks_at_the_main_path_shapes(B, H, L, blocks):
    plan = _dq_plan(B, H, L, 128 if H == 32 else 64)
    assert plan.body == "wgmma"
    assert plan.blocks == blocks
    assert plan.grid[0] == B * H  # one block per query head, not kv head


@pytest.mark.parametrize("B,H,Hkv,L,Lk,D,causal,window,dtype", PLAN_CASES)
def test_plan_covers_every_pair_once(B, H, Hkv, L, Lk, D, causal, window,
                                     dtype):
    plan = _dq_plan(B, H, L, D, dtype)
    heads, q_tiles = plan.grid
    assert heads == B * H
    assert (q_tiles - 1) * plan.block_rows < L <= q_tiles * plan.block_rows
    keep = _visible(L, Lk, causal, window)
    for qt in range(q_tiles):
        rows = slice(qt * plan.block_rows, (qt + 1) * plan.block_rows)
        tiles = _dq_block_tiles(plan, qt, Lk, causal, window)
        assert tiles == sorted(set(tiles))
        cover = np.zeros(Lk, dtype=int)
        for t0 in tiles:
            assert 0 <= t0 < Lk
            keys = slice(t0, t0 + plan.block_keys)
            assert keep[rows, keys].any(), "a key tile with no visible pair"
            cover[keys] += 1
        assert cover.max() <= 1
        seen = keep[rows].any(0)  # the keys some row of the tile sees
        assert (cover[seen] == 1).all(), "a visible pair not covered"


def _walk_dq(plan, q, k, v, o, lse, do, scale, causal, window):
    """dq as the kernel computes it: per q tile, delta = rowsum(do * o) in
    f32 for the tile's rows, then per visited key tile p from lse with the
    element mask, ds = p (dp - delta) scale and dq += ds.k, written once."""
    B, H, L, D = q.shape
    G = H // k.shape[1]
    kr, vr = (t.repeat_interleave(G, dim=1) for t in (k, v))
    keep = torch.from_numpy(_visible(L, k.shape[2], causal, window))
    safe = torch.where(lse <= NEG_INF / 2, 0.0, lse)
    dq = torch.zeros_like(q)
    for qt in range(plan.grid[1] - 1, -1, -1):  # the kernel's launch order
        rows = slice(qt * plan.block_rows, (qt + 1) * plan.block_rows)
        delta = (do[:, :, rows] * o[:, :, rows]).sum(-1, keepdim=True)
        acc = torch.zeros_like(q[:, :, rows])
        for t0 in _dq_block_tiles(plan, qt, k.shape[2], causal, window):
            keys = slice(t0, t0 + plan.block_keys)
            s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, rows],
                             kr[:, :, keys]) * scale
            p = torch.where(keep[rows, keys], torch.exp(s - safe[:, :, rows]),
                            0.0)
            dp = torch.einsum("bhqd,bhkd->bhqk", do[:, :, rows],
                              vr[:, :, keys])
            ds = p * (dp - delta) * scale
            acc += torch.einsum("bhqk,bhkd->bhqd", ds, kr[:, :, keys])
        dq[:, :, rows] = acc
    return dq


@pytest.mark.parametrize("B,H,Hkv,L,Lk,D,causal,window", [
    (1, 4, 1, 150, 150, 64, True, None),   # ragged, GQA 4
    (1, 2, 2, 300, 300, 64, True, 40),     # window under one tile, GQA 1
    (1, 2, 2, 70, 190, 128, False, None),  # bidirectional, Lk != L
])
def test_block_walk_matches_pallas_and_plain(B, H, Hkv, L, Lk, D, causal,
                                             window):
    rng = np.random.RandomState(0)
    q, do = (rng.standard_normal((B, H, L, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, Hkv, Lk, D)).astype(np.float32)
            for _ in range(2))
    scale = D ** -0.5
    G = H // Hkv
    kr = jnp.repeat(jnp.asarray(k), G, axis=1)
    vr = jnp.repeat(jnp.asarray(v), G, axis=1)
    o, lse = jax_flash_fwd(jnp.asarray(q), kr, vr, scale, causal, L, Lk,
                           True, window)
    dq_j = jax_flash_bwd(jnp.asarray(q), kr, vr, o, lse, jnp.asarray(do),
                         scale, causal, L, Lk, True, window)[0]
    args = [torch.from_numpy(np.array(a)) for a in (q, k, v, o, lse, do)]
    plan = _dq_plan(B, H, L, D)
    got = _walk_dq(plan, *args, scale, causal, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(dq_j), atol=2e-5,
                               rtol=2e-5)
    ref = flash_bwd_plain(*args, scale, causal, window)[0]
    assert (got - ref).abs().max().item() <= 1e-5 * max(
        1.0, ref.abs().max().item())


def _bf16(shape, offset=0, row_pad=0):
    """A bf16 [B, H, L, D] view whose rows are ``row_pad`` elements apart
    beyond D and whose data starts ``offset`` elements into its storage."""
    B, H, L, D = shape
    n = B * H * L * (D + row_pad) + offset
    flat = torch.zeros(n, dtype=BF16)[offset:]
    return flat.view(B, H, L, D + row_pad)[..., :D]


def _dq_operands():
    q = _bf16((1, 4, 33, 64))
    k = _bf16((1, 2, 33, 64))
    return {"q": q, "k": k, "v": k.clone(), "do": q.clone(), "o": q.clone()}


def _dq_body_and_o(ops):
    """The dq plan's body for these operands, after the wrapper's checks
    (which no layout fails), and ``o`` as that body reads it."""
    _check_launch(*ops.values())
    B, H, L, D = ops["q"].shape
    lse = torch.zeros(B, H, L)
    _, o, _, _ = _bwd_operands(ops["q"], ops["o"], lse, ops["do"])
    return _dq_plan(B, H, L, D, ops["q"].dtype).body, o


def test_check_launch_accepts_the_dq_operands():
    ops = _dq_operands()
    assert _check_launch(*ops.values()) == 1


@pytest.mark.parametrize("offset,row_pad", [
    (1, 0),   # data 2 bytes past a 16-byte boundary
    (0, 4),   # rows 68 elements apart: not a multiple of 8
    (0, 1),
])
def test_misaligned_o_is_copied_for_the_tiled_body(offset, row_pad):
    ops = _dq_operands()
    body, o = _dq_body_and_o(ops)
    assert body == "wgmma" and o is ops["o"]
    ops["o"] = _bf16((1, 4, 33, 64), offset, row_pad)
    body, o = _dq_body_and_o(ops)
    assert body == "wgmma" and o.data_ptr() != ops["o"].data_ptr()
    assert o.is_contiguous() and o.data_ptr() % 16 == 0
    assert torch.equal(o, ops["o"])


def test_broadcast_o_is_copied_for_the_tiled_body():
    ops = _dq_operands()
    ops["o"] = torch.ones(1, 4, 1, 64, dtype=BF16).expand(1, 4, 33, 64)
    body, o = _dq_body_and_o(ops)
    assert body == "wgmma" and o.is_contiguous() and o.stride(2) == 64
    assert torch.equal(o, ops["o"])


def test_check_launch_refuses_o_of_another_type():
    ops = _dq_operands()
    ops["o"] = ops["o"].to(F16)
    with pytest.raises(TypeError, match="all inputs alike"):
        _check_launch(*ops.values())


def test_bwd_operands_make_o_and_do_kernel_ready():
    """A misaligned o or an expanded do becomes a contiguous copy; an
    aligned strided view ([B, L, H, D] read as [B, H, L, D]) is kept as it
    is; delta is a fresh [B, H, L] f32 buffer for the dq kernel to fill."""
    q = _bf16((1, 4, 33, 64))
    o = _bf16((1, 4, 33, 64), 1, 0)
    do = torch.ones(1, 4, 1, 64, dtype=BF16).expand(1, 4, 33, 64)
    lse = torch.zeros(1, 4, 33, 1)
    do_k, o_k, lse_k, delta = _bwd_operands(q, o, lse, do)
    for t, src in ((do_k, do), (o_k, o)):
        assert t.is_contiguous() and torch.equal(t, src)
    assert lse_k.shape == (1, 4, 33) and lse_k.is_contiguous()
    assert delta.shape == (1, 4, 33) and delta.dtype == F32
    view = torch.zeros(1, 33, 4, 64, dtype=BF16).transpose(1, 2)
    _, o_view, _, _ = _bwd_operands(q, view, lse, view)
    assert o_view.data_ptr() == view.data_ptr()


def test_dq_launch_hands_the_entry_point_its_operands(monkeypatch):
    """``k8s_flash_bwd_dq(q, k, v, do, o, lse, delta, dq, dtype, B, H, Hkv,
    L, Lk, D, strides, scale, causal, window, Dp, stream)`` with 18
    strides: q, k, v, do, dq, then o (csrc/flash_bwd.cuh)."""
    seen = {}

    def fake(*args):
        seen["args"] = args
        seen["strides"] = ctypes.cast(
            args[15], ctypes.POINTER(ctypes.c_int64))[:18]
        return 0

    ops = _dq_operands()
    ops["o"] = torch.zeros(1, 33, 4, 64, dtype=BF16).transpose(1, 2)
    lse, delta = torch.zeros(1, 4, 33), torch.zeros(1, 4, 33)
    dq = torch.empty_like(ops["q"])
    monkeypatch.setitem(flash._fns, "bwd_dq", fake)
    monkeypatch.setattr(flash.torch.cuda, "device", contextlib.nullcontext)
    monkeypatch.setattr(flash, "_stream", lambda t: 0)
    monkeypatch.setattr(_common, "LAUNCHES", {})
    plan = _dq_plan(1, 4, 33, 64, BF16)
    flash._launch_bwd("bwd_dq", plan, ops["q"], ops["k"], ops["v"], ops["do"],
                      lse, delta, (dq,), 0.125, True, 7, o=ops["o"])
    args = seen["args"]
    order = (ops["q"], ops["k"], ops["v"], ops["do"], ops["o"], lse, delta, dq)
    assert list(args[:8]) == [t.data_ptr() for t in order]
    assert args[8:15] == (1, 1, 4, 2, 33, 33, 64)
    assert args[16:19] == (0.125, 1, 7)
    want = [t.stride(i) for t in (ops["q"], ops["k"], ops["v"], ops["do"], dq,
                                  ops["o"]) for i in (0, 1, 2)]
    assert seen["strides"] == want
    assert _common.launches()["flash_bwd_dq"] == 1
