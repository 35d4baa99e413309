"""The dk/dv kernel's plan (k8s_tpu_torch/ops/flash_attention.py:_dkv_plan)
and the wrapper's checks, on the CPU.

``_dkv_plan`` decides from the shape alone how the dk/dv kernel covers a
problem: its body, the keys a block owns, the q rows it streams, and into
how many chunks each block's (query head, q tile) list is split when the
unsplit grid would leave SMs idle.  ``_dkv_block_items`` is the kernel's
walk of one block, written out in Python; the tests hold that every key
tile and every (head, visible q tile) pair is covered exactly once, that
the split-then-group-sum order gives ``flash_bwd_plain``'s dk/dv, and that
16-bit operands no tensor map can describe (misaligned, expanded, a strided
head_dim) pass the wrapper's checks, keep the tiled body their head_dim
has, and reach it as contiguous copies.  The kernels
themselves are held against the plain versions on the card by
chip_smoke.py.  Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

from k8s_tpu_torch.ops.flash_attention import (
    N_SMS,
    NEG_INF,
    _check_launch,
    _dkv_block_items,
    _dkv_group_sum,
    _dkv_plan,
    _fwd_plan,
    _readable,
    flash_bwd_plain,
    flash_fwd_plain,
)

BF16, F32 = torch.bfloat16, torch.float32

# (B, H, Hkv, L, Lk, D, causal, window, dtype): the main-path shapes, then
# ragged lengths, windows smaller than a tile, bidirectional Lk != L, GQA
# groups 1 and 4, and the small-head and f32 bodies.
PLAN_CASES = [
    (8, 12, 12, 1024, 1024, 64, True, None, BF16),   # gpt2_train
    (1, 32, 8, 509, 509, 128, True, None, BF16),     # llama_509
    (1, 32, 8, 2048, 2048, 128, True, 256, BF16),    # window_2048
    (2, 4, 4, 1000, 1000, 64, True, None, BF16),
    (2, 8, 2, 301, 301, 128, True, None, BF16),
    (1, 8, 2, 509, 509, 128, True, 48, BF16),
    (1, 4, 4, 77, 77, 64, True, 1, BF16),
    (1, 8, 2, 301, 1000, 128, False, None, BF16),
    (2, 4, 1, 100, 257, 64, False, None, BF16),
    (2, 8, 2, 301, 301, 32, True, None, torch.float16),
    (1, 4, 4, 77, 77, 16, True, 4, F32),
]


def _visible(L, Lk, causal, window):
    qp = np.arange(L)[:, None]
    kp = np.arange(Lk)[None, :]
    keep = np.ones((L, Lk), dtype=bool)
    if causal:
        keep &= kp <= qp
        if window is not None:
            keep &= qp - kp < window
    return keep


def test_plan_fills_the_card_at_llama_509():
    plan = _dkv_plan(1, 32, 8, 509, 509, 128, True)
    assert plan.body == "wgmma"
    assert plan.nsplit > 1
    assert plan.blocks >= N_SMS == 132


def test_plan_keeps_gpt2_train_unsplit():
    plan = _dkv_plan(8, 12, 12, 1024, 1024, 64, True)
    assert (plan.body, plan.nsplit) == ("wgmma", 1)
    assert plan.grid == (1024 // 128, 8 * 12, 1)


@pytest.mark.parametrize("dtype,D,body", [
    (BF16, 128, "wgmma"), (torch.float16, 64, "wgmma"),
    (BF16, 32, "mma"), (torch.float16, 16, "mma"), (F32, 128, "fma")])
def test_plan_body_by_type_and_head_dim(dtype, D, body):
    plan = _dkv_plan(1, 4, 2, 300, 300, D, True, None, dtype)
    assert plan.body == body
    assert plan.block_keys == (128 if body == "wgmma" else 64)
    if body != "wgmma":
        assert plan.nsplit == 1


@pytest.mark.parametrize("B,H,Hkv,L,Lk,D,causal,window,dtype", PLAN_CASES)
def test_plan_covers_every_pair_once(B, H, Hkv, L, Lk, D, causal, window,
                                     dtype):
    plan = _dkv_plan(B, H, Hkv, L, Lk, D, causal, window, dtype)
    tiles, heads, nsplit = plan.grid
    assert heads == B * Hkv and nsplit == plan.nsplit >= 1
    assert (tiles - 1) * plan.block_keys < Lk <= tiles * plan.block_keys
    G = H // Hkv
    keep = _visible(L, Lk, causal, window)
    for kt in range(tiles):
        k_lo = kt * plan.block_keys
        sees = keep[:, k_lo:k_lo + plan.block_keys].any(1)  # [L]
        items = [it for z in range(nsplit) for it in _dkv_block_items(
            plan, kt, z, H, Hkv, L, causal, window)]
        assert len(items) == len(set(items))  # no (head, q tile) twice
        cover = np.zeros((G, L), dtype=int)
        for hh, q0 in items:
            assert 0 <= hh < G and 0 <= q0 < L
            rows = slice(q0, min(L, q0 + plan.q_tile))
            assert sees[rows].any(), "a q tile with no visible key"
            cover[hh, rows] += 1
        assert cover.max() <= 1
        assert (cover[:, sees] == 1).all(), "a visible pair not covered"


@pytest.mark.parametrize("B,H,Hkv,L,Lk,D,causal,window", [
    (1, 4, 2, 150, 150, 64, True, None),
    (2, 4, 1, 200, 200, 64, True, 40),
    (1, 4, 4, 70, 190, 128, False, None),
])
def test_split_then_group_sum_equals_plain(B, H, Hkv, L, Lk, D, causal,
                                           window):
    """Each chunk's f32 partial, computed from the plain formulas over the
    chunk's items only, summed in the wrapper's order, gives
    flash_bwd_plain's dk and dv."""
    plan = _dkv_plan(B, H, Hkv, L, Lk, D, causal, window)
    assert plan.body == "wgmma" and plan.nsplit > 1
    rng = np.random.RandomState(0)
    q, do = (torch.tensor(rng.standard_normal((B, H, L, D)), dtype=F32)
             for _ in range(2))
    k, v = (torch.tensor(rng.standard_normal((B, Hkv, Lk, D)), dtype=F32)
            for _ in range(2))
    scale = D ** -0.5
    o, lse = flash_fwd_plain(q, k, v, scale, causal, window)
    _, dk_ref, dv_ref = flash_bwd_plain(q, k, v, o, lse, do, scale, causal,
                                        window)

    # p and ds per (b, h, q, key), the kernel's formulas in f32
    G = H // Hkv
    kr, vr = (t.repeat_interleave(G, dim=1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q, kr) * scale
    keep = torch.tensor(_visible(L, Lk, causal, window))
    safe = torch.where(lse <= NEG_INF / 2, 0.0, lse)
    p = torch.where(keep, torch.exp(s - safe), 0.0)
    delta = (do * o).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do, vr) - delta) * scale

    part = torch.zeros(2, B, Hkv * plan.nsplit, Lk, D)
    for kt in range(plan.grid[0]):
        keys = slice(kt * plan.block_keys, (kt + 1) * plan.block_keys)
        for z in range(plan.nsplit):
            for hh, q0 in _dkv_block_items(plan, kt, z, H, Hkv, L, causal,
                                           window):
                rows = slice(q0, q0 + plan.q_tile)
                for hk in range(Hkv):
                    h, oh = hk * G + hh, hk * plan.nsplit + z
                    part[0, :, oh, keys] += torch.einsum(
                        "bqk,bqd->bkd", ds[:, h, rows, keys], q[:, h, rows])
                    part[1, :, oh, keys] += torch.einsum(
                        "bqk,bqd->bkd", p[:, h, rows, keys], do[:, h, rows])
    dk, dv = _dkv_group_sum(part, Hkv, plan.nsplit)
    for got, ref in ((dk, dk_ref), (dv, dv_ref)):
        assert got.shape == ref.shape
        err = (got - ref).abs().max().item()
        assert err <= 1e-5 * max(1.0, ref.abs().max().item())


def _bf16(shape, offset=0, row_pad=0):
    """A bf16 [B, H, L, D] view whose rows are ``row_pad`` elements apart
    beyond D and whose data starts ``offset`` elements into its storage."""
    B, H, L, D = shape
    n = B * H * L * (D + row_pad) + offset
    flat = torch.zeros(n, dtype=BF16)[offset:]
    return flat.view(B, H, L, D + row_pad)[..., :D]


def test_check_launch_accepts_aligned_operands():
    q = _bf16((1, 4, 33, 64))
    k = _bf16((1, 2, 33, 64))
    assert _check_launch(q, k, k.clone()) == 1


def _bodies_and_operands(q, k, v):
    """The body each kernel's plan names for these operands, after the
    wrapper's checks (which no layout fails), and the operands as that body
    reads them."""
    code = _check_launch(q, k, v)
    B, H, L, D = q.shape
    bodies = {_fwd_plan(B, H, L, D, q.dtype).body,
              _dkv_plan(B, H, k.shape[1], L, L, D, True, None,
                        q.dtype).body}
    (body,) = bodies
    return bodies, _readable(body, code, q, k, v)


def _is_tensor_map_ready(t):
    """Contiguous, 16-byte aligned rows: what the 16-bit tiled bodies read."""
    return t.is_contiguous() and t.data_ptr() % 16 == 0


@pytest.mark.parametrize("which,offset,row_pad", [
    ("q", 1, 0),   # data 2 bytes past a 16-byte boundary
    ("k", 0, 4),   # rows 68 elements apart: not a multiple of 8
    ("v", 0, 1),
])
def test_misaligned_16bit_is_copied_for_the_tiled_body(which, offset,
                                                      row_pad):
    ops = {"q": _bf16((1, 4, 33, 64)), "k": _bf16((1, 2, 33, 64)),
           "v": _bf16((1, 2, 33, 64))}
    ops[which] = _bf16(tuple(ops[which].shape), offset, row_pad)
    bodies, got = _bodies_and_operands(ops["q"], ops["k"], ops["v"])
    assert bodies == {"wgmma"}
    for name, t in zip(("q", "k", "v"), got):
        if name == which:
            assert t.data_ptr() != ops[name].data_ptr()
            assert _is_tensor_map_ready(t) and torch.equal(t, ops[name])
        else:
            assert t is ops[name]


def test_broadcast_rows_are_copied_for_the_tiled_body():
    """A stride of 0 (an expanded tensor) is no row layout a tensor map
    can describe: the tiled body reads a contiguous copy."""
    q = _bf16((1, 4, 33, 64))
    k = torch.zeros(1, 2, 1, 64, dtype=BF16).expand(1, 2, 33, 64)
    bodies, (q2, k2, v2) = _bodies_and_operands(q, k, k)
    assert bodies == {"wgmma"} and q2 is q
    for t in (k2, v2):
        assert _is_tensor_map_ready(t) and torch.equal(t, k)


def test_strided_head_dim_is_copied_for_the_tiled_body():
    q = torch.arange(4 * 33 * 128, dtype=F32).view(1, 4, 33, 128)
    q = q.to(BF16)[..., ::2]
    k = torch.zeros(1, 2, 33, 64, dtype=BF16)
    bodies, (q2, k2, _) = _bodies_and_operands(q, k, k.clone())
    assert bodies == {"wgmma"} and k2 is k
    assert _is_tensor_map_ready(q2) and torch.equal(q2, q)
