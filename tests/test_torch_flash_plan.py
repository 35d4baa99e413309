"""The dk/dv kernel's plan (k8s_tpu_torch/ops/flash_attention.py:_dkv_plan)
and the wrapper's checks, on the CPU.

``_dkv_plan`` decides from the shape alone how the dk/dv kernel covers a
problem: its body, the keys a block owns, the q rows it streams, and into
how many chunks each block's (query head, q tile) list is split when the
unsplit grid would leave SMs idle.  ``_dkv_block_items`` is the kernel's
walk of one block, written out in Python; the tests hold that every key
tile and every (head, visible q tile) pair is covered exactly once, that
the split-then-group-sum order gives ``flash_bwd_plain``'s dk/dv, and that
misaligned 16-bit operands are refused before any launch.  The kernels
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


@pytest.mark.parametrize("which,offset,row_pad", [
    ("q", 1, 0),   # data 2 bytes past a 16-byte boundary
    ("k", 0, 4),   # rows 68 elements apart: not a multiple of 8
    ("v", 0, 1),
])
def test_check_launch_refuses_misaligned_16bit(which, offset, row_pad):
    ops = {"q": _bf16((1, 4, 33, 64)), "k": _bf16((1, 2, 33, 64)),
           "v": _bf16((1, 2, 33, 64))}
    ops[which] = _bf16(tuple(ops[which].shape), offset, row_pad)
    with pytest.raises(ValueError, match="16-byte aligned bf16/fp16 rows"):
        _check_launch(ops["q"], ops["k"], ops["v"])


def test_check_launch_refuses_broadcast_rows():
    """A stride of 0 (an expanded tensor) is no row layout a tensor map
    can describe."""
    q = _bf16((1, 4, 33, 64))
    k = torch.zeros(1, 2, 1, 64, dtype=BF16).expand(1, 2, 33, 64)
    with pytest.raises(ValueError, match="16-byte aligned bf16/fp16 rows"):
        _check_launch(q, k, k)


def test_check_launch_refuses_strided_head_dim():
    q = torch.zeros(1, 4, 33, 128, dtype=BF16)[..., ::2]
    k = torch.zeros(1, 2, 33, 64, dtype=BF16)
    with pytest.raises(ValueError, match="contiguous head_dim"):
        _check_launch(q, k, k.clone())
