"""Ring attention: exact attention over sequence shards, the port of
``k8s_tpu/parallel/ring_attention.py`` (plain PyTorch, as the reference is
plain XLA with no Pallas).

Each rank of the ``sp`` ring holds one sequence chunk of Q, K and V.  K/V
chunks travel round the ring (:func:`~k8s_tpu_torch.parallel.collectives.
ring_shift`) while every rank folds its Q chunk's attention into an online
softmax, so the full score matrix never exists.  Causal masking uses
global chunk positions: on step ``s`` the rank holding Q chunk ``i`` sees
K chunk ``(i - s) mod sp``.  The backward is autograd's through the shifts
(each one's backward is the reverse shift).
"""

from __future__ import annotations

import torch

from k8s_tpu_torch.parallel.collectives import (
    MeshRings, Ring, ring_shift, tp_enter, tp_exit,
)

NEG_INF = -1e30


def _block_attn(q, k, v, mask, scale):
    """Scores and masked online-softmax pieces of one (Q chunk, K chunk)
    pair.  q ``[B, Lq, H, D]``, k/v ``[B, Lk, H, D]``, mask ``[Lq, Lk]``
    bool or None.  Returns (numerator ``[B, Lq, H, D]`` f32, the
    masked-row-safe row max, the row sum and the true row max, each
    ``[B, Lq, H]`` f32)."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if mask is not None:
        scores = torch.where(mask[None, None], scores, NEG_INF)
    m = scores.amax(dim=-1)  # [B, H, Lq]
    # a fully masked row: exp(NEG_INF - NEG_INF) would be 1
    safe_m = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.exp(scores - safe_m[..., None])
    if mask is not None:
        p = torch.where(mask[None, None], p, 0.0)
    l = p.sum(dim=-1)
    num = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return (num, safe_m.transpose(1, 2), l.transpose(1, 2),
            m.transpose(1, 2))


def _combine(acc, m_acc, l_acc, num, m_blk, l_blk, m_raw):
    """Merge one block's numerator and statistics into the running
    accumulator; a fully masked side weighs 0."""
    new_m = torch.maximum(m_acc, m_raw)
    safe_new_m = torch.where(new_m <= NEG_INF / 2, 0.0, new_m)
    alpha = torch.where(m_acc <= NEG_INF / 2, 0.0,
                        torch.exp(m_acc - safe_new_m))
    beta = torch.where(m_raw <= NEG_INF / 2, 0.0,
                       torch.exp(m_blk - safe_new_m))
    acc = acc * alpha[..., None] + num * beta[..., None]
    return acc, new_m, l_acc * alpha + l_blk * beta


def ring_attention_local(q, k, v, ring: Ring, *, causal: bool = True,
                         scale: float | None = None):
    """One rank's ring attention: q, k, v ``[B, chunk, H, D]``, this
    rank's chunk of the sequence.  Returns ``[B, chunk, H, D]`` in
    q.dtype."""
    B, Lq, H, D = q.shape
    n, me = ring.size, ring.rank
    if scale is None:
        scale = D ** -0.5
    acc = torch.zeros((B, Lq, H, D), dtype=torch.float32, device=q.device)
    m_acc = torch.full((B, Lq, H), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_acc = torch.zeros((B, Lq, H), dtype=torch.float32, device=q.device)
    pos = torch.arange(Lq, device=q.device)
    k_cur, v_cur = k, v
    for s in range(n):
        mask = None
        if causal:
            # future chunk: fully masked; diagonal: triangular; past: full
            c = (me - s) % n
            mask = (me * Lq + pos[:, None]) >= (c * Lq + pos[None, :])
        num, m_blk, l_blk, m_raw = _block_attn(q, k_cur, v_cur, mask, scale)
        acc, m_acc, l_acc = _combine(acc, m_acc, l_acc, num, m_blk, l_blk,
                                     m_raw)
        if s < n - 1:  # the last hop would bring nothing new
            k_cur = ring_shift(k_cur, ring)
            v_cur = ring_shift(v_cur, ring)
    out = acc / l_acc.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


def ring_attention(rings: MeshRings, q, k, v, *, causal: bool = True):
    """One rank's entry: q, k, v ``[B, chunk, H, D]`` (this rank's rows
    and sequence chunk, every head).  Heads split over the ``tp`` ring,
    the sequence rides the ``sp`` ring, and the heads are gathered back:
    the reference's ``P(batch, "sp", "tp", None)``."""
    q, k, v = (tp_enter(t, rings.tp, 2) for t in (q, k, v))
    out = ring_attention_local(q, k, v, rings.sp, causal=causal)
    return tp_exit(out, rings.tp, 2)


def reference_attention(q, k, v, *, causal: bool = True):
    """Whole-sequence attention for the checks: plain softmax over
    ``[B, L, H, D]``, f32 accumulation."""
    B, L, H, D = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * D ** -0.5
    if causal:
        mask = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask[None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
