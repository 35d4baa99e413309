"""Fused linear + cross-entropy over vocabulary chunks, in plain PyTorch.

Port of ``k8s_tpu/ops/fused_ce.py``, whose reference is a ``lax.scan``
with no Pallas kernel, so the port is a ``torch.autograd.Function`` over a
Python loop of chunk products.  The LM loss's ``[T, V]`` logits exist only
to be reduced to one scalar; here the tied-embedding head is folded into an
online-softmax loss one ``[T, vocab_chunk]`` chunk at a time, so that is
the peak extra memory and ``[T, V]`` never exists.

Semantics match ``models/train.py``'s ``cross_entropy_loss``: each chunk's
product takes ``hidden.dtype``-rounded operands with f32 accumulation (an
f32 product of the rounded values), the loss math is f32, and
out-of-range targets (the ``label = -1`` padding idiom) add zero loss and
zero gradient while still counting in the mean's denominator.  The
optional z-loss adds ``z_loss * lse**2`` per valid token.  The backward
recomputes each chunk's logits against the saved log-sum-exp, as the
reference's custom VJP does.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _chunk_logits(h, emb, c0: int, vocab_chunk: int):
    """f32 logits of vocabulary rows [c0, c0 + vocab_chunk) (the last
    chunk may be shorter; the reference pads it with masked columns)."""
    emb_c = emb[c0:c0 + vocab_chunk]
    return torch.matmul(h.float(), emb_c.to(h.dtype).float().T)


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, emb, targets, vocab_chunk, z_loss):
        d = hidden.shape[-1]
        h = hidden.reshape(-1, d)
        tg = targets.reshape(-1).long()
        T, V = h.shape[0], emb.shape[0]
        m = torch.full((T,), NEG_INF, dtype=torch.float32, device=h.device)
        s = torch.zeros(T, dtype=torch.float32, device=h.device)
        t = torch.zeros(T, dtype=torch.float32, device=h.device)
        for c0 in range(0, V, vocab_chunk):
            logits = _chunk_logits(h, emb, c0, vocab_chunk)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=-1)
            local = tg - c0
            in_chunk = (local >= 0) & (local < logits.shape[1])
            picked = logits.gather(
                1, local.clamp(0, logits.shape[1] - 1)[:, None])[:, 0]
            t = t + torch.where(in_chunk, picked, 0.0)
            m = m_new
        lse = m + torch.log(s.clamp_min(1e-30))
        valid = (tg >= 0) & (tg < V)
        per_token = lse - t
        if z_loss:
            # PaLM-style stabilizer on log(Z)^2
            per_token = per_token + z_loss * lse.square()
        ctx.save_for_backward(hidden, emb, targets, lse)
        ctx.vocab_chunk, ctx.z_loss = vocab_chunk, z_loss
        return torch.where(valid, per_token, 0.0).sum() / T

    @staticmethod
    def backward(ctx, g):
        hidden, emb, targets, lse = ctx.saved_tensors
        vocab_chunk, z_loss = ctx.vocab_chunk, ctx.z_loss
        d = hidden.shape[-1]
        h = hidden.reshape(-1, d)
        tg = targets.reshape(-1).long()
        T, V = h.shape[0], emb.shape[0]
        valid = (tg >= 0) & (tg < V)
        # d loss / d logits[i, v] = valid_i * (softmax_iv - onehot_iv) / T;
        # the z-loss term adds valid_i * 2 z lse_i * softmax_iv / T
        coeff = (g / T) * valid.float()
        p_coeff = coeff * (1.0 + 2.0 * z_loss * lse) if z_loss else coeff
        h32 = h.float()
        dh = torch.zeros(T, d, dtype=torch.float32, device=h.device)
        demb = torch.zeros(V, d, dtype=torch.float32, device=h.device)
        for c0 in range(0, V, vocab_chunk):
            logits = _chunk_logits(h, emb, c0, vocab_chunk)
            C = logits.shape[1]
            dl = torch.exp(logits - lse[:, None]) * p_coeff[:, None]
            local = tg - c0
            in_chunk = (local >= 0) & (local < C)
            dl.scatter_add_(1, local.clamp(0, C - 1)[:, None],
                            -(coeff * in_chunk)[:, None])
            emb_c = emb[c0:c0 + C].float()
            dh += dl @ emb_c
            demb[c0:c0 + C] = dl.T @ h32
        return (dh.to(hidden.dtype).reshape(hidden.shape), demb.to(emb.dtype),
                None, None, None)


def fused_linear_cross_entropy(hidden, emb, targets, *,
                               vocab_chunk: int = 8192,
                               z_loss: float = 0.0):
    """Mean cross-entropy of ``hidden @ emb.T`` against ``targets``
    without materializing the ``[T, V]`` logits.

    hidden: ``[B, L, d]`` or ``[T, d]`` in the model dtype; emb: ``[V, d]``
    (any float dtype, rounded to hidden's per chunk); targets: int ``[B,
    L]`` or ``[T]``, out-of-range ids contribute zero.  ``z_loss``: weight
    of the log(Z)^2 stabilizer (0 disables).  Differentiable in hidden and
    emb.
    """
    if vocab_chunk < 1:
        raise ValueError(f"vocab_chunk must be >= 1, got {vocab_chunk}")
    return _FusedCE.apply(hidden, emb, targets, int(vocab_chunk),
                          float(z_loss))
