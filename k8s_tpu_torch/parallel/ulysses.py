"""Ulysses (all-to-all) sequence parallelism: the port of
``k8s_tpu/parallel/ulysses.py``.

Inputs arrive sequence-sharded, ``[B, L/sp, H, D]`` on each rank of the
``sp`` ring; one all-to-all exchanges the sequence shards for head shards,
giving every rank the whole sequence for H/sp heads; attention runs
locally (the flash kernels unchanged: heads are independent); a second
all-to-all restores the sequence sharding.  Two all-to-alls of the
activations a layer, whatever the sequence length.

With ``use_flash`` the attention is the flash forward (the CUDA kernel on
the card) and the backward the flash backward kernels, through
:func:`ulysses_flash_forward` / :func:`ulysses_flash_backward` joined by
an autograd Function; without it, the plain whole-sequence attention, and
autograd through the all-to-alls (each its own transpose).
"""

from __future__ import annotations

import torch

from k8s_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
from k8s_tpu_torch.parallel.collectives import MeshRings, Ring, all_to_all
from k8s_tpu_torch.parallel.ring_attention import reference_attention


def check_heads(H: int, Hkv: int, sp: int) -> None:
    if H % sp:
        raise ValueError(
            f"Ulysses needs heads ({H}) divisible by the sp axis ({sp}); "
            "use ring attention for H < sp")
    if Hkv != H:
        raise ValueError(
            f"Ulysses needs H == Hkv (got {H} vs {Hkv}); repeat "
            "grouped-query KV heads first")


def _to_blocks(x, sp: int):
    """``[B, Lc, H, D]`` -> ``[sp, B, Lc, H/sp, D]``: block j holds head
    group j, the one rank j owns during attention."""
    B, Lc, H, D = x.shape
    return x.reshape(B, Lc, sp, H // sp, D).permute(2, 0, 1, 3, 4)


def seq_to_heads(x, ring: Ring):
    """``[B, Lc, H, D]`` -> ``[B, sp*Lc, H/sp, D]``: give away the other
    head groups, receive the other ranks' sequence chunks of ours (rank
    order is sequence order, as rank i owns chunk i).  Differentiable."""
    sp = ring.size
    B, Lc, H, D = x.shape
    got = all_to_all(_to_blocks(x, sp).contiguous(), ring)
    return got.permute(1, 0, 2, 3, 4).reshape(B, sp * Lc, H // sp, D)


def heads_to_seq(x, ring: Ring):
    """The inverse: ``[B, sp*Lc, H/sp, D]`` -> ``[B, Lc, H, D]``."""
    sp = ring.size
    B, L, Hs, D = x.shape
    blocks = x.reshape(B, sp, L // sp, Hs, D).permute(1, 0, 2, 3, 4)
    got = all_to_all(blocks.contiguous(), ring)
    return got.permute(1, 2, 0, 3, 4).reshape(B, L // sp, sp * Hs, D)


def ulysses_flash_forward(q, k, v, ring: Ring, *, causal: bool = True,
                          scale: float | None = None):
    """One rank's Ulysses forward through the flash kernel: q, k, v ``[B,
    Lc, H, D]``.  Returns ``(out [B, Lc, H, D], saved)``."""
    B, Lc, H, D = q.shape
    check_heads(H, k.shape[2], ring.size)
    if scale is None:
        scale = D ** -0.5
    qh, kh, vh = (seq_to_heads(t, ring).transpose(1, 2) for t in (q, k, v))
    oh, lse = flash_fwd(qh, kh, vh, scale, causal)
    out = heads_to_seq(oh.transpose(1, 2), ring)
    return out, (qh, kh, vh, oh, lse)


def ulysses_flash_backward(saved, do, ring: Ring, *, causal: bool = True,
                           scale: float | None = None):
    """One rank's Ulysses backward: ``saved`` from
    :func:`ulysses_flash_forward`, ``do`` ``[B, Lc, H, D]``; returns
    ``(dq, dk, dv)`` ``[B, Lc, H, D]``."""
    qh, kh, vh, oh, lse = saved
    if scale is None:
        scale = qh.shape[-1] ** -0.5
    doh = seq_to_heads(do, ring).transpose(1, 2)
    grads = flash_bwd(qh, kh, vh, oh, lse, doh, scale, causal)
    return tuple(heads_to_seq(g.transpose(1, 2), ring) for g in grads)


class _UlyssesFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ring, causal, scale):
        out, saved = ulysses_flash_forward(q, k, v, ring, causal=causal,
                                           scale=scale)
        ctx.save_for_backward(*saved)
        ctx.ring, ctx.causal, ctx.scale = ring, causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        grads = ulysses_flash_backward(ctx.saved_tensors, do, ctx.ring,
                                       causal=ctx.causal, scale=ctx.scale)
        return (*grads, None, None, None)


def ulysses_attention_local(q, k, v, ring: Ring, *, causal: bool = True,
                            scale: float | None = None,
                            use_flash: bool = False):
    """One rank's Ulysses attention: q, k, v ``[B, chunk, H, D]`` with H
    divisible by sp and H == Hkv.  Returns ``[B, chunk, H, D]`` in
    q.dtype.  ``scale`` is the flash path's softmax scale (``D ** -0.5``
    when None); the plain path, as the reference's, always takes ``D **
    -0.5``."""
    check_heads(q.shape[2], k.shape[2], ring.size)
    if use_flash:
        return _UlyssesFlash.apply(q, k, v, ring, causal, scale)
    qh, kh, vh = (seq_to_heads(t, ring) for t in (q, k, v))
    out = reference_attention(qh, kh, vh, causal=causal).to(q.dtype)
    return heads_to_seq(out, ring)


def ulysses_attention(rings: MeshRings, q, k, v, *, causal: bool = True,
                      use_flash: bool = False):
    """One rank's entry (the reference's ``P(batch, "sp", None, None)``):
    unlike the rings, heads are not split over tp here, since Ulysses
    already spends the head dim on the sp axis."""
    return ulysses_attention_local(q, k, v, rings.sp, causal=causal,
                                   use_flash=use_flash)
