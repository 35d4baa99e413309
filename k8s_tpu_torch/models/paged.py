"""Block-table paged attention: the decode-step seam between the serving
engine's pooled KV cache and the attention math.

Port of ``k8s_tpu/models/paged.py`` (``quantize_kv``,
``paged_kv_write``, ``paged_attention``) in plain PyTorch.  The engine
(models/engine.py) keeps decode KV state in one shared block-granular
pool per cache leaf (``[num_blocks, block_size, kv_heads, head_dim]``)
addressed through per-request **block tables**.  The transformer's
paged decode step writes new K/V straight into the pool at
``(table[pos // block], pos % block)`` (:func:`paged_kv_write`, in
place) and attends through :func:`paged_attention`, which gathers the
rows' blocks in table order and runs the dense path's grouped einsum and
masked f32 softmax over them.  It is plain torch in the reference too
(XLA, not a Pallas kernel); a decode-attention kernel would replace this
body without touching the engine or the transformer.

Conventions (the reference's):

- ``tables`` is ``[B, max_blocks]`` int; entry 0 is the engine's
  reserved **null block** — table padding points there and nothing valid
  ever reads it.  Write-masked lanes change no pool bit: their store is
  masked to the null block's slot 0 holding its own content, so masked
  rows never reach a live block.  The table may be narrower than the engine's full rows: the
  view covers ``tables.shape[1] * block_size`` positions, and the caller
  passes as many leading columns as its rows' positions reach.
- ``lengths`` is ``[B]``: the row's written length BEFORE this chunk.
  View index ``p`` is absolute position ``p``, so validity is purely
  length-based: positions below ``lengths`` are the row's own (or
  shared) content; everything above — recycled-block garbage,
  copy-on-write residue — is masked without any scrubbing pass.
- ``positions`` is ``[B, Lc]`` absolute query positions.  **-1 marks a
  write-masked slot** (an inactive row).  Masked queries attend nothing
  and their K/V writes are dropped.
- int8 KV pools carry ``k_scale`` / ``v_scale`` leaves ``[N, bs,
  kv_heads]``; dequantization happens after the block gather, in f32,
  with the product cast once, exactly as in the dense path.

The reference's tensor-parallel variants (``paged_kv_write_tp``,
``paged_attention_tp``) come with the ``parallel/`` slice of the port.
"""

from __future__ import annotations

import torch

MASK_VALUE = -1e30


def quantize_kv(x):
    """Symmetric per-vector absmax int8 quantization for KV storage:
    ``x`` is ``[..., D]`` vectors; returns ``(q int8 [..., D], scale f32
    [...])``.  ``torch.round`` rounds half to even, as the reference does,
    so the int8 values are bit-identical."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.round(x32 / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def paged_kv_write(leaf, tables, positions, x, *, scale_leaf=None,
                   quantize: bool = False):
    """Store chunk K/V straight into the pool, in place: ``x`` is ``[B,
    Lc, H, D]`` vectors for absolute ``positions`` ``[B, Lc]``; each lands
    at ``(tables[b, p // bs], p % bs)``.  Write-masked lanes (position
    -1) are never clipped into a live block: they are masked to store the
    null block's own slot 0 back onto itself, which leaves every pool bit
    as it was, with no host read of the mask (a ``nonzero`` would be one
    device sync per layer and leaf).  Returns ``(leaf, scale_leaf)`` (the
    same tensors, updated)."""
    bs = leaf.shape[1]
    keep = positions >= 0
    col = (positions.clamp_min(0) // bs).clamp_max(tables.shape[1] - 1)
    dst = torch.where(keep, torch.gather(tables.long(), 1, col), 0)
    off = torch.where(keep, positions % bs, 0)
    lanes = keep[..., None, None]
    if quantize:
        q, scale = quantize_kv(x)
        leaf[dst, off] = torch.where(lanes, q, leaf[0, 0])
        scale_leaf[dst, off] = torch.where(keep[..., None], scale,
                                           scale_leaf[0, 0])
    else:
        leaf[dst, off] = torch.where(lanes, x.to(leaf.dtype), leaf[0, 0])
    return leaf, scale_leaf


def paged_attention(q, pool_k, pool_v, tables, lengths, positions, *,
                    k_scale=None, v_scale=None, dtype=None,
                    mask_value: float = MASK_VALUE):
    """Attention for one batched decode chunk over the block pool.

    ``q`` is ``[B, Lc, H, D]`` post-rotary queries; ``pool_k`` /
    ``pool_v`` are ``[N, bs, Hkv, D]`` pool leaves that ALREADY contain
    this chunk's own K/V (write-then-attend, the dense path's order —
    int8 pools therefore see the same quantize/dequantize round trip on
    the chunk's own vectors).  Returns ``[B, Lc, H, D]``.

    The block-table gather in table order feeds the dense path's
    grouped-query einsum and masked f32 softmax
    (``transformer.Attention._decode_step``), element for element."""
    B, Lc, H, D = q.shape
    bs, kv_heads = pool_k.shape[1], pool_k.shape[2]
    S = tables.shape[1] * bs
    idx_t = tables.long()

    def gather(pool, scale):
        g = pool[idx_t]  # [B, MAXB, bs, Hkv, D] — table-order blocks
        if scale is not None:
            # dequantize in f32, cast the product once (the dense path's
            # _kv_cache_read contract)
            g = (g.float() * scale[idx_t][..., None]).to(dtype)
        return g.reshape(B, S, kv_heads, D)

    keys = gather(pool_k, k_scale)
    values = gather(pool_v, v_scale)
    # synthesized slot positions: index p IS position p below the row's
    # written length; the chunk's own (unmasked) positions become valid
    # for later in-chunk queries, exactly like the dense pos scatter.
    # Masked lanes scatter into a spare last column that is cut off.
    idx = torch.arange(S, device=q.device)
    kpos = torch.where(idx[None, :] < lengths[:, None], idx[None, :], -1)
    kpos = torch.cat([kpos, kpos.new_full((B, 1), -1)], dim=1)
    slot = torch.where(positions >= 0, positions, S).long()
    kpos = kpos.scatter(1, slot, positions.to(kpos.dtype))[:, :S]
    rep = H // kv_heads
    qg = q.reshape(B, Lc, kv_heads, rep, D)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg, keys).float()
    scores = scores * (D ** -0.5)
    mask = (kpos >= 0)[:, None, :] & \
        (kpos[:, None, :] <= positions[:, :, None])  # [B, Lc, S]
    scores = scores.masked_fill(~mask[:, None, None], mask_value)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs.to(values.dtype), values)
    return out.reshape(B, Lc, H, D)
