"""Ring flash attention: the flash kernels as the per-block compute of
sequence-parallel ring attention, the port of
``k8s_tpu/parallel/ring_flash.py``.

Each (Q chunk, K chunk) pair of the ring goes through the port's flash
forward (``ops.flash_attention.flash_fwd``: the CUDA kernel on the card,
its plain version on the CPU).  Two partial attentions over disjoint key
sets combine exactly as

    lse = logaddexp(lse_a, lse_b)
    out = out_a * exp(lse_a - lse) + out_b * exp(lse_b - lse)

so each ring step merges one flash call into the running (out, lse).  The
backward is a second ring pass: with the global lse, and delta =
rowsum(do * out) from the global out, the flash backward kernels
(``flash_bwd``) give the exact dq and the exact (dk, dv) contribution of
each pair on its own; the dk/dv accumulators travel round the ring with
their K/V chunks and arrive home after sp hops.

Three variants, each a forward and a backward over a
:class:`~k8s_tpu_torch.parallel.collectives.Ring` in the kernels' ``[B, H,
L, D]`` layout (:func:`ring_flash_forward`, :func:`ring_flash_backward`),
joined by one autograd Function:

- ``contiguous``: rank r holds chunk r; a causal ring skips the chunks
  after its own (rank r calls the kernels r + 1 times);
- ``zigzag`` (causal, even sp): the sequence is cut into 2·sp half
  chunks and rank r holds the pair (r, 2sp-1-r), so every ring step costs
  every rank one chunk of work: its own pair causal, an earlier rank's
  low half in full, or (from a later rank) its own high half against both
  of the other's halves.  Two permutations of half chunks each way move
  between the model's contiguous layout and the pairs;
- windowed (``window``, causal): only the ``ceil((window-1)/chunk)``
  preceding chunks are visited.  Hop 0 is the kernel with the window;
  a hop whose keys are all in the window is the kernel without a mask; the
  hops the band's edge crosses are plain PyTorch (:func:`_band_block`,
  plain XLA in the reference).  The backward replays the same hops and
  sends each hop's dk/dv straight home.

GQA is native: K/V ride the ring at their Hkv heads and the kernels read
kv head ``h // (H / Hkv)`` and sum dk/dv over each group, so dk/dv travel
at Hkv heads too.  Only the plain band blocks repeat K/V.
"""

from __future__ import annotations

import torch

from k8s_tpu_torch.ops.flash_attention import NEG_INF, flash_bwd, flash_fwd
from k8s_tpu_torch.parallel.collectives import (
    MeshRings, Ring, tp_enter, tp_exit,
)

LAYOUTS = ("contiguous", "zigzag")
_F32 = torch.float32

# scores of one plain band block held at a time: heads are taken in
# groups so that [heads, Lc, Lc] f32 stays near this many bytes
_BAND_BYTES = 1 << 29


def _merge(o_acc, lse_acc, o_blk, lse_blk):
    """Combine two partial attentions over disjoint key sets (f32; lse
    ``[B, H, L]``).  A side whose lse is NEG_INF (no visible key) weighs
    0 exactly."""
    lse_new = torch.logaddexp(lse_acc, lse_blk)
    safe = torch.where(lse_new <= NEG_INF / 2, 0.0, lse_new)
    w_acc = torch.where(lse_acc <= NEG_INF / 2, 0.0,
                        torch.exp(lse_acc - safe))
    w_blk = torch.where(lse_blk <= NEG_INF / 2, 0.0,
                        torch.exp(lse_blk - safe))
    return o_acc * w_acc[..., None] + o_blk * w_blk[..., None], lse_new


def _flash(q, k, v, scale, causal, window=None):
    o, lse = flash_fwd(q, k, v, scale, causal, window)
    return o.to(_F32), lse[..., 0]


def _bwd(q, k, v, o, lse, do, scale, causal, window=None):
    return tuple(g.to(_F32) for g in flash_bwd(q, k, v, o, lse, do, scale,
                                               causal, window))


def _check_layout(H: int, Hkv: int, Lc: int, *, causal: bool, layout: str,
                  window) -> None:
    """The reference's checks on a ring-flash call."""
    if Hkv == 0 or H % Hkv:
        raise ValueError(
            f"ring flash needs Hkv dividing H (got H={H}, Hkv={Hkv})")
    if layout not in LAYOUTS:
        raise ValueError(f"unknown ring layout {layout!r}")
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True (sliding-window "
                             "attention is a causal construction)")
        if window < 1:
            raise ValueError(f"window must be >= 1 (got {window})")
    elif layout == "zigzag":
        if not causal:
            raise ValueError(
                "zigzag layout only balances the CAUSAL ring (non-causal "
                "rings are already uniform); use layout='contiguous'")
        if Lc % 2:
            raise ValueError(f"zigzag needs an even per-rank chunk (got {Lc})")


# -- contiguous --------------------------------------------------------------


def _visits(me: int, n: int, causal: bool):
    """(step, k chunk, diagonal?) of each chunk the rank attends, in ring
    order; a causal ring skips the chunks after its own."""
    out = []
    for s in range(n):
        c = (me - s) % n
        if not causal or c <= me:
            out.append((s, c, c == me))
    return out


def _contig_fwd(q, k, v, ring, causal, scale):
    B, H, Lc, D = q.shape
    n, me = ring.size, ring.rank
    o = torch.zeros((B, H, Lc, D), dtype=_F32, device=q.device)
    lse = torch.full((B, H, Lc), NEG_INF, dtype=_F32, device=q.device)
    visits = {s: diag for s, _, diag in _visits(me, n, causal)}
    k_cur, v_cur = k, v
    for s in range(n):
        if s in visits:
            o, lse = _merge(o, lse, *_flash(q, k_cur, v_cur, scale,
                                            causal and visits[s]))
        if s < n - 1:
            k_cur, v_cur = ring.shift(k_cur), ring.shift(v_cur)
    return o.to(q.dtype), lse


def _contig_bwd(q, k, v, o, lse, do, ring, causal, scale):
    n, me = ring.size, ring.rank
    dq = torch.zeros(q.shape, dtype=_F32, device=q.device)
    dk = torch.zeros(k.shape, dtype=_F32, device=q.device)
    dv = torch.zeros(k.shape, dtype=_F32, device=q.device)
    visits = {s: diag for s, _, diag in _visits(me, n, causal)}
    k_cur, v_cur = k, v
    for s in range(n):
        if s in visits:
            dq_s, dk_s, dv_s = _bwd(q, k_cur, v_cur, o, lse, do, scale,
                                    causal and visits[s])
            dq += dq_s
            dk += dk_s
            dv += dv_s
        # the accumulators travel with their K/V chunk: after sp hops
        # each chunk's gradients are back on its owner
        dk, dv = ring.shift(dk), ring.shift(dv)
        if s < n - 1:
            k_cur, v_cur = ring.shift(k_cur), ring.shift(v_cur)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -- zigzag ------------------------------------------------------------------


def _zigzag_perms(n: int):
    """Where the low and the high half of each rank's contiguous chunk go:
    half chunk 2r -> rank of pair member 2r, 2r+1 likewise."""
    p1 = [2 * r if 2 * r < n else 2 * n - 1 - 2 * r for r in range(n)]
    p2 = [2 * r + 1 if 2 * r + 1 < n else 2 * n - 2 - 2 * r
          for r in range(n)]
    return p1, p2


def _permute(x, ring: Ring, perm, inverse: bool = False):
    """Every rank r sends to ``perm[r]`` (``inverse``: receives from it)."""
    me = ring.rank
    if inverse:
        return ring.sendrecv(x, perm.index(me), perm[me])
    return ring.sendrecv(x, perm[me], perm.index(me))


def _zigzag_to(x, ring: Ring):
    """Contiguous halves (2r, 2r+1) -> the zigzag pair (r, 2sp-1-r), split
    on dim 2 (the chunk's sequence dim in the kernels' layout)."""
    h0, h1 = x.chunk(2, dim=2)
    p1, p2 = _zigzag_perms(ring.size)
    a = _permute(h0.contiguous(), ring, p1)
    b = _permute(h1.contiguous(), ring, p2)
    # through p1 an even rank receives its low half, an odd one its high
    low, high = (a, b) if ring.rank % 2 == 0 else (b, a)
    return torch.cat([low, high], dim=2)


def _zigzag_from(x, ring: Ring):
    """The inverse of :func:`_zigzag_to`."""
    low, high = x.chunk(2, dim=2)
    p1, p2 = _zigzag_perms(ring.size)
    even = ring.rank % 2 == 0
    h0 = _permute((low if even else high).contiguous(), ring, p1, True)
    h1 = _permute((high if even else low).contiguous(), ring, p2, True)
    return torch.cat([h0, h1], dim=2)


def _zz_kind(me: int, j: int) -> str:
    return "diag" if j == me else ("low" if j < me else "high")


def _zigzag_core_fwd(q, k, v, ring, scale):
    """q, k, v in the zigzag layout; returns the zigzag (o, lse)."""
    B, H, Lc, D = q.shape
    half = Lc // 2
    n, me = ring.size, ring.rank
    o = torch.zeros((B, H, Lc, D), dtype=_F32, device=q.device)
    lse = torch.full((B, H, Lc), NEG_INF, dtype=_F32, device=q.device)
    k_cur, v_cur = k, v
    for s in range(n):
        kind = _zz_kind(me, (me - s) % n)
        if kind == "diag":  # own pair: low precedes high, plain causal
            o, lse = _merge(o, lse, *_flash(q, k_cur, v_cur, scale, True))
        elif kind == "low":  # both halves see the earlier rank's low half
            o, lse = _merge(o, lse, *_flash(q, k_cur[:, :, :half],
                                            v_cur[:, :, :half], scale, False))
        else:  # only the high half sees the later rank, both its halves
            o_h, lse_h = _merge(o[:, :, half:], lse[:, :, half:],
                                *_flash(q[:, :, half:], k_cur, v_cur, scale,
                                        False))
            o = torch.cat([o[:, :, :half], o_h], dim=2)
            lse = torch.cat([lse[:, :, :half], lse_h], dim=2)
        if s < n - 1:
            k_cur, v_cur = ring.shift(k_cur), ring.shift(v_cur)
    return o.to(q.dtype), lse


def _zigzag_core_bwd(q, k, v, o, lse, do, ring, scale):
    B, H, Lc, D = q.shape
    half = Lc // 2
    n, me = ring.size, ring.rank
    dq = torch.zeros(q.shape, dtype=_F32, device=q.device)
    dk = torch.zeros(k.shape, dtype=_F32, device=q.device)
    dv = torch.zeros(k.shape, dtype=_F32, device=q.device)
    k_cur, v_cur = k, v
    for s in range(n):
        kind = _zz_kind(me, (me - s) % n)
        if kind == "diag":
            dq_s, dk_s, dv_s = _bwd(q, k_cur, v_cur, o, lse, do, scale, True)
            dq += dq_s
            dk += dk_s
            dv += dv_s
        elif kind == "low":
            dq_s, dk_h, dv_h = _bwd(q, k_cur[:, :, :half],
                                    v_cur[:, :, :half], o, lse, do, scale,
                                    False)
            dq += dq_s
            dk[:, :, :half] += dk_h
            dv[:, :, :half] += dv_h
        else:
            dq_h, dk_s, dv_s = _bwd(q[:, :, half:], k_cur, v_cur,
                                    o[:, :, half:], lse[:, :, half:],
                                    do[:, :, half:], scale, False)
            dq[:, :, half:] += dq_h
            dk += dk_s
            dv += dv_s
        dk, dv = ring.shift(dk), ring.shift(dv)
        if s < n - 1:
            k_cur, v_cur = ring.shift(k_cur), ring.shift(v_cur)
    return dq, dk, dv


# -- windowed ----------------------------------------------------------------


def _window_hops(window: int, Lc: int, n: int) -> int:
    """How many preceding chunks a window of ``window`` reaches."""
    return min(n - 1, -(-(window - 1) // Lc))


def _band_keep(Lc: int, band: int, device):
    q_pos = torch.arange(Lc, device=device)[:, None]
    k_pos = torch.arange(Lc, device=device)[None, :]
    return (q_pos - k_pos) < band


def _head_groups(H: int, Hkv: int, Lc: int):
    """Head ranges of whole GQA groups, each small enough that one [heads,
    Lc, Lc] f32 block stays near ``_BAND_BYTES``."""
    g = H // Hkv
    per = max(1, _BAND_BYTES // (4 * Lc * Lc * g)) * g
    return [(h, min(H, h + per)) for h in range(0, H, per)]


def _band_block(q, k, v, scale, band):
    """Partial attention of q against a K chunk where only ``q_rel - k_rel
    < band`` is visible; returns (o f32, lse ``[B, H, Lc]``) in
    :func:`_merge`'s convention.  Plain PyTorch, a group of heads at a
    time."""
    B, H, Lc, D = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    keep = _band_keep(Lc, band, q.device)
    o = torch.empty((B, H, Lc, D), dtype=_F32, device=q.device)
    lse = torch.empty((B, H, Lc), dtype=_F32, device=q.device)
    for h0, h1 in _head_groups(H, Hkv, Lc):
        kh = k[:, h0 // g:h1 // g].float().repeat_interleave(g, dim=1)
        vh = v[:, h0 // g:h1 // g].float().repeat_interleave(g, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, h0:h1].float(), kh) * scale
        s = torch.where(keep, s, NEG_INF)
        m = s.amax(dim=-1)
        safe_m = torch.where(m <= NEG_INF / 2, 0.0, m)
        p = torch.where(keep, torch.exp(s - safe_m[..., None]), 0.0)
        del s
        den = p.sum(dim=-1)
        o[:, h0:h1] = torch.einsum("bhqk,bhkd->bhqd", p, vh) \
            / den.clamp_min(1e-30)[..., None]
        lse[:, h0:h1] = torch.where(m <= NEG_INF / 2, NEG_INF,
                                    m + torch.log(den.clamp_min(1e-30)))
    return o, lse


def _band_bwd(q, k, v, o, lse, do, scale, band):
    """Backward of :func:`_band_block` against the global lse (the flash
    backward's convention: p from the global lse, delta = rowsum(do * o)
    from the global o); dk/dv summed over each GQA group.  f32."""
    B, H, Lc, D = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    keep = _band_keep(Lc, band, q.device)
    dq = torch.empty((B, H, Lc, D), dtype=_F32, device=q.device)
    dk = torch.empty((B, Hkv, Lc, D), dtype=_F32, device=q.device)
    dv = torch.empty((B, Hkv, Lc, D), dtype=_F32, device=q.device)
    for h0, h1 in _head_groups(H, Hkv, Lc):
        qf, dof = q[:, h0:h1].float(), do[:, h0:h1].float()
        kf = k[:, h0 // g:h1 // g].float().repeat_interleave(g, dim=1)
        vf = v[:, h0 // g:h1 // g].float().repeat_interleave(g, dim=1)
        delta = (dof * o[:, h0:h1].float()).sum(-1)
        lse_h = lse[:, h0:h1]
        safe = torch.where(lse_h <= NEG_INF / 2, 0.0, lse_h)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
        p = torch.where(keep, torch.exp(s - safe[..., None]), 0.0)
        del s
        dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
        ds = p * (dp - delta[..., None]) * scale
        del dp
        dq[:, h0:h1] = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
        dk_h = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
        dv_h = torch.einsum("bhqk,bhqd->bhkd", p, dof)
        dk[:, h0 // g:h1 // g] = dk_h.view(B, -1, g, Lc, D).sum(2)
        dv[:, h0 // g:h1 // g] = dv_h.view(B, -1, g, Lc, D).sum(2)
    return dq, dk, dv


def _window_fwd(q, k, v, ring, window, scale):
    Lc = q.shape[2]
    n, me = ring.size, ring.rank
    w0 = window if window < Lc else None  # window >= Lc: plain causal
    o, lse = _flash(q, k, v, scale, True, w0)
    k_cur, v_cur = k, v
    for m in range(1, _window_hops(window, Lc, n) + 1):
        k_cur, v_cur = ring.shift(k_cur), ring.shift(v_cur)
        if me < m:  # chunk me attends chunks me - m >= 0 only
            continue
        band = window - m * Lc
        if band >= Lc:
            blk = _flash(q, k_cur, v_cur, scale, False)
        else:
            blk = _band_block(q, k_cur, v_cur, scale, band)
        o, lse = _merge(o, lse, *blk)
    return o.to(q.dtype), lse


def _window_bwd(q, k, v, o, lse, do, ring, window, scale):
    Lc = q.shape[2]
    n, me = ring.size, ring.rank
    w0 = window if window < Lc else None
    dq, dk, dv = _bwd(q, k, v, o, lse, do, scale, True, w0)
    k_cur, v_cur = k, v
    for m in range(1, _window_hops(window, Lc, n) + 1):
        k_cur, v_cur = ring.shift(k_cur), ring.shift(v_cur)
        band = window - m * Lc
        if me < m:  # a wrap-around hop: nothing to send home
            dk_m = torch.zeros_like(dk)
            dv_m = torch.zeros_like(dv)
        else:
            if band >= Lc:
                dq_m, dk_m, dv_m = _bwd(q, k_cur, v_cur, o, lse, do, scale,
                                        False)
            else:
                dq_m, dk_m, dv_m = _band_bwd(q, k_cur, v_cur, o, lse, do,
                                             scale, band)
            dq += dq_m
        # this hop's dk/dv belong to the chunk m ranks up-ring: send them
        # home in one permutation step
        dk += ring.sendrecv(dk_m, (me - m) % n, (me + m) % n)
        dv += ring.sendrecv(dv_m, (me - m) % n, (me + m) % n)
    return dq, dk, dv


# -- the variants' forward and backward, and their autograd Function ---------


def ring_flash_forward(q, k, v, ring: Ring, *, causal: bool = True,
                       scale: float | None = None,
                       layout: str = "contiguous", window=None):
    """One rank's ring-flash forward in the kernels' layout: q ``[B, H, Lc,
    D]``, k/v ``[B, Hkv, Lc, D]`` (this rank's contiguous chunk).  Returns
    ``(o [B, H, Lc, D] in q.dtype, lse [B, H, Lc] f32, saved)``, ``saved``
    the tensors :func:`ring_flash_backward` takes."""
    B, H, Lc, D = q.shape
    _check_layout(H, k.shape[1], Lc, causal=causal, layout=layout,
                 window=window)
    if scale is None:
        scale = D ** -0.5
    if window is not None:
        o, lse = _window_fwd(q, k, v, ring, int(window), scale)
        return o, lse, (q, k, v, o, lse)
    if layout == "zigzag":
        qz, kz, vz = (_zigzag_to(t, ring) for t in (q, k, v))
        oz, lsez = _zigzag_core_fwd(qz, kz, vz, ring, scale)
        o = _zigzag_from(oz, ring)
        lse = _zigzag_from(lsez[..., None], ring)[..., 0]
        return o, lse, (qz, kz, vz, oz, lsez)
    o, lse = _contig_fwd(q, k, v, ring, causal, scale)
    return o, lse, (q, k, v, o, lse)


def ring_flash_backward(saved, do, ring: Ring, *, causal: bool = True,
                        scale: float | None = None,
                        layout: str = "contiguous", window=None):
    """One rank's ring-flash backward: ``saved`` from
    :func:`ring_flash_forward` and ``do`` ``[B, H, Lc, D]``; returns
    ``(dq, dk, dv)`` in the inputs' types, dk/dv at Hkv heads."""
    q, k, v, o, lse = saved
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if window is not None:
        grads = _window_bwd(q, k, v, o, lse, do, ring, int(window), scale)
    elif layout == "zigzag":
        do_z = _zigzag_to(do, ring)
        grads = (_zigzag_from(g, ring) for g in _zigzag_core_bwd(
            q, k, v, o, lse, do_z, ring, scale))
    else:
        return _contig_bwd(q, k, v, o, lse, do, ring, causal, scale)
    dq, dk, dv = grads
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ring, kw):
        o, _, saved = ring_flash_forward(q, k, v, ring, **kw)
        ctx.save_for_backward(*saved)
        ctx.ring, ctx.kw = ring, kw
        return o

    @staticmethod
    def backward(ctx, do):
        grads = ring_flash_backward(ctx.saved_tensors, do.contiguous(),
                                    ctx.ring, **ctx.kw)
        return (*grads, None, None)


def ring_flash_attention_local(q, k, v, ring: Ring, *, causal: bool = True,
                               scale: float | None = None,
                               layout: str = "contiguous", window=None):
    """One rank's ring flash attention: q ``[B, chunk, H, D]``, k/v
    ``[B, chunk, Hkv, D]`` with Hkv dividing H.  Returns ``[B, chunk, H,
    D]``; differentiable in q, k and v.

    ``layout="zigzag"`` (causal only, even sp, even chunk) balances the
    causal ring: every rank does one chunk of flash work a step.
    ``window``: sliding-window attention over the bounded hops (causal).
    External semantics are the same in every variant: contiguous in,
    contiguous out."""
    kw = dict(causal=causal, scale=scale, layout=layout, window=window)
    out = _RingFlash.apply(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), ring, kw)
    return out.transpose(1, 2)


def ring_flash_attention(rings: MeshRings, q, k, v, *, causal: bool = True,
                         layout: str = "contiguous", window=None):
    """One rank's entry (the reference's ``shard_map`` over ``P(batch,
    "sp", "tp", None)``): q ``[B, chunk, H, D]`` and k/v ``[B, chunk, Hkv,
    D]`` with every head; each tp rank takes its H/tp query heads and
    Hkv/tp kv heads round its sp ring, and the heads are gathered back.
    An odd sp ring cannot pair early and late halves and stays
    contiguous."""
    if layout == "zigzag" and rings.sp.size % 2:
        layout = "contiguous"
    q, k, v = (tp_enter(t, rings.tp, 2) for t in (q, k, v))
    out = ring_flash_attention_local(q, k, v, rings.sp, causal=causal,
                                     layout=layout, window=window)
    return tp_exit(out, rings.tp, 2)
