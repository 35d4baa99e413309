"""Pipeline parallelism over the ``pp`` ring: the port of
``k8s_tpu/parallel/pipeline.py``.

The network is split into ``S = |pp|`` homogeneous stages (or, with
``num_virtual = v > 1``, ``S * v`` chunks placed round-robin, chunk ``c``
on rank ``c mod S``) and a batch into ``M`` equal microbatches.  The
reference runs one SPMD tick loop under ``shard_map`` and rotates
activations with ``ppermute``; here each rank runs its own tick loop over
its :class:`~k8s_tpu_torch.parallel.collectives.Ring` (``ThreadRing``
threads for the checks on one device, a process group otherwise), with
the reference's tick maps:

- GPipe (:func:`pipeline_apply`, forward): rank ``s`` computes microbatch
  ``t - s`` at tick ``t``, ``M + S - 1`` ticks;
- 1F1B (:func:`pipeline_train_step_1f1b`): forward of ``t - s`` and
  backward of ``t - (2S-2) + s``, ``M + 2S - 2`` ticks;
- interleaved 1F1B (:func:`pipeline_train_step_interleaved`): forward of
  ``(m, c)`` at ``base(m) + c`` and backward at ``base(m) + 2(C-1) - c``,
  ``base(m) = (m // S) * S * v + m % S``.

Each tick sends this tick's activation down the ring and its cotangent up
it (``Ring.shift``; zeros on a dead tick, whose compute a rank skips where
the reference computes and masks it).  The interleaved schedule's last
rank hands chunk ``(q+1)S`` to rank 0 over the wrap hop.

The memory contract is the reference's: a rank stashes only each
microbatch's ring input, in ``min(M, 2S-1)`` slots (interleaved:
``_simulate_interleaved``'s per-chunk depth), and at the backward tick
reruns the stage under ``torch.enable_grad()`` and differentiates it
(``torch.autograd.grad`` with the arriving cotangent, or the loss seed
``1/M`` on the last stage).  No autograd graph lives across ticks, so
:func:`peak_activation_microbatches` counts what a rank holds; the price
is a second forward of every stage (the reference's trade, its
``jax.vjp`` recompute).  Gradients accumulate in f32 over the
microbatches in ascending order, as the reference's scan adds them.

Parameters are dicts of tensors (or modules, whose named parameters are
taken): ``stage_fn(params, x)`` runs one stage, ``pre_fn(pre_params,
microbatch)`` the heterogeneous input end on the first rank (an
embedding), ``post_fn(post_params, y, target)`` the loss head on the last
rank.  Differences from the reference, all from each rank running its own
program: a rank's batch is its rows of the global batch (its block over
the data axes, ``parallel.mesh.data_sharding``), split into ``M``
microbatches; the loss and the stage gradients are averaged over the
data rings (``batch_rings``, the reference's ``pmean`` over
``batch_axes``); the end stages' gradients are returned on the rank that
holds them (the reference's ``psum`` over pp replicates them), as are
GPipe's outputs (on the last rank, where the reference broadcasts them
with a masked ``psum``).  A chunk stack needs no ``stack_stage_params``
here: each rank passes its own chunks, a list in round-robin order.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from k8s_tpu_torch.parallel.collectives import Ring


def bubble_fraction(schedule: str, num_microbatches: int, num_stages: int,
                    num_virtual: int = 1) -> float:
    """Fraction of stage-time idle.

    gpipe and non-interleaved 1f1b are identical: (S-1)/(M+S-1).
    interleaved 1f1b with v virtual stages per device cuts the fill/drain
    to (S-1)/(v*M + S-1) — each device's work grows v-fold (v chunk
    computes per microbatch) while the pipeline fill stays S-1 ticks.
    """
    M, S, v = num_microbatches, num_stages, num_virtual
    if schedule in ("gpipe", "1f1b"):
        return (S - 1) / (M + S - 1)
    if schedule == "interleaved":
        return (S - 1) / (v * M + S - 1)
    raise ValueError(f"unknown schedule {schedule!r}")


def _interleaved_base(m: int, S: int, v: int) -> int:
    """Tick at which microbatch m's first chunk is computed: microbatches
    run in groups of S; group g starts at tick g*S*v (the device needs S*v
    ticks to push a group through its v chunks)."""
    return (m // S) * S * v + (m % S)


def _simulate_interleaved(M: int, S: int, v: int) -> tuple[int, int]:
    """Exact trace-time accounting of the interleaved schedule.

    Chunk c of microbatch m runs forward at tick base(m)+c and backward at
    tick base(m)+2(C-1)-c (C = S*v chunks).  Returns (buf_slots,
    peak_total): the per-chunk circular-buffer depth the kernel needs (max
    in-flight residuals of any single chunk — the in-flight set of a chunk
    is a contiguous m-interval, so `m mod buf_slots` indexing is
    collision-free), and the peak total residuals a device holds across its
    v chunks (the memory figure peak_activation_microbatches reports).
    """
    C = S * v
    ticks = M * v + 2 * C + S + 2
    bases = [_interleaved_base(m, S, v) for m in range(M)]

    def peak_of(chunks: list[int]) -> int:
        # difference-array sweep: O(M·|chunks| + ticks), not a full
        # per-tick scan (this runs at trace time on every step build)
        delta = [0] * (ticks + 1)
        for c in chunks:
            for base in bases:
                delta[base + c] += 1          # fwd tick, inclusive
                delta[base + 2 * (C - 1) - c + 1] -= 1  # past bwd tick
        peak = cur = 0
        for x in delta:
            cur += x
            peak = max(peak, cur)
        return peak

    per_chunk_peak = max(peak_of([c]) for c in range(C))
    device_peak = max(
        peak_of([q * S + d for q in range(v)]) for d in range(S))
    return per_chunk_peak, device_peak


def peak_activation_microbatches(schedule: str, num_microbatches: int,
                                 num_stages: int, num_virtual: int = 1) -> int:
    """Peak in-flight microbatch residuals a stage must hold — the metric
    1f1b exists to bound: O(M) for gpipe, O(S) for 1f1b.  Interleaving
    trades some of that memory back (plus v× the comm volume) for the
    smaller bubble; its peak is computed exactly from the schedule."""
    M, S, v = num_microbatches, num_stages, num_virtual
    if schedule == "gpipe":
        return M
    if schedule == "1f1b":
        return min(M, 2 * S - 1)
    if schedule == "interleaved":
        return _simulate_interleaved(M, S, v)[1]
    raise ValueError(f"unknown schedule {schedule!r}")


def interleave_chunks(chunks: Sequence, num_stages: int, num_virtual: int,
                      inverse: bool = False) -> list:
    """Natural chunk order <-> device-major round-robin layout (chunk c on
    device c mod S): the layout a long-lived interleaved train state should
    be stored in, so that rank d's chunks are the contiguous
    ``[d*v:(d+1)*v]``."""
    S, v = num_stages, num_virtual
    perm = np.array([q * S + d for d in range(S) for q in range(v)])
    if inverse:
        perm = np.argsort(perm)
    return [chunks[i] for i in perm]


# -- the per-rank machinery -------------------------------------------------


def _leaves(params) -> dict:
    """The tensors of a params argument: a dict, or a module's named
    parameters."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params or {})


def _data_size(batch_rings: Sequence[Ring]) -> int:
    return math.prod(r.size for r in batch_rings)


def _data_mean(tensors: list, batch_rings: Sequence[Ring]) -> list:
    """The mean of each tensor over the data rings (the reference's
    ``pmean`` over ``batch_axes``): one flat sum over each ring."""
    n = _data_size(batch_rings)
    if n == 1 or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    for ring in batch_rings:
        flat = ring.all_reduce(flat)
    flat = flat / n
    return [part.view_as(t) for t, part in
            zip(tensors, flat.split([t.numel() for t in tensors]))]


def _microbatches(batch, num_microbatches: int,
                  batch_rings: Sequence[Ring]) -> list:
    """This rank's rows split into ``num_microbatches``, after the
    reference's checks on the global batch (``_check_microbatching``)."""
    n = _data_size(batch_rings)
    B = batch.shape[0] * n
    if B % num_microbatches:
        raise ValueError(
            f"batch {B} not divisible into {num_microbatches} microbatches")
    mb = B // num_microbatches
    if mb % n:
        raise ValueError(
            f"microbatch size {mb} not divisible by data shards {n} "
            f"(axes ('dp', 'fsdp')); use fewer microbatches or a bigger "
            "batch")
    return list(batch.split(mb // n))


def _act_like(act, pre_fn, pre_params, micro) -> torch.Tensor:
    """A tensor shaped like one microbatch's ring activation: ``act``
    when given, else the microbatch itself (no ``pre_fn``) or
    ``pre_fn``'s output on the first one."""
    if act is not None:
        return act
    if pre_fn is None:
        return micro[0]
    if not pre_params:
        raise ValueError("a rank without pre_params needs act= (a tensor "
                         "shaped like one microbatch's ring activation)")
    with torch.no_grad():
        return pre_fn(pre_params, micro[0])


class _Accumulator:
    """f32 sums of one parameter dict's gradients, added in call order
    (None for a gradient autograd did not reach: zero)."""

    def __init__(self, params: dict):
        self.params = params
        self.sums: dict = {k: None for k in params}

    def add(self, grads) -> None:
        for k, g in zip(self.sums, grads):
            if g is not None:
                g = g.float()
                self.sums[k] = g if self.sums[k] is None \
                    else self.sums[k] + g

    def result(self, batch_rings) -> dict:
        sums = {k: torch.zeros_like(p, dtype=torch.float32)
                if self.sums[k] is None else self.sums[k]
                for k, p in self.params.items()}
        means = _data_mean(list(sums.values()), batch_rings)
        return {k: g.to(self.params[k].dtype)
                for k, g in zip(sums, means)}


class _Schedule:
    """One rank's state over a train tick loop: its microbatches, the
    stash of ring inputs, and the backward tick (recompute + vjp)."""

    def __init__(self, ring, stage_fn, pre_fn, pre, post_fn, post, loss_fn,
                 micro, tmicro, act):
        self.ring, self.stage_fn = ring, stage_fn
        self.pre_fn, self.pre = pre_fn, pre
        self.post_fn, self.post, self.loss_fn = post_fn, post, loss_fn
        self.micro, self.tmicro = micro, tmicro
        self.inv_m = 1.0 / len(micro)
        self.zero = torch.zeros_like(act)
        self.pre_acc = _Accumulator(pre)
        self.post_acc = _Accumulator(post)
        self.loss = torch.zeros((), dtype=torch.float32, device=act.device)
        self.live = 0  # stashed ring inputs held now
        self.peak = 0

    def ingest(self, pre, m, x_ring, is_first):
        """The stage input of microbatch ``m``: the first chunk's is
        ``pre_fn`` of the raw microbatch, every other the ring input."""
        if not is_first:
            return x_ring
        if self.pre_fn is None:
            return self.micro[m]
        return self.pre_fn(pre, self.micro[m]).to(self.zero.dtype)

    def forward(self, params, m, x_ring, is_first):
        with torch.no_grad():
            return self.stage_fn(params, self.ingest(self.pre, m, x_ring,
                                                     is_first))

    def stash(self):
        self.live += 1
        self.peak = max(self.peak, self.live)

    def backward(self, run, acc, m, x_saved, d_out, is_first, is_last):
        """Rerun the stage (``run``: its module or params) on microbatch
        ``m``'s stashed ring input and differentiate it into ``acc``:
        returns the cotangent of that input (zeros on the first chunk,
        whose input is the raw microbatch)."""
        self.live -= 1
        # fresh leaves over the end parameters, so that a tensor held by
        # both ends (a tied embedding) gets each end's part on its own
        pre = {k: v.detach().requires_grad_() for k, v in self.pre.items()} \
            if is_first else {}
        post = {k: v.detach().requires_grad_()
                for k, v in self.post.items()} if is_last else {}
        if isinstance(run, torch.nn.Module):
            params = acc.params
        else:  # differentiate a dict through fresh leaves over it
            run = params = {k: v.detach().requires_grad_()
                            for k, v in acc.params.items()}
        with torch.enable_grad():
            x = None
            if not is_first:
                x = x_saved.detach().requires_grad_()
            out = self.stage_fn(run, self.ingest(pre, m, x, is_first))
            if is_last:
                if self.post_fn is not None:
                    mb_loss = self.post_fn(post, out, self.tmicro[m])
                else:
                    mb_loss = self.loss_fn(out, self.tmicro[m])
                mb_loss = mb_loss.float()
                self.loss = self.loss + self.inv_m * mb_loss.detach()
                outputs = mb_loss
                seed = torch.full_like(mb_loss, self.inv_m)
            else:
                outputs, seed = out, d_out
            wrt = [*params.values(), *pre.values(), *post.values()]
            if x is not None:
                wrt.append(x)
            grads = torch.autograd.grad(outputs, wrt, seed,
                                        allow_unused=True)
        n, n_pre = len(params), len(pre)
        acc.add(grads[:n])
        if is_first:
            self.pre_acc.add(grads[n:n + n_pre])
        if is_last:
            self.post_acc.add(grads[n + n_pre:n + n_pre + len(post)])
        if x is None:
            return self.zero
        dx = grads[-1]
        return self.zero if dx is None else dx.to(self.zero.dtype)

    def finish(self, stage_grads, batch_rings, first: bool, last: bool,
               stats):
        """The loss on every rank (the last rank's, summed over the ring,
        averaged over the data rings) and the end gradients on their
        ranks."""
        loss = self.ring.all_reduce(self.loss)
        loss = _data_mean([loss], batch_rings)[0]
        g_pre = self.pre_acc.result(batch_rings) if first else None
        g_post = self.post_acc.result(batch_rings) if last else None
        if stats is not None:
            stats["peak_stashed"] = self.peak
        return loss, (stage_grads, g_pre, g_post)


def _check_ends(loss_fn, post_fn):
    if (loss_fn is None) == (post_fn is None):
        raise ValueError("exactly one of loss_fn / post_fn must be given")


def pipeline_apply(ring: Ring, stage_fn: Callable, stage_params, batch, *,
                   num_microbatches: int, batch_rings: Sequence[Ring] = (),
                   pre_fn: Optional[Callable] = None, pre_params=None,
                   post_fn: Optional[Callable] = None, post_params=None,
                   act: Optional[torch.Tensor] = None):
    """Run this rank's rows ``batch`` through the pipeline (GPipe,
    forward only: training goes through the 1F1B steps).

    stage_fn(params, x) -> y: this rank's stage, same activation shape in
      and out.  pre_fn(pre_params, mb) -> x / post_fn(post_params, y) ->
      out: optional heterogeneous input and output stages, run on the
      first and the last rank only (only they need their params).
    act: a tensor shaped like one microbatch's ring activation, needed on
      the ranks that cannot compute it (no pre_params).
    Returns the outputs ``[rows, ...]`` (post_fn's output space when
    given) on the last rank, None on the others.
    """
    micro = _microbatches(batch, num_microbatches, batch_rings)
    S, s = ring.size, ring.rank
    M = len(micro)
    pre, post = _leaves(pre_params), _leaves(post_params)
    zero = torch.zeros_like(_act_like(act, pre_fn, pre, micro))
    params = stage_params if isinstance(stage_params, torch.nn.Module) \
        else _leaves(stage_params)
    outputs = []
    hold = zero
    with torch.no_grad():
        for t in range(M + S - 1):
            m = t - s
            y = zero
            if 0 <= m < M:
                x = hold
                if s == 0:
                    x = micro[m] if pre_fn is None else \
                        pre_fn(pre, micro[m]).to(zero.dtype)
                y = stage_fn(params, x)
                if s == S - 1:
                    outputs.append(y if post_fn is None
                                   else post_fn(post, y))
            hold = ring.shift(y)
    return torch.cat(outputs) if s == S - 1 else None


def pipeline_train_step_1f1b(ring: Ring, stage_fn: Callable, stage_params,
                             batch, targets, loss_fn: Callable = None, *,
                             num_microbatches: int,
                             batch_rings: Sequence[Ring] = (),
                             pre_fn: Optional[Callable] = None,
                             pre_params=None,
                             post_fn: Optional[Callable] = None,
                             post_params=None,
                             act: Optional[torch.Tensor] = None,
                             stats: Optional[dict] = None):
    """Loss + parameter gradients of this rank's stage under the 1F1B
    schedule.

    stage_fn(params, x) -> y: this rank's homogeneous ring stage over
      ``stage_params`` (a dict of tensors, or a module).
    loss_fn(out_mb, target_mb) -> scalar: per-microbatch loss; the total is
      the mean over microbatches (the decomposition 1F1B requires).
    batch/targets: this rank's rows, split into num_microbatches.
    pre_fn(pre_params, mb) -> x: optional heterogeneous input stage
      (embedding lookup) run on pp rank 0 only.
    post_fn(post_params, y, target_mb) -> scalar: optional heterogeneous
      loss head (final norm + LM head + loss) run on the last rank only;
      replaces loss_fn.
    act: as in :func:`pipeline_apply`.  stats: a dict that receives
      ``peak_stashed``, the most ring inputs this rank held at once.
    Returns (loss, grads), the loss on every rank: grads is the stage's
    gradient dict when no end stages are given, else (stage_grads,
    pre_grads, post_grads), the end ones on their rank (None elsewhere).
    """
    _check_ends(loss_fn, post_fn)
    micro = _microbatches(batch, num_microbatches, batch_rings)
    tmicro = list(targets.split(micro[0].shape[0]))
    S, s = ring.size, ring.rank
    M = len(micro)
    BUF = min(M, 2 * S - 1)
    first, last = s == 0, s == S - 1
    pre, post = _leaves(pre_params), _leaves(post_params)
    params = _leaves(stage_params)
    run = stage_params if isinstance(stage_params, torch.nn.Module) \
        else params
    sched = _Schedule(ring, stage_fn, pre_fn, pre, post_fn, post, loss_fn,
                      micro, tmicro, _act_like(act, pre_fn, pre, micro))
    acc = _Accumulator(params)
    buf: list = [None] * BUF
    fwd_hold = bwd_hold = sched.zero
    for t in range(M + 2 * S - 2):
        # forward stream: microbatch t - s
        m_f = t - s
        y = sched.zero
        if 0 <= m_f < M:
            y = sched.forward(run, m_f, fwd_hold, first)
            # stash the RING input for the backward recompute (stage 0
            # re-ingests from the raw microbatch)
            buf[m_f % BUF] = fwd_hold
            sched.stash()
        # backward stream: microbatch t - (2S-2) + s
        m_b = t - (2 * S - 2) + s
        dx = sched.zero
        if 0 <= m_b < M:
            x_saved, buf[m_b % BUF] = buf[m_b % BUF], None
            dx = sched.backward(run, acc, m_b, x_saved, bwd_hold, first,
                                last)
        # activations down the ring, cotangents up it
        fwd_hold = ring.shift(y)
        bwd_hold = ring.shift(dx, reverse=True)
    grads = acc.result(batch_rings)
    loss, out = sched.finish(grads, batch_rings, first, last, stats)
    if pre_fn is None and post_fn is None:
        return loss, out[0]
    return loss, out


def pipeline_train_step_interleaved(
        ring: Ring, stage_fn: Callable, chunk_params, batch, targets,
        loss_fn: Callable = None, *, num_microbatches: int,
        num_virtual: int, batch_rings: Sequence[Ring] = (),
        pre_fn: Optional[Callable] = None, pre_params=None,
        post_fn: Optional[Callable] = None, post_params=None,
        act: Optional[torch.Tensor] = None, stats: Optional[dict] = None):
    """Loss + gradients of this rank's chunks under the interleaved 1F1B
    schedule.

    chunk_params: this rank's ``num_virtual`` chunks in round-robin order
      (rank d holds chunks d, S+d, ..., (v-1)S+d of the C = S*v-deep
      virtual pipeline: ``interleave_chunks``' device-major layout, the
      reference's ``device_major=True``), each a dict or a module.
    num_microbatches must be a multiple of |pp| (microbatches are ingested
      in groups of S).
    loss_fn / pre_fn / post_fn / act / stats: as in
      :func:`pipeline_train_step_1f1b`.
    Returns (loss, grads): grads a list of per-chunk gradient dicts when
    homogeneous, else (chunk_grads, pre_grads, post_grads).
    """
    _check_ends(loss_fn, post_fn)
    S, d = ring.size, ring.rank
    v = num_virtual
    if v < 1:
        raise ValueError(f"num_virtual must be >= 1, got {v}")
    if num_microbatches % S:
        raise ValueError(
            f"interleaved schedule ingests microbatches in groups of "
            f"{S} (=|pp|); {num_microbatches} is not a multiple")
    if len(chunk_params) != v:
        raise ValueError(
            f"chunk_params must hold this rank's num_virtual={v} chunks "
            f"(S*v={S * v} in all), got {len(chunk_params)}")
    micro = _microbatches(batch, num_microbatches, batch_rings)
    tmicro = list(targets.split(micro[0].shape[0]))
    M = len(micro)
    C = Sv = S * v
    buf_slots, _ = _simulate_interleaved(M, S, v)
    pre, post = _leaves(pre_params), _leaves(post_params)
    params = [_leaves(c) for c in chunk_params]
    run = [c if isinstance(c, torch.nn.Module) else p
           for c, p in zip(chunk_params, params)]
    sched = _Schedule(ring, stage_fn, pre_fn, pre, post_fn, post, loss_fn,
                      micro, tmicro, _act_like(act, pre_fn, pre, micro))
    accs = [_Accumulator(p) for p in params]
    buf = [[None] * buf_slots for _ in range(v)]
    fwd_hold = bwd_hold = sched.zero
    for t in range(M * v + Sv + S - 2):
        # forward: invert u = t - d = g*Sv + q*S + j
        u = t - d
        y = sched.zero
        if 0 <= u < M * v:
            q_f = (u % Sv) // S
            m_f = (u // Sv) * S + u % S
            y = sched.forward(run[q_f], m_f, fwd_hold, d == 0 and q_f == 0)
            buf[q_f][m_f % buf_slots] = fwd_hold
            sched.stash()
        # backward: invert r + (v-1)S = g*Sv + (v-1-q)*S + j
        rv = t - 2 * (C - 1) + d + (v - 1) * S
        dx = sched.zero
        if 0 <= rv < M * v:
            q_b = v - 1 - (rv % Sv) // S
            m_b = (rv // Sv) * S + rv % S
            slot = m_b % buf_slots
            x_saved, buf[q_b][slot] = buf[q_b][slot], None
            dx = sched.backward(run[q_b], accs[q_b], m_b, x_saved, bwd_hold,
                                d == 0 and q_b == 0,
                                d == S - 1 and q_b == v - 1)
        fwd_hold = ring.shift(y)
        bwd_hold = ring.shift(dx, reverse=True)
    grads = [a.result(batch_rings) for a in accs]
    loss, out = sched.finish(grads, batch_rings, d == 0, d == S - 1, stats)
    if pre_fn is None and post_fn is None:
        return loss, out[0]
    return loss, out
