"""Ring collectives over a small transport: the port of
``k8s_tpu/parallel/collectives.py``.

The reference writes its rings as ``ppermute`` chains under
``shard_map``, where one program runs every device of an axis.  Here each
rank runs its own program, and the communication goes through a
:class:`Ring` transport over the ranks of one mesh axis:

- ``rank`` and ``size``;
- ``sendrecv(x, dst, src)``: send ``x`` to ``dst`` and receive a tensor
  of ``x``'s shape from ``src`` (one permutation step; ``shift`` is the
  ring's);
- ``all_to_all(x)``: block ``j`` of ``x``'s first dim goes to rank ``j``;
- ``all_reduce(x)`` (a sum) and ``all_gather(x)`` (stacked in rank
  order), which the tensor-parallel pair below needs;
- ``broadcast(x)``: rank 0's ``x`` on every rank (the tokens a served tp
  rank 0 samples, models/placement.py).

Three transports: :class:`Ring` itself is the one-rank ring (every
collective is the identity); :class:`ProcessGroupRing` runs over a
``torch.distributed`` group (``batch_isend_irecv`` and
``all_to_all_single``: NCCL on CUDA, gloo on the CPU); :class:`ThreadRing`
runs the ranks of one ring as threads of one process, with queues in
place of the links.  ``ThreadRing`` is how the checks run sp, tp, pp and
ep ranks on one device (the counterpart of the reference tests' fake XLA
devices); no entry point selects it.

The differentiable pieces are autograd Functions: :func:`ring_shift`
(its backward is the reverse shift, the transpose of ppermute),
:func:`all_to_all` (its own transpose), the Megatron pair
:func:`tp_enter` / :func:`tp_exit` that puts heads on the ``tp`` axis, and
its twin over ``ep``, :func:`ep_enter` / :func:`ep_exit`, around the
experts a rank holds.
:func:`ring_all_gather`, :func:`ring_reduce_scatter` and
:func:`collective_matmul` are built on :func:`ring_shift` as in the
reference, so they are differentiable too.

:class:`MeshRings` holds one rank's rings over the mesh's six axes;
:func:`mesh_rings` makes it from a ``DeviceMesh`` (process-group rings
over its dims) or passes one through.
"""

from __future__ import annotations

import dataclasses
import math
import queue
import threading
import time
from typing import Callable, Optional

import torch


class Ring:
    """The transport of one rank of a ring.  This base class is the
    one-rank ring: rank 0 of 1, every collective the identity."""

    rank: int = 0
    size: int = 1

    def sendrecv(self, x: torch.Tensor, dst: int, src: int) -> torch.Tensor:
        """Send ``x`` to rank ``dst``; return the tensor rank ``src`` sent
        (of ``x``'s shape and type).  Every rank of the ring calls it in
        the same order, each with its part of one permutation."""
        return x

    def shift(self, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
        """Send to the next rank and receive from the previous one
        (``reverse``: the other way round)."""
        step = -1 if reverse else 1
        return self.sendrecv(x, (self.rank + step) % self.size,
                             (self.rank - step) % self.size)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` ``[size, ...]``: block ``j`` goes to rank ``j``; returns
        ``[size, ...]`` whose block ``i`` came from rank ``i``."""
        return x

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks."""
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[size, *x.shape]``: every rank's ``x`` in rank order."""
        return x[None]

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``x`` on every rank (each rank passes a tensor of the
        same shape and type; only rank 0's values are read)."""
        return x


class ProcessGroupRing(Ring):
    """A ring over the ranks of a ``torch.distributed`` process group, in
    group-rank order."""

    def __init__(self, group=None):
        import torch.distributed as dist

        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self._peers = [dist.get_global_rank(group, r) if group is not None
                       else r for r in range(self.size)]

    def sendrecv(self, x, dst, src):
        import torch.distributed as dist

        if dst == self.rank:  # a fixed point of the permutation
            if src != self.rank:
                raise ValueError(f"rank {self.rank} keeps its tensor but "
                                 f"receives from {src}")
            return x.clone()
        x = x.contiguous()
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, self._peers[dst], self.group),
               dist.P2POp(dist.irecv, out, self._peers[src], self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out

    def all_to_all(self, x):
        import torch.distributed as dist

        if self.size == 1:
            return x.clone()
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return out

    def all_reduce(self, x):
        import torch.distributed as dist

        out = x.clone(memory_format=torch.contiguous_format)
        if self.size > 1:
            dist.all_reduce(out, group=self.group)
        return out

    def all_gather(self, x):
        import torch.distributed as dist

        x = x.contiguous()
        if self.size == 1:
            return x[None].clone()
        outs = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(outs, x, group=self.group)
        return torch.stack(outs)

    def broadcast(self, x):
        import torch.distributed as dist

        if self.size == 1:
            return x
        out = x.clone(memory_format=torch.contiguous_format)
        dist.broadcast(out, self._peers[0], group=self.group)
        return out


class _Aborted(RuntimeError):
    """Raised in a ThreadRing rank when another rank failed first."""


class _Hub:
    """The links of one ThreadRing: a FIFO queue from each rank to each
    rank, and an abort flag that a failing rank raises."""

    def __init__(self, size: int, timeout: float, failed=None):
        self.size = size
        self.timeout = timeout
        self.links = {(s, d): queue.Queue() for s in range(size)
                      for d in range(size)}
        self.failed = failed or threading.Event()


class ThreadRing(Ring):
    """One rank of a ring whose ranks are threads of this process (see
    :meth:`run`).  A send puts a copy of the tensor on the link's queue,
    so the sender may reuse its tensor; a receive waits on it.  Tensors
    stay on their device: on one CUDA device the ranks' kernels share its
    stream order."""

    def __init__(self, hub: _Hub, rank: int):
        self._hub = hub
        self.rank = rank
        self.size = hub.size

    def _send(self, x, dst):
        self._hub.links[(self.rank, dst)].put(x.clone())

    def _recv(self, src):
        link = self._hub.links[(src, self.rank)]
        deadline = time.monotonic() + self._hub.timeout
        while True:
            if self._hub.failed.is_set():
                raise _Aborted("another rank of the ThreadRing failed")
            try:
                return link.get(timeout=0.05)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"ThreadRing rank {self.rank}: nothing from rank "
                        f"{src} in {self._hub.timeout} s") from None

    def sendrecv(self, x, dst, src):
        self._send(x, dst)
        return self._recv(src)

    def all_to_all(self, x):
        for j in range(self.size):
            self._send(x[j], j)
        return torch.stack([self._recv(i) for i in range(self.size)])

    def all_reduce(self, x):
        parts = self.all_gather(x)
        out = parts[0].clone()
        for p in parts[1:]:  # rank order: every rank gets the same sum
            out += p
        return out

    def all_gather(self, x):
        for j in range(self.size):
            self._send(x, j)
        return torch.stack([self._recv(i) for i in range(self.size)])

    def broadcast(self, x):
        if self.rank == 0:
            for j in range(1, self.size):
                self._send(x, j)
            return x
        return self._recv(0)

    @staticmethod
    def run(size: int, fn: Callable, *, timeout: float = 600.0) -> list:
        """Run ``fn(ring)`` on ``size`` threads, one per rank, and return
        the results in rank order.  The first rank to raise aborts the
        others' receives, and its error is re-raised here."""
        return ThreadRing.run_mesh(size, 1, lambda rings: fn(rings.sp),
                                   timeout=timeout)

    @staticmethod
    def run_mesh(sp: int, tp: int, fn: Callable, *, pp: int = 1,
                 ep: int = 1, timeout: float = 600.0) -> list:
        """Run ``fn(MeshRings)`` on ``pp * ep * sp * tp`` threads, the
        ranks of a (pp, ep, sp, tp) grid laid out in the mesh's axis order
        (tp innermost); returns the results in that order.  Errors as
        :meth:`run`."""
        import numpy as np

        sizes = {"pp": pp, "ep": ep, "sp": sp, "tp": tp}
        shape = tuple(sizes.values())
        n = math.prod(shape)
        failed = threading.Event()
        # one hub for each line of the grid along an axis: keyed by the
        # rank's coordinates with that axis left out
        hubs = {a: {} for a in sizes}
        for i in range(n):
            coord = np.unravel_index(i, shape)
            for k, a in enumerate(sizes):
                key = coord[:k] + coord[k + 1:]
                if key not in hubs[a]:
                    hubs[a][key] = _Hub(sizes[a], timeout, failed)
        results: list = [None] * n
        errors: list = [None] * n

        def body(i):
            coord = np.unravel_index(i, shape)
            rings = {a: ThreadRing(hubs[a][coord[:k] + coord[k + 1:]],
                                   int(coord[k]))
                     for k, a in enumerate(sizes)}
            try:
                results[i] = fn(MeshRings(**rings))
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors[i] = e
                failed.set()

        threads = [threading.Thread(target=body, args=(i,), daemon=True,
                                    name=f"thread-ring-{i}")
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        first = [e for e in errors if e is not None
                 and not isinstance(e, _Aborted)] or \
            [e for e in errors if e is not None]
        if first:
            raise first[0]
        return results


# -- differentiable collectives ---------------------------------------------


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ring, reverse):
        ctx.ring, ctx.reverse = ring, reverse
        return ring.shift(x, reverse)

    @staticmethod
    def backward(ctx, g):
        # the transpose of a permutation is its inverse
        return ctx.ring.shift(g.contiguous(), not ctx.reverse), None, None


def ring_shift(x: torch.Tensor, ring: Ring, *,
               reverse: bool = False) -> torch.Tensor:
    """Send our shard to the next rank on the ring (``reverse``: to the
    previous one) and return the shard that arrives; differentiable (the
    backward shifts the gradient the other way)."""
    return _Shift.apply(x, ring, reverse)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        return ring.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        # block j of rank i went to block i of rank j: its own transpose
        return ctx.ring.all_to_all(g.contiguous()), None


def all_to_all(x: torch.Tensor, ring: Ring) -> torch.Tensor:
    """Differentiable :meth:`Ring.all_to_all` over ``x`` ``[size, ...]``."""
    return _AllToAll.apply(x, ring)


def ring_all_gather(x: torch.Tensor, ring: Ring, *,
                    fold_fn: Optional[Callable] = None):
    """Ring all-gather of per-rank shards, one hop per step.

    Each shard meets ``fold_fn(acc, shard, src_rank)`` the step it lands
    (``acc`` is None on the first fold), so per-shard compute can follow
    each hop.  Without ``fold_fn``, returns ``[size, ...]`` stacked shards
    in rank order; with it, the final accumulator (see
    :func:`collective_matmul`)."""
    n, i = ring.size, ring.rank
    if fold_fn is None:
        def fold_fn(acc, shard, src):  # stack into rank order
            if acc is None:
                acc = shard.new_zeros((n,) + tuple(shard.shape))
            idx = torch.tensor([src], device=shard.device)
            return acc.index_copy(0, idx, shard[None])

    # step 0 folds our own shard, then hop t delivers the shard that
    # started t ranks up-ring
    acc = fold_fn(None, x, i)
    cur = x
    for t in range(1, n):
        cur = ring_shift(cur, ring)
        acc = fold_fn(acc, cur, (i - t) % n)
    return acc


def ring_reduce_scatter(x: torch.Tensor, ring: Ring) -> torch.Tensor:
    """Ring reduce-scatter: ``x`` is ``[size, chunk...]`` per rank (one
    chunk addressed to each rank); returns this rank's chunk summed over
    the ranks.  The partial sum for chunk ``c`` starts at rank ``c+1`` and
    travels the ring once, each rank adding its piece as it passes."""
    n, i = ring.size, ring.rank
    partial = x[(i - 1) % n]
    for k in range(1, n):
        partial = ring_shift(partial, ring) + x[(i - 1 - k) % n]
    return partial


def collective_matmul(x_shard: torch.Tensor, w: torch.Tensor,
                      ring: Ring) -> torch.Tensor:
    """Tensor-parallel matmul: ``x`` row-sharded over the ring
    (``x_shard`` ``[rows/n, k]``), ``w`` replicated; returns the full ``x
    @ w`` (``[rows, out]``), each hop's shard multiplied as it lands."""
    n, rows = ring.size, x_shard.shape[0]

    def fold(acc, shard, src):
        y = shard @ w
        if acc is None:
            acc = y.new_zeros((n * rows,) + tuple(y.shape[1:]))
        idx = torch.arange(src * rows, (src + 1) * rows, device=y.device)
        return acc.index_copy(0, idx, y)

    return ring_all_gather(x_shard, ring, fold_fn=fold)


class _Copy(torch.autograd.Function):
    """The identity forward; the gradient summed over the ring backward
    (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.ring.all_reduce(g), None


class _Reduce(torch.autograd.Function):
    """The sum over the ring forward; the identity backward (Megatron's
    g)."""

    @staticmethod
    def forward(ctx, x, ring):
        return ring.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Psum(torch.autograd.Function):
    """The sum over the ring forward and backward (JAX's ``psum``, whose
    transpose is itself)."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        return ring.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.ring.all_reduce(g.contiguous()), None


def psum(x: torch.Tensor, rings) -> torch.Tensor:
    """``x`` summed over each ring of ``rings``, differentiably: the
    backward sums the gradient over them too, as the transpose of the
    reference's ``psum`` does (every rank's use of the sum reaches every
    rank's part)."""
    for ring in rings:
        if ring.size > 1:
            x = _Psum.apply(x, ring)
    return x


class _TpExit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ring, dim):
        ctx.ring, ctx.dim = ring, dim
        parts = ring.all_gather(x)
        return torch.cat(list(parts.unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.ring.size
        return g.narrow(ctx.dim, ctx.ring.rank * n, n), None, None


def tp_enter(x: torch.Tensor, ring: Ring, dim: int) -> torch.Tensor:
    """This rank's slice of ``dim`` over the ``tp`` ring (``x`` is equal
    on every tp rank).  Forward: the identity, then the slice; backward:
    the gradient of the slice, summed over the tp ranks, so every rank
    holds the gradient of the whole ``x``."""
    if ring.size == 1:
        return x
    if x.shape[dim] % ring.size:
        raise ValueError(f"{x.shape[dim]} heads do not divide over tp "
                         f"{ring.size}")
    n = x.shape[dim] // ring.size
    return _Copy.apply(x, ring).narrow(dim, ring.rank * n, n)


def tp_exit(x: torch.Tensor, ring: Ring, dim: int) -> torch.Tensor:
    """The tp ranks' slices of ``dim`` gathered back in rank order.
    Backward: this rank's slice of the gradient (equal on every tp
    rank)."""
    if ring.size == 1:
        return x
    return _TpExit.apply(x, ring, dim)


def ep_enter(x: torch.Tensor, ring: Ring) -> torch.Tensor:
    """``x`` (equal on every ep rank) into this rank's share of an
    expert-parallel sum.  Forward: the identity; backward: the gradient
    summed over the ep ranks, each of which holds the part its own
    experts give, so every rank gets the gradient of the whole sum."""
    if ring.size == 1:
        return x
    return _Copy.apply(x, ring)


def ep_exit(x: torch.Tensor, ring: Ring) -> torch.Tensor:
    """The ep ranks' partial results summed.  Backward: the identity (the
    gradient of the sum is equal on every ep rank and is each part's
    gradient whole)."""
    if ring.size == 1:
        return x
    return _Reduce.apply(x, ring)


@dataclasses.dataclass(frozen=True)
class MeshRings:
    """One rank's rings over the axes of its mesh (``Ring()``, one rank,
    on an axis it does not span)."""

    sp: Ring = dataclasses.field(default_factory=Ring)
    tp: Ring = dataclasses.field(default_factory=Ring)
    pp: Ring = dataclasses.field(default_factory=Ring)
    ep: Ring = dataclasses.field(default_factory=Ring)
    dp: Ring = dataclasses.field(default_factory=Ring)
    fsdp: Ring = dataclasses.field(default_factory=Ring)


def mesh_rings(mesh) -> Optional[MeshRings]:
    """``MeshRings`` for ``mesh``: None for None, itself for a
    ``MeshRings``, and for a ``DeviceMesh`` process-group rings over each
    of its dims."""
    if mesh is None or isinstance(mesh, MeshRings):
        return mesh

    def ring(axis):
        if axis not in mesh.mesh_dim_names or mesh[axis].size() == 1:
            return Ring()
        return ProcessGroupRing(mesh.get_group(axis))

    return MeshRings(**{f.name: ring(f.name)
                        for f in dataclasses.fields(MeshRings)})


def host_local_array_to_global(mesh, arrays, placements):
    """Multi-process input plumbing: this rank's tensor as its shard of a
    global ``DTensor`` (``DTensor.from_local``)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(arrays, mesh, placements)
