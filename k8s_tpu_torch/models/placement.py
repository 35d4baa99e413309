"""Compute seam for the serving engine: port of
``k8s_tpu/models/placement.py``.

The engine (models/engine.py) is a host-side scheduler (slot admission,
block-pool bookkeeping, batch-plan construction over numpy) above a set
of device bodies (batched decode step, speculative verify step, chunked
prefill, copy-on-write, and the block-chain gather and graft that
migration and the spill tier ride).
This module holds the bodies and the placement that runs them:

- :class:`PagedCompute` — functions on tensors over the port's
  :class:`~k8s_tpu_torch.models.transformer.Transformer`.  The pool is a
  list of per-layer dicts of ``[num_blocks, block_size, ...]`` tensors
  that the transformer's paged decode step updates in place, so a body
  returns what the engine reads (tokens, accepted counts,
  last-position logits) and nothing else.
- :class:`LocalPlacement` — runs a body under ``torch.inference_mode()``
  on the engine's device, with no compile (eager PyTorch has no program
  to build); allocates the zero pool on the device and uploads block
  tables.
- ``MeshPlacement`` (models/mesh_serve.py) — tensor-parallel serving over
  a ``tp`` ring: the engine's model is tp rank 0's Megatron shard, the
  pool holds rank 0's kv-head slice, and every call first goes to the
  follower ranks over the plan bus (models/mp_plan.py), which replay it
  on their own shards.

The seam the engine relies on: ``build_compute(config, params)`` gives
the :class:`PagedCompute` over the placement's model; ``wrap(op, fn)``
returns a callable with ``fn``'s signature (``op`` names it for plan
replay); ``build_pool(compute, blocks, block_size)`` and
``put_tables(stack)`` place the pool and the slot tables; ``info()`` is
the mesh identity ``stats()`` reports.  Plan arguments are host (numpy)
arrays; a body moves them to its device.

On a tp ring every rank runs the same bodies; rank 0 alone holds the
slots' generators and samples, and each fused iteration's tokens reach
the other ranks over the ring (``Ring.broadcast``), so every rank feeds
the tokens the chief sampled.  Only rank 0 reads results on the host.

Knob: ``K8S_TPU_SERVE_MESH`` (:func:`env_mesh`; models/server.py routes
on it).
"""

from __future__ import annotations

import functools
import logging
import os
from typing import Callable

import numpy as np
import torch

from k8s_tpu_torch.models.decode import sample_logits_rows, spec_verify_rows
from k8s_tpu_torch.models.kvtier import BF16
from k8s_tpu_torch.models.transformer import Transformer

log = logging.getLogger(__name__)


def env_mesh() -> int:
    """K8S_TPU_SERVE_MESH: number of processes in the serving mesh (0 or
    unset = one device, LocalPlacement; >= 1 = MeshPlacement over the
    ``torch.distributed`` world the launcher env contract brings up)."""
    raw = os.environ.get("K8S_TPU_SERVE_MESH", "").strip()
    try:
        return max(0, int(raw)) if raw else 0
    except ValueError:
        log.warning("ignoring non-integer K8S_TPU_SERVE_MESH=%r", raw)
        return 0


# the host dtype of each pool leaf dtype (a bf16 leaf travels as its bits)
_HOST_DTYPES = {torch.float32: np.dtype(np.float32),
                torch.float16: np.dtype(np.float16),
                torch.bfloat16: BF16, torch.int8: np.dtype(np.int8)}


def host_dtype(dtype: torch.dtype) -> np.dtype:
    """The host (numpy) dtype a pool leaf of ``dtype`` exports as."""
    return _HOST_DTYPES[dtype]


def host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor over a host array of the :meth:`PagedCompute.
    gather_blocks` layout (:data:`kvtier.BF16` bits become bfloat16).
    Read-only or strided arrays are copied first."""
    arr = np.asarray(arr)
    if not (arr.flags.writeable and arr.flags.c_contiguous):
        arr = arr.copy()
    if arr.dtype == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class PagedCompute:
    """The engine's device bodies over one served transformer (on a tp
    ring, one rank's shard of it).

    Every method sees the model, the pool or dense cache, and per-call
    plan data, and mutates the pool or cache in place.  On a tp rank
    other than 0 the step bodies take no generators and return nothing:
    rank 0 samples and reads."""

    def __init__(self, model: Transformer):
        self.model = model
        self.config = model.config
        self.tp = model.tp
        self.sampler = self.tp is None or self.tp.rank == 0

    # ---------------------------------------------------- cache helpers

    @staticmethod
    def paged_cache(pool, tables, lens):
        """Attach the per-row block ``table`` and written-``len`` bound to
        every layer's pool dict: the cache the transformer's paged decode
        path consumes.  The pool tensors are shared, not copied, and
        updated in place, so there is no cache to strip back into a pool
        (the reference's ``pool_from_cache``)."""
        return [{**node, "table": tables, "len": lens} for node in pool]

    def init_cache(self, batch: int, device):
        """A dense cache for ``batch`` rows, every slot invalid (zero K/V,
        ``pos`` -1): exactly what the model allocates at a first write."""
        cache = self.model.new_cache()
        for layer, node in zip(self.model.layers, cache):
            layer.attn._cache_vars(node, batch, device)
        return cache

    def pool_manifest(self, pool_blocks: int, block_size: int,
                      tp: int = 1) -> list:
        """The shape manifest of the whole pool (every tp rank's slices
        together): ``[[path parts], dtype name, shape]`` per leaf, in
        :meth:`pool_leaves` order, as the reference's init message
        carries it.  ``tp``: the ranks this compute's kv heads are one
        slice of."""
        cfg = self.config
        shape = [pool_blocks, block_size, cfg.kv_heads * tp,
                 cfg.dims_per_head]
        if cfg.kv_cache_dtype == "int8":
            leaves = (("k", "int8", shape), ("v", "int8", shape),
                      ("k_scale", "float32", shape[:3]),
                      ("v_scale", "float32", shape[:3]))
        else:
            dt = str(cfg.dtype).replace("torch.", "")
            leaves = (("k", dt, shape), ("v", dt, shape))
        return [[[f"layer_{i}", "attn", name], dt, list(s)]
                for i in range(cfg.layers) for name, dt, s in leaves]

    def build_pool(self, pool_blocks: int, block_size: int, device):
        """The zero block pool: each dense-cache K/V(/scale) leaf ``[1, S,
        ...]`` becomes ``[pool_blocks, block_size, ...]``.  No ``pos``
        leaf is pooled: validity is synthesized from each row's written
        length, so recycled blocks need no reset pass."""
        cfg = self.config
        shape = (pool_blocks, block_size, cfg.kv_heads, cfg.dims_per_head)
        if cfg.kv_cache_dtype == "int8":
            def layer():
                return {"k": torch.zeros(shape, dtype=torch.int8,
                                         device=device),
                        "v": torch.zeros(shape, dtype=torch.int8,
                                         device=device),
                        "k_scale": torch.zeros(shape[:3],
                                               dtype=torch.float32,
                                               device=device),
                        "v_scale": torch.zeros(shape[:3],
                                               dtype=torch.float32,
                                               device=device)}
        else:
            def layer():
                return {"k": torch.zeros(shape, dtype=cfg.dtype,
                                         device=device),
                        "v": torch.zeros(shape, dtype=cfg.dtype,
                                         device=device)}
        return [layer() for _ in range(cfg.layers)]

    # ---------------------------------------------------- step bodies

    def paged_step(self, pool, tables, ints, gens, temps, topks, k: int):
        """``k`` batched decode iterations over the block pool, one model
        call each, with one host read at the end: feed each row's last
        token at its own position, take each row's next token
        (:func:`sample_logits_rows` — greedy rows the raw argmax, sampled
        rows one draw from their own generator), advance.  ``ints`` packs
        [toks, poss] as a ``[2, B]`` host array; ``gens``, ``temps`` and
        ``topks`` are per-row lists.  A row's position doubles as its
        written length.  Inactive rows ride at position -1: their writes
        are dropped before they reach the pool.  Returns the ``[k, B]``
        tokens on the host (None on a tp rank other than 0, which feeds
        the tokens rank 0 sampled)."""
        dev = tables.device
        plan = torch.as_tensor(ints, dtype=torch.long).to(dev)
        toks, poss = plan[0], plan[1]
        act = poss >= 0
        out = []
        for _ in range(k):
            cache = self.paged_cache(pool, tables, poss.clamp_min(0))
            logits = self.model(toks[:, None], positions=poss[:, None],
                                mode="decode", cache=cache)
            if self.sampler:
                nxt = sample_logits_rows(logits[:, -1], gens, temps, topks)
            else:
                nxt = torch.empty_like(toks)
            if self.tp is not None:
                nxt = self.tp.broadcast(nxt)
            out.append(nxt)
            toks = torch.where(act, nxt, toks)
            poss = torch.where(act, poss + 1, poss)
        if not self.sampler:
            return None
        return torch.stack(out).cpu().numpy()

    def spec_step(self, pool, tables, chunk, ints, gens, temps, topks,
                  k: int):
        """One write-masked variable-width batched step (``k`` = the
        chunk width W): every participating slot feeds its own row of
        ``chunk`` ``[B, W]`` — a speculative slot its last token plus
        ``draft_k - 1`` prompt-lookup drafts (width W), a plain slot just
        its last token (width 1) — at per-slot positions.  Lanes past a
        row's width ride at position -1, so ``paged_kv_write`` drops their
        K/V writes (masked onto the null block's slot 0: a mixed-width
        batch never scribbles past a short row's block capacity) and their
        queries attend nothing.  Accept/reject runs row-wise in
        :func:`spec_verify_rows` with the per-slot generators.  ``ints``
        packs [poss, widths] as a ``[2, B]`` host array.  Returns ``(emit
        [B, W], n_emit [B])`` on the host, from one read (None on a tp
        rank other than 0: no later call of the rank reads them)."""
        dev = tables.device
        plan = torch.as_tensor(ints, dtype=torch.long).to(dev)
        poss, widths = plan[0], plan[1]
        ar = torch.arange(k, device=dev)[None, :]
        cpos = torch.where((poss >= 0)[:, None] & (ar < widths[:, None]),
                           poss[:, None] + ar, -1)  # [B, W]; -1 = masked
        chunk = torch.as_tensor(chunk, dtype=torch.long).to(dev)
        cache = self.paged_cache(pool, tables, poss.clamp_min(0))
        logits = self.model(chunk, positions=cpos, mode="decode",
                            cache=cache)
        if not self.sampler:
            return None
        emit, n_emit = spec_verify_rows(logits, chunk, gens, temps, topks,
                                        ints[1].tolist())
        out = torch.cat([emit, n_emit[:, None]], dim=1).cpu().numpy()
        return out[:, :k], out[:, k]

    def prefill_paged(self, pool, table, chunk, positions):
        """One chunked decode-mode prefill call writing straight into the
        request's pool blocks through its ``[blocks]`` table (a host array
        or a tensor).  Written length before this chunk = its first
        position (chunks land in order).  Returns the last position's
        ``[1, V]`` logits."""
        dev = pool[0]["k"].device
        table = torch.as_tensor(table, dtype=torch.long).to(dev)
        chunk = torch.as_tensor(chunk, dtype=torch.long).to(dev)
        positions = torch.as_tensor(positions, dtype=torch.long).to(dev)
        cache = self.paged_cache(pool, table[None, :], positions[:, 0])
        return self.model(chunk, positions=positions, mode="decode",
                          cache=cache)[:, -1]

    def prefill_dense(self, cache, chunk, positions):
        """Dense-mode batch-1 row-cache prefill (the windowed fallback;
        scattered into its slot later by :meth:`scatter`)."""
        dev = cache[0]["pos"].device
        chunk = torch.as_tensor(chunk, dtype=torch.long).to(dev)
        positions = torch.as_tensor(positions, dtype=torch.long).to(dev)
        return self.model(chunk, positions=positions, mode="decode",
                          cache=cache)[:, -1]

    def dense_step(self, cache, ints, gens, temps, topks):
        """One batched decode step over the dense per-slot rows (windowed
        fallback), with the paged step's row-wise sampling.  Inactive
        rows ride at position -1: the ring writes their slot S-1, in a
        row the next join's :meth:`scatter` replaces whole.  Returns the
        ``[1, B]`` tokens on the host."""
        dev = cache[0]["pos"].device
        plan = torch.as_tensor(ints, dtype=torch.long).to(dev)
        logits = self.model(plan[0][:, None], positions=plan[1][:, None],
                            mode="decode", cache=cache)
        nxt = sample_logits_rows(logits[:, -1], gens, temps, topks)
        return nxt[None, :].cpu().numpy()

    @staticmethod
    def pool_leaves(pool):
        """``(path, leaf)`` for every pool leaf, named as the reference
        names its pool pytree's leaves (``layer_<i>/attn/<k|v|k_scale|
        v_scale>``): the keys of an exported chain on the wire."""
        for i, node in enumerate(pool):
            for name, leaf in node.items():
                yield f"layer_{i}/attn/{name}", leaf

    def gather_blocks(self, pool, idxs) -> dict:
        """Export seam: the K/V(/scale) content of a block chain —
        ``idxs`` is ``[n]`` pool block ids in table order — as flat host
        arrays ``{path: [n, block_size, ...]}`` (the arrays the
        kv-transfer plane ships and the spill tier stores).  Each leaf is
        one ``index_select`` into a fresh tensor (a copy, never a view of
        the pool); their bytes go to the host in one copy.  bf16 leaves
        come back as :data:`kvtier.BF16` bit patterns."""
        leaves = list(self.pool_leaves(pool))
        dev = leaves[0][1].device
        idx = torch.as_tensor(np.asarray(idxs), dtype=torch.long).to(dev)
        parts = [leaf.index_select(0, idx) for _, leaf in leaves]
        host = torch.cat([p.reshape(-1).view(torch.uint8)
                          for p in parts]).cpu().numpy()
        out, off = {}, 0
        for (path, leaf), part in zip(leaves, parts):
            n = part.numel() * part.element_size()
            out[path] = host[off:off + n].view(
                _HOST_DTYPES[leaf.dtype]).reshape(tuple(part.shape))
            off += n
        return out

    @staticmethod
    def graft_blocks(pool, values: dict, dsts):
        """Import seam: write a chain's flat host arrays ``values`` (the
        :meth:`gather_blocks` layout, off the wire or out of the spill
        tier) into the freshly allocated local blocks ``dsts``: per leaf
        one host-to-device copy, a cast to the leaf's dtype and one
        ``index_copy_``.  Every ``dsts`` entry came off the free list at
        refcount 1, so a graft never touches a block a live slot or the
        tree shares."""
        leaves = list(PagedCompute.pool_leaves(pool))
        dev = leaves[0][1].device
        idx = torch.as_tensor(np.asarray(dsts), dtype=torch.long).to(dev)
        for path, leaf in leaves:
            src = host_tensor(values[path]).to(dev)
            leaf.index_copy_(0, idx, src.to(leaf.dtype))

    @staticmethod
    def cow(pool, src: int, dst: int):
        """Copy-on-write at the divergence block: duplicate block ``src``
        into the private block ``dst`` in every pool leaf.  Only the
        shared prefix of the run is ever valid for the attaching row;
        the divergent tail is overwritten by its own prefill before the
        row's length reaches it."""
        for node in pool:
            for leaf in node.values():
                leaf[dst] = leaf[src]

    @staticmethod
    def scatter(cache, row, idx: int):
        """Replace batch row ``idx`` of every dense cache leaf with the
        freshly prefilled batch-1 row (dense-mode slot join)."""
        for node, rnode in zip(cache, row):
            for name, leaf in node.items():
                leaf[idx] = rnode[name][0]


class LocalPlacement:
    """Single-device placement: each body runs eagerly on the engine's
    device under ``torch.inference_mode()``."""

    is_mesh = False

    def __init__(self, device):
        self.device = torch.device(device)

    def build_compute(self, config, params) -> PagedCompute:
        """The bodies over the whole served model on this device."""
        return PagedCompute(Transformer(config, params, device=self.device))

    def info(self) -> dict:
        """Mesh identity for stats(): a single-device engine is a
        1-process, tp=1 'mesh', the reference's schema."""
        return {"num_processes": 1, "mesh_shape": {}, "tp_degree": 1,
                "placement": "local"}

    def wrap(self, op: str, fn: Callable) -> Callable:
        """``fn`` run under ``torch.inference_mode()`` (``op`` names the
        body for plan replay on a mesh; unused here)."""
        del op

        @functools.wraps(fn)
        def run(*args, **kwargs):
            with torch.inference_mode():
                return fn(*args, **kwargs)
        return run

    def build_pool(self, compute: PagedCompute, pool_blocks: int,
                   block_size: int):
        with torch.inference_mode():
            return compute.build_pool(pool_blocks, block_size, self.device)

    def put_tables(self, stack: np.ndarray) -> torch.Tensor:
        """Upload the ``[slots, max_blocks]`` block-table stack."""
        return torch.as_tensor(stack, dtype=torch.long).to(self.device)

    def close(self) -> None:
        pass


def check_placement(placement):
    """The placement an engine may run on: a :class:`LocalPlacement`, or a
    ``mesh_serve.MeshPlacement`` (tensor-parallel serving over a tp
    ring).  Anything else is refused by name."""
    from k8s_tpu_torch.models.mesh_serve import MeshPlacement

    if not isinstance(placement, (LocalPlacement, MeshPlacement)):
        raise TypeError(
            f"placement {type(placement).__name__} is neither a "
            "LocalPlacement nor a mesh_serve.MeshPlacement")
    return placement
