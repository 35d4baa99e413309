"""Compute seam for the serving engine: port of
``k8s_tpu/models/placement.py``.

The engine (models/engine.py) is a host-side scheduler (slot admission,
block-pool bookkeeping, batch-plan construction over numpy) above a set
of device bodies (batched decode step, chunked prefill, copy-on-write).
This module holds the bodies and the placement that runs them:

- :class:`PagedCompute` — functions on tensors over the port's
  :class:`~k8s_tpu_torch.models.transformer.Transformer`.  The pool is a
  list of per-layer dicts of ``[num_blocks, block_size, ...]`` tensors
  that the transformer's paged decode step updates in place, so a body
  returns what the engine reads (tokens, last-position logits) and
  nothing else.
- :class:`LocalPlacement` — runs a body under ``torch.inference_mode()``
  on the engine's device, with no compile (eager PyTorch has no program
  to build); allocates the zero pool on the device and uploads block
  tables.

The reference's ``MeshPlacement`` (params tensor-sharded over a ``tp``
mesh, the pool head-sharded per host) comes with the ``parallel/`` slice
of the port; :func:`check_placement` refuses anything but the local
placement.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from k8s_tpu_torch.models.decode import sample_logits_rows
from k8s_tpu_torch.models.transformer import Transformer


class PagedCompute:
    """The engine's device bodies over one served transformer.

    Every method sees the model, the pool or dense cache, and per-call
    plan data, and mutates the pool or cache in place."""

    def __init__(self, model: Transformer):
        self.model = model
        self.config = model.config

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
        tokens on the host."""
        dev = tables.device
        plan = torch.as_tensor(ints, dtype=torch.long).to(dev)
        toks, poss = plan[0], plan[1]
        act = poss >= 0
        out = []
        for _ in range(k):
            cache = self.paged_cache(pool, tables, poss.clamp_min(0))
            logits = self.model(toks[:, None], positions=poss[:, None],
                                mode="decode", cache=cache)
            nxt = sample_logits_rows(logits[:, -1], gens, temps, topks)
            out.append(nxt)
            toks = torch.where(act, nxt, toks)
            poss = torch.where(act, poss + 1, poss)
        return torch.stack(out).cpu().numpy()

    def prefill_paged(self, pool, table, chunk, positions):
        """One chunked decode-mode prefill call writing straight into the
        request's pool blocks through its ``[blocks]`` table.  Written
        length before this chunk = its first position (chunks land in
        order).  Returns the last position's ``[1, V]`` logits."""
        dev = table.device
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

    def __init__(self, device):
        self.device = torch.device(device)

    def info(self) -> dict:
        """Mesh identity for stats(): a single-device engine is a
        1-process, tp=1 'mesh', the reference's schema."""
        return {"num_processes": 1, "mesh_shape": {}, "tp_degree": 1,
                "placement": "local"}

    def wrap(self, fn: Callable) -> Callable:
        """``fn`` run under ``torch.inference_mode()``."""
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


def check_placement(placement) -> LocalPlacement:
    """The placement an engine may run on: only :class:`LocalPlacement`
    is ported."""
    if not isinstance(placement, LocalPlacement):
        raise NotImplementedError(
            f"placement {type(placement).__name__} is not ported: mesh "
            "serving (MeshPlacement, K8S_TPU_SERVE_MESH) comes with the "
            "parallel/ slice of the port; use LocalPlacement")
    return placement
