"""Slot-based continuous-batching inference engine: port of
``k8s_tpu/models/engine.py``.

Orca/vLLM-style iteration-level scheduling over a paged KV cache with
shared-prefix reuse and a batched sampling lane:

- a fixed pool of ``B`` decode **slots**; for full-cache configs each
  slot references a per-request **block table** over one shared
  block-granular KV pool (``[num_blocks, block_size, kv_heads,
  head_dim]`` per layer, models/placement.py);
- a **radix prefix tree** (models/kvblocks.py) caches block-sized token
  runs: a request attaches to already-prefilled blocks **by reference**
  (refcounted), copy-on-writes the divergence block when the match ends
  mid-block, and prefills only its unshared tail;
- incoming tails are **prefilled** through decode-mode cache calls at
  exact per-token positions in bucket-sized chunks
  (decode.prefill_buckets_for / split_prefill), straight into the
  request's own pool blocks;
- one **batched decode step** advances every active slot per iteration
  through the transformer's paged decode path (models/paged.py); requests
  join and retire *between* steps, so a long generation never serializes
  short ones.  Up to ``MAX_STEP_TOKENS`` iterations run back to back
  with one host read of their tokens when no active row can retire
  mid-way;
- **sampling rides the batch**: each slot owns a ``torch.Generator`` on
  the model's device seeded by the request's ``seed``, and
  ``decode.sample_logits_rows`` draws each sampled row from its own
  distribution exactly as the exclusive lane's program does, so a
  fixed-seed ``temperature>0`` request emits the same tokens on either
  lane;
- a **bounded admission queue** gives backpressure: when it is full,
  submit() raises :class:`QueueFull` and the HTTP layer answers 503 with
  ``Retry-After``;
- an **exclusive lane** (:meth:`Engine.submit_exclusive`) runs a callable
  single-flight on the engine thread between iterations.

Sliding-window configs keep dense per-slot rows (their ring cache is
position-wrapped per row and does not decompose into shareable
absolute-position blocks); prefix reuse is a full-cache feature.

Knobs: ``K8S_TPU_SERVE_SLOTS`` (decode slots, default 4; the server
treats 0 as "engine off" → single-flight), ``K8S_TPU_SERVE_QUEUE``
(admission queue bound, default 64) and ``K8S_TPU_SERVE_PREFIX_BLOCKS``
(extra pool blocks retained for the prefix tree beyond the ``1 + slots x
blocks_per_row`` floor; 0 disables prefix reuse, unset auto-sizes to two
full-length rows).  ``K8S_TPU_SERVE_BATCH_SAMPLING`` routes in the
server.

A single engine thread owns all device work.  With
``K8S_TPU_REQUEST_LOG=1`` every request gets a bounded timeline
(models/requestlog.py) served at ``/debug/requests``, and every decode
step a ledger record served at ``/debug/engine``.

What the reference has and this port does not:

- its compile ledger (``compile_seams``, ``compile_audit``,
  ``/debug/compiles``) budgets the XLA programs jit builds per bucket and
  per fused width; eager PyTorch builds no programs, so there is nothing
  to budget.  The bounded-shape contract it guarded — prefill chunk
  lengths drawn from the bucket set, decode widths from powers of two —
  holds here too and is reported by ``stats()`` (``prefill_programs``
  lists the chunk lengths used, ``decode_step_ks`` the widths);
- later slices, each refused by name: batched speculative decoding
  (``submit(speculative=...)``), disaggregated export/import
  (``prefill_export``, ``submit_prefilled``), the fleet prefix index
  (``prefix_index``, ``dedup_have``, ``fetch_prefix``,
  ``import_prefix``), the host spill tier (``K8S_TPU_SERVE_SPILL_MB``;
  eviction drops the tree's reference) and mesh placements.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from k8s_tpu_torch.models import requestlog
from k8s_tpu_torch.models import placement as placement_lib
from k8s_tpu_torch.models.decode import (
    _check_cache_capacity,
    prefill_buckets_for,
    sample_logits,
    split_prefill,
)
from k8s_tpu_torch.models.kvblocks import BlockPool, PrefixTree
from k8s_tpu_torch.models.transformer import Transformer
from k8s_tpu_torch.ops._common import resolve_device

log = logging.getLogger(__name__)

DEFAULT_SLOTS = 4
DEFAULT_QUEUE = 64
# preferred KV block size (tokens); clamped into the bucket set so block
# boundaries line up with prefill chunk boundaries
DEFAULT_BLOCK = 16
# fused decode: up to this many batched iterations run back to back with
# one host read when no active row can retire mid-way (no EOS condition,
# >= k tokens remaining everywhere); k is a power of two.  Joins and
# exclusive-lane work wait at most k-1 extra iterations.
MAX_STEP_TOKENS = 4


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    try:
        val = int(raw)
    except ValueError:
        if raw:
            log.warning("ignoring non-integer %s=%r", name, raw)
        return default
    if val < 0:
        log.warning("ignoring negative %s=%d", name, val)
        return default
    return val


def env_slots() -> int:
    """K8S_TPU_SERVE_SLOTS (>= 0; 0 = single-flight, engine off)."""
    return _env_int("K8S_TPU_SERVE_SLOTS", DEFAULT_SLOTS)


def env_queue() -> int:
    """K8S_TPU_SERVE_QUEUE admission bound (0 rejects everything)."""
    return _env_int("K8S_TPU_SERVE_QUEUE", DEFAULT_QUEUE)


def env_prefix_blocks() -> Optional[int]:
    """K8S_TPU_SERVE_PREFIX_BLOCKS: pool blocks retained for the prefix
    tree beyond the slot floor (0 = prefix reuse off; unset = auto)."""
    if "K8S_TPU_SERVE_PREFIX_BLOCKS" not in os.environ:
        return None
    return _env_int("K8S_TPU_SERVE_PREFIX_BLOCKS", 0)


def env_batch_sampling() -> bool:
    """K8S_TPU_SERVE_BATCH_SAMPLING: route temperature>0 requests onto
    the batched slot lanes (default on; 0/false routes them to the
    exclusive single-flight lane).  Consumed by models/server.py."""
    raw = os.environ.get("K8S_TPU_SERVE_BATCH_SAMPLING", "").strip().lower()
    return raw not in ("0", "false", "no", "off")


class QueueFull(RuntimeError):
    """Admission queue at capacity; carries the Retry-After hint."""

    def __init__(self, depth: int, limit: int, retry_after_s: float = 1.0):
        super().__init__(
            f"admission queue full ({depth}/{limit} waiting)")
        self.depth = depth
        self.limit = limit
        self.retry_after_s = retry_after_s


class EngineClosed(RuntimeError):
    pass


def _later_slice(feature: str):
    raise NotImplementedError(
        f"{feature} is not ported yet; it comes with a later slice of "
        "the port")


@dataclasses.dataclass
class _Request:
    """One queued unit of work: either a batched generation (``ids``
    set; greedy or sampled) or an exclusive-lane callable (``fn``)."""

    ids: Optional[np.ndarray] = None
    max_new_tokens: int = 0
    eos_id: Optional[int] = None
    temperature: float = 0.0
    top_k: Optional[int] = None
    seed: int = 0
    fn: Optional[Callable[[], Any]] = None
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    result: Any = None
    error: Optional[BaseException] = None
    # observability: request-recorder timeline id, submit stamp and
    # first-token latency (TTFT)
    rid: Optional[int] = None
    t_submit: float = 0.0
    ttft_s: Optional[float] = None

    def finish(self, result=None, error=None) -> None:
        self.result = result
        self.error = error
        self.done.set()


class _Slot:
    """One decode slot: generation state plus either a block table over
    the shared pool (paged mode) or one batch row of the dense cache
    (windowed fallback).  ``ready`` flips True once prefill landed."""

    __slots__ = ("idx", "req", "pos", "last", "tokens", "ready", "gen",
                 "table", "nblocks")

    def __init__(self, idx: int, maxb: int):
        self.idx = idx
        self.req: Optional[_Request] = None
        self.pos = 0          # absolute position of the NEXT cache write
        self.last = 0         # last emitted token (fed to the next step)
        self.tokens: list[int] = []
        self.ready = False
        self.gen: Optional[torch.Generator] = None  # per-slot sampler
        self.table = np.zeros(maxb, np.int64)  # pool block ids (0 = null)
        self.nblocks = 0

    @property
    def free(self) -> bool:
        return self.req is None

    def clear(self) -> None:
        self.req = None
        self.tokens = []
        self.ready = False
        self.gen = None
        self.table[:] = 0
        self.nblocks = 0


class Engine:
    """Continuous-batching decode engine over one model.

    ``params`` is a state dict (models/bridge.py); the engine builds the
    served :class:`Transformer` on ``device`` (``model``, shared with the
    server's exclusive lane).  All device work happens on the single
    engine thread; callers block in :meth:`submit` /
    :meth:`submit_exclusive` on a per-request event.
    """

    def __init__(self, config, params, *, slots: Optional[int] = None,
                 queue_limit: Optional[int] = None,
                 buckets: Optional[tuple] = None, pad_id: int = 0,
                 block_size: Optional[int] = None,
                 prefix_blocks: Optional[int] = None,
                 metrics: Optional[dict] = None,
                 placement=None, device="cuda"):
        if slots is None:
            slots = env_slots() or DEFAULT_SLOTS
        if slots < 1:
            raise ValueError(f"engine needs slots >= 1, got {slots}")
        if queue_limit is None:
            queue_limit = env_queue()
        if _env_int("K8S_TPU_SERVE_SPILL_MB", 0) > 0:
            _later_slice("the host spill tier (K8S_TPU_SERVE_SPILL_MB)")
        self.config = config
        self.device = resolve_device(device)
        self._placement = placement_lib.check_placement(
            placement if placement is not None
            else placement_lib.LocalPlacement(self.device))
        self.model = Transformer(config, params, device=self.device)
        self._compute = placement_lib.PagedCompute(self.model)
        self.pad_id = pad_id
        self.queue_limit = queue_limit
        self.buckets = tuple(sorted(buckets or prefill_buckets_for(config)))
        if not self.buckets or self.buckets[0] != 1:
            raise ValueError(
                f"buckets must include 1 so every prompt length "
                f"decomposes, got {self.buckets}")
        if config.window_size and \
                self.buckets[-1] > max(1, config.prefill_chunk):
            raise ValueError(
                f"bucket {self.buckets[-1]} exceeds prefill_chunk "
                f"({config.prefill_chunk}): a windowed ring cache only "
                "holds window + prefill_chunk - 1 slots")
        self.metrics = metrics or {}
        self._queue: deque[_Request] = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._crashed = False

        # paged block cache (full-cache configs only): a windowed ring
        # wraps positions per row and cannot share absolute-position
        # blocks, so it keeps the dense per-slot rows
        self.paged = config.window_size is None
        if block_size is None:
            block_size = max(b for b in self.buckets
                             if b <= DEFAULT_BLOCK)
        if block_size not in self.buckets:
            raise ValueError(
                f"block_size {block_size} must be one of the prefill "
                f"buckets {self.buckets} so block boundaries line up "
                "with chunk boundaries")
        self.block_size = block_size
        self._maxb = math.ceil(config.max_seq_len / block_size)
        if prefix_blocks is None:
            prefix_blocks = env_prefix_blocks()
        if prefix_blocks is None:
            prefix_blocks = 2 * self._maxb  # auto: ~two full-length rows
        self.prefix_blocks = prefix_blocks if self.paged else 0
        # pool floor: null block + worst-case fully-private slots, so
        # decode-time allocation can always succeed by evicting the tree
        self.pool_blocks = (1 + slots * self._maxb + self.prefix_blocks) \
            if self.paged else 0
        self._slots = [_Slot(i, self._maxb) for i in range(slots)]

        wrap = self._placement.wrap
        # the prefill chunk lengths used so far (a subset of the buckets)
        self._prefill_lens: set[int] = set()
        # (fused width, has-sampling, is-spec) step shapes used so far
        self._step_ks: set[tuple[int, bool, bool]] = set()
        if self.paged:
            self._step_fn = wrap(self._compute.paged_step)
            self._cow_fn = wrap(self._compute.cow)
            self._prefill_body = wrap(self._compute.prefill_paged)
            self._pool = self._placement.build_pool(
                self._compute, self.pool_blocks, self.block_size)
            self._pool_alloc = BlockPool(self.pool_blocks)
            self._tree = PrefixTree(block_size) \
                if self.prefix_blocks > 0 else None
            self._cache = None
            # device-side table stack, refreshed only when a slot's
            # table changes (join/retire/growth) — not every step
            self._tables_dev = None
            self._tables_dirty = True
        else:
            self._step_fn = wrap(self._compute.dense_step)
            self._scatter_fn = wrap(self._compute.scatter)
            self._prefill_body = wrap(self._compute.prefill_dense)
            self._init_cache_fn = wrap(self._compute.init_cache)
            self._cache = self._init_cache_fn(slots, self.device)
            self._pool = None
            self._pool_alloc = None
            self._tree = None

        # request lifecycle recorder (K8S_TPU_REQUEST_LOG=1): zero
        # overhead when off, every call site guards on the None binding
        self._reqlog = requestlog.maybe_active()

        # stats (mutated on the engine thread; read under _cond)
        self._steps = 0
        self._prefill_chunks = 0
        self._completed = 0
        self._peak_active = 0
        self._prefix_hits = 0
        self._prefix_tokens_saved = 0
        self._cow_copies = 0
        self._occupancy: deque[tuple[int, int]] = deque(maxlen=4096)

        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="lm-engine")
        self._thread.start()

    # ------------------------------------------------------------------ API

    def submit(self, ids, max_new_tokens: int, eos_id: Optional[int] = None,
               temperature: float = 0.0, top_k: Optional[int] = None,
               seed: int = 0, speculative: int = 0,
               timeout: Optional[float] = None) -> list[int]:
        """Batched generation (greedy at ``temperature == 0``, otherwise
        temperature/top-k sampling with the exclusive lane's exact draw
        schedule for ``seed``).  Returns emitted tokens, stopping at the
        first EOS inclusive.  Raises QueueFull under backpressure."""
        if speculative:
            _later_slice("batched speculative decoding (speculative=)")
        ids = np.asarray(ids, np.int64).reshape(-1)
        # the capacity bound, surfaced BEFORE the request occupies queue
        # space (an over-capacity row would run past its table)
        self._validate_gen_args(ids, int(max_new_tokens),
                                float(temperature), top_k)
        req = _Request(ids=ids, max_new_tokens=int(max_new_tokens),
                       eos_id=eos_id, temperature=float(temperature),
                       top_k=top_k, seed=int(seed))
        req.t_submit = time.monotonic()
        if self._reqlog is not None:
            req.rid = self._reqlog.begin(
                int(ids.size), int(max_new_tokens),
                temperature=float(temperature), top_k=top_k)
        return self._enqueue_and_wait(req, timeout)

    def _validate_gen_args(self, ids, max_new_tokens: int,
                           temperature: float, top_k: Optional[int]) -> None:
        if ids.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if top_k is not None and top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        _check_cache_capacity(self.config, int(ids.size),
                              int(max_new_tokens))

    def prefill_export(self, *args, **kwargs):
        _later_slice("disaggregated prefill export (prefill_export)")

    def submit_prefilled(self, *args, **kwargs):
        _later_slice("disaggregated seating (submit_prefilled)")

    def prefix_index(self, *args, **kwargs):
        _later_slice("the fleet prefix index (prefix_index)")

    def dedup_have(self, *args, **kwargs):
        _later_slice("migration dedup (dedup_have)")

    def fetch_prefix(self, *args, **kwargs):
        _later_slice("fleet prefix fetch-on-miss (fetch_prefix)")

    def import_prefix(self, *args, **kwargs):
        _later_slice("fleet prefix fetch-on-miss (import_prefix)")

    def submit_exclusive(self, fn: Callable[[], Any],
                         timeout: Optional[float] = None):
        """Run ``fn`` single-flight on the engine thread between batch
        iterations; FIFO with batched admissions through the same
        bounded queue."""
        req = _Request(fn=fn)
        req.t_submit = time.monotonic()
        if self._reqlog is not None:
            req.rid = self._reqlog.begin(None, 0, kind="exclusive")
        return self._enqueue_and_wait(req, timeout)

    def _enqueue_and_wait(self, req: _Request, timeout: Optional[float]):
        try:
            with self._cond:
                if self._closed:
                    raise EngineClosed("engine is shut down")
                if len(self._queue) >= self.queue_limit:
                    rej = self.metrics.get("rejected")
                    if rej is not None:
                        rej.inc()
                    raise QueueFull(len(self._queue), self.queue_limit)
                self._queue.append(req)
                self._cond.notify_all()
        except QueueFull as e:
            # recorded OUTSIDE the engine lock (the recorder lock stays
            # a leaf); the timeline closes as shed/queue-dominant
            if self._reqlog is not None:
                self._reqlog.shed(req.rid, e.depth, e.limit)
            raise
        except EngineClosed:
            if self._reqlog is not None:
                self._reqlog.retire(req.rid, "closed")
            raise
        if not req.done.wait(timeout):
            # best-effort cancellation: a still-queued request is removed
            # so abandoned retries don't pile phantom work onto a loaded
            # engine; one already admitted to a slot runs to completion
            # (its tokens are simply discarded)
            removed = False
            with self._cond:
                try:
                    self._queue.remove(req)
                    removed = True
                except ValueError:
                    pass
            if removed and self._reqlog is not None:
                self._reqlog.retire(req.rid, "abandoned")
            raise TimeoutError("generation did not complete in time")
        if req.error is not None:
            raise req.error
        return req.result

    @property
    def healthy(self) -> bool:
        """False once the engine loop has died on an unexpected error —
        the serving /healthz flips to 503 so the pod is restarted instead
        of answering 500 to every generate.  Deliberate shutdown() and
        queue shedding are NOT unhealthy."""
        # lock-free: a wedged loop holding _cond must not hang the probe
        return not self._crashed

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def active_slots(self) -> int:
        with self._cond:
            return sum(1 for s in self._slots if not s.free)

    def stats(self) -> dict:
        mesh_info = self._placement.info()
        with self._cond:
            return {
                "placement": mesh_info["placement"],
                "num_processes": mesh_info["num_processes"],
                "mesh_shape": mesh_info["mesh_shape"],
                "tp_degree": mesh_info["tp_degree"],
                "slots": len(self._slots),
                "active": sum(1 for s in self._slots if not s.free),
                "queue_depth": len(self._queue),
                "queue_limit": self.queue_limit,
                # decode iterations (one batched model call each)
                "steps": self._steps,
                "completed": self._completed,
                "peak_active": self._peak_active,
                "buckets": list(self.buckets),
                # the prefill chunk lengths used: always bucket sizes
                "prefill_programs": sorted(self._prefill_lens),
                # the (fused width, sampling, spec) step shapes used
                "decode_programs": len(self._step_ks),
                "decode_step_ks": sorted(
                    [list(t) for t in self._step_ks]),
                # model calls: one per prefill chunk and per decode
                # iteration (what the kernels' launch counts scale with)
                "prefill_chunks": self._prefill_chunks,
                "model_calls": self._prefill_chunks + self._steps,
                "occupancy_timeline": list(self._occupancy),
                # paged-cache / prefix-reuse surface
                "paged": self.paged,
                "block_size": self.block_size if self.paged else 0,
                "pool_blocks": self.pool_blocks,
                "blocks_in_use": self._pool_alloc.used_blocks
                if self.paged else 0,
                "tree_nodes": self._tree.nodes if self._tree else 0,
                "prefix_hits": self._prefix_hits,
                "prefix_tokens_saved": self._prefix_tokens_saved,
                "cow_copies": self._cow_copies,
                "tree_evictions": self._tree.evictions
                if self._tree else 0,
                "request_log": self._reqlog is not None,
            }

    def shutdown(self, timeout: float = 10.0) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout)
        self._placement.close()

    def debug_check_blocks(self) -> None:
        """Test hook: assert pool refcounts exactly equal the references
        actually held (slot tables + tree nodes) and that free blocks
        hold no references.  Call when the engine is quiescent."""
        if not self.paged:
            return
        expect = [0] * self.pool_blocks
        with self._cond:
            for s in self._slots:
                if s.req is not None:
                    for b in s.table[:s.nblocks]:
                        expect[int(b)] += 1
        if self._tree is not None:
            def walk(node):
                for child in node.children.values():
                    expect[child.block] += 1
                    walk(child)
            walk(self._tree.root)
        actual = [self._pool_alloc.refcount(i)
                  for i in range(self.pool_blocks)]
        if actual != expect:
            diffs = [(i, e, a) for i, (e, a)
                     in enumerate(zip(expect, actual)) if e != a]
            raise AssertionError(f"block refcount drift: {diffs[:8]}")

    # ---------------------------------------------------- block machinery

    def _alloc_block(self, slot: Optional[_Slot] = None) -> int:
        """Pop a free pool block, evicting least-recently-hit prefix-tree
        leaves as needed; with the pool floor of 1 + slots x blocks_per_
        row this cannot fail while slot tables are within capacity.
        Recycled blocks need no scrubbing: stale content sits above the
        new owner's written length and is masked by the synthesized
        validity.  ``slot`` names the request the allocation serves so
        evictions land on ITS timeline (the ``evict`` phase)."""
        idx = self._pool_alloc.alloc()
        if idx is not None:
            return idx
        t0 = time.monotonic()
        evicted = 0
        while idx is None:
            # only leaves whose block nothing else pins: evicting a
            # slot-referenced block frees nothing and throws away a hot
            # cache entry for no progress
            victim = self._tree.evict_leaf(
                pinned=lambda b: self._pool_alloc.refcount(b) > 1) \
                if self._tree else None
            if victim is None:
                raise RuntimeError(
                    "KV block pool exhausted (no evictable prefix "
                    "blocks) — pool sizing invariant violated")
            released = self._pool_alloc.release(victim.block)
            if not released:
                raise RuntimeError("unpinned tree leaf must free its block")
            evicted += 1
            idx = self._pool_alloc.alloc()
        if self._reqlog is not None and slot is not None \
                and slot.req is not None:
            self._reqlog.evicted(slot.req.rid, evicted,
                                 time.monotonic() - t0)
        return idx

    def _release_table(self, slot: _Slot) -> None:
        for b in slot.table[:slot.nblocks]:
            self._pool_alloc.release(int(b))
        slot.table[:] = 0
        slot.nblocks = 0
        self._tables_dirty = True
        self._update_block_gauge()

    def _update_block_gauge(self) -> None:
        gauge = self.metrics.get("blocks_in_use")
        if gauge is not None and self._pool_alloc is not None:
            gauge.set(self._pool_alloc.used_blocks)

    def _prefill_fn(self, chunk_len: int) -> Callable:
        """The prefill body for one bucket-sized chunk (recording the
        length; stats() reads the set from probe threads, so it is
        rebound, never mutated in place)."""
        if chunk_len not in self._prefill_lens:
            self._prefill_lens = self._prefill_lens | {chunk_len}
        self._prefill_chunks += 1
        return self._prefill_body

    # -------------------------------------------------------- engine loop

    def _loop(self) -> None:
        try:
            while True:
                with self._cond:
                    while (not self._closed and not self._queue
                           and not any(s.ready for s in self._slots)):
                        self._cond.wait()
                    if self._closed:
                        self._drain_locked()
                        return
                    actions = self._admit_locked()
                for req, slot in actions:
                    if req.fn is not None:
                        self._run_exclusive(req)
                        continue
                    # prefill convoy: decode-ready slots stalled behind
                    # this admission's prefill — the stall bills to each
                    # VICTIM's prefill phase
                    waiting = [s.req.rid for s in self._slots
                               if s.ready and s.req is not None]
                    t0 = time.monotonic()
                    self._prefill_into(slot, req)
                    if waiting:
                        conv = self.metrics.get("prefill_convoy")
                        if conv is not None:
                            conv.inc()
                        if self._reqlog is not None:
                            dur = time.monotonic() - t0
                            for rid in waiting:
                                self._reqlog.convoy(rid, dur)
                if any(s.ready for s in self._slots):
                    self._decode_step_all()
        except BaseException:  # noqa: BLE001 - engine thread must not die silently
            log.exception("engine loop crashed; failing all requests")
            with self._cond:
                self._closed = True
                self._crashed = True
                self._drain_locked()

    def _drain_locked(self) -> None:
        err = EngineClosed("engine shut down with requests in flight")
        while self._queue:
            req = self._queue.popleft()
            if self._reqlog is not None:
                self._reqlog.retire(req.rid, "shutdown")
            req.finish(error=err)
        for s in self._slots:
            if s.req is not None:
                if self._reqlog is not None:
                    self._reqlog.retire(s.req.rid, "shutdown")
                s.req.finish(error=err)
                s.clear()

    def _admit_locked(self) -> list[tuple[_Request, Optional[_Slot]]]:
        """FIFO admission: exclusive requests always pop (they run inline
        between steps); batched requests pop while a free slot exists."""
        out: list[tuple[_Request, Optional[_Slot]]] = []
        while self._queue:
            head = self._queue[0]
            if head.fn is not None:
                out.append((self._queue.popleft(), None))
                continue
            slot = next((s for s in self._slots if s.free), None)
            if slot is None:
                break
            slot.req = self._queue.popleft()
            slot.ready = False
            out.append((slot.req, slot))
        return out

    def _run_exclusive(self, req: _Request) -> None:
        rlog = self._reqlog
        t0 = time.monotonic()
        if req.t_submit:
            qw_h = self.metrics.get("queue_wait")
            if qw_h is not None:
                qw_h.observe(t0 - req.t_submit)
        if rlog is not None:
            rlog.admitted(req.rid, -1, t0 - req.t_submit
                          if req.t_submit else 0.0)
        try:
            result = req.fn()
        except BaseException as e:  # noqa: BLE001 - surfaced to the caller
            req.finish(error=e)
            if rlog is not None:
                rlog.step(req.rid, 0, 1, 0, time.monotonic() - t0)
                rlog.retire(req.rid, "error")
            return
        req.finish(result=result)
        if rlog is not None:
            # the whole generation is opaque from out here: one step
            # record carrying its full wall time (decode phase)
            rlog.step(req.rid, 0, 1, 0, time.monotonic() - t0)
            rlog.retire(req.rid, "ok")
        with self._cond:
            self._completed += 1

    def _first_token(self, req: _Request, last_logits) -> tuple:
        """The first token from the prefill's last-position ``[1, V]``
        logits with the exclusive lane's exact draw schedule: a generator
        seeded by the request's seed draws it (sampled requests) and is
        carried for the decode steps.  Returns ``(token, generator)``."""
        gen = torch.Generator(device=self.device).manual_seed(req.seed)
        first = sample_logits(last_logits, gen, req.temperature, req.top_k)
        return int(first[0]), gen

    def _attach_prefix(self, slot: _Slot, ids) -> tuple:
        """Walk the prefix tree and attach shared blocks by reference;
        copy-on-write the divergence block when the match ends mid-run.
        Returns ``(shared, blocks, cow)``: the number of prompt tokens
        whose prefill is skipped (always <= len(ids) - 1: the last
        prompt token is recomputed for its logits), the blocks attached,
        and whether the divergence block was copy-on-written."""
        if self._tree is None:
            return 0, 0, False
        full, partial = self._tree.match(ids, len(ids) - 1)
        shared = 0
        for node in full:
            self._pool_alloc.retain(node.block)
            slot.table[slot.nblocks] = node.block
            slot.nblocks += 1
            shared += self.block_size
        if partial is not None:
            node, j = partial
            dst = self._alloc_block(slot)
            self._cow_fn(self._pool, node.block, dst)
            slot.table[slot.nblocks] = dst
            slot.nblocks += 1
            shared += j
            self._cow_copies += 1
        if shared > 0:
            self._prefix_hits += 1
            self._prefix_tokens_saved += shared
            hits = self.metrics.get("prefix_hits")
            if hits is not None:
                hits.inc()
            saved = self.metrics.get("prefill_saved")
            if saved is not None:
                saved.inc(shared)
        return shared, len(full) + (1 if partial is not None else 0), \
            partial is not None

    def _run_chunks(self, req: _Request, start: int, call) -> Any:
        """Prefill ``req.ids[start:]`` in bucket-sized chunks through
        ``call(c, chunk, positions)``; returns the last call's logits."""
        ids, off, last = req.ids, start, None
        for c in split_prefill(len(ids) - start, self.buckets):
            tc0 = time.monotonic()
            chunk = ids[off:off + c][None, :]
            positions = (off + np.arange(c, dtype=np.int64))[None, :]
            last = call(c, chunk, positions)
            if self._reqlog is not None:
                self._reqlog.prefill_chunk(req.rid, c,
                                           time.monotonic() - tc0, False)
            off += c
        return last

    def _prefill_into(self, slot: _Slot, req: _Request) -> None:
        """Prefill one prompt into the slot (tail-only when a prefix was
        attached), then emit the first token.  A first-token EOS or
        max_new_tokens == 1 retires the request without ever occupying a
        step."""
        ids = req.ids
        rlog = self._reqlog
        t_adm = time.monotonic()
        qw = t_adm - req.t_submit if req.t_submit else 0.0
        qw_h = self.metrics.get("queue_wait")
        if qw_h is not None:
            qw_h.observe(qw)
        if rlog is not None:
            rlog.admitted(req.rid, slot.idx, qw)
        row = None
        try:
            if self.paged:
                shared, pblocks, cow = self._attach_prefix(slot, ids)
                if rlog is not None:
                    rlog.prefix_outcome(
                        req.rid,
                        "cow" if cow else ("hit" if shared else "miss"),
                        pblocks, shared)
                # blocks covering the unshared prompt tail (the CoW
                # block, if any, already covers its own span)
                needed = math.ceil(len(ids) / self.block_size)
                while slot.nblocks < needed:
                    slot.table[slot.nblocks] = self._alloc_block(slot)
                    slot.nblocks += 1
                self._tables_dirty = True
                self._update_block_gauge()
                table = self._placement.put_tables(slot.table[:needed])

                def call(c, chunk, positions):
                    # the table columns this chunk's positions reach
                    nb = -(-(int(positions[0, -1]) + 1) // self.block_size)
                    return self._prefill_fn(c)(self._pool, table[:nb],
                                               chunk, positions)
                last = self._run_chunks(req, shared, call)
                first, slot.gen = self._first_token(req, last)
                if self._tree is not None:
                    # re-match NOW: block allocations above may have
                    # evicted part of the originally-matched path, and
                    # inserting under a detached node would leak
                    # unreachable (unevictable) references
                    created = self._tree.insert(
                        self._tree.match(ids, len(ids) - 1)[0], ids,
                        [int(b) for b in slot.table[:slot.nblocks]])
                    for node in created:
                        self._pool_alloc.retain(node.block)
            else:
                row = self._init_cache_fn(1, self.device)
                last = self._run_chunks(
                    req, 0, lambda c, chunk, positions: self._prefill_fn(c)(
                        row, chunk, positions))
                first, slot.gen = self._first_token(req, last)
        except BaseException as e:  # noqa: BLE001 - bad request must not kill the loop
            req.finish(error=e)
            if rlog is not None:
                rlog.retire(req.rid, "error")
            with self._cond:
                if self.paged:
                    self._release_table(slot)
                slot.clear()
            return
        # TTFT: submit to first emitted token, the _first_token read
        # above having forced the whole prefill
        now = time.monotonic()
        req.ttft_s = now - req.t_submit if req.t_submit else None
        if req.ttft_s is not None:
            tt_h = self.metrics.get("ttft")
            if tt_h is not None:
                tt_h.observe(req.ttft_s)
        if rlog is not None:
            rlog.prefill_done(req.rid, now - t_adm,
                              req.ttft_s if req.ttft_s is not None
                              else now - t_adm)
        tokens = [first]
        if (req.eos_id is not None and first == req.eos_id) \
                or req.max_new_tokens <= 1:
            self._retire(slot, req, tokens,
                         "eos" if req.eos_id is not None
                         and first == req.eos_id else "max_tokens")
            return
        if not self.paged:
            self._scatter_fn(self._cache, row, slot.idx)
        slot.tokens = tokens
        slot.last = first
        slot.pos = len(ids)
        slot.ready = True
        with self._cond:
            self._peak_active = max(
                self._peak_active,
                sum(1 for s in self._slots if not s.free))

    def _retire(self, slot: _Slot, req: _Request, tokens: list[int],
                reason: str = "max_tokens") -> None:
        tok_counter = self.metrics.get("tokens")
        if tok_counter is not None:
            tok_counter.inc(len(tokens))
        if req.temperature > 0:
            sampled = self.metrics.get("sampled_batched")
            if sampled is not None:
                sampled.inc()
        # TPOT: decode-side per-token latency, (e2e - TTFT) / (n - 1)
        if req.ttft_s is not None and len(tokens) > 1 and req.t_submit:
            tp_h = self.metrics.get("tpot")
            if tp_h is not None:
                tp_h.observe(
                    (time.monotonic() - req.t_submit - req.ttft_s)
                    / (len(tokens) - 1))
        if self._reqlog is not None:
            self._reqlog.retire(req.rid, reason, tokens=len(tokens),
                                ttft_s=req.ttft_s)
        req.finish(result=tokens)
        with self._cond:
            self._completed += 1
            if self.paged:
                self._release_table(slot)
            slot.clear()

    def _decode_step_all(self) -> None:
        """One batched step over every ready slot: ``k`` iterations (a
        power of two up to MAX_STEP_TOKENS when no active row can retire
        mid-way, else 1) and one host read.  Inactive rows ride along at
        position -1: (paged) their writes are dropped before reaching the
        pool, or (dense) the model's write slot wraps to S-1 in a row the
        next join's scatter fully replaces.  Row independence of the
        batched math keeps active rows exact."""
        B = len(self._slots)
        active = [s for s in self._slots if s.ready]
        k = 1
        if self.paged and active:
            if all(s.req.eos_id is None for s in active):
                k = min(MAX_STEP_TOKENS,
                        min(s.req.max_new_tokens - len(s.tokens)
                            for s in active))
                while k & (k - 1):  # round down to a power of two
                    k &= k - 1
            # grow tables so every write of the fused window lands in an
            # owned block
            grew = False
            for s in active:
                need_bi = (s.pos + k - 1) // self.block_size
                while s.nblocks <= need_bi:
                    s.table[s.nblocks] = self._alloc_block(s)
                    s.nblocks += 1
                    grew = True
            if grew:
                self._tables_dirty = True
                self._update_block_gauge()
        ints = np.zeros((2, B), np.int64)  # [toks, poss]
        ints[0] = self.pad_id
        ints[1] = -1
        gens: list = [None] * B
        temps = [0.0] * B
        topks = [0] * B
        for s in active:
            ints[0, s.idx] = s.last
            ints[1, s.idx] = s.pos
            gens[s.idx] = s.gen
            temps[s.idx] = s.req.temperature
            topks[s.idx] = s.req.top_k or 0
        sampling = any(s.req.temperature > 0 for s in active)
        step_key = (k, sampling, False)
        t_step = time.monotonic()
        if self.paged:
            if self._tables_dirty:
                self._tables_dev = self._placement.put_tables(
                    np.stack([s.table for s in self._slots]))
                self._tables_dirty = False
            # the table columns any row's positions reach this step
            width = max(-(-(s.pos + k) // self.block_size) for s in active)
            toks_host = self._step_fn(self._pool,
                                      self._tables_dev[:, :width], ints,
                                      gens, temps, topks, k)  # [k, B]
        else:
            toks_host = self._step_fn(self._cache, ints, gens, temps,
                                      topks)  # [1, B]
        step_dur = time.monotonic() - t_step
        sd_h = self.metrics.get("step_duration")
        if sd_h is not None:
            sd_h.observe(step_dur)
        # rebound, never mutated: stats() reads it from probe threads
        self._step_ks = self._step_ks | {step_key}
        occ = self.metrics.get("occupancy")
        if occ is not None:
            occ.set(len(active))
        with self._cond:
            for _ in range(k):
                self._steps += 1
                self._occupancy.append((self._steps, len(active)))
            seq = self._steps
        rlog = self._reqlog
        if rlog is not None:
            # ledger + per-request participation BEFORE the retire loop
            # clears slots (the fused-step gate guarantees every active
            # row emitted exactly k tokens)
            rlog.engine_step(seq, len(active), k, 0,
                             k * len(active), step_dur)
            for s in active:
                rlog.step(s.req.rid, seq, k, k, step_dur)
        for s in active:
            req = s.req
            for i in range(k):
                tok = int(toks_host[i, s.idx])
                s.tokens.append(tok)
                s.pos += 1
                s.last = tok
                hit_eos = req.eos_id is not None and tok == req.eos_id
                if hit_eos or len(s.tokens) >= req.max_new_tokens:
                    if i != k - 1:
                        raise RuntimeError(
                            "mid-window retirement is excluded by the "
                            "fused-step gate")
                    self._retire(s, req, s.tokens,
                                 "eos" if hit_eos else "max_tokens")
                    break
