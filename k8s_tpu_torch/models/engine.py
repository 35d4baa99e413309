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
- **speculative decoding rides the batch too**: a spec slot verifies its
  ``draft_k``-token prompt-lookup chunk in the same model call that
  advances its 1-token neighbours — per-slot widths with write-masked
  padding lanes (a masked lane rides at position -1 and its K/V write is
  dropped), host-side drafting (``decode.lookup_draft_host``) mirroring
  the exclusive lane's exactly, and the shared ``decode.spec_accept_*``
  accept/reject with the exclusive lane's per-verify draw schedule from
  the slot's generator, so at a fixed seed a batched spec slot emits
  token for token what ``decode.make_speculative_generate_fn`` emits
  for the same batch-1 request.  Spec slots with different ``draft_k``
  are grouped per step (round-robin across groups), so the chunk width
  stays uniform.  Speculative requests on windowed configs (dense rows,
  no write-maskable pool) take the exclusive lane;
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
full-length rows).  ``K8S_TPU_SERVE_BATCH_SAMPLING`` and
``K8S_TPU_SERVE_BATCH_SPEC`` route in the server.

A single engine thread owns all device work.  With
``K8S_TPU_REQUEST_LOG=1`` every request gets a bounded timeline
(models/requestlog.py) served at ``/debug/requests``, every decode
step a ledger record served at ``/debug/engine``, and the engine thread's
loop is cut into phases on the profiler's clock (``_phase``; the phase
ledger, its rollup also at ``/debug/engine``).  With span tracing on
(``K8S_TPU_TRACE_SAMPLE``, ``k8s_tpu_torch.trace``) a request's
``prefill`` and ``exclusive_generate`` spans parent under the trace
context the ingress hands to ``submit`` / ``submit_exclusive`` /
``prefill_export`` (``trace_ctx``), and every batched step records a
``decode_step`` span of its own, as the reference's engine does.

What the reference has and this port does not:

- its compile ledger (``compile_seams``, ``compile_audit``,
  ``/debug/compiles``) budgets the XLA programs jit builds per bucket and
  per fused width; eager PyTorch builds no programs, so there is nothing
  to budget.  The bounded-shape contract it guarded — prefill chunk
  lengths drawn from the bucket set, decode widths from powers of two —
  holds here too and is reported by ``stats()`` (``prefill_programs``
  lists the chunk lengths used, ``decode_step_ks`` the widths);

Tensor-parallel serving, as in the reference: with a
``mesh_serve.MeshPlacement`` the engine's model is tp rank 0's shard and
every body call is replayed by the follower ranks (models/mesh_serve.py).
The scheduler above never branches on it.  Under a mesh, windowed configs
(dense rows, nothing to head-split), the spill tier and disaggregation
(no local pool to export) are refused or off with the reference's
messages, and ``stats()`` reports ``placement``, ``num_processes``,
``mesh_shape`` and ``tp_degree``.

Tiered KV memory and disaggregation, as in the reference:

- **the host spill tier** (``spill_mb`` / ``K8S_TPU_SERVE_SPILL_MB``,
  models/kvtier.py): an evicted prefix-tree leaf demotes its block to
  host memory before its pool reference drops, and a later prompt whose
  chain fingerprint is resident promotes it back through one graft
  instead of re-prefilling it;
- **disaggregated serving**: :meth:`Engine.prefill_export` prefills a
  request on the ordinary slot path, emits its first token and exports
  its block chain to the host in one gather, holding no decode seat;
  :meth:`Engine.submit_prefilled` seats a request straight from an
  imported chain (one graft into fresh blocks, a tree graft so the
  prefix is shareable at once) and decodes on.  The wire between the two
  is models/kvxfer.py; :meth:`Engine.dedup_have`,
  :meth:`Engine.prefix_index`, :meth:`Engine.fetch_prefix` and
  :meth:`Engine.import_prefix` serve its dedup handshake and the fleet
  prefix fetch.  Where the reference carries a threefry key, the
  manifest carries the slot generator's state (``get_state()`` as a
  ``uint8`` array named ``key``), which the receiving engine restores
  into a generator on its own device: a fixed-seed sampled request that
  migrates emits what it emits locally.  A state from another device
  type is refused; a greedy request, which never draws, also seats with
  the reference's ``uint32[2]`` key.
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

from k8s_tpu_torch import trace
from k8s_tpu_torch.models import kvtier, requestlog
from k8s_tpu_torch.models import placement as placement_lib
from k8s_tpu_torch.models.decode import (
    _check_cache_capacity,
    check_speculative_capacity,
    lookup_draft_host,
    prefill_buckets_for,
    sample_logits,
    split_prefill,
)
from k8s_tpu_torch.models.kvblocks import BlockPool, PrefixTree, chain_tokens
from k8s_tpu_torch.models.paged import quantize_kv
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


def env_batch_spec() -> bool:
    """K8S_TPU_SERVE_BATCH_SPEC: route speculative requests onto the
    batched slot lanes (default on; 0/false routes them to the exclusive
    single-flight lane).  Consumed by models/server.py; windowed configs
    ride the exclusive lane regardless (their dense rows have no
    write-maskable block pool)."""
    raw = os.environ.get("K8S_TPU_SERVE_BATCH_SPEC", "").strip().lower()
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


class PoolExhausted(RuntimeError):
    """The KV block pool cannot take an imported block chain right now
    (receive-side backpressure of disaggregated serving): with every
    free and tree-evictable block counted, the chain still does not fit.
    The sender maps it to a 503-class refusal, so the router re-places
    the request instead of wedging the decode pod."""

    def __init__(self, needed: int, available: int,
                 retry_after_s: float = 1.0):
        super().__init__(
            f"KV pool cannot seat {needed} migrated blocks "
            f"({available} free+evictable)")
        self.needed = needed
        self.available = available
        self.retry_after_s = retry_after_s


class DedupStale(RuntimeError):
    """A deduplicated migration promised prefix blocks this engine no
    longer holds (evicted between the dedup answer and the seat).  The
    ``kind`` travels back as a typed kvxfer error frame and the sender
    re-sends the full chain once."""

    kind = "dedup_stale"


def _quantize_host(arr):
    """``paged.quantize_kv`` over one host array (the spill tier's
    quantizer)."""
    return quantize_kv(placement_lib.host_tensor(arr))


@dataclasses.dataclass
class _Request:
    """One queued unit of work: either a batched generation (``ids``
    set; greedy, sampled or speculative) or an exclusive-lane callable
    (``fn``)."""

    ids: Optional[np.ndarray] = None
    max_new_tokens: int = 0
    eos_id: Optional[int] = None
    temperature: float = 0.0
    top_k: Optional[int] = None
    seed: int = 0
    speculative: int = 0  # draft_k (>= 2) for batched spec; 0 = off
    fn: Optional[Callable[[], Any]] = None
    # disaggregated serving: a prefill-only request emits its first token
    # and block manifest and retires without a decode slot; a
    # manifest-carrying request seats straight from imported blocks
    export: bool = False
    manifest: Optional[dict] = None
    seated_cb: Optional[Callable[[], None]] = None
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    result: Any = None
    error: Optional[BaseException] = None
    # observability: request-recorder timeline id, the remote trace
    # context the ingress extracted from the inbound W3C traceparent,
    # submit stamp and first-token latency (TTFT)
    rid: Optional[int] = None
    trace_ctx: Optional[tuple] = None
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
                 "table", "nblocks", "ctx")

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
        # full context (prompt + emitted) of a speculative slot: the
        # host-side drafting reads it
        self.ctx: Optional[list[int]] = None

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
        self.ctx = None


class Engine:
    """Continuous-batching decode engine over one model.

    ``params`` is a state dict (models/bridge.py); the placement builds the
    served :class:`Transformer` from it (``model``, shared with the
    server's exclusive lane): the whole model on ``device`` by default, tp
    rank 0's shard on the placement's device under a mesh.  All device
    work happens on the single engine thread; callers block in
    :meth:`submit` / :meth:`submit_exclusive` on a per-request event.
    """

    def __init__(self, config, params, *, slots: Optional[int] = None,
                 queue_limit: Optional[int] = None,
                 buckets: Optional[tuple] = None, pad_id: int = 0,
                 block_size: Optional[int] = None,
                 prefix_blocks: Optional[int] = None,
                 metrics: Optional[dict] = None,
                 placement=None, spill_mb: Optional[int] = None,
                 device="cuda"):
        if slots is None:
            slots = env_slots() or DEFAULT_SLOTS
        if slots < 1:
            raise ValueError(f"engine needs slots >= 1, got {slots}")
        if queue_limit is None:
            queue_limit = env_queue()
        if spill_mb is None:
            spill_mb = kvtier.env_spill_mb()
        self.config = config
        if placement is None:
            placement = placement_lib.LocalPlacement(resolve_device(device))
        self._placement = placement_lib.check_placement(placement)
        self.device = placement.device
        if self._placement.is_mesh and config.window_size is not None:
            raise ValueError(
                "mesh serving needs the paged block pool; windowed "
                "configs keep dense per-slot rows and stay single-host")
        self._compute = self._placement.build_compute(config, params)
        self.model = self._compute.model
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
            self._step_fn = wrap("paged_step", self._compute.paged_step)
            # the variable-width speculative verify step
            self._spec_fn = wrap("spec_step", self._compute.spec_step)
            self._cow_fn = wrap("cow", self._compute.cow)
            self._prefill_body = wrap("prefill",
                                      self._compute.prefill_paged)
            self._pool = self._placement.build_pool(
                self._compute, self.pool_blocks, self.block_size)
            # disaggregated block export/import and the spill tier's
            # demote/promote: gather a chain to the host, graft one into
            # fresh local blocks.  A mesh placement has no single-device
            # pool to export from: disaggregation composes tiers of
            # single-device (or whole-gang) pods, so the seams stay local
            if not self._placement.is_mesh:
                self._gather_fn = wrap("kv_gather",
                                       self._compute.gather_blocks)
                self._graft_fn = wrap("kv_graft",
                                      self._compute.graft_blocks)
            else:
                self._gather_fn = None
                self._graft_fn = None
            # {leaf path: (per-block tail shape, host dtype)}: what
            # submit_prefilled validates an imported chain against
            # before any device work
            self._pool_leaf_meta = {
                path: (tuple(leaf.shape[2:]),
                       placement_lib.host_dtype(leaf.dtype))
                for path, leaf in self._compute.pool_leaves(self._pool)}
            self._pool_alloc = BlockPool(self.pool_blocks)
            self._tree = PrefixTree(block_size) \
                if self.prefix_blocks > 0 else None
            # host-RAM spill tier: evicted tree leaves demote to bounded
            # host buffers instead of being dropped (0 MB = off).  Needs
            # the gather/graft chain seams, so a mesh placement (no local
            # pool export) stays single-tier
            self._spill = kvtier.SpillTier(int(spill_mb) * (1 << 20)) \
                if (self._tree is not None and int(spill_mb) > 0
                    and self._gather_fn is not None) else None
            self._cache = None
            # device-side table stack, refreshed only when a slot's
            # table changes (join/retire/growth) — not every step
            self._tables_dev = None
            self._tables_dirty = True
        else:
            self._step_fn = wrap("dense_step", self._compute.dense_step)
            self._scatter_fn = wrap("scatter", self._compute.scatter)
            self._prefill_body = wrap("prefill_dense",
                                      self._compute.prefill_dense)
            self._init_cache_fn = wrap("init_cache",
                                       self._compute.init_cache)
            self._cache = self._init_cache_fn(slots, self.device)
            self._pool = None
            self._pool_alloc = None
            self._tree = None
            self._gather_fn = None
            self._graft_fn = None
            self._pool_leaf_meta = {}
            self._spill = None

        # request lifecycle recorder (K8S_TPU_REQUEST_LOG=1): zero
        # overhead when off, every call site guards on the None binding
        self._reqlog = requestlog.maybe_active()
        # its phase ledger's open boundary (time.time_ns(), set by the
        # engine thread)
        self._t_phase = 0

        # stats (mutated on the engine thread; read under _cond)
        self._steps = 0
        self._prefill_chunks = 0
        self._completed = 0
        # disaggregated migration counters
        self._kv_exports = 0
        self._kv_imports = 0
        self._kv_blocks_out = 0
        self._kv_blocks_in = 0
        # blocks a deduplicated migration attached locally instead of
        # receiving, and prefix blocks grafted in by fleet fetch-on-miss
        self._kv_blocks_deduped = 0
        self._kv_prefix_fetched = 0
        # chain-fingerprint index over the tree's resident chains (spill
        # entries carry their own): mutated only on the engine thread;
        # readers on other threads take GIL-atomic snapshots, and every
        # consumer re-verifies at use time
        self._tree_fps: dict[str, bool] = {}
        self._peak_active = 0
        self._prefix_hits = 0
        self._prefix_tokens_saved = 0
        self._cow_copies = 0
        self._spec_proposed = 0   # draft tokens offered to verify steps
        self._spec_accepted = 0   # draft tokens accepted by verify steps
        self._spec_steps = 0      # verify calls (per participating slot)
        self._spec_rr = 0         # round-robin over draft_k groups
        self._occupancy: deque[tuple[int, int]] = deque(maxlen=4096)

        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="lm-engine")
        self._thread.start()

    # ------------------------------------------------------------------ API

    def submit(self, ids, max_new_tokens: int, eos_id: Optional[int] = None,
               temperature: float = 0.0, top_k: Optional[int] = None,
               seed: int = 0, speculative: int = 0,
               timeout: Optional[float] = None,
               trace_ctx: Optional[tuple] = None) -> list[int]:
        """Batched generation (greedy at ``temperature == 0``, otherwise
        temperature/top-k sampling with the exclusive lane's exact draw
        schedule for ``seed``); ``speculative=draft_k`` (>= 2) verifies
        prompt-lookup draft chunks in the batched variable-width step —
        fixed-seed output token-identical to the exclusive lane's
        ``make_speculative_generate_fn``.  Returns emitted tokens,
        stopping at the first EOS inclusive.  Raises QueueFull under
        backpressure."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        # the capacity bound, surfaced BEFORE the request occupies queue
        # space (an over-capacity row would run past its table)
        self._validate_gen_args(ids, int(max_new_tokens),
                                float(temperature), top_k,
                                int(speculative))
        req = _Request(ids=ids, max_new_tokens=int(max_new_tokens),
                       eos_id=eos_id, temperature=float(temperature),
                       top_k=top_k, seed=int(seed),
                       speculative=int(speculative), trace_ctx=trace_ctx)
        req.t_submit = time.monotonic()
        if self._reqlog is not None:
            req.rid = self._reqlog.begin(
                int(ids.size), int(max_new_tokens),
                temperature=float(temperature), top_k=top_k,
                speculative=int(speculative),
                trace_id=trace_ctx[0] if trace_ctx else None)
        return self._enqueue_and_wait(req, timeout)

    def _validate_gen_args(self, ids, max_new_tokens: int,
                           temperature: float, top_k: Optional[int],
                           speculative: int = 0) -> None:
        if ids.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if top_k is not None and top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        if speculative:
            if speculative < 2:
                raise ValueError(
                    f"speculative draft_k must be >= 2, got {speculative}")
            if not self.paged:
                raise ValueError(
                    "batched speculative decoding needs the paged block "
                    "cache; windowed configs ride the exclusive lane "
                    "(models/server.py routes them there)")
            if ids.size < 2:
                raise ValueError(
                    "prompt-lookup drafting needs prompt_len >= 2")
            check_speculative_capacity(self.config, int(ids.size),
                                       int(max_new_tokens),
                                       int(speculative))
        _check_cache_capacity(self.config, int(ids.size),
                              int(max_new_tokens))

    def _check_disagg_ready(self) -> None:
        if not self.paged:
            raise ValueError(
                "disaggregated serving needs the paged block pool; "
                "windowed configs keep dense per-slot rows")
        if self._gather_fn is None or self._graft_fn is None:
            raise ValueError(
                "disaggregated serving tiers are single-host engines; "
                "a mesh placement has no local pool to export/import "
                "(compose disaggregation ACROSS gangs, not inside one)")

    def prefill_export(self, ids, max_new_tokens: int,
                       eos_id: Optional[int] = None,
                       temperature: float = 0.0,
                       top_k: Optional[int] = None, seed: int = 0,
                       speculative: int = 0,
                       timeout: Optional[float] = None,
                       trace_ctx: Optional[tuple] = None) -> dict:
        """Prefill-only mode: prefill the prompt through the normal slot
        path (prefix reuse, tree insert), emit the first token, then
        export the request's block chain to the host and retire: no
        decode slot is held past the prefill.

        Returns the migration manifest: ``ids``, ``first``, ``key`` (the
        slot generator's state, ``uint8``: the decode pod continues the
        exact draw schedule), ``blocks`` (flat ``{leaf path: [n_blocks,
        block_size, ...]}`` host arrays), ``n_blocks``, ``block_size``,
        ``done`` and ``tokens`` (``done`` when the generation finished at
        the first token: first-token EOS or ``max_new_tokens == 1``, and
        nothing migrates), and ``rid`` so the HTTP layer can bill the
        hop to the request's timeline.  Raises QueueFull under
        backpressure like :meth:`submit`."""
        self._check_disagg_ready()
        ids = np.asarray(ids, np.int64).reshape(-1)
        self._validate_gen_args(ids, int(max_new_tokens),
                                float(temperature), top_k,
                                int(speculative))
        req = _Request(ids=ids, max_new_tokens=int(max_new_tokens),
                       eos_id=eos_id, temperature=float(temperature),
                       top_k=top_k, seed=int(seed),
                       speculative=int(speculative), export=True,
                       trace_ctx=trace_ctx)
        req.t_submit = time.monotonic()
        if self._reqlog is not None:
            req.rid = self._reqlog.begin(
                int(ids.size), int(max_new_tokens),
                temperature=float(temperature), top_k=top_k,
                speculative=int(speculative), kind="prefill_export",
                trace_id=trace_ctx[0] if trace_ctx else None)
        return self._enqueue_and_wait(req, timeout)

    def _check_key(self, key, temperature: float) -> np.ndarray:
        """The migrated draw-schedule carry, checked before any device
        work: a ``uint8`` generator state must be one of this engine's
        device type (a CPU generator's state does not fit a CUDA
        generator, nor the reverse); any other key (the reference's
        threefry ``uint32[2]``) seats only a greedy request, which never
        draws."""
        key = np.asarray(key).reshape(-1)
        if key.dtype == np.uint8:
            want = torch.Generator(device=self.device).get_state().numel()
            if key.size != want:
                raise ValueError(
                    f"migrated generator state has {key.size} bytes; a "
                    f"{self.device.type} generator's has {want}: the "
                    "tiers must run on the same device type")
        elif temperature > 0:
            raise ValueError(
                f"a sampled request needs a generator state (uint8) to "
                f"continue its draws, got a {key.dtype} key")
        return key

    def submit_prefilled(self, ids, blocks: dict, *, first_token: int,
                         key, max_new_tokens: int,
                         eos_id: Optional[int] = None,
                         temperature: float = 0.0,
                         top_k: Optional[int] = None,
                         speculative: int = 0,
                         block_size: Optional[int] = None,
                         skip: int = 0,
                         timeout: Optional[float] = None,
                         trace_id: Optional[str] = None,
                         seated: Optional[Callable[[], None]] = None
                         ) -> list[int]:
        """Seat a request straight from an imported block chain (the
        decode half of disaggregated serving): graft the received blocks
        into fresh local pool blocks, insert the prompt's full-block runs
        into the local prefix tree, and join the batched decode lanes at
        position ``len(ids)`` with ``first_token`` as the last emitted
        token and the generator restored from ``key``: fixed-seed output
        is the local output (same pool bytes, same draws).

        ``blocks`` is the sender's flat ``{leaf path: [n_blocks,
        block_size, ...]}`` manifest; a structural mismatch (paths,
        shapes, an int8 pool fed other content, a generator state of
        another device type) refuses with ValueError before any device
        work, and a chain that cannot fit even after evicting every
        unpinned tree leaf refuses with :class:`PoolExhausted`.
        ``seated()`` fires on the engine thread the moment the request
        holds its slot.  Returns the emitted tokens, ``first_token``
        included.

        ``skip``: the sender omitted the chain's first ``skip`` full
        blocks after this engine's dedup answer promised it holds them
        (in the tree or the spill tier); ``blocks`` then carries only the
        shipped tail and the seat attaches the prefix by reference
        (promoting from the spill tier where needed).  A promise the tree
        can no longer keep refuses with :class:`DedupStale`."""
        self._check_disagg_ready()
        ids = np.asarray(ids, np.int64).reshape(-1)
        self._validate_gen_args(ids, int(max_new_tokens),
                                float(temperature), top_k,
                                int(speculative))
        key = self._check_key(key, float(temperature))
        bs = self.block_size if block_size is None else int(block_size)
        if bs != self.block_size:
            raise ValueError(
                f"imported block_size {bs} != engine block_size "
                f"{self.block_size}: disaggregated tiers must serve the "
                "same artifact with the same bucket set")
        n = math.ceil(int(ids.size) / self.block_size)
        skip = int(skip)
        if not 0 <= skip < n:
            raise ValueError(
                f"dedup skip {skip} out of range for a {n}-block chain")
        if skip > max(0, (int(ids.size) - 1) // self.block_size):
            raise ValueError(
                f"dedup skip {skip} covers the last prompt token's "
                "block — that block is never tree-shareable and must "
                "always ship")
        shipped = n - skip
        missing = set(self._pool_leaf_meta) - set(blocks)
        extra = set(blocks) - set(self._pool_leaf_meta)
        if missing or extra:
            raise ValueError(
                f"imported chain does not match the pool manifest "
                f"(missing {sorted(missing)[:4]}, extra "
                f"{sorted(extra)[:4]})")
        for path, arr in blocks.items():
            tail, dtype = self._pool_leaf_meta[path]
            want = (shipped, self.block_size) + tail
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"imported leaf {path} has shape {tuple(arr.shape)}"
                    f", expected {want}")
            if dtype == np.int8 and arr.dtype != np.int8:
                raise ValueError(
                    f"imported leaf {path} is "
                    f"{kvtier.dtype_name(arr.dtype)} but the pool stores "
                    "int8: quantized pools migrate their native leaves "
                    "bit-exact (no wire re-quantization)")
        # receive-side backpressure: refuse BEFORE queuing when the chain
        # cannot fit even after evicting every unpinned tree leaf (a
        # best-effort read: the seat-time allocation re-checks for real).
        # A deduplicated chain needs fresh blocks for its shipped tail
        # only.
        with self._cond:
            try:
                available = self._pool_alloc.free_blocks \
                    + self._evictable_blocks()
            # the tree mutates on the engine thread without this lock; a
            # torn walk must not refuse a seatable chain
            except RuntimeError:
                available = shipped
        if available < shipped:
            raise PoolExhausted(shipped, available)
        req = _Request(ids=ids, max_new_tokens=int(max_new_tokens),
                       eos_id=eos_id, temperature=float(temperature),
                       top_k=top_k, speculative=int(speculative),
                       manifest={"first": int(first_token), "key": key,
                                 "n_blocks": n, "skip": skip,
                                 "blocks": blocks},
                       seated_cb=seated)
        req.t_submit = time.monotonic()
        if self._reqlog is not None:
            req.rid = self._reqlog.begin(
                int(ids.size), int(max_new_tokens),
                temperature=float(temperature), top_k=top_k,
                speculative=int(speculative), kind="migrated",
                trace_id=trace_id)
        return self._enqueue_and_wait(req, timeout)

    def prefix_index(self, limit: int = 128) -> list[str]:
        """Chain fingerprints this engine can serve by reference (tree
        chains) or re-promote (spill entries), most recent first, at most
        ``limit``: what the fleet prefix index advertises.  Advisory: the
        dedup seat and the fetch re-verify at use time."""
        # read off the engine thread: single C-level snapshots of maps
        # mutated only on the engine thread
        fps: list[str] = []
        if self.paged and self._tree is not None:
            fps.extend(reversed(list(self._tree_fps)))
        if self._spill is not None:
            fps.extend(reversed(self._spill.fingerprints()))
        seen: set[str] = set()
        out: list[str] = []
        for fp in fps:
            if fp not in seen:
                seen.add(fp)
                out.append(fp)
                if len(out) >= limit:
                    break
        return out

    def dedup_have(self, fps: list) -> int:
        """Longest leading run of offered chain fingerprints held in the
        tree or the spill tier: the receiver's half of the kvxfer dedup
        handshake.  Advisory: the seat re-verifies and refuses with
        :class:`DedupStale` if eviction broke the promise."""
        spill = self._spill
        have = 0
        for fp in fps:
            if fp in self._tree_fps or (spill is not None and fp in spill):
                have += 1
            else:
                break
        return have

    def fetch_prefix(self, ids, timeout: Optional[float] = None
                     ) -> Optional[dict]:
        """Holder side of fleet fetch-on-miss: the longest cached
        full-block prefix of ``ids`` (the tree's chain, extended straight
        from spill payloads without touching the pool) as a wire-ready
        manifest ``{"n_blocks", "block_size", "blocks": {leaf path: [n,
        block_size, ...]}}``, or None when nothing is cached.  Runs on
        the engine thread (:meth:`submit_exclusive`), where the pool is
        written.  The last prompt token's block is never served: it is
        never tree-shareable on the importer either."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if not self.paged or self._tree is None:
            return None
        cap = (int(ids.size) - 1) // self.block_size
        if cap < 1:
            return None

        def _do() -> Optional[dict]:
            bs = self.block_size
            full, _ = self._tree.match(ids, cap * bs)
            n = len(full)
            gathered: dict = {}
            if n:
                gathered = self._gather_fn(self._pool,
                                           [nd.block for nd in full])
            extra: list[dict] = []
            if self._spill is not None and n < cap:
                fps = kvtier.chain_fingerprints(ids, bs, max_blocks=cap)
                for k in range(n, cap):
                    e = self._spill.peek(fps[k])
                    if e is None:
                        break
                    extra.append(kvtier.decode_payload(e.payload))
            total = n + len(extra)
            if total == 0:
                return None
            out: dict[str, np.ndarray] = {}
            for path, (_tail, dtype) in self._pool_leaf_meta.items():
                parts = [gathered[path]] if n else []
                parts += [np.asarray(dec[path])[None] for dec in extra]
                arr = np.concatenate(parts, 0) if len(parts) > 1 \
                    else parts[0]
                # fp pools' spill payloads decode to f32; int8 and bf16
                # stay as stored: cast so the manifest matches the pool
                out[path] = np.ascontiguousarray(
                    arr.astype(dtype, copy=False))
            return {"n_blocks": total, "block_size": bs, "blocks": out}

        return self.submit_exclusive(_do, timeout=timeout)

    def import_prefix(self, ids, blocks: dict, n_blocks: int,
                      timeout: Optional[float] = None) -> int:
        """Requester side of fleet fetch-on-miss: graft a fetched chain
        prefix into fresh pool blocks and insert its runs into the tree,
        so the generation submitted right after attaches it like any
        local prefix hit.  Best-effort: any shortfall (local coverage
        grew, pool pressure) imports less or nothing and the request
        re-prefills; a structural mismatch raises ValueError.  Returns
        the blocks adopted."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        n_blocks = int(n_blocks)
        if not self.paged or self._tree is None or n_blocks < 1:
            return 0
        for path, arr in blocks.items():
            meta = self._pool_leaf_meta.get(path)
            if meta is None:
                raise ValueError(f"fetched leaf {path} not in pool")
            tail, _dtype = meta
            want = (n_blocks, self.block_size) + tail
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"fetched leaf {path} has shape {tuple(arr.shape)}"
                    f", expected {want}")
        if set(blocks) != set(self._pool_leaf_meta):
            raise ValueError("fetched chain does not match the pool "
                             "manifest")

        def _do() -> int:
            bs = self.block_size
            cap = min(n_blocks, (int(ids.size) - 1) // bs)
            if cap < 1:
                return 0
            full, _ = self._tree.match(ids, cap * bs)
            start = len(full)
            if start >= cap:
                return 0  # already covered locally
            dsts: list[int] = []
            try:
                for _ in range(cap - start):
                    dsts.append(self._alloc_block(None))
            # pool pressure during an opportunistic import falls back to
            # re-prefilling, never fails anything
            except RuntimeError:
                for b in dsts:
                    self._pool_alloc.release(b)
                return 0
            # the allocations may have evicted part of the matched path;
            # re-match so the insert path is attached
            full2, _ = self._tree.match(ids, cap * bs)
            if len(full2) != start:
                for b in dsts:
                    self._pool_alloc.release(b)
                return 0
            self._graft_fn(self._pool,
                           {p: a[start:cap] for p, a in blocks.items()},
                           dsts)
            created = self._tree.insert(
                full2, [int(t) for t in ids[:cap * bs]],
                [0] * start + dsts)
            # a fresh block's refcount 1 becomes the tree's reference;
            # release any block the insert did not adopt
            adopted = {node.block for node in created}
            for b in dsts:
                if b not in adopted:
                    self._pool_alloc.release(b)
            self._index_add(created)
            self._update_block_gauge()
            with self._cond:
                self._kv_prefix_fetched += len(created)
            return len(created)

        return self.submit_exclusive(_do, timeout=timeout)

    def _evictable_blocks(self) -> int:
        """Tree blocks eviction could eventually free for an import
        (caller holds ``_cond`` or accepts a best-effort read).  Freeing
        a leaf exposes its parent, so a whole unpinned chain is evictable
        bottom-up: a node counts iff nothing else pins it and its whole
        subtree is unpinned."""
        if self._tree is None:
            return 0
        count = 0

        def walk(node) -> bool:
            nonlocal count
            subtree_ok = True
            for child in node.children.values():
                if not walk(child):
                    subtree_ok = False
            if not subtree_ok \
                    or self._pool_alloc.refcount(node.block) != 1:
                return False
            count += 1
            return True

        for child in self._tree.root.children.values():
            walk(child)
        return count

    def submit_exclusive(self, fn: Callable[[], Any],
                         timeout: Optional[float] = None,
                         trace_ctx: Optional[tuple] = None):
        """Run ``fn`` single-flight on the engine thread between batch
        iterations; FIFO with batched admissions through the same
        bounded queue."""
        req = _Request(fn=fn, trace_ctx=trace_ctx)
        req.t_submit = time.monotonic()
        if self._reqlog is not None:
            req.rid = self._reqlog.begin(
                None, 0, kind="exclusive",
                trace_id=trace_ctx[0] if trace_ctx else None)
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
    def disagg_capable(self) -> bool:
        """True when this engine can export and import KV block chains
        (the paged pool): what the server gates the kv-transfer plane
        on."""
        return self.paged and self._gather_fn is not None

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
                # speculative lane: drafting efficiency for /healthz
                "spec_proposed": self._spec_proposed,
                "spec_accepted": self._spec_accepted,
                "spec_steps": self._spec_steps,
                "spec_mean_accepted": round(
                    self._spec_accepted / self._spec_steps, 3)
                if self._spec_steps else 0.0,
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
                # disaggregated migration: chains exported to decode
                # pods, imported chains seated
                "kv_exports": self._kv_exports,
                "kv_imports": self._kv_imports,
                "kv_blocks_out": self._kv_blocks_out,
                "kv_blocks_in": self._kv_blocks_in,
                # tiered KV memory: the host spill tier's occupancy and
                # demote/promote lifetimes, dedup attaches and fleet
                # fetch-on-miss imports
                "spill_enabled": self._spill is not None,
                "spill_blocks": len(self._spill) if self._spill else 0,
                "spill_bytes": self._spill.bytes_used
                if self._spill else 0,
                "spill_demotions": self._spill.spilled_blocks
                if self._spill else 0,
                "spill_promotions": self._spill.promoted_blocks
                if self._spill else 0,
                "spill_evictions": self._spill.spill_evictions
                if self._spill else 0,
                "kv_blocks_deduped": self._kv_blocks_deduped,
                "kv_prefix_fetched": self._kv_prefix_fetched,
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
        evictions land on ITS timeline (the ``evict`` phase).  With the
        spill tier on, each victim's content demotes to host memory
        BEFORE its pool reference drops: its bytes survive for
        re-promotion."""
        idx = self._pool_alloc.alloc()
        if idx is not None:
            return idx
        t0 = time.monotonic()
        evicted = 0
        spilled = 0
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
            spilled += self._demote_leaf(victim)
            released = self._pool_alloc.release(victim.block)
            if not released:
                raise RuntimeError("unpinned tree leaf must free its block")
            evicted += 1
            idx = self._pool_alloc.alloc()
        if self._reqlog is not None and slot is not None \
                and slot.req is not None:
            dur = time.monotonic() - t0
            self._reqlog.evicted(slot.req.rid, evicted, dur)
            if spilled:
                # the demote cost rides inside the evict window; the
                # spill event carries the same wall span
                self._reqlog.spilled(slot.req.rid, spilled, dur)
        return idx

    def _demote_leaf(self, node) -> int:
        """Demote one evicted tree leaf to the host spill tier: gather its
        block through the export seam (a copy on the host: the payload
        never aliases a pool block), quantize float K/V leaves through
        the one ``quantize_kv``, and park it under the leaf's cumulative
        chain fingerprint.  Returns 1 when a payload is resident
        afterwards.  Runs BEFORE the tree's pool reference is released:
        the gather reads the victim block.  The device-to-host copy
        synchronizes the stream: every slot waits on it, as on the
        reference's engine thread."""
        fp = self._node_fp_of(node)
        self._tree_fps.pop(fp, None)
        spill = self._spill
        if spill is None:
            return 0
        if spill.touch(fp):
            # a chain's content is immutable once inserted: the resident
            # host copy is already exact
            return 1
        flat = self._gather_fn(self._pool, [node.block])
        flat = {p: a[0] for p, a in flat.items()}
        payload, nbytes = kvtier.encode_payload(flat, _quantize_host)
        ok = spill.put(fp, node.tokens, payload, nbytes)
        self._update_spill_gauges()
        return 1 if ok else 0

    def _promote_spill(self, slot: Optional[_Slot], ids,
                       max_tokens: int) -> int:
        """Re-promote consecutive spilled chain blocks extending the
        tree's coverage of ``ids`` (at most ``max_tokens`` tokens) into
        the pool: fresh blocks, one graft (the seam migration seats
        ride), tree re-insert, so the caller's tree walk sees an ordinary
        prefix hit.  Returns the blocks promoted; 0 whenever the tier is
        off or cold, or pool pressure says re-prefilling is the better
        deal."""
        spill = self._spill
        if spill is None or len(spill) == 0 or self._tree is None:
            return 0
        bs = self.block_size
        cap = max(0, int(max_tokens)) // bs
        if cap < 1:
            return 0
        fps = kvtier.chain_fingerprints(ids, bs, max_blocks=cap)
        full, _ = self._tree.match(ids, cap * bs)
        entries: list[tuple[str, kvtier.SpillEntry]] = []
        for k in range(len(full), len(fps)):
            e = spill.peek(fps[k])
            if e is None:
                break
            entries.append((fps[k], e))
        if not entries:
            return 0
        t0 = time.monotonic()
        dsts: list[int] = []
        try:
            for _ in entries:
                # may demote OTHER leaves to make room; the entries held
                # above stay valid even if the spill LRU drops them
                dsts.append(self._alloc_block(slot))
        # allocation pressure during a promote (nothing left to evict)
        # falls back to re-prefilling the tail, never fails the request
        except RuntimeError:
            for b in dsts:
                self._pool_alloc.release(b)
            return 0
        # the allocations may have evicted part of the matched path;
        # re-match so the insert path is attached
        full2, _ = self._tree.match(ids, cap * bs)
        if len(full2) != len(full):
            for b in dsts:
                self._pool_alloc.release(b)
            return 0
        flat: dict[str, list] = {}
        for fp, e in entries:
            dec = kvtier.decode_payload(e.payload)
            spill.get(fp)  # LRU refresh and promote accounting
            for p, a in dec.items():
                flat.setdefault(p, []).append(a)
        self._graft_fn(self._pool,
                       {p: np.stack(parts) for p, parts in flat.items()},
                       dsts)
        n_tok = (len(full2) + len(entries)) * bs
        created = self._tree.insert(
            full2, [int(t) for t in ids[:n_tok]],
            [0] * len(full2) + dsts)
        # a fresh block's refcount 1 becomes the tree's reference;
        # release any block the insert did not adopt
        adopted = {node.block for node in created}
        for b in dsts:
            if b not in adopted:
                self._pool_alloc.release(b)
        self._index_add(created)
        self._update_block_gauge()
        self._update_spill_gauges()
        promos = self.metrics.get("kv_promotions")
        if promos is not None:
            promos.inc(len(created))
        if self._reqlog is not None and slot is not None \
                and slot.req is not None:
            self._reqlog.promoted(slot.req.rid, len(created),
                                  time.monotonic() - t0)
        return len(created)

    def _node_fp_of(self, node) -> str:
        """A tree node's cumulative chain fingerprint (its whole
        root-to-node token chain, hashed with the router's scheme)."""
        return kvtier.chain_fingerprints(
            chain_tokens(node), self.block_size)[-1]

    def _index_add(self, created) -> None:
        """Register freshly inserted tree nodes in the chain-fingerprint
        index (engine thread only)."""
        for node in created:
            self._tree_fps[self._node_fp_of(node)] = True

    def _update_spill_gauges(self) -> None:
        if self._spill is None:
            return
        g = self.metrics.get("kv_spilled_blocks")
        if g is not None:
            g.set(len(self._spill))
        g = self.metrics.get("kv_spill_bytes")
        if g is not None:
            g.set(self._spill.bytes_used)

    def _release_table(self, slot: _Slot) -> None:
        for b in slot.table[:slot.nblocks]:
            self._pool_alloc.release(int(b))
        slot.table[:] = 0
        slot.nblocks = 0
        self._tables_dirty = True
        self._update_block_gauge()

    def _grow_tables(self, writes: list) -> None:
        """For each ``(slot, n)``, grow the slot's table so the writes of
        its next ``n`` positions land in owned blocks."""
        grew = False
        for s, n in writes:
            need_bi = (s.pos + n - 1) // self.block_size
            while s.nblocks <= need_bi:
                s.table[s.nblocks] = self._alloc_block(s)
                s.nblocks += 1
                grew = True
        if grew:
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

    def _phase(self, phase: str, now: Optional[int] = None,
               **fields) -> int:
        """Close the engine thread's open phase into the recorder's phase
        ledger at ``now`` (a ``time.time_ns()`` reading the caller took
        for its own use, else one taken here) and open the next phase
        there; returns ``now``.  Call sites guard on ``self._reqlog``."""
        if now is None:
            now = time.time_ns()
        self._reqlog.engine_phase(phase, self._t_phase, now - self._t_phase,
                                  **fields)
        self._t_phase = now
        return now

    def _loop(self) -> None:
        rlog = self._reqlog
        self._t_phase = time.time_ns()
        try:
            while True:
                with self._cond:
                    waited = False
                    while (not self._closed and not self._queue
                           and not any(s.ready for s in self._slots)):
                        self._cond.wait()
                        waited = True
                    if self._closed:
                        self._drain_locked()
                        return
                    if waited and rlog is not None:
                        self._phase("wait")
                    actions = self._admit_locked()
                for req, slot in actions:
                    if req.fn is not None:
                        self._run_exclusive(req)
                        if rlog is not None:
                            self._phase("exclusive", rid=req.rid)
                        continue
                    if req.manifest is not None:
                        # a migrated seat: a graft, no model call, so it
                        # does not convoy the decode-ready slots
                        self._seat_prefilled(slot, req)
                        if rlog is not None:
                            self._phase("admit", rid=req.rid)
                        continue
                    # prefill convoy: decode-ready slots stalled behind
                    # this admission's prefill — the stall bills to each
                    # VICTIM's prefill phase
                    waiting = [s.req.rid for s in self._slots
                               if s.ready and s.req is not None]
                    t0 = self._t_phase
                    self._prefill_into(slot, req)
                    if rlog is not None:
                        # the seat after the read
                        now = self._phase("admit", rid=req.rid)
                    if waiting:
                        conv = self.metrics.get("prefill_convoy")
                        if conv is not None:
                            conv.inc()
                        if rlog is not None:
                            for rid in waiting:
                                rlog.convoy(rid, (now - t0) / 1e9)
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
            # parented under the ingress's inbound traceparent: the
            # exclusive lane runs on the engine thread, so the contextvar
            # chain from the handler thread does not reach here, the
            # explicit remote context does
            with trace.span_under(req.trace_ctx, "exclusive_generate"):
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
        # spilled chains re-promote BEFORE the walk: a demoted prefix
        # grafts back into fresh blocks and the match below sees an
        # ordinary tree hit
        self._promote_spill(slot, ids, len(ids) - 1)
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
        ``call(c, chunk, positions)``; returns the last call's logits.
        With the recorder on, the admission's phase closes here and the
        chunks' issue is the ``prefill_issue`` phase, each chunk's share
        of it its ``prefill_chunk`` event."""
        rlog = self._reqlog
        if rlog is not None:
            tc0 = self._phase("admit", rid=req.rid)
        ids, off, last = req.ids, start, None
        for c in split_prefill(len(ids) - start, self.buckets):
            chunk = ids[off:off + c][None, :]
            positions = (off + np.arange(c, dtype=np.int64))[None, :]
            last = call(c, chunk, positions)
            if rlog is not None:
                now = time.time_ns()
                rlog.prefill_chunk(req.rid, c, (now - tc0) / 1e9, False)
                tc0 = now
            off += c
        if rlog is not None:
            self._phase("prefill_issue", tc0, rid=req.rid,
                        tokens=len(ids) - start)
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
                table = slot.table[:needed].copy()  # host plan data

                def call(c, chunk, positions):
                    # the table columns this chunk's positions reach
                    nb = -(-(int(positions[0, -1]) + 1) // self.block_size)
                    return self._prefill_fn(c)(self._pool, table[:nb],
                                               chunk, positions)
                span = {"shared": shared}
            else:
                row = self._init_cache_fn(1, self.device)

                def call(c, chunk, positions):
                    return self._prefill_fn(c)(row, chunk, positions)
                shared, span = 0, {}
            with trace.span_under(
                    req.trace_ctx, "prefill", prompt_len=len(ids),
                    chunks=len(split_prefill(len(ids) - shared,
                                             self.buckets)), **span):
                last = self._run_chunks(req, shared, call)
                first, slot.gen = self._first_token(req, last)
                if rlog is not None:
                    self._phase("prefill_read", rid=req.rid,
                                tokens=len(ids) - shared)
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
                self._index_add(created)
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
        if req.export:
            self._finish_export(slot, req, first)
            return
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
        if req.speculative:
            # host-side prompt-lookup drafting reads the full context
            slot.ctx = [int(t) for t in ids] + tokens
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

    def _finish_export(self, slot: _Slot, req: _Request,
                       first: int) -> None:
        """Close a prefill-export request: gather the block chain to the
        host, release the slot (no decode seat is held) and hand the
        migration manifest back to the HTTP layer.  A generation that
        finished at the first token skips the gather: nothing
        migrates."""
        hit_eos = req.eos_id is not None and first == req.eos_id
        done = hit_eos or req.max_new_tokens <= 1
        export = {
            "ids": req.ids,
            "first": int(first),
            # the draw-schedule carry: the slot generator's state
            "key": slot.gen.get_state().numpy(),
            "block_size": self.block_size,
            "done": done,
            "tokens": [int(first)],
            "rid": req.rid,
            "blocks": {},
            "n_blocks": 0,
        }
        if not done:
            export["blocks"] = self._export_blocks(slot)
            export["n_blocks"] = int(slot.nblocks)
        with self._cond:
            self._completed += 1
            self._kv_exports += 1
            self._kv_blocks_out += export["n_blocks"]
            self._release_table(slot)
            slot.clear()
        if done:
            tok_counter = self.metrics.get("tokens")
            if tok_counter is not None:
                tok_counter.inc(1)
            # nothing migrates: the timeline closes here like any local
            # retirement; otherwise it stays live so the HTTP layer can
            # bill the hop to the migrate phase before closing it
            if self._reqlog is not None:
                self._reqlog.retire(req.rid,
                                    "eos" if hit_eos else "max_tokens",
                                    tokens=1, ttft_s=req.ttft_s)
        req.finish(result=export)

    def _export_blocks(self, slot: _Slot) -> dict:
        """The slot's block chain as flat host arrays ``{leaf path:
        [n_blocks, block_size, ...]}`` in table order: one gather and
        one device-to-host copy per export."""
        return self._gather_fn(self._pool, slot.table[:slot.nblocks])

    def _seat_prefilled(self, slot: _Slot, req: _Request) -> None:
        """Seat a migrated request: graft the received blocks into
        freshly allocated local blocks (refcount 1: a graft never touches
        a block another slot or the tree shares), insert the prompt's
        runs into the local tree, and join the decode lanes at the
        migrated position with the generator restored from the carried
        state."""
        m = req.manifest
        rlog = self._reqlog
        t_adm = time.monotonic()
        qw = t_adm - req.t_submit if req.t_submit else 0.0
        qw_h = self.metrics.get("queue_wait")
        if qw_h is not None:
            qw_h.observe(qw)
        if rlog is not None:
            rlog.admitted(req.rid, slot.idx, qw)
        ids = req.ids
        n = int(m["n_blocks"])
        skip = int(m["skip"])
        try:
            if skip:
                # a deduplicated migration: the sender omitted the first
                # ``skip`` full blocks after our dedup answer promised
                # them; attach them by reference now, promoting from the
                # spill tier where they live.  A promise eviction broke
                # refuses with the typed ``dedup_stale``, and the sender
                # re-sends the full chain.
                if self._tree is None:
                    raise DedupStale(
                        "deduped migration on an engine without a "
                        "prefix tree")
                self._promote_spill(slot, ids, skip * self.block_size)
                full, _ = self._tree.match(ids, skip * self.block_size)
                if len(full) < skip:
                    raise DedupStale(
                        f"receiver holds {len(full)}/{skip} promised "
                        "prefix blocks (evicted since the offer)")
                for node in full:
                    self._pool_alloc.retain(node.block)
                    slot.table[slot.nblocks] = node.block
                    slot.nblocks += 1
            dsts = []
            for _ in range(n - skip):
                dsts.append(self._alloc_block(slot))
                slot.table[slot.nblocks] = dsts[-1]
                slot.nblocks += 1
            # one graft for the whole chain
            self._graft_fn(self._pool, m["blocks"], dsts)
            self._tables_dirty = True
            self._update_block_gauge()
            if self._tree is not None:
                # migrated prefixes are shareable at once: local requests
                # with the same template attach by reference
                created = self._tree.graft(
                    ids, [int(b) for b in slot.table[:slot.nblocks]])
                for node in created:
                    self._pool_alloc.retain(node.block)
                self._index_add(created)
            gen = torch.Generator(device=self.device)
            if m["key"].dtype == np.uint8:
                gen.set_state(torch.from_numpy(m["key"].copy()))
        except BaseException as e:  # noqa: BLE001 - bad import must not kill the loop
            req.finish(error=e)
            if rlog is not None:
                rlog.retire(req.rid, "error")
            with self._cond:
                self._release_table(slot)
                slot.clear()
            return
        graft_s = time.monotonic() - t_adm
        mig_c = self.metrics.get("kv_migrated")
        if mig_c is not None:
            mig_c.inc(n - skip)
        with self._cond:
            self._kv_imports += 1
            self._kv_blocks_in += n - skip
            self._kv_blocks_deduped += skip
        if rlog is not None:
            rlog.migrated(req.rid, n - skip, graft_s)
        if req.seated_cb is not None:
            try:
                req.seated_cb()
            # the seated ack is a transport seam (a dead kvxfer socket);
            # the seated request still decodes
            except Exception:
                log.exception("kvxfer seated callback failed")
        first = int(m["first"])
        slot.tokens = [first]
        slot.last = first
        slot.pos = int(ids.size)
        slot.gen = gen
        # the first token came from the prefill pod: stamp the seat time
        # so TPOT still computes, but do NOT observe the TTFT histogram
        req.ttft_s = time.monotonic() - req.t_submit \
            if req.t_submit else None
        if (req.eos_id is not None and first == req.eos_id) \
                or req.max_new_tokens <= 1:
            # the sender never migrates a finished generation, but a
            # direct caller must not seat one the decode loop would
            # over-emit for
            self._retire(slot, req, slot.tokens,
                         "eos" if req.eos_id is not None
                         and first == req.eos_id else "max_tokens")
            return
        if req.speculative:
            slot.ctx = [int(t) for t in ids] + [first]
        slot.ready = True
        with self._cond:
            self._peak_active = max(
                self._peak_active,
                sum(1 for s in self._slots if not s.free))

    def _decode_step_all(self) -> None:
        """One batched step over every ready slot: ``k`` iterations (a
        power of two up to MAX_STEP_TOKENS when no active row can retire
        mid-way, else 1) and one host read.  Inactive rows ride along at
        position -1: (paged) their writes are dropped before reaching the
        pool, or (dense) the model's write slot wraps to S-1 in a row the
        next join's scatter fully replaces.  Row independence of the
        batched math keeps active rows exact, except with MoE layers
        (``num_experts > 0``): expert capacity is per model call, so
        every row of the call competes for it, the inactive rows at
        ``pad_id`` included, exactly as in the reference's engine.

        Speculative slots divert the whole step into the variable-width
        path: all plain slots advance one token while every spec slot of
        the chosen ``draft_k`` group verifies its draft chunk in the
        same model call.  Groups with other ``draft_k`` values sit the
        step out (their generators only advance on actual verifies) and
        a round-robin pointer rotates the pick, so no group starves and
        each row's draws keep the exclusive lane's shapes."""
        B = len(self._slots)
        active = [s for s in self._slots if s.ready]
        spec_ks = sorted({s.req.speculative for s in active
                          if s.req.speculative})
        if spec_ks:
            pick = spec_ks[self._spec_rr % len(spec_ks)]
            self._spec_rr += 1
            self._spec_step(
                [s for s in active if s.req.speculative in (0, pick)],
                pick)
            return
        k = 1
        if self.paged and active:
            if all(s.req.eos_id is None for s in active):
                k = min(MAX_STEP_TOKENS,
                        min(s.req.max_new_tokens - len(s.tokens)
                            for s in active))
                while k & (k - 1):  # round down to a power of two
                    k &= k - 1
            self._grow_tables([(s, k) for s in active])
        rlog = self._reqlog
        if rlog is not None:
            seq = self._steps + k  # the step's ledger seq (this thread's)
            self._phase("admit", seq=seq, k=k)
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
        t_step = time.time_ns()
        if rlog is not None:
            self._phase("decode_plan", t_step, seq=seq, k=k)
        # the span closes after the step's one host read of its tokens
        # (inside _step_fn), so it measures the device work, not only the
        # host's issue of it
        with trace.span("decode_step", active=len(active), fused=k):
            if self.paged:
                if self._tables_dirty:
                    self._tables_dev = self._placement.put_tables(
                        np.stack([s.table for s in self._slots]))
                    self._tables_dirty = False
                # the table columns any row's positions reach this step
                width = max(-(-(s.pos + k) // self.block_size)
                            for s in active)
                toks_host = self._step_fn(self._pool,
                                          self._tables_dev[:, :width], ints,
                                          gens, temps, topks, k)  # [k, B]
            else:
                toks_host = self._step_fn(self._cache, ints, gens, temps,
                                          topks)  # [1, B]
        t_end = time.time_ns()
        step_dur = (t_end - t_step) / 1e9
        if rlog is not None:
            self._step_phases(t_end, seq, k)
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
        if rlog is not None:
            self._phase("retire", seq=seq, k=k)

    def _step_phases(self, t_end: int, seq: int, k: int) -> None:
        """Close a step's ``decode_issue`` where its body's host read
        began (``PagedCompute.read_ns``) and its ``decode_read`` at
        ``t_end``."""
        self._phase("decode_issue", self._compute.read_ns, seq=seq, k=k)
        self._phase("decode_read", t_end, seq=seq, k=k)

    def _spec_step(self, active: list, draft_k: int) -> None:
        """One write-masked variable-width batched step (chunk width
        W = ``draft_k``): every spec slot of the chosen group feeds its
        last token + W-1 host-proposed prompt-lookup drafts; every plain
        slot feeds just its last token with its padding lanes
        write-masked at position -1.  Emissions are truncated host-side
        at the first EOS / max_new_tokens exactly as the exclusive
        lane's loop truncates, so fixed-seed output matches it
        token-for-token; rejected drafts need no rollback — their pool
        writes sit above the row's written length, masked until the
        next chunk overwrites them (the write-then-mask contract)."""
        B = len(self._slots)
        W = draft_k
        # plain slots only write their next position
        self._grow_tables([(s, W if s.req.speculative else 1)
                           for s in active])
        rlog = self._reqlog
        if rlog is not None:
            # one model call: one iteration of the phase ledger's k
            seq = self._steps + 1
            self._phase("admit", seq=seq, k=1)
        chunk = np.full((B, W), self.pad_id, np.int64)
        ints = np.zeros((2, B), np.int64)  # [poss, widths]
        ints[0] = -1
        gens: list = [None] * B
        temps = [0.0] * B
        topks = [0] * B
        for s in active:
            chunk[s.idx, 0] = s.last
            if s.req.speculative:
                chunk[s.idx, 1:W] = lookup_draft_host(s.ctx, W)
                ints[1, s.idx] = W
            else:
                ints[1, s.idx] = 1
            ints[0, s.idx] = s.pos
            gens[s.idx] = s.gen
            temps[s.idx] = s.req.temperature
            topks[s.idx] = s.req.top_k or 0
        sampling = any(s.req.temperature > 0 for s in active)
        n_spec = sum(1 for s in active if s.req.speculative)
        step_key = (W, sampling, True)
        t_step = time.time_ns()
        if rlog is not None:
            self._phase("decode_plan", t_step, seq=seq, k=1)
        with trace.span("decode_step", active=len(active), fused=W,
                        spec=n_spec):
            if self._tables_dirty:
                self._tables_dev = self._placement.put_tables(
                    np.stack([s.table for s in self._slots]))
                self._tables_dirty = False
            # the table columns any row's chunk reaches
            width = max(-(-(s.pos + (W if s.req.speculative else 1))
                          // self.block_size) for s in active)
            # the verify's one host read of emissions and counts is inside
            emit_host, n_host = self._spec_fn(
                self._pool, self._tables_dev[:, :width], chunk, ints, gens,
                temps, topks, W)
        t_end = time.time_ns()
        step_dur = (t_end - t_step) / 1e9
        if rlog is not None:
            self._step_phases(t_end, seq, 1)
        sd_h = self.metrics.get("step_duration")
        if sd_h is not None:
            sd_h.observe(step_dur)
        self._step_ks = self._step_ks | {step_key}
        occ = self.metrics.get("occupancy")
        if occ is not None:
            occ.set(len(active))
        with self._cond:
            self._steps += 1
            self._occupancy.append((self._steps, len(active)))
            seq = self._steps
        if rlog is not None:
            emitted = sum(int(n_host[s.idx]) for s in active)
            rlog.engine_step(seq, len(active), W, W, emitted, step_dur)
        prop_c = self.metrics.get("spec_proposed")
        acc_c = self.metrics.get("spec_accepted")
        for s in active:
            req = s.req
            n = int(n_host[s.idx])
            toks = [int(t) for t in emit_host[s.idx, :n]]
            if req.speculative:
                with self._cond:
                    self._spec_steps += 1
                    self._spec_proposed += W - 1
                    self._spec_accepted += n - 1
                if prop_c is not None:
                    prop_c.inc(W - 1)
                if acc_c is not None:
                    acc_c.inc(n - 1)
            if rlog is not None:
                # a spec slot's verify chunk splits its wall time into
                # accepted (decode) and rejected (spec_reject) shares;
                # a plain rider records a width-1 decode participation
                rlog.step(req.rid, seq,
                          W if req.speculative else 1, n, step_dur,
                          spec=bool(req.speculative),
                          proposed=W - 1 if req.speculative else 0,
                          accepted=n - 1 if req.speculative else 0)
            out: list[int] = []
            done = False
            # truncate exactly as the exclusive lane's loop: at the
            # first emitted EOS inclusive, capped at max_new_tokens
            for t in toks[:req.max_new_tokens - len(s.tokens)]:
                out.append(t)
                if req.eos_id is not None and t == req.eos_id:
                    done = True
                    break
            s.tokens.extend(out)
            s.pos += len(out)
            s.last = out[-1]
            if s.ctx is not None:
                s.ctx.extend(out)
            if done or len(s.tokens) >= req.max_new_tokens:
                self._retire(s, req, s.tokens,
                             "eos" if done else "max_tokens")
        if rlog is not None:
            self._phase("retire", seq=seq, k=1)
