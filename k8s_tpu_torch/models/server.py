"""HTTP inference server over a serving artifact: port of
``k8s_tpu/models/server.py``.

    python -m k8s_tpu_torch.models.server --train_dir DIR --port 8000

Endpoints (JSON over HTTP/1.1, stdlib only):

- ``GET /healthz`` -> ``{"status": "ok", "model": {...}, "serving":
  {...}}``: readiness, with queue depth and slot occupancy.  Stays 200
  while the admission queue is shedding; 503 once the engine loop has
  crashed.
- ``GET /metrics`` -> Prometheus text exposition (serve_requests_total,
  serve_tokens_total, serve_queue_depth, serve_batch_occupancy,
  serve_rejected_total, serve_request_duration_seconds, the prefix-reuse
  counters and the TTFT/TPOT/queue-wait/step histograms).
- ``GET /debug/requests`` / ``GET /debug/engine`` -> per-request serving
  timelines and the engine step ledger (models/requestlog.py; 404 with an
  explicit body until ``K8S_TPU_REQUEST_LOG=1`` activates the recorder),
  and ``GET /debug``, the index of these endpoints.
- ``GET /debug/traces`` -> recent span trees (``serve_request``,
  ``prefill``, ``decode_step``, ``exclusive_generate``, ``kv_migrate``,
  ``kv_fetch``; k8s_tpu_torch.trace), 404 with an explicit body while
  tracing is off (``K8S_TPU_TRACE_SAMPLE`` unset or 0).  An inbound W3C
  ``traceparent`` on POST /v1/generate parents the server and engine
  spans, joining caller -> ingress -> engine into one trace.
  ``/debug/compiles`` answers 404 naming why it has no counterpart.
- ``POST /v1/generate`` with ``{"text": str | "tokens": [int], ...}`` ->
  ``{"text": str | "tokens": [int]}``.  Optional fields:
  ``max_new_tokens``, ``temperature``, ``top_k``, ``eos``, ``seed``,
  ``speculative`` (draft_k: prompt-lookup speculative decoding),
  ``kv_dest`` and ``kv_src`` (below).  Bad input answers 400 with
  ``{"error": ..., "field": ...}`` naming the field; a full admission
  queue answers 503 with a ``Retry-After`` header.

Device work goes through the continuous-batching engine
(models/engine.py): greedy, sampled and speculative requests share one
batched decode step over ``K8S_TPU_SERVE_SLOTS`` (default 4) slots with
iteration-level join/retire, a paged KV pool with shared-prefix reuse,
per-slot samplers and per-slot step widths (a speculative slot verifies
its draft chunk in the same call that advances its 1-token neighbours),
so fixed-seed output is the same on either lane.
``K8S_TPU_SERVE_BATCH_SAMPLING=0`` (or ``--batch-sampling 0``) routes
sampled requests to the engine's exclusive lane, which runs the
single-flight program (``decode.make_generate_fn``, whose prefill goes
through the flash-attention kernel when the config sets
``use_flash_attention``); ``K8S_TPU_SERVE_BATCH_SPEC=0`` (or
``--batch-spec 0``) does the same for speculative requests
(``decode.make_speculative_generate_fn``), which also ride the exclusive
lane on sliding-window configs and for one-token prompts.  ``--slots 0``
turns the engine off and restores the one-lock single-flight path.

Tiered KV memory and disaggregated serving, as in the reference:

- ``--spill-mb`` / ``K8S_TPU_SERVE_SPILL_MB`` (``LmServer(spill_mb=)``)
  gives the engine a host-RAM spill tier: evicted prefix blocks demote to
  host memory and promote back on the next hit (models/kvtier.py).
- ``--role prefill|decode`` / ``K8S_TPU_SERVE_ROLE`` makes the pod one
  tier of a disaggregated deployment.  A decode-capable pod runs a
  kv-transfer receiver (models/kvxfer.py; its port is
  ``serving.kvxfer_port`` in ``/healthz``); a request carrying
  ``kv_dest: "host:port"`` is prefilled here, its block chain shipped to
  that receiver (deduplicated against the blocks the receiver already
  holds unless ``--kvxfer-dedup 0``; int8 on the wire for fp pools with
  ``--kvxfer-int8 1``) and decoded there, and the tokens come back
  through this pod.  A bad ``kv_dest`` is a 400, a dead one a 502, and a
  receiver out of pool blocks or queue room a 503 with ``Retry-After``.
  A request carrying ``kv_src: "host:port"`` first fetches the prompt's
  cached prefix chain from that pod's receiver (best-effort) and then
  prefills only the rest.  ``serve_kv_prefix_cached{fp}`` advertises the
  chain fingerprints this pod holds.

What differs from the reference: the manifest carries the sampler
generator's state instead of a threefry key (models/engine.py).  The hop
is a ``kv_migrate`` span in the request's trace and carries its
``trace_id`` on the wire, as the reference's does.

Multi-process serving, as in the reference: with ``K8S_TPU_SERVE_MESH=N``
every pod of an N-replica serving gang runs THIS binary.  The launcher
env contract brings up ``torch.distributed`` (launcher/bootstrap.py),
every process loads the same artifact, replica 0 serves HTTP as the chief
over a ``mesh_serve.MeshPlacement`` (params split Megatron-style over
the N processes, the KV pool split by kv head, the plan bus
on ``K8S_TPU_SERVE_PLAN_PORT``), and the other replicas replay the
chief's per-step plan (``mesh_serve.follower_loop``), exiting non-zero if
the chief dies so the gang restarts whole.  One deliberate difference: at
tp > 1 the chief holds only a shard, so the exclusive lane, which runs
the whole model on one device, cannot run there; ``LmServer`` refuses
``slots=0``, ``batch_sampling=False`` and ``batch_spec=False`` under such
a placement at construction, and a speculative request with a one-token
prompt gets the batched lane's 400.  At tp 1 every lane runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from k8s_tpu_torch import trace
from k8s_tpu_torch.models import decode as decode_lib
from k8s_tpu_torch.models import engine as engine_lib
from k8s_tpu_torch.models import kvtier
from k8s_tpu_torch.models import kvxfer as kvxfer_lib
from k8s_tpu_torch.models import requestlog, serving
from k8s_tpu_torch.models.paged import quantize_kv
from k8s_tpu_torch.models.placement import host_tensor
from k8s_tpu_torch.models.dataset import decode_bytes, encode_bytes
from k8s_tpu_torch.models.transformer import Transformer
from k8s_tpu_torch.ops._common import resolve_device
from k8s_tpu_torch.util import metrics as metrics_mod

log = logging.getLogger(__name__)


class RequestError(ValueError):
    """400-class input error carrying the offending field name."""

    def __init__(self, field: str, msg: str):
        super().__init__(msg)
        self.field = field


@dataclasses.dataclass
class ParsedRequest:
    """A fully validated /v1/generate request, produced on the HTTP
    handler thread so no parsing or validation runs under the device
    lock."""

    ids: np.ndarray                    # [Lp] int32
    echo_text: Optional[str]           # original text, or None for tokens
    max_new_tokens: int
    temperature: float
    top_k: Optional[int]
    eos: Optional[int]
    seed: int
    speculative: int                   # draft_k; 0 = off
    # disaggregated serving: the decode pod's kv-transfer address
    # (host:port) for a phase-split request; None = serve here
    kv_dest: Optional[str] = None
    # fleet prefix fetch-on-miss: the kv-transfer address of a pod that
    # caches this prompt's prefix chain; best-effort, None = no holder
    kv_src: Optional[str] = None


def parse_request(config, req: dict, default_max_new_tokens: int
                  ) -> ParsedRequest:
    """Validate one request dict against the model config; raises
    :class:`RequestError` naming the offending field."""
    has_text = isinstance(req.get("text"), str)
    has_tokens = isinstance(req.get("tokens"), list)
    if has_text == has_tokens:
        raise RequestError("text", 'give exactly one of "text" or "tokens"')
    field = "text" if has_text else "tokens"
    if has_text:
        ids = encode_bytes(req["text"]).astype(np.int32)
    else:
        try:
            ids = np.asarray([int(t) for t in req["tokens"]], np.int32)
        except (TypeError, ValueError):
            raise RequestError("tokens", '"tokens" must be a list of ints')
    if ids.size < 1:
        raise RequestError(field, "empty prompt")
    if ids.min(initial=0) < 0 or ids.max(initial=0) >= config.vocab_size:
        raise RequestError(
            field, f"token ids outside [0, {config.vocab_size})")

    def opt(key, default, cast):
        # JSON null means "not set"; a non-castable value is the client's
        # error -> 400
        val = req.get(key)
        if val is None:
            return default
        try:
            return cast(val)
        except (TypeError, ValueError):
            raise RequestError(key, f"bad {key!r}: {val!r}")

    max_new = opt("max_new_tokens", default_max_new_tokens, int)
    if not 1 <= max_new <= config.max_seq_len:
        raise RequestError(
            "max_new_tokens",
            f"max_new_tokens must be in [1, {config.max_seq_len}]")
    try:
        decode_lib._check_cache_capacity(config, int(ids.size), max_new)
    except ValueError as e:
        raise RequestError("max_new_tokens", str(e))
    temperature = opt("temperature", 0.0, float)
    if temperature < 0.0:
        raise RequestError("temperature", "temperature must be >= 0")
    top_k = opt("top_k", 0, int) or None
    if top_k is not None and top_k < 1:
        raise RequestError("top_k",
                           "top_k must be >= 1 (omit or 0 disables)")
    eos: Optional[int] = opt("eos", None, int)
    seed = opt("seed", 0, int)
    spec = opt("speculative", 0, int)
    if spec != 0 and spec < 2:
        raise RequestError("speculative",
                           "speculative must be >= 2 (0 disables)")

    def kv_addr(key):
        val = req.get(key)
        if val is None:
            return None
        if not isinstance(val, str):
            raise RequestError(key, f'"{key}" must be a string')
        try:
            kvxfer_lib.parse_dest(val)
        except ValueError as e:
            raise RequestError(key, str(e))
        return val

    return ParsedRequest(
        ids=ids, echo_text=req["text"] if has_text else None,
        max_new_tokens=max_new, temperature=temperature, top_k=top_k,
        eos=eos, seed=seed, speculative=spec, kv_dest=kv_addr("kv_dest"),
        kv_src=kv_addr("kv_src"))


def _emitted(toks, eos) -> int:
    """Tokens actually emitted by a shape-static generation row: through
    the first EOS inclusive, excluding the frozen pad tail."""
    toks = list(toks)
    if eos is not None and eos in toks:
        return toks.index(eos) + 1
    return len(toks)


class LmServer:
    """Loads a serving artifact (or takes config + params directly) once
    onto ``device``; thread-safe generate() through the
    continuous-batching engine (``slots`` > 0, default
    ``K8S_TPU_SERVE_SLOTS`` or 4) or single-flight (``slots=0``).
    ``placement``: the engine's (None: the whole model on ``device``; a
    ``mesh_serve.MeshPlacement`` makes this server the chief of a
    tensor-parallel gang, on the placement's device)."""

    def __init__(self, train_dir: Optional[str] = None,
                 kv_cache: str = "model", param_dtype: str = "model",
                 default_max_new_tokens: int = 64, *, config=None,
                 params=None, slots: Optional[int] = None,
                 queue_limit: Optional[int] = None,
                 prefix_blocks: Optional[int] = None,
                 batch_sampling: Optional[bool] = None,
                 batch_spec: Optional[bool] = None, registry=None,
                 role: Optional[str] = None,
                 kvxfer_port: Optional[int] = None,
                 kvxfer_int8: Optional[bool] = None,
                 spill_mb: Optional[int] = None,
                 kvxfer_dedup: Optional[bool] = None, placement=None,
                 device="cuda"):
        self.device = placement.device if placement is not None \
            else resolve_device(device)
        if train_dir is not None:
            config, params = serving.load_for_serving(
                train_dir, kv_cache=kv_cache, param_dtype=param_dtype,
                device=self.device)
        elif config is None or params is None:
            raise ValueError("need train_dir or config+params")
        self.config = config
        self.default_max_new_tokens = default_max_new_tokens
        self.registry = registry or metrics_mod.Registry()
        self.metrics = metrics_mod.serving_metrics(self.registry)
        # the registry returns an existing gauge on a name collision:
        # rebind its callable to this server (latest wins)
        self.metrics["queue_depth"]._fn = self.queue_depth
        if slots is None:
            slots = engine_lib.env_slots()
        if batch_sampling is None:
            batch_sampling = engine_lib.env_batch_sampling()
        self.batch_sampling = bool(batch_sampling)
        if batch_spec is None:
            batch_spec = engine_lib.env_batch_spec()
        self.batch_spec = bool(batch_spec)
        # at tp > 1 the chief holds one shard: the exclusive lane (the
        # whole model on one device) cannot run, so nothing may route there
        self._sharded = placement is not None and placement.is_mesh \
            and placement.tp > 1
        if self._sharded and (slots == 0 or not self.batch_sampling
                              or not self.batch_spec):
            raise ValueError(
                f"tp {placement.tp} mesh serving runs every request on the "
                "batched lanes: the exclusive lane (slots=0, "
                "batch_sampling=False or batch_spec=False; --slots 0, "
                "--batch-sampling 0, --batch-spec 0) needs the whole model "
                "on one device, and the chief holds one shard")
        if slots > 0:
            self.engine: Optional[engine_lib.Engine] = engine_lib.Engine(
                config, params, slots=slots, queue_limit=queue_limit,
                prefix_blocks=prefix_blocks, metrics=self.metrics,
                spill_mb=spill_mb, placement=placement, device=self.device)
            # the exclusive lane runs on the engine's model
            self.model = self.engine.model
        else:
            # single-flight: one lock around all device work
            self.engine = None
            self.model = Transformer(config, params, device=self.device)
        self._lock = threading.Lock()
        # disaggregated tier membership: a prefill pod never seats
        # migrated requests; a decode pod always runs a kv-transfer
        # receiver (an ephemeral port unless one is given: read it back
        # from serving_info)
        self.role = kvxfer_lib.env_role() if role is None else role
        if self.role not in ("", kvxfer_lib.ROLE_PREFILL,
                             kvxfer_lib.ROLE_DECODE):
            raise ValueError(f"role must be prefill/decode/'' "
                             f"(got {self.role!r})")
        self.kvxfer_int8 = kvxfer_lib.env_kvxfer_int8() \
            if kvxfer_int8 is None else bool(kvxfer_int8)
        # migration dedup, on by default: a peer without it interoperates
        # through the legacy fallback either way
        self.kvxfer_dedup = kvxfer_lib.env_kvxfer_dedup() \
            if kvxfer_dedup is None else bool(kvxfer_dedup)
        if kvxfer_port is None:
            kvxfer_port = kvxfer_lib.env_kvxfer_port()
        self._kv_receiver = None
        self._kv_sender = None
        if self.engine is not None and self.engine.disagg_capable:
            if self.role != kvxfer_lib.ROLE_PREFILL and (
                    kvxfer_port is not None
                    or self.role == kvxfer_lib.ROLE_DECODE):
                self._kv_receiver = kvxfer_lib.KvReceiver(
                    self._seat_migrated, host="0.0.0.0",
                    port=kvxfer_port or 0,
                    index_fn=(self.engine.dedup_have
                              if self.kvxfer_dedup else None),
                    fetch_fn=self._serve_fetch)
            if self.role != kvxfer_lib.ROLE_DECODE:
                self._kv_sender = kvxfer_lib.KvSender()
        # fleet prefix index: the chain fingerprints this pod holds (tree
        # and spill tier), one labeled gauge sample each; rebound to this
        # server like queue_depth (the registry dedupes by name)
        proxy = self.registry.register(metrics_mod.ProxyMetric(
            "serve_kv_prefix_cached",
            "Chain fingerprints this pod can serve by reference or "
            "re-promote (radix tree + host spill tier), one labeled "
            "sample per fingerprint.", "gauge", None))
        proxy._sample_fn = self._sample_prefix_index
        self._prefix_index_proxy = proxy

    def _sample_prefix_index(self, name: str):
        """Exposition lines of the fleet prefix index family: one
        ``{fp="..."} 1`` sample per advertised chain fingerprint, none
        without a paged engine."""
        if self.engine is None or not self.engine.paged:
            return
        for fp in self.engine.prefix_index():
            yield f'{name}{{fp="{fp}"}} 1'

    def close(self) -> None:
        if self.metrics["queue_depth"]._fn == self.queue_depth:
            self.metrics["queue_depth"]._fn = None
        if self._prefix_index_proxy._sample_fn == self._sample_prefix_index:
            self._prefix_index_proxy._sample_fn = None
        if self._kv_receiver is not None:
            self._kv_receiver.stop()
        if self._kv_sender is not None:
            self._kv_sender.close()
        if self.engine is not None:
            self.engine.shutdown()

    def queue_depth(self) -> int:
        return self.engine.queue_depth() if self.engine is not None else 0

    def model_info(self) -> dict:
        c = self.config
        return {"layers": c.layers, "hidden": c.hidden,
                "vocab_size": c.vocab_size, "max_seq_len": c.max_seq_len,
                "kv_cache_dtype": c.kv_cache_dtype}

    def serving_info(self) -> dict:
        """Engine occupancy for /healthz (shedding is NOT unreadiness)."""
        if self.engine is None:
            return {"engine": "single-flight", "slots": 0, "queue_depth": 0,
                    "role": self.role, "device": str(self.device)}
        s = self.engine.stats()
        return {"engine": "continuous-batching", "slots": s["slots"],
                "placement": s["placement"],
                "num_processes": s["num_processes"],
                "mesh_shape": s["mesh_shape"],
                "tp_degree": s["tp_degree"],
                "active": s["active"], "queue_depth": s["queue_depth"],
                "queue_limit": s["queue_limit"],
                "batch_sampling": self.batch_sampling,
                "batch_spec": self.batch_spec,
                "paged": s["paged"], "block_size": s["block_size"],
                "pool_blocks": s["pool_blocks"],
                "blocks_in_use": s["blocks_in_use"],
                "prefix_hits": s["prefix_hits"],
                "prefix_tokens_saved": s["prefix_tokens_saved"],
                # speculative drafting efficiency: proposed / accepted
                # draft tokens and the mean accepted per verify step
                "spec_proposed": s["spec_proposed"],
                "spec_accepted": s["spec_accepted"],
                "spec_mean_accepted": s["spec_mean_accepted"],
                "request_log": s["request_log"],
                # disaggregated tier: role, the kv-transfer listener
                # (decode-capable pods) and the migration counters
                "role": self.role,
                "kvxfer_port": self._kv_receiver.port
                if self._kv_receiver is not None else None,
                "kvxfer_int8": self.kvxfer_int8,
                "kv_exports": s["kv_exports"],
                "kv_imports": s["kv_imports"],
                "kv_blocks_out": s["kv_blocks_out"],
                "kv_blocks_in": s["kv_blocks_in"],
                # tiered KV memory: spill tier occupancy, dedup savings
                # and fleet fetch imports
                "kvxfer_dedup": self.kvxfer_dedup,
                "spill_enabled": s["spill_enabled"],
                "spill_blocks": s["spill_blocks"],
                "spill_bytes": s["spill_bytes"],
                "spill_demotions": s["spill_demotions"],
                "spill_promotions": s["spill_promotions"],
                "spill_evictions": s["spill_evictions"],
                "kv_blocks_deduped": s["kv_blocks_deduped"],
                "kv_prefix_fetched": s["kv_prefix_fetched"],
                "device": str(self.device)}

    # -- disaggregated prefill/decode ----------------------------------

    def _wire_blocks(self, export: dict) -> tuple[dict, bool]:
        """The export manifest's block arrays as wire arrays: int8 and
        bf16 pools ship their native leaves bit-exact; fp pools optionally
        quantize k/v content for transit through the one ``quantize_kv``
        (``kvxfer_int8``: lossy, less wire).  Which leaves quantize is
        the spill tier's rule (``kvtier._is_kv_leaf``), the reference's
        test."""
        blocks = export["blocks"]
        if not self.kvxfer_int8:
            return ({f"blk/{p}": a for p, a in blocks.items()}, False)
        out: dict = {}
        quantized = False
        for path, arr in blocks.items():
            if kvtier._is_kv_leaf(path, arr.dtype):
                q, scale = quantize_kv(host_tensor(arr))
                out[f"blk/{path}"] = q.numpy()
                out[f"blkscale/{path}"] = scale.numpy()
                quantized = True
            else:
                out[f"blk/{path}"] = arr
        return out, quantized

    @staticmethod
    def _unwire_blocks(arrays: dict, wire_int8: bool) -> dict:
        """Receiver-side inverse of :meth:`_wire_blocks`: dequantize
        wire-int8 content to f32 (the graft casts to the pool dtype);
        bit-exact passthrough otherwise."""
        out: dict = {}
        for name, arr in arrays.items():
            if not name.startswith("blk/"):
                continue
            path = name[len("blk/"):]
            scale = arrays.get(f"blkscale/{path}")
            if wire_int8 and scale is not None:
                out[path] = (arr.astype(np.float32)
                             * scale[..., None].astype(np.float32))
            else:
                out[path] = arr
        return out

    def _serve_fetch(self, statics: dict, arrays: dict
                     ) -> Optional[tuple[dict, dict]]:
        """The receiver's fetch seam: serve a peer's fetch-on-miss from
        this pod's cached prefix chain (tree blocks + spill payloads),
        wire-encoded like a migration export; None = nothing cached (the
        peer re-prefills)."""
        if self.engine is None or not self.engine.paged:
            return None
        manifest = self.engine.fetch_prefix(
            np.asarray(arrays["ids"], np.int32))
        if manifest is None or not manifest["n_blocks"]:
            return None
        wire, quantized = self._wire_blocks(manifest)
        return ({"v": kvxfer_lib.PROTOCOL_VERSION,
                 "wire_int8": quantized,
                 "n_blocks": manifest["n_blocks"],
                 "block_size": manifest["block_size"]}, wire)

    def _fetch_on_miss(self, parsed: ParsedRequest,
                       trace_ctx: Optional[tuple]) -> int:
        """Requester side of fleet fetch-on-miss: pull the prompt's
        cached prefix chain from ``parsed.kv_src`` and graft it here, so
        the submit right after attaches it as a tree hit.  Best-effort:
        any shortfall or transport failure returns 0 and the request
        re-prefills."""
        engine = self.engine
        bs = engine.block_size
        fps = kvtier.chain_fingerprints(
            parsed.ids, bs, max_blocks=(int(parsed.ids.size) - 1) // bs)
        if not fps or engine.dedup_have(fps) >= len(fps):
            return 0  # nothing fetchable, or already cached here
        try:
            with trace.span_under(trace_ctx, "kv_fetch",
                                  src=parsed.kv_src):
                statics, arrays = self._kv_sender.fetch(
                    parsed.kv_src, {"v": kvxfer_lib.PROTOCOL_VERSION},
                    {"ids": np.asarray(parsed.ids, np.int32)})
            n = int(statics.get("n_blocks") or 0)
            if n <= 0:
                return 0
            blocks = self._unwire_blocks(arrays,
                                         bool(statics.get("wire_int8")))
            return engine.import_prefix(parsed.ids, blocks, n)
        except Exception as e:  # noqa: BLE001 - fetch is an optimization, never an error
            log.debug("kv fetch-on-miss from %s failed: %s",
                      parsed.kv_src, e)
            return 0

    def _seat_migrated(self, statics: dict, arrays: dict,
                       on_seated) -> list[int]:
        """The receiver's seam onto the engine: rebuild the flat block
        manifest from the wire and seat the request; typed refusals
        (PoolExhausted, QueueFull, ValueError, DedupStale) travel back to
        the sender as error frames."""
        req = statics.get("req") or {}
        blocks = self._unwire_blocks(arrays,
                                     bool(statics.get("wire_int8")))
        return self.engine.submit_prefilled(
            np.asarray(arrays["ids"], np.int32), blocks,
            skip=int(statics.get("skip") or 0),
            first_token=int(req["first"]),
            key=arrays["key"],
            max_new_tokens=int(req["max_new_tokens"]),
            eos_id=req.get("eos"),
            temperature=float(req.get("temperature") or 0.0),
            top_k=req.get("top_k"),
            speculative=int(req.get("speculative") or 0),
            block_size=req.get("block_size"),
            trace_id=statics.get("trace_id"),
            seated=on_seated)

    def _generate_disagg(self, parsed: ParsedRequest,
                         trace_ctx: Optional[tuple]) -> list[int]:
        """The phase-split path: prefill-only here (no decode slot held),
        stream the block chain to ``parsed.kv_dest``, and return the
        decode pod's tokens.  The transfer span joins the caller's trace;
        the request's timeline closes with the hop billed to its
        ``migrate`` phase."""
        export = self.engine.prefill_export(
            parsed.ids, parsed.max_new_tokens, eos_id=parsed.eos,
            temperature=parsed.temperature, top_k=parsed.top_k,
            seed=parsed.seed, speculative=parsed.speculative,
            trace_ctx=trace_ctx)
        if export["done"]:
            return export["tokens"]
        rid = export.get("rid")
        rlog = self.engine._reqlog
        try:
            wire, quantized = self._wire_blocks(export)
            wire["ids"] = np.asarray(export["ids"], np.int32)
            wire["key"] = export["key"]
            statics = {
                "v": kvxfer_lib.PROTOCOL_VERSION,
                "wire_int8": quantized,
                "trace_id": trace_ctx[0] if trace_ctx else None,
                "req": {
                    "first": export["first"],
                    "max_new_tokens": parsed.max_new_tokens,
                    "eos": parsed.eos,
                    "temperature": parsed.temperature,
                    "top_k": parsed.top_k,
                    "speculative": parsed.speculative,
                    "block_size": export["block_size"],
                },
            }
            # migration dedup: offer the chain's cumulative block
            # fingerprints, so the receiver claims the blocks it already
            # holds and the wire ships only the rest
            fps = None
            info: dict = {}
            if self.kvxfer_dedup:
                ids = export["ids"]
                # offer only blocks the receiver may skip: the last
                # prompt token's block is never tree-shareable
                fps = kvtier.chain_fingerprints(
                    ids, export["block_size"],
                    max_blocks=(len(ids) - 1) // export["block_size"])
            with trace.span_under(trace_ctx, "kv_migrate",
                                  dest=parsed.kv_dest,
                                  blocks=export["n_blocks"],
                                  wire_int8=quantized):
                tokens, seated_s = self._kv_sender.migrate(
                    parsed.kv_dest, statics, wire, fingerprints=fps,
                    info=info)
            skipped = int(info.get("skipped_blocks") or 0)
            if skipped:
                self.metrics["kvxfer_dedup_skipped"].inc(skipped)
            self.metrics["kv_migrate"].observe(seated_s)
            if rlog is not None:
                rlog.migrate_send(rid, export["n_blocks"] - skipped,
                                  seated_s, dest=parsed.kv_dest)
                rlog.retire(rid, "migrated", tokens=len(tokens))
            return tokens
        except BaseException:
            # the export timeline must not stay live on a failed hop
            if rlog is not None:
                rlog.retire(rid, "error")
            raise

    def generate(self, parsed: ParsedRequest,
                 trace_ctx: Optional[tuple] = None) -> dict:
        """One validated generation request.  May raise engine.QueueFull
        under backpressure.  ``trace_ctx`` is the ``(trace_id, span_id,
        sampled)`` context the HTTP ingress extracted from the inbound
        W3C ``traceparent`` (or minted for its own server span): the
        engine parents its prefill/exclusive spans under it across the
        thread hop, so one trace spans caller -> ingress -> engine.  Sampled requests ride the batch unless
        ``batch_sampling`` routes them to the exclusive lane; speculative
        requests ride it unless ``batch_spec`` routes them there, or the
        engine has no paged pool to write-mask (windowed configs), or the
        prompt is too short to draft from (the exclusive lane refuses
        that: the same 400 from one lane; a tp > 1 mesh sends it to the
        batched lane, whose 400 is the same).  Either routing emits the
        same tokens at a fixed seed."""
        spec_batched = (parsed.speculative > 0 and self.batch_spec
                        and self.engine is not None and self.engine.paged
                        and (parsed.ids.size >= 2 or self._sharded))
        use_batched = (parsed.speculative == 0 or spec_batched) and (
            parsed.temperature == 0.0 or self.batch_sampling)
        if parsed.kv_src and not parsed.kv_dest \
                and self._kv_sender is not None \
                and self.engine is not None and self.engine.paged:
            # fleet fetch-on-miss: a peer caches this prompt's prefix
            # chain; graft it here first so the prefill attaches it
            self._fetch_on_miss(parsed, trace_ctx)
        if parsed.kv_dest and self._kv_sender is not None \
                and self.engine is not None and self.engine.paged \
                and use_batched:
            # disaggregated phase split: prefill here, decode on the
            # kv_dest peer.  A kv_dest on a pod that cannot send (decode
            # role, windowed engine), or a request the lane-routing knobs
            # send to the exclusive lane (migration seats batched lanes
            # only), serves here instead
            toks = self._generate_disagg(parsed, trace_ctx)
        elif self.engine is not None and use_batched:
            toks = self.engine.submit(parsed.ids, parsed.max_new_tokens,
                                      eos_id=parsed.eos,
                                      temperature=parsed.temperature,
                                      top_k=parsed.top_k, seed=parsed.seed,
                                      speculative=parsed.speculative,
                                      trace_ctx=trace_ctx)
        elif self.engine is not None:
            toks = self.engine.submit_exclusive(
                lambda: self._generate_exclusive(parsed),
                trace_ctx=trace_ctx)
            self.metrics["tokens"].inc(_emitted(toks, parsed.eos))
        else:
            # the lock is held across the whole generation and the copy
            # of its tokens to the host: serialized device work is the
            # single-flight path's definition
            with self._lock:
                toks = self._generate_exclusive(parsed)
            self.metrics["tokens"].inc(_emitted(toks, parsed.eos))
        toks = serving.strip_after_eos(np.asarray(toks), parsed.eos)
        if parsed.echo_text is not None:
            return {"text": parsed.echo_text + decode_bytes(np.asarray(toks))}
        return {"tokens": [int(t) for t in toks]}

    def _generate_exclusive(self, parsed: ParsedRequest) -> np.ndarray:
        """Whole generation on the device (the single-flight program, or
        the speculative one for a ``speculative`` request); returns the
        host token row."""
        if parsed.speculative > 0:
            # temperature/top_k compose via rejection sampling: the
            # emitted tokens are distributed exactly as vanilla
            # temperature/top-k sampling
            fn = decode_lib.cached_speculative_fn(
                self.config, parsed.max_new_tokens,
                draft_k=parsed.speculative, eos_id=parsed.eos,
                temperature=parsed.temperature,
                top_k=parsed.top_k if parsed.temperature > 0 else None)
        else:
            fn = decode_lib._cached_generate_fn(
                self.config, parsed.max_new_tokens, parsed.temperature,
                parsed.top_k, parsed.eos, 0)
        gen = torch.Generator(device=self.device).manual_seed(parsed.seed)
        prompt = torch.as_tensor(parsed.ids, dtype=torch.long,
                                 device=self.device)[None, :]
        return fn(self.model, prompt, gen)[0].cpu().numpy()


_NOT_PORTED_DEBUG = {
    "/debug/compiles": "eager PyTorch compiles no programs, so the "
                       "reference's compile ledger has no counterpart",
}


def debug_index_response() -> tuple[int, str, str]:
    """The /debug index: each debug endpoint of this server with its
    active state, what activates it and its query parameters (the
    reference's shared index, for the endpoints a serving pod has)."""
    active = requestlog.active() is not None
    endpoints = [
        {"path": "/debug/traces",
         "subsystem": "span tracing (k8s_tpu_torch.trace)",
         "active": trace.enabled(),
         "activation": "K8S_TPU_TRACE_SAMPLE > 0",
         "params": ["job", "n"]},
        {"path": "/debug/requests",
         "subsystem": "request lifecycle recorder (models/requestlog.py)",
         "active": active, "activation": "K8S_TPU_REQUEST_LOG=1",
         "params": ["id", "slow", "phase", "n"]},
        {"path": "/debug/engine",
         "subsystem": "engine step ledger (models/requestlog.py)",
         "active": active, "activation": "K8S_TPU_REQUEST_LOG=1",
         "params": ["n"]},
    ] + [{"path": path, "subsystem": why, "active": False,
          "activation": "not ported", "params": []}
         for path, why in _NOT_PORTED_DEBUG.items()]
    return (200, json.dumps({"endpoints": endpoints}, indent=2) + "\n",
            "application/json")


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "k8s-tpu-torch-lm"
    # one TCP segment per response: buffer writes (flushed once per
    # request) and disable Nagle, avoiding a delayed-ACK stall on
    # keep-alive connections
    wbufsize = -1
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):
        log.debug("server: " + fmt, *args)

    def _send(self, code: int, obj: dict, headers: Optional[dict] = None
              ) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code: int, body: str, ctype: str) -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        path, _, query = self.path.partition("?")
        lm = self.server.lm
        if path == "/healthz":
            # busy (shedding) is still ready; a CRASHED engine is not —
            # 503 makes the kubelet recycle the pod instead of routing to
            # a process that fails every generate
            dead = lm.engine is not None and not lm.engine.healthy
            return self._send(503 if dead else 200,
                              {"status": "engine crashed" if dead else "ok",
                               "model": lm.model_info(),
                               "serving": lm.serving_info()})
        if path == "/metrics":
            try:
                body = lm.registry.expose()
            except Exception as e:  # noqa: BLE001 - broken collector
                log.exception("metrics scrape failed")
                return self._send_text(500, f"scrape failed: {e}\n",
                                       "text/plain")
            return self._send_text(
                200, body, "text/plain; version=0.0.4; charset=utf-8")
        if path == "/debug/traces":
            return self._send_text(
                *trace.debug_traces_response(trace.TRACER, query))
        if path == "/debug/requests":
            return self._send_text(
                *requestlog.debug_requests_response(query))
        if path == "/debug/engine":
            return self._send_text(*requestlog.debug_engine_response(query))
        if path in ("/debug", "/debug/"):
            return self._send_text(*debug_index_response())
        if path in _NOT_PORTED_DEBUG:
            return self._send(404, {"error": f"{path}: "
                                    f"{_NOT_PORTED_DEBUG[path]}"})
        return self._send(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        # always drain the declared body first: unread bytes on a
        # keep-alive connection would be parsed as the next request line
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            self.close_connection = True  # unknown body size: can't drain
            return self._send(400, {"error": "bad Content-Length"})
        raw = self.rfile.read(length) if length > 0 else b""
        if self.path != "/v1/generate":
            return self._send(404, {"error": f"unknown path {self.path}"})
        lm = self.server.lm
        m = lm.metrics
        try:
            req = json.loads(raw or b"{}")
            if not isinstance(req, dict):
                raise ValueError("request body must be a JSON object")
        except ValueError as e:
            m["requests"].labels("bad_request").inc()
            return self._send(400, {"error": f"bad request body: {e}"})
        try:
            parsed = parse_request(lm.config, req, lm.default_max_new_tokens)
        except RequestError as e:
            m["requests"].labels("bad_request").inc()
            return self._send(400, {"error": str(e), "field": e.field})
        # end-to-end trace join: the inbound W3C traceparent parents this
        # request's server span, and the engine's prefill/exclusive spans
        # parent under that across the thread hop: one trace per request
        # across processes.  With tracing off the recorder still keeps
        # the inbound trace id on the timeline, so the join survives.
        inbound = trace.parse_traceparent(self.headers.get("traceparent"))
        start = time.monotonic()
        try:
            with trace.span_under(inbound, "serve_request",
                                  prompt_len=int(parsed.ids.size),
                                  max_new=parsed.max_new_tokens) as sspan:
                ctx = trace.span_context(sspan) or inbound
                out = lm.generate(parsed, trace_ctx=ctx)
        except engine_lib.QueueFull as e:
            # backpressure: shed with an explicit retry hint; /healthz
            # stays 200 (serve_rejected_total is counted by the engine)
            m["requests"].labels("rejected").inc()
            return self._send(
                503, {"error": str(e)},
                headers={"Retry-After":
                         str(max(1, int(round(e.retry_after_s))))})
        except kvxfer_lib.KvTransferError as e:
            # receive-side backpressure (pool exhausted / queue full on
            # the decode peer) is a shed, not an error: the router's retry
            # walk re-places the request; anything else (dead peer,
            # protocol) is a 502-class failure the router walks past too
            if e.kind in ("pool_exhausted", "queue_full"):
                m["requests"].labels("rejected").inc()
                return self._send(503, {"error": str(e)},
                                  headers={"Retry-After": "1"})
            log.warning("kv migration failed: %s", e)
            m["requests"].labels("error").inc()
            return self._send(502, {"error": f"kv migration: {e}"})
        except ValueError as e:
            m["requests"].labels("bad_request").inc()
            return self._send(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 - surface, don't kill the worker
            log.exception("generate failed")
            m["requests"].labels("error").inc()
            return self._send(500, {"error": f"{type(e).__name__}: {e}"})
        m["requests"].labels("ok").inc()
        m["duration"].observe(time.monotonic() - start)
        return self._send(200, out)


def serve(lm: LmServer, host: str = "127.0.0.1", port: int = 0):
    """Returns a started ThreadingHTTPServer (caller owns shutdown())."""
    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.daemon_threads = True
    httpd.lm = lm  # type: ignore[attr-defined]
    t = threading.Thread(target=httpd.serve_forever,
                         kwargs={"poll_interval": 0.1}, daemon=True,
                         name="lm-server")
    t.start()
    return httpd


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train_dir", required=True)
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (default loopback; set 0.0.0.0 "
                   "explicitly for pod exposure)")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_new_tokens", type=int, default=64,
                   help="per-request default")
    p.add_argument("--kv_cache", choices=["model", "int8"], default="model")
    p.add_argument("--param_dtype", choices=["model", "bfloat16"],
                   default="model")
    p.add_argument("--slots", type=int, default=None,
                   help="continuous-batching decode slots (default "
                   "K8S_TPU_SERVE_SLOTS or 4; 0 = single-flight)")
    p.add_argument("--queue", type=int, default=None,
                   help="admission queue bound before 503 shedding "
                   "(default K8S_TPU_SERVE_QUEUE or 64)")
    p.add_argument("--prefix-blocks", type=int, default=None,
                   help="KV pool blocks retained for shared-prefix reuse "
                   "beyond the per-slot floor (default "
                   "K8S_TPU_SERVE_PREFIX_BLOCKS or auto; 0 disables "
                   "prefix reuse)")
    p.add_argument("--batch-sampling", type=int, choices=(0, 1),
                   default=None,
                   help="route temperature>0 requests onto the batched "
                   "slot lanes (default K8S_TPU_SERVE_BATCH_SAMPLING or "
                   "1; 0 = the exclusive lane)")
    p.add_argument("--batch-spec", type=int, choices=(0, 1),
                   default=None,
                   help="route speculative requests onto the batched "
                   "slot lanes (variable-width verify chunks; default "
                   "K8S_TPU_SERVE_BATCH_SPEC or 1; 0 = the exclusive "
                   "lane)")
    p.add_argument("--role", choices=("prefill", "decode"), default=None,
                   help="disaggregated tier membership (default "
                   "K8S_TPU_SERVE_ROLE; unset = collapsed single-role "
                   "pod serving both phases)")
    p.add_argument("--kvxfer-port", type=int, default=None,
                   help="KV block-transfer listener port on decode-"
                   "capable pods (default K8S_TPU_KVXFER_PORT; 0 = "
                   "ephemeral; decode-role pods always listen)")
    p.add_argument("--kvxfer-int8", type=int, choices=(0, 1),
                   default=None,
                   help="quantize fp-pool KV content to int8 for "
                   "transit (default K8S_TPU_KVXFER_INT8 or 0; lossy "
                   "on fp pools, no-op on int8 pools)")
    p.add_argument("--spill-mb", type=int, default=None,
                   help="host-RAM KV spill tier budget in MiB: evicted "
                   "prefix-tree leaves demote to quantized host buffers "
                   "and re-promote on the next hit instead of "
                   "re-prefilling (default K8S_TPU_SERVE_SPILL_MB or 0 "
                   "= off)")
    p.add_argument("--kvxfer-dedup", type=int, choices=(0, 1),
                   default=None,
                   help="fingerprint-dedup the kv migration wire: skip "
                   "blocks the receiver already holds in-tree or "
                   "in-spill (default K8S_TPU_KVXFER_DEDUP or 1; "
                   "legacy peers interoperate either way)")
    p.add_argument("--device", default=None,
                   help="cuda or cpu (the plain versions); default "
                   "K8S_TPU_PLATFORM, else cuda")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from k8s_tpu_torch.launcher import bootstrap
    from k8s_tpu_torch.models import placement as placement_lib

    device = bootstrap.default_device(args.device)
    mesh_kw: dict = {"train_dir": args.train_dir, "device": device}
    if placement_lib.env_mesh() > 0:
        # a tensor-parallel serving gang: every pod runs this binary; the
        # launcher env contract brings up torch.distributed, followers
        # replay the chief's batch plan, and the chief serves HTTP over
        # the mesh placement.  Every process loads the same artifact (to
        # the host; each rank moves its own shard), so no parameter
        # crosses the wire.
        from k8s_tpu_torch.models import mesh_serve

        lcfg = bootstrap.initialize_distributed(device=device)
        dev = bootstrap.process_device()
        config, params = serving.load_for_serving(
            args.train_dir, kv_cache=args.kv_cache,
            param_dtype=args.param_dtype, device="cpu")
        if lcfg.num_processes > 1 and lcfg.process_id != 0:
            host = lcfg.coordinator_address.rsplit(":", 1)[0] \
                if lcfg.coordinator_address else "127.0.0.1"
            return mesh_serve.follower_loop(config, params,
                                            chief_host=host, device=dev)
        mesh_kw = {"config": config, "params": params,
                   "placement": mesh_serve.MeshPlacement.from_env(
                       config, device=dev)}
    lm = LmServer(kv_cache=args.kv_cache,
                  param_dtype=args.param_dtype,
                  default_max_new_tokens=args.max_new_tokens,
                  slots=args.slots, queue_limit=args.queue,
                  prefix_blocks=args.prefix_blocks,
                  batch_sampling=None if args.batch_sampling is None
                  else bool(args.batch_sampling),
                  batch_spec=None if args.batch_spec is None
                  else bool(args.batch_spec),
                  role=args.role, kvxfer_port=args.kvxfer_port,
                  kvxfer_int8=None if args.kvxfer_int8 is None
                  else bool(args.kvxfer_int8),
                  spill_mb=args.spill_mb,
                  kvxfer_dedup=None if args.kvxfer_dedup is None
                  else bool(args.kvxfer_dedup), **mesh_kw)
    httpd = serve(lm, args.host, args.port)
    host, port = httpd.server_address[:2]
    log.info("serving %s on http://%s:%d (POST /v1/generate)",
             args.train_dir, host, port)
    print(f"READY http://{host}:{port}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        lm.close()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
