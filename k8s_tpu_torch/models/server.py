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
  and ``GET /debug``, the index of these endpoints.  ``/debug/traces``
  and ``/debug/compiles`` answer 404 naming what they wait for.
- ``POST /v1/generate`` with ``{"text": str | "tokens": [int], ...}`` ->
  ``{"text": str | "tokens": [int]}``.  Optional fields:
  ``max_new_tokens``, ``temperature``, ``top_k``, ``eos``, ``seed``.  Bad
  input answers 400 with ``{"error": ..., "field": ...}`` naming the
  field; a full admission queue answers 503 with a ``Retry-After``
  header.

Device work goes through the continuous-batching engine
(models/engine.py): greedy and sampled requests share one batched decode
step over ``K8S_TPU_SERVE_SLOTS`` (default 4) slots with iteration-level
join/retire, a paged KV pool with shared-prefix reuse, and per-slot
samplers, so fixed-seed output is the same on either lane.
``K8S_TPU_SERVE_BATCH_SAMPLING=0`` (or ``--batch-sampling 0``) routes
sampled requests to the engine's exclusive lane, which runs the
single-flight program (``decode.make_generate_fn``, whose prefill goes
through the flash-attention kernel when the config sets
``use_flash_attention``).  ``--slots 0`` turns the engine off and
restores the one-lock single-flight path.

Not ported yet, each refused by name: speculative decoding (the
``speculative`` field answers 400), disaggregated serving
(``K8S_TPU_SERVE_ROLE``), mesh serving (``K8S_TPU_SERVE_MESH``) and the
host spill tier (``K8S_TPU_SERVE_SPILL_MB``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from k8s_tpu_torch.models import decode as decode_lib
from k8s_tpu_torch.models import engine as engine_lib
from k8s_tpu_torch.models import requestlog, serving
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
    if spec:
        raise RequestError("speculative",
                           "speculative decoding is not ported yet")
    return ParsedRequest(
        ids=ids, echo_text=req["text"] if has_text else None,
        max_new_tokens=max_new, temperature=temperature, top_k=top_k,
        eos=eos, seed=seed)


def _emitted(toks, eos) -> int:
    """Tokens actually emitted by a shape-static generation row: through
    the first EOS inclusive, excluding the frozen pad tail."""
    toks = list(toks)
    if eos is not None and eos in toks:
        return toks.index(eos) + 1
    return len(toks)


def _refuse_later_slices() -> None:
    """The serving features of later slices, refused by name when their
    knobs are set."""
    role = os.environ.get("K8S_TPU_SERVE_ROLE", "").strip().lower()
    if role in ("prefill", "decode"):
        raise NotImplementedError(
            f"K8S_TPU_SERVE_ROLE={role}: disaggregated serving (kvxfer) "
            "is not ported yet; unset it to serve both phases")
    if engine_lib._env_int("K8S_TPU_SERVE_MESH", 0) > 0:
        raise NotImplementedError(
            "K8S_TPU_SERVE_MESH: mesh serving comes with the parallel/ "
            "slice of the port; unset it to serve on one device")


class LmServer:
    """Loads a serving artifact (or takes config + params directly) once
    onto ``device``; thread-safe generate() through the
    continuous-batching engine (``slots`` > 0, default
    ``K8S_TPU_SERVE_SLOTS`` or 4) or single-flight (``slots=0``)."""

    def __init__(self, train_dir: Optional[str] = None,
                 kv_cache: str = "model", param_dtype: str = "model",
                 default_max_new_tokens: int = 64, *, config=None,
                 params=None, slots: Optional[int] = None,
                 queue_limit: Optional[int] = None,
                 prefix_blocks: Optional[int] = None,
                 batch_sampling: Optional[bool] = None, registry=None,
                 device="cuda"):
        _refuse_later_slices()
        self.device = resolve_device(device)
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
        if slots > 0:
            self.engine: Optional[engine_lib.Engine] = engine_lib.Engine(
                config, params, slots=slots, queue_limit=queue_limit,
                prefix_blocks=prefix_blocks, metrics=self.metrics,
                device=self.device)
            # the exclusive lane runs on the engine's model
            self.model = self.engine.model
        else:
            # single-flight: one lock around all device work
            self.engine = None
            self.model = Transformer(config, params, device=self.device)
        self._lock = threading.Lock()

    def close(self) -> None:
        if self.metrics["queue_depth"]._fn == self.queue_depth:
            self.metrics["queue_depth"]._fn = None
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
                    "device": str(self.device)}
        s = self.engine.stats()
        return {"engine": "continuous-batching", "slots": s["slots"],
                "placement": s["placement"],
                "num_processes": s["num_processes"],
                "mesh_shape": s["mesh_shape"],
                "tp_degree": s["tp_degree"],
                "active": s["active"], "queue_depth": s["queue_depth"],
                "queue_limit": s["queue_limit"],
                "batch_sampling": self.batch_sampling,
                "paged": s["paged"], "block_size": s["block_size"],
                "pool_blocks": s["pool_blocks"],
                "blocks_in_use": s["blocks_in_use"],
                "prefix_hits": s["prefix_hits"],
                "prefix_tokens_saved": s["prefix_tokens_saved"],
                "request_log": s["request_log"],
                "device": str(self.device)}

    def generate(self, parsed: ParsedRequest) -> dict:
        """One validated generation request.  May raise engine.QueueFull
        under backpressure.  Sampled requests ride the batch unless
        ``batch_sampling`` routes them to the exclusive lane; either
        routing emits the same tokens at a fixed seed."""
        use_batched = parsed.temperature == 0.0 or self.batch_sampling
        if self.engine is not None and use_batched:
            toks = self.engine.submit(parsed.ids, parsed.max_new_tokens,
                                      eos_id=parsed.eos,
                                      temperature=parsed.temperature,
                                      top_k=parsed.top_k, seed=parsed.seed)
        elif self.engine is not None:
            toks = self.engine.submit_exclusive(
                lambda: self._generate_exclusive(parsed))
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
        """Whole generation on the device (the single-flight program);
        returns the host token row."""
        fn = decode_lib._cached_generate_fn(
            self.config, parsed.max_new_tokens, parsed.temperature,
            parsed.top_k, parsed.eos, 0)
        gen = torch.Generator(device=self.device).manual_seed(parsed.seed)
        prompt = torch.as_tensor(parsed.ids, dtype=torch.long,
                                 device=self.device)[None, :]
        return fn(self.model, prompt, gen)[0].cpu().numpy()


_NOT_PORTED_DEBUG = {
    "/debug/traces": "span tracing (k8s_tpu/trace) is not ported",
    "/debug/compiles": "eager PyTorch compiles no programs, so the "
                       "reference's compile ledger has no counterpart",
}


def debug_index_response() -> tuple[int, str, str]:
    """The /debug index: each debug endpoint of this server with its
    active state, what activates it and its query parameters (the
    reference's shared index, for the endpoints a serving pod has)."""
    active = requestlog.active() is not None
    endpoints = [
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
        start = time.monotonic()
        try:
            out = lm.generate(parsed)
        except engine_lib.QueueFull as e:
            # backpressure: shed with an explicit retry hint; /healthz
            # stays 200 (serve_rejected_total is counted by the engine)
            m["requests"].labels("rejected").inc()
            return self._send(
                503, {"error": str(e)},
                headers={"Retry-After":
                         str(max(1, int(round(e.retry_after_s))))})
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
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    lm = LmServer(args.train_dir, kv_cache=args.kv_cache,
                  param_dtype=args.param_dtype,
                  default_max_new_tokens=args.max_new_tokens,
                  slots=args.slots, queue_limit=args.queue,
                  prefix_blocks=args.prefix_blocks,
                  batch_sampling=None if args.batch_sampling is None
                  else bool(args.batch_sampling), device=args.device)
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
