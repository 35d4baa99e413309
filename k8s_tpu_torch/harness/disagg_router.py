"""The port's own copy of the serving front door's pieces that
``harness/bench_disagg.py`` drives: the block-aligned prefix
fingerprint and consistent-hash ring of the reference's
``k8s_tpu/router/ring.py`` and the placement, disaggregated phase split
and proxying of its ``k8s_tpu/router/router.py``, plus a reader of
un-labeled samples from a Prometheus text exposition in place of its
``fleet/parser.py``.  Stdlib only.

The copy places requests exactly as the reference does, pod for pod:
the same sha1 fingerprint over the first two full blocks, the same
ring (64 points a node, sha1 points, ties ordered by name), the same affine plan with the least-outstanding fallback, and the
same phase split (prompts of at least ``phase_split_tokens`` tokens go
to the prefill tier's own ring and carry a ``kv_dest`` that rotates over
the decode candidates on retries).

What the reference router has and this copy leaves out, because the
bench uses none of it:

- request hedging (the bench's ``hedge_s`` is 0);
- the fleet plane: the ``serve_queue_depth`` tie-break and the fleet
  prefix index with its ``kv_src`` injection (the bench runs no fleet
  plane, so the reference reads both as empty);
- discovery through pod informer objects, pod weights and
  discovery-driven drain: targets are the static forms ``(name, url)``
  and ``(name, url, role[, kvxfer])`` only;
- router and per-backend drain, the autoscaler's hooks, the policies
  other than ``affine``, the in-flight bound;
- ``/metrics`` with its counters, ``/debug/router`` and the placement
  ring behind it.

The knobs the bench leaves at the reference's defaults are constants
here (64 points a node, 2 affinity blocks, a retry budget of 2, eviction
after 2 failures, a 1 s shed window), as are the two it sets (a 120 s
request timeout, a 0.5 s refresh).

``threading.Lock`` stands in for the reference's checked lock.
"""

from __future__ import annotations

import bisect
import hashlib
import http.client
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import urlsplit

log = logging.getLogger(__name__)

# the reference's defaults, and the bench's request timeout and refresh
VNODES = 64
AFFINITY_BLOCKS = 2
RETRY_BUDGET = 2
FAIL_THRESHOLD = 2
SHED_S = 1.0
PROBE_TIMEOUT_S = 1.0
REQUEST_TIMEOUT_S = 120.0
REFRESH_S = 0.5
POOL_CAP = 32  # idle keep-alive connections kept a backend


# -- the ring -----------------------------------------------------------------

def _point(data: str) -> int:
    return int.from_bytes(hashlib.sha1(data.encode()).digest()[:8], "big")


def fingerprint_tokens(tokens, block_size: int) -> Optional[str]:
    """Block-aligned fingerprint of a token-id prompt over its first
    ``min(AFFINITY_BLOCKS, full blocks)`` FULL blocks, or None when the
    prompt has no full block (affinity would be pure pinning)."""
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    n_full = len(tokens) // block_size
    if n_full < 1:
        return None
    use = min(AFFINITY_BLOCKS, n_full) * block_size
    h = hashlib.sha1()
    h.update(f"{block_size}:".encode())
    for t in tokens[:use]:
        h.update(f"{int(t)},".encode())
    return h.hexdigest()


def fingerprint_request(req: dict, block_size: int) -> Optional[str]:
    """Fingerprint a /v1/generate JSON body: token requests fingerprint
    their ids, text requests their UTF-8 bytes (the serving tokenizer is
    byte-level, so byte runs are token runs)."""
    tokens = req.get("tokens")
    if isinstance(tokens, list):
        try:
            return fingerprint_tokens([int(t) for t in tokens], block_size)
        except (TypeError, ValueError):
            return None  # malformed: the backend answers the 400
    text = req.get("text")
    if isinstance(text, str):
        return fingerprint_tokens(text.encode("utf-8", "replace"),
                                  block_size)
    return None


class HashRing:
    """Deterministic consistent-hash ring over string node names: VNODES
    points a node on a 2^64 circle keyed by ``sha1(node#i)``; a key's
    walk goes clockwise from ``sha1(key)``."""

    def __init__(self):
        self._nodes: set[str] = set()
        self._points: list[int] = []     # sorted ring positions
        self._owners: list[str] = []     # owner of each position

    def add(self, node: str) -> None:
        if node in self._nodes:
            return
        self._nodes.add(node)
        for i in range(VNODES):
            p = _point(f"{node}#{i}")
            idx = bisect.bisect_left(self._points, p)
            # equal points are ordered by name: insertion stays
            # deterministic
            while idx < len(self._points) and self._points[idx] == p \
                    and self._owners[idx] < node:
                idx += 1
            self._points.insert(idx, p)
            self._owners.insert(idx, node)

    def remove(self, node: str) -> None:
        if node not in self._nodes:
            return
        self._nodes.discard(node)
        keep = [(p, o) for p, o in zip(self._points, self._owners)
                if o != node]
        self._points = [p for p, _o in keep]
        self._owners = [o for _p, o in keep]

    def replace(self, nodes) -> None:
        """Reconcile membership to exactly ``nodes`` with minimal edits:
        surviving nodes keep their points."""
        target = {str(n) for n in nodes}
        for n in list(self._nodes - target):
            self.remove(n)
        for n in sorted(target):
            self.add(n)

    def candidates(self, key: str) -> list[str]:
        """Every node in clockwise ring order from the key, nearest
        first, each exactly once: the retry walk."""
        out: list[str] = []
        seen: set[str] = set()
        start = bisect.bisect_right(self._points, _point(key))
        n = len(self._points)
        for off in range(n):
            owner = self._owners[(start + off) % n]
            if owner not in seen:
                seen.add(owner)
                out.append(owner)
                if len(out) == len(self._nodes):
                    break
        return out


# -- the router ---------------------------------------------------------------

class Backend:
    """One serving pod behind the front door."""

    __slots__ = ("name", "base_url", "healthy", "inflight",
                 "consecutive_failures", "shed_until", "role", "kvxfer")

    def __init__(self, name: str, base_url: str, role: str = "",
                 kvxfer: Optional[str] = None):
        self.name = name
        self.base_url = base_url.rstrip("/")
        self.healthy = True
        self.inflight = 0
        self.consecutive_failures = 0
        self.shed_until = 0.0
        # disaggregated tier: "prefill" / "decode" ("" = a collapsed
        # single-role pod), and a decode pod's kv-transfer host:port
        self.role = role
        self.kvxfer = kvxfer


def _base_url(url: str) -> str:
    """scheme://host:port of a target URL."""
    parts = urlsplit(url)
    if parts.scheme and parts.netloc:
        return f"{parts.scheme}://{parts.netloc}"
    return url.rstrip("/")


class Router:
    """Placement and health state for one fleet of serving pods.
    ``targets_fn`` returns static targets, ``(name, url)`` or ``(name,
    url, role[, kvxfer])``.  All HTTP I/O happens outside the state
    lock."""

    def __init__(self, targets_fn: Callable[[], list], *, block_size: int,
                 phase_split_tokens: Optional[int] = None):
        self.block_size = int(block_size)
        # prompts of at least this many tokens go to the prefill tier
        # (then follow their blocks to a decode pod); None = off, and it
        # engages only while prefill-role backends exist
        self.phase_split_tokens = (int(phase_split_tokens)
                                   if phase_split_tokens else None)
        self._targets_fn = targets_fn
        self._ring = HashRing()
        # the prefill tier's own ring: its radix trees compose as the
        # serving ring's do
        self._prefill_ring = HashRing()
        self._backends: dict[str, Backend] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # keep-alive connections per backend netloc: a stale pooled
        # socket is retried once on a fresh connection before it counts
        # as a transport failure
        self._pool: dict[str, list] = {}

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "Router":
        self.refresh_once()
        self._thread = threading.Thread(
            target=self._maintenance_loop, daemon=True,
            name="router-refresh")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        with self._lock:
            pools, self._pool = self._pool, {}
        for idle in pools.values():
            for conn in idle:
                conn.close()

    def _maintenance_loop(self) -> None:
        while not self._stop.wait(REFRESH_S):
            try:
                self.refresh_once()
            except Exception:  # noqa: BLE001 - the loop must survive
                log.exception("router: refresh failed")

    # -- targets / health -----------------------------------------------------

    def refresh_once(self) -> int:
        """Reconcile the backend table and the rings to the targets and
        probe unhealthy backends; returns the backend count."""
        resolved: dict[str, tuple] = {}
        for t in list(self._targets_fn() or ()):
            if not isinstance(t, (tuple, list)) or len(t) < 2:
                continue
            name, url = t[0], t[1]
            role = t[2] if len(t) >= 3 else None
            kvxfer = t[3] if len(t) >= 4 else None
            if not name or not url:
                continue
            role = str(role).strip().lower() if role else ""
            if role not in ("prefill", "decode"):
                role = ""
            resolved[str(name)] = (_base_url(str(url)), role,
                                   str(kvxfer) if kvxfer else None)
        with self._lock:
            for name in list(self._backends):
                if name not in resolved:
                    del self._backends[name]
            for name, (base, role, kvxfer) in resolved.items():
                b = self._backends.get(name)
                if b is None:
                    b = self._backends[name] = Backend(name, base,
                                                       role=role,
                                                       kvxfer=kvxfer)
                b.base_url = base
                b.role = role
                b.kvxfer = kvxfer
            probe_list = [(b.name, b.base_url)
                          for b in self._backends.values() if not b.healthy]
            self._rebuild_ring_locked()
            count = len(self._backends)
        for name, base in probe_list:  # I/O outside the lock
            self._probe(name, base)
        return count

    def _rebuild_ring_locked(self) -> None:
        # prefill-role pods serve the phase-split prefill leg only
        self._ring.replace(b.name for b in self._backends.values()
                           if b.healthy and b.role != "prefill")
        self._prefill_ring.replace(b.name for b in self._backends.values()
                                   if b.healthy and b.role == "prefill")

    def _probe(self, name: str, base_url: str) -> None:
        """/healthz recheck of an evicted backend: a 200 re-admits it."""
        ok = False
        try:
            conn = http.client.HTTPConnection(urlsplit(base_url).netloc,
                                              timeout=PROBE_TIMEOUT_S)
            try:
                conn.request("GET", "/healthz")
                resp = conn.getresponse()
                resp.read()
                ok = resp.status == 200
            finally:
                conn.close()
        except (OSError, http.client.HTTPException):
            ok = False
        if ok:
            with self._lock:
                b = self._backends.get(name)
                if b is not None and not b.healthy:
                    b.healthy = True
                    b.consecutive_failures = 0
                    self._rebuild_ring_locked()

    # -- placement ------------------------------------------------------------

    def _eligible_locked(self) -> list[Backend]:
        return [b for b in self._backends.values()
                if b.healthy and b.role != "prefill"]

    def _prefill_eligible_locked(self) -> list[Backend]:
        return [b for b in self._backends.values()
                if b.healthy and b.role == "prefill"]

    @staticmethod
    def _available(b: Backend, now: float) -> bool:
        return now >= b.shed_until  # a 503 sheds it for SHED_S

    @staticmethod
    def _prompt_tokens(req: dict) -> int:
        tokens = req.get("tokens")
        if isinstance(tokens, list):
            return len(tokens)
        text = req.get("text")
        if isinstance(text, str):
            return len(text.encode("utf-8", "replace"))
        return 0

    def _least(self, backends: list, now: float) -> list:
        """Least-outstanding order: available first, then in-flight,
        then name."""
        return sorted(backends, key=lambda b: (
            not self._available(b, now), b.inflight, b.name))

    def plan_disagg(self, req: dict) -> Optional[tuple[
            list[str], bool, Optional[str], list[str]]]:
        """Phase-split placement of a long prompt, or None when it stays
        on the normal plan: ``(prefill order, affine, fingerprint,
        kv_dests)``.  The prefill leg is prefix-affine over the prefill
        tier's ring; ``kv_dests`` is the ordered walk of decode
        destinations, affine on the serving ring with the same
        fingerprint first, then the least-outstanding rest, each once."""
        if not self.phase_split_tokens \
                or self._prompt_tokens(req) < self.phase_split_tokens \
                or req.get("kv_dest"):
            return None
        fp = fingerprint_request(req, self.block_size)
        now = time.monotonic()
        with self._lock:
            prefill = self._prefill_eligible_locked()
            if not prefill:
                return None  # collapsed fleet: normal plan
            by_name = {b.name: b for b in prefill}
            if fp is not None:
                order = [n for n in self._prefill_ring.candidates(fp)
                         if n in by_name]
                affine = bool(order) and self._available(
                    by_name[order[0]], now)
            else:
                order, affine = [], False
            if not order:
                order = [b.name for b in self._least(prefill, now)]
            decode = [b for b in self._eligible_locked() if b.kvxfer]
            if not decode:
                return None  # nobody can receive blocks: serve locally
            by_decode = {b.name: b for b in decode}
            dests: list[str] = []
            if fp is not None:
                for n in self._ring.candidates(fp):
                    cand = by_decode.get(n)
                    if cand is not None and self._available(cand, now):
                        dests.append(cand.kvxfer)
            for b in self._least(decode, now):
                if b.kvxfer not in dests:
                    dests.append(b.kvxfer)
            return order, affine, fp, dests

    def plan(self, req: dict) -> tuple[list[str], bool, Optional[str]]:
        """(ordered backend names to try, affine, fingerprint): the first
        is the placement, the rest the retry walk.  Affine when the
        ring's pod is available, else least-outstanding first and then
        the ring walk without it."""
        now = time.monotonic()
        fp = fingerprint_request(req, self.block_size)
        with self._lock:
            eligible = self._eligible_locked()
            if not eligible:
                return [], False, fp
            by_name = {b.name: b for b in eligible}
            least = self._least(eligible, now)
            if fp is None:
                return [b.name for b in least], False, None
            ring_order = [n for n in self._ring.candidates(fp)
                          if n in by_name]
            if ring_order and self._available(by_name[ring_order[0]], now):
                return ring_order, True, fp
            pick = least[0].name
            return [pick] + [n for n in (ring_order
                                         or [b.name for b in least])
                             if n != pick], False, fp

    # -- proxying -------------------------------------------------------------

    def handle_generate(self, body: bytes, headers: dict) -> tuple[
            int, dict, bytes, dict]:
        """Proxy one /v1/generate: (status, response headers, body,
        placement info).  Every failure maps to a response; this never
        raises."""
        try:
            req = json.loads(body or b"{}")
            if not isinstance(req, dict):
                req = {}
        except ValueError:
            req = {}  # the backend answers the 400; no affinity
        disagg = self.plan_disagg(req) if req else None
        kv_dests: Optional[list] = None
        if disagg is not None:
            # the destination rides the body and ROTATES over the decode
            # candidates on retries: an exhausted decode pod refuses as a
            # 503 on the prefill side
            order, affine, fp, kv_dests = disagg
        else:
            order, affine, fp = self.plan(req)
        if not order:
            return (503, {"Retry-After": "1"},
                    json.dumps({"error": "no healthy backends"}).encode(),
                    {"outcome": "no_backends", "affine": affine})
        attempts = min(len(order), 1 + RETRY_BUDGET)
        last_status, last_headers, last_body = 503, {}, json.dumps(
            {"error": "all retry candidates failed"}).encode()
        for i, name in enumerate(order[:attempts]):
            if kv_dests:
                body = json.dumps(
                    {**req,
                     "kv_dest": kv_dests[i % len(kv_dests)]}).encode()
            status, resp_headers, resp_body, err = self._forward(
                name, body, headers)
            if err is not None:
                self._note_transport_failure(name)
                last_status, last_headers, last_body = 502, {}, json.dumps(
                    {"error": f"backend {name}: {err}"}).encode()
                continue
            if status >= 500:
                # /v1/generate is idempotent: every 5xx walks on.  A 503
                # is shedding (healthy: mark the shed window); another
                # 5xx counts toward eviction
                if status == 503:
                    self._note_success(name, status)
                else:
                    self._note_transport_failure(name)
                last_status, last_headers, last_body = (
                    status, resp_headers, resp_body)
                continue
            self._note_success(name, status)
            served_affine = affine and i == 0
            resp_headers["X-Router-Backend"] = name
            resp_headers["X-Router-Affine"] = "1" if served_affine else "0"
            return status, resp_headers, resp_body, {
                "outcome": "ok" if status < 400 else "bad_request",
                "affine": served_affine, "backend": name,
                "attempts": i + 1}
        last_headers.setdefault("Retry-After", "1")
        return last_status, last_headers, last_body, {
            "outcome": "shed" if last_status == 503 else "error",
            "affine": False, "attempts": attempts}

    def _checkout_conn(self, netloc: str):
        """(connection, reused): an idle pooled keep-alive connection, or
        a fresh one."""
        with self._lock:
            idle = self._pool.get(netloc)
            if idle:
                return idle.pop(), True
        return http.client.HTTPConnection(
            netloc, timeout=REQUEST_TIMEOUT_S), False

    def _checkin_conn(self, netloc: str, conn) -> None:
        with self._lock:
            idle = self._pool.setdefault(netloc, [])
            if len(idle) < POOL_CAP:
                idle.append(conn)
                return
        conn.close()

    def _attempt(self, netloc: str, body: bytes, fwd: dict) -> tuple[
            int, dict, bytes, Optional[str]]:
        """One POST on one (maybe pooled) connection; a failure on a
        reused connection is retried once on a fresh socket."""
        for only_fresh in (False, True):
            conn, reused = (self._checkout_conn(netloc) if not only_fresh
                            else (http.client.HTTPConnection(
                                netloc, timeout=REQUEST_TIMEOUT_S),
                                False))
            try:
                conn.request("POST", "/v1/generate", body=body,
                             headers=fwd)
                resp = conn.getresponse()
                resp_body = resp.read()
                out_headers = {}
                ra = resp.getheader("Retry-After")
                if ra:
                    out_headers["Retry-After"] = ra
                if resp.will_close:
                    conn.close()
                else:
                    self._checkin_conn(netloc, conn)
                return resp.status, out_headers, resp_body, None
            except (OSError, http.client.HTTPException) as e:
                conn.close()
                if reused:
                    continue  # stale keep-alive: one fresh retry
                return 0, {}, b"", f"{type(e).__name__}: {e}"
        return 0, {}, b"", "unreachable"  # pragma: no cover

    def _forward(self, name: str, body: bytes, headers: dict) -> tuple[
            int, dict, bytes, Optional[str]]:
        """One attempt against one backend: (status, headers, body,
        transport error)."""
        with self._lock:
            b = self._backends.get(name)
            if b is None:
                return 0, {}, b"", "backend vanished"
            b.inflight += 1
            netloc = urlsplit(b.base_url).netloc
        try:
            fwd = {"Content-Type": "application/json"}
            tp = headers.get("traceparent")
            if tp:
                fwd["traceparent"] = tp
            return self._attempt(netloc, body, fwd)
        finally:
            with self._lock:
                b2 = self._backends.get(name)
                if b2 is not None:
                    b2.inflight = max(0, b2.inflight - 1)

    def _note_transport_failure(self, name: str) -> None:
        with self._lock:
            b = self._backends.get(name)
            if b is None:
                return
            b.consecutive_failures += 1
            if b.healthy and b.consecutive_failures >= FAIL_THRESHOLD:
                b.healthy = False  # evicted until a /healthz probe greens
                self._rebuild_ring_locked()

    def _note_success(self, name: str, status: int) -> None:
        with self._lock:
            b = self._backends.get(name)
            if b is None:
                return
            b.consecutive_failures = 0
            if status == 503:
                # shedding is not unhealth: skip it for placement until
                # the shed window passes
                b.shed_until = time.monotonic() + SHED_S

    def healthy_backends(self) -> int:
        with self._lock:
            return sum(b.healthy for b in self._backends.values())


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "k8s-tpu-torch-router"
    # one TCP segment a response: buffered writes and no Nagle, or
    # keep-alive clients stall 40-200 ms
    wbufsize = -1
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):
        log.debug("router: " + fmt, *args)

    def _send(self, code: int, body: bytes,
              headers: Optional[dict] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            if k.lower() not in ("content-type", "content-length"):
                self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        router: Router = self.server.router  # type: ignore[attr-defined]
        if self.path.partition("?")[0] != "/healthz":
            return self._send(404, json.dumps(
                {"error": f"unknown path {self.path}"}).encode())
        healthy = router.healthy_backends()
        return self._send(200 if healthy else 503, json.dumps(
            {"status": "ok" if healthy else "no backends",
             "healthy_backends": healthy}).encode())

    def do_POST(self):  # noqa: N802
        router: Router = self.server.router  # type: ignore[attr-defined]
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            self.close_connection = True
            return self._send(400, json.dumps(
                {"error": "bad Content-Length"}).encode())
        body = self.rfile.read(length) if length > 0 else b""
        if self.path.partition("?")[0] != "/v1/generate":
            return self._send(404, json.dumps(
                {"error": f"unknown path {self.path}"}).encode())
        status, headers, resp_body, _info = router.handle_generate(
            body, {k.lower(): v for k, v in self.headers.items()})
        return self._send(status, resp_body, headers=headers)


class RouterServer:
    """The front door's HTTP listener (``POST /v1/generate``, ``GET
    /healthz``) over a Router."""

    def __init__(self, router: Router):
        self.router = router
        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.router = router  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "RouterServer":
        self.router.start()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True, name="router-server")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.router.stop()


# -- the exposition reader ----------------------------------------------------

def sample_value(text: str, name: str) -> Optional[float]:
    """The value of the un-labeled sample ``name`` in a Prometheus text
    exposition (``name value [timestamp]``), or None when there is none.
    Comment lines and labeled samples are skipped; ``+Inf`` / ``-Inf``
    read as infinities."""
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "{" in line:
            continue
        fields = line.split()
        if len(fields) >= 2 and fields[0] == name:
            raw = fields[1]
            if raw == "+Inf":
                return float("inf")
            if raw == "-Inf":
                return float("-inf")
            return float(raw)
    return None
