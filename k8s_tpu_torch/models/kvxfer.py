"""Cross-pod KV block transfer plane for disaggregated serving: the
wire between a prefill-tier pod and a decode-tier pod.  The port's own
copy of ``k8s_tpu/models/kvxfer.py``: its frames are byte for byte the
reference's, so a port pod and a JAX pod speak to each other.

A disaggregated serving deployment splits the compute-bound prefill
phase from the latency-bound decode phase into replica roles
(``K8S_TPU_SERVE_ROLE``).  A prefill pod prefills a prompt, emits the
first token and retires without holding a decode slot; the finished KV
blocks (position-independent and table-addressed, models/kvblocks.py)
stream here to the chosen decode pod, which grafts them into its own
block pool, seats the request straight from them
(``Engine.submit_prefilled``) and answers the remaining tokens back over
the same connection.

Wire format (stdlib ``socket`` + ``struct`` + ``json``, numpy for array
payloads)::

    [4-byte big-endian header length][header json][raw array bytes...]

where the header is ``{"op": str, "statics": {...}, "arrays": [[name,
dtype, shape], ...]}`` and the array payloads follow in header order,
C-contiguous.  A bf16 array is named ``"bfloat16"`` and carries its raw
2-byte patterns, as the reference writes it; this module reads it into
the host dtype :data:`kvtier.BF16` through its own dtype table, so it
needs no ml_dtypes.  One migration is a three-frame conversation on one
TCP connection (TCP_NODELAY):

- ``migrate`` (sender -> receiver): generation parameters and a trace id
  in ``statics``, the prompt ids, the draw-schedule carry (``key``) and
  one ``blk/<path>`` array per pool leaf (``[n_blocks, block_size,
  ...]``, the request's block chain in table order).  ``wire_int8``
  marks fp-pool content quantized for transit through
  ``models/paged.quantize_kv`` (``blk/...`` int8 + ``blkscale/...`` f32:
  less wire, lossy; int8 and bf16 pools ship their native leaves
  bit-exact and ignore the knob);
- ``seated`` (receiver -> sender): the blocks are grafted and the
  request holds a decode slot — what ``serve_kv_migrate_seconds``
  measures on the sender (transfer + graft, not the decode after);
- ``tokens`` (receiver -> sender): the full emitted token list (first
  token included), or ``error`` with a ``kind`` the sender maps back to
  HTTP semantics (``pool_exhausted`` / ``queue_full`` -> 503-shed,
  anything else -> 500).

Two extensions, both wire-compatible with peers that predate them (an
old receiver answers an unknown op with the closed protocol's
``kind=protocol`` error and closes; the sender memoizes the peer as
legacy and falls back to the classic conversation):

- **dedup handshake**: ``offer`` (sender -> receiver: the chain's
  cumulative block fingerprints, models/kvtier.chain_fingerprints) /
  ``need`` (receiver -> sender: how many leading blocks it already holds
  in its tree or spill tier) before a migrate; the migrate frame then
  carries ``statics["skip"]`` and only the ``blk/``/``blkscale/`` rows
  past the receiver's coverage.  The promise is advisory: a receiver
  that evicted it refuses with ``kind=dedup_stale`` and the sender
  re-sends the full chain once on the same stream;
- **prefix fetch**: ``fetch`` (requester -> holder: prompt ids) /
  ``blocks`` (holder -> requester: the longest cached full-block chain
  prefix as a migrate-shaped array payload; ``n_blocks`` 0 = miss), the
  fleet prefix index's cross-pod fetch-on-miss path.

Failure semantics: a truncated frame or dead peer raises
:class:`KvPeerGone` on the reader; the receiver tears down that
connection (discarding the in-flight request's tokens if it was already
seated: the engine runs it to completion, nobody waits) while the accept
loop keeps serving; the sender raises :class:`KvTransferError` so the
HTTP layer can answer the router, whose retry walk re-lands the request
on another prefill candidate.

This module is sockets and numpy: the engine owns the device work.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import struct
import threading
import time
from typing import Callable, Optional

import numpy as np

from k8s_tpu_torch.models.kvtier import dtype_name, dtype_of

log = logging.getLogger(__name__)

# Ops of the closed three-frame protocol.
OP_MIGRATE = "migrate"
OP_SEATED = "seated"
OP_TOKENS = "tokens"
OP_ERROR = "error"
# Tiered-KV extension ops.  ``offer``/``need`` prepend a
# fingerprint handshake to the migrate conversation (the sender then
# ships only blocks the receiver lacks); ``fetch``/``blocks`` are the
# fleet prefix-cache fetch-on-miss exchange.  A peer predating them
# answers any with the closed protocol's ``unexpected op`` error frame
# (kind ``protocol``) and closes the connection — the sender treats
# that as "legacy peer", caches the verdict, and falls back to the
# classic full migrate, so mixed-version fleets interoperate.
OP_OFFER = "offer"
OP_NEED = "need"
OP_FETCH = "fetch"
OP_BLOCKS = "blocks"

PROTOCOL_VERSION = 1

_HDR = struct.Struct(">I")
MAX_HEADER = 1 << 20
# one pool leaf's block chain for one request is MBs at most: anything
# past this is a garbage or misaligned stream, not a big prompt
MAX_ARRAY_BYTES = 1 << 30

DEFAULT_PORT = 8472

ENV_ROLE = "K8S_TPU_SERVE_ROLE"
ENV_PORT = "K8S_TPU_KVXFER_PORT"
ENV_INT8 = "K8S_TPU_KVXFER_INT8"
ENV_DEDUP = "K8S_TPU_KVXFER_DEDUP"

ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"


def env_role() -> str:
    """K8S_TPU_SERVE_ROLE: ``prefill`` / ``decode`` tier membership for
    a disaggregated serving TFJob; unset/anything else = the collapsed
    single-role pod (serves both phases — the compatibility default)."""
    raw = os.environ.get(ENV_ROLE, "").strip().lower()
    return raw if raw in (ROLE_PREFILL, ROLE_DECODE) else ""


def env_kvxfer_port() -> Optional[int]:
    """K8S_TPU_KVXFER_PORT: the decode pod's block-transfer listener
    port (0 = ephemeral, for tests/benches; unset = None — the server
    then only starts a receiver when its role is ``decode``)."""
    raw = os.environ.get(ENV_PORT, "").strip()
    if not raw:
        return None
    try:
        port = int(raw)
    except ValueError:
        log.warning("ignoring non-integer %s=%r", ENV_PORT, raw)
        return None
    if not 0 <= port < 65536:
        log.warning("ignoring out-of-range %s=%d", ENV_PORT, port)
        return None
    return port


def env_kvxfer_int8() -> bool:
    """K8S_TPU_KVXFER_INT8: quantize fp-pool block content to int8 for
    transit (models/paged.quantize_kv — 4x less wire, LOSSY on fp
    pools; int8 pools always ship their native leaves bit-exact and
    ignore this).  Default off: exactness beats bandwidth until a
    deployment opts in."""
    return os.environ.get(ENV_INT8, "").strip().lower() in (
        "1", "true", "on", "yes")


def env_kvxfer_dedup() -> bool:
    """K8S_TPU_KVXFER_DEDUP: the block-fingerprint dedup handshake on
    migrations.  Default ON — the handshake is one tiny
    frame round trip, falls back transparently on legacy peers, and
    the receiver re-verifies every skip — set 0/false/off to ship
    every block unconditionally."""
    return os.environ.get(ENV_DEDUP, "").strip().lower() not in (
        "0", "false", "off", "no")


class KvTransferError(RuntimeError):
    """A migration failed; ``kind`` maps the failure back to HTTP
    semantics on the sender (``pool_exhausted``/``queue_full`` are
    receiver backpressure → shed; everything else is an error)."""

    def __init__(self, msg: str, kind: str = "error"):
        super().__init__(msg)
        self.kind = kind


class KvPeerGone(KvTransferError):
    """The TCP stream ended mid-conversation (dead peer / truncated
    frame)."""

    def __init__(self, msg: str):
        super().__init__(msg, kind="peer_gone")


# ------------------------------------------------------------- framing

def encode_frame(op: str, statics: Optional[dict] = None,
                 arrays: Optional[dict] = None) -> bytes:
    metas = []
    payloads = []
    for name, arr in (arrays or {}).items():
        arr = np.ascontiguousarray(arr)
        if arr.nbytes > MAX_ARRAY_BYTES:
            raise ValueError(f"kvxfer array {name} too large: {arr.nbytes}")
        metas.append([name, dtype_name(arr.dtype), list(arr.shape)])
        payloads.append(arr.reshape(-1).view(np.uint8))
    header = json.dumps({"op": op, "statics": statics or {},
                         "arrays": metas}).encode()
    if len(header) > MAX_HEADER:
        raise ValueError(f"kvxfer header too large: {len(header)}")
    # one copy of the payload bytes: the join reads each array's buffer
    # in place (a block chain is tens of MiB at serving widths)
    return b"".join([_HDR.pack(len(header)), header, *payloads])


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    """``n`` bytes off the stream, in a bytearray: the arrays numpy
    reads over it stay writable, so the graft takes them without a
    copy."""
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            # timeouts propagate distinctly: the SENDER must tell a
            # reply timeout (frame likely delivered — never re-send)
            # from a dead stream (safe to retry a stale keep-alive)
            raise
        except OSError as e:
            raise KvPeerGone(f"kvxfer stream error: {e}") from None
        if not chunk:
            raise KvPeerGone(
                "kvxfer stream ended mid-frame (peer gone)")
        buf.extend(chunk)
    return buf


def read_frame(sock: socket.socket) -> tuple[str, dict, dict]:
    """One framed message off the stream: ``(op, statics, arrays)``.
    Raises :class:`KvPeerGone` on EOF/truncation and on malformed
    headers (a garbage stream must never be interpreted as a multi-GB
    allocation)."""
    (hlen,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if hlen > MAX_HEADER:
        raise KvPeerGone(f"bad kvxfer header length {hlen}")
    try:
        header = json.loads(_recv_exact(sock, hlen))
        metas = header["arrays"]
        op = header["op"]
    except (ValueError, KeyError, TypeError) as e:
        raise KvPeerGone(f"malformed kvxfer header: {e}") from None
    arrays: dict[str, np.ndarray] = {}
    for name, dtype, shape in metas:
        try:
            dt = dtype_of(dtype)
        except TypeError as e:
            raise KvPeerGone(f"bad kvxfer dtype {dtype!r}: {e}") from None
        n = int(dt.itemsize * int(np.prod(shape or [1])))
        if n > MAX_ARRAY_BYTES:
            raise KvPeerGone(f"bad kvxfer array size {n}")
        raw = _recv_exact(sock, n) if n else b""
        arrays[name] = np.frombuffer(raw, dtype=dt).reshape(shape)
    return op, header.get("statics") or {}, arrays


def parse_dest(dest: str) -> tuple[str, int]:
    """``host:port`` → (host, port); raises ValueError on garbage (the
    request-level validation path — a bad ``kv_dest`` is a 400, not a
    connect timeout)."""
    host, sep, port = str(dest).rpartition(":")
    if not sep or not host:
        raise ValueError(f"kv_dest must be host:port, got {dest!r}")
    try:
        p = int(port)
    except ValueError:
        raise ValueError(f"kv_dest port not an int: {dest!r}") from None
    if not 0 < p < 65536:
        raise ValueError(f"kv_dest port out of range: {dest!r}")
    return host, p


# ------------------------------------------------------------- receiver

class KvReceiver:
    """Decode-pod side: accept migrations, seat them on the engine, and
    stream the finished tokens back.

    ``seat_fn(statics, arrays, on_seated)`` is the server's seam onto
    ``Engine.submit_prefilled``: it must call ``on_seated()`` the moment
    the blocks are grafted and the request holds a slot (the engine does
    this between graft and the first decode step), then return the full
    emitted token list.  Backpressure raises from ``seat_fn`` travel to
    the sender as typed ``error`` frames.

    One handler thread per connection (senders pool connections, so the
    thread count tracks peer pods, not requests); connections are
    keep-alive — a sender runs many migrations down one socket.
    """

    def __init__(self, seat_fn: Callable, host: str = "127.0.0.1",
                 port: int = 0, reply_timeout_s: float = 600.0,
                 index_fn: Optional[Callable] = None,
                 fetch_fn: Optional[Callable] = None):
        self._seat_fn = seat_fn
        # the tiered-KV seams, both optional (None = the pre-hierarchy
        # protocol: offers and fetches answer the closed protocol's
        # ``unexpected op`` error, which senders read as "legacy"):
        # ``index_fn(fps) -> int`` answers a dedup offer with the
        # longest leading run of chain fingerprints this pod holds;
        # ``fetch_fn(statics, arrays) -> (statics, arrays) | None``
        # serves a prefix-cache fetch (None = nothing cached).
        self._index_fn = index_fn
        self._fetch_fn = fetch_fn
        self._listener = socket.create_server((host, port))
        self.port = self._listener.getsockname()[1]
        self._lock = threading.Lock()
        self._closed = False
        self._conns: list[socket.socket] = []
        self._reply_timeout_s = reply_timeout_s
        # counters (under the receiver lock; stats() renders them)
        self._migrations = 0
        self._blocks_in = 0
        self._errors = 0
        self._peer_gone = 0
        self._dedup_offers = 0
        self._dedup_blocks_promised = 0
        self._fetches = 0
        self._fetch_blocks_out = 0
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="kvxfer-accept")
        self._accept_thread.start()

    def stats(self) -> dict:
        with self._lock:
            return {"port": self.port, "migrations": self._migrations,
                    "blocks_in": self._blocks_in, "errors": self._errors,
                    "peer_gone": self._peer_gone,
                    "connections": len(self._conns),
                    "dedup_offers": self._dedup_offers,
                    "dedup_blocks_promised": self._dedup_blocks_promised,
                    "fetches": self._fetches,
                    "fetch_blocks_out": self._fetch_blocks_out}

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, addr = self._listener.accept()
            except OSError:
                return  # listener closed by stop()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                if self._closed:
                    conn.close()
                    return
                self._conns.append(conn)
            threading.Thread(target=self._serve_conn, args=(conn, addr),
                             daemon=True, name="kvxfer-conn").start()

    def _serve_conn(self, conn: socket.socket, addr) -> None:
        try:
            while True:
                try:
                    op, statics, arrays = read_frame(conn)
                except KvPeerGone:
                    # dead peer / truncated frame: tear down THIS
                    # connection; the accept loop keeps serving
                    with self._lock:
                        self._peer_gone += 1
                    return
                if op == OP_OFFER and self._index_fn is not None:
                    # dedup handshake: answer how many of
                    # the offered chain fingerprints we hold, then stay
                    # on the conversation — the (possibly sliced)
                    # migrate frame follows on this connection
                    fps = [str(f) for f in statics.get("fps") or []]
                    try:
                        have = int(self._index_fn(fps))
                    # the index is advisory; a failed probe
                    # just means "ship everything", never a dead conn
                    except Exception:  # noqa: BLE001
                        log.exception("kvxfer dedup index probe failed")
                        have = 0
                    have = max(0, min(have, len(fps)))
                    with self._lock:
                        self._dedup_offers += 1
                        self._dedup_blocks_promised += have
                    if not self._reply(conn, encode_frame(
                            OP_NEED, {"have": have})):
                        return
                    continue
                if op == OP_FETCH and self._fetch_fn is not None:
                    self._handle_fetch(conn, statics, arrays)
                    continue
                if op != OP_MIGRATE:
                    # unknown op (or a tiered-KV op this pod has no
                    # seam for): the closed protocol's error frame —
                    # senders read kind=protocol as "legacy peer" and
                    # fall back to the classic full migrate
                    self._reply(conn, encode_frame(
                        OP_ERROR, {"error": f"unexpected op {op!r}",
                                   "kind": "protocol"}))
                    return
                self._handle_migrate(conn, statics, arrays)
        finally:
            with self._lock:
                try:
                    self._conns.remove(conn)
                except ValueError:
                    pass
            try:
                conn.close()
            except OSError:
                pass

    def _reply(self, conn: socket.socket, data: bytes) -> bool:
        try:
            conn.sendall(data)
            return True
        except OSError:
            with self._lock:
                self._peer_gone += 1
            return False

    def _handle_fetch(self, conn: socket.socket, statics: dict,
                      arrays: dict) -> None:
        """One prefix-cache fetch: serve the longest cached
        chain prefix of the requested ids.  Runs inline on the
        connection thread — ``fetch_fn`` bounds its own engine-thread
        hop — and answers ``blocks`` (``n_blocks`` 0 = cache miss; the
        requester re-prefills, a miss is never an error)."""
        try:
            reply = self._fetch_fn(statics, arrays)
        except BaseException as e:  # noqa: BLE001 - typed onto the wire
            with self._lock:
                self._errors += 1
            kind = getattr(e, "kind", None) or "error"
            self._reply(conn, encode_frame(
                OP_ERROR, {"error": f"{type(e).__name__}: {e}",
                           "kind": kind}))
            return
        if reply is None:
            self._reply(conn, encode_frame(OP_BLOCKS, {"n_blocks": 0}))
            return
        out_statics, out_arrays = reply
        n = int(out_statics.get("n_blocks") or 0)
        with self._lock:
            self._fetches += 1
            self._fetch_blocks_out += n
        self._reply(conn, encode_frame(OP_BLOCKS, out_statics,
                                       out_arrays))

    def _handle_migrate(self, conn: socket.socket, statics: dict,
                        arrays: dict) -> None:
        """One migration: seat in a worker thread so the ``seated`` ack
        leaves the moment the graft lands (the engine thread must never
        block on this socket), then stream the tokens."""
        seated = threading.Event()
        done = threading.Event()
        box: dict = {}

        def run() -> None:
            try:
                box["tokens"] = self._seat_fn(statics, arrays,
                                              seated.set)
            except BaseException as e:  # noqa: BLE001 - typed onto the wire below
                box["error"] = e
            finally:
                done.set()

        t = threading.Thread(target=run, daemon=True,
                             name="kvxfer-seat")
        t.start()
        deadline = time.monotonic() + self._reply_timeout_s
        # ack as soon as seated; a seat failure (refusal) skips the ack
        timed_out = False
        while not seated.is_set() and not done.is_set():
            if time.monotonic() > deadline:
                box.setdefault("error", KvTransferError(
                    "seat timed out on the receive side", "timeout"))
                timed_out = True
                break
            seated.wait(0.01)
        if seated.is_set() and "error" not in box:
            n_blocks = next(
                (int(a.shape[0]) for name, a in arrays.items()
                 if name.startswith("blk/")), 0)
            if not self._reply(conn, encode_frame(
                    OP_SEATED, {"blocks": n_blocks})):
                # sender died between migrate and ack: the engine still
                # runs the seated request to completion; its tokens are
                # discarded below (nobody is waiting)
                done.wait(self._reply_timeout_s)
                return
        if not timed_out:
            done.wait(self._reply_timeout_s)
        # a timed-out seat replies its typed error IMMEDIATELY (waiting
        # on `done` again would delay the frame past the sender's own
        # reply timeout and tie this handler up for a second budget)
        err = box.get("error")
        if err is not None:
            kind = getattr(err, "kind", None) or {
                "PoolExhausted": "pool_exhausted",
                "QueueFull": "queue_full",
                "ValueError": "bad_request",
            }.get(type(err).__name__, "error")
            with self._lock:
                self._errors += 1
            self._reply(conn, encode_frame(
                OP_ERROR, {"error": f"{type(err).__name__}: {err}",
                           "kind": kind}))
            return
        tokens = [int(tk) for tk in box.get("tokens") or []]
        with self._lock:
            self._migrations += 1
            self._blocks_in += next(
                (int(a.shape[0]) for name, a in arrays.items()
                 if name.startswith("blk/")), 0)
        self._reply(conn, encode_frame(OP_TOKENS, {"tokens": tokens}))

    def stop(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            conns, self._conns = self._conns, []
        # shutdown wakes the accept loop blocked on the listener (a close
        # alone leaves it waiting until the join below times out)
        for end in (lambda: self._listener.shutdown(socket.SHUT_RDWR),
                    self._listener.close):
            try:
                end()
            except OSError:
                pass
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        self._accept_thread.join(timeout=5)


# --------------------------------------------------------------- sender

class KvSender:
    """Prefill-pod side: pooled keep-alive connections per decode peer
    (a fresh TCP connect per migration would pay a handshake on the
    serving hot path), one three-frame conversation per migration."""

    def __init__(self, connect_timeout_s: float = 5.0,
                 reply_timeout_s: float = 600.0, pool_cap: int = 8):
        self._lock = threading.Lock()
        self._pool: dict[str, list[socket.socket]] = {}
        self._pool_cap = pool_cap
        self._connect_timeout_s = connect_timeout_s
        self._reply_timeout_s = reply_timeout_s
        self._migrations = 0
        self._blocks_out = 0
        # dedup accounting + the legacy-peer memo: a dest
        # that answered an offer with the closed protocol's error never
        # gets offered again — one wasted round trip per peer lifetime
        self._dedup_blocks_skipped = 0
        self._dedup_bytes_saved = 0
        self._dedup_stale = 0
        self._legacy_peers: set[str] = set()

    def stats(self) -> dict:
        with self._lock:
            return {"migrations": self._migrations,
                    "blocks_out": self._blocks_out,
                    "pooled_connections": sum(
                        len(v) for v in self._pool.values()),
                    "dedup_blocks_skipped": self._dedup_blocks_skipped,
                    "dedup_bytes_saved": self._dedup_bytes_saved,
                    "dedup_stale": self._dedup_stale,
                    "legacy_peers": len(self._legacy_peers)}

    def _checkout(self, dest: str) -> tuple[socket.socket, bool]:
        with self._lock:
            idle = self._pool.get(dest)
            if idle:
                return idle.pop(), True
        host, port = parse_dest(dest)
        sock = socket.create_connection((host, port),
                                        timeout=self._connect_timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock, False

    def _checkin(self, dest: str, sock: socket.socket) -> None:
        with self._lock:
            idle = self._pool.setdefault(dest, [])
            if len(idle) < self._pool_cap:
                idle.append(sock)
                return
        sock.close()

    def migrate(self, dest: str, statics: dict, arrays: dict,
                fingerprints: Optional[list] = None,
                info: Optional[dict] = None) -> tuple[list[int], float]:
        """Run one migration conversation; returns ``(tokens,
        seated_s)`` where ``seated_s`` is send-to-seated-ack — the
        migration cost proper, decode excluded.  Raises
        :class:`KvTransferError` (typed) on refusal or a dead peer.
        A stale pooled connection gets ONE fresh retry (a receiver
        closing an idle keep-alive is not a peer failure).

        ``fingerprints`` (dedup): cumulative chain
        fingerprints of the chain's leading dedup-eligible FULL blocks
        (never the last prompt token's).  When given and the peer
        speaks the handshake, an ``offer``/``need`` prologue runs
        first and the migrate frame ships only ``blk/``/``blkscale/``
        rows past the receiver's promised coverage; a peer answering
        with the closed protocol's error is memoized as legacy and
        gets the classic full migrate, and a ``dedup_stale`` refusal
        (the receiver evicted the promise) re-sends the full chain
        once on the same stream.  ``info`` (optional out-param dict)
        receives this call's ``skipped_blocks``/``skipped_bytes`` —
        per-call and race-free, unlike the aggregate stats()."""
        full_frame = encode_frame(OP_MIGRATE, statics, arrays)
        if info is not None:
            info["skipped_blocks"] = 0
            info["skipped_bytes"] = 0
        last: Optional[KvTransferError] = None
        for only_fresh in (False, True):
            try:
                if only_fresh:
                    host, port = parse_dest(dest)
                    sock = socket.create_connection(
                        (host, port), timeout=self._connect_timeout_s)
                    sock.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                    reused = False
                else:
                    sock, reused = self._checkout(dest)
            except OSError as e:
                # a dead/unreachable decode peer is a transport failure
                # the HTTP layer maps to 502 (and the router walks past)
                raise KvPeerGone(
                    f"kvxfer connect to {dest}: {e}") from None
            try:
                sock.settimeout(self._reply_timeout_s)
                with self._lock:
                    offer = bool(fingerprints) \
                        and dest not in self._legacy_peers
                skip = 0
                t0 = time.monotonic()
                if offer:
                    sock.sendall(encode_frame(OP_OFFER, {
                        "v": PROTOCOL_VERSION,
                        "fps": [str(f) for f in fingerprints]}))
                    op, st, _arr = read_frame(sock)
                    if op == OP_ERROR \
                            and str(st.get("kind")) == "protocol":
                        # legacy peer predating the handshake: it
                        # closed the connection behind the error frame
                        # — memoize, reconnect, run the classic
                        # conversation
                        with self._lock:
                            self._legacy_peers.add(dest)
                        try:
                            sock.close()
                        except OSError:
                            pass
                        host, port = parse_dest(dest)
                        sock = socket.create_connection(
                            (host, port),
                            timeout=self._connect_timeout_s)
                        sock.setsockopt(socket.IPPROTO_TCP,
                                        socket.TCP_NODELAY, 1)
                        sock.settimeout(self._reply_timeout_s)
                        reused = False
                        t0 = time.monotonic()
                    elif op == OP_ERROR:
                        raise KvTransferError(
                            str(st.get("error")),
                            kind=str(st.get("kind") or "error"))
                    elif op == OP_NEED:
                        skip = max(0, min(int(st.get("have") or 0),
                                          len(fingerprints)))
                    else:
                        raise KvPeerGone(
                            f"unexpected offer reply {op!r}")
                frame = full_frame if not skip else encode_frame(
                    OP_MIGRATE, {**statics, "skip": skip},
                    {name: (a[skip:]
                            if name.startswith(("blk/", "blkscale/"))
                            else a)
                     for name, a in arrays.items()})
                sock.sendall(frame)
                op, st, _arr = read_frame(sock)
                seated_s = time.monotonic() - t0
                if op == OP_ERROR and skip \
                        and str(st.get("kind")) == "dedup_stale":
                    # the receiver lost the promised prefix between
                    # the offer and the seat (eviction race): one full
                    # re-send on the same live stream — we still hold
                    # every array, the index is advisory by contract
                    with self._lock:
                        self._dedup_stale += 1
                    skip = 0
                    t0 = time.monotonic()
                    sock.sendall(full_frame)
                    op, st, _arr = read_frame(sock)
                    seated_s = time.monotonic() - t0
                if op == OP_ERROR:
                    raise KvTransferError(
                        str(st.get("error")),
                        kind=str(st.get("kind") or "error"))
                if op == OP_SEATED:
                    op, st, _arr = read_frame(sock)
                if op == OP_ERROR:
                    raise KvTransferError(
                        str(st.get("error")),
                        kind=str(st.get("kind") or "error"))
                if op != OP_TOKENS:
                    raise KvPeerGone(f"unexpected reply op {op!r}")
                tokens = [int(tk) for tk in st.get("tokens") or []]
                n_blocks = next(
                    (int(a.shape[0]) for name, a in arrays.items()
                     if name.startswith("blk/")), 0)
                saved = sum(
                    (a.nbytes // max(1, int(a.shape[0]))) * skip
                    for name, a in arrays.items()
                    if name.startswith(("blk/", "blkscale/"))) \
                    if skip else 0
                with self._lock:
                    self._migrations += 1
                    self._blocks_out += n_blocks - skip
                    self._dedup_blocks_skipped += skip
                    self._dedup_bytes_saved += saved
                if info is not None and skip:
                    info["skipped_blocks"] = skip
                    info["skipped_bytes"] = saved
                self._checkin(dest, sock)
                return tokens, seated_s
            except socket.timeout:
                # a REPLY timeout is not a stale socket: the migrate
                # frame likely reached the receiver and the request may
                # already be seated — re-sending would graft and decode
                # the whole request a SECOND time on an already-slow
                # decode pod.  Fail the attempt; the router's retry
                # walk re-places it deliberately instead.
                try:
                    sock.close()
                except OSError:
                    pass
                raise KvPeerGone(
                    f"kvxfer reply from {dest} timed out after "
                    f"{self._reply_timeout_s}s") from None
            except (OSError, KvPeerGone) as e:
                try:
                    sock.close()
                except OSError:
                    pass
                last = e if isinstance(e, KvTransferError) \
                    else KvPeerGone(f"kvxfer transport: {e}")
                if reused:
                    continue  # stale keep-alive: one fresh retry
                raise last from None
            except KvTransferError:
                # typed refusal on a live stream: the conversation is
                # complete and the socket is reusable
                self._checkin(dest, sock)
                raise
        raise last  # pragma: no cover - loop always returns or raises

    def fetch(self, dest: str, statics: dict, arrays: dict
              ) -> tuple[dict, dict]:
        """One prefix-cache fetch conversation: ask ``dest``
        for its cached chain prefix of the prompt in ``arrays``;
        returns the ``blocks`` reply's ``(statics, arrays)`` —
        ``n_blocks`` 0 is a cache miss, not an error.  Transport
        semantics match :meth:`migrate`: typed errors (a legacy peer
        answers kind ``protocol``), one fresh retry for a stale pooled
        connection."""
        frame = encode_frame(OP_FETCH, statics, arrays)
        last: Optional[KvTransferError] = None
        for only_fresh in (False, True):
            try:
                if only_fresh:
                    host, port = parse_dest(dest)
                    sock = socket.create_connection(
                        (host, port), timeout=self._connect_timeout_s)
                    sock.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                    reused = False
                else:
                    sock, reused = self._checkout(dest)
            except OSError as e:
                raise KvPeerGone(
                    f"kvxfer connect to {dest}: {e}") from None
            try:
                sock.settimeout(self._reply_timeout_s)
                sock.sendall(frame)
                op, st, arr = read_frame(sock)
                if op == OP_ERROR:
                    raise KvTransferError(
                        str(st.get("error")),
                        kind=str(st.get("kind") or "error"))
                if op != OP_BLOCKS:
                    raise KvPeerGone(f"unexpected fetch reply {op!r}")
                self._checkin(dest, sock)
                return st, arr
            except socket.timeout:
                try:
                    sock.close()
                except OSError:
                    pass
                raise KvPeerGone(
                    f"kvxfer fetch reply from {dest} timed out after "
                    f"{self._reply_timeout_s}s") from None
            except (OSError, KvPeerGone) as e:
                try:
                    sock.close()
                except OSError:
                    pass
                last = e if isinstance(e, KvTransferError) \
                    else KvPeerGone(f"kvxfer transport: {e}")
                if reused:
                    continue  # stale keep-alive: one fresh retry
                raise last from None
            except KvTransferError as e:
                # typed refusal on a live stream: the conversation is
                # complete and the socket is reusable — EXCEPT a legacy
                # peer's ``protocol`` refusal, which closed the stream
                # behind the error frame
                if getattr(e, "kind", None) == "protocol":
                    try:
                        sock.close()
                    except OSError:
                        pass
                else:
                    self._checkin(dest, sock)
                raise
        raise last  # pragma: no cover - loop always returns or raises

    def close(self) -> None:
        with self._lock:
            pools, self._pool = self._pool, {}
        for idle in pools.values():
            for sock in idle:
                try:
                    sock.close()
                except OSError:
                    pass
