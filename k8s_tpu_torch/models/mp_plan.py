"""Chief→worker batch-plan bus for multi-process serving: the port's own
copy of ``k8s_tpu/models/mp_plan.py``, its wire format byte for byte.

The tensor-parallel engine keeps ALL scheduling host-side on one chief
(slot admission, block tables, batch-plan ints); the other tp ranks only
run the model bodies on their shards.  Every rank must run the SAME body
on the SAME plan each step, since the ranks meet in the per-layer
all-reduces — so before the chief runs a body, it broadcasts the
per-step plan (opcode + static args + the host numpy arrays) here, and
each follower replays it verbatim.  Per-step traffic is a few hundred
bytes of ints (slot/table/position/token ids); the model, the KV pool,
and every activation stay on the device.

Stdlib only (socket + struct + json), same discipline as the router and
fleet planes.  Wire format per message::

    [4-byte big-endian header length][header json][raw array bytes...]

where the header is ``{"op": str, "statics": {...}, "arrays":
[[name, dtype, shape], ...]}`` and the array payloads follow in header
order, C-contiguous.  The stream is strictly ordered; workers execute
in receive order, so chief and workers always run the same body
sequence (the ranks' collectives then hold them in lockstep).

Failure semantics are the gang's: a chief crash closes the TCP stream,
every worker's ``recv()`` raises :class:`PlanBusClosed`, and the worker
exits NONZERO — the operator's whole-gang restart policy takes it from
there (a half-dead serving gang, like a half-dead SPMD training gang,
can only hang).  A deliberate shutdown sends the ``bye`` op first so
workers exit 0.
"""

from __future__ import annotations

import json
import logging
import socket
import struct
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

OP_BYE = "bye"
_HDR = struct.Struct(">I")
# plan messages are tiny; anything past this is a protocol bug, not a
# big batch (guards a worker against interpreting a garbage/misaligned
# stream as a multi-GB allocation)
MAX_HEADER = 1 << 20
MAX_ARRAY_BYTES = 1 << 28


class PlanBusClosed(ConnectionError):
    """The plan stream ended: deliberate ``bye`` or a dead chief."""

    def __init__(self, msg: str, *, clean: bool):
        super().__init__(msg)
        self.clean = clean


def _encode(op: str, statics: dict, arrays: dict[str, np.ndarray]
            ) -> bytes:
    metas = []
    payloads = []
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        if arr.nbytes > MAX_ARRAY_BYTES:
            raise ValueError(f"plan array {name} too large: {arr.nbytes}")
        metas.append([name, str(arr.dtype), list(arr.shape)])
        payloads.append(arr.tobytes())
    header = json.dumps({"op": op, "statics": statics,
                         "arrays": metas}).encode()
    if len(header) > MAX_HEADER:
        raise ValueError(f"plan header too large: {len(header)}")
    return _HDR.pack(len(header)) + header + b"".join(payloads)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise PlanBusClosed(
                "plan bus stream ended mid-message (chief gone)",
                clean=False)
        buf.extend(chunk)
    return bytes(buf)


def _decode(sock: socket.socket) -> tuple[str, dict, dict]:
    (hlen,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if hlen > MAX_HEADER:
        raise PlanBusClosed(f"bad plan header length {hlen}", clean=False)
    header = json.loads(_recv_exact(sock, hlen))
    arrays: dict[str, np.ndarray] = {}
    for name, dtype, shape in header["arrays"]:
        n = int(np.dtype(dtype).itemsize * int(np.prod(shape or [1])))
        if n > MAX_ARRAY_BYTES:
            raise PlanBusClosed(f"bad plan array size {n}", clean=False)
        raw = _recv_exact(sock, n) if n else b""
        arrays[name] = np.frombuffer(raw, dtype=dtype).reshape(shape)
    return header["op"], header.get("statics") or {}, arrays


def mp_closed_during_accept() -> PlanBusClosed:
    return PlanBusClosed("plan bus closed during worker accept",
                         clean=True)


class PlanBus:
    """Chief side: accept one connection per worker, then broadcast
    plan messages in step order.

    ``pipelined=False`` (default): sends happen inline on the engine
    thread — broadcast returns after every worker's socket took the
    frame.  ``pipelined=True`` (chunked-prefill plan pipelining):
    broadcast ENQUEUES the encoded frame and returns
    immediately; a dedicated sender thread drains the queue in FIFO
    order, so the chief's next dispatch overlaps the socket I/O of the
    current plan instead of serializing behind it — a multi-chunk
    prefill stops paying one bus round per chunk.  Ordering is
    preserved (one queue, one sender), the frame is encoded at enqueue
    time (the engine may reuse its host buffers afterwards), and a
    sender-side socket failure surfaces as :class:`PlanBusClosed` on
    the NEXT broadcast — the same gang-fatal semantics as the inline
    path, one step later.  ``stats()`` reports enqueue-wait vs actual
    send seconds, so the overlap can be checked.

    ``close()`` (any thread) drains the queue, sends ``bye`` once and
    tears down."""

    def __init__(self, num_workers: int, host: str = "127.0.0.1",
                 port: int = 0, accept_timeout: float = 120.0,
                 pipelined: bool = False):
        """``host`` is the BIND address: loopback for same-host gangs
        (tests, the local driver); the serving chief binds all
        interfaces (``""``) so workers on other pods can dial the
        chief pod's hostname — MeshPlacement.from_env does that."""
        self._lock = threading.Lock()
        self._listener = socket.create_server((host, port))
        self.port = self._listener.getsockname()[1]
        self.num_workers = num_workers
        self._conns: list[socket.socket] = []
        self._closed = False
        self._accept_timeout = accept_timeout
        self.pipelined = bool(pipelined)
        # pipelined state, all under _send_cond (its own leaf lock so
        # the sender never holds the conns lock across a syscall)
        self._send_cond = threading.Condition()
        self._sendq: "deque[bytes]" = deque()
        self._send_error: Optional[str] = None
        self._sender_stop = False
        self._stat_broadcasts = 0
        self._stat_enqueue_s = 0.0
        self._stat_send_s = 0.0
        self._stat_bytes = 0
        self._stat_max_depth = 0
        self._sender: Optional[threading.Thread] = None
        if self.pipelined:
            self._sender = threading.Thread(
                target=self._sender_loop, daemon=True,
                name="planbus-sender")
            self._sender.start()

    def stats(self) -> dict:
        """Pipelining telemetry: enqueue-wait vs send seconds is the
        measured overlap (enqueue ≪ send means the engine thread really
        stopped paying the socket I/O)."""
        with self._send_cond:
            return {
                "pipelined": self.pipelined,
                "broadcasts": self._stat_broadcasts,
                "enqueue_wait_s": round(self._stat_enqueue_s, 6),
                "send_s": round(self._stat_send_s, 6),
                "bytes": self._stat_bytes,
                "max_queue_depth": self._stat_max_depth,
                "send_error": self._send_error,
            }

    def _sender_loop(self) -> None:
        while True:
            with self._send_cond:
                while not self._sendq and not self._sender_stop:
                    self._send_cond.wait()
                if not self._sendq:
                    return  # stopped and drained
                data = self._sendq.popleft()
                self._send_cond.notify_all()  # close() waits for drain
            with self._lock:
                conns = list(self._conns)
            t0 = time.monotonic()
            try:
                for conn in conns:
                    conn.sendall(data)
            except OSError as e:
                # a dead worker is gang-fatal: surface on the next
                # broadcast (PlanBusClosed) instead of hanging the queue
                with self._send_cond:
                    self._send_error = f"{type(e).__name__}: {e}"
                    self._sendq.clear()
                    self._send_cond.notify_all()
                return
            with self._send_cond:
                self._stat_send_s += time.monotonic() - t0

    def accept_workers(self) -> None:
        """Block until every worker has dialed in (workers connect right
        after building their shard, so this bounds gang bring-up,
        not steady state).  The accept socket is only ever touched here;
        the shared connection list is mutated under the bus lock."""
        self._listener.settimeout(self._accept_timeout)
        accepted = 0
        try:
            while accepted < self.num_workers:
                conn, addr = self._listener.accept()
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                accepted += 1
                log.info("plan bus: worker %d/%d connected from %s",
                         accepted, self.num_workers, addr)
                with self._lock:
                    if self._closed:
                        conn.close()
                        raise mp_closed_during_accept()
                    self._conns.append(conn)
        except socket.timeout:
            raise TimeoutError(
                f"plan bus: only {accepted}/{self.num_workers} "
                "workers connected before the accept timeout") from None

    def broadcast(self, op: str, statics: Optional[dict] = None,
                  arrays: Optional[dict] = None) -> None:
        data = _encode(op, statics or {}, arrays or {})
        if not self.pipelined:
            with self._lock:
                if self._closed:
                    raise PlanBusClosed("plan bus closed", clean=True)
                for conn in self._conns:
                    conn.sendall(data)
            return
        t0 = time.monotonic()
        with self._send_cond:
            if self._sender_stop:
                raise PlanBusClosed("plan bus closed", clean=True)
            if self._send_error is not None:
                raise PlanBusClosed(
                    f"plan bus sender died: {self._send_error}",
                    clean=False)
            self._sendq.append(data)
            self._stat_broadcasts += 1
            self._stat_bytes += len(data)
            self._stat_max_depth = max(self._stat_max_depth,
                                       len(self._sendq))
            self._send_cond.notify()
            self._stat_enqueue_s += time.monotonic() - t0

    def _drain_sender(self, timeout: float = 10.0) -> None:
        """Flush queued frames, then stop the sender thread (``bye``
        below must be the LAST frame on every worker's stream)."""
        deadline = time.monotonic() + timeout
        with self._send_cond:
            while self._sendq and self._send_error is None \
                    and time.monotonic() < deadline:
                self._send_cond.wait(0.1)
            self._sender_stop = True
            self._send_cond.notify_all()
        if self._sender is not None:
            self._sender.join(timeout=5)

    def close(self) -> None:
        if self.pipelined:
            self._drain_sender()
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for conn in self._conns:
                try:
                    conn.sendall(_encode(OP_BYE, {}, {}))
                except OSError:
                    pass  # worker already gone; the gang policy covers it
                try:
                    conn.close()
                except OSError:
                    pass
            self._conns = []
            try:
                self._listener.close()
            except OSError:
                pass


class PlanFollower:
    """Worker side: one blocking connection to the chief's bus.

    ``recv()`` returns ``(op, statics, arrays)`` in stream order;
    raises :class:`PlanBusClosed` with ``clean=True`` on ``bye`` and
    ``clean=False`` when the stream dies (chief crash) — the worker
    main converts the latter into a NONZERO exit so the gang supervisor
    restarts the whole serving gang instead of leaving orphans parked
    inside a collective."""

    def __init__(self, host: str, port: int, connect_timeout: float = 120.0,
                 retry_interval: float = 0.1):
        import time as _time

        deadline = _time.monotonic() + connect_timeout
        last: Optional[Exception] = None
        self._sock: Optional[socket.socket] = None
        while _time.monotonic() < deadline:
            try:
                self._sock = socket.create_connection(
                    (host, port), timeout=connect_timeout)
                break
            except OSError as e:  # chief still binding: retry
                last = e
                _time.sleep(retry_interval)
        if self._sock is None:
            raise ConnectionError(
                f"plan bus: could not reach chief at {host}:{port}: {last}")
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.settimeout(None)  # steady state blocks on the stream

    def recv(self) -> tuple[str, dict, dict]:
        op, statics, arrays = _decode(self._sock)
        if op == OP_BYE:
            raise PlanBusClosed("chief said bye", clean=True)
        return op, statics, arrays

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
