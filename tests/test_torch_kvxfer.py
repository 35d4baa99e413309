"""The port's kv-transfer plane (k8s_tpu_torch/models/kvxfer.py) against
the JAX package's (k8s_tpu/models/kvxfer.py), on the CPU over real
sockets: frames byte for byte the reference's (a bf16 array included),
each side reading the other's frames, and whole conversations with the
port on one end and the reference on the other — migrate / seated /
tokens, offer / need with ``skip``, the ``dedup_stale`` re-send, fetch /
blocks (hit and miss), typed refusals and the legacy-peer fallback — with
a stub engine seam.  Truncated or garbage streams raise ``KvPeerGone``
and the accept loop keeps serving.  Neither module imports JAX, and the
port's reads a bf16 frame in an interpreter where ml_dtypes cannot be
imported."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading

import ml_dtypes
import numpy as np
import pytest

from k8s_tpu.models import kvxfer as ref
from k8s_tpu_torch.models import kvtier
from k8s_tpu_torch.models import kvxfer as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = {"port_to_ref": (port, ref), "ref_to_port": (ref, port),
         "port_to_port": (port, port)}


def _payload(bf16: bool, n_blocks=3, bs=4, seed=0):
    """A migrate frame's statics and arrays in both packages' host forms
    (the reference's bf16 is ml_dtypes', the port's its bits)."""
    rng = np.random.default_rng(seed)
    statics = {"v": ref.PROTOCOL_VERSION, "wire_int8": False,
               "trace_id": None,
               "req": {"first": 7, "max_new_tokens": 8, "eos": None,
                       "temperature": 0.0, "top_k": None,
                       "speculative": 0, "block_size": bs}}
    kv = rng.standard_normal((2, n_blocks, bs, 2, 8)).astype(np.float32)
    common = {"ids": np.arange(n_blocks * bs, dtype=np.int32),
              "key": np.arange(16, dtype=np.uint8)}
    if not bf16:
        arrays = {**common, "blk/layer_0/attn/k": kv[0],
                  "blk/layer_0/attn/v": kv[1]}
        return statics, arrays, arrays
    j = {**common, "blk/layer_0/attn/k": kv[0].astype(ml_dtypes.bfloat16),
         "blk/layer_0/attn/v": kv[1].astype(ml_dtypes.bfloat16)}
    t = {n: (a.view(np.uint16).view(kvtier.BF16)
             if a.dtype == ml_dtypes.bfloat16 else a) for n, a in j.items()}
    return statics, j, t


def _same(a, b):
    """Two arrays hold the same bytes, shape and wire dtype name."""
    return (a.shape == b.shape and a.tobytes() == b.tobytes()
            and kvtier.dtype_name(a.dtype) == str(b.dtype)
            if b.dtype == ml_dtypes.bfloat16 else
            a.shape == b.shape and a.tobytes() == b.tobytes()
            and str(a.dtype) == str(b.dtype))


def _read(mod, data: bytes):
    a, b = socket.socketpair()
    try:
        a.sendall(data)
        return mod.read_frame(b)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_migrate_frame_is_the_references(bf16):
    statics, j, t = _payload(bf16)
    data = port.encode_frame(port.OP_MIGRATE, statics, t)
    assert data == ref.encode_frame(ref.OP_MIGRATE, statics, j)
    # each side reads the other's frame
    op, st, arr = _read(port, ref.encode_frame(ref.OP_MIGRATE, statics, j))
    assert op == "migrate" and st == statics
    for name in j:
        assert _same(arr[name], j[name]), name
    if bf16:
        assert arr["blk/layer_0/attn/k"].dtype == kvtier.BF16
        assert arr["blk/layer_0/attn/k"].flags.writeable
    op, st, arr = _read(ref, data)
    assert op == "migrate" and st == statics
    for name in j:
        assert arr[name].dtype == j[name].dtype
        assert arr[name].tobytes() == j[name].tobytes(), name


@pytest.mark.parametrize("op,statics", [
    ("seated", {"blocks": 3}), ("tokens", {"tokens": [1, 2, 3]}),
    ("error", {"error": "x", "kind": "pool_exhausted"}),
    ("offer", {"v": 1, "fps": ["a", "b"]}), ("need", {"have": 2}),
    ("blocks", {"n_blocks": 0}), ("fetch", {"v": 1})])
def test_small_frames_are_the_references(op, statics):
    arrays = {"ids": np.arange(5, dtype=np.int32)} if op == "fetch" else {}
    assert port.encode_frame(op, statics, arrays) == \
        ref.encode_frame(op, statics, arrays)


def test_port_reads_bf16_without_ml_dtypes():
    """The dtype table is the port's own: a clean interpreter in which
    importing ml_dtypes fails still reads a bf16 frame bit for bit."""
    _, j, _ = _payload(True)
    data = ref.encode_frame("migrate", {}, j)
    code = (
        "import sys; sys.modules['ml_dtypes'] = None\n"
        "import socket, numpy as np\n"
        "from k8s_tpu_torch.models import kvxfer, kvtier\n"
        "from k8s_tpu_torch.models.placement import host_tensor\n"
        "data = sys.stdin.buffer.read()\n"
        "a, b = socket.socketpair(); a.sendall(data); a.close()\n"
        "op, st, arr = kvxfer.read_frame(b)\n"
        "k = arr['blk/layer_0/attn/k']\n"
        "assert k.dtype == kvtier.BF16, k.dtype\n"
        "t = host_tensor(k)\n"
        "bad = [m for m, v in sys.modules.items() if v is not None "
        "and m.split('.')[0] in ('jax', 'ml_dtypes', 'k8s_tpu')]\n"
        "print(str(t.dtype), k.view(np.uint16).sum(), bad)\n")
    r = subprocess.run([sys.executable, "-c", code], input=data, cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, timeout=120)
    assert r.returncode == 0, r.stderr.decode()
    want = j["blk/layer_0/attn/k"].view(np.uint16).sum()
    assert r.stdout.decode().split() == ["torch.bfloat16", str(want), "[]"]


class _Seat:
    """A stub engine seam: records each seat, acks it, answers tokens;
    ``stale`` refuses the first deduplicated seat as the engine's
    DedupStale does."""

    def __init__(self, stale=False, refuse=None):
        self.calls: list = []
        self.stale = stale
        self.refuse = refuse

    def __call__(self, statics, arrays, on_seated):
        self.calls.append((statics, arrays))
        if self.refuse is not None:
            raise self.refuse
        if self.stale and statics.get("skip"):
            self.stale = False
            raise _Stale("evicted since the offer")
        on_seated()
        return [statics["req"]["first"], 11, 12]


class _Stale(RuntimeError):
    kind = "dedup_stale"


def _fetch_fn(statics, arrays):
    if int(arrays["ids"][0]) == 99:
        return None  # miss
    return ({"v": 1, "wire_int8": False, "n_blocks": 2, "block_size": 4},
            {"blk/layer_0/attn/k": np.ones((2, 4, 2, 8), np.float32)})


@pytest.fixture()
def peers():
    made = []

    def build(pair, **kw):
        smod, rmod = PAIRS[pair]
        rx = rmod.KvReceiver(kw.pop("seat", _Seat()), **kw)
        tx = smod.KvSender(reply_timeout_s=30)
        made.append((rx, tx))
        return rx, tx, f"127.0.0.1:{rx.port}"
    yield build
    for rx, tx in made:
        tx.close()
        # wake the reference's accept loop, which a close alone leaves
        # blocked until its stop() gives up waiting
        try:
            rx._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        rx.stop()


@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_migrate_conversation(peers, pair, bf16):
    smod, rmod = PAIRS[pair]
    seat = _Seat()
    rx, tx, dest = peers(pair, seat=seat)
    statics, j, t = _payload(bf16)
    sent = t if smod is port else j
    for _ in range(2):  # the second rides the pooled connection
        tokens, seated_s = tx.migrate(dest, statics, sent)
        assert tokens == [7, 11, 12] and seated_s >= 0
    st, got = seat.calls[-1]
    assert st == statics
    for name in j:
        assert got[name].tobytes() == j[name].tobytes(), name
    assert rx.stats()["migrations"] == 2 and rx.stats()["blocks_in"] == 6
    assert tx.stats()["migrations"] == 2
    assert tx.stats()["pooled_connections"] == 1


@pytest.mark.parametrize("pair", PAIRS)
def test_offer_need_ships_only_the_tail(peers, pair):
    smod, _ = PAIRS[pair]
    seat = _Seat()
    rx, tx, dest = peers(pair, seat=seat, index_fn=lambda fps: 2)
    statics, j, t = _payload(False)
    info: dict = {}
    tokens, _ = tx.migrate(dest, statics, t if smod is port else j,
                           fingerprints=["f0", "f1", "f2"], info=info)
    assert tokens == [7, 11, 12]
    st, got = seat.calls[-1]
    assert st["skip"] == 2
    assert got["blk/layer_0/attn/k"].shape[0] == 1
    assert got["blk/layer_0/attn/k"].tobytes() == \
        j["blk/layer_0/attn/k"][2:].tobytes()
    assert got["ids"].shape == j["ids"].shape  # ids and key ship whole
    assert info == {"skipped_blocks": 2,
                    "skipped_bytes": 2 * 2 * 4 * 2 * 8 * 4}
    assert rx.stats()["dedup_offers"] == 1
    assert rx.stats()["dedup_blocks_promised"] == 2
    assert tx.stats()["dedup_blocks_skipped"] == 2


@pytest.mark.parametrize("pair", PAIRS)
def test_dedup_stale_resends_the_full_chain(peers, pair):
    smod, _ = PAIRS[pair]
    seat = _Seat(stale=True)
    rx, tx, dest = peers(pair, seat=seat, index_fn=lambda fps: 1)
    statics, j, t = _payload(False)
    info: dict = {}
    tokens, _ = tx.migrate(dest, statics, t if smod is port else j,
                           fingerprints=["f0", "f1"], info=info)
    assert tokens == [7, 11, 12]
    assert [c[0].get("skip") for c in seat.calls] == [1, None]
    assert seat.calls[-1][1]["blk/layer_0/attn/k"].shape[0] == 3
    assert tx.stats()["dedup_stale"] == 1 and info["skipped_blocks"] == 0


@pytest.mark.parametrize("pair", PAIRS)
def test_legacy_peer_falls_back_once(peers, pair):
    """A receiver without the dedup seam answers an offer with the closed
    protocol's error: the sender memoizes it as legacy, reconnects and
    runs the classic migrate, and never offers it again."""
    smod, _ = PAIRS[pair]
    seat = _Seat()
    rx, tx, dest = peers(pair, seat=seat)  # index_fn None
    statics, j, t = _payload(False)
    for _ in range(2):
        tokens, _ = tx.migrate(dest, statics, t if smod is port else j,
                               fingerprints=["f0", "f1"])
        assert tokens == [7, 11, 12]
    assert tx.stats()["legacy_peers"] == 1
    assert rx.stats()["dedup_offers"] == 0
    assert all("skip" not in c[0] for c in seat.calls)


@pytest.mark.parametrize("pair", PAIRS)
def test_fetch_hit_and_miss(peers, pair):
    rx, tx, dest = peers(pair, fetch_fn=_fetch_fn)
    st, arr = tx.fetch(dest, {"v": 1},
                       {"ids": np.arange(12, dtype=np.int32)})
    assert st["n_blocks"] == 2
    assert np.array_equal(arr["blk/layer_0/attn/k"],
                          np.ones((2, 4, 2, 8), np.float32))
    st, arr = tx.fetch(dest, {"v": 1},
                       {"ids": np.full(12, 99, np.int32)})
    assert st == {"n_blocks": 0} and arr == {}
    assert rx.stats()["fetches"] == 1
    assert rx.stats()["fetch_blocks_out"] == 2


@pytest.mark.parametrize("pair", PAIRS)
def test_fetch_from_a_peer_without_the_seam_is_protocol(peers, pair):
    smod, _ = PAIRS[pair]
    rx, tx, dest = peers(pair)
    with pytest.raises(smod.KvTransferError) as ei:
        tx.fetch(dest, {"v": 1}, {"ids": np.arange(4, dtype=np.int32)})
    assert ei.value.kind == "protocol"


@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("exc,kind", [
    (None, "pool_exhausted"), (ValueError("bad"), "bad_request"),
    (RuntimeError("boom"), "error")], ids=["pool", "value", "other"])
def test_typed_refusal_travels(peers, pair, exc, kind):
    smod, _ = PAIRS[pair]
    if exc is None:
        from k8s_tpu_torch.models.engine import PoolExhausted
        exc = PoolExhausted(5, 2)
    rx, tx, dest = peers(pair, seat=_Seat(refuse=exc))
    statics, j, t = _payload(False)
    with pytest.raises(smod.KvTransferError) as ei:
        tx.migrate(dest, statics, t if smod is port else j)
    assert ei.value.kind == kind
    assert rx.stats()["errors"] == 1


def test_dead_peer_is_peer_gone():
    tx = port.KvSender(connect_timeout_s=2)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = s.getsockname()[1]
    s.close()
    statics, _, t = _payload(False)
    with pytest.raises(port.KvPeerGone):
        tx.migrate(f"127.0.0.1:{dead}", statics, t)


@pytest.mark.parametrize("junk", [
    b"\x00\x00\x01",                                     # truncated length
    (1 << 25).to_bytes(4, "big") + b"x" * 64,            # huge header
    (15).to_bytes(4, "big") + b"not json at all",        # bad json
    (40).to_bytes(4, "big") + b'{"op": "migrate", "arrays": [["a", "no'
    b'pe", [1]]]}'[:40],                                 # bad dtype
], ids=["truncated", "huge", "json", "dtype"])
def test_garbage_is_peer_gone_and_accept_loop_survives(junk):
    a, b = socket.socketpair()
    try:
        a.sendall(junk)
        a.close()
        with pytest.raises(port.KvPeerGone):
            port.read_frame(b)
    finally:
        b.close()
    seat = _Seat()
    rx = port.KvReceiver(seat)
    try:
        c = socket.create_connection(("127.0.0.1", rx.port))
        c.sendall(junk)
        c.close()
        tx = port.KvSender(reply_timeout_s=30)
        statics, _, t = _payload(False)
        assert tx.migrate(f"127.0.0.1:{rx.port}", statics, t)[0] == \
            [7, 11, 12]
        tx.close()
        deadline = threading.Event()
        for _ in range(100):
            if rx.stats()["peer_gone"] >= 1:
                break
            deadline.wait(0.02)
        assert rx.stats()["peer_gone"] >= 1
    finally:
        rx.stop()


@pytest.mark.parametrize("dest,ok", [
    ("10.0.0.1:8472", True), ("[::1]:1", True), ("host", False),
    (":80", False), ("h:x", False), ("h:0", False), ("h:65536", False)])
def test_parse_dest_as_the_reference(dest, ok):
    if ok:
        assert port.parse_dest(dest) == ref.parse_dest(dest)
    else:
        with pytest.raises(ValueError):
            port.parse_dest(dest)
        with pytest.raises(ValueError):
            ref.parse_dest(dest)


@pytest.mark.parametrize("env,val", [
    ("K8S_TPU_SERVE_ROLE", " Decode "), ("K8S_TPU_SERVE_ROLE", "other"),
    ("K8S_TPU_KVXFER_PORT", "9000"), ("K8S_TPU_KVXFER_PORT", "x"),
    ("K8S_TPU_KVXFER_PORT", "70000"), ("K8S_TPU_KVXFER_INT8", "yes"),
    ("K8S_TPU_KVXFER_INT8", "0"), ("K8S_TPU_KVXFER_DEDUP", "off"),
    ("K8S_TPU_KVXFER_DEDUP", "")])
def test_env_readers_as_the_reference(monkeypatch, env, val):
    monkeypatch.setenv(env, val)
    for name in ("env_role", "env_kvxfer_port", "env_kvxfer_int8",
                 "env_kvxfer_dedup"):
        assert getattr(port, name)() == getattr(ref, name)(), name
