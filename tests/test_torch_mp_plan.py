"""The port's plan bus (k8s_tpu_torch/models/mp_plan.py) against the JAX
package's (k8s_tpu/models/mp_plan.py) on the wire.

The framing must be byte for byte the reference's: the same op, statics
and arrays encode to the same bytes, and each side's follower decodes the
other side's bus, inline and pipelined.  Then the port's own contract: a
clean bye against a dead chief (the ``clean`` flag the follower turns into
its exit code), strict message order, the pipelined sender's counters,
and a refused connect that raises in the end.
"""

from __future__ import annotations

import socket
import threading

import numpy as np
import pytest

from k8s_tpu.models import mp_plan as ref_plan
from k8s_tpu_torch.models import mp_plan

MESSAGES = {
    "paged_step": ("paged_step", {"k": 4, "width": 3},
                   {"ints": np.arange(8, dtype=np.int64).reshape(2, 4)}),
    "spec_step": ("spec_step", {"k": 3, "width": 2},
                  {"chunk": np.arange(12, dtype=np.int64).reshape(4, 3),
                   "ints": np.array([[5, -1, 7, -1], [3, 1, 1, 1]],
                                    np.int64)}),
    "keys_f32": ("paged_step", {"k": 2, "sampling": True},
                 {"keys": np.arange(8, dtype=np.uint32).reshape(4, 2),
                  "temps": np.array([0.0, 1.0, 0.7, 0.0], np.float32)}),
    "cow": ("cow", {}, {"src": np.int32(3), "dst": np.int32(7)}),
    "init": ("init", {"pool": [[["layer_0", "attn", "k"], "float32",
                                [9, 4, 2, 8]]]}, {}),
    "empty_array": ("tables", {}, {"tables": np.zeros((0, 3), np.int32)}),
    "bye": ("bye", {}, {}),
}


@pytest.mark.parametrize("name", sorted(MESSAGES))
def test_encode_is_the_references_bytes(name):
    op, statics, arrays = MESSAGES[name]
    assert mp_plan._encode(op, statics, arrays) == \
        ref_plan._encode(op, statics, arrays)


def _connect(bus_mod, follower_mod, pipelined):
    bus = bus_mod.PlanBus(num_workers=1, pipelined=pipelined)
    box = {}
    t = threading.Thread(target=lambda: box.update(
        f=follower_mod.PlanFollower("127.0.0.1", bus.port)))
    t.start()
    bus.accept_workers()
    t.join(30)
    assert not t.is_alive(), "the follower never connected"
    # a recv that never returns fails the test instead of hanging it
    box["f"]._sock.settimeout(30)
    return bus, box["f"]


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["inline", "pipelined"])
@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_each_side_decodes_the_other(direction, pipelined):
    bus_mod, follower_mod = (mp_plan, ref_plan) if direction == \
        "port_to_ref" else (ref_plan, mp_plan)
    bus, f = _connect(bus_mod, follower_mod, pipelined)
    try:
        sent = [MESSAGES[n] for n in ("paged_step", "spec_step",
                                      "keys_f32", "cow", "init",
                                      "empty_array")]
        for op, statics, arrays in sent:
            bus.broadcast(op, statics, arrays)
        for op, statics, arrays in sent:
            got_op, got_statics, got_arrays = f.recv()
            assert (got_op, got_statics) == (op, statics)
            assert set(got_arrays) == set(arrays)
            for k, v in arrays.items():
                np.testing.assert_array_equal(got_arrays[k], v)
                assert got_arrays[k].dtype == np.asarray(v).dtype
        bus.close()
        with pytest.raises(follower_mod.PlanBusClosed) as ei:
            f.recv()
        assert ei.value.clean
    finally:
        bus.close()
        f.close()


def test_clean_bye_against_a_dead_chief():
    """The gang contract at the socket layer: ``bye`` raises clean=True
    (the follower exits 0); an EOF without one raises clean=False (the
    follower exits non-zero and the gang restarts whole)."""
    bus, f = _connect(mp_plan, mp_plan, False)
    bus.close()
    with pytest.raises(mp_plan.PlanBusClosed) as ei:
        f.recv()
    assert ei.value.clean
    f.close()
    bus, f = _connect(mp_plan, mp_plan, False)
    for conn in bus._conns:  # the crash: sockets die with no bye
        conn.close()
    bus._listener.close()
    with pytest.raises(mp_plan.PlanBusClosed) as ei:
        f.recv()
    assert not ei.value.clean
    f.close()


def test_order_and_pipelined_counters():
    bus, f = _connect(mp_plan, mp_plan, True)
    try:
        for i in range(20):
            bus.broadcast("cow", {}, {"src": np.int32(i),
                                      "dst": np.int32(i + 1)})
        assert [f.recv()[2]["src"].item() for _ in range(20)] == \
            list(range(20))
        bus.close()
        st = bus.stats()
        assert st["pipelined"] and st["broadcasts"] == 20
        assert st["bytes"] == 20 * len(mp_plan._encode(
            "cow", {}, {"src": np.int32(0), "dst": np.int32(1)}))
        assert st["send_error"] is None and st["send_s"] >= 0
        with pytest.raises(mp_plan.PlanBusClosed):
            bus.broadcast("cow", {}, {})
    finally:
        bus.close()
        f.close()


def test_follower_connect_refused_eventually_raises():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with pytest.raises(ConnectionError):
        mp_plan.PlanFollower("127.0.0.1", port, connect_timeout=0.5,
                             retry_interval=0.1)


def test_oversized_array_is_refused():
    with pytest.raises(ValueError, match="too large"):
        mp_plan._encode("tables", {}, {"t": np.zeros(
            mp_plan.MAX_ARRAY_BYTES + 1, np.uint8)})
