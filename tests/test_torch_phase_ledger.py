"""The engine's phase ledger (k8s_tpu_torch/models/requestlog.py, written
by models/engine.py) on a tiny CPU engine: the records of a run cut the
engine thread's loop into consecutive phases with no gap and no overlap,
the step ledger keeps its records and its bracket (a step's ``dur_s`` is
its ``decode_issue`` plus its ``decode_read``), nothing is recorded with
no recorder active, and ``/debug/engine`` serves the phase rollup.  Every
wait carries a timeout and every engine is shut down."""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest
import torch

from k8s_tpu_torch.models import bridge, requestlog
from k8s_tpu_torch.models.engine import Engine
from k8s_tpu_torch.models.transformer import TransformerConfig
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

WAIT = 60
SHAPE = dict(vocab_size=61, hidden=32, ffn_hidden=64, layers=2, heads=4,
             kv_heads=4, max_seq_len=64, remat=False)
# paged (with a prefix tree) and windowed (dense rows) engines
SETUPS = {"paged": ({}, dict(block_size=8, prefix_blocks=24)),
          "window": (dict(window_size=8, prefill_chunk=4), {})}
STEP_KEYS = {"seq", "active", "width", "spec_group", "tokens", "dur_s", "t"}


@pytest.fixture(scope="module")
def sd():
    return bridge.init_params(TransformerConfig(dtype=torch.float32,
                                                **SHAPE), 0, "cpu")


@pytest.fixture()
def recorded(sd):
    """``recorded(setup, work)``: a recorder made active, an engine built
    under it, ``work(engine)`` run, the engine shut down; returns the
    recorder."""
    def run(setup, work):
        rec = requestlog.RequestRecorder()
        requestlog.set_active(rec)
        try:
            extra, kw = SETUPS[setup]
            eng = Engine(TransformerConfig(dtype=torch.float32, **SHAPE,
                                           **extra),
                         sd, slots=2, queue_limit=32, device="cpu", **kw)
            try:
                work(eng)
            finally:
                eng.shutdown()
        finally:
            requestlog.set_active(None)
        return rec
    return run


def _traffic(eng, speculative=0):
    """More requests than slots at once, then an exclusive request and a
    request that retires at its first token."""
    def one(i):
        out[i] = eng.submit(np.arange(5 + 4 * i) % 61, 3 + 2 * i,
                            speculative=speculative if i % 2 else 0,
                            timeout=WAIT)
    out = [None] * 4
    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads), "a request hung"
    assert all(out)
    assert eng.submit_exclusive(lambda: [1], timeout=WAIT) == [1]
    assert len(eng.submit(np.arange(9), 1, timeout=WAIT)) == 1


@pytest.mark.parametrize("setup", sorted(SETUPS))
def test_phases_partition_the_loop_wall(recorded, setup):
    rec = recorded(setup, _traffic)
    recs = rec.engine_phases(limit=-1)
    assert recs and {r["phase"] for r in recs} >= {
        "admit", "prefill_issue", "prefill_read", "decode_plan",
        "decode_issue", "decode_read", "retire", "exclusive"}
    assert {r["phase"] for r in recs} <= set(requestlog.ENGINE_PHASES)
    for a, b in zip(recs, recs[1:]):
        assert a["dur_ns"] >= 0
        assert a["t_ns"] + a["dur_ns"] == b["t_ns"], (a, b)
    wall = recs[-1]["t_ns"] + recs[-1]["dur_ns"] - recs[0]["t_ns"]
    assert sum(r["dur_ns"] for r in recs) == pytest.approx(wall, rel=0.01)
    for r in recs:
        if r["phase"].startswith("decode") or r["phase"] == "retire":
            assert r["seq"] >= 1 and r["k"] >= 1, r
        if r["phase"].startswith("prefill"):
            assert r["rid"] >= 1 and r["tokens"] >= 1, r
    rollup = rec.phase_rollup()
    assert rollup["records"] == len(recs)
    assert rollup["wall_s"] == pytest.approx(wall / 1e9, abs=1e-6)
    assert sum(p["share"] for p in rollup["phases"].values()) == \
        pytest.approx(1.0, abs=0.01)


@pytest.mark.parametrize("speculative", [0, 3])
def test_step_ledger_keeps_its_records_and_bracket(recorded, speculative):
    rec = recorded("paged", lambda eng: _traffic(eng, speculative))
    steps = rec.engine_steps(limit=-1)
    assert steps and all(set(s) == STEP_KEYS for s in steps)
    if speculative:
        assert any(s["spec_group"] for s in steps)
    phases = {}
    for r in rec.engine_phases(limit=-1):
        if r["phase"] in ("decode_issue", "decode_read"):
            phases.setdefault(r["seq"], {})[r["phase"]] = r["dur_ns"]
    assert sorted(phases) == [s["seq"] for s in steps]
    for s in steps:
        p = phases[s["seq"]]
        assert s["dur_s"] == pytest.approx(
            (p["decode_issue"] + p["decode_read"]) / 1e9, abs=1e-6)


def test_no_recorder_records_nothing(sd, monkeypatch):
    monkeypatch.delenv("K8S_TPU_REQUEST_LOG", raising=False)
    requestlog.set_active(None)
    eng = Engine(TransformerConfig(dtype=torch.float32, **SHAPE), sd,
                 slots=2, queue_limit=32, device="cpu")
    late = requestlog.RequestRecorder()
    try:
        assert eng._reqlog is None
        requestlog.set_active(late)
        _traffic(eng)
    finally:
        eng.shutdown()
        requestlog.set_active(None)
    assert late.engine_phases(limit=-1) == []
    assert late.phase_rollup()["records"] == 0


def test_debug_engine_serves_the_phase_rollup(recorded):
    seen = {}

    def work(eng):
        _traffic(eng)
        seen["response"] = requestlog.debug_engine_response("n=4")
    recorded("paged", work)
    code, body, ctype = seen["response"]
    assert code == 200 and ctype == "application/json"
    rollup = json.loads(body)["phase_rollup"]
    assert set(rollup["phases"]) == set(requestlog.ENGINE_PHASES)
    assert rollup["records"] > 0 and rollup["wall_s"] > 0
    assert rollup["phases"]["decode_issue"]["s"] > 0
    assert all(set(p) == {"s", "share"} for p in rollup["phases"].values())


@pytest.mark.parametrize("setup, speculative",
                         [("paged", 0), ("paged", 3), ("window", 0)])
def test_a_step_splits_where_its_body_reads(recorded, setup, speculative):
    """The last step's ``decode_issue`` ends, and its ``decode_read``
    starts, at the clock its body (``paged_step``, ``spec_step`` or
    ``dense_step``) read where its host read began."""
    seen = {}

    def work(eng):
        _traffic(eng, speculative)
        seen["read_ns"] = eng._compute.read_ns
    rec = recorded(setup, work)
    recs = rec.engine_phases(limit=-1)
    read = [r for r in recs if r["phase"] == "decode_read"][-1]
    issue = [r for r in recs if r["phase"] == "decode_issue"][-1]
    assert read["t_ns"] == seen["read_ns"] > issue["t_ns"]
    assert issue["t_ns"] + issue["dur_ns"] == read["t_ns"]
