"""The attribution of the card's idle gaps and busy time to the engine
phase ledger's records (``portbench/attribution.py``), on synthetic
intervals and on a CPU trace."""

from __future__ import annotations

import pytest
import torch

from portbench import attribution

US = 1_000  # ns


def _ph(phase, t_us, dur_us, **fields):
    return dict(phase=phase, t_ns=t_us * US, dur_ns=dur_us * US, **fields)


# admit [0, 100) us, decode_issue [100, 300), decode_read [300, 400);
# nothing recorded from 400 us on
PHASES = [_ph("admit", 0, 100), _ph("decode_issue", 100, 200, seq=1, k=4),
          _ph("decode_read", 300, 100, seq=1, k=4)]


def test_a_gap_split_across_two_phases():
    busy = [[0, 50 * US], [150 * US, 350 * US]]
    # the gap (50, 150) us: 50 in admit, 50 in decode_issue
    got = attribution.by_phase(busy, PHASES)
    assert got["idle_s"] == pytest.approx(100e-6)
    assert got["idle"] == pytest.approx({"admit": 50e-6,
                                         "decode_issue": 50e-6})
    assert got["idle_outside_s"] == 0
    assert got["busy_s"] == pytest.approx(250e-6)
    assert got["busy"] == pytest.approx({"admit": 50e-6,
                                         "decode_issue": 150e-6,
                                         "decode_read": 50e-6})
    # step 1 spans [100, 400) us, the trace [0, 350): 250 of its 300 us,
    # so that share of its 4 iterations
    assert got["decode_busy_s"] == pytest.approx(200e-6)
    assert got["decode_iterations"] == pytest.approx(4 * 250 / 300)
    assert got["prefill_busy_s"] == 0 and got["prefill_tokens"] == 0


def test_a_gap_in_no_phase_and_gaps_under_10_us():
    busy = [[200 * US, 205 * US], [212 * US, 390 * US],
            [395 * US, 420 * US], [500 * US, 600 * US]]
    got = attribution.by_phase(busy, PHASES)
    # 7 us and 5 us gaps are launch latency; (420, 500) lies past every
    # record
    assert got["idle_s"] == pytest.approx(80e-6)
    assert got["idle"] == {}
    assert got["idle_outside_s"] == pytest.approx(80e-6)
    # the trace [200, 600) covers [200, 400) of step 1's [100, 400)
    assert got["decode_busy_s"] == pytest.approx(188e-6)
    assert got["decode_iterations"] == pytest.approx(4 * 2 / 3)


def test_gaps_against_unsorted_records_and_no_busy_time():
    got = attribution.by_phase([], list(reversed(PHASES)))
    assert got["idle_s"] == 0 and got["busy_s"] == 0
    assert got["decode_iterations"] == 0 and got["prefill_tokens"] == 0
    busy = [[0, 10 * US], [390 * US, 400 * US]]
    got = attribution.by_phase(busy, list(reversed(PHASES)))
    assert sum(got["idle"].values()) == pytest.approx(got["idle_s"])
    assert got["idle"] == pytest.approx({
        "admit": 90e-6, "decode_issue": 200e-6, "decode_read": 90e-6})


def test_busy_time_by_step_and_by_prefill():
    """Steps and prefills are units by ``seq`` and ``rid``: one the trace
    covers whole counts its iterations or tokens whole, one it misses
    counts nothing; busy time in other phases counts for neither."""
    phases = [_ph("prefill_issue", 0, 100, rid=7, tokens=1000),
              _ph("prefill_read", 100, 400, rid=7, tokens=1000),
              _ph("admit", 500, 100, rid=7),
              _ph("decode_plan", 600, 10, seq=2, k=2),
              _ph("decode_issue", 610, 290, seq=2, k=2),
              _ph("decode_read", 900, 100, seq=2, k=2),
              _ph("decode_issue", 2000, 100, seq=3, k=1),
              _ph("decode_read", 2100, 100, seq=3, k=1)]
    busy = [[0, 450 * US], [520 * US, 580 * US], [700 * US, 1000 * US]]
    got = attribution.by_phase(busy, phases)
    assert got["prefill_busy_s"] == pytest.approx(450e-6)
    assert got["prefill_tokens"] == pytest.approx(1000)
    assert got["decode_busy_s"] == pytest.approx(300e-6)
    assert got["decode_iterations"] == pytest.approx(2)
    assert got["busy"]["admit"] == pytest.approx(60e-6)


def test_a_cpu_trace_has_no_busy_interval():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(64).sum()
    busy = attribution.busy_intervals(prof)
    assert busy == []
    got = attribution.by_phase(busy, PHASES)
    assert got["idle_s"] == 0 and got["busy"] == {}
