"""Which phase of the serving engine's thread the card's idle and busy
time falls in: the device's busy intervals in a profiler trace,
intersected with the engine's phase ledger (``models/requestlog.py``:
records of ``phase``, ``t_ns``, ``dur_ns``), both on ``time.time_ns()``'s
clock.  The gaps are those ``common.profile_summary`` names: between
consecutive merged busy intervals, of at least ``common.SHORT_GAP_NS``.

No driver calls it yet: the serving driver keeps neither the phase
records nor the raw trace in its record (PERF.md §7 has the lines it
would take)."""

from __future__ import annotations

import bisect

from portbench import common

# the phases in which the engine thread runs host code while the card
# may wait on it (the others block on the card, or on no work)
HOST_PHASES = ("admit", "prefill_issue", "decode_plan", "decode_issue",
               "retire")
# a decode step's records from its issue to the end of its read (the
# step ledger's bracket), and a prefill's from its chunks' issue to the
# end of its first token's read: the card's work for each lies inside
DECODE_PHASES = ("decode_issue", "decode_read")
PREFILL_PHASES = ("prefill_issue", "prefill_read")


def busy_intervals(prof) -> list:
    """The merged ``[start, end]`` ns of device activity in a
    ``torch.profiler`` trace, by ``common.profile_summary``'s rule: device
    events of positive length, user annotations left out."""
    from torch._C._autograd import DeviceType

    dev = []
    for e in prof.profiler.kineto_results.events():
        dur = e.duration_ns()
        if e.device_type() == DeviceType.CUDA and dur > 0 \
                and not e.is_user_annotation():
            dev.append((e.start_ns(), e.start_ns() + dur))
    return common._union(dev)


def _overlap(intervals, phases) -> tuple[list, int]:
    """Nanoseconds of ``intervals`` inside each record of ``phases``
    (ascending by ``t_ns``, disjoint), and outside every record."""
    starts = [p["t_ns"] for p in phases]
    inside = [0] * len(phases)
    outside = 0
    for a, b in intervals:
        covered = 0
        j = max(0, bisect.bisect_right(starts, a) - 1)
        while j < len(phases) and phases[j]["t_ns"] < b:
            p = phases[j]
            lo, hi = max(a, p["t_ns"]), min(b, p["t_ns"] + p["dur_ns"])
            if hi > lo:
                inside[j] += hi - lo
                covered += hi - lo
            j += 1
        outside += b - a - covered
    return inside, outside


def _by_name(phases, ns) -> dict:
    out: dict[str, float] = {}
    for p, v in zip(phases, ns):
        if v:
            out[p["phase"]] = out.get(p["phase"], 0.0) + v / 1e9
    return dict(sorted(out.items()))


def _units(phases, work, names, key, size, extent) -> tuple[float, float]:
    """The busy seconds ``work`` inside the records named ``names``,
    grouped into units by ``key`` (a step's ``seq``, a prefill's
    ``rid``), and the units' summed ``size`` (iterations, tokens), each
    unit's weighted by the share of its span, from its first record's
    start to its last one's end, that lies in ``extent`` (the trace's)."""
    spans: dict = {}
    seconds = 0.0
    for p, w in zip(phases, work):
        if p["phase"] in names:
            a, b, n = spans.get(p[key], (p["t_ns"], 0, p[size]))
            spans[p[key]] = (a, p["t_ns"] + p["dur_ns"], n)
            seconds += w / 1e9
    total = 0.0
    for a, b, n in spans.values():
        cover = min(b, extent[1]) - max(a, extent[0])
        if cover > 0:
            total += n * cover / (b - a)
    return seconds, total


def by_phase(busy, phases, short_gap_ns: int = common.SHORT_GAP_NS) -> dict:
    """The device's idle gaps of at least ``short_gap_ns`` between the
    merged ``busy`` intervals, and its busy time, split over the phase
    records by overlap, in seconds: ``idle_s`` (every such gap),
    ``idle`` (by phase), ``idle_outside_s`` (in no record), ``busy_s``,
    ``busy`` (by phase); and the busy time inside the decode steps'
    ``DECODE_PHASES`` over their iterations (``decode_busy_s``,
    ``decode_iterations``) and inside the prefills' ``PREFILL_PHASES``
    over their prompt tokens (``prefill_busy_s``, ``prefill_tokens``),
    a step or prefill the trace covers in part counted by the share
    covered."""
    phases = sorted(phases, key=lambda p: p["t_ns"])
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])
            if s1 - e0 >= short_gap_ns]
    idle, idle_out = _overlap(gaps, phases)
    work, _ = _overlap(busy, phases)
    extent = (busy[0][0], busy[-1][1]) if busy else (0, 0)
    decode = _units(phases, work, DECODE_PHASES, "seq", "k", extent)
    prefill = _units(phases, work, PREFILL_PHASES, "rid", "tokens", extent)
    return {"idle_s": sum(b - a for a, b in gaps) / 1e9,
            "idle": _by_name(phases, idle),
            "idle_outside_s": idle_out / 1e9,
            "busy_s": sum(b - a for a, b in busy) / 1e9,
            "busy": _by_name(phases, work),
            "decode_busy_s": decode[0], "decode_iterations": decode[1],
            "prefill_busy_s": prefill[0], "prefill_tokens": prefill[1]}

