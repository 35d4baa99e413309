"""Per-request serving observability: the serving-side analogue of
the control plane's flight recorder.

The port's own copy of ``k8s_tpu/models/requestlog.py`` (stdlib only, so
it is copied rather than imported), with its lock a plain
``threading.Lock`` and its nearest-rank quantile the port's own
``util.util.quantile_nearest`` (the one the bench harnesses use); keep
the two in step.  The phase ledger is the port's own: the reference
has none.

Three bounded instruments behind one process-global recorder:

- a **request lifecycle recorder** — one timeline per generation
  request, from submit through shed/admission, prefill chunks (with the
  prefix-reuse outcome: hit / copy-on-write / miss, blocks attached,
  tokens saved), every decode step the slot participated in, block-pool
  evictions that touched the request, and the retire reason.  A
  finished timeline closes with a computed **dominant-phase
  attribution** — the phase that owned the largest share of the
  request's wall time — so "why was this request slow" is a lookup, not
  an investigation;
- an **engine step ledger** — one record per batched model call group
  (occupancy, fused width, tokens emitted, step wall time) in a bounded
  ring with windowed rollups (mean occupancy, tokens/s, step p50/p99);
- an **engine phase ledger** — the engine thread's loop cut into
  consecutive intervals, one record a phase (:data:`ENGINE_PHASES`),
  stamped with ``time.time_ns()``, the clock ``torch.profiler`` stamps
  its host events with, so a record lines up with a device trace, and
  rolled up into each phase's seconds and share of the loop's wall.
  The card's own time inside a phase is a trace's busy time over the
  phase's records (``portbench/attribution.py``).

Activation: ``K8S_TPU_REQUEST_LOG=1`` plus the
:func:`set_active`/:func:`active` process-global registry; a
zero-overhead no-op when unset (the engine binds ``maybe_active()`` at
construction and guards every call site on ``is None``).
``K8S_TPU_REQUEST_LOG_RING`` bounds the finished-request ring (default
512, oldest-finished evicted).

Served at ``/debug/requests`` (``?id=`` one full timeline with events,
``?slow=`` seconds filter, ``?phase=`` dominant-phase filter, ``?n=``
limit) and ``/debug/engine`` (``?n=`` recent step records + rollups,
and the phase ledger's rollup) on
the serving pod's HTTP server, 404 with an explicit body while no
recorder is active.  The recorder's lock is a leaf: it never calls back
into the engine, so it can be invoked from any engine code path.

The request phase set keeps the reference's, so the JSON has the
reference's schema.  The port's engine bills ``queue``, ``prefill``,
``decode``, ``spec_reject`` (its batched speculative lane records
``spec_chunk`` events), ``evict``, ``spill`` and ``promote`` (the host
KV tier) and, on a decode pod, ``migrate`` (:meth:`RequestRecorder.
migrated`, the graft of a received chain).  It never bills ``compile``
(eager PyTorch builds no program) and never calls ``migrate_send``.  A
``prefill_chunk`` event's seconds are the chunk's host issue; the
prefill's wait for the card is its ``prefill_read`` record in the phase
ledger.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Optional
from urllib.parse import parse_qs

from k8s_tpu_torch.util.util import quantile_nearest as _quantile


ENV_ENABLE = "K8S_TPU_REQUEST_LOG"
ENV_RING = "K8S_TPU_REQUEST_LOG_RING"

DEFAULT_MAX_REQUESTS = 512
DEFAULT_MAX_STEPS = 2048
DEFAULT_MAX_EVENTS_PER_REQUEST = 256

#: canonical phase order — also the tie-break order for the dominant-
#: phase attribution (earlier wins on equal seconds, so an all-zero
#: timeline attributes to "queue", the only phase every request has).
#: ``migrate`` is the disaggregated cross-pod hop: block
#: transfer on the prefill side, graft-and-seat on the decode side.
#: ``spill``/``promote`` are the host-RAM KV tier: demoting
#: evicted tree leaves to host buffers on this request's behalf, and
#: re-grafting spilled chain blocks back into the pool at attach time.
#: The spill span rides INSIDE the evict walk's wall span (the demote
#: happens mid-eviction), so those two phases deliberately overlap —
#: attribution names the tier, it does not partition wall time.
PHASES = ("queue", "prefill", "migrate", "decode", "spec_reject",
          "compile", "evict", "spill", "promote")


#: the engine thread's phases, in the order a loop pass meets them.
#: ``wait``: blocked on the engine's condition with no work.
#: ``admit``: the admission pop, prefix attach (copy-on-write and spill
#: promotion included), block allocation with its eviction and spill
#: walks, a decode step's table growth, and a prefill's seat after its
#: read (the prefix tree's insert, the first token's bookkeeping, an
#: export's gather or a retire at the first token).
#: ``prefill_issue``: building and issuing a prompt's chunks.
#: ``prefill_read``: the blocking read of its first token.
#: ``decode_plan``: building a step's per-row plan.
#: ``decode_issue``: the table upload and the step body's issue, up to
#: its host read (on a mesh placement the plan's broadcast too).
#: ``decode_read``: the blocking part of that read.
#: ``retire``: the step's token loop, retirements and recorder and
#: metric updates.
#: ``exclusive``: a request run whole on the engine thread (the
#: exclusive lane, a prefix fetch or import).
ENGINE_PHASES = ("wait", "admit", "prefill_issue", "prefill_read",
                 "decode_plan", "decode_issue", "decode_read", "retire",
                 "exclusive")


def _dominant(phase_s: dict) -> str:
    """Argmax phase with the canonical-order tie-break (earlier wins:
    an all-zero timeline attributes to "queue")."""
    return max(PHASES, key=lambda p: (phase_s[p], -PHASES.index(p)))


def enabled_from_env() -> bool:
    """K8S_TPU_REQUEST_LOG: truthy activates the recorder (default off
    — the zero-overhead compatibility default)."""
    return os.environ.get(ENV_ENABLE, "").lower() in ("1", "true", "on",
                                                      "yes")


def ring_from_env() -> int:
    """K8S_TPU_REQUEST_LOG_RING: finished-timeline ring bound (positive
    int; garbage and non-positive fall back to the default)."""
    try:
        n = int(os.environ.get(ENV_RING, ""))
    except ValueError:
        return DEFAULT_MAX_REQUESTS
    return n if n > 0 else DEFAULT_MAX_REQUESTS




class RequestRecorder:
    """Thread-safe bounded recorder of per-request serving timelines
    plus the engine step ledger.  Writers are the engine thread and the
    HTTP handler threads (submit/shed); readers are debug endpoints and
    bench rollups.  Methods never raise into the serving hot path."""

    def __init__(self, max_requests: Optional[int] = None,
                 max_steps: int = DEFAULT_MAX_STEPS,
                 max_events_per_request: int =
                 DEFAULT_MAX_EVENTS_PER_REQUEST):
        if max_requests is None:
            max_requests = ring_from_env()
        if max_requests < 1 or max_steps < 1 \
                or max_events_per_request < 1:
            raise ValueError("recorder bounds must be >= 1")
        self.max_requests = max_requests
        self.max_events_per_request = max_events_per_request
        self._lock = threading.Lock()
        self._next_id = 1
        self._live: dict[int, dict] = {}
        # finished timelines, oldest-finished evicted at max_requests
        self._done: "OrderedDict[int, dict]" = OrderedDict()
        self._evicted = 0
        self._shed_total = 0
        self._finished_total = 0
        # engine step ledger: bounded ring of per-program-call records
        self._steps: deque[dict] = deque(maxlen=max_steps)
        # engine phase ledger: a loop pass with a step writes ~6 records
        self._phases: deque[dict] = deque(maxlen=8 * max_steps)
        self._steps_total = 0
        self._tokens_total = 0
        self.created_at = time.time()

    # -- writers (engine / server) ------------------------------------

    def begin(self, prompt_len: Optional[int], max_new: int, *,
              temperature: float = 0.0, top_k: Optional[int] = None,
              speculative: int = 0, kind: str = "batched",
              trace_id: Optional[str] = None) -> int:
        """Open a timeline at submit time; returns the request id the
        engine threads through every later call."""
        entry = {
            "state": "live",
            "kind": kind,
            "wall_submit": round(time.time(), 3),
            "t_submit": time.monotonic(),
            "prompt_len": prompt_len,
            "max_new": max_new,
            "temperature": temperature,
            "top_k": top_k,
            "speculative": speculative,
            "trace_id": trace_id,
            "events": [],
            "events_dropped": 0,
            "phase_s": {p: 0.0 for p in PHASES},
            "queue_wait_s": None,
            "ttft_s": None,
            "tpot_s": None,
            "e2e_s": None,
            "tokens": 0,
            "steps": 0,
            "prefix": None,
            "spec": {"chunks": 0, "proposed": 0, "accepted": 0},
            # the prefill→decode hop: direction/blocks/peer,
            # None for requests that never migrated
            "migrate": None,
            "evictions": 0,
            # tiered KV hierarchy: blocks this request's
            # allocations demoted to the host spill tier, and spilled
            # blocks promoted back to the pool for its prefix attach
            "spilled": 0,
            "promoted": 0,
            "slot": None,
            "retire": None,
            "dominant_phase": None,
        }
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            entry["id"] = rid
            self._live[rid] = entry
        return rid

    def _event(self, entry: dict, kind: str, **attrs) -> None:
        # caller holds self._lock
        if len(entry["events"]) >= self.max_events_per_request:
            entry["events_dropped"] += 1
            return
        evt = {"t": round(time.monotonic() - entry["t_submit"], 6),
               "kind": kind}
        if attrs:
            evt.update(attrs)
        entry["events"].append(evt)

    def _phase(self, entry: dict, phase: str, seconds: float) -> None:
        entry["phase_s"][phase] += max(0.0, seconds)

    def shed(self, rid: Optional[int], depth: int, limit: int) -> None:
        """Admission-queue rejection: the timeline finishes immediately
        with retire reason ``shed`` and dominant phase ``queue``."""
        if rid is None:
            return
        with self._lock:
            entry = self._live.pop(rid, None)
            if entry is None:
                return
            self._event(entry, "shed", depth=depth, limit=limit)
            self._shed_total += 1
            self._finish_locked(entry, "shed")

    def admitted(self, rid: Optional[int], slot: int,
                 queue_wait_s: float) -> None:
        if rid is None:
            return
        with self._lock:
            entry = self._live.get(rid)
            if entry is None:
                return
            entry["slot"] = slot
            entry["queue_wait_s"] = round(queue_wait_s, 6)
            self._phase(entry, "queue", queue_wait_s)
            self._event(entry, "admitted", slot=slot,
                        queue_wait_s=round(queue_wait_s, 6))

    def prefix_outcome(self, rid: Optional[int], outcome: str,
                       blocks: int, tokens_saved: int) -> None:
        """The radix-tree result for this request's prompt: ``hit``
        (whole blocks attached by reference), ``cow`` (divergence block
        copy-on-written), or ``miss``."""
        if rid is None:
            return
        with self._lock:
            entry = self._live.get(rid)
            if entry is None:
                return
            entry["prefix"] = {"outcome": outcome, "blocks": blocks,
                               "tokens_saved": tokens_saved}
            self._event(entry, "prefix", outcome=outcome, blocks=blocks,
                        tokens_saved=tokens_saved)

    def prefill_chunk(self, rid: Optional[int], bucket: int,
                      dur_s: float, compiled: bool) -> None:
        """One chunked-prefill dispatch.  A chunk that compiled a fresh
        bucket program bills its wall time to ``compile``, not
        ``prefill`` — a compile stall mid-admission is its own phase."""
        if rid is None:
            return
        with self._lock:
            entry = self._live.get(rid)
            if entry is None:
                return
            self._phase(entry, "compile" if compiled else "prefill",
                        dur_s)
            self._event(entry, "prefill_chunk", bucket=bucket,
                        dur_s=round(dur_s, 6), compiled=compiled)

    def prefill_done(self, rid: Optional[int], total_s: float,
                     ttft_s: float) -> None:
        """Close the prefill span: any wall time the per-chunk dispatch
        records did not cover (device execution forced by the first-
        token sync) lands in ``prefill``."""
        if rid is None:
            return
        with self._lock:
            entry = self._live.get(rid)
            if entry is None:
                return
            covered = sum(e.get("dur_s", 0.0) for e in entry["events"]
                          if e["kind"] == "prefill_chunk")
            self._phase(entry, "prefill", total_s - covered)
            entry["ttft_s"] = round(ttft_s, 6)
            self._event(entry, "first_token",
                        ttft_s=round(ttft_s, 6))

    def convoy(self, rid: Optional[int], dur_s: float) -> None:
        """This request's decode-ready slot stalled behind ANOTHER
        request's prefill (the prefill convoy): the stall bills to the
        victim's ``prefill`` phase."""
        if rid is None:
            return
        with self._lock:
            entry = self._live.get(rid)
            if entry is None:
                return
            self._phase(entry, "prefill", dur_s)
            self._event(entry, "convoy", dur_s=round(dur_s, 6))

    def step(self, rid: Optional[int], seq: int, width: int,
             emitted: int, dur_s: float, *, compiled: bool = False,
             spec: bool = False, proposed: int = 0,
             accepted: int = 0) -> None:
        """One decode step this request's slot participated in.  Spec
        verify steps split their wall time between ``decode`` (accepted
        share) and ``spec_reject`` (rejected-draft share); a step that
        compiled a fresh program bills to ``compile`` instead."""
        if rid is None:
            return
        with self._lock:
            entry = self._live.get(rid)
            if entry is None:
                return
            entry["steps"] += 1
            entry["tokens"] += emitted
            if compiled:
                self._phase(entry, "compile", dur_s)
            elif spec and width > 0:
                reject_frac = max(0.0, (width - emitted) / width)
                self._phase(entry, "spec_reject", dur_s * reject_frac)
                self._phase(entry, "decode", dur_s * (1 - reject_frac))
            else:
                self._phase(entry, "decode", dur_s)
            if spec:
                entry["spec"]["chunks"] += 1
                entry["spec"]["proposed"] += proposed
                entry["spec"]["accepted"] += accepted
            self._event(entry, "spec_chunk" if spec else "step",
                        seq=seq, width=width, emitted=emitted,
                        dur_s=round(dur_s, 6),
                        **({"proposed": proposed, "accepted": accepted}
                           if spec else {}))

    def migrated(self, rid: Optional[int], blocks: int, dur_s: float,
                 peer: Optional[str] = None) -> None:
        """Decode-side half of the prefill→decode hop: the
        imported chain was grafted into the local pool and the request
        seated — the graft wall time bills to the ``migrate`` phase."""
        if rid is None:
            return
        with self._lock:
            entry = self._live.get(rid)
            if entry is None:
                return
            self._phase(entry, "migrate", dur_s)
            entry["migrate"] = {"direction": "in", "blocks": blocks,
                                "peer": peer}
            self._event(entry, "migrate_in", blocks=blocks,
                        dur_s=round(dur_s, 6),
                        **({"peer": peer} if peer else {}))

    def migrate_send(self, rid: Optional[int], blocks: int,
                     dur_s: float, dest: Optional[str] = None) -> None:
        """Prefill-side half of the hop: the block chain was shipped and
        the decode pod acked the seat — transfer wall time bills to
        ``migrate`` (the HTTP layer closes the timeline with retire
        reason ``migrated`` right after)."""
        if rid is None:
            return
        with self._lock:
            entry = self._live.get(rid)
            if entry is None:
                return
            self._phase(entry, "migrate", dur_s)
            entry["migrate"] = {"direction": "out", "blocks": blocks,
                                "peer": dest}
            self._event(entry, "migrate_out", blocks=blocks,
                        dur_s=round(dur_s, 6),
                        **({"dest": dest} if dest else {}))

    def evicted(self, rid: Optional[int], blocks: int,
                dur_s: float) -> None:
        """Block-pool allocation for this request had to evict prefix-
        tree leaves (the pool ran dry on its behalf)."""
        if rid is None:
            return
        with self._lock:
            entry = self._live.get(rid)
            if entry is None:
                return
            entry["evictions"] += blocks
            self._phase(entry, "evict", dur_s)
            self._event(entry, "evict", blocks=blocks,
                        dur_s=round(dur_s, 6))

    def spilled(self, rid: Optional[int], blocks: int,
                dur_s: float) -> None:
        """Block-pool allocation for this request demoted evicted tree
        leaves to the host spill tier instead of dropping
        them.  The span rides inside the evict walk's wall time — see
        the PHASES note on the deliberate overlap."""
        if rid is None:
            return
        with self._lock:
            entry = self._live.get(rid)
            if entry is None:
                return
            entry["spilled"] += blocks
            self._phase(entry, "spill", dur_s)
            self._event(entry, "spill", blocks=blocks,
                        dur_s=round(dur_s, 6))

    def promoted(self, rid: Optional[int], blocks: int,
                 dur_s: float) -> None:
        """Spilled chain blocks were re-grafted into the pool so this
        request's prompt attaches them as a tree hit — the
        gather/dequantize/graft wall time bills to ``promote``."""
        if rid is None:
            return
        with self._lock:
            entry = self._live.get(rid)
            if entry is None:
                return
            entry["promoted"] += blocks
            self._phase(entry, "promote", dur_s)
            self._event(entry, "promote", blocks=blocks,
                        dur_s=round(dur_s, 6))

    def retire(self, rid: Optional[int], reason: str,
               tokens: Optional[int] = None,
               ttft_s: Optional[float] = None) -> None:
        """Close the timeline (idempotent — a second retire of the same
        id is a no-op): stamps e2e, derives TPOT, computes the dominant
        phase, and moves the entry to the finished ring."""
        if rid is None:
            return
        with self._lock:
            entry = self._live.pop(rid, None)
            if entry is None:
                return
            if tokens is not None:
                entry["tokens"] = tokens
            if ttft_s is not None and entry["ttft_s"] is None:
                entry["ttft_s"] = round(ttft_s, 6)
            self._event(entry, "retire", reason=reason)
            self._finish_locked(entry, reason)

    def _finish_locked(self, entry: dict, reason: str) -> None:
        e2e = time.monotonic() - entry["t_submit"]
        entry["e2e_s"] = round(e2e, 6)
        entry["retire"] = reason
        entry["state"] = "done"
        if entry["ttft_s"] is not None and entry["tokens"] \
                and entry["tokens"] > 1:
            entry["tpot_s"] = round(
                (e2e - entry["ttft_s"]) / (entry["tokens"] - 1), 6)
        entry["phase_s"] = {p: round(s, 6)
                            for p, s in entry["phase_s"].items()}
        entry["dominant_phase"] = _dominant(entry["phase_s"])
        self._finished_total += 1
        self._done[entry["id"]] = entry
        while len(self._done) > self.max_requests:
            self._done.popitem(last=False)
            self._evicted += 1

    def engine_step(self, seq: int, active: int, width: int,
                    spec_group: int, tokens: int, dur_s: float) -> None:
        """One batched program call into the step ledger ring."""
        with self._lock:
            self._steps_total += 1
            self._tokens_total += tokens
            self._steps.append({
                "seq": seq, "active": active, "width": width,
                "spec_group": spec_group, "tokens": tokens,
                "dur_s": round(dur_s, 6),
                "t": round(time.monotonic(), 3),
            })

    def engine_phase(self, phase: str, t_ns: int, dur_ns: int,
                     **fields) -> None:
        """One interval of the engine thread into the phase ledger ring:
        ``phase`` (one of :data:`ENGINE_PHASES`) from ``t_ns``
        (``time.time_ns()``) for ``dur_ns``.  ``fields``: the step's
        ``seq`` and fused iterations ``k``, or the request's ``rid``; a
        prefill's ``tokens``."""
        rec = {"phase": phase, "t_ns": t_ns, "dur_ns": dur_ns, **fields}
        with self._lock:
            self._phases.append(rec)

    def clear(self) -> None:
        """Drop all data (bench warmup boundary); live ids stay valid —
        their in-flight entries are simply forgotten."""
        with self._lock:
            self._live.clear()
            self._done.clear()
            self._steps.clear()
            self._phases.clear()
            self._evicted = 0
            self._shed_total = 0
            self._finished_total = 0
            self._steps_total = 0
            self._tokens_total = 0

    # -- readers ------------------------------------------------------

    def request(self, rid: int) -> Optional[dict]:
        """One full timeline (events included), live or finished.  The
        copy is plain dict/list cloning, NOT a json round-trip: this
        lock is the one the decode loop contends on, and a debug poll
        must not stall in-flight steps for a serialization pass."""
        with self._lock:
            entry = self._live.get(rid) or self._done.get(rid)
            if entry is None:
                return None
            out = {k: (dict(v) if isinstance(v, dict) else v)
                   for k, v in entry.items() if k != "events"}
            out["events"] = [dict(e) for e in entry["events"]]
        return out

    @staticmethod
    def _summary(entry: dict, now: Optional[float] = None) -> dict:
        out = {k: entry[k] for k in (
            "id", "state", "kind", "wall_submit", "prompt_len",
            "max_new", "speculative", "trace_id", "queue_wait_s",
            "ttft_s", "tpot_s", "e2e_s", "tokens", "steps", "prefix",
            "spec", "migrate", "evictions", "spilled", "promoted",
            "slot", "retire", "dominant_phase")}
        out["phase_s"] = dict(entry["phase_s"])
        if out["dominant_phase"] is None:
            # provisional attribution for LIVE entries, so
            # ?slow=&phase= surfaces a currently-stuck request instead
            # of hiding it until it finishes: argmax over the phases
            # accrued so far; a still-queued entry (nothing accrued)
            # lands on "queue" via the tie-break — all its elapsed time
            # IS queue wait
            out["dominant_phase"] = _dominant(entry["phase_s"])
        # elapsed so far: e2e for finished entries, time-since-submit
        # for live ones — what ?slow= filters on, so a request STUCK in
        # the queue or a wedged slot for 30s is visible, not hidden
        # behind its unset e2e
        out["elapsed_s"] = entry["e2e_s"] if entry["e2e_s"] is not None \
            else round((now if now is not None else time.monotonic())
                       - entry["t_submit"], 6)
        return out

    def snapshot(self, slow_s: Optional[float] = None,
                 phase: Optional[str] = None,
                 limit: Optional[int] = None) -> list[dict]:
        """Finished-timeline summaries, most recent last, plus live
        entries at the tail; ``slow_s`` keeps elapsed (e2e, or
        time-since-submit for live entries) >= the bound, ``phase``
        keeps one dominant phase, ``limit`` the most recent N."""
        now = time.monotonic()
        with self._lock:
            entries = [self._summary(e, now)
                       for e in self._done.values()]
            entries += [self._summary(e, now)
                        for e in self._live.values()]
        if slow_s is not None:
            entries = [e for e in entries if e["elapsed_s"] >= slow_s]
        if phase is not None:
            entries = [e for e in entries
                       if e["dominant_phase"] == phase]
        if limit is not None and limit >= 0:
            entries = entries[-limit:] if limit else []
        return entries

    def stats(self) -> dict:
        with self._lock:
            by_phase: dict[str, int] = {}
            for e in self._done.values():
                p = e["dominant_phase"]
                by_phase[p] = by_phase.get(p, 0) + 1
            return {
                "live": len(self._live),
                "finished": len(self._done),
                "finished_total": self._finished_total,
                "shed_total": self._shed_total,
                "evicted_timelines": self._evicted,
                "max_requests": self.max_requests,
                "dominant_phases": by_phase,
                "ledger_steps": len(self._steps),
                "ledger_steps_total": self._steps_total,
                "ledger_tokens_total": self._tokens_total,
            }

    def percentiles(self) -> dict:
        """TTFT / TPOT / queue-wait / e2e p50+p99 over the finished
        ring — what the bench artifact embeds per phase."""
        with self._lock:
            done = list(self._done.values())
        out = {"requests": len(done)}
        for field in ("ttft_s", "tpot_s", "queue_wait_s", "e2e_s"):
            vals = sorted(e[field] for e in done
                          if e[field] is not None)
            key = field[:-2]  # strip the _s suffix
            out[f"{key}_p50_s"] = round(_quantile(vals, 0.50), 6)
            out[f"{key}_p99_s"] = round(_quantile(vals, 0.99), 6)
        return out

    def engine_rollup(self, window: int = 128) -> dict:
        """Windowed step-ledger rollup: occupancy, tokens/s, and step
        wall-time quantiles over the most recent ``window`` records."""
        with self._lock:
            recent = list(self._steps)[-window:] if window else []
            total = {"steps_total": self._steps_total,
                     "tokens_total": self._tokens_total}
        out = {"window": len(recent), **total}
        if not recent:
            out.update({"mean_occupancy": 0.0, "tokens_per_s": 0.0,
                        "step_p50_s": 0.0, "step_p99_s": 0.0,
                        "spec_steps": 0})
            return out
        durs = sorted(r["dur_s"] for r in recent)
        wall = sum(durs)
        out["mean_occupancy"] = round(
            sum(r["active"] for r in recent) / len(recent), 3)
        out["tokens_per_s"] = round(
            sum(r["tokens"] for r in recent) / wall, 1) if wall else 0.0
        out["step_p50_s"] = round(_quantile(durs, 0.50), 6)
        out["step_p99_s"] = round(_quantile(durs, 0.99), 6)
        out["spec_steps"] = sum(1 for r in recent if r["spec_group"])
        return out

    def engine_steps(self, limit: int = 64) -> list[dict]:
        with self._lock:
            recent = list(self._steps)
        if limit >= 0:
            recent = recent[-limit:] if limit else []
        return [dict(r) for r in recent]

    def engine_phases(self, limit: int = 64) -> list[dict]:
        """The phase ledger's most recent ``limit`` records (all at
        ``limit < 0``), oldest first."""
        with self._lock:
            recent = list(self._phases)
        if limit >= 0:
            recent = recent[-limit:] if limit else []
        return [dict(r) for r in recent]

    def phase_rollup(self) -> dict:
        """Seconds of each engine phase over the phase ledger ring, and
        each one's share of the loop's wall from the first record's
        start to the last one's end (the records partition it)."""
        with self._lock:
            recent = list(self._phases)
        ns = dict.fromkeys(ENGINE_PHASES, 0)
        for r in recent:
            ns[r["phase"]] += r["dur_ns"]
        wall = (recent[-1]["t_ns"] + recent[-1]["dur_ns"]
                - recent[0]["t_ns"]) if recent else 0
        return {"records": len(recent), "wall_s": round(wall / 1e9, 6),
                "phases": {p: {"s": round(v / 1e9, 6),
                               "share": round(v / wall, 4) if wall else 0.0}
                           for p, v in ns.items()}}

    def audit_payload(self, slowest: int = 8) -> dict:
        """The requests_audit.json shape: recorder stats, the phase
        percentiles, the engine rollup, and the slowest finished
        timelines (summaries) with their dominant phases."""
        with self._lock:
            done = [self._summary(e) for e in self._done.values()]
        done.sort(key=lambda e: e["e2e_s"] or 0.0, reverse=True)
        return {
            "stats": self.stats(),
            "percentiles": self.percentiles(),
            "engine": self.engine_rollup(),
            "slowest": done[:slowest],
        }


# -- process-global active recorder (trace.TRACER / fleet pattern) ------------

_ACTIVE: Optional[RequestRecorder] = None


def set_active(recorder: Optional[RequestRecorder]) -> None:
    global _ACTIVE
    _ACTIVE = recorder


def active() -> Optional[RequestRecorder]:
    return _ACTIVE


def maybe_active() -> Optional[RequestRecorder]:
    """The active recorder, auto-created on first use when
    ``K8S_TPU_REQUEST_LOG`` is set — the activation seam the engine
    calls at construction (mirroring ``compileledger.maybe_active``)."""
    global _ACTIVE
    if _ACTIVE is None and enabled_from_env():
        _ACTIVE = RequestRecorder()
    return _ACTIVE


# -- /debug/requests and /debug/engine ----------------------------------------

_INACTIVE_BODY = ("request recorder inactive (set K8S_TPU_REQUEST_LOG=1 "
                  "so the serving engine records per-request "
                  "timelines)\n")


def debug_requests_response(query: str = "") -> tuple[int, str, str]:
    """(status, body, content-type) for GET /debug/requests — the ONE
    responder the metrics server, the dashboard backend, and the
    serving pod all route to (404 with an explicit body while no
    recorder is active, like every other /debug route)."""
    rec = _ACTIVE
    if rec is None:
        return 404, _INACTIVE_BODY, "text/plain"
    params = parse_qs(query or "")

    def _num(key, cast):
        raw = (params.get(key) or [None])[0]
        if raw is None:
            return None
        try:
            return cast(raw)
        except ValueError:
            return None

    rid = _num("id", int)
    if rid is not None:
        entry = rec.request(rid)
        if entry is None:
            return (404, f"no request timeline with id {rid}\n",
                    "text/plain")
        body = json.dumps({"request": entry}, indent=2)
        return 200, body + "\n", "application/json"
    slow = _num("slow", float)
    phase = (params.get("phase") or [None])[0]
    if phase is not None and phase not in PHASES:
        return (400, f"unknown phase {phase!r} (expected one of "
                f"{list(PHASES)})\n", "text/plain")
    limit = _num("n", int)
    payload = {
        "stats": rec.stats(),
        "percentiles": rec.percentiles(),
        "requests": rec.snapshot(slow_s=slow, phase=phase,
                                 limit=50 if limit is None else limit),
    }
    return 200, json.dumps(payload, indent=2) + "\n", "application/json"


def debug_engine_response(query: str = "") -> tuple[int, str, str]:
    """(status, body, content-type) for GET /debug/engine: the step
    ledger's recent records plus windowed rollups, and the phase
    ledger's rollup (404 with an explicit body while no recorder is
    active)."""
    rec = _ACTIVE
    if rec is None:
        return 404, _INACTIVE_BODY, "text/plain"
    params = parse_qs(query or "")
    raw_n = (params.get("n") or [None])[0]
    try:
        limit = int(raw_n) if raw_n is not None else 64
    except ValueError:
        limit = 64
    payload = {
        "rollup": rec.engine_rollup(),
        "rollup_recent": rec.engine_rollup(window=32),
        "steps": rec.engine_steps(limit=limit),
        "phase_rollup": rec.phase_rollup(),
    }
    return 200, json.dumps(payload, indent=2) + "\n", "application/json"
