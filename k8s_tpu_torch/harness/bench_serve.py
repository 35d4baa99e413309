"""Serving throughput bench: N concurrent closed-loop clients against the
port's HTTP server (``models/server.py``), single-flight against the
continuous-batching engine (``models/engine.py``).  The port of
``k8s_tpu/harness/bench_serve.py``.

    python -m k8s_tpu_torch.harness.bench_serve --concurrency 8 --slots 8
    python -m k8s_tpu_torch.harness.bench_serve --device cpu   # no card

Every phase serves the SAME randomly initialized transformer in the same
process over real HTTP (``ThreadingHTTPServer`` and stdlib clients), so
the comparison isolates the serving architecture:

- **single_flight**: ``slots=0``, one lock, each request one whole
  generation, requests serialized;
- **batched**: ``slots=N``, slot-based continuous batching, one shared
  decode step advancing every active slot.

Client 0 issues long generations (``--max-new-long``) and the rest short
ones, so single-flight p99 for short requests waits on the long
generation while iteration-level scheduling retires them mid-flight.

The sampled phases (``--sampled``, on by default): 80% of requests share
a templated prefix, all carry ``temperature > 0`` with per-request
seeds.  ``sampled_exclusive`` routes sampling to the exclusive lane with
prefix reuse off; ``sampled_batched`` rides the slot lanes with the
radix prefix cache on.  Prefix-cache hits are counted after the warm-up,
and a fixed-seed spot check holds that both routings emit the same
tokens.

The speculative phases (``--spec``, on by default): every request
carries ``speculative: draft_k`` over grounded prompts (each embeds the
model's own greedy continuation).  ``spec_exclusive`` routes speculation
through the exclusive lane, ``spec_batched`` through the batched
variable-width verify step.  The phase records the draft acceptance
rate, and a fixed-seed spot check holds that both routings emit the same
tokens, greedy and sampled.

The engine phases run under a fresh request recorder
(``models/requestlog.py``), cleared at the warm-up boundary, so each
phase reports the measured section's TTFT / TPOT / queue-wait p50/p99
and a ``requests_audit`` block; an identical recorder-off batched phase
gives the recorder's overhead.

Failures (request errors, a routing that is not output-invariant, the
recorder more than 3% below recorder-off, spec_batched under 1.5x
spec_exclusive, batched greedy slower than single-flight) attach a
``failures`` field and raise with the result on the exception; the
JSON line is printed either way.  The wall-time bounds were set on the
reference's tiny CPU model; at another width or on the card they are
readings.

Eager PyTorch compiles no programs, so the reference's per-phase
``compile`` dict, ``compile_ledger`` and the compile-budget failures
have no counterpart here.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; asking for CUDA without a card raises.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import threading
import time
import urllib.request

from k8s_tpu_torch.util.util import quantile_nearest as _quantile

log = logging.getLogger(__name__)

# mixed prompt lengths exercising several prefill buckets (13 = 8+4+1 ...)
PROMPT_LENGTHS = (4, 6, 13, 21)


def _downsample(timeline: list, points: int) -> list:
    """Evenly-strided subset of a (step, occupancy) timeline, keeping the
    final sample so the retire tail is visible."""
    if len(timeline) <= points:
        return [list(t) for t in timeline]
    stride = len(timeline) / points
    out = [list(timeline[int(i * stride)]) for i in range(points)]
    out.append(list(timeline[-1]))
    return out


def build_model(seed: int = 0, hidden: int = 256, layers: int = 4,
                device="cuda"):
    """The bench's causal LM with the byte vocabulary (256), f32: hidden
    256 and 4 layers keep decode bound by weight reads, so continuous
    batching wins on shared weight streams rather than on framework
    overhead; the speculative phases pass ``hidden=512`` (a draft_k-wide
    verify has draft_k times the arithmetic intensity of a 1-wide step).
    Weights come from a generator seeded with ``seed``
    (``bridge.init_params``).  Returns ``(config, state dict)``."""
    import torch

    from k8s_tpu_torch.models.bridge import init_params
    from k8s_tpu_torch.models.transformer import TransformerConfig

    config = TransformerConfig(
        vocab_size=256, hidden=hidden, ffn_hidden=2 * hidden,
        layers=layers, heads=8, kv_heads=8, max_seq_len=128,
        dtype=torch.float32, remat=False)
    return config, init_params(config, seed, device=device)


def _prompt(rank: int, length: int) -> list[int]:
    # deterministic per (client, length) so both phases see identical work
    return [(rank * 31 + i * 7 + length) % 256 for i in range(length)]


def _template(length: int) -> list[int]:
    """The shared system-prompt prefix of the sampled phases."""
    return [(i * 5 + 3) % 256 for i in range(length)]


SPEC_PROMPT_LEN = 30  # one fixed prompt length per spec phase


def _spec_prompt(rank: int, i: int, length: int = SPEC_PROMPT_LEN
                 ) -> list[int]:
    """Repetitive prompts for the speculative phases: a 6-token cycle
    repeated to ``length``, the 2-gram structure prompt-lookup drafting
    copies from.  Per-(client, request) cycle content keeps requests
    distinct while every shape stays fixed."""
    cycle = [(rank * 29 + i * 17 + j * 11 + 3) % 256 for j in range(6)]
    return [cycle[j % 6] for j in range(length)]


def _grounded_spec_prompts(config, params, n: int = 8, base_len: int = 8,
                           embed: int = SPEC_PROMPT_LEN - 8,
                           device="cuda") -> list[list[int]]:
    """The speculative phases' workload: grounded prompts, each embedding
    the model's own greedy continuation of a short base, so the served
    generation reproduces a span already in the context (greedy decoding
    is self-consistent under prefix extension): the traffic that
    prompt-lookup drafting targets.  Bases whose continuation never
    settles into a repetitive tail are skipped (both lanes serve the same
    mix, so the selection favours neither).  All prompts share one
    length."""
    import numpy as np

    from k8s_tpu_torch.models import decode as decode_lib

    out: list[list[int]] = []
    seed = 0
    while len(out) < n and seed < 16 * n:
        base = [(seed * 29 + j * 11 + 3) % 256 for j in range(base_len)]
        cont = [int(t) for t in decode_lib.generate(
            config, params, np.asarray(base, np.int64)[None],
            embed + 12, device=device)[0].tolist()]
        if len(set(cont[embed:])) <= 2:  # repetitive tail: drafts track
            out.append(base + cont[:embed])
        seed += 1
    # pathological weights: fall back to cyclic prompts rather than spin
    while len(out) < n:
        out.append(_spec_prompt(len(out), 0))
    return out


def _shared_prompt(rank: int, i: int, template_len: int,
                   tail_len: int, shared: bool) -> list[int]:
    """Templated traffic: ``shared`` requests are the common template
    plus a per-(client, request) unique tail; the rest are unique prompts
    of the same total length (so only reuse differs between routings)."""
    if shared:
        tail = [(rank * 17 + i * 13 + j * 7 + 1) % 256
                for j in range(tail_len)]
        return _template(template_len) + tail
    return [(rank * 37 + i * 101 + j * 7 + 11) % 256
            for j in range(template_len + tail_len)]


def _post(url: str, payload: dict, timeout: float = 300.0) -> dict:
    req = urllib.request.Request(
        url + "/v1/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def run_phase(config, params, *, slots: int, concurrency: int,
              requests_per_client: int, max_new_short: int,
              max_new_long: int, queue_limit: int = 1024,
              temperature: float = 0.0,
              batch_sampling: bool = True,
              batch_spec: bool = True, spec_k: int = 0,
              spec_prompts: list | None = None,
              prefix_blocks: int | None = None,
              shared_frac: float = 0.0, template_len: int = 40,
              tail_len: int = 6, mode: str | None = None,
              request_log: bool = False, device="cuda") -> dict:
    """One closed-loop phase: start a server on ``device``, send every
    request shape once (the warm-up), then drive it with
    ``concurrency`` clients and measure.

    ``shared_frac > 0`` switches to the templated workload: that fraction
    of requests shares a ``template_len``-token prefix, every request
    carries ``temperature`` with a per-request seed, and the phase
    reports the prefix-cache hit rate of the measured section (counters
    taken after the warm-up).

    ``request_log`` runs the phase under a fresh request recorder,
    cleared after the warm-up, so the reported TTFT / TPOT / queue-wait
    percentiles cover the measured section; the phase gains
    ``request_phases`` and ``requests_audit``."""
    from k8s_tpu_torch.models import requestlog
    from k8s_tpu_torch.models.server import LmServer, serve
    from k8s_tpu_torch.util.metrics import Registry

    rec = None
    prev_rec = requestlog.active()
    # the env knob is neutralized for both arms while the engine binds:
    # with K8S_TPU_REQUEST_LOG=1 in the environment, the engine's
    # maybe_active() would create a recorder and turn the recorder-off
    # arm into a second recorder-on arm
    prev_env = os.environ.pop(requestlog.ENV_ENABLE, None)
    if request_log:
        # active before LmServer: the engine binds it at construction
        rec = requestlog.RequestRecorder()
        requestlog.set_active(rec)
    else:
        requestlog.set_active(None)
    try:
        lm = LmServer(config=config, params=params, slots=slots,
                      queue_limit=queue_limit,
                      batch_sampling=batch_sampling,
                      batch_spec=batch_spec,
                      prefix_blocks=prefix_blocks, registry=Registry(),
                      device=device)
    finally:
        if prev_env is not None:
            os.environ[requestlog.ENV_ENABLE] = prev_env
    httpd = serve(lm)
    url = "http://%s:%d" % httpd.server_address[:2]
    try:
        # warm-up: every (prompt_len, max_new) shape any client will
        # issue, so allocator growth and first launches stay out of the
        # measured section
        if spec_k > 0:
            if spec_prompts is None:
                spec_prompts = [_spec_prompt(r, 0) for r in range(8)]
            _post(url, {"tokens": spec_prompts[0],
                        "max_new_tokens": max_new_short,
                        "temperature": temperature,
                        "speculative": spec_k, "seed": 99})
        elif shared_frac > 0:
            for shared in (True, False):
                _post(url, {"tokens": _shared_prompt(
                    99, 99, template_len, tail_len, shared),
                    "max_new_tokens": max_new_short,
                    "temperature": temperature, "seed": 99})
            # a mid-block partial match (truncated template + unique
            # tail) copies the divergence block on write: warm that too
            cut = (template_len // 2) | 1  # odd: never block-aligned
            _post(url, {"tokens": _template(template_len)[:cut]
                        + [250, 251, 252],
                        "max_new_tokens": max_new_short,
                        "temperature": temperature, "seed": 98})
        else:
            for length in PROMPT_LENGTHS:
                for max_new in (max_new_short, max_new_long):
                    _post(url, {"tokens": _prompt(0, length),
                                "max_new_tokens": max_new,
                                "temperature": temperature})
        warm_stats = lm.engine.stats() if lm.engine is not None else {}
        if rec is not None:
            # the warm-up boundary: percentiles cover the measured section
            rec.clear()

        lat_all: list[float] = []
        lat_short: list[float] = []
        tokens_out = [0]
        errors: list[str] = []
        lock = threading.Lock()
        barrier = threading.Barrier(concurrency + 1)

        def client(rank: int) -> None:
            import http.client

            # greedy phases: one long-generation client exposes the
            # head-of-line price; sampled and spec phases: a uniform
            # short mix (their headline is aggregate tokens/s)
            is_long = rank == 0 and shared_frac == 0 and spec_k == 0
            max_new = max_new_long if is_long else max_new_short
            # one keep-alive connection per client, as a real closed-loop
            # client holds
            conn = http.client.HTTPConnection(
                "%s:%d" % httpd.server_address[:2], timeout=300)
            barrier.wait()
            # a few ms of per-rank jitter: a phase-locked client fleet
            # joins and retires in one wave
            time.sleep(rank * 0.005)
            try:
                for i in range(requests_per_client):
                    if spec_k > 0:
                        toks = spec_prompts[(rank + i)
                                            % len(spec_prompts)]
                        payload = {"tokens": toks,
                                   "max_new_tokens": max_new,
                                   "temperature": temperature,
                                   "speculative": spec_k,
                                   "seed": rank * 1000 + i}
                    elif shared_frac > 0:
                        # a deterministic split accurate to 1% for any
                        # fraction: the same mix hits every phase
                        shared = ((rank * 37 + i * 11) % 100) \
                            < round(shared_frac * 100)
                        payload = {"tokens": _shared_prompt(
                            rank, i, template_len, tail_len, shared),
                            "max_new_tokens": max_new,
                            "temperature": temperature,
                            "seed": rank * 1000 + i}
                    else:
                        length = PROMPT_LENGTHS[(rank + i)
                                                % len(PROMPT_LENGTHS)]
                        payload = {"tokens": _prompt(rank, length),
                                   "max_new_tokens": max_new}
                    body = json.dumps(payload).encode()
                    t0 = time.monotonic()
                    try:
                        conn.request(
                            "POST", "/v1/generate", body=body,
                            headers={"Content-Type": "application/json"})
                        resp = conn.getresponse()
                        out = json.loads(resp.read())
                        if resp.status != 200:
                            raise RuntimeError(f"HTTP {resp.status}: {out}")
                    except Exception as e:  # noqa: BLE001 - count, don't crash
                        with lock:
                            errors.append(f"{type(e).__name__}: {e}")
                        continue
                    dt = time.monotonic() - t0
                    with lock:
                        lat_all.append(dt)
                        if not is_long:
                            lat_short.append(dt)
                        tokens_out[0] += len(out["tokens"])
            finally:
                conn.close()

        threads = [threading.Thread(target=client, args=(r,), daemon=True)
                   for r in range(concurrency)]
        for t in threads:
            t.start()
        barrier.wait()
        t0 = time.monotonic()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0

        engine_stats = lm.engine.stats() if lm.engine is not None else {}
        lat_all.sort()
        lat_short.sort()
        occ = [o for _, o in engine_stats.get("occupancy_timeline", [])]
        # measured-section prefix and spec counters: deltas against the
        # post-warm-up snapshot
        hits = engine_stats.get("prefix_hits", 0) \
            - warm_stats.get("prefix_hits", 0)
        prefix = {
            "hits": hits,
            "hit_rate": round(hits / max(1, len(lat_all)), 3),
            "tokens_saved": engine_stats.get("prefix_tokens_saved", 0)
            - warm_stats.get("prefix_tokens_saved", 0),
            "cow_copies": engine_stats.get("cow_copies", 0),
            "tree_nodes": engine_stats.get("tree_nodes", 0),
            "blocks_in_use": engine_stats.get("blocks_in_use", 0),
            "pool_blocks": engine_stats.get("pool_blocks", 0),
        }
        # the batched lane counts per verify step; the exclusive lane's
        # acceptance happens inside its generation loop and is not
        # observable here
        spec_steps = engine_stats.get("spec_steps", 0) \
            - warm_stats.get("spec_steps", 0)
        spec_prop = engine_stats.get("spec_proposed", 0) \
            - warm_stats.get("spec_proposed", 0)
        spec_acc = engine_stats.get("spec_accepted", 0) \
            - warm_stats.get("spec_accepted", 0)
        spec = {
            "draft_k": spec_k,
            "verify_steps": spec_steps,
            "proposed": spec_prop,
            "accepted": spec_acc,
            "acceptance_rate": round(spec_acc / spec_prop, 3)
            if spec_prop else 0.0,
            "mean_accepted_per_step": round(spec_acc / spec_steps, 3)
            if spec_steps else 0.0,
        }
        request_phases = rec.percentiles() if rec is not None else None
        requests_audit = rec.audit_payload() if rec is not None else None
        return {
            "mode": mode or ("batched" if slots > 0 else "single_flight"),
            "slots": slots,
            "request_log": rec is not None,
            "request_phases": request_phases,
            "requests_audit": requests_audit,
            "temperature": temperature,
            "batch_sampling": bool(batch_sampling) and slots > 0,
            "batch_spec": bool(batch_spec) and slots > 0,
            "shared_frac": shared_frac,
            "prefix": prefix,
            "spec": spec,
            "requests": len(lat_all),
            "errors": errors[:5],
            "wall_s": round(wall, 3),
            "tokens": tokens_out[0],
            "tokens_per_s": round(tokens_out[0] / max(wall, 1e-9), 1),
            "latency_p50_s": round(_quantile(lat_all, 0.50), 4),
            "latency_p99_s": round(_quantile(lat_all, 0.99), 4),
            "short_p99_s": round(_quantile(lat_short, 0.99), 4),
            "mean_batch_occupancy": round(sum(occ) / len(occ), 2)
            if occ else None,
            "occupancy_timeline": _downsample(
                engine_stats.get("occupancy_timeline", []), 32),
            "decode_steps": engine_stats.get("steps"),
            "prefill_programs": engine_stats.get("prefill_programs"),
        }
    finally:
        httpd.shutdown()
        httpd.server_close()
        lm.close()
        requestlog.set_active(prev_rec)


def _lane_outputs(config, params, payloads: list, device, **server_kw
                  ) -> list:
    """Each payload's answer over real HTTP from a 2-slot server built
    with ``server_kw``."""
    from k8s_tpu_torch.models.server import LmServer, serve
    from k8s_tpu_torch.util.metrics import Registry

    lm = LmServer(config=config, params=params, slots=2, queue_limit=8,
                  registry=Registry(), device=device, **server_kw)
    httpd = serve(lm)
    try:
        url = "http://%s:%d" % httpd.server_address[:2]
        return [_post(url, p) for p in payloads]
    finally:
        httpd.shutdown()
        httpd.server_close()
        lm.close()


def sampled_equivalence_payloads(template_len: int = 40,
                                 tail_len: int = 6) -> list[dict]:
    """The fixed-seed request of :func:`check_sampled_equivalence`."""
    return [{"tokens": _shared_prompt(3, 1, template_len, tail_len, True),
             "max_new_tokens": 8, "temperature": 1.0, "seed": 7}]


def spec_equivalence_payloads(draft_k: int = 4) -> list[dict]:
    """The fixed-seed requests of :func:`check_spec_equivalence`: greedy
    and sampled speculation."""
    return [
        {"tokens": _spec_prompt(3, 1), "max_new_tokens": 8,
         "speculative": draft_k},
        {"tokens": _spec_prompt(4, 2), "max_new_tokens": 8,
         "speculative": draft_k, "temperature": 1.0, "seed": 7},
    ]


def check_sampled_equivalence(config, params, template_len: int = 40,
                              tail_len: int = 6, device="cuda") -> bool:
    """Fixed-seed spot check over real HTTP: the batched sampling lane and
    the exclusive lane must emit the same tokens (the sampled speedup
    means something only if the routing leaves the output unchanged)."""
    payloads = sampled_equivalence_payloads(template_len, tail_len)
    outs = [_lane_outputs(config, params, payloads, device,
                          batch_sampling=batch_sampling)
            for batch_sampling in (True, False)]
    return outs[0] == outs[1]


def check_spec_equivalence(config, params, draft_k: int = 4,
                           device="cuda") -> bool:
    """Fixed-seed spot check over real HTTP: the batched speculative lane
    and the exclusive lane must emit the same tokens for greedy and
    sampled speculation."""
    payloads = spec_equivalence_payloads(draft_k)
    outs = [_lane_outputs(config, params, payloads, device,
                          batch_spec=batch_spec)
            for batch_spec in (True, False)]
    return outs[0] == outs[1]


def run_bench(concurrency: int = 16, slots: int = 8,
              requests_per_client: int = 4, max_new_short: int = 32,
              max_new_long: int = 64, seed: int = 0,
              sampled: bool = True, shared_frac: float = 0.8,
              spec: bool = True, draft_k: int = 4,
              device="cuda") -> dict:
    """Single-flight against continuous batching over the same model and
    workload, then the sampled mix (shared-prefix traffic at temperature
    > 0, exclusive-lane sampling against the batched sampling lane with
    prefix reuse), then the speculative phases (exclusive-lane against
    batched variable-width speculation over grounded prompts).  Returns
    the JSON-able comparison dict."""
    config, params = build_model(seed, device=device)
    single = run_phase(config, params, slots=0, concurrency=concurrency,
                       requests_per_client=requests_per_client,
                       max_new_short=max_new_short,
                       max_new_long=max_new_long, device=device)
    # prefix reuse off in the greedy comparison: the slots=0 baseline has
    # no prefix cache (the sampled phases measure reuse).  Recorder off
    # and on over the identical batched workload, interleaved, best of
    # two per arm: closed-loop tokens/s swings several percent from run
    # to run, and the recorder-on winner is the headline (the shipped
    # configuration)
    greedy_kw = dict(slots=slots, concurrency=concurrency,
                     requests_per_client=requests_per_client,
                     max_new_short=max_new_short,
                     max_new_long=max_new_long, prefix_blocks=0,
                     device=device)
    off_runs, on_runs = [], []
    for _ in range(2):
        off_runs.append(run_phase(config, params,
                                  mode="batched_recorder_off",
                                  **greedy_kw))
        on_runs.append(run_phase(config, params, request_log=True,
                                 **greedy_kw))
    batched_off = max(off_runs, key=lambda p: p["tokens_per_s"])
    batched = max(on_runs, key=lambda p: p["tokens_per_s"])
    speedup = batched["tokens_per_s"] / max(single["tokens_per_s"], 1e-9)
    recorder_ratio = batched["tokens_per_s"] \
        / max(batched_off["tokens_per_s"], 1e-9)
    result = {
        "metric": "serve_tokens_per_s",
        "value": batched["tokens_per_s"],
        "unit": "tok/s",
        "concurrency": concurrency,
        "requests_per_client": requests_per_client,
        "max_new_short": max_new_short,
        "max_new_long": max_new_long,
        "single_flight": single,
        "batched": batched,
        "batched_recorder_off": batched_off,
        "recorder_overhead": {
            "on_tokens_per_s": batched["tokens_per_s"],
            "off_tokens_per_s": batched_off["tokens_per_s"],
            "on_runs": [p["tokens_per_s"] for p in on_runs],
            "off_runs": [p["tokens_per_s"] for p in off_runs],
            "ratio": round(recorder_ratio, 4),
        },
        "speedup": round(speedup, 2),
        # short requests behind a long generation (p99): serialized
        # against continuous batching
        "short_p99_single_s": single["short_p99_s"],
        "short_p99_batched_s": batched["short_p99_s"],
    }
    if sampled:
        # baseline: sampling on the exclusive lane without prefix reuse;
        # candidate: batched sampling with radix reuse.  Twice the
        # clients of the greedy phases: the batched lane turns backlog
        # into occupancy, the serialized baseline cannot
        sampled_kw = dict(
            slots=slots, concurrency=concurrency * 2,
            requests_per_client=requests_per_client,
            max_new_short=max_new_short, max_new_long=max_new_long,
            temperature=1.0, shared_frac=shared_frac,
            request_log=True, device=device)
        exclusive = run_phase(config, params, batch_sampling=False,
                              prefix_blocks=0, mode="sampled_exclusive",
                              **sampled_kw)
        promoted = run_phase(config, params, batch_sampling=True,
                             prefix_blocks=None, mode="sampled_batched",
                             **sampled_kw)
        result["sampled_exclusive"] = exclusive
        result["sampled_batched"] = promoted
        result["sampled_speedup"] = round(
            promoted["tokens_per_s"]
            / max(exclusive["tokens_per_s"], 1e-9), 2)
        result["sampled_shared_frac"] = shared_frac
        result["sampled_equivalence_ok"] = check_sampled_equivalence(
            config, params, device=device)
    if spec:
        # the hidden-512 model (see build_model), twice the slots,
        # clients and requests: spec slots spend several iterations per
        # emitted-token budget verifying, and a longer closed-loop run
        # measures the steady state past the batched lane's ramp and
        # drain.  Prefix reuse stays on for the batched phase; the
        # exclusive lane runs over a private dense cache and cannot reuse
        # the pool
        spec_config, spec_params = build_model(seed, hidden=512,
                                               device=device)
        spec_kw = dict(
            slots=slots * 2, concurrency=concurrency * 2,
            requests_per_client=requests_per_client * 2,
            max_new_short=max_new_short, max_new_long=max_new_long,
            spec_k=draft_k, request_log=True, device=device,
            spec_prompts=_grounded_spec_prompts(spec_config, spec_params,
                                                device=device))
        spec_excl = run_phase(spec_config, spec_params, batch_spec=False,
                              prefix_blocks=0, mode="spec_exclusive",
                              **spec_kw)
        spec_prom = run_phase(spec_config, spec_params, batch_spec=True,
                              prefix_blocks=None, mode="spec_batched",
                              **spec_kw)
        result["spec_exclusive"] = spec_excl
        result["spec_batched"] = spec_prom
        result["spec_speedup"] = round(
            spec_prom["tokens_per_s"]
            / max(spec_excl["tokens_per_s"], 1e-9), 2)
        result["spec_draft_k"] = draft_k
        result["spec_acceptance_rate"] = \
            spec_prom["spec"]["acceptance_rate"]
        result["spec_equivalence_ok"] = check_spec_equivalence(
            spec_config, spec_params, draft_k, device=device)
    result["requests_audit"] = {
        phase["mode"]: phase["requests_audit"]
        for phase in (batched, result.get("sampled_batched") or {},
                      result.get("sampled_exclusive") or {},
                      result.get("spec_batched") or {},
                      result.get("spec_exclusive") or {})
        if phase and phase.get("requests_audit") is not None}
    failures = bench_failures(result)
    if failures:
        result["failures"] = failures
        err = RuntimeError("serve bench assertions failed:\n  "
                           + "\n  ".join(failures))
        err.result = result
        raise err
    return result


def bench_failures(result: dict) -> list[str]:
    """The assertions of a ``run_bench`` result, as messages."""
    single, batched = result["single_flight"], result["batched"]
    batched_off = result["batched_recorder_off"]
    failures: list[str] = []
    for phase in (single, batched, batched_off,
                  result.get("sampled_exclusive") or {},
                  result.get("sampled_batched") or {},
                  result.get("spec_exclusive") or {},
                  result.get("spec_batched") or {}):
        if phase.get("errors"):
            failures.append(
                f"phase {phase.get('mode')}: request errors "
                f"{phase['errors']}")
    # the recorder must pay for itself: recorder-on batched tokens/s
    # within 3% of recorder-off on the identical workload
    recorder_ratio = result["recorder_overhead"]["ratio"]
    if recorder_ratio < 0.97:
        failures.append(
            f"request recorder overhead too high: recorder-ON batched "
            f"{batched['tokens_per_s']} tok/s is "
            f"{round((1 - recorder_ratio) * 100, 1)}% below "
            f"recorder-OFF {batched_off['tokens_per_s']} tok/s "
            "(> 3% bound): per-request recording is taxing the decode "
            "loop it observes")
    if "sampled_equivalence_ok" in result \
            and not result["sampled_equivalence_ok"]:
        failures.append(
            "sampled routing not output-invariant: batched sampling lane "
            "and exclusive lane emitted different tokens at a fixed seed")
    if "spec_equivalence_ok" in result:
        if not result["spec_equivalence_ok"]:
            failures.append(
                "speculative routing not output-invariant: batched spec "
                "lane and exclusive lane emitted different tokens at a "
                "fixed seed")
        if result["spec_speedup"] < 1.5:
            failures.append(
                f"spec_batched only {result['spec_speedup']}x "
                "spec_exclusive aggregate tokens/s (< 1.5x bound): the "
                "batched spec lanes are not converting the serialized "
                "exclusive backlog into occupancy")
    # the paged decode step must keep the continuous-batching win
    if batched["tokens_per_s"] < single["tokens_per_s"]:
        failures.append(
            f"batched greedy {batched['tokens_per_s']} tok/s fell below "
            f"single-flight {single['tokens_per_s']} tok/s: the paged "
            "decode step regressed the continuous-batching win")
    return failures


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--concurrency", type=int, default=16,
                   help="closed-loop client threads (>= 2; client 0 "
                   "issues long generations; > slots keeps a backlog so "
                   "slots stay fed through client turnaround)")
    p.add_argument("--slots", type=int, default=8,
                   help="decode slots for the batched phase")
    p.add_argument("--requests", type=int, default=4,
                   help="requests per client per phase")
    p.add_argument("--max-new-short", type=int, default=32)
    p.add_argument("--max-new-long", type=int, default=64,
                   help="the long-client generation length (the head-of-"
                   "line blocker for the serialized baseline)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sampled", type=int, choices=(0, 1), default=1,
                   help="also run the shared-prefix temperature>0 "
                   "phases: exclusive-lane sampling vs the batched "
                   "sampling lane with prefix reuse (default on)")
    p.add_argument("--shared-frac", type=float, default=0.8,
                   help="fraction of sampled-phase requests sharing the "
                   "templated prompt prefix")
    p.add_argument("--spec", type=int, choices=(0, 1), default=1,
                   help="also run the speculative phases: exclusive-lane "
                   "vs batched variable-width speculation over "
                   "grounded prompts (acceptance rate in the JSON)")
    p.add_argument("--draft-k", type=int, default=4,
                   help="speculative draft chunk width for the spec "
                   "phases")
    p.add_argument("--device", default="cuda",
                   help="cuda (default), or cpu for the plain versions")
    p.add_argument("--out", default=None,
                   help="also write the JSON result to this path")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)

    def _write(payload: dict) -> None:
        line = json.dumps(payload)
        print(line)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                f.write(line + "\n")

    try:
        result = run_bench(concurrency=args.concurrency, slots=args.slots,
                           requests_per_client=args.requests,
                           max_new_short=args.max_new_short,
                           max_new_long=args.max_new_long, seed=args.seed,
                           sampled=bool(args.sampled),
                           shared_frac=args.shared_frac,
                           spec=bool(args.spec), draft_k=args.draft_k,
                           device=args.device)
    except RuntimeError as e:
        # the JSON line lands on failure too, ``failures`` included
        partial = getattr(e, "result", None)
        if partial is not None:
            _write(partial)
        raise
    _write(result)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
