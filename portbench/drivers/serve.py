"""A serving cell: ``models/server.py``'s ``LmServer`` on the
continuous-batching engine (``models/engine.py``), reached over HTTP
``/v1/generate`` by closed-loop clients in a child process
(``portbench/client.py``), greedy and without EOS.  The request recorder
(``models/requestlog.py``) is on, for the per-layer metrics.

The clients send for ``--seconds``, then send nothing more and wait for
every request in flight.  The end-to-end metric is the clients' own
clock: every token of every request sent in the window, over the time
from the window's start to the last answer.  Closed-loop clients on as
many slots keep the engine saturated, so the latency tail (the 95th
percentile from send to answer over every request sent, one not
answered counting as never answered) is a per-layer metric, as are the
recorder's tails over the same requests.  Afterwards a sample of the
answered requests, drawn from the seed with the longest among them, is
held against the reference's teacher-forced pass.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

from portbench import check, client, common, flops, traffic
from portbench.drivers import (
    allocated_bytes, peak_bytes, port_config, release, sync)
from portbench.reference import serve as ref_serve

CLIENT_START_S = 120.0
THREAD_END_S = 30.0


def _post(url: str, ids: list, max_new: int) -> None:
    req = urllib.request.Request(
        url + "/v1/generate",
        data=json.dumps({"tokens": ids, "max_new_tokens": max_new}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=600) as resp:
        resp.read()


def _warm(url: str, tr: dict, spec, seed: int, slots: int) -> None:
    """Every prompt shape the traffic can make, and the decode step at
    every width up to ``slots``: one request for each length of
    ``traffic.warmup_lengths`` at once, then ``slots`` short requests
    whose answers end one after another."""
    rng = np.random.default_rng(common.sub_seed(seed, "warm"))

    def burst(reqs):
        errors = []

        def one(ids, n):
            try:
                _post(url, ids, n)
            except OSError as e:
                errors.append(e)

        ts = [threading.Thread(target=one, args=r) for r in reqs]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        if errors:
            raise RuntimeError(f"warm-up request failed: {errors[0]!r}")

    burst([(rng.integers(0, spec.vocab, n).tolist(), 2)
           for n in traffic.warmup_lengths(tr)])
    burst([(rng.integers(0, spec.vocab, 16).tolist(), 2 + i)
           for i in range(slots)])


def _sample(done: list, n: int, seed: int, plan) -> list:
    """``n`` answered requests drawn from the seed, the longest (prompt
    and answer) among them."""
    if not done:
        return []
    def size(r):
        return len(plan[r["c"]][r["i"]]["prompt"]) + len(r["tokens"])

    longest = max(done, key=size)
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng(common.sub_seed(seed, "sample"))
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[int(i)] for i in sorted(pick)]


def run(ctx) -> dict:
    from k8s_tpu_torch.models import requestlog
    from k8s_tpu_torch.models import server as server_lib

    spec, wl, dev, seed = ctx.spec, ctx.workload, ctx.device, ctx.seed
    tr, slots = wl["traffic"], wl["slots"]
    cfg = port_config(spec)
    plan = traffic.serve_plan(tr, seed, spec.vocab)
    rec = requestlog.RequestRecorder(max_requests=1 << 16, max_steps=1 << 18)
    requestlog.set_active(rec)
    child = subprocess.Popen(
        [sys.executable, "-m", "portbench.client"], cwd=common.ROOT,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    lm = httpd = None
    before = set(threading.enumerate())
    try:
        params = common.make_params(spec, seed, dev, spec.torch_dtype)
        lm = server_lib.LmServer(config=cfg, params=params, slots=slots,
                                 device=dev)
        del params
        httpd = server_lib.serve(lm, "127.0.0.1", 0)
        url = "http://127.0.0.1:%d" % httpd.server_address[1]
        child.stdin.write(json.dumps({"url": url, "traffic": tr,
                                      "seed": seed, "vocab": spec.vocab})
                          + "\n")
        child.stdin.flush()
        if child.stdout.readline().strip() != "ready":
            raise RuntimeError("the client process did not start")
        common.log(ctx.t_start, "server up; warming up")
        _warm(url, tr, spec, seed, slots)
        sync(dev)
        rec.clear()
        record = {"setup_s": time.perf_counter() - ctx.t_start}
        common.log(ctx.t_start, "set-up done; window opens")

        t0 = time.monotonic() + 0.05
        deadline = t0 + ctx.seconds
        child.stdin.write(f"{t0!r} {deadline!r}\n")
        child.stdin.flush()
        if ctx.trace:
            # a slice from the window's middle: past the first round's
            # prefills, which every client sends at once
            record["profile"] = _profile(dev, t0 + ctx.seconds / 2,
                                         ctx.trace_slice_s)
        out, _ = child.communicate(
            timeout=ctx.seconds + client.DRAIN_S + CLIENT_START_S)
        if child.returncode != 0:
            raise RuntimeError(f"the client process exited "
                               f"{child.returncode}")
        results = json.loads(out.strip().splitlines()[-1])
        record["memory_peak_bytes"] = peak_bytes(dev)
        record.update(_window(results, plan, spec, t0, deadline))
        common.log(ctx.t_start, "window closed: %d requests sent, the last "
                   "answered %.2f s past the deadline" % (
                       record["attempted"], record["drain_s"]))
        record["recorder"] = _recorder(rec, t0)
        if ctx.trace:
            record["moe"] = _time_moe(lm, spec, tr, slots, dev)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if lm is not None:
            lm.close()
        requestlog.set_active(None)
        if httpd is not None:
            httpd.lm = None
        # the engine thread and the handler threads hold the model until
        # they end; the reference needs its memory
        for t in threading.enumerate():
            if t is not threading.current_thread() and t not in before:
                t.join(THREAD_END_S)
    del lm, httpd
    release(dev)
    common.log(ctx.t_start, "server closed, %.1f GB still allocated"
               % (allocated_bytes(dev) / 1e9))

    done = [r for r in results if _answered(r)]
    sample = _sample(done, wl["check"]["sample_requests"], seed, plan)
    seqs = [(plan[r["c"]][r["i"]]["prompt"], r["tokens"]) for r in sample]
    gaps = ref_serve.served_gaps(ref_serve.logits_at_served(
        spec, seed, seqs, dev, spec.torch_dtype), seqs) if seqs else []
    common.log(ctx.t_start, f"reference done over {len(seqs)} requests")
    flat = sorted(x for g in gaps for x in g)
    numbers = {
        "served_gap": flat[-1] if flat else None,
        "served_gap_mean": sum(flat) / len(flat) if flat else None,
        "served_tokens_compared": len(flat),
        "failed_requests": record["failed"],
        "wrong_lengths": sum(len(r["tokens"]) != plan[r["c"]][r["i"]]
                             ["max_new"] for r in done),
    }
    record["numbers"] = numbers
    record["checks"] = check.judge(numbers, wl["limits"])
    record["seqs"] = seqs
    return record


def _answered(r) -> bool:
    return r["status"] == 200 and r["done"] is not None


def _window(results, plan, spec, t0, deadline) -> dict:
    """The end-to-end metrics over every request sent in the window: all
    their tokens over the time from ``t0`` to the last answer.  One not
    answered, or answered with an error, fails and has no end."""
    done = [r for r in results if _answered(r)]
    end = max([r["done"] for r in done], default=deadline)
    lat = sorted([(r["done"] - r["send"]) * 1e3 for r in done]
                 + [float("inf")] * (len(results) - len(done)))
    tokens = sum(len(r["tokens"]) for r in done)
    model_flops = sum(flops.serve_request_flops(
        spec, len(plan[r["c"]][r["i"]]["prompt"]), len(r["tokens"]))
        for r in done)
    return {
        "e2e": {"serve_tokens_per_s": tokens / (end - t0)},
        "e2e_p95_ms": common.quantile_nearest(lat, 0.95),
        "attempted": len(results), "failed": len(results) - len(done),
        "answered": len(done), "drain_s": end - deadline,
        "model_flops_per_s": model_flops / (end - t0),
    }


def _recorder(rec, t0) -> dict:
    """The recorder's timelines of every request submitted since the
    warm-up (all sent in the window), and its step ledger's records from
    the window's start on.  A request still live has no ``e2e_s``."""
    reqs = [e for e in rec.snapshot() if e["retire"] != "shutdown"]
    steps = [s for s in rec.engine_steps(limit=-1) if t0 <= s["t"]]
    return {"requests": [{k: e[k] for k in ("ttft_s", "tpot_s",
                                             "queue_wait_s", "e2e_s")}
                         for e in reqs],
            "step_s": [s["dur_s"] for s in steps]}


def _profile(dev, t0: float, slice_s: float):
    """``torch.profiler`` over ``slice_s`` seconds from ``t0``, while the
    engine thread serves."""
    from torch.profiler import ProfilerActivity, profile

    while time.monotonic() < t0:
        time.sleep(0.001)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        p0 = time.perf_counter()
        time.sleep(slice_s)
        sync(dev)
        p1 = time.perf_counter()
    return prof, p1 - p0


def _time_moe(lm, spec, tr: dict, slots: int, dev) -> list:
    """Device seconds of one MoE layer's forward (the served model's layer
    0) at the cell's two call shapes: a decode step of ``slots`` rows and
    a prefill chunk of the largest power of two not above the median
    prompt; each with the work that shape needs.  Its input is what the
    layer hands it: a residual in the served type through the layer's
    ``mlp_norm``."""
    if dev.type != "cuda":
        return None
    layer = lm.engine.model.layers[0]
    moe = layer.moe_mlp
    chunk = 1 << (int(tr["prompt"]["median"]).bit_length() - 1)
    g = torch.Generator(device=dev).manual_seed(0)
    out = []
    with torch.no_grad():
        for rows, length in ((slots, 1), (1, chunk)):
            x = layer.mlp_norm(torch.randn(
                (rows, length, spec.hidden), generator=g, device=dev,
                dtype=spec.torch_dtype))
            probs = torch.softmax(x.reshape(-1, spec.hidden).float()
                                  @ moe.router.float(), -1)
            hit = int(probs.topk(spec.top_k, -1).indices.unique().numel())
            seconds = common.cuda_seconds(lambda: moe(x), reps=10)
            f, b = flops.moe_call_work(rows * length, spec, hit)
            out.append({"tokens": rows * length, "seconds": seconds,
                        "flops": f, "bytes": b})
    return out
