"""Disaggregated prefill/decode serving bench: decode p99 under a
long-prompt storm, split tiers against the collapsed baseline.  The port
of ``k8s_tpu/harness/bench_disagg.py``.

    python -m k8s_tpu_torch.harness.bench_disagg                # the card
    python -m k8s_tpu_torch.harness.bench_disagg --device cpu --hidden 64 \\
        --layers 2 --duration 1                                 # no card

The scenario: steady short decodes share a serving fleet with bursts of
long prompts, and every long admission's chunked prefill runs inside the
engine loop, so decode-ready slots stall behind it (the convoy
``serve_prefill_convoy_total`` counts).  Disaggregation splits the fleet
into a prefill tier (chunk-prefill, first token, export the block chain:
no decode slot held) and a decode tier (graft imported chains: no model
forward a migrated request), with the router phase-splitting traffic by
prompt length and the KV block-transfer plane (``models/kvxfer.py``)
carrying the chains between real engines over real sockets.

Both arms run the same three pods (1 prefill + 2 decode pods against 3
collapsed pods), each pod an OS process pinned to its own third of the
host's cores, the same model, the same router and the same phases:

- ``unloaded``: short decode clients only;
- ``storm1x``: shorts + N long-prompt clients;
- ``storm2x``: shorts + 2N long-prompt clients.

Failures (a violation attaches ``failures`` and raises with the result
on the exception; the JSON line lands either way):

- **decode p99 stays flat on the split topology**: disaggregated shorts'
  p99 at storm2x <= ``flat_factor`` (1.25) x its unloaded p99;
- **the collapsed baseline convoys**: collapsed shorts' p99 at storm2x
  >= ``convoy_factor`` (2.0) x its unloaded p99, with
  ``serve_prefill_convoy_total`` > 0 on its pods;
- **fixed-seed identity**: a long (prompt, seed) answered through the
  disaggregated router (prefill, migrate, decode on another engine) is
  token-identical to a local single-engine call, greedy and sampled;
- **migration really happened**: blocks migrated > 0 in the storm
  phases, with the per-token transfer overhead
  (``serve_kv_migrate_seconds`` sum over migrated tokens emitted)
  reported.

The two p99 bounds assume the prefill tier's compute is not the decode
tier's, as on the reference's CPU pods.  On one card the three pods
split the host's cores but time-share the one GPU.

The router is the port's own copy of the reference router's pieces the
bench drives (``harness/disagg_router.py``: the ring, the affine plan,
the phase split, the retry walk; its docstring names what it leaves
out), and ``/metrics`` is read by that module's exposition reader.

Deliberate differences from the reference:

- (a) ``--device`` (default ``cuda``) goes to every pod and to the
  local oracle; pods get ``K8S_TPU_PLATFORM`` rather than
  ``JAX_PLATFORMS``.  Asking for CUDA without a card raises in the pod,
  and the bring-up error carries its output.
- (b) ``run_bench(model=...)`` / ``--model JSON``: a preset of
  ``models/transformer.py`` with field overrides (``{"preset":
  "llama_8b", "layers": 16, "dtype": "bfloat16", ...}``), built in each
  pod by ``bridge.init_params(cfg, 0, device)``; the default is the
  reference's ``build_model(0, hidden, layers)``.
- (c) each pod reports, when stopped (SIGTERM, one final line read
  under a bounded wait, then a kill), its kernel launches
  (``ops/_common.launches()``), its engine's ``model_calls``, both
  counted from its ready line, and its peak device memory; its ready
  line carries a digest of one weight tensor and the parent times its
  bring-up.  ``_run_arm`` returns these as ``pods``.

``measure`` runs the oracle and both arms, ``judge`` holds them to the
bounds (the reference's inline checks, same messages, same order), and
``run_bench`` is the two.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import urllib.request

from k8s_tpu_torch.harness import disagg_router
from k8s_tpu_torch.util.util import quantile_nearest as _quantile

DEFAULT_FLAT_FACTOR = 1.25
DEFAULT_CONVOY_FACTOR = 2.0


def _short_prompt(rank: int, i: int, n: int = 8) -> list[int]:
    return [(rank * 17 + i * 13 + j * 5 + 1) % 256 for j in range(n)]


def _long_prompt(rank: int, i: int, n: int) -> list[int]:
    return [(rank * 41 + i * 97 + j * 7 + 11) % 256 for j in range(n)]


def _post(port: int, body: dict, timeout: float = 120.0) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def build_pod_model(model, hidden: int, layers: int, device="cuda"):
    """``(config, state dict)`` of the served model: the reference's
    ``bench_serve.build_model(0, hidden, layers)`` when ``model`` is
    None, else the ``models/transformer.py`` preset ``model["preset"]``
    with the other keys replacing its fields (``dtype`` by name), drawn
    by ``bridge.init_params(cfg, 0, device)``."""
    import dataclasses

    import torch

    from k8s_tpu_torch.harness.bench_serve import build_model
    from k8s_tpu_torch.models import transformer
    from k8s_tpu_torch.models.bridge import init_params

    if model is None:
        return build_model(0, hidden=hidden, layers=layers, device=device)
    fields = dict(model)
    cfg = getattr(transformer, fields.pop("preset"))()
    if "dtype" in fields:
        fields["dtype"] = getattr(torch, fields["dtype"])
    cfg = dataclasses.replace(cfg, **fields)
    return cfg, init_params(cfg, 0, device=device)


def weights_digest(params: dict) -> dict:
    """sha1 of the bytes of the last layer tensor drawn (the last one
    ``init_params`` draws): equal digests mean every copy drew the same
    weights in the same order."""
    import hashlib

    import torch

    name = [k for k in params if k.startswith("layers.")][-1]
    t = params[name].detach().contiguous().view(torch.uint8).cpu()
    return {"tensor": name,
            "sha1": hashlib.sha1(t.numpy().tobytes()).hexdigest()}


class _Fleet:
    """One measured topology: three serving pods, each an OS process
    pinned to its own CPU share, behind the router.  ``disagg=True``
    makes pod 0 the prefill tier and pods 1-2 the decode tier with the
    phase split at ``phase_tokens``; otherwise every pod is a collapsed
    single-role server."""

    def __init__(self, *, disagg: bool, slots: int, phase_tokens: int,
                 hidden: int, layers: int, block_size: int, model=None,
                 device: str = "cuda"):
        self.disagg = disagg
        # one prefill pod feeding two decode pods, against three
        # collapsed pods on the same budget
        roles = ("prefill", "decode", "decode") if disagg \
            else ("", "", "")
        # split the host's cores between the pods, the same split in
        # both arms
        cpus = sorted(os.sched_getaffinity(0)) \
            if hasattr(os, "sched_getaffinity") else []
        share = len(cpus) // len(roles)
        cpu_sets = [cpus[i * share:(i + 1) * share] if share >= 1
                    else None for i in range(len(roles))]
        self.pods: list[_SubprocPod] = []
        self.server = None
        try:
            # the pods come up together: each draws its weights and
            # starts its server on its own cores
            for i in range(len(roles)):
                self.pods.append(_SubprocPod(
                    role=roles[i], cpus=cpu_sets[i], slots=slots,
                    hidden=hidden, layers=layers, model=model,
                    device=device))
            for pod in self.pods:
                pod.wait_ready()
            self.ports = [p.port for p in self.pods]
            targets = []
            for i, role in enumerate(roles):
                if role == "prefill":
                    targets.append((f"pod-prefill-{i}",
                                    f"http://127.0.0.1:{self.ports[i]}",
                                    "prefill", None))
                elif role == "decode":
                    targets.append((
                        f"pod-decode-{i}",
                        f"http://127.0.0.1:{self.ports[i]}", "decode",
                        f"127.0.0.1:{self.pods[i].kvxfer_port}"))
                else:
                    targets.append((f"pod-{i}",
                                    f"http://127.0.0.1:{self.ports[i]}"))
            # fingerprint at the engine's block size, read back from the
            # pod
            engine_block = int(self.serving_info(0).get("block_size")
                               or block_size)
            self.router = disagg_router.Router(
                lambda: targets, block_size=engine_block,
                phase_split_tokens=phase_tokens if disagg else None)
            self.server = disagg_router.RouterServer(self.router)
            self.server.start()
        except BaseException:
            self.stop()  # no pod outlives a failed bring-up
            raise
        self.port = self.server.port

    def metric_value(self, pod: int, family: str, suffix: str = ""
                     ) -> float:
        """One un-labeled sample value off pod ``pod``'s own /metrics."""
        with urllib.request.urlopen(
                f"http://127.0.0.1:{self.ports[pod]}/metrics",
                timeout=30) as resp:
            text = resp.read().decode()
        value = disagg_router.sample_value(text, family + suffix)
        return 0.0 if value is None else value

    def serving_info(self, pod: int) -> dict:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{self.ports[pod]}/healthz",
                timeout=30) as resp:
            return json.loads(resp.read())["serving"]

    def decode_pods(self) -> list[int]:
        """Indices of the pods that can seat migrations."""
        return [i for i, p in enumerate(self.pods)
                if p.kvxfer_port is not None]

    def blocks_migrated(self) -> float:
        return sum(self.metric_value(i, "serve_kv_blocks_migrated_total")
                   for i in self.decode_pods())

    def kv_imports(self) -> int:
        return int(sum(int(self.serving_info(i).get("kv_imports") or 0)
                       for i in self.decode_pods()))

    def convoys(self) -> int:
        return int(sum(self.metric_value(i, "serve_prefill_convoy_total")
                       for i in range(len(self.pods))))

    def stop(self) -> None:
        if self.server is not None:
            self.server.stop()
        for p in self.pods:
            p.stop()


POD_READY = "DISAGG_POD "
POD_STATS = "DISAGG_POD_STATS "


class _SubprocPod:
    """One serving pod as an OS process (``bench_disagg --pod``), maybe
    pinned to a CPU set: builds the seed-deterministic model, runs
    LmServer and its HTTP listener, prints its ports, and serves until
    SIGTERM, when it prints its counters (``stats``).  The constructor
    starts the process and returns; ``wait_ready`` blocks until it is up
    (so that a fleet's pods come up together), and a pod that dies or
    stays silent for ``timeout`` seconds during bring-up raises there
    with its output's tail."""

    def __init__(self, *, role: str, cpus, slots: int, hidden: int,
                 layers: int, timeout: float = 300.0, model=None,
                 device: str = "cuda"):
        cmd = [sys.executable, "-m", "k8s_tpu_torch.harness.bench_disagg",
               "--pod", "--slots", str(slots), "--hidden", str(hidden),
               "--layers", str(layers), "--device", device]
        if role:
            cmd += ["--role", role]
        if cpus:
            cmd += ["--cpus", ",".join(str(c) for c in cpus)]
        if model is not None:
            cmd += ["--model", json.dumps(model)]
        env = dict(os.environ)
        env["K8S_TPU_PLATFORM"] = device
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo_root + os.pathsep \
            + env.get("PYTHONPATH", "")
        self.role = role
        self.port = None
        self.kvxfer_port = None
        self.weights = None
        self.stats = None
        self._tail: collections.deque = collections.deque(maxlen=30)
        self._lines: queue.Queue = queue.Queue()
        t0 = time.monotonic()
        self.proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=repo_root)
        # one reader drains the pipe for the pod's whole life, so the
        # child never blocks on a full buffer and no wait here is
        # unbounded
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        self._t0, self._deadline = t0, t0 + timeout

    def wait_ready(self) -> None:
        """Block until the pod prints its ready line (its ports)."""
        role = self.role
        while True:
            try:
                line = self._lines.get(
                    timeout=max(0.0, self._deadline - time.monotonic()))
            except queue.Empty:
                self.stop()
                raise RuntimeError(
                    f"disagg pod (role={role!r}) never became ready:\n"
                    + "".join(self._tail)) from None
            if line is None:
                self.stop()
                raise RuntimeError(
                    f"disagg pod (role={role!r}) died during bring-up:\n"
                    + "".join(self._tail))
            if line.startswith(POD_READY):
                info = json.loads(line[len(POD_READY):])
                self.port = info["port"]
                self.kvxfer_port = info["kvxfer_port"]
                self.weights = info.get("weights")
                break
        self.bringup_s = time.monotonic() - self._t0

    def _read(self) -> None:
        for line in self.proc.stdout:
            self._tail.append(line)
            if line.startswith(POD_STATS):
                self.stats = json.loads(line[len(POD_STATS):])
            elif self.port is None:
                self._lines.put(line)
        self._lines.put(None)

    def stop(self, timeout: float = 60.0) -> None:
        """SIGTERM, wait up to ``timeout`` seconds for the counters line
        and the exit, then kill."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
        self._reader.join(timeout=10)

    def report(self) -> dict:
        return {"role": self.role, "bringup_s": round(self.bringup_s, 2),
                "weights": self.weights, "exit_code": self.proc.returncode,
                "stats": self.stats}


def _pod_main(args) -> int:
    """``--pod`` mode: one serving pod process.  CPU affinity is applied
    before torch is imported, so its thread pool sizes to the pod's
    share of the host."""
    if args.cpus and hasattr(os, "sched_setaffinity"):
        os.sched_setaffinity(0, {int(c) for c in args.cpus.split(",")})
    import torch

    from k8s_tpu_torch.models import server as server_mod
    from k8s_tpu_torch.ops import _common
    from k8s_tpu_torch.util import metrics as metrics_mod

    model = json.loads(args.model) if args.model else None
    config, params = build_pod_model(model, args.hidden, args.layers,
                                     args.device)
    lm = server_mod.LmServer(
        config=config, params=params, slots=args.slots,
        queue_limit=256, role=args.role or "",
        kvxfer_port=0 if args.role == "decode" else None,
        registry=metrics_mod.Registry(), device=args.device)
    httpd = server_mod.serve(lm)
    cuda = lm.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    _common.reset_launches()
    calls0 = lm.engine.stats()["model_calls"]
    # from here on SIGTERM stops the pod through the counters line
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    print(POD_READY + json.dumps({
        "port": httpd.server_address[1],
        "kvxfer_port": lm._kv_receiver.port
        if lm._kv_receiver is not None else None,
        "role": args.role or "",
        "weights": weights_digest(params),
    }), flush=True)
    try:
        while not stop.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        if cuda:
            torch.cuda.synchronize()
        print(POD_STATS + json.dumps({
            "launches": _common.launches(),
            "model_calls": lm.engine.stats()["model_calls"] - calls0,
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2 ** 30 if cuda
                else None,
        }), flush=True)
        httpd.shutdown()
        lm.close()
    return 0


def _closed_loop_phase(fleet: _Fleet, *, shorts: int, longs: int,
                       duration_s: float, max_new_short: int,
                       max_new_long: int, long_len: int,
                       phase_tag: int) -> dict:
    """One measured phase: ``shorts`` closed-loop short-decode clients
    (their latencies are the metric) plus ``longs`` closed-loop
    long-prompt clients (the offered prefill load), all through the
    router, for ``duration_s``."""
    lock = threading.Lock()
    short_lat: list[float] = []
    long_lat: list[float] = []
    long_done = [0]
    errors: list[str] = []
    stop = threading.Event()
    barrier = threading.Barrier(shorts + longs + 1)

    def client(rank: int, is_long: bool) -> None:
        barrier.wait()
        time.sleep((rank % 7) * 0.003)  # desynchronize (bench_serve)
        i = 0
        while not stop.is_set():
            if is_long:
                body = {"tokens": _long_prompt(rank, i + phase_tag * 1000,
                                               long_len),
                        "max_new_tokens": max_new_long}
            else:
                body = {"tokens": _short_prompt(rank, i),
                        "max_new_tokens": max_new_short}
            t0 = time.monotonic()
            try:
                out = _post(fleet.port, body)
                if "tokens" not in out:
                    raise RuntimeError(f"bad response: {out}")
            except Exception as e:  # noqa: BLE001 - count, don't crash
                with lock:
                    errors.append(f"{type(e).__name__}: {e}")
                i += 1
                continue
            dt = time.monotonic() - t0
            with lock:
                if is_long:
                    long_lat.append(dt)
                    long_done[0] += 1
                else:
                    short_lat.append(dt)
            i += 1

    threads = [threading.Thread(target=client, args=(r, False),
                                daemon=True) for r in range(shorts)]
    threads += [threading.Thread(target=client, args=(100 + r, True),
                                 daemon=True) for r in range(longs)]
    for t in threads:
        t.start()
    barrier.wait()
    time.sleep(duration_s)
    stop.set()
    for t in threads:
        t.join(timeout=120)
    short_lat.sort()
    long_lat.sort()
    return {
        "shorts": shorts,
        "longs": longs,
        "duration_s": duration_s,
        "short_requests": len(short_lat),
        "long_requests": long_done[0],
        "errors": errors[:5],
        "error_count": len(errors),
        "short_p50_s": round(_quantile(short_lat, 0.50), 4)
        if short_lat else None,
        "short_p99_s": round(_quantile(short_lat, 0.99), 4)
        if short_lat else None,
        "long_p50_s": round(_quantile(long_lat, 0.50), 4)
        if long_lat else None,
    }


def _run_arm(*, disagg: bool, slots: int, phase_tokens: int,
             shorts: int, longs: int, duration_s: float,
             max_new_short: int, max_new_long: int, long_len: int,
             hidden: int, layers: int,
             identity_probes: list | None = None, model=None,
             device: str = "cuda") -> dict:
    fleet = _Fleet(disagg=disagg, slots=slots,
                   phase_tokens=phase_tokens, hidden=hidden,
                   layers=layers, block_size=16, model=model,
                   device=device)
    try:
        # warm every path on the pods that will run it, so no phase
        # pays a first use: every prefill bucket, the short and long
        # shapes, and one full migration to each decode pod on the split
        # topology
        blen = 1
        buckets = []
        while blen < long_len:
            buckets.append(blen)
            blen *= 2
        for port in fleet.ports:
            for blen in buckets:
                _post(port, {"tokens": _short_prompt(901, blen, blen),
                             "max_new_tokens": 1})
            _post(port, {"tokens": _short_prompt(900, 0),
                         "max_new_tokens": max_new_short})
        if disagg:
            for i in fleet.decode_pods():
                kv = f"127.0.0.1:{fleet.pods[i].kvxfer_port}"
                _post(fleet.ports[0],
                      {"tokens": _long_prompt(900, i, long_len),
                       "max_new_tokens": max_new_long, "kv_dest": kv})
        else:
            for port in fleet.ports:
                _post(port, {"tokens": _long_prompt(900, 0, long_len),
                             "max_new_tokens": max_new_long})
        identity = None
        if identity_probes:
            # fixed-seed identity through the full hop (router phase
            # split, prefill engine, socket migration, decode engine)
            # against the parent's local reference
            identity = {}
            for lane, body, expected in identity_probes:
                routed = _post(fleet.port, body)["tokens"]
                identity[lane] = {"ok": routed == expected,
                                  "local": expected, "routed": routed}
            identity["migrations"] = fleet.kv_imports()
        # unrecorded settle pass: the first seconds after bring-up carry
        # one-time costs that would land as phantom outliers in the
        # unloaded baseline's p99
        _closed_loop_phase(fleet, shorts=shorts, longs=0,
                           duration_s=min(2.5, duration_s),
                           max_new_short=max_new_short,
                           max_new_long=max_new_long,
                           long_len=long_len, phase_tag=9)
        phases = {}
        for tag, (name, n_long) in enumerate((
                ("unloaded", 0), ("storm1x", longs),
                ("storm2x", 2 * longs))):
            blocks_before = fleet.blocks_migrated() if disagg else 0.0
            t0 = time.monotonic()
            phases[name] = _closed_loop_phase(
                fleet, shorts=shorts, longs=n_long,
                duration_s=duration_s, max_new_short=max_new_short,
                max_new_long=max_new_long, long_len=long_len,
                phase_tag=tag)
            wall = time.monotonic() - t0
            if disagg:
                migrated = fleet.blocks_migrated() - blocks_before
                phases[name]["blocks_migrated"] = int(migrated)
                phases[name]["blocks_per_s_migrated"] = round(
                    migrated / wall, 1)
        out = {
            "topology": "disaggregated" if disagg else "collapsed",
            "phases": phases,
            "prefill_convoys_total": fleet.convoys(),
        }
        if identity is not None:
            out["identity"] = identity
        if disagg:
            # per-token transfer overhead: sender-side migration seconds
            # (send to seated ack) over the tokens migrated requests
            # emitted on the decode tier
            mig_sum = fleet.metric_value(0, "serve_kv_migrate_seconds",
                                         "_sum")
            mig_count = fleet.metric_value(0, "serve_kv_migrate_seconds",
                                           "_count")
            long_tokens = sum(
                p["long_requests"] for p in phases.values()) \
                * max_new_long
            out["migrations"] = int(mig_count)
            out["migrate_seconds_total"] = round(mig_sum, 4)
            out["migrate_s_per_migration"] = round(
                mig_sum / mig_count, 5) if mig_count else None
            out["transfer_overhead_s_per_token"] = round(
                mig_sum / long_tokens, 6) if long_tokens else None
            out["kv_exports"] = \
                int(fleet.serving_info(0).get("kv_exports") or 0)
            out["kv_imports"] = fleet.kv_imports()
    finally:
        fleet.stop()
    out["pods"] = [p.report() for p in fleet.pods]
    return out


def _reference_outputs(long_len: int, max_new: int, hidden: int,
                       layers: int, model=None,
                       device: str = "cuda") -> list:
    """The parent-side local oracle: greedy and sampled outputs for the
    identity probe prompt from one local engine.  The engine is torn
    down (and, on the card, its memory returned) before any pod
    spawns."""
    import gc

    import numpy as np
    import torch

    from k8s_tpu_torch.models.engine import Engine

    config, params = build_pod_model(model, hidden, layers, device)
    engine = Engine(config, params, slots=2, queue_limit=16, device=device)
    try:
        probes = []
        prompt = _long_prompt(7, 7, long_len)
        for lane, extra in (("greedy", {}),
                            ("sampled", {"temperature": 1.0, "top_k": 7,
                                         "seed": 1234})):
            local = [int(t) for t in engine.submit(
                np.asarray(prompt, np.int32), max_new,
                temperature=float(extra.get("temperature", 0.0)),
                top_k=extra.get("top_k"),
                seed=int(extra.get("seed", 0)), timeout=600)]
            probes.append((lane,
                           {"tokens": prompt, "max_new_tokens": max_new,
                            **extra},
                           local))
        return probes
    finally:
        engine.shutdown()
        del engine, params
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def measure(shorts: int = 4, longs: int = 3, slots: int = 12,
            duration_s: float = 4.0, max_new_short: int = 17,
            max_new_long: int = 5, long_len: int = 112,
            phase_tokens: int = 48, hidden: int = 256, layers: int = 4,
            model=None, device: str = "cuda") -> dict:
    """The local oracle, then both arms, the disaggregated one first
    (whichever arm runs first also absorbs the parent's one-time costs
    as a fatter unloaded tail, which dilutes its storm ratio: that bias
    is conservative for the flatness bound and must not dilute the
    collapsed arm's convoy ratio).  Returns ``{arm name: arm}``; the
    disaggregated arm carries ``identity``."""
    from k8s_tpu_torch.ops._common import resolve_device

    resolve_device(device)  # a CUDA request without a card raises here
    probes = _reference_outputs(long_len, 12, hidden, layers, model=model,
                                device=device)
    arms = {}
    for disagg in (True, False):
        arms["disaggregated" if disagg else "collapsed"] = _run_arm(
            disagg=disagg, slots=slots,
            phase_tokens=phase_tokens, shorts=shorts, longs=longs,
            duration_s=duration_s, max_new_short=max_new_short,
            max_new_long=max_new_long, long_len=long_len,
            hidden=hidden, layers=layers,
            identity_probes=probes if disagg else None, model=model,
            device=device)
    return arms


def judge(arms: dict, *, shorts: int, longs: int, slots: int,
          duration_s: float, max_new_short: int, max_new_long: int,
          long_len: int, phase_tokens: int, hidden: int, layers: int,
          flat_factor: float = DEFAULT_FLAT_FACTOR,
          convoy_factor: float = DEFAULT_CONVOY_FACTOR,
          model=None) -> tuple[dict, list[str]]:
    """The reference's bounds over ``measure``'s arms (the disaggregated
    arm's ``identity`` is popped): ``(result, failures)``."""
    failures: list[str] = []
    identity = arms["disaggregated"].pop("identity")
    for lane in ("greedy", "sampled"):
        if not identity[lane]["ok"]:
            failures.append(
                f"fixed-seed {lane} output through the disaggregated "
                f"hop differs from local: migration changed the math "
                f"(local {identity[lane]['local'][:6]}... vs routed "
                f"{identity[lane]['routed'][:6]}...)")
    if identity["migrations"] < 1:
        failures.append(
            "identity probes never migrated: the phase split did not "
            "route through the prefill tier")

    dis, col = arms["disaggregated"], arms["collapsed"]
    for name, arm in arms.items():
        errs = sum(p["error_count"] for p in arm["phases"].values())
        if errs:
            failures.append(
                f"{name} arm: {errs} request error(s) "
                f"(first: {next(p['errors'] for p in arm['phases'].values() if p['errors'])})")

    def _ratio(arm) -> tuple:
        base = arm["phases"]["unloaded"]["short_p99_s"]
        stormed = arm["phases"]["storm2x"]["short_p99_s"]
        if not base or not stormed:
            return None, base, stormed
        return stormed / base, base, stormed

    dis_ratio, dis_base, dis_storm = _ratio(dis)
    col_ratio, col_base, col_storm = _ratio(col)
    if dis_ratio is None or col_ratio is None:
        failures.append("a phase produced no short-request latencies")
    else:
        if dis_ratio > flat_factor:
            failures.append(
                f"disaggregated decode p99 degraded {dis_ratio:.2f}x "
                f"({dis_base}s -> {dis_storm}s) under a doubled prefill "
                f"storm (bound {flat_factor}x): the prefill tier is not "
                "absorbing the storm")
        if col_ratio < convoy_factor:
            failures.append(
                f"collapsed decode p99 only degraded {col_ratio:.2f}x "
                f"({col_base}s -> {col_storm}s) under the storm (expected "
                f">= {convoy_factor}x): the workload no longer convoys, "
                "so this bench proves nothing — retune it")
    if col["prefill_convoys_total"] < 1:
        failures.append(
            "collapsed arm recorded zero prefill convoys: the storm "
            "never actually stalled a decode-ready slot")
    storm_blocks = sum(
        dis["phases"][p].get("blocks_migrated", 0)
        for p in ("storm1x", "storm2x"))
    if storm_blocks < 1:
        failures.append(
            "no KV blocks migrated during the storm phases: the "
            "disaggregated arm never exercised the transfer plane")

    result = {
        "metric": "disagg_decode_p99_ratio_under_2x_prefill",
        "value": round(dis_ratio, 3) if dis_ratio else None,
        "unit": "x_vs_unloaded",
        "collapsed_ratio": round(col_ratio, 3) if col_ratio else None,
        "flat_factor_bound": flat_factor,
        "convoy_factor_bound": convoy_factor,
        "model": {"hidden": hidden, "layers": layers} if model is None
        else dict(model),
        "workload": {"shorts": shorts, "longs": longs,
                     "long_len": long_len, "phase_tokens": phase_tokens,
                     "max_new_short": max_new_short,
                     "max_new_long": max_new_long,
                     "duration_s": duration_s, "slots": slots},
        "identity": {
            "greedy_ok": identity["greedy"]["ok"],
            "sampled_ok": identity["sampled"]["ok"],
            "migrations": identity["migrations"],
        },
        "collapsed": col,
        "disaggregated": dis,
    }
    if failures:
        result["failures"] = failures
    return result, failures


def run_bench(shorts: int = 4, longs: int = 3, slots: int = 12,
              duration_s: float = 4.0, max_new_short: int = 17,
              max_new_long: int = 5, long_len: int = 112,
              phase_tokens: int = 48, hidden: int = 256,
              layers: int = 4,
              flat_factor: float = DEFAULT_FLAT_FACTOR,
              convoy_factor: float = DEFAULT_CONVOY_FACTOR,
              model=None, device: str = "cuda") -> dict:
    workload = dict(shorts=shorts, longs=longs, slots=slots,
                    duration_s=duration_s, max_new_short=max_new_short,
                    max_new_long=max_new_long, long_len=long_len,
                    phase_tokens=phase_tokens, hidden=hidden,
                    layers=layers)
    arms = measure(**workload, model=model, device=device)
    result, failures = judge(arms, **workload, flat_factor=flat_factor,
                             convoy_factor=convoy_factor, model=model)
    if failures:
        err = RuntimeError("disagg bench assertions failed:\n  "
                           + "\n  ".join(failures))
        err.result = result
        raise err
    return result


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--shorts", type=int, default=4)
    p.add_argument("--longs", type=int, default=3)
    p.add_argument("--slots", type=int, default=12)
    p.add_argument("--duration", type=float, default=4.0)
    p.add_argument("--long-len", type=int, default=112)
    p.add_argument("--phase-tokens", type=int, default=48)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--model", default="",
                   help="JSON: a models/transformer.py preset and field "
                   "overrides (default: the bench's hidden/layers model)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default), or cpu for the plain versions")
    p.add_argument("--out", default=None)
    # --pod mode: run as ONE serving pod process (spawned by _Fleet)
    p.add_argument("--pod", action="store_true",
                   help="internal: run as one serving pod process")
    p.add_argument("--role", default="",
                   choices=("", "prefill", "decode"))
    p.add_argument("--cpus", default="",
                   help="internal: comma-separated CPU affinity set")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    if args.pod:
        return _pod_main(args)

    def _write(payload: dict) -> None:
        line = json.dumps(payload)
        print(line)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                f.write(line + "\n")

    try:
        result = run_bench(
            shorts=args.shorts, longs=args.longs, slots=args.slots,
            duration_s=args.duration, long_len=args.long_len,
            phase_tokens=args.phase_tokens, hidden=args.hidden,
            layers=args.layers,
            model=json.loads(args.model) if args.model else None,
            device=args.device)
    except RuntimeError as e:
        partial = getattr(e, "result", None)
        if partial is not None:
            _write(partial)
        raise
    _write(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
