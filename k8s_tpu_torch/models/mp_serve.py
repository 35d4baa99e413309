"""Multi-process serving gang: entry point and local gang driver, port of
``k8s_tpu/models/mp_serve.py``.

Every process of a multi-process serving TFJob runs THIS module (the
serving counterpart of e2e.rendezvous_worker):

1. reads the operator-injected env contract through
   ``launcher.bootstrap`` and brings up ``torch.distributed``: a serving
   gang rendezvouses exactly like a training gang;
2. builds the identical model (the same seed) on every process;
3. process 0 (the chief) builds the engine over a
   ``mesh_serve.MeshPlacement`` (params split over the tp ranks, the KV
   pool split by kv head, the per-step plan broadcast over the plan bus)
   and serves a fixed request script;
4. every other process runs ``mesh_serve.follower_loop``: replay the
   plan, exit 0 on the chief's bye, exit non-zero when the plan stream
   dies, so the operator's whole-gang restart policy applies to serving
   gangs unchanged.

``run_serve_gang`` is the local driver: N real OS processes under the
launcher env contract (``launcher/bootstrap.py`` reads it: the
coordinator on loopback, ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``,
``K8S_TPU_PLATFORM``), supervised with gang semantics.

    python -m k8s_tpu_torch.models.mp_serve --gang 2        # spawn + supervise
    python -m k8s_tpu_torch.models.mp_serve --script r.json # one gang member
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional

log = logging.getLogger(__name__)

CHIEF_OK = "SERVE_MP_OK "
WORKER_OK = "SERVE_MP_WORKER "
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_model(seed: int = 0, *, vocab: int = 256, hidden: int = 64,
                ffn: Optional[int] = None, layers: int = 2, heads: int = 4,
                kv_heads: Optional[int] = None, max_seq_len: int = 128):
    """Deterministic tiny serving model: the same seed gives the same
    params on every process (drawn on the CPU), so no parameter
    broadcast is needed (the production path loads the same artifact on
    every pod for the same reason).  Returns ``(config, state dict)``."""
    import torch

    from k8s_tpu_torch.models.bridge import init_params
    from k8s_tpu_torch.models.transformer import TransformerConfig

    config = TransformerConfig(
        vocab_size=vocab, hidden=hidden, ffn_hidden=ffn or 2 * hidden,
        layers=layers, heads=heads, kv_heads=kv_heads or heads,
        max_seq_len=max_seq_len, dtype=torch.float32, remat=False)
    return config, init_params(config, seed, device="cpu")


def default_script(n_per_lane: int = 2, max_new: int = 8) -> list[dict]:
    """The three-lane fixed-seed request set (greedy, sampled,
    speculative) the token-identity bar is held over."""
    out: list[dict] = []
    for i in range(n_per_lane):
        base = [(i * 13 + j * 7 + 1) % 256 for j in range(6 + i)]
        out.append({"tokens": base, "max_new_tokens": max_new})
        out.append({"tokens": base, "max_new_tokens": max_new,
                    "temperature": 1.0, "seed": 100 + i})
        cycle = [(i * 29 + j * 11 + 3) % 256 for j in range(5)]
        out.append({"tokens": [cycle[j % 5] for j in range(15)],
                    "max_new_tokens": max_new, "speculative": 3,
                    "seed": 200 + i})
        out.append({"tokens": [cycle[j % 5] for j in range(15)],
                    "max_new_tokens": max_new, "speculative": 4,
                    "temperature": 0.8, "top_k": 7, "seed": 300 + i})
    return out


def warmup_script(script: list[dict]) -> list[dict]:
    """Same shapes (prompt lengths, max_new, lanes, draft widths),
    different token content and seeds: warms the allocator and the
    kernels' first launches without seeding the prefix tree with the
    measured prompts."""
    out = []
    for r in script:
        w = dict(r)
        w["tokens"] = [(int(t) + 1) % 251 for t in r["tokens"]]
        w["seed"] = int(r.get("seed", 0)) + 7919
        out.append(w)
    return out


def _run_script(engine, script: list[dict], threads: int = 1,
                timeout: float = 300.0) -> dict:
    """Submit every request (``threads`` closed-loop submitters; 1 keeps
    strict order for identity runs, though the engine's batching
    invariance makes outputs independent of interleaving either way) and
    collect per-request tokens in script order."""
    import numpy as np

    results: list = [None] * len(script)
    errors: list[str] = []
    lock = threading.Lock()
    cursor = [0]

    def submit(i: int) -> None:
        r = script[i]
        try:
            toks = engine.submit(
                np.asarray(r["tokens"], np.int64),
                int(r.get("max_new_tokens", 8)),
                eos_id=r.get("eos"),
                temperature=float(r.get("temperature", 0.0)),
                top_k=r.get("top_k"),
                seed=int(r.get("seed", 0)),
                speculative=int(r.get("speculative", 0)), timeout=timeout)
            results[i] = [int(t) for t in toks]
        except Exception as e:  # noqa: BLE001 - collected, gang-fatal below
            with lock:
                errors.append(f"request {i}: {type(e).__name__}: {e}")

    t0 = time.monotonic()
    if threads <= 1:
        for i in range(len(script)):
            submit(i)
    else:
        def worker() -> None:
            while True:
                with lock:
                    if cursor[0] >= len(script):
                        return
                    i = cursor[0]
                    cursor[0] += 1
                submit(i)

        ts = [threading.Thread(target=worker, daemon=True)
              for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    wall = time.monotonic() - t0
    tokens = sum(len(r) for r in results if r)
    return {"results": results, "errors": errors,
            "wall_s": round(wall, 4), "tokens": tokens,
            "tokens_per_s": round(tokens / max(wall, 1e-9), 2)}


def member_main(args) -> int:
    """One gang member (chief or follower), inside the operator env."""
    from k8s_tpu_torch.launcher import bootstrap
    from k8s_tpu_torch.models import mesh_serve
    from k8s_tpu_torch.ops import _common

    pin = os.environ.get("K8S_TPU_SERVE_MP_CPU", "")
    if pin and hasattr(os, "sched_setaffinity"):
        # one core a member (run_serve_gang(pin_cpus=True)): a per-process
        # comparison on a CPU gang means something only when each process
        # gets one core's worth of compute
        os.sched_setaffinity(0, {int(pin) % (os.cpu_count() or 1)})
    lcfg = bootstrap.initialize_distributed(
        device=bootstrap.default_device())
    device = bootstrap.process_device()
    config, params = build_model(
        args.seed, vocab=args.vocab, hidden=args.hidden,
        layers=args.layers, heads=args.heads, max_seq_len=args.max_seq_len)
    chief_host = (lcfg.coordinator_address.rsplit(":", 1)[0]
                  if lcfg.coordinator_address else "127.0.0.1")
    if lcfg.num_processes > 1 and lcfg.process_id != 0:
        return mesh_serve.follower_loop(config, params,
                                        chief_host=chief_host,
                                        device=device)

    # ---- chief: the engine over the mesh placement, then the script ----
    from k8s_tpu_torch.models.engine import Engine

    placement = mesh_serve.MeshPlacement.from_env(config, device=device)
    engine = Engine(config, params, slots=args.slots,
                    queue_limit=max(64, len(args.script_requests) + 1),
                    placement=placement)
    try:
        if args.warmup:
            warm = _run_script(engine, warmup_script(args.script_requests),
                               threads=args.threads)
            if warm["errors"]:
                raise RuntimeError(f"warmup failed: {warm['errors'][:3]}")
        out = _run_script(engine, args.script_requests,
                          threads=args.threads)
        stats = engine.stats()
    finally:
        engine.shutdown()
    # after shutdown: the bus is drained and closed, so the send and
    # enqueue totals cover every broadcast of the run
    payload = {
        "plan_bus": placement.plan_bus_stats(),
        "num_processes": lcfg.num_processes,
        "tp_degree": stats["tp_degree"],
        "mesh_shape": stats["mesh_shape"],
        "placement": stats["placement"],
        "decode_programs": stats["decode_programs"],
        "prefill_programs": stats["prefill_programs"],
        "spec_mean_accepted": stats["spec_mean_accepted"],
        "compile_ledger": None,
        # this process's kernel launches (serving and warm-up)
        "launches": _common.launches(),
        "pool_local_fraction": placement.pool_local_fraction,
        "params_local_fraction": placement.params_local_fraction,
        # the cores this process may run on (one when pinned)
        "cpu_affinity": sorted(os.sched_getaffinity(0))
        if hasattr(os, "sched_getaffinity") else None,
        **out,
    }
    print(CHIEF_OK + json.dumps(payload, sort_keys=True), flush=True)
    return 1 if out["errors"] else 0


# ------------------------------------------------------------ gang driver


@dataclasses.dataclass
class GangResult:
    """What a supervised gang did: each process's exit code (None for a
    member still running at the deadline, then killed), the chief's
    parsed payload, each process's output, the wall time, the order the
    processes died in, each member's exit as seconds after spawn (None
    if never seen) and, in the chief-crash drill, when the chief was
    killed."""

    exit_codes: list
    chief_result: Optional[dict]
    worker_outputs: list
    duration_s: float
    death_order: list
    exit_s: list = dataclasses.field(default_factory=list)
    chief_killed_s: Optional[float] = None

    @property
    def success(self) -> bool:
        return all(rc == 0 for rc in self.exit_codes)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def gang_env(n_processes: int, index: int, port: int,
             plan_port: int) -> dict:
    """Member ``index``'s env under the launcher contract
    (launcher/bootstrap.py): the coordinator on loopback, the world size
    and rank, the CPU, and the serving mesh's knobs."""
    return {"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
            "JAX_NUM_PROCESSES": str(n_processes),
            "JAX_PROCESS_ID": str(index),
            "K8S_TPU_PLATFORM": "cpu",
            "K8S_TPU_SERVE_MESH": str(n_processes),
            "K8S_TPU_SERVE_PLAN_PORT": str(plan_port)}


def run_serve_gang(n_processes: int, *, script: Optional[list] = None,
                   threads: int = 1, slots: int = 4, seed: int = 0,
                   hidden: int = 64, layers: int = 2, heads: int = 4,
                   vocab: int = 256, max_seq_len: int = 128,
                   timeout: float = 420.0,
                   kill_chief_after: Optional[float] = None,
                   kill_chief_when: Optional[str] = None,
                   extra_env: Optional[dict] = None,
                   pin_cpus: bool = False, warmup: bool = False):
    """Spawn an n-process serving gang as real OS processes under the
    launcher env contract and supervise it with gang semantics.  Returns
    ``(GangResult, [each follower's SERVE_MP_WORKER payload])``.

    ``kill_chief_after`` hard-kills process 0 after that many seconds of
    runtime (counted from the moment the chief's output first shows
    ``kill_chief_when``, when that is given: e.g. the plan bus's "worker
    N/N connected" line, so the kill lands in steady state however slow
    the bring-up): the chief-crash drill, whose bar is that the followers
    exit non-zero rather than hang (plan-bus EOF -> rc 1, or a collective
    that fails within ``mesh_serve.COLLECTIVE_TIMEOUT_S``), so the
    operator's whole-gang restart policy fires.

    ``pin_cpus`` pins member i to core i (modulo the host's count) through
    ``K8S_TPU_SERVE_MP_CPU``, as the reference's does."""
    script = script if script is not None else default_script()
    port = free_port()
    plan_port = free_port()
    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) \
            as f:
        json.dump(script, f)
        script_path = f.name
    argv = ["--script", script_path, "--slots", str(slots),
            "--seed", str(seed), "--hidden", str(hidden),
            "--layers", str(layers), "--heads", str(heads),
            "--vocab", str(vocab), "--max-seq-len", str(max_seq_len),
            "--threads", str(threads),
            "--warmup", "1" if warmup else "0"]

    procs: list = []
    logs = []
    t0 = time.time()
    try:
        for i in range(n_processes):
            env = dict(os.environ)
            env.update(gang_env(n_processes, i, port, plan_port))
            env["OMP_NUM_THREADS"] = env.get("OMP_NUM_THREADS", "1")
            env["PYTHONPATH"] = REPO_ROOT + os.pathsep \
                + env.get("PYTHONPATH", "")
            if pin_cpus:
                env["K8S_TPU_SERVE_MP_CPU"] = str(i)
            if extra_env:
                env.update(extra_env)
            logf = tempfile.TemporaryFile()
            logs.append(logf)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "k8s_tpu_torch.models.mp_serve"]
                + argv, env=env, cwd=REPO_ROOT, stdout=logf,
                stderr=subprocess.STDOUT))

        deadline = t0 + timeout
        exit_codes: list = [None] * n_processes
        exit_s: list = [None] * n_processes
        death_order: list = []
        hung: list = []  # members still running at the deadline
        chief_killed_at: Optional[float] = None
        kill_clock = None if kill_chief_when else t0
        while time.time() < deadline:
            if kill_clock is None and kill_chief_when.encode() in os.pread(
                    logs[0].fileno(), 1 << 20, 0):
                kill_clock = time.time()
            if kill_chief_after is not None and chief_killed_at is None \
                    and kill_clock is not None \
                    and time.time() > kill_clock + kill_chief_after \
                    and procs[0].poll() is None:
                procs[0].kill()  # the drill: the chief dies without a bye
                chief_killed_at = time.time()
            for i, p in enumerate(procs):
                if exit_codes[i] is None and p.poll() is not None:
                    exit_codes[i] = p.returncode
                    exit_s[i] = time.time() - t0
                    death_order.append(i)
            if all(rc is not None for rc in exit_codes):
                break
            time.sleep(0.1)
        else:
            for i, p in enumerate(procs):
                if p.poll() is None:
                    hung.append(i)
                    p.kill()

        outputs = []
        chief_result = None
        worker_results = []
        for i, p in enumerate(procs):
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            if i not in hung:  # a member killed at the deadline reads None
                exit_codes[i] = p.returncode
            logs[i].seek(0)
            out = logs[i].read().decode(errors="replace")
            logs[i].close()
            outputs.append(out or "")
            for line in (out or "").splitlines():
                if line.startswith(CHIEF_OK):
                    chief_result = json.loads(line[len(CHIEF_OK):])
                elif line.startswith(WORKER_OK):
                    worker_results.append(json.loads(line[len(WORKER_OK):]))
        return GangResult(
            exit_codes=exit_codes, chief_result=chief_result,
            worker_outputs=outputs, duration_s=time.time() - t0,
            death_order=death_order, exit_s=exit_s,
            chief_killed_s=None if chief_killed_at is None
            else chief_killed_at - t0), worker_results
    finally:
        # an exception mid-spawn or mid-supervision must not orphan live
        # gang members: a chief parked in accept_workers and followers
        # parked in rendezvous would burn CPU long past the run
        for p in procs:
            if p.poll() is None:
                p.kill()
                try:
                    p.wait(timeout=10)
                except Exception:  # noqa: BLE001 - best-effort teardown
                    pass
        try:
            os.unlink(script_path)
        except OSError:
            pass


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--gang", type=int, default=0,
                   help="driver mode: spawn and supervise an N-process "
                   "local serving gang (0 = run as one gang member)")
    p.add_argument("--script", default=None,
                   help="JSON request-script path (member mode)")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--max-seq-len", type=int, default=128)
    p.add_argument("--warmup", type=int, choices=(0, 1), default=0,
                   help="run a shape-identical warmup pass before the "
                   "timed script")
    p.add_argument("--timeout", type=float, default=420.0)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.gang > 0:
        res, workers = run_serve_gang(
            args.gang, slots=args.slots, threads=args.threads,
            seed=args.seed, hidden=args.hidden, layers=args.layers,
            heads=args.heads, vocab=args.vocab,
            max_seq_len=args.max_seq_len, timeout=args.timeout,
            warmup=bool(args.warmup))
        print(json.dumps({
            "success": res.success, "exit_codes": res.exit_codes,
            "chief": res.chief_result, "workers": workers,
            "duration_s": round(res.duration_s, 1)}, sort_keys=True))
        if not res.success:
            for i, out in enumerate(res.worker_outputs):
                sys.stderr.write(f"--- proc {i} rc={res.exit_codes[i]} "
                                 f"---\n{out[-2000:]}\n")
        return 0 if res.success else 1
    if args.script:
        with open(args.script) as f:
            args.script_requests = json.load(f)
    else:
        args.script_requests = default_script()
    return member_main(args)


if __name__ == "__main__":
    sys.exit(main())
