"""Multi-process tensor-parallel serving bench: a 1-process against an
N-process serving gang over the SAME fixed-seed three-lane workload.  The
port of ``k8s_tpu/harness/bench_serve_mp.py``, over the port's
``models/mp_serve.run_serve_gang``.

    python -m k8s_tpu_torch.harness.bench_serve_mp --device cpu --processes 4
    python -m k8s_tpu_torch.harness.bench_serve_mp --processes 1   # the card

Each arm is a real serving gang: N OS processes under the launcher env
contract, ``torch.distributed`` (gloo on the CPU, NCCL on CUDA, one card
a process), params split over the tp ranks, the KV pool split by kv head,
the chief broadcasting each step's plan over the plan bus.  Both arms run
a warm-up pass of the same shapes first, then the timed script (greedy,
sampled and speculative requests mixed).

Failures (a violation attaches ``failures`` and raises with the result on
the exception; the JSON line lands either way):

- **token identity**: the N-process gang emits the 1-process gang's
  tokens for every request of every lane;
- **memory sharding**: each process holds ~1/N of the KV pool and its
  share of the params, read from each worker's measured local tensors
  (``mesh_serve.local_fraction``), with the spec-derived expectation
  (``_shard_fractions``) beside it;
- **mesh overhead floor**: N-process aggregate tokens/s >=
  ``efficiency_floor`` x the 1-process arm's (default 0.12).  The floor
  is for the gloo CPU arms, whose per-layer all-reduces run over TCP
  loopback; it catches a mechanism that serializes the gang (a pool
  gather, a blocking plan send).  One H100 runs only the 1-process arm
  (NCCL puts no two ranks on one card);
- **plan pipelining**: the chief's broadcast is an enqueue, not a socket
  wait;
- **clean gang exits**: every process exits 0 in both arms.

Eager PyTorch compiles no programs, so the reference's
``K8S_TPU_COMPILE_LEDGER`` export and compile-budget failures have no
counterpart here.  One JSON line; ``--out`` also writes it to a file.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os

log = logging.getLogger(__name__)

# the regression floor of the gloo-loopback CPU gang (the reference's)
DEFAULT_EFFICIENCY_FLOOR = 0.12


def bench_script(requests: int, max_new: int) -> list[dict]:
    """The mixed three-lane fixed-seed workload both arms serve."""
    out: list[dict] = []
    for i in range(requests):
        lane = i % 3
        base = [(i * 13 + j * 7 + 1) % 256 for j in range(8)]
        if lane == 0:
            out.append({"tokens": base, "max_new_tokens": max_new})
        elif lane == 1:
            out.append({"tokens": base, "max_new_tokens": max_new,
                        "temperature": 1.0, "seed": 100 + i})
        else:
            cyc = [(i * 29 + j * 11 + 3) % 256 for j in range(5)]
            out.append({"tokens": [cyc[j % 5] for j in range(20)],
                        "max_new_tokens": max_new, "speculative": 4,
                        "seed": 200 + i})
    return out


def _arm(n: int, script: list, *, slots: int, threads: int, hidden: int,
         layers: int, timeout: float, device: str = "cuda") -> tuple:
    from k8s_tpu_torch.models import mp_serve

    return mp_serve.run_serve_gang(
        n, script=script, slots=slots, threads=threads, hidden=hidden,
        layers=layers, heads=8, max_seq_len=128, timeout=timeout,
        warmup=True, extra_env={"K8S_TPU_PLATFORM": device})


def run_bench(processes: int = 4, requests: int = 24, max_new: int = 24,
              slots: int = 8, threads: int = 10, hidden: int = 256,
              layers: int = 4, timeout: float = 420.0,
              efficiency_floor: float = DEFAULT_EFFICIENCY_FLOOR,
              device: str = "cuda") -> dict:
    from k8s_tpu_torch.ops._common import resolve_device

    resolve_device(device)  # a CUDA request without a card raises here
    script = bench_script(requests, max_new)
    failures: list[str] = []
    arms: dict[int, dict] = {}
    worker_audits: dict[int, list] = {}
    for n in (1, processes):
        res, workers = _arm(n, script, slots=slots, threads=threads,
                            hidden=hidden, layers=layers, timeout=timeout,
                            device=device)
        if not res.success or res.chief_result is None:
            tail = res.worker_outputs[-1][-800:] if res.worker_outputs \
                else ""
            failures.append(
                f"{n}-process gang failed: exit codes {res.exit_codes}: "
                f"{tail}")
            arms[n] = {"exit_codes": res.exit_codes}
            continue
        c = res.chief_result
        arms[n] = {
            "num_processes": c["num_processes"],
            "plan_bus": c.get("plan_bus"),
            "tp_degree": c["tp_degree"],
            "tokens": c["tokens"],
            "wall_s": c["wall_s"],
            "tokens_per_s": c["tokens_per_s"],
            "decode_programs": c["decode_programs"],
            "prefill_programs": c["prefill_programs"],
            "spec_mean_accepted": c["spec_mean_accepted"],
            "launches": c.get("launches"),
            "errors": c["errors"],
            "exit_codes": res.exit_codes,
            "gang_duration_s": round(res.duration_s, 1),
            "results": c["results"],
        }
        worker_audits[n] = workers
        if c["errors"]:
            failures.append(f"{n}-process arm request errors: "
                            f"{c['errors'][:3]}")

    result: dict = {
        "metric": "serve_mp_tokens_per_s",
        "value": arms.get(processes, {}).get("tokens_per_s"),
        "unit": "tok/s",
        "device": device,
        "processes": processes,
        "requests": requests,
        "max_new": max_new,
        "slots": slots,
        "threads": threads,
        "model": {"hidden": hidden, "layers": layers, "heads": 8},
        "efficiency_floor": efficiency_floor,
        "single_host": {k: v for k, v in arms.get(1, {}).items()
                        if k != "results"},
        "mesh": {k: v for k, v in arms.get(processes, {}).items()
                 if k != "results"},
        "worker_audits": worker_audits.get(processes, []),
    }

    one, many = arms.get(1), arms.get(processes)
    if one and many and "results" in one and "results" in many:
        # -- token identity: the correctness bar ------------------------
        identical = one["results"] == many["results"]
        result["token_identity_ok"] = identical
        if not identical:
            diffs = [i for i, (a, b) in enumerate(
                zip(one["results"], many["results"])) if a != b]
            failures.append(
                f"{processes}-process mesh diverged from 1-process on "
                f"requests {diffs[:8]}: tensor-parallel decode is not "
                "output-invariant")
        # -- mesh overhead floor ---------------------------------------
        eff = many["tokens_per_s"] / max(one["tokens_per_s"], 1e-9)
        result["mp_efficiency"] = round(eff, 3)
        if eff < efficiency_floor:
            failures.append(
                f"{processes}-process mesh at {many['tokens_per_s']} "
                f"tok/s is {round(eff, 3)}x single-host "
                f"{one['tokens_per_s']} tok/s (< {efficiency_floor} "
                "floor): the plan/collective machinery is eating the "
                "mesh (serialized steps? pool re-gather?)")
        # -- plan pipelining: the chief's broadcast must be an enqueue,
        # not a socket wait (enqueue-wait seconds a small fraction of
        # the sender thread's send seconds)
        bus = many.get("plan_bus") or {}
        result["plan_bus"] = bus
        if not bus.get("pipelined"):
            failures.append(
                "plan bus is not pipelined: chunked-prefill broadcasts "
                "serialize behind socket I/O again")
        elif bus.get("send_error"):
            failures.append(
                f"plan bus sender died mid-run: {bus['send_error']}")
        elif bus.get("broadcasts", 0) > 0:
            enq = bus.get("enqueue_wait_s", 0.0)
            snd = bus.get("send_s", 0.0)
            result["plan_overlap_ratio"] = round(
                enq / snd, 4) if snd else None
            if enq > max(0.5 * snd, 0.005 * bus["broadcasts"]):
                failures.append(
                    f"plan enqueue wait {enq}s is not small vs send "
                    f"{snd}s over {bus['broadcasts']} broadcasts: the "
                    "pipeline is not overlapping (queue backpressure or "
                    "a lock on the enqueue path)")
        # -- memory sharding: 1/N pool and params per process, measured
        # from each worker's local tensors, the spec-derived numbers
        # beside them as the expectation
        expect = _shard_fractions(processes, hidden, layers)
        result["shard_fractions_expected"] = expect
        measured = [(w.get("process_id"), w.get("pool_local_fraction"),
                     w.get("params_local_fraction"))
                    for w in worker_audits.get(processes, [])]
        result["shard_fractions_measured"] = [
            {"process_id": p, "pool": pf, "params": prf}
            for p, pf, prf in measured]
        for pid, pool_frac, param_frac in measured:
            if pool_frac is None or \
                    abs(pool_frac - 1.0 / processes) > 0.02:
                failures.append(
                    f"worker {pid} holds {pool_frac} of the KV pool, "
                    f"expected ~1/{processes}: the pool is not "
                    "head-sharded (a replicated pool forfeits the "
                    "memory win multi-host serving exists for)")
            if param_frac is None or \
                    param_frac > expect["params"] + 0.05:
                failures.append(
                    f"worker {pid} holds {param_frac} of the params, "
                    f"expected ~{expect['params']}: tensor sharding is "
                    "not splitting the transformer weights")

    # the arms dropped the results lists from the copies above; keep a
    # compact identity digest instead
    if one and "results" in one:
        result["results_digest"] = _digest(one["results"])

    if failures:
        result["failures"] = failures
        err = RuntimeError("serve-mp bench assertions failed:\n  "
                           + "\n  ".join(failures))
        err.result = result
        raise err
    return result


def _digest(results: list) -> str:
    return hashlib.sha1(
        json.dumps(results, sort_keys=True).encode()).hexdigest()[:16]


def _shard_fractions(tp: int, hidden: int, layers: int) -> dict:
    """Each process's share of the params and of the KV pool under the
    serving tp specs, computed from the sharding rules themselves
    (``serve_tp_param_specs`` over the gang's model, ``serve_pool_specs``
    over a pool of its shape): a tensor whose spec names ``tp`` counts
    1/tp, a replicated one whole."""
    from k8s_tpu_torch.models.mp_serve import build_model
    from k8s_tpu_torch.models.placement import PagedCompute
    from k8s_tpu_torch.models.transformer import Transformer
    from k8s_tpu_torch.parallel.sharding import (serve_pool_specs,
                                                 serve_tp_param_specs)

    config, params = build_model(0, hidden=hidden, layers=layers, heads=8,
                                 max_seq_len=128)
    specs = serve_tp_param_specs(params)
    total = sum(t.numel() for t in params.values())
    local = sum(t.numel() / (tp if "tp" in specs[name] else 1)
                for name, t in params.items())
    pool = PagedCompute(Transformer(config, params, device="cpu")
                        ).build_pool(2, 16, "cpu")
    pool_specs = serve_pool_specs(pool)
    pool_total = sum(t.numel() for node in pool for t in node.values())
    pool_local = sum(t.numel() / (tp if "tp" in spec[key] else 1)
                     for node, spec in zip(pool, pool_specs)
                     for key, t in node.items())
    return {"params": round(local / max(total, 1), 3),
            "pool": round(pool_local / max(pool_total, 1), 3)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--processes", type=int, default=4)
    p.add_argument("--requests", type=int, default=24)
    p.add_argument("--max-new", type=int, default=24)
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--threads", type=int, default=10)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--timeout", type=float, default=420.0)
    p.add_argument("--efficiency-floor", type=float,
                   default=DEFAULT_EFFICIENCY_FLOOR)
    p.add_argument("--device", default="cuda",
                   help="cuda (default: NCCL, one card a process), or cpu "
                   "(gloo)")
    p.add_argument("--out", default=None,
                   help="also write the JSON artifact to this path")
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
        result = run_bench(
            processes=args.processes, requests=args.requests,
            max_new=args.max_new, slots=args.slots, threads=args.threads,
            hidden=args.hidden, layers=args.layers, timeout=args.timeout,
            efficiency_floor=args.efficiency_floor, device=args.device)
    except RuntimeError as e:
        partial = getattr(e, "result", None)
        if partial is not None:
            _write(partial)
        raise
    _write(result)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
