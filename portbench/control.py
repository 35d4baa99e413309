"""The readings a cell's limits are set from, on the card at the cell's
own size; the benchmark's runs do not run this.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--seconds 20]

For each seed of both lists it makes a run of the cell (a short window)
and prints the numbers the check compares: the lower readings come from
these.  For each of ``--control-seeds`` it also reads the control, the
reference computed in fp8 in the program's place, and the planted
faults that the cell can have, each against the float32 reference: the
upper readings come from these.  One JSON line a seed, then a summary
line with the largest program reading and the smallest control and
fault readings of each number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import types

import numpy as np
import torch

from portbench import check, common, traffic
from portbench.reference import serve as ref_serve
from portbench.reference import train as ref_train


def _ctx(cell: str, seed: int, seconds: float):
    wl = common.load_json("workloads", cell)
    config = common.load_json("configs", wl["config"])
    return types.SimpleNamespace(
        cell=cell, workload=wl, config=config,
        spec=common.ModelSpec.from_config(config), seed=seed,
        seconds=seconds, trace=False, device=torch.device("cuda", 0),
        t_start=time.perf_counter(), trace_slice_s=0.0)


def train_control(ctx) -> dict:
    """The fp8 control and the half-batch fault against the f32
    reference, on the first rows of the seed's corpus (a frozen state
    reads 1 on ``change_gap`` by the measure's definition)."""
    wl, spec = ctx.workload, ctx.spec
    B, L = wl["batch"], wl["seq_len"]
    rows = traffic.token_corpus(ctx.seed, 3 * B * L, spec.vocab) \
        .astype(np.int64).reshape(3, B, L)
    lr = wl["optimizer"]["lr"]
    ref = ref_train.run_steps(spec, ctx.seed, list(rows), lr, ctx.device)
    out = {}
    for name, kw in (("control_fp8", {"precision": "fp8"}),
                     ("fault_half_batch", {"fault": "half_batch"})):
        got = ref_train.run_steps(spec, ctx.seed, list(rows), lr, ctx.device,
                                  **kw)
        out[name] = check.train_numbers(got, ref)
    return out


def serve_control(ctx, record: dict) -> dict:
    """Over the run's own sample: the fp8 control's gap (the gap of the
    token the lower precision ranks first, at each position), and the gap
    if each sampled request's first served token were altered to the next
    id where it is produced."""
    spec, seqs = ctx.spec, record["seqs"]
    f32 = ref_serve.logits_at_served(spec, ctx.seed, seqs, ctx.device,
                                     spec.torch_dtype)
    low = ref_serve.logits_at_served(spec, ctx.seed, seqs, ctx.device,
                                     spec.torch_dtype, precision="fp8")
    ctrl = ref_serve.control_gaps(f32, low)
    altered = [(p, [(s[0] + 1) % spec.vocab] + list(s[1:])) for p, s in seqs]
    fault = ref_serve.served_gaps(f32, altered)
    flat = [x for g in ctrl for x in g]
    return {"control_fp8": {"served_gap": max(flat),
                            "served_gap_mean": sum(flat) / len(flat)},
            "fault_token_altered": {"served_gap": max(g[0] for g in fault)}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    torch.cuda.set_device(0)
    lows: dict = {}
    highs: dict = {}
    for seed in seeds + [s for s in controls if s not in seeds]:
        ctx = _ctx(args.workload, seed, args.seconds)
        driver = __import__("portbench.drivers." + ctx.workload["driver"],
                            fromlist=["run"])
        torch.cuda.reset_peak_memory_stats()
        record = driver.run(ctx)
        line = {"seed": seed, "numbers": record["numbers"],
                "memory_peak_bytes": record["memory_peak_bytes"],
                "e2e": record["e2e"], "setup_s": record["setup_s"]}
        for k, v in record["numbers"].items():
            if isinstance(v, (int, float)):
                lows[k] = max(lows.get(k, v), v)
        if seed in controls:
            torch.cuda.empty_cache()
            readings = train_control(ctx) if ctx.workload["driver"] == \
                "train" else serve_control(ctx, record)
            line["upper"] = readings
            for what, nums in readings.items():
                for k, v in nums.items():
                    if isinstance(v, (int, float)):
                        key = f"{what}.{k}"
                        highs[key] = min(highs.get(key, v), v)
        print(json.dumps(line), flush=True)
        del record
        torch.cuda.empty_cache()
    print(json.dumps({"summary": args.workload, "lower": lows,
                      "upper": highs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
