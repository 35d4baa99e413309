"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's workload file names its configuration and its kind (a
module of ``drivers/``), which builds the system, warms up, measures for
``--seconds`` and checks what the timed path produced against the
reference.  With ``--trace 0`` the line carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, each from its reader
in ``metrics/``; both carry the numbers compared, each beside its limit,
under ``checks``, which also end standard error.  Exit codes: 0 a result was printed, 2 no card or
too few, 3 a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

from portbench import common  # noqa: E402

TRACE_SLICE_S = 3.0


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def reader(metric: str):
    """The per-layer metric's reader, ``metrics/<metric>.py``."""
    path = os.path.join(common.PKG, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The metrics of ``BENCHMARK.json``'s ``kind`` list that this cell
    reports: those that list it, and those that list no cells."""
    return [m for m in bench[kind]
            if cell in m.get("workloads", [cell])]


def _finite(v):
    """A number for a JSON line: None where it is not finite."""
    return v if v is None or math.isfinite(v) else None


def run(args, device=None) -> tuple[int, dict]:
    """One run: ``(exit code, result line)``.  ``device`` set (a test's
    CPU) skips the look for a card.  The port builds its kernels into
    its own fixed cache inside the checkout, ``k8s_tpu_torch/_build``."""
    import torch

    wl = common.load_json("workloads", args.workload)
    config = common.load_json("configs", wl["config"])
    if device is None:
        need = wl.get("chips", 1)
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            print(f"portbench: the cell needs {need} CUDA card(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2, {}
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    bench = common.benchmark()
    ctx = types.SimpleNamespace(
        cell=args.workload, workload=wl, config=config,
        spec=common.ModelSpec.from_config(config), seed=args.seed,
        seconds=args.seconds, trace=bool(args.trace), device=device,
        t_start=T_START, trace_slice_s=wl.get("trace_slice_s", TRACE_SLICE_S))
    driver = importlib.import_module("portbench.drivers." + wl["driver"])
    record = driver.run(ctx)

    kind = "per_layer" if args.trace else "end_to_end"
    values = dict(record["e2e"], setup_s=record["setup_s"])
    record["spec"] = ctx.spec
    record["device_name"] = torch.cuda.get_device_name(device) \
        if device.type == "cuda" else "cpu"
    if args.trace and "profile" in record:
        prof, host_s = record.pop("profile")
        record["trace"] = common.profile_summary(prof, host_s)
    metrics = {}
    for m in cell_metrics(bench, args.workload, kind):
        v = values.get(m["name"]) if kind == "end_to_end" \
            else reader(m["name"])(record)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": record["device_name"], "count": 1,
           "memory_peak_bytes": record["memory_peak_bytes"]}
    line = {"correct": all(c["ok"] for c in record["checks"]),
            "attempted": record["attempted"], "failed": record["failed"],
            "metrics": metrics, "device": dev}
    if args.trace and record.get("trace"):
        tr = record["trace"]
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checks"] = {c["name"]: {"value": _finite(c["value"]),
                                  "limit": c["limit"]}
                      for c in record["checks"]}
    loaded = common.forbidden_loaded()
    if loaded:
        print(f"portbench: forbidden modules loaded: {loaded}",
              file=sys.stderr)
        return 3, {}
    line["_record"] = record
    return 0, line


def main(argv=None) -> int:
    args = parse_args(argv)
    code, line = run(args)
    if code:
        return code
    record = line.pop("_record")
    print(json.dumps({k: v for k, v in record.get("numbers", {}).items()}),
          file=sys.stderr)
    for c in record["checks"]:
        print(f"check {c['name']}: {c['value']!r} against limit "
              f"{c['limit']!r}: {'ok' if c['ok'] else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
