#!/usr/bin/env python3
"""Compare two checkouts of the port on one card, in turns.

    python3 chip_ab.py --base DIR [--paths serve,engine]

``DIR`` is another checkout of the repository, for example the parent
commit unpacked with ``git archive`` into a git-ignored directory.  In the
order base, this checkout, this checkout, base, each in a fresh process:

- the RMSNorm (K1) cases of this checkout's ``chip_smoke.rms_cases`` run
  on each checkout's ``fused_norm``: device ``ms`` a call, host
  ``wall_ms`` a call beside ``F.rms_norm``'s ``library_wall_ms``, and the
  bound;
- ``chip_profile.py --path P`` of each checkout, for each path in
  ``--paths``: the single-flight decode step's host wall (``serve``) and
  the engine's host wall an iteration at k = 1 and k = 4 (``engine``).

Prints the card line, one JSON line a run, then one summary line a
checkout with the mean over its two turns; everything also goes to
``chip_reports/chip_ab.json``.  Hosts differ between calls, so compare
only the numbers of one call.  Exits non-zero without a CUDA device or
when any run fails.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def k1_worker(root: str) -> int:
    """The K1 cases on ``root``'s kernel, one JSON line a case."""
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    # a checkout whose K1 is still Triton caches its compile beside it
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(
        root, "k8s_tpu_torch", "_build", "triton"))
    sys.path.insert(0, root)
    from k8s_tpu_torch.ops import _build, fused_norm

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_harness", os.path.join(REPO, "chip_smoke.py"))
    harness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(harness)
    planned = hasattr(fused_norm, "_rms_plan")
    harness.rms_cases(torch, F, fused_norm, _build if planned else None)
    return 0


def run(cmd: list[str], timeout: float) -> list[dict]:
    """JSON lines a subprocess printed; raises when it fails."""
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    if r.returncode != 0:
        raise RuntimeError(f"{cmd} exited {r.returncode}:\n"
                           f"{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
    return [json.loads(line) for line in r.stdout.splitlines()
            if line.startswith("{")]


def summarize(runs: list[dict]) -> dict:
    """The mean of each reading over a checkout's turns."""
    def mean(xs):
        xs = [x for x in xs if x is not None]
        return sum(xs) / len(xs) if xs else None

    k1: dict = {}
    for r in runs:
        for rec in r.get("k1", []):
            k1.setdefault(rec["case"], []).append(rec)
    out = {"k1": {case: {key: mean([rec.get(key) for rec in recs])
                         for key in ("ms", "wall_ms", "library_ms",
                                     "library_wall_ms", "single_wall_ms",
                                     "library_single_wall_ms", "copy_ms",
                                     "bound_ms")}
                  | {"body": recs[0].get("body")}
                  for case, recs in k1.items()}}
    for key in ("decode_step_s", "prefill_s", "engine_k1_s_per_iteration",
                "engine_k4_s_per_iteration"):
        out[key] = mean([r.get(key) for r in runs])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--base", help="the other checkout")
    p.add_argument("--paths", default="serve,engine",
                   help="chip_profile.py paths to clock ('' for none)")
    p.add_argument("--k1_worker", metavar="ROOT", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.k1_worker:
        return k1_worker(os.path.abspath(args.k1_worker))

    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    if not args.base:
        p.error("--base is required")
    base = os.path.abspath(args.base)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    report = {"card": card, "base": base, "runs": []}
    paths = [q for q in args.paths.split(",") if q]
    for turn, (label, root) in enumerate((("base", base), ("change", REPO),
                                          ("change", REPO), ("base", base))):
        rec = {"turn": turn, "checkout": label}
        rec["k1"] = [r for r in run([sys.executable, os.path.abspath(__file__),
                                     "--k1_worker", root], 900)
                     if r.get("kernel") == "rms_norm"]
        for path in paths:
            lines = run([sys.executable, os.path.join(root, "chip_profile.py"),
                         "--path", path], 1200)
            for line in lines:
                if line.get("phase") == "wall":
                    rec["decode_step_s"] = line["decode_step_s"]
                    rec["prefill_s"] = line["prefill_s"]
                if line.get("phase", "").startswith("profile_engine_step_k"):
                    k = line["fused_iterations"]
                    rec[f"engine_k{k}_s_per_iteration"] = \
                        line["wall_s_per_iteration"]
                    rec[f"engine_k{k}_device_ms_per_iteration"] = \
                        line["device_ms_per_iteration"]
                    rec[f"engine_k{k}_rms_norm_launches"] = \
                        line["rms_norm_launches"]
        emit({"phase": "run", **{k: v for k, v in rec.items() if k != "k1"},
              "k1": {r["case"]: {key: r.get(key) for key in (
                  "ms", "wall_ms", "library_wall_ms", "bound_ms", "body")}
                  for r in rec["k1"]}})
        report["runs"].append(rec)
    for label in ("base", "change"):
        summary = summarize([r for r in report["runs"]
                             if r["checkout"] == label])
        report[label] = summary
        emit({"phase": "summary", "checkout": label, **summary})
    os.makedirs(os.path.join(REPO, "chip_reports"), exist_ok=True)
    with open(os.path.join(REPO, "chip_reports", "chip_ab.json"), "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
