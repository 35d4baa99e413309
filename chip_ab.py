#!/usr/bin/env python3
"""Compare two checkouts of the port on one card, in turns.

    python3 chip_ab.py --base DIR [--paths serve,engine] [--kernels k1,flash]

``DIR`` is another checkout of the repository, for example the parent
commit unpacked with ``git archive`` into a git-ignored directory.  In the
order base, this checkout, this checkout, base, each in a fresh process:

- the RMSNorm (K1) cases of this checkout's ``chip_smoke.rms_cases`` run
  on each checkout's ``fused_norm``: device ``ms`` a call, host
  ``wall_ms`` a call beside ``F.rms_norm``'s ``library_wall_ms``, and the
  bound (``--kernels k1``, the default);
- the flash kernels K2, K3 and K4 of each checkout (``--kernels flash``)
  at the main path's attention shapes (``FLASH_SHAPES``; a shape the
  checkout refuses is recorded as null), each kernel's device ``ms`` a
  call by this checkout's ``chip_smoke.time_ms``, beside SDPA's forward
  on the same inputs (``sdpa_ms``, the library yardstick of K2, timed in
  every turn), and the count of ptxas's C7515 warnings (wgmma
  serialised) in the checkout's build log;
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


# (name, B, H, Hkv, L, D): the main path's causal attention shapes
# (gpt2-small training, the Llama-3-8B-width prefill and training cuts),
# then Phi-3-mini's and Gemma-7B's head_dims at L 2048.
FLASH_SHAPES = (("gpt2_train", 8, 12, 12, 1024, 64),
                ("llama_509", 1, 32, 8, 509, 128),
                ("llama_2048", 1, 32, 8, 2048, 128),
                ("phi3_2048", 1, 32, 32, 2048, 96),
                ("gemma_2048", 1, 16, 16, 2048, 256))


def flash_worker(root: str) -> int:
    """K2-K4 of ``root``'s flash module at ``FLASH_SHAPES``, one JSON line
    a shape, then one line with the build's C7515 count a source."""
    import inspect

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from k8s_tpu_torch.ops import _build
    from k8s_tpu_torch.ops import flash_attention as flash

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_harness", os.path.join(REPO, "chip_smoke.py"))
    harness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(harness)
    _build.build_all()
    # the dq launch takes its plan first where the checkout has one
    planned = "plan" in list(inspect.signature(flash._launch_bwd).parameters)[:2]
    g = torch.Generator(device="cuda").manual_seed(5)
    for name, B, H, Hkv, L, D in FLASH_SHAPES:
        def rand(*shape):
            return torch.randn(*shape, generator=g, device="cuda").to(
                torch.bfloat16)
        q, k, v, do = (rand(B, h, L, D) for h in (H, Hkv, Hkv, H))
        args = (D ** -0.5, True, None)
        rec = {"kernel": "flash", "case": name, "shape": [B, H, Hkv, L, D]}
        try:
            o, lse = flash.flash_fwd(q, k, v, *args)
        except ValueError as e:
            emit({**rec, "refused": str(e)})
            continue
        do_k, o_k, lse_k, delta = flash._bwd_operands(q, o, lse, do)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        lead = ("bwd_dq", flash._dq_plan(B, H, L, D, q.dtype)) if planned \
            else ("bwd_dq",)
        for kname, fn in (
                ("flash_fwd", lambda: flash.flash_fwd(q, k, v, *args)),
                ("flash_bwd_dq", lambda: flash._launch_bwd(
                    *lead, q, k, v, do_k, lse_k, delta, (dq,), *args,
                    o=o_k)),
                ("flash_bwd_dkv", lambda: flash._launch_dkv(
                    q, k, v, do_k, lse_k, delta, dk, dv, *args))):
            rec[kname + "_ms"] = harness.time_ms(torch, fn)["ms"]
        rec["sdpa_ms"] = harness.time_ms(
            torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=Hkv != H))["ms"]
        emit(rec)
    emit({"kernel": "build", "c7515": {
        src: log.count("C7515") for src, log in _build.BUILD_LOGS.items()}})
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
    flash: dict = {}
    for r in runs:
        for rec in r.get("k1", []):
            k1.setdefault(rec["case"], []).append(rec)
        for rec in r.get("flash", []):
            flash.setdefault(rec["case"], []).append(rec)
    out = {"k1": {case: {key: mean([rec.get(key) for rec in recs])
                         for key in ("ms", "wall_ms", "library_ms",
                                     "library_wall_ms", "single_wall_ms",
                                     "library_single_wall_ms", "copy_ms",
                                     "bound_ms")}
                  | {"body": recs[0].get("body")}
                  for case, recs in k1.items()},
           "flash": {case: {key: mean([rec.get(key) for rec in recs])
                            for key in ("flash_fwd_ms", "flash_bwd_dq_ms",
                                        "flash_bwd_dkv_ms", "sdpa_ms")}
                     for case, recs in flash.items()}}
    for key in ("decode_step_s", "prefill_s", "engine_k1_s_per_iteration",
                "engine_k4_s_per_iteration"):
        out[key] = mean([r.get(key) for r in runs])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--base", help="the other checkout")
    p.add_argument("--paths", default="serve,engine",
                   help="chip_profile.py paths to clock ('' for none)")
    p.add_argument("--kernels", default="k1",
                   help="kernel sets to time: k1, flash ('' for none)")
    p.add_argument("--k1_worker", metavar="ROOT", help=argparse.SUPPRESS)
    p.add_argument("--flash_worker", metavar="ROOT", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.k1_worker:
        return k1_worker(os.path.abspath(args.k1_worker))
    if args.flash_worker:
        return flash_worker(os.path.abspath(args.flash_worker))

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
    kernels = [q for q in args.kernels.split(",") if q]
    for turn, (label, root) in enumerate((("base", base), ("change", REPO),
                                          ("change", REPO), ("base", base))):
        rec = {"turn": turn, "checkout": label}
        if "k1" in kernels:
            rec["k1"] = [r for r in run([sys.executable,
                                         os.path.abspath(__file__),
                                         "--k1_worker", root], 900)
                         if r.get("kernel") == "rms_norm"]
        if "flash" in kernels:
            lines = run([sys.executable, os.path.abspath(__file__),
                         "--flash_worker", root], 900)
            rec["flash"] = [r for r in lines if r.get("kernel") == "flash"]
            rec["c7515"] = [r["c7515"] for r in lines
                            if r.get("kernel") == "build"][0]
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
        emit({"phase": "run",
              **{k: v for k, v in rec.items() if k not in ("k1", "flash")},
              "k1": {r["case"]: {key: r.get(key) for key in (
                  "ms", "wall_ms", "library_wall_ms", "bound_ms", "body")}
                  for r in rec.get("k1", [])},
              "flash": {r["case"]: {key: val for key, val in r.items()
                                    if key.endswith("_ms") or key == "refused"}
                        for r in rec.get("flash", [])}})
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
