#!/usr/bin/env python3
"""Where the time goes on the port's main paths, on one card.

    python3 chip_profile.py [--path serve|train|engine|both]
                            [--prompt_len 509] [--new_tokens 32] [--seed 0]

``serve``: builds the model chip_smoke.py serves (llama_8b widths, bf16,
all 32 layers, the flash-attention and RMSNorm kernels on, random weights
from ``--seed``) and runs the generation loop the server runs
(``decode.make_generate_fn``), without HTTP:

- host clock around whole generations that end in
  ``torch.cuda.synchronize()``: prefill alone (``max_new_tokens=1``) and
  the full request, median of 3 each after a warm-up;
- ``torch.profiler`` over one prefill and one full request: device time
  by kernel, the device-busy share of the traced wall time, and kernel
  launches per decode step.

``engine``: the same model behind the continuous-batching engine with
four slots (``models/engine.py``, no HTTP); four requests of
``--prompt_len`` tokens and ``--new_tokens`` new tokens each decode
together, twice: once with an EOS condition, which pins each batched
step at one iteration, and once without, where the engine fuses four.
For each, the host clock around the engine's step body while all four
slots are active (three calls; each ends in the step's host read of its
tokens); then both again, with ``torch.profiler`` over one such call:
device time by kernel, the device-busy share of the step, and device
time and ops per iteration.

``train``: one training step of the path ``train_lm`` runs at its
default preset (gpt2-small, B8 L1024, bf16, flash kernels forward and
backward, Adam on f32 master weights), built the way ``train_lm.main``
builds it:

- host clock around steps that end in ``torch.cuda.synchronize()``,
  median of 5 after 3 warm-up steps;
- ``torch.profiler`` over one step: device time by kernel and the
  device-busy share.

Prints JSON lines; everything also goes to
``chip_reports/chip_profile.json``.
Exits non-zero without a CUDA device or when the profiler sees no device
work.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def median(xs):
    return sorted(xs)[len(xs) // 2]


def profile_device(torch, fn) -> tuple[dict, float, list]:
    """torch.profiler over ``fn()``: (device time by kernel name, traced
    host seconds, the device events)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    # device work only: record_function ranges (Optimizer.step#...) also
    # show on the device timeline and would count their kernels twice
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    by_name: dict[str, list] = {}
    for e in kernels:
        rec = by_name.setdefault(e.name[:100], [0, 0.0])
        rec[0] += 1
        rec[1] += e.time_range.elapsed_us() / 1e3
    return by_name, traced_s, kernels


def summary(phase: str, by_name: dict, traced_s: float, kernels: list,
            top_n: int = 15) -> dict:
    busy_ms = sum(ms for _, ms in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top_n]
    # the hand-written flash kernels (K2, K3, K4), by their entry names
    flash = {n: rec for n, rec in by_name.items() if "flash_" in n}
    flash_ms = sum(ms for _, ms in flash.values())
    return {"phase": phase, "traced_s": traced_s, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / 1e3 / traced_s,
            "device_ops": len(kernels),
            "flash_ms": flash_ms, "flash_share_of_busy": flash_ms / busy_ms,
            "flash": [{"name": n, "count": c, "ms": ms}
                      for n, (c, ms) in sorted(flash.items())],
            "top": [{"name": n, "count": c, "ms": ms} for n, (c, ms) in top]}


def profile_serve(torch, args, report) -> int:
    from k8s_tpu_torch.models import bridge, decode
    from k8s_tpu_torch.models import transformer as tlib

    cfg = dataclasses.replace(tlib.llama_8b(), use_flash_attention=True,
                              use_fused_norm=True, dtype=torch.bfloat16)
    model = tlib.Transformer(cfg, bridge.init_params(cfg, args.seed),
                             device="cuda")
    prompt = torch.randint(
        0, cfg.vocab_size, (1, args.prompt_len),
        generator=torch.Generator().manual_seed(args.seed + 1)).cuda()
    prefill = decode.make_generate_fn(cfg, 1)
    full = decode.make_generate_fn(cfg, args.new_tokens)

    def run(fn):
        t0 = time.perf_counter()
        fn(model, prompt)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(full)  # warm-up: kernel builds, cuBLAS handles, allocator
    wall = {"prefill_s": median([run(prefill) for _ in range(3)]),
            "request_s": median([run(full) for _ in range(3)])}
    steps = args.new_tokens - 1
    wall["decode_step_s"] = (wall["request_s"] - wall["prefill_s"]) / steps
    report["wall"] = wall
    emit({"phase": "wall", **wall})

    for name, fn in (("prefill", prefill), ("request", full)):
        by_name, traced_s, kernels = profile_device(
            torch, lambda: fn(model, prompt))
        if not kernels:
            print("FAIL: the profiler saw no device work", file=sys.stderr)
            return 1
        rec = summary(f"profile_{name}", by_name, traced_s, kernels)
        if name == "request":
            rec["device_ops_per_decode_step"] = (
                len(kernels) - report["profile_prefill"]["device_ops"]) \
                / steps
        report[f"profile_{name}"] = rec
        emit(rec)
    return 0


def profile_engine(torch, args, report) -> int:
    import threading

    from k8s_tpu_torch.models import bridge
    from k8s_tpu_torch.models import engine as engine_lib
    from k8s_tpu_torch.models import transformer as tlib

    cfg = dataclasses.replace(tlib.llama_8b(), use_flash_attention=True,
                              use_fused_norm=True, dtype=torch.bfloat16)
    eng = engine_lib.Engine(cfg, bridge.init_params(cfg, args.seed, "cuda"),
                            slots=4, device="cuda")
    gen = torch.Generator().manual_seed(args.seed + 1)
    step_fn = eng._step_fn
    rounds: dict = {}
    mode = {"profile": False}

    def watched(pool, tables, ints, gens, temps, topks, k):
        """The engine's step body: host-clocked for three calls with all
        four rows active; in a profiling round, the next such call runs
        under the profiler instead."""
        def call():
            return step_fn(pool, tables, ints, gens, temps, topks, k)
        rnd = rounds.setdefault(k, {"walls": []})
        full = int((ints[1] >= 0).sum()) == 4
        if full and mode["profile"] and "profile" not in rnd:
            out = {}
            rnd["profile"] = profile_device(
                torch, lambda: out.setdefault("toks", call()))
            return out["toks"]
        if not full or mode["profile"] or len(rnd["walls"]) == 3:
            return call()
        t0 = time.perf_counter()
        toks = call()
        rnd["walls"].append(time.perf_counter() - t0)
        return toks

    eng._step_fn = watched
    try:
        # an EOS condition on every row pins the step at one iteration
        # (k = 1); without one the engine fuses MAX_STEP_TOKENS (k = 4).
        # The EOS id is the last vocabulary entry, which random weights
        # emit with probability ~1/vocab a token.  Both host clocks come
        # before the first profiler session, after which the launch path
        # has been seen to run slower for the rest of the process.
        for profiling, eos in ((False, cfg.vocab_size - 1), (False, None),
                               (True, cfg.vocab_size - 1), (True, None)):
            mode["profile"] = profiling
            prompts = [torch.randint(0, cfg.vocab_size, (args.prompt_len,),
                                     generator=gen).tolist()
                       for _ in range(4)]
            threads = [threading.Thread(target=eng.submit, args=(
                p, args.new_tokens), kwargs={"eos_id": eos, "timeout": 600})
                for p in prompts]
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
    finally:
        eng.shutdown()
    for k, rnd in sorted(rounds.items()):
        if "profile" not in rnd:
            continue
        by_name, traced_s, kernels = rnd["profile"]
        if not kernels:
            print("FAIL: the profiler saw no device work", file=sys.stderr)
            return 1
        rec = summary(f"profile_engine_step_k{k}", by_name, traced_s,
                      kernels)
        rec.update({"fused_iterations": k, "active_slots": 4,
                    "step_wall_s": rnd["walls"],
                    "step_wall_s_median": median(rnd["walls"]),
                    "wall_s_per_iteration": median(rnd["walls"]) / k,
                    "device_ms_per_iteration": rec["device_busy_ms"] / k,
                    "device_ops_per_iteration": rec["device_ops"] / k,
                    "rms_norm_launches": sum(
                        c for n, (c, _) in by_name.items() if "rms" in n)})
        report[rec["phase"]] = rec
        emit(rec)
    if not any("profile" in r for r in rounds.values()):
        print("FAIL: no step ran with four active slots", file=sys.stderr)
        return 1
    return 0


def profile_train(torch, args, report) -> int:
    from k8s_tpu_torch import train_lm
    from k8s_tpu_torch.models import bridge
    from k8s_tpu_torch.models import train as train_lib
    from k8s_tpu_torch.models.transformer import Transformer

    torch.cuda.reset_peak_memory_stats()
    targs = train_lm.parse_args(["--device", "cuda"])
    cfg = train_lm.build_config(targs, True)
    model = Transformer(cfg, bridge.init_params(cfg, args.seed, "cuda",
                                                dtype=torch.float32),
                        device="cuda", trainable=True)
    opt = train_lib.default_optimizer(targs.learning_rate)
    state = train_lib.init_state(model, opt)
    step = train_lib.make_train_step(lambda m, x: m(x), train_lib.lm_loss,
                                     opt)
    tokens = torch.randint(
        0, cfg.vocab_size, (targs.batch_size, targs.seq_len),
        generator=torch.Generator().manual_seed(args.seed + 2)).cuda()

    def run():
        t0 = time.perf_counter()
        step(state, (tokens, tokens))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for _ in range(3):  # warm-up: kernel builds, cuBLAS, allocator
        run()
    step_s = median([run() for _ in range(5)])
    wall = {"step_s": step_s,
            "tokens_per_s": targs.batch_size * targs.seq_len / step_s,
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2 ** 30}
    report["train_wall"] = wall
    emit({"phase": "train_wall", "preset": targs.preset,
          "batch": [targs.batch_size, targs.seq_len], **wall})
    by_name, traced_s, kernels = profile_device(torch, run)
    if not kernels:
        print("FAIL: the profiler saw no device work", file=sys.stderr)
        return 1
    rec = summary("profile_train_step", by_name, traced_s, kernels, 25)
    report["profile_train_step"] = rec
    emit(rec)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--path", choices=["serve", "train", "engine", "both"],
                   default="both")
    p.add_argument("--prompt_len", type=int, default=509)
    p.add_argument("--new_tokens", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from k8s_tpu_torch.ops import _build

    os.environ.setdefault(
        "TRITON_CACHE_DIR", os.path.join(_build.BUILD_DIR, "triton"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"card": torch.cuda.get_device_name(0), "args": vars(args)}
    rc = 0
    if args.path in ("serve", "both"):
        rc = rc or profile_serve(torch, args, report)
        torch.cuda.empty_cache()
    if args.path in ("train", "both"):
        rc = rc or profile_train(torch, args, report)
    if args.path == "engine":
        rc = rc or profile_engine(torch, args, report)

    os.makedirs(os.path.join(REPO, "chip_reports"), exist_ok=True)
    with open(os.path.join(REPO, "chip_reports", "chip_profile.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
