#!/usr/bin/env python3
"""Where the time goes on the port's main paths, on one card.

    python3 chip_profile.py [--path PATH] [--prompt_len 509]
                            [--new_tokens 32] [--seed 0]

PATH is serve, train, engine, spec, resnet, vit, fsdp, pp, mesh or both
(the default: serve and train).

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

``spec``: the same model, single-flight, after a ``--prompt_len``
prefill: one W = 4 verify call of the speculative loop
(``decode.make_speculative_generate_fn``'s body: host drafting with
``lookup_draft_host``, one 4-token decode-mode call, greedy acceptance,
the host read of its result) against one 1-token decode step of the
vanilla loop (one decode call and its argmax), each ending in a host
sync, median of 5 of each in turns; then the same inside whole
``--new_tokens`` generations (median of 3 in turns: per decode call,
the generation's time less a prefill's).  All host clocks come before
any profiler session; then ``torch.profiler`` over one call of each:
device time, device ops and RMSNorm launches.

``train``: one training step of the path ``train_lm`` runs at its
default preset (gpt2-small, B8 L1024, bf16, flash kernels forward and
backward, Adam on f32 master weights), built the way ``train_lm.main``
builds it:

- host clock around steps that end in ``torch.cuda.synchronize()``,
  median of 5 after 3 warm-up steps;
- ``torch.profiler`` over one step: device time by kernel and the
  device-busy share.

``resnet``, ``vit``: one training step of chip_smoke.py's ``resnet``
phase (ResNet-50, bf16, 7x7 stem, SGD momentum) or ``vit`` phase
(ViT-B/16, bf16, fused norm on, AdamW), B128 at 224x224, built by
the bench cells' ``resnet_trainer`` / ``vit_trainer``
(``k8s_tpu_torch/bench.py``), which the smoke's phases use too:

- host clock around steps that end in ``torch.cuda.synchronize()``,
  median of 5 after 3 warm-up steps (``cudnn.benchmark`` on);
- ``torch.profiler`` over one step: device time by kernel and by class
  (convolution, matmul, norm, softmax, pool, elementwise and reductions,
  optimizer) and the device-busy share; ``vit`` also times one layer's
  plain attention, forward and backward, with CUDA events.

``fsdp``: the ``train`` step (Adam 1e-4, clip 1.0) unsharded and
FSDP2-sharded over the one-rank NCCL mesh
(``launcher.bootstrap.make_training_mesh``), as chip_smoke.py's
``fsdp_train`` builds them from the same weights:

- host clock around steps that end in ``torch.cuda.synchronize()``,
  median of 5 after 3 warm-up steps, in turns sharded / plain / plain /
  sharded;
- ``torch.profiler`` over one step of each: device time by kernel and by
  class (``collective`` for NCCL's kernels), the device-busy share, and
  the host time inside the profiler's ranges (FSDP2's ``FSDP::`` hooks,
  ``Optimizer.step``).

``pp``: chip_smoke.py's ``pp_train`` 1F1B step (gpt2-small, four pp
``ThreadRing`` ranks, M 8, AdamW clip 0.1, built by its own
``_stage_states`` / ``_pp_step``) and the unpipelined step from the same
weights:

- host clock around steps that end in ``torch.cuda.synchronize()``,
  median of 3 after a warm-up, in turns plain / pp / pp / plain;
- ``torch.profiler`` over one step of each: device time by kernel and by
  class, device ops, and the device-busy share of the step's wall.

``mesh``: chip_smoke.py's ``mesh_serve`` mesh (the ``engine`` model at
tp 4 over ``ThreadRing`` ranks, plan bus on loopback) against the local
engine on the same weights, four ``--prompt_len`` requests of 8 new
tokens decoding together: seconds a model call for each; for the mesh,
each rank's host seconds inside its ring collectives and plan receives,
a 2 ms stack sample of the rank and engine threads, and the batch again
at a 0.5 ms interpreter switch interval.

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
import subprocess
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


def profile_spec(torch, args, report) -> int:
    from k8s_tpu_torch.models import bridge, decode
    from k8s_tpu_torch.models import transformer as tlib

    cfg = dataclasses.replace(tlib.llama_8b(), use_flash_attention=True,
                              use_fused_norm=True, dtype=torch.bfloat16)
    model = tlib.Transformer(cfg, bridge.init_params(cfg, args.seed),
                             device="cuda")
    Lp, K = args.prompt_len, 4
    prompt = torch.randint(
        0, cfg.vocab_size, (1, Lp),
        generator=torch.Generator().manual_seed(args.seed + 1)).cuda()
    cache = model.new_cache()
    with torch.inference_mode():
        tok = model(prompt, mode="prefill", cache=cache)[:, -1].argmax(-1)
    ctx = prompt[0].tolist() + [int(tok)]
    pos1 = torch.full((1, 1), Lp, device="cuda")
    posk = (Lp + torch.arange(K, device="cuda"))[None]

    # both rewrite the K/V of position Lp (and the verify Lp+1..Lp+3)
    # with the same values each call, so repeated calls see one cache
    def step():
        with torch.inference_mode():
            logits = model(tok[:, None], positions=pos1, mode="decode",
                           cache=cache)
            decode.sample_logits(logits[:, -1])
        torch.cuda.synchronize()

    def verify():
        with torch.inference_mode():
            chunk = torch.tensor([[ctx[-1]] + decode.lookup_draft_host(
                ctx, K)], device="cuda")
            logits = model(chunk, positions=posk, mode="decode",
                           cache=cache)
            acc, bonus = decode.spec_accept_greedy(logits, chunk[:, 1:])
            torch.stack([acc, bonus]).tolist()
        torch.cuda.synchronize()

    def clock(fn):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for _ in range(2):  # warm-up
        step()
        verify()
    walls = {"step": [], "verify": []}
    for _ in range(5):
        walls["step"].append(clock(step))
        walls["verify"].append(clock(verify))
    # the same inside whole generations (--new_tokens), where the
    # vanilla loop never waits for the device and the speculative loop
    # reads every verify back: (generation - prefill) per decode call
    gens = {"prefill": decode.make_generate_fn(cfg, 1),
            "vanilla": decode.make_generate_fn(cfg, args.new_tokens),
            "spec": decode.make_speculative_generate_fn(
                cfg, args.new_tokens, draft_k=K, return_stats=True)}
    loops = {name: [] for name in gens}
    for _ in range(3):
        for name, fn in gens.items():
            loops[name].append(clock(lambda: fn(model, prompt)))
    verify_calls = gens["spec"](model, prompt)[1]["model_calls"] - 1
    pre = median(loops["prefill"])
    rec = {"phase": "spec_verify_vs_step", "card": report["nvidia_smi"],
           "prompt_len": Lp, "draft_k": K,
           "step_wall_s": walls["step"], "verify_wall_s": walls["verify"],
           "step_wall_s_median": median(walls["step"]),
           "verify_wall_s_median": median(walls["verify"]),
           "verify_over_step_wall": median(walls["verify"])
           / median(walls["step"]),
           "generation_s": loops, "spec_verify_calls": verify_calls,
           "loop_step_s": (median(loops["vanilla"]) - pre)
           / (args.new_tokens - 1),
           "loop_verify_s": (median(loops["spec"]) - pre) / verify_calls}
    for name, fn in (("step", step), ("verify", verify)):
        by_name, traced_s, kernels = profile_device(torch, fn)
        if not kernels:
            print("FAIL: the profiler saw no device work", file=sys.stderr)
            return 1
        busy = sum(ms for _, ms in by_name.values())
        rec[f"{name}_device_ms"] = busy
        rec[f"{name}_device_ops"] = len(kernels)
        rec[f"{name}_rms_norm_launches"] = sum(
            c for n, (c, _) in by_name.items() if "rms" in n)
        rec[f"{name}_top"] = [
            {"name": n, "count": c, "ms": ms} for n, (c, ms) in sorted(
                by_name.items(), key=lambda kv: -kv[1][1])[:8]]
    rec["verify_over_step_device"] = rec["verify_device_ms"] \
        / rec["step_device_ms"]
    report["spec"] = rec
    emit(rec)
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


# Device time by class of kernel, from the kernel's name (the first class
# whose pattern the lower-cased name holds).  The plain attention's two
# products are cuBLAS batched GEMMs and count as matmul; ``--path vit``
# times the attention on its own beside the profile.
OP_CLASSES = (
    ("collective", ("nccl",)),
    ("optimizer", ("multi_tensor_apply", "adam", "sgd")),
    ("conv", ("fprop", "dgrad", "wgrad", "conv", "implicit")),
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma")),
    ("norm", ("batch_norm", "bn_", "rms_norm")),
    ("softmax", ("softmax",)),
    ("pool", ("pool",)),
    ("elementwise_reduce", ("elementwise", "reduce", "copy", "fill",
                            "cat", "index", "scatter", "gather")),
)


def op_classes(by_name: dict) -> dict:
    """{class: {"ms", "count", "share"}} over every kernel in ``by_name``
    (``other`` for a name no pattern matches)."""
    out: dict = {}
    for name, (count, ms) in by_name.items():
        low = name.lower()
        cls = next((c for c, pats in OP_CLASSES
                    if any(p in low for p in pats)), "other")
        rec = out.setdefault(cls, {"ms": 0.0, "count": 0})
        rec["ms"] += ms
        rec["count"] += count
    busy = sum(r["ms"] for r in out.values())
    for rec in out.values():
        rec["share"] = rec["ms"] / busy
    return out


def profile_vision(torch, args, report, path: str) -> int:
    """One training step of chip_smoke.py's ``resnet`` (ResNet-50, conv
    stem, SGD momentum) or ``vit`` (ViT-B/16, fused norm on, AdamW) phase
    at its batch, from its step builders: host clock of steps ending in a sync (median of 5
    after 3 warm-up steps, ``cudnn.benchmark`` on), then
    ``torch.profiler`` over one step: device time by kernel and by class
    (``OP_CLASSES``) and the device-busy share.  For ``vit`` also the
    plain attention of one layer, forward and backward, by CUDA events."""
    import chip_smoke as smoke
    from k8s_tpu_torch import bench
    from k8s_tpu_torch.models import vit

    torch.backends.cudnn.benchmark = True
    torch.cuda.reset_peak_memory_stats()
    if path == "resnet":
        B, gflop = smoke.RESNET_BATCH, smoke.RESNET_GFLOP
        x, y = smoke.vision_batch(torch, B, args.seed)
        _, step = bench.resnet_trainer(x, y, "conv", args.seed)
    else:
        B, gflop = smoke.VIT_BATCH, smoke.VIT_GFLOP
        x, y = smoke.vision_batch(torch, B, args.seed)
        cfg = vit.vit_b16(remat=False, use_fused_norm=True)
        _, step = bench.vit_trainer(cfg, x, y, seed=args.seed)

    def run():
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for _ in range(3):  # warm-up: cuDNN's algorithm search, allocator
        run()
    step_s = median([run() for _ in range(5)])
    wall = {"step_s": step_s, "images_per_s": B / step_s,
            "peak_16bit_share":
                3 * 2 * gflop * 1e9 * B / step_s / smoke.PEAK_16BIT,
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2 ** 30,
            "cudnn_benchmark": True}
    if path == "vit":
        from k8s_tpu_torch.models.transformer import _plain_attention

        q, k, v = (torch.randn(B, 197, 12, 64, device="cuda",
                               dtype=torch.bfloat16, requires_grad=True)
                   for _ in range(3))
        do = torch.randn(B, 197, 12, 64, device="cuda", dtype=torch.bfloat16)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        for _ in range(3):
            _plain_attention(q, k, v, False).backward(do)
        start.record()
        for _ in range(10):
            _plain_attention(q, k, v, False).backward(do)
        end.record()
        torch.cuda.synchronize()
        wall["attention_fwd_bwd_ms_a_layer"] = start.elapsed_time(end) / 10
    report[f"{path}_wall"] = wall
    emit({"phase": f"{path}_wall", "batch": [B, 224, 224, 3], **wall})
    by_name, traced_s, kernels = profile_device(torch, run)
    if not kernels:
        print("FAIL: the profiler saw no device work", file=sys.stderr)
        return 1
    rec = summary(f"profile_{path}_step", by_name, traced_s, kernels, 25)
    rec["by_class"] = op_classes(by_name)
    report[rec["phase"]] = rec
    emit(rec)
    return 0


def host_ranges(torch, fn, prefixes=("FSDP::", "Optimizer.")) -> dict:
    """torch.profiler over ``fn()``: host ms inside the ranges whose names
    start with ``prefixes``, by name (nested ranges count in each)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and \
                e.name.startswith(prefixes):
            rec = out.setdefault(e.name[:80], [0, 0.0])
            rec[0] += 1
            rec[1] += e.time_range.elapsed_us() / 1e3
    return {n: {"count": c, "ms": ms} for n, (c, ms) in sorted(
        out.items(), key=lambda kv: -kv[1][1])}


def profile_fsdp(torch, args, report) -> int:
    from k8s_tpu_torch import train_lm
    from k8s_tpu_torch.launcher import bootstrap
    from k8s_tpu_torch.models import bridge
    from k8s_tpu_torch.models import train as train_lib
    from k8s_tpu_torch.models.transformer import Transformer

    mesh, _ = bootstrap.make_training_mesh(config=bootstrap.LauncherConfig())
    targs = train_lm.parse_args(["--device", "cuda"])
    cfg = train_lm.build_config(targs, True)
    params = bridge.init_params(cfg, args.seed, "cuda", dtype=torch.float32)
    opt = train_lib.default_optimizer(targs.learning_rate, clip_norm=1.0)
    steps, states = {}, {}
    for name in ("sharded", "plain"):
        state = train_lib.init_state(Transformer(
            cfg, params, device="cuda", trainable=True), opt)
        if name == "sharded":
            state, sh = train_lib.shard_train_state(state, mesh)
            steps[name] = train_lib.make_sharded_train_step(
                lambda m, x: m(x), train_lib.lm_loss, opt, mesh, sh)
        else:
            steps[name] = train_lib.make_train_step(
                lambda m, x: m(x), train_lib.lm_loss, opt)
        states[name] = state
    del params
    tokens = torch.randint(
        0, cfg.vocab_size, (targs.batch_size, targs.seq_len),
        generator=torch.Generator().manual_seed(args.seed + 2)).cuda()

    def run(name):
        t0 = time.perf_counter()
        steps[name](states[name], (tokens, tokens))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for name in ("sharded", "plain"):
        for _ in range(3):  # warm-up: NCCL, FSDP2's lazy init, cuBLAS
            run(name)
    clocks: dict = {"sharded": [], "plain": []}
    for name in ("sharded", "plain", "plain", "sharded"):
        clocks[name].append(median([run(name) for _ in range(5)]))
    wall = {"turns": ["sharded", "plain", "plain", "sharded"],
            "step_s": clocks,
            "sharded_over_plain": sum(clocks["sharded"])
            / sum(clocks["plain"])}
    report["fsdp_wall"] = wall
    emit({"phase": "fsdp_wall", **wall})
    for name in ("sharded", "plain"):
        by_name, traced_s, kernels = profile_device(torch, lambda: run(name))
        if not kernels:
            print("FAIL: the profiler saw no device work", file=sys.stderr)
            return 1
        rec = summary(f"profile_fsdp_{name}", by_name, traced_s, kernels, 25)
        rec["classes"] = op_classes(by_name)
        rec["host_ranges"] = host_ranges(torch, lambda: run(name))
        report[rec["phase"]] = rec
        emit(rec)
    torch.distributed.destroy_process_group()
    return 0


def profile_pp(torch, args, report) -> int:
    import chip_smoke as smoke
    from k8s_tpu_torch import train_lm
    from k8s_tpu_torch.models import bridge, pp_lm
    from k8s_tpu_torch.models import train as train_lib
    from k8s_tpu_torch.models.transformer import Transformer
    from k8s_tpu_torch.parallel import collectives

    cfg = train_lm.build_config(train_lm.parse_args(smoke.TRAIN_ARGS), True)
    params = bridge.init_params(cfg, args.seed, "cuda", dtype=torch.float32)
    opt = train_lib.default_optimizer(1e-4, weight_decay=0.01,
                                      clip_norm=0.1)
    plain = train_lib.init_state(Transformer(cfg, params, device="cuda",
                                             trainable=True), opt)
    plain_step = train_lib.make_train_step(lambda m, x: m(x),
                                           train_lib.lm_loss, opt)
    states = smoke._stage_states(torch, pp_lm, train_lib, cfg, params, opt,
                                 1)
    stats = [{} for _ in range(smoke.PP)]
    del params
    tokens = torch.randint(
        0, cfg.vocab_size, (8, 1024),
        generator=torch.Generator().manual_seed(args.seed + 2)).cuda()
    steps = {
        "plain": lambda: plain_step(plain, (tokens, tokens)),
        "pp": lambda: smoke._pp_step(torch, pp_lm, collectives, cfg, opt,
                                     states, stats, (tokens, tokens),
                                     smoke.PP_M, 1)}

    def run(name):
        t0 = time.perf_counter()
        steps[name]()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for name in steps:
        run(name)
    clocks: dict = {"plain": [], "pp": []}
    for name in ("plain", "pp", "pp", "plain"):
        clocks[name].append(median([run(name) for _ in range(3)]))
    wall = {"turns": ["plain", "pp", "pp", "plain"], "step_s": clocks,
            "pp_over_plain": sum(clocks["pp"]) / sum(clocks["plain"])}
    report["pp_wall"] = wall
    emit({"phase": "pp_wall", **wall})
    for name in steps:
        by_name, traced_s, kernels = profile_device(torch, lambda: run(name))
        if not kernels:
            print("FAIL: the profiler saw no device work", file=sys.stderr)
            return 1
        rec = summary(f"profile_pp_{name}", by_name, traced_s, kernels, 12)
        rec["classes"] = op_classes(by_name)
        report[rec["phase"]] = rec
        emit(rec)
    return 0


class StackSampler:
    """Where a set of threads spend their host time: every ``period``
    seconds, each watched thread's innermost frame in this repo (or its
    innermost frame when none is), counted by thread and by
    ``file:function:line``."""

    def __init__(self, prefixes, period: float = 0.002):
        import threading

        self.prefixes = tuple(prefixes)
        self.period = period
        self.counts: dict = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="stack-sampler")

    def _where(self, frame) -> str:
        inner = None
        while frame is not None:
            code = frame.f_code
            name = f"{os.path.basename(code.co_filename)}:{code.co_name}:" \
                   f"{frame.f_lineno}"
            inner = inner or name
            if code.co_filename.startswith(REPO):
                return name
            frame = frame.f_back
        return inner or "?"

    def _run(self):
        import threading

        while not self._stop.wait(self.period):
            names = {t.ident: t.name for t in threading.enumerate()}
            for ident, frame in sys._current_frames().items():
                name = names.get(ident, "")
                if name.startswith(self.prefixes):
                    c = self.counts.setdefault(name, {})
                    where = self._where(frame)
                    c[where] = c.get(where, 0) + 1

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def top(self, n: int = 8) -> dict:
        out = {}
        for name, c in sorted(self.counts.items()):
            total = sum(c.values())
            out[name] = {"samples": total, "top": [
                [w, k / total] for w, k in
                sorted(c.items(), key=lambda kv: -kv[1])[:n]]}
        return out


def profile_mesh(torch, args, report) -> int:
    """chip_smoke.py's ``mesh_serve`` mesh (llama_8b, bf16, tp 4 over
    ``ThreadRing`` ranks on the one card, the plan bus on loopback, slots
    4) against the local engine on the same weights: four requests of
    ``--prompt_len`` tokens and 8 new tokens each, decoding together.
    For each, the host clock around the batch over its model calls; for
    the mesh, each rank's host time inside its ring collectives and plan
    receives, and a stack sample (every 2 ms) of the rank threads and
    the engine thread; then the mesh batch again at a 0.5 ms interpreter
    switch interval (``sys.setswitchinterval``, default 5 ms)."""
    import collections
    import threading

    from k8s_tpu_torch.models import bridge, mesh_serve, mp_plan
    from k8s_tpu_torch.models import engine as engine_lib
    from k8s_tpu_torch.models import transformer as tlib
    from k8s_tpu_torch.parallel import collectives

    cfg = dataclasses.replace(tlib.llama_8b(), use_flash_attention=True,
                              use_fused_norm=True, dtype=torch.bfloat16)
    params = bridge.init_params(cfg, args.seed, "cuda")
    gen = torch.Generator().manual_seed(args.seed + 1)
    prompts = [torch.randint(0, cfg.vocab_size, (args.prompt_len,),
                             generator=gen).tolist() for _ in range(4)]
    new = 8
    waits = collections.defaultdict(float)

    def timed(name, fn):
        def inner(self, *a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(self, *a, **kw)
            finally:
                waits[(name, threading.current_thread().name)] += \
                    time.perf_counter() - t0
        return inner

    patched = {(collectives.ThreadRing, "all_reduce"),
               (collectives.ThreadRing, "broadcast"),
               (mp_plan.PlanFollower, "recv")}
    saved = {(c, m): getattr(c, m) for c, m in patched}
    for (c, m), fn in saved.items():
        setattr(c, m, timed(f"{c.__name__}.{m}", fn))

    def batch(eng):
        eng.submit(prompts[0][:8], 1, timeout=600)  # warm-up
        calls0 = eng.stats()["model_calls"]
        threads = [threading.Thread(target=eng.submit, args=(p, new),
                                    kwargs={"timeout": 900})
                   for p in prompts]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        wall = time.perf_counter() - t0
        calls = eng.stats()["model_calls"] - calls0
        return {"batch_s": wall, "model_calls": calls,
                "s_per_model_call": wall / calls}

    def local():
        eng = engine_lib.Engine(cfg, params, slots=4, queue_limit=32,
                                device="cuda")
        try:
            return batch(eng)
        finally:
            eng.shutdown()

    def mesh(sample: bool):
        def chief(placement):
            eng = engine_lib.Engine(cfg, params, slots=4, queue_limit=32,
                                    placement=placement)
            try:
                waits.clear()
                if not sample:
                    return batch(eng), None
                with StackSampler(("thread-ring-", "lm-engine",
                                   "planbus-sender")) as s:
                    rec = batch(eng)
                return rec, s.top()
            finally:
                eng.shutdown()

        (rec, stacks), _ = mesh_serve.run_in_threads(4, cfg, params, chief,
                                                     device="cuda",
                                                     timeout=900)
        rec["host_s_in"] = {f"{n} @ {t}": s for (n, t), s in
                            sorted(waits.items())}
        if stacks is not None:
            rec["stacks"] = stacks
        return rec

    out = {"phase": "profile_mesh", "prompt_len": args.prompt_len,
           "new_tokens": new, "local": local()}
    torch.cuda.empty_cache()
    out["mesh"] = mesh(sample=False)
    out["mesh_sampled"] = mesh(sample=True)
    default = sys.getswitchinterval()
    sys.setswitchinterval(0.0005)
    try:
        out["mesh_switch_0.5ms"] = mesh(sample=False)
    finally:
        sys.setswitchinterval(default)
    for (c, m), fn in saved.items():
        setattr(c, m, fn)
    report["profile_mesh"] = out
    emit(out)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--path",
                   choices=["serve", "train", "engine", "spec", "resnet",
                            "vit", "fsdp", "pp", "mesh", "both"],
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    report = {"card": torch.cuda.get_device_name(0), "nvidia_smi": smi[0],
              "args": vars(args)}
    emit({"phase": "card", "nvidia_smi": smi[0]})
    rc = 0
    if args.path in ("serve", "both"):
        rc = rc or profile_serve(torch, args, report)
        torch.cuda.empty_cache()
    if args.path in ("train", "both"):
        rc = rc or profile_train(torch, args, report)
    if args.path == "engine":
        rc = rc or profile_engine(torch, args, report)
    if args.path == "spec":
        rc = rc or profile_spec(torch, args, report)
    if args.path in ("resnet", "vit"):
        rc = rc or profile_vision(torch, args, report, args.path)
    if args.path == "fsdp":
        rc = rc or profile_fsdp(torch, args, report)
    if args.path == "pp":
        rc = rc or profile_pp(torch, args, report)
    if args.path == "mesh":
        rc = rc or profile_mesh(torch, args, report)

    os.makedirs(os.path.join(REPO, "chip_reports"), exist_ok=True)
    with open(os.path.join(REPO, "chip_reports", "chip_profile.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
