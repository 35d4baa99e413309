#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (k8s_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. card: the card's name and power limit (nvidia-smi) and the device.
2. build: every CUDA kernel source, compiled in parallel (one nvcc each),
   and the Triton kernel's first compile.
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card at the serving and training paths' shapes and at the edges of
   the wgmma bodies (ragged tails, D 64 and 128, GQA groups 1 and 4, a
   window inside one tile, bidirectional Lk != L), with stated
   tolerances; kernel, plain and library-call device times and
   back-to-back wall times (CUDA events) beside the bound; each body's
   registers, spills and shared memory; dq and dk/dv bit-identical across
   two runs (dk/dv on both the split and the unsplit path); the delta the
   dq kernel writes against a torch reduction; RMSNorm timed over rotated
   buffers larger than the L2.
4. parity: the tiny test model (f32, both kernels on) generates the same
   greedy tokens on cuda (kernels) and cpu (plain versions), and its
   logits agree; then it trains 5 Adam steps on each from the same
   parameters and batches, and the losses and parameters agree.
5. serve: a Llama-3-8B-width LM (llama_8b, bf16, random weights from a
   seed) behind the single-flight HTTP server answers POST /v1/generate
   requests; the kernels' launch counters, zeroed just before, must show
   the path went through the forward kernels and no other.  Then its
   prefill logits are held against the same weights run through the plain
   attention and norm.
5b. engine: the continuous-batching engine (two slots, paged pool) gives
   the exclusive lane's tokens on the tiny model (f32 and int8 KV: mixed
   prompt lengths, a join mid-decode, EOS, a fixed-seed sampled request);
   then the port's default serving mode, ``LmServer(slots=4)`` over the
   same Llama-3-8B-width model, answers 8 concurrent requests, records a
   prefix hit on a repeated prompt and repeats a sampled request exactly;
   its counters must show RMSNorm at 2·32+1 launches a model call and no
   flash kernel, and its prefill logits are held against the
   single-flight model's.
6. train: ``k8s_tpu_torch.train_lm.main`` trains the gpt2-small preset at
   full width and depth (bf16, flash on, synthetic corpus) with
   checkpoints, exports a serving artifact and generates; the counters,
   zeroed just before, must equal exactly 12 launches per step of the
   flash forward and of each backward kernel (plus the generation's
   prefill); the artifact must load in the server and answer.  Then one
   gpt2-small step's gradients with the kernels are held against the same
   weights and batch through the plain attention, and a 2-layer cut of the
   Llama-3-8B widths trains 3 steps through GQA, head_dim 128 and the
   RMSNorm kernel with exact launch counts.

Prints the card line first, one JSON object per phase and case, then a
``{"kernels": [...]}`` line and last ``{"ok": true, "device": {...}}``.
Without a CUDA device, or away from the repository checkout, it exits
non-zero and prints no result.  Details go to
``chip_reports/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chip_reports")

# Peak rates of one H100 SXM (NVIDIA data sheet, dense): bf16/fp16 tensor
# cores, f32 outside the tensor cores, HBM3 bandwidth.
PEAK_16BIT = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
L2_BYTES = 50 * 2 ** 20  # the H100 SXM's L2 cache

REPORT: dict = {"cases": []}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


# Cycles of the spin kernel that holds the stream while the host queues the
# timed calls (~0.1 s at the H100's ~2 GHz clock).
SPIN_CYCLES = 200_000_000


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> dict:
    """One call's times after ``warmup`` calls, from CUDA events around
    ``iters`` calls.  ``ms`` is device time: the stream is first parked on
    a spin kernel, so the host has queued every call before the device
    starts them and the events bracket device work only.  ``wall_ms`` is
    the same from an idle stream: for small inputs that is the host's
    launch rate, not the device's time."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def bracket(park: bool) -> float:
        torch.cuda.synchronize()
        if park:
            torch.cuda._sleep(SPIN_CYCLES)
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_s = time.perf_counter() - t0
        end.synchronize()
        if park and queued_s > 0.05:
            fail(f"queueing {iters} calls took {queued_s:.3f} s, longer "
                 "than the spin kernel holds the stream")
        return start.elapsed_time(end) / iters

    wall_ms = bracket(park=False)
    return {"ms": bracket(park=True), "wall_ms": wall_ms}


def timed(torch, prefix: str, fn, **kw) -> dict:
    t = time_ms(torch, fn, **kw)
    return {prefix + "ms": t["ms"], prefix + "wall_ms": t["wall_ms"]}


def rotating(fn, xs, n: int):
    """A call of ``fn`` on ``xs[0]``, ``xs[1]``, ... in turn (``n`` of
    them, then around again), each call's output kept alive until its slot
    comes round again, so the calls read and write ``n`` distinct buffers."""
    keep, count = [None] * n, [0]

    def call():
        i = count[0] % n
        count[0] += 1
        keep[i] = fn(xs[i])
    return call


def bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops > t_bytes else "bytes"


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return r.stdout.strip().splitlines()[0]


# -- phase 3: kernels against their plain versions --------------------------


_TYPE_TOKENS = {"torch.bfloat16": "13__nv_bfloat16", "torch.float16": "6__half"}


def build_report(_build, kernel: str, dtype, D: int, split=False) -> dict:
    """Registers, spills and shared memory of the body that runs ``kernel``
    (flash_fwd, flash_bwd_dq or flash_bwd_dkv) for this type and head_dim:
    the first from nvcc's ptxas report in ``_build.BUILD_LOGS``, the
    dynamic shared memory from the library's own size query."""
    import re
    code = {"torch.float32": 0, "torch.bfloat16": 1, "torch.float16": 2}[str(dtype)]
    body = "fma" if code == 0 else ("wgmma" if D >= 64 else "mma")
    tmpl = f"Li{D}E" if code == 0 else f"{_TYPE_TOKENS[str(dtype)]}Li{D}E"
    if kernel == "flash_fwd":
        source, fn = "flash_fwd", f"flash_fwd_{body}I" + ("f" if code == 0 else "") + tmpl
        smem = _build.load(source).k8s_flash_fwd_smem(code, D)
    else:
        source, which = "flash_bwd", kernel[len("flash_bwd_"):]
        fn = f"flash_bwd_{which}_{body}I" + tmpl
        if body == "wgmma" and which == "dkv":
            fn = f"flash_bwd_dkv_wgmmaI{_TYPE_TOKENS[str(dtype)]}" \
                 f"{'f' if split else 'S1_'}Li{D}E"
        smem = _build.load(source).k8s_flash_bwd_smem(int(which == "dkv"), code, D)
    rep = {"body": f"{kernel}:{body}", "entry": fn, "smem_dynamic_bytes": smem,
           "registers": None, "spill_stores": None, "spill_loads": None,
           "smem_static_bytes": None}
    lines = _build.BUILD_LOGS.get(source, "").splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and fn in line:
            for nxt in lines[i + 1:i + 6]:
                if m := re.search(r"Used (\d+) registers", nxt):
                    rep["registers"] = int(m.group(1))
                    m = re.search(r"(\d+) bytes smem", nxt)
                    rep["smem_static_bytes"] = int(m.group(1)) if m else 0
                if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                                  r"loads", nxt):
                    rep["spill_stores"] = int(m.group(1))
                    rep["spill_loads"] = int(m.group(2))
            break
    return rep




def rms_cases(torch, F, fused_norm):
    """RMSNorm: x [N, D] with a scale [D].  Tolerance: f32 inputs 1e-5
    relative (summation order and rsqrt rounding only); 16-bit x one
    rounding step of x.dtype (the normalized row is rounded to x.dtype, and
    an rsqrt one ulp apart can round it the other way), plus one step of a
    16-bit output.  The timed calls rotate over copies of x and keep their
    outputs, twice the L2's bytes in all, so every call reads x from HBM
    and writes an output that is not in the L2; a warm-up call on each
    buffer first leaves every output allocated, so no timed call waits
    on the allocator.  The library call
    (``F.rms_norm``, scale cast to x.dtype) writes x.dtype: it computes
    K1's function only where the scale is x.dtype too (``bf16x_bf16s``);
    no PyTorch call writes K1's f32 output from a bf16 x."""
    bf, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    cases = [("main_prefill", 509, 4096, bf, f32),
             ("main_decode", 1, 4096, bf, f32),
             ("engine_decode_4", 4, 4096, bf, f32),
             ("main_17", 17, 4096, bf, f32),
             ("main_64", 64, 4096, bf, f32),
             ("main_128", 128, 4096, bf, f32),
             ("bf16x_f32s", 2048, 4096, bf, f32),
             ("bf16x_bf16s", 2048, 4096, bf, bf),
             ("ragged_rows", 1000, 4096, bf, f32),
             ("small_f32", 7, 64, f32, f32),
             ("ragged_d_f16", 5, 100, f16, f32)]
    g = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for name, N, D, xd, sd in cases:
        x = torch.randn(N, D, generator=g, device="cuda").to(xd)
        s = (1 + 0.1 * torch.randn(D, generator=g, device="cuda")).to(sd)
        got = fused_norm.rms_norm(x, s)
        torch.cuda.synchronize()
        ref = fused_norm.rms_norm_plain(x, s)
        if got.dtype != ref.dtype or got.shape != ref.shape:
            fail(f"rms_norm {name}: {got.dtype}{tuple(got.shape)} vs "
                 f"{ref.dtype}{tuple(ref.shape)}")
        if xd == f32:
            rtol = 1e-5
        else:
            rtol = torch.finfo(xd).eps + (
                torch.finfo(got.dtype).eps if got.dtype != f32 else 0.0)
        diff = (got.float() - ref.float()).abs()
        err = diff.max().item()
        if not bool((diff <= 1e-6 + rtol * ref.float().abs()).all()):
            fail(f"rms_norm {name}: max abs err {err} beyond rtol {rtol}")
        w16 = s.to(xd)
        per_call = N * D * (x.element_size() + got.element_size())
        n_buf = max(2, -(-2 * L2_BYTES // per_call))
        xs = x.expand(n_buf, N, D).clone()
        nbytes = per_call + D * s.element_size()
        b_ms, b_by = bound(4 * N * D, nbytes, PEAK_F32)
        rec = {"phase": "kernel", "kernel": "rms_norm", "case": name,
               "shape": [N, D], "x": str(xd), "scale": str(sd),
               "max_abs_err": err, "rtol": rtol, "rotated_buffers": n_buf,
               **timed(torch, "", rotating(
                   lambda xi: fused_norm.rms_norm(xi, s), xs, n_buf),
                   warmup=n_buf),
               **timed(torch, "plain_", rotating(
                   lambda xi: fused_norm.rms_norm_plain(xi, s), xs, n_buf),
                   warmup=n_buf),
               **timed(torch, "library_", rotating(
                   lambda xi: F.rms_norm(xi, (D,), w16, 1e-6), xs, n_buf),
                   warmup=n_buf),
               "library_same_output_type": got.dtype == xd,
               "bound_ms": b_ms, "bound_by": b_by}
        del xs
        emit(rec)
        REPORT["cases"].append(rec)
        out[name] = rec
    return out


def visible_pairs(L: int, Lk: int, causal: bool, window) -> int:
    """(q, k) pairs the mask keeps, per (batch, head)."""
    if causal:
        return sum(min(i + 1, window or L) for i in range(L))
    return L * Lk


def flash_cases(torch, F, flash, _build):
    """Flash forward: q [B, H, L, D], k/v [B, Hkv, Lk, D].  Tolerance: f32
    2e-5 (summation order only, the reference's own test tolerance); bf16
    o 2e-2 absolute (the tensor-core body rounds p to bf16 before p.v and
    o itself is rounded to bf16, so o can move one bf16 step, 2^-6 at |o|
    in [2, 4)) and lse 1e-3 (f32 log-sum-exp over up to 2048 terms,
    summed in another order).  Beside the main-path shapes, the edges of
    the 128-row wgmma body: ragged tails (L 1000, 301), D 64 and 128, GQA
    groups 1 and 4, a window smaller than one tile, bidirectional with
    Lk != L."""
    bf, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    cases = [("gpt2_train", 8, 12, 12, 1024, 1024, 64, bf, True, None),
             ("main_prefill", 1, 32, 8, 509, 509, 128, bf, True, None),
             ("main_17", 1, 32, 8, 17, 17, 128, bf, True, None),
             ("main_64", 1, 32, 8, 64, 64, 128, bf, True, None),
             ("main_128", 1, 32, 8, 128, 128, 128, bf, True, None),
             ("llama_2048", 1, 32, 8, 2048, 2048, 128, bf, True, None),
             ("window_509", 1, 32, 8, 509, 509, 128, bf, True, 256),
             ("window_2048", 1, 32, 8, 2048, 2048, 128, bf, True, 256),
             ("ragged_1000_d64_g1", 2, 4, 4, 1000, 1000, 64, bf, True, None),
             ("ragged_301_d128_g4_f16", 2, 8, 2, 301, 301, 128, f16, True,
              None),
             ("window_48_d128_g4", 1, 8, 2, 509, 509, 128, bf, True, 48),
             ("cross_d128_g4", 1, 8, 2, 301, 1000, 128, bf, False, None),
             ("f16_d32_ragged", 2, 8, 2, 301, 301, 32, f16, True, None),
             ("f32_d16_causal", 2, 4, 2, 130, 130, 16, f32, True, None),
             ("f32_d16_window", 1, 4, 4, 77, 77, 16, f32, True, 4),
             ("f32_d16_cross", 2, 4, 2, 13, 37, 16, f32, False, None)]
    g = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for name, B, H, Hkv, L, Lk, D, dt, causal, window in cases:
        q = torch.randn(B, H, L, D, generator=g, device="cuda").to(dt)
        k = torch.randn(B, Hkv, Lk, D, generator=g, device="cuda").to(dt)
        v = torch.randn(B, Hkv, Lk, D, generator=g, device="cuda").to(dt)
        scale = D ** -0.5
        o, lse = flash.flash_fwd(q, k, v, scale, causal, window)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash.flash_fwd_plain(q, k, v, scale, causal, window)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_l = (lse - lse_ref).abs().max().item()
        tol_o, tol_l = (2e-5, 2e-5) if dt == f32 else (2e-2, 1e-3)
        if not (err_o <= tol_o and err_l <= tol_l) or o.dtype != dt:
            fail(f"flash {name}: o err {err_o} (tol {tol_o}), lse err "
                 f"{err_l} (tol {tol_l})")
        pairs = visible_pairs(L, Lk, causal, window)
        esz = q.element_size()
        nbytes = esz * (2 * B * H * L * D + 2 * B * Hkv * Lk * D) \
            + 4 * B * H * L
        b_ms, b_by = bound(4 * B * H * D * pairs, nbytes,
                           PEAK_16BIT if esz == 2 else PEAK_F32)
        mask = None
        if window is not None:
            qp = torch.arange(L, device="cuda")[:, None]
            kp = torch.arange(Lk, device="cuda")[None, :]
            mask = (kp <= qp) & (qp - kp < window)

        def library():
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=Hkv != H)

        rec = {"phase": "kernel", "kernel": "flash_fwd", "case": name,
               "B": B, "H": H, "Hkv": Hkv, "L": L, "Lk": Lk, "D": D,
               "dtype": str(dt), "causal": causal, "window": window,
               "max_abs_err": err_o, "lse_max_abs_err": err_l,
               "tol_o": tol_o, "tol_lse": tol_l,
               **timed(torch, "", lambda: flash.flash_fwd(
                   q, k, v, scale, causal, window)),
               **timed(torch, "plain_", lambda: flash.flash_fwd_plain(
                   q, k, v, scale, causal, window), iters=5),
               **timed(torch, "library_", library),
               "bound_ms": b_ms, "bound_by": b_by,
               "visible_pairs": pairs,
               **build_report(_build, "flash_fwd", dt, D)}
        emit(rec)
        REPORT["cases"].append(rec)
        out[name] = rec
    return out


def flash_bwd_cases(torch, F, flash, _build):
    """Flash backward: K3 (dq) and K4 (dk/dv) against flash_bwd_plain on
    the same q, k, v, do and the forward kernel's o and lse.  Tolerance,
    as a share of the largest |gradient| of each tensor: f32 1e-4
    (summation order only); 16-bit 2e-2: the kernels round p and ds to the
    input type before their products (relative 2^-9 each, over sums of up
    to 2048 x 4 terms) and round each gradient to it once more on the way
    out, while the plain version keeps all of it in f32.  dq, dk and dv
    must come out bit-identical from a second run on the same inputs, on
    the dk/dv kernel's split path (f32 partials summed by the wrapper) and
    its unsplit path alike; ``_dkv_plan`` puts gpt2_train and llama_509 on
    different sides, and each record names its side; each dq record names
    its ``_dq_plan``, whose body must be the one the build reports.  The
    delta the dq kernel writes (f32 ``rowsum(do * o)``) must match
    ``(do.float() * o.float()).sum(-1)`` within 1e-5 of the row's
    ``sum(|do * o|)``: the two sum the same f32 products in different
    orders."""
    bf, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    cases = [("gpt2_train", 8, 12, 12, 1024, 1024, 64, bf, True, None),
             ("llama_509", 1, 32, 8, 509, 509, 128, bf, True, None),
             ("llama_2048", 1, 32, 8, 2048, 2048, 128, bf, True, None),
             ("window_2048", 1, 32, 8, 2048, 2048, 128, bf, True, 256),
             ("ragged_1000_d64_g1", 2, 4, 4, 1000, 1000, 64, bf, True, None),
             ("ragged_301_d128_g4_f16", 2, 8, 2, 301, 301, 128, f16, True,
              None),
             ("window_48_d128_g4", 1, 8, 2, 509, 509, 128, bf, True, 48),
             ("cross_d128_g4", 1, 8, 2, 301, 1000, 128, bf, False, None),
             ("f16_d32_ragged", 2, 8, 2, 301, 301, 32, f16, True, None),
             ("bf16_cross", 2, 4, 4, 100, 257, 64, bf, False, None),
             ("f32_d16_causal", 2, 4, 2, 130, 130, 16, f32, True, None),
             ("f32_d16_window", 1, 4, 4, 77, 77, 16, f32, True, 4),
             ("f32_d16_cross", 2, 4, 2, 13, 37, 16, f32, False, None)]
    g = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for name, B, H, Hkv, L, Lk, D, dt, causal, window in cases:
        q = torch.randn(B, H, L, D, generator=g, device="cuda").to(dt)
        k = torch.randn(B, Hkv, Lk, D, generator=g, device="cuda").to(dt)
        v = torch.randn(B, Hkv, Lk, D, generator=g, device="cuda").to(dt)
        do = torch.randn(B, H, L, D, generator=g, device="cuda").to(dt)
        scale = D ** -0.5
        args = (scale, causal, window)
        o, lse = flash.flash_fwd(q, k, v, *args)
        got = flash.flash_bwd(q, k, v, o, lse, do, *args)
        torch.cuda.synchronize()
        ref = flash.flash_bwd_plain(q, k, v, o, lse, do, *args)
        tol = 1e-4 if dt == f32 else 2e-2
        errs = {}
        for gname, a, r in zip(("dq", "dk", "dv"), got, ref):
            if a.dtype != dt or a.shape != r.shape:
                fail(f"flash_bwd {name} {gname}: {a.dtype}{tuple(a.shape)} "
                     f"vs {r.dtype}{tuple(r.shape)}")
            err = (a.float() - r.float()).abs().max().item()
            top = r.float().abs().max().item()
            if not err <= tol * top:
                fail(f"flash_bwd {name} {gname}: max abs err {err} beyond "
                     f"{tol} x max |grad| {top}")
            errs[gname] = {"max_abs_err": err, "max_abs": top}
        again = flash.flash_bwd(q, k, v, o, lse, do, *args)
        torch.cuda.synchronize()
        plan = flash._dkv_plan(B, H, Hkv, L, Lk, D, causal, window, dt)
        dq_plan = flash._dq_plan(B, H, L, D, dt)
        path = "split" if plan.nsplit > 1 else "unsplit"
        if not torch.equal(got[0], again[0]):
            fail(f"flash_bwd {name}: dq differs between two runs on the same "
                 "inputs")
        if not all(torch.equal(a, b) for a, b in zip(got[1:], again[1:])):
            fail(f"flash_bwd {name}: dk/dv differ between two runs on the "
                 f"same inputs ({path} path)")

        # each kernel alone, on the operands flash_bwd hands it (the dk/dv
        # kernel with its plan's partial sums), then the whole backward
        do_k, o_k, lse_k, delta = flash._bwd_operands(q, o, lse, do)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        flash._launch_bwd("bwd_dq", q, k, v, do_k, lse_k, delta, (dq,),
                          *args, o=o_k)
        prod = do.float() * o.float()
        delta_err = ((delta - prod.sum(-1)).abs()
                     / prod.abs().sum(-1).clamp_min(1e-30)).max().item()
        if not delta_err <= 1e-5:
            fail(f"flash_bwd {name}: the dq kernel's delta is {delta_err} of "
                 "sum(|do * o|) off the f32 torch reduction (tol 1e-5)")
        del prod
        t_dq = time_ms(torch, lambda: flash._launch_bwd(
            "bwd_dq", q, k, v, do_k, lse_k, delta, (dq,), *args, o=o_k))
        t_dkv = time_ms(torch, lambda: flash._launch_dkv(
            q, k, v, do_k, lse_k, delta, dk, dv, *args))
        t_pair = time_ms(torch, lambda: flash.flash_bwd(
            q, k, v, o, lse, do, *args))
        t_plain = time_ms(torch, lambda: flash.flash_bwd_plain(
            q, k, v, o, lse, do, *args), iters=3)
        # the library's backward alone: SDPA forward + backward minus SDPA
        # forward, timed the same way
        mask = None
        if window is not None:
            qp = torch.arange(L, device="cuda")[:, None]
            kp = torch.arange(Lk, device="cuda")[None, :]
            mask = (kp <= qp) & (qp - kp < window)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(
                qg, kg, vg, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=Hkv != H)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), (qg, kg, vg), do)

        lib_f, lib_fb = time_ms(torch, sdpa), time_ms(torch, sdpa_fwd_bwd)
        library_ms = lib_fb["ms"] - lib_f["ms"]
        pairs = visible_pairs(L, Lk, causal, window)
        esz = q.element_size()
        q_bytes, kv_bytes = esz * B * H * L * D, esz * B * Hkv * Lk * D
        row_bytes = 2 * 4 * B * H * L  # lse and delta
        peak = PEAK_16BIT if esz == 2 else PEAK_F32
        dq_rep = build_report(_build, "flash_bwd_dq", dt, D)
        if dq_rep["body"] != "flash_bwd_dq:" + dq_plan.body:
            fail(f"flash_bwd {name}: _dq_plan names body {dq_plan.body}, the "
                 f"build runs {dq_rep['body']}")
        for kname, flops_per, nbytes, t, extra in (
                ("flash_bwd_dq", 6, 4 * q_bytes + 2 * kv_bytes + row_bytes,
                 t_dq, {**dq_rep, "plan": dataclasses.asdict(dq_plan),
                        "blocks": dq_plan.blocks, "delta_rel_err": delta_err,
                        "deterministic": True}),
                ("flash_bwd_dkv", 8, 2 * q_bytes + 4 * kv_bytes + row_bytes,
                 t_dkv, {**build_report(_build, "flash_bwd_dkv", dt, D,
                                        split=plan.nsplit > 1),
                         "dkv_path": path, "nsplit": plan.nsplit,
                         "blocks": plan.blocks, "deterministic": True})):
            b_ms, b_by = bound(flops_per * B * H * D * pairs, nbytes, peak)
            rec = {"phase": "kernel", "kernel": kname, "case": name,
                   "B": B, "H": H, "Hkv": Hkv, "L": L, "Lk": Lk, "D": D,
                   "dtype": str(dt), "causal": causal, "window": window,
                   "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
                   "errors": errs, "tol_share_of_max": tol,
                   "ms": t["ms"], "wall_ms": t["wall_ms"],
                   "plain_ms": t_plain["ms"],
                   "plain_wall_ms": t_plain["wall_ms"],
                   "plain_is": "flash_bwd_plain (dq, dk and dv together)",
                   "library_ms": library_ms,
                   "library_is": "SDPA forward+backward minus SDPA forward",
                   "bwd_pair_ms": t_pair["ms"],
                   "bwd_pair_is": "flash_bwd: K3 (with delta) and K4 "
                                  "together",
                   "bound_ms": b_ms, "bound_by": b_by,
                   "visible_pairs": pairs, **extra}
            emit(rec)
            REPORT["cases"].append(rec)
            out[(kname, name)] = rec
    sides = {n: out[("flash_bwd_dkv", n)]["dkv_path"]
             for n in ("gpt2_train", "llama_509")}
    if sides["gpt2_train"] == sides["llama_509"]:
        fail(f"_dkv_plan put gpt2_train and llama_509 on one side: {sides}")
    return out


# -- phase 4: the kernel path against the plain path on a tiny model --------


def parity(torch, tlib, bridge, decode):
    cfg = dataclasses.replace(tlib.tiny_test(), use_flash_attention=True,
                              use_fused_norm=True)
    params = bridge.init_params(cfg, seed=3, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (1, 37),
                           generator=torch.Generator().manual_seed(4))
    toks = {dev: decode.generate(cfg, params, prompt, 24, device=dev).cpu()
            for dev in ("cuda", "cpu")}
    if not torch.equal(toks["cuda"], toks["cpu"]):
        fail(f"tiny greedy tokens differ: cuda {toks['cuda'].tolist()} "
             f"cpu {toks['cpu'].tolist()}")
    errs = []
    with torch.inference_mode():
        models = {d: tlib.Transformer(cfg, params, device=d)
                  for d in ("cuda", "cpu")}
        caches = {d: models[d].new_cache() for d in models}
        logits = {d: models[d](prompt.to(d), mode="prefill",
                               cache=caches[d]).cpu() for d in models}
        errs.append((logits["cuda"] - logits["cpu"]).abs().max().item())
        for step in range(4):
            tok = toks["cpu"][:, step:step + 1]
            pos = torch.full((1, 1), 37 + step)
            logits = {d: models[d](tok.to(d), positions=pos.to(d),
                                   mode="decode", cache=caches[d]).cpu()
                      for d in models}
            errs.append((logits["cuda"] - logits["cpu"]).abs().max().item())
    if max(errs) > 1e-4:
        fail(f"tiny logits cuda vs cpu differ by {max(errs)} (> 1e-4)")
    rec = {"phase": "parity", "config": "tiny_test f32 flash+fused",
           "prompt_len": 37, "new_tokens": 24, "tokens_equal": True,
           "logits_max_abs_err": max(errs), "tol": 1e-4}
    emit(rec)
    REPORT["parity"] = rec


# -- phase 5: the served main path ------------------------------------------


def http(url: str, payload=None, timeout: float = 600.0):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"},
        method="GET" if payload is None else "POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body = json.loads(resp.read())
            code = resp.status
    except urllib.error.HTTPError as e:
        fail(f"{url} answered {e.code}: {e.read()[:500]!r}")
    return code, body, time.perf_counter() - t0


def serve_main_path(torch, tlib, bridge, server, common):
    cfg = dataclasses.replace(tlib.llama_8b(), use_flash_attention=True,
                              use_fused_norm=True, dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = bridge.init_params(cfg, seed=0, device="cuda")
    lm = server.LmServer(config=cfg, params=params, slots=0, device="cuda",
                         default_max_new_tokens=32)
    del params
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    httpd = server.serve(lm, "127.0.0.1", 0)
    url = "http://%s:%d" % httpd.server_address[:2]
    rng = torch.Generator().manual_seed(5)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()

    try:
        code, health, _ = http(url + "/healthz")
        if code != 200 or health.get("status") != "ok":
            fail(f"/healthz: {code} {health}")
        prompts = {n: prompt(n) for n in (17, 128, 509, 64)}
        plan = [("greedy_17", 17, 32, {}), ("greedy_128", 128, 32, {})]
        plan += [(f"greedy_509_{i}", 509, 32, {}) for i in range(3)]
        plan += [(f"ttft_509_{i}", 509, 1, {}) for i in range(5)]
        sampled = {"temperature": 0.8, "top_k": 50, "seed": 7}
        plan += [("sampled_a", 64, 32, sampled), ("sampled_b", 64, 32,
                                                  sampled)]
        # the main path's run: counters zeroed just before, read just after
        common.reset_launches()
        results = {}
        for name, n, new, extra in plan:
            code, body, secs = http(url + "/v1/generate", dict(
                tokens=prompts[n], max_new_tokens=new, **extra))
            toks = body.get("tokens")
            if code != 200 or not isinstance(toks, list) or len(toks) != new \
                    or not all(0 <= t < cfg.vocab_size for t in toks):
                fail(f"request {name}: {code} {str(body)[:300]}")
            results[name] = {"prompt_len": n, "new_tokens": new,
                             "seconds": secs, "tokens": toks}
        torch.cuda.synchronize()
        launches = common.launches()
        code, _, _ = http(url + "/healthz")
    finally:
        httpd.shutdown()
        httpd.server_close()
        lm.close()
    if results["sampled_a"]["tokens"] != results["sampled_b"]["tokens"]:
        fail("the repeated sampled request (seed 7) gave different tokens")
    calls = sum(new for _, _, new, _ in plan)  # 1 prefill + new-1 decodes
    want = {"flash_fwd": cfg.layers * len(plan),
            "rms_norm": (2 * cfg.layers + 1) * calls,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    if launches != want:
        fail(f"main-path launches {launches}, expected {want}")
    # TTFT: a max_new_tokens=1 request (prefill + head + first sample,
    # over HTTP); decode rate: the other 31 tokens of a 32-token request
    ttft = sorted(results[f"ttft_509_{i}"]["seconds"] for i in range(5))
    ttft_med = ttft[2]
    decode_tps = sorted(31 / (results[f"greedy_509_{i}"]["seconds"]
                              - ttft_med) for i in range(3))
    rec = {"phase": "serve", "config": "llama_8b bf16 flash+fused",
           "layers": cfg.layers, "requests": len(plan),
           "setup_s": setup_s,
           "request_s": {k: v["seconds"] for k, v in results.items()},
           "ttft_509_s": ttft, "ttft_509_median_s": ttft_med,
           "decode_tokens_per_s_509": decode_tps,
           "decode_tokens_per_s_509_median": decode_tps[1],
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launches, "expected_launches": want,
           "sampled_repeat_identical": True}
    emit(rec)
    REPORT["serve"] = rec
    check_against_plain(torch, tlib, lm, prompts)
    return launches


def check_against_plain(torch, tlib, lm, prompts):
    """The served model's prefill logits against the same weights through
    the plain attention and norm on the card.  Through 32 random bf16
    layers a one-step bf16 difference in one attention output moves
    later activations, so this is held loosely (5e-2 of the largest
    logit); the tight check is the tiny model's parity phase."""
    ref_cfg = dataclasses.replace(lm.config, use_flash_attention=False,
                                  use_fused_norm=False)
    ref = tlib.Transformer(ref_cfg, lm.model.state_dict(), device="cuda")
    out = {}
    with torch.inference_mode():
        for n in (17, 509):
            toks = torch.tensor([prompts[n]], device="cuda")
            a = lm.model(toks, mode="prefill", cache=lm.model.new_cache())
            b = ref(toks, mode="prefill", cache=ref.new_cache())
            if not bool(torch.isfinite(a).all()):
                fail(f"non-finite logits at prompt length {n}")
            rel = ((a - b).abs().max() / b.abs().max()).item()
            agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
            if rel > 5e-2:
                fail(f"8B prefill logits vs plain path: rel err {rel}")
            out[n] = {"rel_err": rel, "argmax_agreement": agree}
    rec = {"phase": "serve_vs_plain", "prompt_lens": out, "tol_rel": 5e-2}
    emit(rec)
    REPORT["serve_vs_plain"] = rec


# -- phase 5b: the continuous-batching engine ----------------------------------


def engine_parity(torch, tlib, bridge, decode, engine_lib):
    """The engine (two slots, paged pool) against the port's exclusive lane
    (the single-flight program on the engine's model) on the card, on the
    tiny test model in f32 with both kernels on: mixed prompt lengths from
    threads, a request joining mid-decode, an EOS request and a fixed-seed
    sampled request give the same tokens on both lanes; so do a greedy and
    a sampled request on the int8-KV config.  Pool refcounts are checked
    after each engine's run."""
    import threading

    base = dataclasses.replace(tlib.tiny_test(), use_flash_attention=True,
                               use_fused_norm=True)
    rng = torch.Generator().manual_seed(14)

    def prompt(n):
        return torch.randint(0, base.vocab_size, (n,), generator=rng).tolist()

    rec = {"phase": "engine_parity", "config": "tiny_test f32 flash+fused",
           "slots": 2, "cases": {}}
    for label, cfg in (("f32", base), ("int8_kv", dataclasses.replace(
            base, kv_cache_dtype="int8"))):
        params = bridge.init_params(cfg, seed=13, device="cpu")
        eng = engine_lib.Engine(cfg, params, slots=2, queue_limit=32,
                                device="cuda")

        def exclusive(p, n, eos=None, temperature=0.0, top_k=None, seed=0):
            fn = decode._cached_generate_fn(cfg, n, temperature, top_k, eos,
                                            0)

            def run():
                gen = torch.Generator(device="cuda").manual_seed(seed)
                row = fn(eng.model, torch.tensor([p], device="cuda"),
                         gen)[0].tolist()
                return row[:row.index(eos) + 1] if eos in row else row
            return eng.submit_exclusive(run, timeout=300)

        def check(name, got, want):
            if got != want:
                fail(f"engine_parity {label} {name}: engine {got}, "
                     f"exclusive lane {want}")
            rec["cases"][f"{label}/{name}"] = len(got)

        try:
            if label == "f32":
                prompts = [prompt(n) for n in (3, 7, 13, 5, 21)]
                got = {}

                def run(i, p):
                    got[i] = eng.submit(p, 8, timeout=300)
                threads = [threading.Thread(target=run, args=(i, p))
                           for i, p in enumerate(prompts)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(300)
                for i, p in enumerate(prompts):
                    check(f"mixed_{len(p)}", got.get(i), exclusive(p, 8))
                long_p, short_p = prompt(9), prompt(4)
                t = threading.Thread(target=lambda: got.__setitem__(
                    "long", eng.submit(long_p, 24, timeout=300)))
                t.start()
                deadline = time.time() + 60
                while eng.stats()["steps"] < 3 and time.time() < deadline:
                    time.sleep(0.002)
                got["short"] = eng.submit(short_p, 5, timeout=300)
                t.join(300)
                check("join_long", got.get("long"), exclusive(long_p, 24))
                check("join_short", got["short"], exclusive(short_p, 5))
                p = prompt(6)
                eos = exclusive(p, 8)[3]
                check("eos", eng.submit(p, 8, eos_id=eos, timeout=300),
                      exclusive(p, 8, eos=eos))
                p = prompt(9)
                check("sampled", eng.submit(p, 10, temperature=0.8, top_k=5,
                                            seed=3, timeout=300),
                      exclusive(p, 10, temperature=0.8, top_k=5, seed=3))
            else:
                # greedy only: the exclusive lane's prefill attends the
                # prompt's unquantized K/V, the engine's chunked prefill
                # the int8 round trip, so a sampled draw may flip
                for n in (9, 21):
                    p = prompt(n)
                    check(f"greedy_{n}", eng.submit(p, 6, timeout=300),
                          exclusive(p, 6))
            eng.debug_check_blocks()
        finally:
            eng.shutdown()
    emit(rec)
    REPORT["engine_parity"] = rec


def engine_prefill_logits(torch, eng, ids):
    """The engine's cold prefill of ``ids``: its own prefill body, chunk
    by bucket chunk, into a private pool (so the served pool and prefix
    tree are untouched), on the engine thread.  Returns the last
    position's f32 logits ``[V]``."""
    from k8s_tpu_torch.models.decode import split_prefill

    bs = eng.block_size
    nb = -(-len(ids) // bs)

    def run():
        with torch.inference_mode():
            pool = eng._compute.build_pool(1 + nb, bs, "cuda")
            table = torch.arange(1, 1 + nb, device="cuda")
            off = 0
            for c in split_prefill(len(ids), eng.buckets):
                pos = torch.arange(off, off + c, device="cuda")[None]
                last = eng._compute.prefill_paged(
                    pool, table[:-(-(off + c) // bs)],
                    torch.tensor([ids[off:off + c]], device="cuda"), pos)
                off += c
            return last[0]
    return eng.submit_exclusive(run, timeout=600)


def serve_engine(torch, tlib, bridge, server, common, requestlog):
    """The port's default serving mode at the served width: llama_8b (32
    layers, bf16, both forward kernels on, random weights from seed 0)
    behind ``LmServer(slots=4)`` over HTTP.  Eight concurrent greedy
    requests, a repeat of the longest prompt (a prefix hit), the same
    sampled request twice, then the engine's prefill logits against the
    single-flight model's.  The kernels' counters, zeroed just before the
    requests and read just after, must show RMSNorm at 2·32+1 launches
    for each model call the engine counts and no flash kernel: batched
    prefill goes through the paged attention, as in the reference."""
    import threading

    cfg = dataclasses.replace(tlib.llama_8b(), use_flash_attention=True,
                              use_fused_norm=True, dtype=torch.bfloat16)
    os.environ["K8S_TPU_REQUEST_LOG"] = "1"  # per-request TTFT records
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = bridge.init_params(cfg, seed=0, device="cuda")
    lm = server.LmServer(config=cfg, params=params, slots=4, device="cuda",
                         default_max_new_tokens=32)
    del params
    eng = lm.engine
    pool_gib = sum(t.numel() * t.element_size() for node in eng._pool
                   for t in node.values()) / 2 ** 30
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    httpd = server.serve(lm, "127.0.0.1", 0)
    url = "http://%s:%d" % httpd.server_address[:2]
    rng = torch.Generator().manual_seed(5)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()

    def post(p, new, **extra):
        code, body, secs = http(url + "/v1/generate", dict(
            tokens=p, max_new_tokens=new, **extra))
        toks = body.get("tokens")
        if code != 200 or not isinstance(toks, list) or len(toks) != new \
                or not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"engine request ({len(p)} tokens): {code} "
                 f"{str(body)[:300]}")
        return toks, secs

    try:
        post(prompt(33), 4)  # warm-up: allocator, cuBLAS handles
        prompts = {n: prompt(n) for n in (17, 64, 128, 509)}
        batch = [n for n in (17, 64, 128, 509) for _ in range(2)]
        st0 = eng.stats()
        # the main path's run: counters zeroed just before, read just after
        common.reset_launches()
        results: dict = {}

        def client(i, n):
            results[i] = post(prompts[n], 32)
        threads = [threading.Thread(target=client, args=(i, n))
                   for i, n in enumerate(batch)]
        t_batch = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        batch_s = time.perf_counter() - t_batch
        if len(results) != len(batch):
            fail(f"engine batch: {len(results)} of {len(batch)} answered")
        st1 = eng.stats()
        code_r, reqs, _ = http(url + "/debug/requests?n=64")
        again, again_s = post(prompts[509], 32)
        st2 = eng.stats()
        sampled = {"temperature": 0.8, "top_k": 50, "seed": 7}
        samp = [post(prompts[64], 32, **sampled)[0] for _ in range(2)]
        torch.cuda.synchronize()
        launches = common.launches()
        st3 = eng.stats()
        code, health, _ = http(url + "/healthz")
        code_e, ledger, _ = http(url + "/debug/engine?n=8")
        if code != 200 or health["serving"]["engine"] != \
                "continuous-batching" or code_e != 200 or code_r != 200:
            fail(f"engine /healthz {code} {health.get('serving')}, "
                 f"/debug/engine {code_e}, /debug/requests {code_r}")
        calls = st3["model_calls"] - st0["model_calls"]
        want = {"flash_fwd": 0, "rms_norm": (2 * cfg.layers + 1) * calls,
                "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        if launches != want:
            fail(f"engine main-path launches {launches}, expected {want} "
                 f"({calls} model calls)")
        if st1["peak_active"] < 3:
            fail(f"engine peak_active {st1['peak_active']} < 3")
        hits = st2["prefix_hits"] - st1["prefix_hits"]
        saved = st2["prefix_tokens_saved"] - st1["prefix_tokens_saved"]
        if hits != 1 or saved < 496:
            fail(f"509-token repeat: prefix hits +{hits}, tokens saved "
                 f"+{saved} (want +1, >= 496)")
        if samp[0] != samp[1]:
            fail("the repeated sampled request (seed 7) gave different "
                 f"tokens on the engine: {samp[0]} vs {samp[1]}")
        # the engine's cold prefill against the single-flight model's
        vs_plain, first = {}, None
        for n in (17, 509):
            a = engine_prefill_logits(torch, eng, prompts[n])
            with torch.inference_mode():
                b = lm.model(torch.tensor([prompts[n]], device="cuda"),
                             mode="prefill", cache=lm.model.new_cache())[0, -1]
            if not bool(torch.isfinite(a).all()):
                fail(f"engine prefill logits non-finite at length {n}")
            rel = ((a - b).abs().max() / b.abs().max()).item()
            if rel > 5e-2:
                fail(f"engine prefill logits vs single-flight at length {n}:"
                     f" rel err {rel} (> 5e-2)")
            top2 = torch.topk(a, 2).values.tolist()
            vs_plain[n] = {"rel_err": rel,
                           "argmax_equal": int(a.argmax()) == int(b.argmax()),
                           "top2_margin": top2[0] - top2[1]}
            if n == 509:
                first = int(a.argmax())
    finally:
        httpd.shutdown()
        httpd.server_close()
        lm.close()
    emitted = sum(len(toks) - 1 for toks, _ in results.values())
    ttft = {}  # the batch's requests (the warm-up's prompt is 33 tokens)
    for r in reqs["requests"]:
        if r.get("ttft_s") is not None and r["prompt_len"] in prompts:
            ttft.setdefault(str(r["prompt_len"]), []).append(r["ttft_s"])
    rec = {"phase": "serve_engine", "card": REPORT["card"],
           "config": "llama_8b bf16 flash+fused, LmServer(slots=4)",
           "layers": cfg.layers, "setup_s": setup_s,
           "pool_blocks": st3["pool_blocks"], "block_size": st3["block_size"],
           "pool_gib": pool_gib,
           "batch": {"prompt_lens": batch, "new_tokens": 32,
                     "wall_s": batch_s, "decode_tokens": emitted,
                     "decode_tokens_per_s": emitted / batch_s,
                     "client_s": {str(i): results[i][1]
                                  for i in range(len(batch))}},
           "ttft_s_by_prompt_len": ttft,
           "peak_active": st1["peak_active"],
           "repeat_509": {"prefix_hits_delta": hits,
                          "prefix_tokens_saved_delta": saved,
                          "seconds": again_s, "first_token": again[0],
                          "cold_first_token": first,
                          "first_token_equal": again[0] == first,
                          "cold_top2_margin": vs_plain[509]["top2_margin"]},
           "sampled_repeat_identical": True,
           "vs_single_flight": vs_plain, "tol_rel": 5e-2,
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2 ** 30,
           "model_calls": calls, "launches": launches,
           "expected_launches": want,
           "engine_rollup": ledger.get("rollup"),
           "stats": {k: v for k, v in st3.items()
                     if k != "occupancy_timeline"}}
    emit(rec)
    REPORT["serve_engine"] = rec
    requestlog.set_active(None)
    os.environ.pop("K8S_TPU_REQUEST_LOG", None)
    return launches


def train_parity(torch, tlib, bridge, train_lib, common):
    """The tiny model (f32, both kernels on) trains 5 Adam steps on cuda
    (kernels, forward and backward) and on cpu (plain versions) from the
    same parameters and batches.  Losses agree within 1e-4 (the logits'
    tolerance above); parameters within 1e-4 = a tenth of one step at lr
    1e-3, since Adam's update g / (|g| + eps) turns a last-bit gradient
    difference on a near-zero gradient into a visible step difference.
    Then remat on the card: the backward recomputes each block, launching
    the flash forward twice per layer, and gives the same gradients
    (1e-6: the recomputation repeats the same kernels on the same
    inputs)."""
    cfg = dataclasses.replace(tlib.tiny_test(), use_flash_attention=True,
                              use_fused_norm=True)
    params = bridge.init_params(cfg, seed=8, device="cpu",
                                dtype=torch.float32)
    gen = torch.Generator().manual_seed(9)
    batches = [torch.randint(0, cfg.vocab_size, (4, 96), generator=gen)
               for _ in range(5)]
    losses, finals = {}, {}
    for dev in ("cuda", "cpu"):
        model = tlib.Transformer(cfg, params, device=dev, trainable=True)
        opt = train_lib.default_optimizer(1e-3, clip_norm=1.0)
        state = train_lib.init_state(model, opt)
        step = train_lib.make_train_step(lambda m, x: m(x), train_lib.lm_loss,
                                         opt)
        out = []
        for b in batches:
            b = b.to(dev)
            state, loss = step(state, (b, b))
            out.append(loss)
        losses[dev] = torch.stack(out).tolist()
        finals[dev] = {n: p.detach().cpu()
                       for n, p in model.named_parameters()}
    loss_err = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
    param_err = max((finals["cuda"][n] - finals["cpu"][n]).abs().max().item()
                    for n in finals["cpu"])
    if not (loss_err <= 1e-4 and param_err <= 1e-4):
        fail(f"tiny training cuda vs cpu: loss err {loss_err}, param err "
             f"{param_err} (tol 1e-4 each)")

    grads, fwd = {}, {}
    b = batches[0].cuda()
    for remat in (False, True):
        model = tlib.Transformer(dataclasses.replace(cfg, remat=remat),
                                 params, device="cuda", trainable=True)
        common.reset_launches()
        train_lib.lm_loss(model(b), b).backward()
        torch.cuda.synchronize()
        fwd[remat] = common.launches()["flash_fwd"]
        grads[remat] = [p.grad for p in model.parameters()]
    remat_err = max((x - y).abs().max().item()
                    for x, y in zip(grads[False], grads[True]))
    if fwd != {False: cfg.layers, True: 2 * cfg.layers} or remat_err > 1e-6:
        fail(f"tiny remat on the card: flash_fwd launches {fwd}, grads "
             f"differ by {remat_err}")
    rec = {"phase": "train_parity", "config": "tiny_test f32 flash+fused",
           "steps": len(batches), "batch": [4, 96], "optimizer":
           "adam lr 1e-3 clip 1.0", "losses_cuda": losses["cuda"],
           "losses_cpu": losses["cpu"], "loss_max_abs_err": loss_err,
           "param_max_abs_err": param_err, "tol": 1e-4,
           "remat_flash_fwd_launches": {"off": fwd[False], "on": fwd[True]},
           "remat_grads_max_abs_err": remat_err}
    emit(rec)
    REPORT["train_parity"] = rec


# -- phase 6: the training main path ----------------------------------------


TRAIN_STEPS = 10
TRAIN_ARGS = ["--preset", "gpt2-small", "--batch_size", "8", "--seq_len",
              "1024", "--train_steps", str(TRAIN_STEPS), "--checkpoint_every",
              "5", "--log_every", "1", "--generate", "8", "--device", "cuda"]


def train_main_path(torch, train_lm, server, serving, common):
    """train_lm.main at the gpt2-small preset, full width and depth.  The
    step time is read from the per-step metrics records (each written
    after a host sync on that step's loss), leaving out warm-up and the
    steps that saved a checkpoint."""
    with tempfile.TemporaryDirectory() as train_dir:
        args = TRAIN_ARGS + ["--train_dir", train_dir]
        torch.cuda.reset_peak_memory_stats()
        # the main path's run: counters zeroed just before, read just after
        common.reset_launches()
        t0 = time.perf_counter()
        rc = train_lm.main(args)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = common.launches()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        if rc != 0:
            fail(f"train_lm.main exited {rc}")
        cfg = serving.load_config(train_dir)
        with open(os.path.join(train_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        losses = [r["loss"] for r in recs if "loss" in r]
        if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
            fail(f"train losses {losses}")
        # layers of one prefill per --generate call (decode steps run the
        # dense-cache path, not the flash kernel)
        want = {"flash_fwd": cfg.layers * (TRAIN_STEPS + 1),
                "flash_bwd_dq": cfg.layers * TRAIN_STEPS,
                "flash_bwd_dkv": cfg.layers * TRAIN_STEPS, "rms_norm": 0}
        if launches != want:
            fail(f"train main-path launches {launches}, expected {want}")
        # record j (step j, 1-based) is written before step j-1's
        # checkpoint: the interval j -> j+1 holds the save of step j-1
        t = {r["step"]: r["wall_time"] for r in recs if "loss" in r}
        steps_s = [t[j + 1] - t[j] for j in range(3, TRAIN_STEPS)
                   if (j - 1) % 5]
        step_s = sorted(steps_s)[len(steps_s) // 2]
        lm = server.LmServer(train_dir=train_dir, device="cuda")
        try:
            out = lm.generate(server.parse_request(
                lm.config, {"tokens": list(range(1, 33)),
                            "max_new_tokens": 8}, 8))
        finally:
            lm.close()
        toks = out.get("tokens", [])
        if len(toks) != 8 or not all(0 <= x < cfg.vocab_size for x in toks):
            fail(f"the exported artifact answered {out}")
    tokens_per_step = 8 * 1024
    rec = {"phase": "train", "config": "gpt2-small bf16 flash, train_lm.main",
           "args": TRAIN_ARGS, "layers": cfg.layers, "steps": TRAIN_STEPS,
           "losses": losses, "wall_s": wall_s,
           "step_s_samples": steps_s, "step_s_median": step_s,
           "tokens_per_s": tokens_per_step / step_s,
           "max_memory_allocated_gib": peak_gib,
           "launches": launches, "expected_launches": want,
           "export_answer": toks, "card": REPORT["card"]}
    emit(rec)
    REPORT["train"] = rec
    return launches


def grads_at_width(torch, tlib, bridge, train_lib, train_lm):
    """One gpt2-small step (B8 L1024 bf16) with the flash kernels against
    the same weights and batch through the plain attention, both held
    against the same step in f32 (plain attention).  The bf16 paths round
    in different places (the kernels round p before p.v and p, ds before
    the backward products; the plain path rounds the scores, the
    normalized probabilities and every einsum output), which moves each
    gradient by a few percent through 12 layers; a wrong kernel moves it
    by order one.  Held per gradient tensor (relative Frobenius error):
    kernels vs plain within 5e-2, and the kernels no further from the f32
    step than twice the plain path's distance (or 1e-2)."""
    cfg = train_lm.build_config(train_lm.parse_args(TRAIN_ARGS), True)
    params = bridge.init_params(cfg, 0, "cuda", dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (8, 1024),
                           generator=torch.Generator().manual_seed(10)
                           ).cuda()
    grads, loss = {}, {}
    for name, kw in (("kernels", {}),
                     ("plain", {"use_flash_attention": False}),
                     ("f32", {"use_flash_attention": False,
                              "dtype": torch.float32})):
        model = tlib.Transformer(dataclasses.replace(cfg, **kw), params,
                                 device="cuda", trainable=True)
        lv = train_lib.lm_loss(model(tokens), tokens)
        lv.backward()
        loss[name] = lv.item()
        grads[name] = {n: p.grad for n, p in model.named_parameters()}
        missing = [n for n, g in grads[name].items() if g is None]
        if missing:
            fail(f"gpt2-small {name} step left no gradient on {missing}")
        del model

    def rel(a, b):
        return {n: ((grads[a][n] - g).norm() / g.norm()).item()
                for n, g in grads[b].items()}

    k_p, k_f, p_f = rel("kernels", "plain"), rel("kernels", "f32"), \
        rel("plain", "f32")
    bad = [n for n in k_p if not (k_p[n] <= 5e-2
                                  and k_f[n] <= max(2 * p_f[n], 1e-2))]
    if bad or abs(loss["kernels"] - loss["plain"]) > 1e-2:
        n = (bad or [max(k_p, key=k_p.get)])[0]
        fail(f"gpt2-small grads: {n} kernels vs plain {k_p[n]}, vs f32 "
             f"{k_f[n]} (plain vs f32 {p_f[n]}), losses {loss}")
    rec = {"phase": "train_grads", "config": "gpt2-small, one step",
           "losses": loss, "tol_kernels_vs_plain": 5e-2,
           "max_rel_err_kernels_vs_plain": max(k_p.values()),
           "max_rel_err_kernels_vs_f32": max(k_f.values()),
           "max_rel_err_plain_vs_f32": max(p_f.values())}
    emit(rec)
    REPORT["train_grads"] = {**rec, "rel_err_kernels_vs_plain": k_p,
                             "rel_err_kernels_vs_f32": k_f,
                             "rel_err_plain_vs_f32": p_f}
    torch.cuda.empty_cache()


def llama_width_training(torch, tlib, bridge, train_lib, common):
    """llama_8b widths cut to 2 layers (layers 32 -> 2, so the f32
    weights, gradients and Adam moments fit one card), B1 L2048, bf16,
    flash and RMSNorm kernels on, no remat, 3 Adam steps; exact launch
    counts."""
    steps = 3
    cfg = dataclasses.replace(tlib.llama_8b(), layers=2, remat=False,
                              use_flash_attention=True, use_fused_norm=True,
                              dtype=torch.bfloat16)
    model = tlib.Transformer(
        cfg, bridge.init_params(cfg, 11, "cuda", dtype=torch.float32),
        device="cuda", trainable=True)
    opt = train_lib.default_optimizer(1e-4)
    state = train_lib.init_state(model, opt)
    step = train_lib.make_train_step(lambda m, x: m(x), train_lib.lm_loss,
                                     opt)
    gen = torch.Generator().manual_seed(12)
    batches = [torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen)
               .cuda() for _ in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    common.reset_launches()
    t0 = time.perf_counter()
    losses = [step(state, (b, b))[1] for b in batches]
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = common.launches()
    losses = torch.stack(losses).tolist()
    want = {"flash_fwd": cfg.layers * steps,
            "flash_bwd_dq": cfg.layers * steps,
            "flash_bwd_dkv": cfg.layers * steps,
            "rms_norm": (2 * cfg.layers + 1) * steps}
    if launches != want or not all(map(math.isfinite, losses)):
        fail(f"llama-width training: launches {launches} (expected {want}),"
             f" losses {losses}")
    rec = {"phase": "train_llama_width",
           "config": "llama_8b widths, layers 32 -> 2, bf16, flash+fused",
           "reduced": {"layers": [32, 2]}, "batch": [1, 2048],
           "steps": steps, "losses": losses, "wall_s": wall_s,
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launches, "expected_launches": want}
    emit(rec)
    REPORT["train_llama_width"] = rec
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke runs on the "
             "card")
    sys.path.insert(0, REPO)
    try:
        from k8s_tpu_torch import train_lm
        from k8s_tpu_torch.models import bridge, decode, server, serving
        from k8s_tpu_torch.models import engine as engine_lib
        from k8s_tpu_torch.models import requestlog
        from k8s_tpu_torch.models import train as train_lib
        from k8s_tpu_torch.models import transformer as tlib
        from k8s_tpu_torch.ops import _build, _common
        from k8s_tpu_torch.ops import flash_attention as flash
        from k8s_tpu_torch.ops import fused_norm
    except ImportError as e:
        fail(f"k8s_tpu_torch is not beside this script ({e}); run it from "
             "a checkout of the repository")
    import torch.nn.functional as F

    os.environ.setdefault(
        "TRITON_CACHE_DIR", os.path.join(_build.BUILD_DIR, "triton"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(OUT_DIR, exist_ok=True)
    t_start = time.perf_counter()

    card = card_line()
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(card, flush=True)
    emit({"phase": "card", "nvidia_smi": card, "device": name,
          "count": count, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    REPORT["card"] = card

    t0 = time.perf_counter()
    nvcc_s = _build.build_all()
    x = torch.ones(4, 64, device="cuda")
    fused_norm.rms_norm(x, torch.ones(64, device="cuda"))
    torch.cuda.synchronize()
    build = {"phase": "build", "nvcc_s": nvcc_s,
             "total_s": time.perf_counter() - t0}
    emit(build)
    REPORT["build"] = build
    with open(os.path.join(OUT_DIR, "build_log.txt"), "w") as f:
        for src, text in _build.BUILD_LOGS.items():
            f.write(f"== {src}\n{text}\n")

    rms = rms_cases(torch, F, fused_norm)
    fl = flash_cases(torch, F, flash, _build)
    bw = flash_bwd_cases(torch, F, flash, _build)
    parity(torch, tlib, bridge, decode)
    engine_parity(torch, tlib, bridge, decode, engine_lib)
    train_parity(torch, tlib, bridge, train_lib, _common)
    served = serve_main_path(torch, tlib, bridge, server, _common)
    gc.collect()
    torch.cuda.empty_cache()
    batched = serve_engine(torch, tlib, bridge, server, _common, requestlog)
    gc.collect()
    torch.cuda.empty_cache()
    trained = train_main_path(torch, train_lm, server, serving, _common)
    grads_at_width(torch, tlib, bridge, train_lib, train_lm)
    llama = llama_width_training(torch, tlib, bridge, train_lib, _common)

    # launches: every main path's count (each zeroed just before it is
    # driven and read just after), summed, and each path's beside it
    kernels = []
    for kname, route, source, replaces, rec in (
            ("flash_fwd", "cuda", "k8s_tpu_torch/csrc/flash_fwd.cu",
             "k8s_tpu/ops/flash_attention.py:99", fl["gpt2_train"]),
            ("rms_norm", "triton", "k8s_tpu_torch/ops/fused_norm.py",
             "k8s_tpu/ops/fused_norm.py:29", rms["bf16x_bf16s"]),
            ("flash_bwd_dq", "cuda", "k8s_tpu_torch/csrc/flash_bwd.cu",
             "k8s_tpu/ops/flash_attention.py:233",
             bw[("flash_bwd_dq", "gpt2_train")]),
            ("flash_bwd_dkv", "cuda", "k8s_tpu_torch/csrc/flash_bwd.cu",
             "k8s_tpu/ops/flash_attention.py:289",
             bw[("flash_bwd_dkv", "gpt2_train")])):
        by_path = {"train_gpt2_small": trained[kname],
                   "train_llama_width_2_layers": llama[kname],
                   "serve_llama_8b": served[kname],
                   "serve_engine_llama_8b": batched[kname]}
        kernels.append({"name": kname, "route": route, "source": source,
                        "replaces": replaces,
                        "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
                        "case": rec["case"],
                        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                        "wall_ms": rec["wall_ms"],
                        "plain_ms": rec["plain_ms"],
                        "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"],
                        "library_ms": rec["library_ms"],
                        **{key: rec[key] for key in (
                            "body", "plan", "registers", "spill_stores",
                            "spill_loads", "smem_dynamic_bytes")
                           if key in rec}})
    REPORT["kernels"] = kernels
    REPORT["total_s"] = time.perf_counter() - t_start
    emit({"phase": "done", "total_s": REPORT["total_s"]})
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(REPORT, f, indent=1)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
