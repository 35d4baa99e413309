#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (k8s_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. card: the card's name and power limit (nvidia-smi) and the device.
2. build: every CUDA kernel source, compiled in parallel (one nvcc each),
   and the Triton kernel's first compile.
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card at the serving path's shapes, with stated tolerances; kernel,
   plain and library-call device times and back-to-back wall times (CUDA
   events) beside the bound.
4. parity: the tiny test model (f32, both kernels on) generates the same
   greedy tokens on cuda (kernels) and cpu (plain versions), and its
   logits agree.
5. serve: a Llama-3-8B-width LM (llama_8b, bf16, random weights from a
   seed) behind the single-flight HTTP server answers POST /v1/generate
   requests; the kernels' launch counters, zeroed just before, must show
   the path went through both kernels.  Then its prefill logits are held
   against the same weights run through the plain attention and norm.

Prints the card line first, one JSON object per phase and case, then a
``{"kernels": [...]}`` line and last ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or away from the repository checkout, it exits non-zero and prints no
result.  Details go to ``chip_reports/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
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


def rms_cases(torch, F, fused_norm):
    """RMSNorm: x [N, D] with a scale [D].  Tolerance: f32 inputs 1e-5
    relative (summation order and rsqrt rounding only); 16-bit x one
    rounding step of x.dtype (the normalized row is rounded to x.dtype, and
    an rsqrt one ulp apart can round it the other way), plus one step of a
    16-bit output."""
    bf, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    cases = [("main_prefill", 509, 4096, bf, f32),
             ("main_decode", 1, 4096, bf, f32),
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
        nbytes = N * D * (x.element_size() + got.element_size()) \
            + D * s.element_size()
        b_ms, b_by = bound(4 * N * D, nbytes, PEAK_F32)
        rec = {"phase": "kernel", "kernel": "rms_norm", "case": name,
               "shape": [N, D], "x": str(xd), "scale": str(sd),
               "max_abs_err": err, "rtol": rtol,
               **timed(torch, "", lambda: fused_norm.rms_norm(x, s)),
               **timed(torch, "plain_",
                       lambda: fused_norm.rms_norm_plain(x, s)),
               **timed(torch, "library_",
                       lambda: F.rms_norm(x, (D,), w16, 1e-6)),
               "bound_ms": b_ms, "bound_by": b_by}
        emit(rec)
        REPORT["cases"].append(rec)
        out[name] = rec
    return out


def flash_cases(torch, F, flash):
    """Flash forward: q [B, H, L, D], k/v [B, Hkv, Lk, D].  Tolerance: f32
    2e-5 (summation order only, the reference's own test tolerance); bf16
    o 2e-2 absolute (the tensor-core body rounds p to bf16 before p.v and
    o itself is rounded to bf16, so o can move one bf16 step, 2^-6 at |o|
    in [2, 4)) and lse 1e-3 (f32 log-sum-exp over up to 2048 terms,
    summed in another order)."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = [("main_prefill", 1, 32, 8, 509, 509, 128, bf, True, None),
             ("main_17", 1, 32, 8, 17, 17, 128, bf, True, None),
             ("main_64", 1, 32, 8, 64, 64, 128, bf, True, None),
             ("main_128", 1, 32, 8, 128, 128, 128, bf, True, None),
             ("llama_2048", 1, 32, 8, 2048, 2048, 128, bf, True, None),
             ("window_509", 1, 32, 8, 509, 509, 128, bf, True, 256),
             ("window_2048", 1, 32, 8, 2048, 2048, 128, bf, True, 256),
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
        if causal:
            pairs = sum(min(i + 1, window or L) for i in range(L))
        else:
            pairs = L * Lk
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
               "visible_pairs": pairs}
        emit(rec)
        REPORT["cases"].append(rec)
        out[name] = rec
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
        launches = dict(common.LAUNCHES)
        code, _, _ = http(url + "/healthz")
    finally:
        httpd.shutdown()
        httpd.server_close()
        lm.close()
    if results["sampled_a"]["tokens"] != results["sampled_b"]["tokens"]:
        fail("the repeated sampled request (seed 7) gave different tokens")
    calls = sum(new for _, _, new, _ in plan)  # 1 prefill + new-1 decodes
    want = {"flash_fwd": cfg.layers * len(plan),
            "rms_norm": (2 * cfg.layers + 1) * calls}
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke runs on the "
             "card")
    sys.path.insert(0, REPO)
    try:
        from k8s_tpu_torch.models import bridge, decode, server
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
    fl = flash_cases(torch, F, flash)
    parity(torch, tlib, bridge, decode)
    launches = serve_main_path(torch, tlib, bridge, server, _common)

    kernels = []
    for kname, route, source, replaces, rec in (
            ("flash_fwd", "cuda", "k8s_tpu_torch/csrc/flash_fwd.cu",
             "k8s_tpu/ops/flash_attention.py:99", fl["main_prefill"]),
            ("rms_norm", "triton", "k8s_tpu_torch/ops/fused_norm.py",
             "k8s_tpu/ops/fused_norm.py:29", rms["main_prefill"])):
        kernels.append({"name": kname, "route": route, "source": source,
                        "replaces": replaces, "launches": launches[kname],
                        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                        "wall_ms": rec["wall_ms"],
                        "plain_ms": rec["plain_ms"],
                        "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"],
                        "library_ms": rec["library_ms"]})
    REPORT["kernels"] = kernels
    REPORT["total_s"] = time.perf_counter() - t_start
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(REPORT, f, indent=1)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
