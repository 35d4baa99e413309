#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (k8s_tpu_torch) on one card.

    python3 chip_smoke.py                       # every phase
    python3 chip_smoke.py --phases bench_serve,mnist   # these (+ needs)

Phases, each fatal on failure (``--phases`` runs the named ones and those
they need, such as ``serve_engine`` for its weights; ``--help`` lists the
names):

1. card: the card's name and power limit (nvidia-smi) and the device.
2. build: every CUDA kernel source (flash forward, flash backward,
   RMSNorm), compiled in parallel (one nvcc each), and a first RMSNorm
   launch.
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card at the serving and training paths' shapes and at the edges of
   the wgmma bodies (ragged tails, D 64 and 128, GQA groups 1 and 4, a
   window inside one tile, bidirectional Lk != L), with stated
   tolerances; kernel, plain and library-call device times and
   back-to-back wall times (CUDA events) beside the bound; each body's
   registers, spills and shared memory; dq and dk/dv bit-identical across
   two runs (dk/dv on both the split and the unsplit path); the delta the
   dq kernel writes against a torch reduction; RMSNorm at every body its
   plan picks (row, stream, scalar; strided rows), timed over rotated
   buffers larger than the L2, its host time a call beside F.rms_norm's.
   Then the head_dim cases of K2-K4: timed at Phi-3-mini's (D 96: K2's
   Dp-96 wgmma body, K3/K4's D-128 one) and Gemma-7B's (D 256 on the
   Dp-256 bodies) attention shapes at L 2048, and once each for
   correctness at D 80 (GQA 4, window 48), 96 (GQA 4, window 200, ragged
   L 1000), 256 (f16 ragged, bidirectional Lk != L), 40, 24, the generic body
   (timed at D 100 and L 2048; once at bf16 D 100 with an expanded k and
   D 320, f32 D 160), operands the tiled body reads as contiguous copies
   (an expanded k, a misaligned q, a strided head_dim) and B*H 65,544,
   held whole; each record names its plan's body and padded width, which
   the build must have compiled.
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
   flash kernel, its prefill logits are held against the single-flight
   model's, and each request's tokens against the exclusive lane's (a
   bf16 difference passes only within twice the logit error at the top-2
   margin, ``token_check``).
5c. spill, disagg: the host spill tier behind ``LmServer(slots=1,
   spill_mb=512)`` on the served Llama-3-8B-width weights (a 509-token
   prompt's 31 prefix blocks demoted by a flood of distinct prompts,
   promoted back on the next ask, the answer unchanged; demote and
   promote ms a block, TTFT cold / hit / promoted); then (on the served
   weights' first 4 of 32 layers, ``cut_depth``, as in bench_serve,
   bench_kvtier and serve_spec) two in-process
   ``LmServer``s, roles prefill and decode, over loopback kvxfer: 8
   prompts (17-509 tokens) through ``kv_dest`` one at a time (equal to
   the colocated answers) and concurrently (``token_check``), a
   fixed-seed sampled request equal to its local answer, dedup on the
   repeats, a ``kv_src`` fetch, ``serve_kv_migrate_seconds`` and each
   stage of a 509-token migration timed on its own.  Both with exact K1
   launches (2·layers+1 a model call) and no flash launch.
5d. speculative, beam: the batched speculative lane equals the exclusive
   lane and vanilla greedy on the tiny model in f32 (greedy at draft_k
   2-4, fixed-seed sampled, two draft_k groups beside a plain row); then
   on the served Llama-3-8B-width weights (4 layers), ``speculative:
   4`` over HTTP on the batched lane and on single-flight against vanilla
   greedy on the same prompts (a repeated 509- and 128-token pattern, a
   random 64), with tokens per model call, both tokens/s, exact K1
   launches (2·4+1 a model call) and K2 (4 a single-flight prefill,
   none batched); beam 1 (all 32 layers)
   equals greedy and beam 4 reports its peak memory, exact launches.
5e. (run after 5c, before 5d) the serving benches' twins
   (``k8s_tpu_torch/harness/``) on the served Llama-3-8B-width weights
   (4 layers):
   ``bench_serve`` (``run_phase`` in ``run_bench``'s order: single_flight, batched and recorder-off twice
   in turns, sampled exclusive / batched, spec exclusive / batched over
   grounded prompts; no request error, exact K1 (2·4+1 a model call) and
   K2 (4 a prefill-mode call: in the single-flight and exclusive phases
   only); tokens/s, p50/p99, recorder TTFT/TPOT, the speedups and the
   recorder ratio as readings; the lane checks exact on the tiny model in
   f32 and, at Llama width, each differing token judged by its decode
   paths' logit error: ``token_check`` for greedy, ``draws_check`` with
   the recorded noise for sampled); ``bench_kvtier`` (``max_seq_len`` cut
   to 128: spill against evict-recompute, identity through promote on an
   int8 pool, a dedup migration storm; exact demote/promote, hit rate,
   identity, dedup and K1); ``bench_serve_mp`` (``_arm(1)``: a
   one-process NCCL serving gang at the twin's width, exit 0, tp 1, its
   greedy tokens equal to an in-process ``LmServer``'s, no kernel
   launched by its plain-flag model); ``bench_disagg`` (needs no other
   phase: ``measure`` and ``judge`` with the twin's workload on three pod
   processes a topology, 1 prefill + 2 decode then 3 collapsed, each
   pinned to a third of the host's cores and drawing its own Llama-3-8B
   width weights, 4 layers, ``max_seq_len`` 128; no request error,
   migrations, collapsed convoys, every pod's weight digest equal to this
   process's draw, exact K1 (2·4+1 a pod's model call) and no K2-K4 on
   every pod, the routed greedy and sampled answers equal to the same hop
   in this process and that within ``token_check`` / ``draws_check`` of
   the twin's local oracle; the two p99 ratios beside their bounds as
   readings, blocks/s migrated, migration seconds, each pod's bring-up
   and peak memory).
6. train: ``k8s_tpu_torch.train_lm.main`` trains the gpt2-small preset at
   full width and depth (bf16, flash on, synthetic corpus) with
   checkpoints, exports a serving artifact and generates; the counters,
   zeroed just before, must equal exactly 12 launches per step of the
   flash forward and of each backward kernel (plus the generation's
   prefill); the artifact must load in the server and answer.  Then one
   gpt2-small step's gradients with the kernels are held against the same
   weights and batch through the plain attention, and a 2-layer cut of the
   Llama-3-8B widths trains 3 steps through GQA, head_dim 128 and the
   RMSNorm kernel with exact launch counts.  ``python -m
   k8s_tpu_torch.serve_lm`` runs ``--beam``, ``--chunked_prefill`` and
   ``--speculative`` on the exported artifact with exact launch counts.
6b. head_dims: the attention and MLP widths of Phi-3-mini-4k (hidden
   3072, ffn 8192, 32 layers, 32/32 heads, head_dim 96, vocab 32064) and
   Gemma-7B (hidden 3072, ffn 24576, 28 layers, 16/16 heads, head_dim
   256, vocab 256000) on the Llama-architecture Transformer, bf16,
   random weights from a seed: single-flight serving at full depth over
   HTTP (a 509-token prompt, 32 greedy tokens; K2 = layers, K1 exact;
   tokens against the plain path's by ``token_check``), then the
   ``models/train.py`` step at 2 layers (B2 L2048 and B1 L4096; K1-K4
   exact; loss and gradients against the plain-attention step by
   ``grads_at_width``'s bounds).
7. MoE, tracing, data: ``moe_parity`` (the tiny model with 4 experts,
   top-2, f32: greedy tokens, logits, 3 steps of ``make_moe_apply_fn``
   training, aux losses and per-expert kept pairs on cuda against cpu);
   ``moe_serve``, last (after the Llama-width weights are freed, and
   its profiler session after every host clock): Llama-3-8B's
   attention and vocabulary with Mixtral-8x7B's expert layout (8 experts
   of 4096 -> 14336, top-2), cut to 10 layers, behind ``LmServer(slots=4)``
   with span tracing on: 8 concurrent requests, prefix-hit repeats, a
   single-flight sampled request (K2 in its prefill), a W3C traceparent
   whose trace ``/debug/traces`` shows (serve_request, prefill under it,
   decode_step spans), the drop share at decode, step time with tracing
   at 0 and 1 in turns, a decode call's device time against its host
   wall, exact K1 (2·10+1 a model call) and K2 launches; ``moe_train``:
   the same layout cut to 2 layers trains 3 steps (B1 L2048) on batches
   ``TokenDataset`` reads from a corpus ``write_text_corpus`` wrote, exact
   K1-K4 launches; ``data``: ``train_lm.main --data_dir`` at gpt2-small, 6
   steps with checkpoints and a held-out eval every 3 through the native
   window reader (its counter covers the windows consumed), exact
   launches, then a run resumed from step 3 whose losses equal the
   uninterrupted run's.
7b. native reader and profiler hooks: ``native_reader`` writes 512M
   uint16 tokens (1 GiB, 64 shards) and reads the same 20,000 shuffled
   windows of 1024 through the native and the mmap reader in turns
   (equal bytes, windows/s and MB/s each), trains gpt2-small 6 steps on
   it through ``train_lm.main --data_dir`` on each reader (losses equal
   within 1e-4, exact K2-K4) and with ``--fused_ce on --grad_accum 2
   --remat`` (step 1 within 1e-3, exact launches, peak memory);
   ``profile_hook`` runs ``setup_observability`` / 2 gpt2-small steps /
   ``stop_observability`` in a child process under ``JAX_PROFILE_DIR``
   (and the two hooks without a counterpart), and the trace's K2-K4
   kernel events must equal the child's launch counters.
8. vision and dist_mnist: ``vision_parity`` (``resnet18_thin`` with both
   stems, ``vit_tiny_test`` with the RMSNorm kernel, ``MnistCNN``, f32:
   logits, one training step's loss and gradients, ResNet's BatchNorm
   running stats and SGD parameters, cuda against cpu); ``resnet``:
   ResNet-50 in bf16 at B128, 224x224, 1000 classes, SGD momentum, 3
   warm-up and 10 timed steps with the 7x7 stem and with the s2d stem
   (images/s, step ms, peak memory; finite, moving loss and BN stats; no
   hand-written kernel launched); ``vit``: ViT-B/16 in bf16 at B128,
   AdamW, fused norm on and off in turns on / off / off / on from the
   same weights (images/s each, peak memory, the first step's loss
   difference against the bf16 model's own rounding error, K1 exactly 25
   launches a step with fused norm on and none with it off); ``mnist``:
   ``k8s_tpu_torch.dist_mnist.main`` on the committed digit fixture with
   a held-out split and checkpoints, then a run resumed at step 100 on
   a stream reseeded with the resume step (as the reference's), whose
   losses and final weights equal a control that restores the same
   checkpoint and trains on ``array_batches(seed=100)``; K1 at the ViT
   shape [25216, 768] joins the kernel cases.  ``resnet`` and ``vit``
   build their steps with the bench cells' ``resnet_trainer`` /
   ``vit_trainer`` and time them with their ``_time_steps``.
8b. bench: ``k8s_tpu_torch/bench.py``'s five cells at their shapes with
   fewer steps (``BENCH_KW``, ``BENCH_REPEATS=2``): ResNet-50 and
   ViT-B/16 at B128, gpt2-small B8 L1024 with K2-K4 and its
   plain-attention control, greedy decode B32 128+128 with its HBM
   roofline, and the decode-depth A/Bs (one-shot and chunked prefill at
   B32 L1024, beam 4 and greedy, B128, speculative on a periodic
   prompt); the twin's line printed on a line of its own, complete,
   every MFU and HBM share in (0, 1], each cell's K2-K4 launches equal
   to ``bench_expected``, the flash and plain first losses within one
   bf16 step, and no file at the repository root written.
9. multi-process bring-up at world 1 (NCCL refuses two ranks on one
   card; worlds of 2 and 4 are held against JAX on the CPU over gloo):
   ``launcher.bootstrap.make_training_mesh`` makes a one-rank NCCL group;
   ``dist_parity`` (the tiny model, f32: 3 steps of the FSDP2 step with
   the clip active against the unsharded step, 1e-6); ``fsdp_train``
   (gpt2-small at full width and depth, B8 L1024 bf16, flash on: the
   FSDP2 step and the unsharded step in turns sharded / plain / plain /
   sharded, step time, peak memory, the largest loss difference (bound
   1e-4), exactly 12 launches of K2, K3 and K4 a step; a DCP save sync
   and async, the ms the loop is blocked, and restores that give the
   next step's loss exactly); ``gang`` (``python -m
   k8s_tpu_torch.e2e.rendezvous_worker`` and ``launcher.tpu_smoke`` under
   a one-worker operator env built here, and a worker preempted at
   step_2, resumed to the uninterrupted control's final loss exactly).
10. sequence parallelism on one card (worlds of 2 and 4 over gloo are
   CPU tests): ``sp_kernels`` drives K2-K4 inside the ring with four
   ``ThreadRing`` ranks (threads of this process, each calling the
   ring's forward and backward directly) at gpt2-small width (L 16384:
   contiguous causal, zigzag, Ulysses; bert-base's non-causal at L
   8192) and Llama-3-8B width (L 32768: contiguous, zigzag, windows
   4096, 12288 and 16384), held against the whole-sequence kernels,
   exact launches (the ring's call count), each rank's calls replayed
   alone for its device ms and the max/mean balance over ranks
   (``sp_balance``), and at L 512 against the plain ring on the CPU
   (``sp_small``); ``sp_model``: gpt2-small at L 8192 under no_grad over
   the same ranks (flash ring contiguous and zigzag, Ulysses) against
   the unsharded model, exact K2 launches.
11. pipeline and expert parallelism on one card (worlds of 2 and 4 over
   gloo are CPU tests): ``pp_train`` trains gpt2-small at full width and
   depth on four pp ``ThreadRing`` ranks, 1F1B and interleaved (v 3), M
   8, in turns with the unpipelined step from the same weights (losses,
   exact launches: K2 twice K3 for the recompute, peak memory and the
   stashed inputs, each rank's kernel device ms replayed alone);
   ``pp_llama`` at Llama-3-8B widths cut to 4 layers (B4 L2048, M 4, K2-K4
   at D128/GQA inside stages); ``ep_moe``: the 2-layer MoE cut at Llama
   width, 8 experts over four ep ranks, forward against the unsharded
   model (logits, kept pairs, exact K1 and K2), and a probe of the ep
   backward on the card.
12. tensor-parallel mesh serving (worlds of 2 over gloo are CPU tests):
   ``mesh_parity`` (the tiny model, f32, K1 on: the engine on a
   ``MeshPlacement`` at tp 2 and tp 4, ``ThreadRing`` ranks with the
   followers replaying the plan over the real plan bus, against the
   local engine on all three lanes and the CPU plain engine on greedy;
   exact K1 launches on every rank, pool shares 1/tp); ``mesh_serve``
   (after ``beam``, on ``serve_engine``'s weights: Llama-3-8B width and
   depth at tp 4, 4 slots, its prompts with 4 greedy tokens plus a
   speculative request; K1 exactly 65 launches a chief model call on
   each rank, every rank's measured pool share 0.25, tokens held against
   ``serve_engine``'s by ``token_check``, one prefill's logits through
   the mesh within a bound of the whole model's, and a fault planted in
   one rank's all-reduce caught by the same bound, the plan
   bus's counters, peak memory, decode tokens/s beside
   ``serve_engine``'s); ``mesh_nccl`` (in the world-1 block: the engine
   on a ``MeshPlacement`` over the one-rank NCCL group against the local
   engine on the train phase's gpt2-small export, K1 on; then ``python
   -m k8s_tpu_torch.models.server`` with ``K8S_TPU_SERVE_MESH=1`` in a
   process of its own under ``gang_env``, its HTTP tokens against a
   local server's, exit 0 on SIGINT).

Prints the card line first, one JSON object per phase and case, each
phase between ``{"phase": NAME, "start": true}`` and ``{"phase": NAME,
"s": wall seconds}``, then ``{"phase": "timing", "phases": {...},
"total_s": ...}`` (every phase's seconds, slowest first), a
``{"kernels": [...]}`` line and last ``{"ok": true, "device": {...}}``.
A run still going after ``WATCHDOG_S`` (1080 s, under the 1200 s it is
given) dumps every thread's stack to stderr and exits 1, so the last
``start`` line names the phase that overran.  Without a CUDA device, or
away from the repository checkout, it exits non-zero and prints no
result.  Details go to ``chip_reports/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import gc
import json
import logging
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
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
# what later phases reuse: serve_engine's prompts and tokens (mesh_serve
# holds its tp 4 tokens against them), the train phase's gpt2-small
# serving export (mesh_nccl serves it)
KEPT: dict = {}


# The serving phases after serve_engine that drive its lanes again
# (disagg, bench_serve, bench_kvtier, serve_spec), and bench_disagg's pods,
# run the first 4 of its 32 layers at full width: a depth cut that keeps
# the script well inside its time limit (16 until the whole script came
# to 860 s of the 1200; at 8 it still took 592-779 s, as the host's
# speed went).
CUT_LAYERS = 4


def cut_depth(cfg, sd: dict, layers: int = CUT_LAYERS):
    """``cfg`` and its state dict ``sd`` cut to their first ``layers``
    layers (the same tensors: nothing is copied)."""
    keep = {k: v for k, v in sd.items() if not k.startswith("layers.")
            or int(k.split(".")[1]) < layers}
    return dataclasses.replace(cfg, layers=layers), keep


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


# Cycles of the spin kernel that holds the stream while the host queues the
# timed calls (~0.1 s at the H100's ~2 GHz clock).
SPIN_CYCLES = 200_000_000

# The timing of a case checked at an edge of a body but not at a shape a
# main path runs (``QUICK_CASES``): 5 calls after one warm-up behind a
# quarter of the spin, device time only (no host wall), the plain version
# and K1's library call once, and SDPA not at all (but once at the
# head_dim cases the kernels line reports): SDPA's first call at each new
# shape takes 0.3-0.8 s of host time, most of what the flash cases cost.
# Its check against the plain version is the same as every case's.
QUICK = {"iters": 5, "warmup": 1, "walls": 0, "spin": SPIN_CYCLES // 4}
QUICK_ONCE = {**QUICK, "iters": 1}
QUICK_CASES = frozenset({
    # K1: rows, row strides and head widths no model has
    "ragged_rows", "small_f32", "ragged_d_f16", "strided_4104",
    "strided_4100", "ragged_d_99_f16", "wide_d_8195_f32",
    # K2-K4: windows, ragged tails, GQA groups, cross attention, the f32
    # and mma bodies' test shapes, the generic body
    "window_509", "window_2048", "ragged_1000_d64_g1",
    "ragged_301_d128_g4_f16", "window_48_d128_g4", "cross_d128_g4",
    "f16_d32_ragged", "bf16_cross", "f32_d16_causal", "f32_d16_window",
    "f32_d16_cross", "d100_2048_generic",
    # the head_dim bodies' edges (checked here, served at phi3_2048 and
    # gemma_2048), the padded and generic widths, and layouts that copy
    "d24_f16", "d40_bf16", "f32_d96", "d80_g4_window_48",
    "d96_g4_window_200_ragged_1000", "d256_f16_ragged_301", "d256_cross",
    "d320_bf16_generic", "f32_d160_generic", "d100_expanded_k_generic",
    "bh_65544_l16", "expanded_k_copied", "misaligned_q_copied",
    "strided_d_copied"})


def time_ms(torch, fn, iters: int = 20, warmup: int = 3, walls: int = 1,
            wall_iters: int | None = None, wall_gc_off: bool = True,
            spin: int = SPIN_CYCLES) -> dict:
    """One call's times after ``warmup`` calls, from CUDA events around
    ``iters`` calls.  ``ms`` is device time: the stream is first parked on
    a spin kernel, so the host has queued every call before the device
    starts them and the events bracket device work only.  ``wall_ms`` is
    the same from an idle stream, over ``wall_iters`` calls (the median of
    ``walls`` such runs): for small inputs that is the host's launch rate,
    not the device's time (None with ``walls`` 0).  The cyclic garbage
    collector is off while the calls are queued (for ``wall_ms``, unless
    ``wall_gc_off`` is false).  ``spin``: the spin kernel's cycles
    (``SPIN_CYCLES``, ~0.1 s, by default); queueing the calls must take
    less than half as long as it holds the stream."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def bracket(park: bool, n: int, gc_off: bool = True) -> float:
        # no cyclic garbage collection inside a bracket: a full pass over
        # the process's objects takes ~0.1 s and would land on whichever
        # call happens to trigger it (and a pass before every bracket
        # cost the kernels phase tens of seconds)
        if not gc_off:
            return queue(park, n)
        gc.disable()
        try:
            return queue(park, n)
        finally:
            gc.enable()

    def queue(park: bool, n: int) -> float:
        torch.cuda.synchronize()
        if park:
            torch.cuda._sleep(spin)
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        queued_s = time.perf_counter() - t0
        end.synchronize()
        if park and queued_s > 0.05 * spin / SPIN_CYCLES:
            fail(f"queueing {n} calls took {queued_s:.3f} s, longer "
                 "than the spin kernel holds the stream")
        return start.elapsed_time(end) / n

    wall_ms = sorted(bracket(False, wall_iters or iters, wall_gc_off)
                     for _ in range(walls))[walls // 2] if walls else None
    return {"ms": bracket(True, iters), "wall_ms": wall_ms}


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


def ptxas_report(_build, source: str, fn: str) -> dict:
    """Registers, spills and static shared memory of the kernel whose
    mangled name holds ``fn``, from nvcc's ptxas report of
    ``csrc/<source>.cu`` in ``_build.BUILD_LOGS`` (null where nvcc did not
    run in this process)."""
    import re
    rep = {"registers": None, "spill_stores": None, "spill_loads": None,
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


def build_report(_build, kernel: str, dtype, plan, split=False,
                 smem_want=None) -> dict:
    """Registers, spills and shared memory of the body ``plan`` (the
    kernel's ``_fwd_plan`` / ``_dq_plan`` / ``_dkv_plan``) names for
    ``kernel`` (flash_fwd, flash_bwd_dq or flash_bwd_dkv) at this type: the
    first from nvcc's ptxas report in ``_build.BUILD_LOGS``, the dynamic
    shared memory from the library's own size query.  The build must agree
    with the plan: the library takes its (type, padded width), reports
    ``smem_want`` bytes where that is given (the plan's tiles and stages,
    ``flash._fwd_smem``) and, where nvcc ran in this process, it compiled
    the kernel the plan names."""
    code = {"torch.float32": 0, "torch.bfloat16": 1, "torch.float16": 2}[str(dtype)]
    tok = "f" if code == 0 else _TYPE_TOKENS[str(dtype)]
    body, dp = plan.body, plan.dp
    source = kernel  # csrc/flash_fwd.cu, flash_bwd_dq.cu, flash_bwd_dkv.cu
    fn = f"{kernel}_{body}I"
    if body == "generic":
        fn += f"{tok}E"
        smem = 0
    else:
        if kernel == "flash_bwd_dkv" and body == "wgmma":
            fn += f"{tok}{'f' if split else 'S1_'}Li{dp}E"
        elif kernel != "flash_fwd" and code == 0:
            fn += f"Li{dp}E"
        else:
            fn += f"{tok}Li{dp}E"
        lib = _build.load(source)
        smem = lib.k8s_flash_fwd_smem(code, dp) if kernel == "flash_fwd" \
            else lib.k8s_flash_bwd_smem(int(kernel == "flash_bwd_dkv"), code, dp)
        if smem < 0:
            fail(f"{kernel}: the plan names {body} at Dp {dp} for {dtype}, "
                 "which the library does not build")
        if smem_want is not None and smem != smem_want:
            fail(f"{kernel}: the library launches {body} at Dp {dp} with "
                 f"{smem} bytes of shared memory, the plan's tiles need "
                 f"{smem_want}")
    rep = ptxas_report(_build, source, fn)
    if source in _build.BUILD_LOGS and rep["registers"] is None:
        fail(f"{kernel}: the plan names {fn}, which nvcc did not compile")
    return {"body": f"{kernel}:{body}", "dp": dp, "entry": fn,
            "smem_dynamic_bytes": smem, **rep}


def rms_build_report(_build, plan, x_dtype, s_dtype) -> dict:
    """The RMSNorm body ``plan`` chose (``fused_norm._rms_plan``) for these
    types: its entry, registers, spills and shared memory."""
    tok = {"torch.float32": "f", **_TYPE_TOKENS}
    # a 16-bit type named twice is mangled the second time as S1_
    s_tok = "S1_" if s_dtype == x_dtype and tok[str(x_dtype)] != "f" \
        else tok[str(s_dtype)]
    fn = f"rms_norm_{plan.body}I{tok[str(x_dtype)]}{s_tok}"
    fn += f"Li{plan.nv}E"
    return {"body": f"rms_norm:{plan.body}", "entry": fn,
            "plan": dataclasses.asdict(plan), "smem_dynamic_bytes": plan.smem,
            **ptxas_report(_build, "rms_norm", fn)}


def rms_cases(torch, F, fused_norm, _build=None):
    """RMSNorm: x [N, D] with a scale [D].  Tolerance: f32 inputs 1e-5
    relative (summation order and rsqrt rounding only); 16-bit x one
    rounding step of x.dtype (the normalized row is rounded to x.dtype, and
    an rsqrt one ulp apart can round it the other way), plus one step of a
    16-bit output.  The two ``strided`` cases are [64, 4096] views of
    [64, 4104] and [64, 4100] tensors: rows 16 and 8 bytes aligned, both
    in 8-byte accesses of x; ``ragged_d_99_f16`` (D 99) takes the scalar
    body in one pass, ``wide_d_8195_f32`` its two-pass path.
    The timed calls rotate over copies of x (strided as x is) and keep
    their outputs, twice the L2's bytes in all, so every call reads x from
    HBM and writes an output that is not in the L2; a warm-up call on each
    buffer first leaves every output allocated, so no timed call waits
    on the allocator.  ``wall_ms`` (host time a call) is the median of
    three runs of 100 calls: a run's first call after a sync takes ~0.1
    ms on its own; ``single_wall_ms`` is one run of 20 calls with the
    garbage collector on, for both K1 and the library call.  ``copy_ms``
    is a copy of x into the output's type over the same buffers: the
    bytes K1 moves less the scale's, at the rate the card reaches without
    K1.  The library call
    (``F.rms_norm``, scale cast to x.dtype) writes x.dtype: it computes
    K1's function only where the scale is x.dtype too (``bf16x_bf16s``);
    no PyTorch call writes K1's f32 output from a bf16 x.  With
    ``_build``, each record names the body ``fused_norm._rms_plan`` chose
    and that body's ptxas report."""
    bf, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    # (name, N, D, x dtype, scale dtype[, row stride])
    cases = [("main_prefill", 509, 4096, bf, f32),
             ("main_decode", 1, 4096, bf, f32),
             ("engine_decode_4", 4, 4096, bf, f32),
             ("engine_spec_16", 16, 4096, bf, f32),
             ("main_17", 17, 4096, bf, f32),
             ("main_64", 64, 4096, bf, f32),
             ("main_128", 128, 4096, bf, f32),
             ("bf16x_f32s", 2048, 4096, bf, f32),
             ("bf16x_bf16s", 2048, 4096, bf, bf),
             ("ragged_rows", 1000, 4096, bf, f32),
             ("small_f32", 7, 64, f32, f32),
             ("ragged_d_f16", 5, 100, f16, f32),
             ("strided_4104", 64, 4096, bf, f32, 4104),
             ("strided_4100", 64, 4096, bf, f32, 4100),
             ("ragged_d_99_f16", 5, 99, f16, f32),
             ("wide_d_8195_f32", 2, 8195, f32, f32),
             ("vit_b16_train", 128 * 197, 768, bf, f32)]
    g = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for name, N, D, xd, sd, *width in cases:
        W = width[0] if width else D
        x = torch.randn(N, W, generator=g, device="cuda").to(xd)[:, :D]
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
        quick = name in QUICK_CASES
        n_buf = 2 if quick else max(2, -(-2 * L2_BYTES // per_call))
        xs = torch.empty(n_buf, N, W, dtype=xd, device="cuda")[..., :D]
        xs.copy_(x.expand(n_buf, N, D))
        nbytes = per_call + D * s.element_size()
        b_ms, b_by = bound(4 * N * D, nbytes, PEAK_F32)
        # host time a call: the median of 3 runs of 100 calls
        walls = {**QUICK, "warmup": n_buf} if quick else \
            {"walls": 3, "wall_iters": 100, "warmup": n_buf}
        k1 = rotating(lambda xi: fused_norm.rms_norm(xi, s), xs, n_buf)
        lib = rotating(lambda xi: F.rms_norm(xi, (D,), w16, 1e-6), xs, n_buf)
        rec = {"phase": "kernel", "kernel": "rms_norm", "case": name,
               "shape": [N, D], "row_stride": W, "x": str(xd),
               "scale": str(sd), "max_abs_err": err, "rtol": rtol,
               "rotated_buffers": n_buf,
               **timed(torch, "", k1, **walls),
               **timed(torch, "plain_", rotating(
                   lambda xi: fused_norm.rms_norm_plain(xi, s), xs, n_buf),
                   **walls),
               **timed(torch, "library_", lib, **walls),
               "copy_ms": time_ms(torch, rotating(
                   lambda xi: torch.empty(N, D, dtype=got.dtype,
                                          device="cuda").copy_(xi),
                   xs, n_buf), **{**walls, "walls": 0})["ms"],
               "library_same_output_type": got.dtype == xd,
               "bound_ms": b_ms, "bound_by": b_by}
        for key, fn in (("single_wall_ms", k1), ("library_single_wall_ms",
                                                 lib)):
            rec[key] = None if quick else time_ms(
                torch, fn, warmup=0, wall_gc_off=False)["wall_ms"]
        rec["bound_share"] = b_ms / rec["ms"]
        rec["wall_over_library_wall"] = None if quick else \
            rec["wall_ms"] / rec["library_wall_ms"]
        if _build is not None:
            plan = fused_norm._rms_plan(N, D, xd, sd, x.data_ptr() % 16,
                                        x.stride(0), s.data_ptr() % 16)
            rec.update(rms_build_report(_build, plan, xd, sd))
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


# The head_dim cases (both directions): (name, B, H, Hkv, L, Lk, D, dtype,
# causal, window, layout).  The first three are timed: at the attention
# shapes of Phi-3-mini (D 96: the forward's Dp-96 wgmma body, the
# backward's D-128 one) and Gemma-7B (D 256 on the Dp-256 bodies; the
# FLOPs of llama_2048), and Phi-3-mini's at D 100
# (no multiple of 8: the generic body); the rest run once each for
# correctness: every body and padding the plans pick beside the 64/128
# ones, the generic body's types, head_dims and row layouts (read in
# place), the layouts the tiled bodies read as contiguous copies, and a
# B*H past grid.y's 65535.
HEAD_DIM_TIMED = ("phi3_2048", "gemma_2048", "d100_2048_generic")


def head_dim_cases(torch) -> list:
    bf, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    return [("phi3_2048", 1, 32, 32, 2048, 2048, 96, bf, True, None, None),
            ("gemma_2048", 1, 16, 16, 2048, 2048, 256, bf, True, None, None),
            ("d100_2048_generic", 1, 32, 32, 2048, 2048, 100, bf, True, None,
             None),
            ("d80_g4_window_48", 1, 8, 2, 509, 509, 80, bf, True, 48, None),
            ("d96_g4_window_200_ragged_1000", 2, 8, 2, 1000, 1000, 96, bf,
             True, 200, None),
            ("d256_f16_ragged_301", 2, 8, 2, 301, 301, 256, f16, True, None,
             None),
            ("d256_cross", 1, 8, 2, 301, 1000, 256, bf, False, None, None),
            ("d40_bf16", 2, 4, 4, 300, 300, 40, bf, True, None, None),
            ("d24_f16", 2, 8, 2, 301, 301, 24, f16, True, None, None),
            ("d100_expanded_k_generic", 1, 8, 2, 257, 257, 100, bf, True,
             None, "expand_k"),
            ("d320_bf16_generic", 1, 8, 2, 257, 257, 320, bf, True, None,
             None),
            ("f32_d96", 1, 4, 2, 130, 130, 96, f32, True, None, None),
            ("f32_d160_generic", 1, 4, 2, 130, 130, 160, f32, True, 16,
             None),
            ("expanded_k_copied", 1, 8, 2, 257, 257, 64, bf, True, None,
             "expand_k_heads"),
            ("misaligned_q_copied", 1, 8, 2, 257, 257, 64, bf, True, None,
             "misaligned_q"),
            ("strided_d_copied", 1, 8, 2, 257, 257, 64, bf, True, None,
             "strided_d"),
            ("bh_65544_l16", 2, 32772, 32772, 16, 16, 64, bf, True, None,
             None)]


def flash_operands(torch, g, B, H, Hkv, L, Lk, D, dt, layout, do=False):
    """q, k, v (and do) for a case, in ``layout``: None (contiguous), an
    expanded k (stride-0 rows; or stride-0 heads, every kv head one head's
    keys: with the same key in every row, dq is 0 and only the kernels'
    rounding is left of it), a q view 2 bytes past a 16-byte boundary,
    or a q whose head_dim has stride 2."""
    def rand(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dt)
    q, k, v = rand(B, H, L, D), rand(B, Hkv, Lk, D), rand(B, Hkv, Lk, D)
    if layout == "expand_k":
        k = k[:, :, :1].expand(B, Hkv, Lk, D)
    elif layout == "expand_k_heads":
        k = k[:, :1].expand(B, Hkv, Lk, D)
    elif layout == "misaligned_q":
        q = rand(B * H * L * D + 1)[1:].view(B, H, L, D)
    elif layout == "strided_d":
        q = rand(B, H, L, 2 * D)[..., ::2]
    return (q, k, v, rand(B, H, L, D)) if do else (q, k, v)


def flash_cases(torch, F, flash, _build):
    """Flash forward: q [B, H, L, D], k/v [B, Hkv, Lk, D].  Tolerance: f32
    2e-5 (summation order only, the reference's own test tolerance); bf16
    o 2e-2 absolute (the tensor-core body rounds p to bf16 before p.v and
    o itself is rounded to bf16, so o can move one bf16 step, 2^-6 at |o|
    in [2, 4)) and lse 1e-3 (f32 log-sum-exp over up to 2048 terms,
    summed in another order).  Beside the main-path shapes, the edges of
    the 128-row wgmma body: ragged tails (L 1000, 301), D 64 and 128, GQA
    groups 1 and 4, a window smaller than one tile, bidirectional with
    Lk != L; then the head_dim cases (``head_dim_cases``), each naming the
    body and padded width its ``_fwd_plan`` chose."""
    bf, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    cases = [("gpt2_train", 8, 12, 12, 1024, 1024, 64, bf, True, None),
             ("main_prefill", 1, 32, 8, 509, 509, 128, bf, True, None),
             ("main_17", 1, 32, 8, 17, 17, 128, bf, True, None),
             ("main_64", 1, 32, 8, 64, 64, 128, bf, True, None),
             ("main_128", 1, 32, 8, 128, 128, 128, bf, True, None),
             ("gpt2_serve_32", 1, 12, 12, 32, 32, 64, bf, True, None),
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
    once = {c[0] for c in head_dim_cases(torch)} - set(HEAD_DIM_TIMED)
    cases = [(*c, None) for c in cases] + head_dim_cases(torch)
    g = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for name, B, H, Hkv, L, Lk, D, dt, causal, window, layout in cases:
        t_case = time.perf_counter()
        q, k, v = flash_operands(torch, g, B, H, Hkv, L, Lk, D, dt, layout)
        timed_case = name in HEAD_DIM_TIMED or name not in once
        scale = D ** -0.5
        plan = flash._fwd_plan(B, H, L, D, dt)
        o, lse = flash.flash_fwd(q, k, v, scale, causal, window)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash.flash_fwd_plain(q, k, v, scale, causal, window)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_l = (lse - lse_ref).abs().max().item()
        del o_ref, lse_ref
        tol_o, tol_l = (2e-5, 2e-5) if dt == f32 else (2e-2, 1e-3)
        if not (err_o <= tol_o and err_l <= tol_l) or o.dtype != dt \
                or not bool(torch.isfinite(o).all()):
            fail(f"flash {name}: o err {err_o} (tol {tol_o}), lse err "
                 f"{err_l} (tol {tol_l})")
        pairs = visible_pairs(L, Lk, causal, window)
        esz = q.element_size()
        nbytes = esz * (2 * B * H * L * D + 2 * B * Hkv * Lk * D) \
            + 4 * B * H * L
        b_ms, b_by = bound(4 * B * H * D * pairs, nbytes,
                           PEAK_16BIT if esz == 2 else PEAK_F32)
        rec = {"phase": "kernel", "kernel": "flash_fwd", "case": name,
               "B": B, "H": H, "Hkv": Hkv, "L": L, "Lk": Lk, "D": D,
               "dtype": str(dt), "causal": causal, "window": window,
               "layout": layout, "plan": dataclasses.asdict(plan),
               "max_abs_err": err_o, "lse_max_abs_err": err_l,
               "tol_o": tol_o, "tol_lse": tol_l,
               "bound_ms": b_ms, "bound_by": b_by,
               "visible_pairs": pairs,
               **build_report(_build, "flash_fwd", dt, plan,
                              smem_want=flash._fwd_smem(plan)
                              if plan.body == "wgmma" else None)}
        if timed_case:
            quick = name in QUICK_CASES
            mask = None
            if window is not None:
                qp = torch.arange(L, device="cuda")[:, None]
                kp = torch.arange(Lk, device="cuda")[None, :]
                mask = (kp <= qp) & (qp - kp < window)

            def library():
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask,
                    is_causal=causal and mask is None, enable_gqa=Hkv != H)

            rec.update(
                **timed(torch, "", lambda: flash.flash_fwd(
                    q, k, v, scale, causal, window),
                    **(QUICK if quick else {})),
                **timed(torch, "plain_", lambda: flash.flash_fwd_plain(
                    q, k, v, scale, causal, window),
                    **(QUICK_ONCE if quick else {"iters": 5})),
                **(timed(torch, "library_", library,
                         **(QUICK_ONCE if quick else {}))
                   if not quick or name in HEAD_DIM_TIMED
                   else {"library_ms": None, "library_wall_ms": None}))
            rec["bound_share"] = b_ms / rec["ms"]
        rec["case_s"] = time.perf_counter() - t_case
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
    different sides, and each record names its side; each record names
    its plan's body and padded width, which the build must have.  The
    delta the dq kernel writes (f32 ``rowsum(do * o)``) must match
    ``(do.float() * o.float()).sum(-1)`` within 1e-5 of the row's
    ``sum(|do * o|)``: the two sum the same f32 products in different
    orders.  The head_dim cases (``head_dim_cases``) follow the main-path
    ones; only phi3_2048 and gemma_2048 among them are timed."""
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
    once = {c[0] for c in head_dim_cases(torch)} - set(HEAD_DIM_TIMED)
    cases = [(*c, None) for c in cases] + head_dim_cases(torch)
    g = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for name, B, H, Hkv, L, Lk, D, dt, causal, window, layout in cases:
        t_case = time.perf_counter()
        q, k, v, do = flash_operands(torch, g, B, H, Hkv, L, Lk, D, dt,
                                     layout, do=True)
        scale = D ** -0.5
        args = (scale, causal, window)
        o, lse = flash.flash_fwd(q, k, v, *args)
        got = flash.flash_bwd(q, k, v, o, lse, do, *args)
        torch.cuda.synchronize()
        ref = flash.flash_bwd_plain(q, k, v, o, lse, do, *args)
        tol = 1e-4 if dt == f32 else 2e-2
        errs = {}
        for gname, a, r in zip(("dq", "dk", "dv"), got, ref):
            if not bool(torch.isfinite(a).all()):
                fail(f"flash_bwd {name} {gname}: not finite")
            if a.dtype != dt or a.shape != r.shape:
                fail(f"flash_bwd {name} {gname}: {a.dtype}{tuple(a.shape)} "
                     f"vs {r.dtype}{tuple(r.shape)}")
            err = (a.float() - r.float()).abs().max().item()
            top = r.float().abs().max().item()
            if not err <= tol * top:
                fail(f"flash_bwd {name} {gname}: max abs err {err} beyond "
                     f"{tol} x max |grad| {top}")
            errs[gname] = {"max_abs_err": err, "max_abs": top}
        del ref
        again = flash.flash_bwd(q, k, v, o, lse, do, *args)
        torch.cuda.synchronize()
        if not torch.equal(got[0], again[0]):
            fail(f"flash_bwd {name}: dq differs between two runs on the same "
                 "inputs")
        if not all(torch.equal(a, b) for a, b in zip(got[1:], again[1:])):
            fail(f"flash_bwd {name}: dk/dv differ between two runs on the "
                 "same inputs")
        del got, again

        # each kernel alone, on the operands flash_bwd hands it (read in
        # place or copied by its body's rule; the dk/dv kernel with its
        # plan's partial sums), then the whole backward
        dq_plan = flash._dq_plan(B, H, L, D, dt)
        plan = flash._dkv_plan(B, H, Hkv, L, Lk, D, causal, window, dt)
        path = "split" if plan.nsplit > 1 else "unsplit"
        q_k, k_k, v_k = flash._readable(
            dq_plan.body, flash._check_launch(q, k, v, o, do), q, k, v)
        do_k, o_k, lse_k, delta = flash._bwd_operands(q_k, o, lse, do)
        dq, dk, dv = (torch.empty_like(t) for t in (q_k, k_k, v_k))
        flash._launch_bwd("bwd_dq", dq_plan, q_k, k_k, v_k, do_k, lse_k,
                          delta, (dq,), *args, o=o_k)
        prod = do.float() * o.float()
        delta_err = ((delta - prod.sum(-1)).abs()
                     / prod.abs().sum(-1).clamp_min(1e-30)).max().item()
        if not delta_err <= 1e-5:
            fail(f"flash_bwd {name}: the dq kernel's delta is {delta_err} of "
                 "sum(|do * o|) off the f32 torch reduction (tol 1e-5)")
        del prod
        pairs = visible_pairs(L, Lk, causal, window)
        esz = q.element_size()
        q_bytes, kv_bytes = esz * B * H * L * D, esz * B * Hkv * Lk * D
        row_bytes = 2 * 4 * B * H * L  # lse and delta
        peak = PEAK_16BIT if esz == 2 else PEAK_F32
        timing = {}
        if name in HEAD_DIM_TIMED or name not in once:
            quick = name in QUICK_CASES
            kw, once_kw = (QUICK, QUICK_ONCE) if quick else ({}, {})
            t_dq = time_ms(torch, lambda: flash._launch_bwd(
                "bwd_dq", dq_plan, q_k, k_k, v_k, do_k, lse_k, delta, (dq,),
                *args, o=o_k), **kw)
            t_dkv = time_ms(torch, lambda: flash._launch_dkv(
                q_k, k_k, v_k, do_k, lse_k, delta, dk, dv, *args), **kw)
            t_pair = time_ms(torch, lambda: flash.flash_bwd(
                q, k, v, o, lse, do, *args), **kw)
            t_plain = time_ms(torch, lambda: flash.flash_bwd_plain(
                q, k, v, o, lse, do, *args), **(once_kw or {"iters": 3}))
            # the library's backward alone: SDPA forward + backward minus
            # SDPA forward, timed the same way
            mask = None
            if window is not None:
                qp = torch.arange(L, device="cuda")[:, None]
                kp = torch.arange(Lk, device="cuda")[None, :]
                mask = (kp <= qp) & (qp - kp < window)
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(
                    qg, kg, vg, attn_mask=mask,
                    is_causal=causal and mask is None, enable_gqa=Hkv != H)

            def sdpa_fwd_bwd():
                torch.autograd.grad(sdpa(), (qg, kg, vg), do)

            library_ms = None
            if not quick or name in HEAD_DIM_TIMED:
                lib_f, lib_fb = (time_ms(torch, sdpa, **once_kw),
                                 time_ms(torch, sdpa_fwd_bwd, **once_kw))
                library_ms = lib_fb["ms"] - lib_f["ms"]
            shared = {"plain_ms": t_plain["ms"],
                      "plain_wall_ms": t_plain["wall_ms"],
                      "plain_is": "flash_bwd_plain (dq, dk and dv together)",
                      "library_ms": library_ms,
                      "library_is": "SDPA forward+backward minus SDPA "
                                    "forward",
                      "bwd_pair_ms": t_pair["ms"],
                      "bwd_pair_is": "flash_bwd: K3 (with delta) and K4 "
                                     "together"}
            timing = {"flash_bwd_dq": {"ms": t_dq["ms"],
                                       "wall_ms": t_dq["wall_ms"], **shared},
                      "flash_bwd_dkv": {"ms": t_dkv["ms"],
                                        "wall_ms": t_dkv["wall_ms"],
                                        **shared}}
        for kname, flops_per, nbytes, extra in (
                ("flash_bwd_dq", 6, 4 * q_bytes + 2 * kv_bytes + row_bytes,
                 {**build_report(_build, "flash_bwd_dq", dt, dq_plan),
                  "plan": dataclasses.asdict(dq_plan),
                  "blocks": dq_plan.blocks, "delta_rel_err": delta_err,
                  "deterministic": True}),
                ("flash_bwd_dkv", 8, 2 * q_bytes + 4 * kv_bytes + row_bytes,
                 {**build_report(_build, "flash_bwd_dkv", dt, plan,
                                 split=plan.nsplit > 1),
                  "plan": dataclasses.asdict(plan),
                  "dkv_path": path, "nsplit": plan.nsplit,
                  "blocks": plan.blocks, "deterministic": True})):
            b_ms, b_by = bound(flops_per * B * H * D * pairs, nbytes, peak)
            rec = {"phase": "kernel", "kernel": kname, "case": name,
                   "B": B, "H": H, "Hkv": Hkv, "L": L, "Lk": Lk, "D": D,
                   "dtype": str(dt), "causal": causal, "window": window,
                   "layout": layout,
                   "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
                   "errors": errs, "tol_share_of_max": tol,
                   **timing.get(kname, {}),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "visible_pairs": pairs, **extra}
            if "ms" in rec:
                rec["bound_share"] = b_ms / rec["ms"]
            rec["case_s"] = time.perf_counter() - t_case  # both kernels
            emit(rec)
            REPORT["cases"].append(rec)
            out[(kname, name)] = rec
        del q, k, v, do, o, lse, q_k, k_k, v_k, do_k, o_k, dq, dk, dv
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


def http(url: str, payload=None, timeout: float = 600.0,
         headers: dict | None = None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data,
        headers={"Content-Type": "application/json", **(headers or {})},
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


class ModelCalls:
    """Counts ``Transformer.forward`` calls by mode while active (every
    instance, every thread): the model calls a path's launch counts are
    held against."""

    def __init__(self, tlib):
        self.tlib = tlib
        self.by_mode = {"prefill": 0, "decode": 0, "train": 0}

    def __enter__(self):
        orig = self.orig = self.tlib.Transformer.forward
        counts = self.by_mode

        def forward(model, *args, **kwargs):
            mode = kwargs.get("mode", args[2] if len(args) > 2 else "train")
            counts[mode] += 1
            return orig(model, *args, **kwargs)
        self.tlib.Transformer.forward = forward
        return self

    def __exit__(self, *exc):
        self.tlib.Transformer.forward = self.orig

    @property
    def total(self) -> int:
        return sum(self.by_mode.values())


def spec_parity(torch, tlib, bridge, decode, engine_lib):
    """The engine's batched speculative lane against the port's exclusive
    lane (``make_speculative_generate_fn`` on the engine's model) on the
    card, on the tiny test model in f32 with both kernels on: greedy
    batched spec equals exclusive spec equals vanilla greedy at draft_k
    2, 3 and 4 on a random and a repetitive prompt; a fixed-seed sampled
    spec request gives the same tokens on both lanes; spec slots of two
    draft_k groups beside a plain greedy row, from threads, each equal
    their oracle; refcounts stay exact."""
    import threading

    cfg = dataclasses.replace(tlib.tiny_test(), use_flash_attention=True,
                              use_fused_norm=True)
    params = bridge.init_params(cfg, seed=15, device="cpu")
    rng = torch.Generator().manual_seed(16)
    rand = torch.randint(0, cfg.vocab_size, (11,), generator=rng).tolist()
    rep = (torch.randint(0, cfg.vocab_size, (5,), generator=rng).tolist()
           * 6)[:27]
    eng = engine_lib.Engine(cfg, params, slots=2, queue_limit=32,
                            device="cuda")

    def exclusive(p, n, k=0, temperature=0.0, top_k=None, seed=0):
        if k:
            fn = decode.cached_speculative_fn(
                cfg, n, draft_k=k, temperature=temperature, top_k=top_k)
        else:
            fn = decode._cached_generate_fn(cfg, n, temperature, top_k,
                                            None, 0)

        def run():
            gen = torch.Generator(device="cuda").manual_seed(seed)
            return fn(eng.model, torch.tensor([p], device="cuda"),
                      gen)[0].tolist()
        return eng.submit_exclusive(run, timeout=300)

    rec = {"phase": "spec_parity", "config": "tiny_test f32 flash+fused",
           "slots": 2, "cases": {}}

    def check(name, got, *wants):
        if any(got != w for w in wants):
            fail(f"spec_parity {name}: batched {got}, exclusive/vanilla "
                 f"{list(wants)}")
        rec["cases"][name] = len(got)

    try:
        for label, p in (("random", rand), ("repetitive", rep)):
            greedy = exclusive(p, 16)
            for k in (2, 3, 4):
                check(f"{label}_k{k}",
                      eng.submit(p, 16, speculative=k, timeout=300),
                      exclusive(p, 16, k), greedy)
        sampled = dict(temperature=0.9, top_k=20, seed=5)
        check("sampled_k4", eng.submit(rand, 12, speculative=4, timeout=300,
                                       **sampled),
              exclusive(rand, 12, 4, **sampled))
        got = {}
        plan = {"mixed_k4": (rep, 4), "mixed_k2": (rand, 2),
                "mixed_plain": (rand[:7], 0)}
        threads = [threading.Thread(target=lambda n=n, p=p, k=k: got.__setitem__(
            n, eng.submit(p, 12, speculative=k, timeout=300)))
            for n, (p, k) in plan.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        for n, (p, k) in plan.items():
            check(n, got.get(n), exclusive(p, 12, k))
        eng.debug_check_blocks()
        st = eng.stats()
        rec.update({k: st[k] for k in ("spec_steps", "spec_proposed",
                                       "spec_accepted",
                                       "spec_mean_accepted")})
    finally:
        eng.shutdown()
    emit(rec)
    REPORT["spec_parity"] = rec


def path_logits(torch, model, ctx, buckets) -> dict:
    """Last-position f32 logits of ``ctx`` through each decode path the
    served lanes use: one prefill (flash), a prefill then one 1-token
    decode step, a prefill then one 4-token chunk (a verify call), and the
    engine's bucket chunks through a private paged pool."""
    from k8s_tpu_torch.models.decode import split_prefill
    from k8s_tpu_torch.models.placement import PagedCompute

    t = torch.tensor([ctx], device="cuda")
    n = len(ctx)
    out = {}
    with torch.inference_mode():
        out["prefill"] = model(t, mode="prefill",
                               cache=model.new_cache())[0, -1]
        for w in (1, 4):
            cache = model.new_cache()
            model(t[:, :-w], mode="prefill", cache=cache)
            pos = torch.arange(n - w, n, device="cuda")[None]
            out[f"decode_{w}"] = model(t[:, -w:], positions=pos,
                                       mode="decode", cache=cache)[0, -1]
        comp, bs = PagedCompute(model), 16
        nb = -(-n // bs)
        pool = comp.build_pool(1 + nb, bs, "cuda")
        table = torch.arange(1, 1 + nb, device="cuda")
        off = 0
        for c in split_prefill(n, buckets):
            last = comp.prefill_paged(
                pool, table[:-(-(off + c) // bs)], t[:, off:off + c],
                torch.arange(off, off + c, device="cuda")[None])
            off += c
        out["paged"] = last[0]
    return out


def token_check(torch, model, prompt, got, want, what, buckets) -> dict:
    """``got`` against ``want`` for one request (same weights, two lanes
    or two programs).  In bf16 the lanes round differently, so a token
    may differ where a step's top-2 margin lies within the logit error:
    at the first mismatch, the margin of the logits over the agreed
    context (one prefill) is held against the largest logit difference
    between the decode paths over that same context (``path_logits``).
    A flip moves two logits apart by the margin, which an error e on each
    does up to 2e: fail only where the margin exceeds that."""
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if i is None:
        if len(got) != len(want):
            fail(f"{what}: {len(got)} tokens against {len(want)}")
        return {"equal": True}
    logits = path_logits(torch, model, list(prompt) + list(want[:i]),
                         buckets)
    ref = logits["prefill"]
    top2 = torch.topk(ref, 2).values.tolist()
    margin = top2[0] - top2[1]
    err = max((x - ref).abs().max().item() for k, x in logits.items()
              if k != "prefill")
    rec = {"equal": False, "first_mismatch": i,
           "tokens": [got[i], want[i]], "top2_margin": margin,
           "logit_err": err, "within_error": margin <= 2 * err}
    if not rec["within_error"]:
        fail(f"{what}: token {i} differs ({got[i]} vs {want[i]}) with a "
             f"top-2 margin {margin} beyond twice the logit error {err}")
    return rec


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
    prefill goes through the paged attention, as in the reference.  Each
    request's 32 tokens are then held against the exclusive lane's (the
    single-flight program on the same model) by ``token_check``.
    Returns the launches and the served weights (a state dict), which the
    speculative and beam phases reuse."""
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
        # the exclusive lane's tokens for each distinct prompt
        excl = {}
        for n in prompts:
            parsed = server.parse_request(
                cfg, {"tokens": prompts[n], "max_new_tokens": 32}, 32)
            excl[n] = eng.submit_exclusive(
                lambda parsed=parsed: lm._generate_exclusive(
                    parsed).tolist(), timeout=600)
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
    vs_exclusive = {str(i): token_check(
        torch, lm.model, prompts[n], results[i][0], excl[n],
        f"serve_engine request {i} ({n} tokens) vs the exclusive lane",
        eng.buckets) for i, n in enumerate(batch)}
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
           "tokens_vs_exclusive_lane": vs_exclusive,
           "tokens_equal_exclusive_lane": sum(
               r["equal"] for r in vs_exclusive.values()),
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2 ** 30,
           "model_calls": calls, "launches": launches,
           "expected_launches": want,
           "engine_rollup": ledger.get("rollup"),
           "stats": {k: v for k, v in st3.items()
                     if k != "occupancy_timeline"}}
    emit(rec)
    REPORT["serve_engine"] = rec
    KEPT["serve_engine"] = {
        "prompts": prompts, "buckets": eng.buckets,
        "tokens": {n: results[i][0] for i, n in enumerate(batch)}}
    requestlog.set_active(None)
    os.environ.pop("K8S_TPU_REQUEST_LOG", None)
    return launches, lm.model.state_dict()


def _last_request(eng) -> dict:
    """The engine recorder's most recently finished request."""
    return eng._reqlog.snapshot(limit=1)[-1]


SPILL_PREFIX_BLOCKS = 64   # tree headroom beyond the one slot's row
SPILL_MB = 512             # host budget: 256 blocks of 2 MiB
FLOOD_LEN = 1024           # distinct flood prompts: 63 tree blocks each


def serve_spill(torch, tlib, server, common, requestlog, sd):
    """The host spill tier at the served width, on the served weights
    (``sd``): ``LmServer(slots=1, prefix_blocks=64, spill_mb=512)`` over
    HTTP, bf16 pool (2 MiB a block, stored raw).  Prompt P (a 496-token
    shared prefix + a 13-token tail) cold, then prompt A (the same prefix
    + another 13-token tail): a plain prefix hit.  Distinct 1024-token
    prompts then flood the pool until A's 31 prefix blocks have all been
    demoted to the host, and A is asked again: its prefix promotes back
    (31 blocks), and its tokens must equal A's first answer exactly (the
    bytes grafted back are the bytes demoted, and the tail's prefill is
    the same).  Demote and promote are timed a block with a synchronize
    around each call (a promote's time without the demotions its own
    block allocations cause, which are reported apart); TTFT cold /
    plain hit / promoted from the request recorder.  The counters, zeroed just before and read just after,
    must show RMSNorm at 2·32+1 launches a model call and no flash
    kernel."""
    cfg = dataclasses.replace(tlib.llama_8b(), use_flash_attention=True,
                              use_fused_norm=True, dtype=torch.bfloat16)
    os.environ["K8S_TPU_REQUEST_LOG"] = "1"
    requestlog.set_active(None)
    torch.cuda.reset_peak_memory_stats()
    lm = server.LmServer(config=cfg, params=sd, slots=1,
                         prefix_blocks=SPILL_PREFIX_BLOCKS,
                         spill_mb=SPILL_MB, device="cuda")
    eng = lm.engine
    demotes, promotes = [], []
    demote_leaf, promote_spill = eng._demote_leaf, eng._promote_spill

    def demote(node):
        before = eng._spill.spilled_blocks
        t0 = time.perf_counter()
        out = demote_leaf(node)
        torch.cuda.synchronize()
        if eng._spill.spilled_blocks > before:  # gathered, not touched
            demotes.append(time.perf_counter() - t0)
        return out

    def promote(slot, ids, max_tokens):
        # the demotions its own block allocations cause are timed apart
        n0, t0 = len(demotes), time.perf_counter()
        n = promote_spill(slot, ids, max_tokens)
        torch.cuda.synchronize()
        if n:
            nested = sum(demotes[n0:])
            promotes.append((time.perf_counter() - t0 - nested, n,
                             len(demotes) - n0, nested))
        return n
    eng._demote_leaf, eng._promote_spill = demote, promote
    httpd = server.serve(lm, "127.0.0.1", 0)
    url = "http://%s:%d" % httpd.server_address[:2]
    rng = torch.Generator().manual_seed(8)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()

    def post(p, new):
        code, body, secs = http(url + "/v1/generate", dict(
            tokens=p, max_new_tokens=new))
        toks = body.get("tokens")
        if code != 200 or not isinstance(toks, list) or len(toks) != new \
                or not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"spill request ({len(p)} tokens): {code} "
                 f"{str(body)[:300]}")
        return toks, secs

    shared = prompt(496)
    P, A = shared + prompt(13), shared + prompt(13)
    fps = kvtier_fps(eng, A)
    try:
        post(prompt(33), 2)  # warm-up: allocator, cuBLAS handles
        st0 = eng.stats()
        common.reset_launches()
        t_phase = time.perf_counter()
        post(P, 32)
        ttft_cold = _last_request(eng)["ttft_s"]
        first, _ = post(A, 32)
        hit = _last_request(eng)
        floods, t_flood = 0, time.perf_counter()
        while not all(fp in eng._spill for fp in fps) and floods < 40:
            post(prompt(FLOOD_LEN), 1)
            floods += 1
        flood_s = time.perf_counter() - t_flood
        demoted = all(fp in eng._spill for fp in fps)
        st1 = eng.stats()
        again, _ = post(A, 32)
        promoted = _last_request(eng)
        torch.cuda.synchronize()
        phase_s = time.perf_counter() - t_phase
        launches = common.launches()
        st2 = eng.stats()
        eng.debug_check_blocks()
        peak = torch.cuda.max_memory_allocated()
    finally:
        httpd.shutdown()
        httpd.server_close()
        lm.close()
        requestlog.set_active(None)
        os.environ.pop("K8S_TPU_REQUEST_LOG", None)
    calls = st2["model_calls"] - st0["model_calls"]
    want = {"flash_fwd": 0, "rms_norm": (2 * cfg.layers + 1) * calls,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    if launches != want:
        fail(f"spill launches {launches}, expected {want} ({calls} calls)")
    if not demoted or st1["spill_demotions"] < len(fps):
        fail(f"spill: A's chain was not demoted after {floods} floods "
             f"({st1['spill_demotions']} demotions)")
    promos = st2["spill_promotions"] - st1["spill_promotions"]
    if promos != len(fps) or promoted["prefix"]["tokens_saved"] < 496:
        fail(f"spill: {promos} promotions (want {len(fps)}), prefix "
             f"{promoted['prefix']}")
    if again != first:
        fail(f"spill: the promoted answer {again} differs from the first "
             f"{first}")
    block_bytes = 2 * cfg.layers * 16 * cfg.kv_heads * \
        cfg.dims_per_head * 2
    promote_s = sum(p[0] for p in promotes)
    promote_n = sum(p[1] for p in promotes)
    rec = {"phase": "spill", "card": REPORT["card"],
           "config": f"llama_8b bf16 flash+fused, LmServer(slots=1, "
                     f"prefix_blocks={SPILL_PREFIX_BLOCKS}, "
                     f"spill_mb={SPILL_MB})",
           "layers": cfg.layers, "pool_blocks": st2["pool_blocks"],
           "block_bytes": block_bytes, "flood_prompts": floods,
           "flood_len": FLOOD_LEN, "flood_s": flood_s, "phase_s": phase_s,
           "spill_demotions": st2["spill_demotions"],
           "spill_promotions": st2["spill_promotions"],
           "spill_evictions": st2["spill_evictions"],
           "spill_blocks": st2["spill_blocks"],
           "spill_bytes": st2["spill_bytes"],
           "tree_evictions": st2["tree_evictions"],
           "demote_ms_per_block": 1e3 * sum(demotes) / max(len(demotes), 1),
           "demote_ms_max": 1e3 * max(demotes, default=0.0),
           "demotes_timed": len(demotes),
           "promote_ms_per_block": 1e3 * promote_s / max(promote_n, 1),
           "promote_calls": len(promotes), "promoted_blocks": promote_n,
           "demotes_inside_promote": sum(p[2] for p in promotes),
           "demote_s_inside_promote": sum(p[3] for p in promotes),
           "ttft_s": {"cold_509": ttft_cold, "prefix_hit_509": hit["ttft_s"],
                      "promoted_509": promoted["ttft_s"]},
           "promoted_prefix": promoted["prefix"],
           "promoted_phase_s": promoted["phase_s"],
           "answer_identical": True,
           "max_memory_allocated_gib": peak / 2 ** 30,
           "model_calls": calls, "launches": launches,
           "expected_launches": want}
    emit(rec)
    REPORT["spill"] = rec
    return launches


def kvtier_fps(eng, ids):
    """The chain fingerprints of ``ids``' full blocks but the last prompt
    token's (the blocks a prompt can share)."""
    from k8s_tpu_torch.models import kvtier

    bs = eng.block_size
    return kvtier.chain_fingerprints(ids, bs, max_blocks=(len(ids) - 1) // bs)


DISAGG_LENS = (17, 33, 64, 100, 128, 256, 400, 509)


def migration_stages(torch, kvxfer, placement, eng, ids, reps=3):
    """The wall time of each stage of one migration of ``ids``' chain (the
    engine holds it in its tree), on the same functions the servers run:
    the gather and its device-to-host copy (on the engine thread),
    ``encode_frame`` (``tobytes`` and the join), the frame over loopback
    TCP into ``read_frame`` (``frombuffer``), and the host-to-device copy
    and graft into a scratch pool.  Best of ``reps``."""
    import socket
    import threading

    import numpy as np

    bs = eng.block_size
    nodes = eng._tree.match(ids, len(ids) - 1)[0]
    blocks = [n.block for n in nodes] + [0]  # + the partial block's size
    out = {"blocks": len(blocks)}

    def gather():
        t0 = time.perf_counter()
        flat = eng._gather_fn(eng._pool, blocks)
        return flat, time.perf_counter() - t0
    best = {}
    for _ in range(reps):
        flat, g = eng.submit_exclusive(gather, timeout=600)
        wire = {f"blk/{p}": a for p, a in flat.items()}
        wire["ids"] = np.asarray(ids, np.int32)
        wire["key"] = np.zeros(16, np.uint8)
        t0 = time.perf_counter()
        frame = kvxfer.encode_frame("migrate", {"v": 1}, wire)
        enc = time.perf_counter() - t0
        lst = socket.create_server(("127.0.0.1", 0))
        got = {}

        def rx():
            conn, _ = lst.accept()
            got["frame"] = kvxfer.read_frame(conn)
            got["t"] = time.perf_counter()
            conn.close()
        th = threading.Thread(target=rx)
        th.start()
        snd = socket.create_connection(lst.getsockname())
        t0 = time.perf_counter()
        snd.sendall(frame)
        th.join(120)
        loop = got["t"] - t0
        snd.close()
        lst.close()
        arrays = {k[4:]: v for k, v in got["frame"][2].items()
                  if k.startswith("blk/")}
        with torch.inference_mode():
            pool = eng._compute.build_pool(len(blocks) + 1, bs, "cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng._compute.graft_blocks(pool, arrays,
                                      list(range(1, len(blocks) + 1)))
            torch.cuda.synchronize()
            graft = time.perf_counter() - t0
            same = all(torch.equal(
                placement.host_tensor(flat[p]).cuda(),
                leaf[1:]) for p, leaf in
                eng._compute.pool_leaves(pool))
        del pool
        if not same:
            fail("migration stages: the grafted blocks differ from the "
                 "gathered ones")
        for k, v in (("gather_d2h_s", g), ("encode_s", enc),
                     ("loopback_read_s", loop), ("h2d_graft_s", graft)):
            best[k] = min(best.get(k, v), v)
        out["frame_bytes"] = len(frame)
    out.update(best)
    out["total_s"] = sum(best.values())
    return out


def serve_disagg(torch, tlib, server, common, requestlog, sd, trace):
    """Disaggregated serving at the served width, on the served weights:
    two ``LmServer(slots=4)`` in this process, ``role="prefill"`` and
    ``role="decode"``, each with its own engine and pool (weights shared
    from ``sd``), over HTTP and loopback kvxfer.  Eight prompts (17-509
    tokens) are prefilled once on the prefill server (1 token: its tree
    now holds them) and answered there locally (32 tokens, the colocated
    answers); then each goes through ``kv_dest`` one at a time (its tokens
    must equal the colocated answer: the same prefill, the bytes of its
    blocks, the same decode) and all eight concurrently (held by
    ``token_check``: batched decode rounds otherwise in bf16, and these
    repeats are deduplicated on the wire).  A fixed-seed sampled request
    (temperature 1.0) must equal its local answer.  Last, a prompt cached
    on the decode server only is fetched through ``kv_src`` by the
    prefill server: a hit, and a tail-only prefill.  Counters zeroed
    just before the kv_dest requests and read after the fetch: RMSNorm
    at 2·CUT_LAYERS+1 launches per model call of both engines, no flash
    kernel.
    Then one more migration under a caller's W3C traceparent, tracing on
    (``traced_migration``: its ``kv_migrate`` span and the frame's trace
    id), and each stage of a 509-token migration timed on its own."""
    import threading

    from k8s_tpu_torch.models import kvxfer, placement

    cfg, sd = cut_depth(dataclasses.replace(
        tlib.llama_8b(), use_flash_attention=True, use_fused_norm=True,
        dtype=torch.bfloat16), sd)
    os.environ["K8S_TPU_REQUEST_LOG"] = "1"
    requestlog.set_active(None)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pre = server.LmServer(config=cfg, params=sd, slots=4, role="prefill",
                          device="cuda")
    dec = server.LmServer(config=cfg, params=sd, slots=4, role="decode",
                          device="cuda")
    shared_weights = all(
        a.data_ptr() == b.data_ptr() for (n, a), (_, b) in zip(
            pre.model.state_dict().items(), dec.model.state_dict().items())
        if n != "embedding")
    httpds = [server.serve(lm, "127.0.0.1", 0) for lm in (pre, dec)]
    purl, durl = ("http://%s:%d" % h.server_address[:2] for h in httpds)
    kv_dest = f"127.0.0.1:{dec.serving_info()['kvxfer_port']}"
    rng = torch.Generator().manual_seed(9)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()

    def post(url, p, new, **extra):
        code, body, secs = http(url + "/v1/generate", dict(
            tokens=p, max_new_tokens=new, **extra))
        toks = body.get("tokens")
        if code != 200 or not isinstance(toks, list) or len(toks) != new \
                or not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"disagg request ({len(p)} tokens, {extra}): {code} "
                 f"{str(body)[:300]}")
        return toks, secs

    prompts = [prompt(n) for n in DISAGG_LENS]
    new = 32
    try:
        for url in (purl, durl):
            post(url, prompt(33), 2)  # warm-up
        cold = {}
        for p in prompts:
            post(purl, p, 1)  # the prefill tier's tree now holds p
            cold[len(p)] = _last_request(pre.engine)["ttft_s"]
        local = [post(purl, p, new)[0] for p in prompts]
        samp = {"temperature": 1.0, "seed": 11}
        samp_local = post(purl, prompts[4], new, **samp)[0]
        s0 = {k: lm.engine.stats() for k, lm in (("pre", pre), ("dec", dec))}
        mig0 = pre.metrics["kv_migrate"]._default_child().total
        common.reset_launches()
        t0 = time.perf_counter()
        one = [post(purl, p, new, kv_dest=kv_dest) for p in prompts]
        one_s = time.perf_counter() - t0
        m = pre.metrics["kv_migrate"]._default_child()
        migrate_s_one = (m.total - mig0) / len(prompts)
        conc: dict = {}

        def client(i):
            conc[i] = post(purl, prompts[i], new, kv_dest=kv_dest)
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        conc_s = time.perf_counter() - t0
        if len(conc) != len(prompts):
            fail(f"disagg concurrent: {len(conc)} of {len(prompts)} answered")
        samp_mig = post(purl, prompts[4], new, kv_dest=kv_dest, **samp)[0]
        # the fetch: F cached on the decode server only
        F = prompt(300)
        post(durl, F, 2)
        F2 = F[:288] + prompt(20)
        f0 = pre.engine.stats()
        fetched = post(purl, F2, 8, kv_src=kv_dest)[0]
        f1 = pre.engine.stats()
        torch.cuda.synchronize()
        launches = common.launches()
        s1 = {k: lm.engine.stats() for k, lm in (("pre", pre), ("dec", dec))}
        text = http(purl + "/healthz")[1]["serving"]
        dedup = pre.metrics["kvxfer_dedup_skipped"].value
        mig = pre.metrics["kv_migrate"]._default_child()
        rx_stats = dec._kv_receiver.stats()
        tx_stats = pre._kv_sender.stats()
        traced = traced_migration(trace, purl, dec, prompts[2], kv_dest, new,
                                  local[2])
        stages = migration_stages(torch, kvxfer, placement, pre.engine,
                                  prompts[-1])
        for lm in (pre, dec):
            lm.engine.debug_check_blocks()
        peak = torch.cuda.max_memory_allocated()
    finally:
        for h in httpds:
            h.shutdown()
            h.server_close()
        for lm in (pre, dec):
            lm.close()
        requestlog.set_active(None)
        os.environ.pop("K8S_TPU_REQUEST_LOG", None)
    calls = {k: s1[k]["model_calls"] - s0[k]["model_calls"] for k in s1}
    want = {"flash_fwd": 0,
            "rms_norm": (2 * cfg.layers + 1) * sum(calls.values()),
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    if launches != want or not all(calls.values()):
        fail(f"disagg launches {launches}, expected {want} ({calls})")
    for i, (toks, _) in enumerate(one):
        if toks != local[i]:
            fail(f"disagg: prompt {len(prompts[i])} migrated gave {toks}, "
                 f"the colocated engine {local[i]}")
    vs_local = {str(len(prompts[i])): token_check(
        torch, pre.model, prompts[i], conc[i][0], local[i],
        f"disagg concurrent {len(prompts[i])} vs colocated",
        pre.engine.buckets) for i in range(len(prompts))}
    if samp_mig != samp_local:
        fail(f"disagg: the sampled request migrated gave {samp_mig}, "
             f"locally {samp_local}")
    if dedup <= 0:
        fail("disagg: no block deduplicated on the repeated prompts")
    got_f = f1["kv_prefix_fetched"] - f0["kv_prefix_fetched"]
    saved_f = f1["prefix_tokens_saved"] - f0["prefix_tokens_saved"]
    if got_f != 18 or saved_f != 288 or \
            f1["prefix_hits"] - f0["prefix_hits"] != 1:
        fail(f"disagg kv_src fetch: {got_f} blocks fetched, {saved_f} "
             "tokens saved (want 18 and 288)")
    block_bytes = 2 * cfg.layers * 16 * cfg.kv_heads * \
        cfg.dims_per_head * 2
    rec = {"phase": "disagg", "card": REPORT["card"],
           "config": "llama_8b bf16 flash+fused, two LmServer(slots=4) "
                     "roles prefill and decode, loopback kvxfer",
           "layers": cfg.layers, "prompt_lens": list(DISAGG_LENS),
           "new_tokens": new, "weights_shared_but_embedding": shared_weights,
           "one_at_a_time": {"wall_s": one_s, "identical_to_colocated":
                             len(prompts),
                             "client_s": {str(len(p)): s for p, (_, s)
                                          in zip(prompts, one)}},
           "concurrent": {"wall_s": conc_s, "vs_colocated": vs_local,
                          "equal": sum(r["equal"] for r in vs_local.values())},
           "sampled_identical": True,
           "serve_kv_migrate_seconds": {"count": mig.count, "sum": mig.total,
                                        "mean_one_at_a_time":
                                            migrate_s_one},
           "cold_prefill_ttft_s": {str(k): v for k, v in cold.items()},
           "migration_stages_509": stages,
           "block_bytes": block_bytes,
           "wire_blocks_out": tx_stats["blocks_out"],
           "wire_block_bytes_out": tx_stats["blocks_out"] * block_bytes,
           "dedup_blocks_skipped": dedup,
           "dedup_bytes_saved": tx_stats["dedup_bytes_saved"],
           "receiver": rx_stats, "sender": tx_stats,
           "kv_src_fetch": {"blocks": got_f, "tokens_saved": saved_f,
                            "tokens": fetched},
           "traced_migration": traced,
           "prefill_serving": {k: text[k] for k in (
               "role", "kv_exports", "kv_blocks_out", "kv_prefix_fetched")},
           "model_calls": calls,
           "rms_launches_by_server": {k: (2 * cfg.layers + 1) * v
                                      for k, v in calls.items()},
           "launches": launches, "expected_launches": want,
           "memory_allocated_before_gib": base / 2 ** 30,
           "max_memory_allocated_gib": peak / 2 ** 30}
    emit(rec)
    REPORT["disagg"] = rec
    return launches


# -- phase 5e: the serving benches' twins at the served width ---------------

BENCH_SLOTS, BENCH_CLIENTS, BENCH_REQUESTS = 4, 4, 1
BENCH_NEW_SHORT, BENCH_NEW_LONG = 16, 32
BENCH_GROUNDED = 2   # grounded speculative prompts searched for
BENCH_DRAFT_K = 4
EXCLUSIVE_PHASES = ("single_flight", "sampled_exclusive", "spec_exclusive")


class DrawLog:
    """Records, while active, every decision the sampled lanes draw from
    a generator, in order: each Gumbel draw of ``decode._gumbel_argmax``
    (the noise, the entries the caller masked, the token) and each
    acceptance test of ``decode.spec_accept_sampled`` (the uniforms, the
    drafts).  The noise and the uniforms are replayed from a copy of the
    generator's state, so the lanes draw exactly what they draw
    unrecorded (the token each replayed draw gives is checked)."""

    def __init__(self, torch, decode):
        self.torch, self.decode = torch, decode
        self.events: list = []

    def __enter__(self):
        torch, d, events = self.torch, self.decode, self.events
        self.orig = gumbel_argmax, accept = (d._gumbel_argmax,
                                             d.spec_accept_sampled)

        def replay(generator, shape, device):
            g = torch.Generator(device=device)
            g.set_state(generator.get_state())
            return torch.rand(shape, generator=g, device=device)

        def draw(x, generator):
            u = replay(generator, x.shape, x.device)
            out = gumbel_argmax(x, generator)
            noise = -torch.log(-torch.log(
                u.clamp_min(torch.finfo(u.dtype).tiny)))
            if not torch.equal((x + noise).argmax(dim=-1), out):
                fail("DrawLog: the replayed Gumbel draw gives another token")
            events.append({"kind": "draw", "noise": noise[0],
                           "masked": (x[0] <= -1e29).nonzero()[:, 0],
                           "token": int(out[0])})
            return out

        def accept_sampled(x, draft, generator, pad_id=0):
            u = replay(generator, draft.shape, x.device)
            event = {"kind": "accept", "u": u[0].tolist(),
                     "draft": draft[0].tolist()}
            events.append(event)  # before the draw accept() makes
            acc, bonus = accept(x, draft, generator, pad_id)
            event["accepted"] = int(acc[0])
            return acc, bonus
        d._gumbel_argmax, d.spec_accept_sampled = draw, accept_sampled
        return self

    def __exit__(self, *exc):
        self.decode._gumbel_argmax, self.decode.spec_accept_sampled = \
            self.orig


def draws_check(torch, model, prompt, got, want, logs, temperature, what,
                buckets) -> dict:
    """``got`` (the batched lane) against ``want`` (the exclusive lane)
    for one fixed-seed sampled request, with each lane's ``DrawLog``
    events.  Both lanes draw the same noise in the same order until their
    first differing decision (a differing noise fails: the draw schedules
    differ).  That decision is judged as ``token_check`` judges a greedy
    flip, over the agreed context's logits through each decode path
    (``path_logits``, scaled by 1/temperature): a Gumbel draw may flip
    only where the top-2 margin of the perturbed prefill logits lies
    within twice the largest difference between the paths; an acceptance
    test only where its uniform lies within twice that difference of the
    draft's probability."""
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if i is None:
        if len(got) != len(want):
            fail(f"{what}: {len(got)} tokens against {len(want)}")
        return {"equal": True}
    n = 0  # tokens emitted before the event
    for k, (ea, eb) in enumerate(zip(*logs)):
        if ea["kind"] != eb["kind"]:
            fail(f"{what}: event {k} is a {ea['kind']} on one lane and a "
                 f"{eb['kind']} on the other before any decision differed")
        if ea["kind"] == "draw":
            if not torch.equal(ea["noise"], eb["noise"]):
                fail(f"{what}: draw {k} used other noise on the two lanes")
            if ea["token"] == eb["token"]:
                n += 1
                continue
            logits = path_logits(torch, model, list(prompt) + list(want[:n]),
                                 buckets)
            x = {key: v / temperature for key, v in logits.items()}
            ref = x["prefill"].clone()
            ref[ea["masked"]] = -1e30
            top2 = torch.topk(ref + ea["noise"], 2).values.tolist()
            margin = top2[0] - top2[1]
            err = max((v - x["prefill"]).abs().max().item()
                      for key, v in x.items() if key != "prefill")
            rec = {"equal": False, "first_mismatch": i, "event": k,
                   "decision": "draw", "tokens_before": n,
                   "tokens": [ea["token"], eb["token"]],
                   "top2_margin": margin, "logit_err": err,
                   "within_error": margin <= 2 * err}
        else:
            if ea["draft"] != eb["draft"] or ea["u"] != eb["u"]:
                fail(f"{what}: event {k} drafted {ea['draft']} on one lane "
                     f"and {eb['draft']} on the other")
            if ea["accepted"] == eb["accepted"]:
                n += ea["accepted"]
                continue
            j = min(ea["accepted"], eb["accepted"])  # the first split test
            d = ea["draft"]
            logits = path_logits(torch, model,
                                 list(prompt) + list(want[:n]) + d[:j],
                                 buckets)
            p = {key: torch.softmax(v / temperature, -1)[d[j]].item()
                 for key, v in logits.items()}
            err = max(abs(v - p["prefill"]) for key, v in p.items()
                      if key != "prefill")
            gap = abs(ea["u"][j] - p["prefill"])
            rec = {"equal": False, "first_mismatch": i, "event": k,
                   "decision": "accept", "tokens_before": n,
                   "accepted": [ea["accepted"], eb["accepted"]],
                   "uniform": ea["u"][j], "draft_p": p["prefill"],
                   "p_err": err, "within_error": gap <= 2 * err}
        at = n + (j if rec["decision"] == "accept" else 0)
        if at != i:
            fail(f"{what}: the first differing decision ({rec}) emits token "
                 f"{at}, the first differing token is {i}")
        if not rec["within_error"]:
            fail(f"{what}: token {i} differs ({got[i]} vs {want[i]}) at "
                 f"a {rec['decision']} outside twice the path error: {rec}")
        return rec
    fail(f"{what}: token {i} differs ({got[i]} vs {want[i]}) though every "
         "recorded decision agrees")


def llama_lane_equivalence(torch, tlib, decode, bench_serve, cfg, sd,
                           buckets) -> dict:
    """The twin's two lane checks at the served width, request by request:
    each payload of ``sampled_equivalence_payloads`` and
    ``spec_equivalence_payloads`` over real HTTP on a 2-slot server
    (``_lane_outputs``), the batched lane against the exclusive one, each
    lane's draws recorded.  In bf16 the lanes round differently (the
    exclusive lane prefills through K2 into a dense cache, the batched
    lane through the paged attention), so a token may differ: a greedy
    request is judged by ``token_check``, a sampled one by
    ``draws_check``."""
    bs = bench_serve
    model = tlib.Transformer(cfg, sd, device="cuda")  # shares the weights
    out = {}
    for check, payloads, flag in (
            ("sampled", bs.sampled_equivalence_payloads(), "batch_sampling"),
            ("spec", bs.spec_equivalence_payloads(BENCH_DRAFT_K),
             "batch_spec")):
        lanes, logs = {}, {}
        for lane in (True, False):
            with DrawLog(torch, decode) as dl:
                got = bs._lane_outputs(cfg, sd, payloads, "cuda",
                                       **{flag: lane})
            lanes[lane] = [r["tokens"] for r in got]
            logs[lane] = dl.events
        recs = []
        for k, p in enumerate(payloads):
            what = f"bench_serve {check} equivalence request {k}"
            if p.get("temperature", 0.0) > 0:
                # this request is the only one that draws: the whole log
                recs.append(draws_check(
                    torch, model, p["tokens"], lanes[True][k],
                    lanes[False][k], (logs[True], logs[False]),
                    p["temperature"], what, buckets))
            else:
                recs.append(token_check(torch, model, p["tokens"],
                                        lanes[True][k], lanes[False][k],
                                        what, buckets))
        out[check] = {"equal": lanes[True] == lanes[False],
                      "requests": recs,
                      "draws": [len(logs[True]), len(logs[False])]}
    return out


def bench_serve_llama(torch, tlib, bridge, decode, common, sd, bench_serve):
    """``k8s_tpu_torch.harness.bench_serve``'s phases at the served width
    (``llama_8b``, bf16, both forward kernels, on ``serve_engine``'s
    weights, cut to their first ``CUT_LAYERS`` layers by ``cut_depth``), in
    ``run_bench``'s order, each the twin's ``run_phase`` (a real HTTP
    server, closed-loop clients, the recorder cleared at the warm-up
    boundary): single_flight (slots 0), batched
    and batched_recorder_off twice each in turns, sampled_exclusive and
    sampled_batched (twice the clients), the grounded prompts, then
    spec_exclusive and spec_batched (twice the slots, clients and
    requests).  Slots 4, 4 clients, 1 request a client, 16 / 32 new
    tokens.  Each phase must answer every request; its counters, zeroed
    just before and read just after, must equal 2·CUT_LAYERS+1 K1 launches
    a model call (``ModelCalls``) and one K2 launch a layer a
    prefill-mode call, with K2 in the single-flight and exclusive phases
    and none in the batched ones.  The twin's lane checks must hold exactly on the tiny
    model in f32 on the card; at the served width each differing token
    is judged (``llama_lane_equivalence``).  The speedups and the
    recorder ratio are readings: ``run_bench``'s bounds were set on the
    reference's tiny CPU model."""
    bs = bench_serve
    cfg, sd = cut_depth(dataclasses.replace(
        tlib.llama_8b(), use_flash_attention=True, use_fused_norm=True,
        dtype=torch.bfloat16), sd)
    t_start = time.perf_counter()
    tcfg = dataclasses.replace(tlib.tiny_test(), use_flash_attention=True,
                               use_fused_norm=True)
    tsd = bridge.init_params(tcfg, seed=0, device="cuda")
    exact = {"sampled": bs.check_sampled_equivalence(tcfg, tsd,
                                                     device="cuda"),
             "spec": bs.check_spec_equivalence(tcfg, tsd, BENCH_DRAFT_K,
                                               device="cuda")}
    if not all(exact.values()):
        fail(f"bench_serve lane checks on the tiny model in f32: {exact}")
    torch.cuda.reset_peak_memory_stats()
    phases, launches_by_phase, calls_by_phase, secs = {}, {}, {}, {}
    total = dict.fromkeys(common.KERNELS, 0)

    def phase(name, **kw):
        t0 = time.perf_counter()
        with ModelCalls(tlib) as mc:
            common.reset_launches()
            rec = bs.run_phase(cfg, sd, device="cuda", **kw)
            torch.cuda.synchronize()
            launches = common.launches()
        secs[name] = time.perf_counter() - t0
        calls = dict(mc.by_mode)
        want = {"flash_fwd": cfg.layers * calls["prefill"],
                "rms_norm": (2 * cfg.layers + 1) * mc.total,
                "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        k2 = rec["mode"] in EXCLUSIVE_PHASES
        if rec["errors"] or rec["requests"] == 0:
            fail(f"bench_serve {name}: {rec['requests']} answered, errors "
                 f"{rec['errors']}")
        if launches != want or not launches["rms_norm"] \
                or bool(launches["flash_fwd"]) != k2:
            fail(f"bench_serve {name}: launches {launches}, expected {want} "
                 f"({calls} model calls; K2 {'in' if k2 else 'not in'} "
                 "this phase)")
        for k in total:
            total[k] += launches[k]
        phases[name], launches_by_phase[name] = rec, launches
        calls_by_phase[name] = calls
        return rec

    greedy = dict(slots=BENCH_SLOTS, concurrency=BENCH_CLIENTS,
                  requests_per_client=BENCH_REQUESTS,
                  max_new_short=BENCH_NEW_SHORT, max_new_long=BENCH_NEW_LONG)
    single = phase("single_flight", **{**greedy, "slots": 0})
    on, off = [], []
    for turn in range(2):
        off.append(phase(f"batched_recorder_off_{turn}",
                         mode="batched_recorder_off", prefix_blocks=0,
                         **greedy))
        on.append(phase(f"batched_{turn}", request_log=True, prefix_blocks=0,
                        **greedy))
    batched = max(on, key=lambda r: r["tokens_per_s"])
    batched_off = max(off, key=lambda r: r["tokens_per_s"])
    sampled = dict(greedy, concurrency=2 * BENCH_CLIENTS, temperature=1.0,
                   shared_frac=0.8, request_log=True)
    s_excl = phase("sampled_exclusive", batch_sampling=False,
                   prefix_blocks=0, mode="sampled_exclusive", **sampled)
    s_batch = phase("sampled_batched", batch_sampling=True,
                    prefix_blocks=None, mode="sampled_batched", **sampled)
    t0 = time.perf_counter()
    spec_prompts = bs._grounded_spec_prompts(cfg, sd, n=BENCH_GROUNDED,
                                             device="cuda")
    grounded_s = time.perf_counter() - t0
    fallback = sum(p == bs._spec_prompt(i, 0)
                   for i, p in enumerate(spec_prompts))
    spec_kw = dict(greedy, slots=2 * BENCH_SLOTS,
                   concurrency=2 * BENCH_CLIENTS,
                   requests_per_client=2 * BENCH_REQUESTS,
                   spec_k=BENCH_DRAFT_K, request_log=True,
                   spec_prompts=spec_prompts)
    p_excl = phase("spec_exclusive", batch_spec=False, prefix_blocks=0,
                   mode="spec_exclusive", **spec_kw)
    p_batch = phase("spec_batched", batch_spec=True, prefix_blocks=None,
                    mode="spec_batched", **spec_kw)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    wide = llama_lane_equivalence(torch, tlib, decode, bs, cfg, sd,
                                  decode.prefill_buckets_for(cfg))
    equivalence_s = time.perf_counter() - t0

    def ratio(a, b):
        return a["tokens_per_s"] / max(b["tokens_per_s"], 1e-9)

    def summary(name):
        r = phases[name]
        keep = ("mode", "slots", "requests", "tokens", "wall_s",
                "tokens_per_s", "latency_p50_s", "latency_p99_s",
                "short_p99_s", "mean_batch_occupancy", "decode_steps",
                "request_phases", "prefix", "spec")
        return {**{k: r[k] for k in keep}, "seconds": secs[name],
                "launches": launches_by_phase[name],
                "model_calls": calls_by_phase[name]}
    rec = {"phase": "bench_serve", "card": REPORT["card"],
           "config": "llama_8b bf16 flash+fused, serve_engine's weights, "
                     "k8s_tpu_torch.harness.bench_serve.run_phase",
           "slots": BENCH_SLOTS, "clients": BENCH_CLIENTS,
           "requests_per_client": BENCH_REQUESTS,
           "max_new_short": BENCH_NEW_SHORT, "max_new_long": BENCH_NEW_LONG,
           "draft_k": BENCH_DRAFT_K,
           "phases": {name: summary(name) for name in phases},
           "speedup_batched_vs_single_flight": ratio(batched, single),
           "recorder_on_off_ratio": ratio(batched, batched_off),
           "recorder_runs": {"on": [r["tokens_per_s"] for r in on],
                             "off": [r["tokens_per_s"] for r in off]},
           "sampled_speedup": ratio(s_batch, s_excl),
           "spec_speedup": ratio(p_batch, p_excl),
           "spec_acceptance_rate": p_batch["spec"]["acceptance_rate"],
           "short_p99_single_s": single["short_p99_s"],
           "short_p99_batched_s": batched["short_p99_s"],
           "grounded_prompts": BENCH_GROUNDED,
           "grounded_fallbacks": fallback, "grounded_s": grounded_s,
           "equivalence_tiny_f32": exact,
           "equivalence_llama": wide, "equivalence_s": equivalence_s,
           "max_memory_allocated_gib": peak / 2 ** 30,
           "launches": total, "phase_s": time.perf_counter() - t_start}
    emit(rec)
    REPORT["bench_serve"] = {**rec, "requests_audit": {
        name: r["requests_audit"] for name, r in phases.items()
        if r["requests_audit"] is not None}}
    return total


KV_MAX_SEQ = 128          # the twin's bench model's: 1 + 2·8 + 6 blocks
KV_CORPUS, KV_ROUNDS, KV_PROMPT = 12, 2, 96   # 72 distinct prefix blocks
KV_PREFIX_BLOCKS = 6      # the corpus is 12x the pool's prefix headroom
KV_SPILL_MB = 256         # 128 bf16 blocks of 2 MiB: 1.8x the corpus
KV_IDENTITY_SPILL_MB = 128  # ~113 int8 blocks of 1.125 MiB


def bench_kvtier_llama(torch, tlib, common, sd, bench_kvtier):
    """``k8s_tpu_torch.harness.bench_kvtier``'s three stages at the
    served width and depth (``llama_8b``, bf16, both forward kernels, on
    ``serve_engine``'s weights), with ``max_seq_len`` cut to 128, the
    twin's bench model's, so that the 2-slot pool (1 + 2·8 +
    prefix_blocks blocks) is pressed by the corpus as in the reference:
    ``_spill_arm`` with the spill tier then without (12 prompts of 96
    tokens, 72 distinct prefix blocks against 6 blocks of prefix
    headroom, 256 MB of spill: 128 blocks of 2 MiB), ``_spill_identity``
    on an int8 pool, ``_dedup_storm`` over two servers.  Held exactly:
    the spill arm demotes and promotes and beats the baseline's prefix hit
    rate, and the identity and dedup stages report no failure (each lane
    equal through promote, dedup skips blocks and saves bytes, deduped
    answers equal the local oracle).  Spill against evict-recompute
    tokens/s is a reading.  K1 runs 2·CUT_LAYERS+1 times a model call; nothing
    prefills in prefill mode, so no K2."""
    kv = bench_kvtier
    cfg, sd = cut_depth(dataclasses.replace(
        tlib.llama_8b(), use_flash_attention=True, use_fused_norm=True,
        dtype=torch.bfloat16, max_seq_len=KV_MAX_SEQ), sd)
    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    failures: list = []
    secs = {}
    with ModelCalls(tlib) as mc:
        common.reset_launches()
        arm = dict(corpus=KV_CORPUS, prompt_len=KV_PROMPT, rounds=KV_ROUNDS,
                   prefix_blocks=KV_PREFIX_BLOCKS, max_new=4, device="cuda")
        t0 = time.perf_counter()
        sp = kv._spill_arm(cfg, sd, spill_mb=KV_SPILL_MB, **arm)
        bl = kv._spill_arm(cfg, sd, spill_mb=None, **arm)
        secs["spill_arms"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        identity = kv._spill_identity(
            cfg, sd, prompt_len=80, max_new=8, failures=failures,
            spill_mb=KV_IDENTITY_SPILL_MB, device="cuda")
        secs["spill_identity"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dedup = kv._dedup_storm(cfg, sd, base_len=64, tail_len=16, storm=6,
                                max_new=8, failures=failures, device="cuda")
        secs["dedup_storm"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = common.launches()
    calls = dict(mc.by_mode)
    want = {"flash_fwd": cfg.layers * calls["prefill"],
            "rms_norm": (2 * cfg.layers + 1) * mc.total,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    arm_failures = [m for m in kv.spill_failures(sp, bl)
                    if not m.startswith("spill tokens/s")]
    if failures or arm_failures or launches != want \
            or not launches["rms_norm"] or launches["flash_fwd"]:
        fail(f"bench_kvtier: {failures + arm_failures}; launches "
             f"{launches}, expected {want} ({calls} model calls)")
    block_bytes = 2 * cfg.layers * 16 * cfg.kv_heads * cfg.dims_per_head * 2
    rec = {"phase": "bench_kvtier", "card": REPORT["card"],
           "config": "llama_8b bf16 flash+fused, serve_engine's weights, "
                     f"max_seq_len {KV_MAX_SEQ}, "
                     "k8s_tpu_torch.harness.bench_kvtier",
           "reduced": {"max_seq_len": [8192, KV_MAX_SEQ]},
           "workload": {"corpus": KV_CORPUS, "rounds": KV_ROUNDS,
                        "prompt_len": KV_PROMPT,
                        "prefix_blocks": KV_PREFIX_BLOCKS,
                        "spill_mb": KV_SPILL_MB, "max_new": 4,
                        "identity_spill_mb": KV_IDENTITY_SPILL_MB,
                        "storm": 6},
           "block_bytes": block_bytes,
           "spill": sp, "baseline": bl,
           "spill_vs_recompute_tokens_per_s":
               sp["tokens_per_s"] / bl["tokens_per_s"],
           "spill_identity": identity, "dedup": dedup,
           "seconds": secs, "model_calls": calls, "launches": launches,
           "expected_launches": want,
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2 ** 30,
           "phase_s": time.perf_counter() - t_start}
    emit(rec)
    REPORT["bench_kvtier"] = rec
    return launches


MP_REQUESTS, MP_NEW = 24, 24  # bench_serve_mp's defaults


def bench_serve_mp_card(torch, server, mp_serve, bench_serve_mp):
    """``k8s_tpu_torch.harness.bench_serve_mp``'s ``_arm(1, ...)`` on the
    card: a one-process serving gang (``python -m
    k8s_tpu_torch.models.mp_serve`` under the launcher env with
    ``K8S_TPU_PLATFORM=cuda``: a one-rank NCCL group, the engine on a
    ``MeshPlacement`` at tp 1, the plan bus) at the twin's default width
    (hidden 256, 4 layers, 8 heads, f32), warm-up then the 24-request
    three-lane script.  NCCL puts no two ranks on one card, so the
    N-process arms are gloo CPU tests.  Held exactly: exit 0, tp 1, no
    request error, and the chief's greedy and greedy-speculative tokens
    equal to the same script served in this process by ``LmServer`` on
    the card over HTTP.  The gang's model keeps the reference's flags
    (plain norm, plain attention), so its chief's counters must read no
    kernel launch."""
    mpb = bench_serve_mp
    script = mpb.bench_script(MP_REQUESTS, MP_NEW)
    t0 = time.perf_counter()
    res, workers = mpb._arm(1, script, slots=8, threads=10, hidden=256,
                            layers=4, timeout=300, device="cuda")
    gang_s = time.perf_counter() - t0
    c = res.chief_result
    if not res.success or c is None or c["errors"] \
            or c["tp_degree"] != 1 or c["num_processes"] != 1:
        tail = res.worker_outputs[-1][-1500:] if res.worker_outputs else ""
        fail(f"bench_serve_mp gang: exit codes {res.exit_codes}, chief "
             f"{None if c is None else {k: c[k] for k in ('errors', 'tp_degree', 'num_processes')}}: {tail}")
    config, params = mp_serve.build_model(0, hidden=256, layers=4, heads=8,
                                          max_seq_len=128)
    lm = server.LmServer(config=config, params=params, slots=8,
                         device="cuda")
    httpd = server.serve(lm, "127.0.0.1", 0)
    url = "http://%s:%d" % httpd.server_address[:2]
    try:
        local = []
        for r in script:
            code, body, _ = http(url + "/v1/generate", r)
            if code != 200:
                fail(f"bench_serve_mp local server: {code} {body}")
            local.append(body["tokens"])
    finally:
        httpd.shutdown()
        httpd.server_close()
        lm.close()
    greedy = [i for i, r in enumerate(script) if not r.get("temperature")]
    differ = [i for i in greedy if c["results"][i] != local[i]]
    zero = dict.fromkeys(c["launches"], 0)
    if differ or c["launches"] != zero:
        fail(f"bench_serve_mp: greedy requests {differ} differ from the "
             f"in-process server; chief launches {c['launches']}")
    sampled = [i for i in range(len(script)) if i not in greedy]
    rec = {"phase": "bench_serve_mp", "card": REPORT["card"],
           "config": "mp_serve.build_model hidden 256, 4 layers, 8 heads, "
                     "f32; bench_serve_mp._arm(1), NCCL world 1",
           "requests": MP_REQUESTS, "max_new": MP_NEW, "slots": 8,
           "threads": 10, "exit_codes": res.exit_codes,
           "tp_degree": c["tp_degree"], "plan_bus": c["plan_bus"],
           "tokens": c["tokens"], "wall_s": c["wall_s"],
           "tokens_per_s": c["tokens_per_s"],
           "spec_mean_accepted": c["spec_mean_accepted"],
           "pool_local_fraction": c["pool_local_fraction"],
           "params_local_fraction": c["params_local_fraction"],
           "greedy_equal_in_process": len(greedy),
           "sampled_equal_in_process": sum(c["results"][i] == local[i]
                                           for i in sampled),
           "sampled_requests": len(sampled),
           "gang_s": gang_s, "gang_duration_s": res.duration_s,
           "launches": c["launches"]}
    emit(rec)
    REPORT["bench_serve_mp"] = rec
    return c["launches"]


# bench_disagg's served model: llama_8b width at the later serving phases'
# depth, max_seq_len cut to the twin's bench model's (long_len 112 + 5 fit)
DISAGG_MODEL = {"preset": "llama_8b", "layers": CUT_LAYERS,
                "max_seq_len": 128, "dtype": "bfloat16",
                "use_flash_attention": True, "use_fused_norm": True}
# the twin's workload, but each measured phase 2 s long, not 4 (the
# smoke's time limit)
DISAGG_WORKLOAD = dict(shorts=4, longs=3, slots=12, duration_s=2.0,
                       max_new_short=17, max_new_long=5, long_len=112,
                       phase_tokens=48, hidden=256, layers=4)


def disagg_hop(torch, engine_lib, cfg, sd, body) -> list:
    """``body`` through the disaggregated hop in this process: a prefill
    engine and a decode engine at the pods' 12 slots over the same weights,
    ``prefill_export`` then ``submit_prefilled`` with the exported blocks
    and generator state, as the pods' servers call them."""
    import numpy as np

    kw = dict(temperature=float(body.get("temperature", 0.0)),
              top_k=body.get("top_k"))
    n = body["max_new_tokens"]
    pre = engine_lib.Engine(cfg, sd, slots=12, queue_limit=16,
                            device="cuda")
    dec = engine_lib.Engine(cfg, sd, slots=12, queue_limit=16,
                            device="cuda")
    try:
        ex = pre.prefill_export(np.asarray(body["tokens"], np.int32), n,
                                seed=int(body.get("seed", 0)), timeout=600,
                                **kw)
        if ex["done"]:
            return [int(t) for t in ex["tokens"]]
        return [int(t) for t in dec.submit_prefilled(
            np.asarray(ex["ids"], np.int32), ex["blocks"],
            first_token=int(ex["first"]), key=ex["key"], max_new_tokens=n,
            block_size=ex["block_size"], timeout=600, **kw)]
    finally:
        pre.shutdown()
        dec.shutdown()


def bench_disagg_card(torch, tlib, decode, engine_lib, _build, bench_disagg):
    """``k8s_tpu_torch.harness.bench_disagg`` at the served width:
    ``measure`` with the twin's workload, call for call, on three pod
    processes a topology (1 prefill + 2 decode, then 3 collapsed), each
    pinned to a third of the host's cores and holding its own llama_8b
    weights (``CUT_LAYERS`` of 32 layers, bf16, K1 and K2 on,
    ``max_seq_len`` 128)
    drawn by ``bridge.init_params`` from seed 0, all on this card; then
    ``judge``.  The kernels are built first (no pod runs nvcc) and this
    process's cached blocks returned.  Held exactly: no request error in
    any phase of either arm, the identity probes migrated, blocks migrated
    in the storm phases, collapsed convoys, each pod's weight digest equal
    to this process's draw, and on every pod K1 = (2·CUT_LAYERS+1) x its
    engine's
    ``model_calls`` with K2-K4 at 0 (engine prefill runs through the paged
    attention).  Identity: the routed greedy and sampled answers must
    equal the same hop run in this process (``disagg_hop``), which is
    held against the twin's local oracle (``Engine(slots=2)``) token by
    token, or, where bf16 rounds otherwise at 12 slots than at 2, by
    ``token_check`` (greedy) and ``draws_check`` (sampled, with each
    side's recorded draws).  The two p99 ratios are readings beside their
    bounds: one card's three processes time-share the GPU, where the
    reference's pods each had their own cores."""
    import copy

    bd = bench_disagg
    t_start = time.perf_counter()
    nvcc_s = _build.build_all()
    gc.collect()
    torch.cuda.empty_cache()
    model, wl = DISAGG_MODEL, DISAGG_WORKLOAD
    cfg, sd = bd.build_pod_model(model, wl["hidden"], wl["layers"], "cuda")
    digest = bd.weights_digest(sd)
    t0 = time.perf_counter()
    with DrawLog(torch, decode) as oracle_draws:  # only the oracle draws here
        arms = bd.measure(**wl, model=model, device="cuda")
    measure_s = time.perf_counter() - t0
    identity = copy.deepcopy(arms["disaggregated"]["identity"])
    result, failures = bd.judge(arms, **wl, model=model)
    errors = {name: sum(p["error_count"] for p in arm["phases"].values())
              for name, arm in arms.items()}
    storm_blocks = sum(arms["disaggregated"]["phases"][p]["blocks_migrated"]
                       for p in ("storm1x", "storm2x"))
    if any(errors.values()) or identity["migrations"] < 1 \
            or storm_blocks < 1 \
            or arms["collapsed"]["prefill_convoys_total"] < 1:
        fail(f"bench_disagg: request errors {errors}, identity migrations "
             f"{identity['migrations']}, storm blocks {storm_blocks}, "
             f"collapsed convoys {arms['collapsed']['prefill_convoys_total']}"
             f"; twin failures {failures}")
    launches = dict.fromkeys(("flash_fwd", "rms_norm", "flash_bwd_dq",
                              "flash_bwd_dkv"), 0)
    pods = {}
    for name, arm in arms.items():
        pods[name] = arm["pods"]
        for i, pod in enumerate(arm["pods"]):
            st = pod["stats"]
            if st is None or pod["exit_code"] != 0 \
                    or pod["weights"] != digest:
                fail(f"bench_disagg {name} pod {i}: {pod} (this process "
                     f"drew {digest})")
            want = {"flash_fwd": 0,
                    "rms_norm": (2 * cfg.layers + 1) * st["model_calls"],
                    "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
            if st["launches"] != want or not st["model_calls"]:
                fail(f"bench_disagg {name} pod {i} ({pod['role']!r}): "
                     f"launches {st['launches']}, expected {want} "
                     f"({st['model_calls']} model calls)")
            for k, v in st["launches"].items():
                launches[k] += v
    # identity: routed == the in-process hop, exactly; the hop against
    # the oracle, token by token or within bf16's rounding
    t0 = time.perf_counter()
    lm = tlib.Transformer(cfg, sd, device="cuda")  # shares the weights
    buckets = decode.prefill_buckets_for(cfg)
    ident = {"migrations": identity["migrations"]}
    for lane in ("greedy", "sampled"):
        body = {"tokens": bd._long_prompt(7, 7, wl["long_len"]),
                "max_new_tokens": 12}
        if lane == "sampled":
            body.update(temperature=1.0, top_k=7, seed=1234)
        with DrawLog(torch, decode) as hop_draws:
            hop = disagg_hop(torch, engine_lib, cfg, sd, body)
        routed, local = identity[lane]["routed"], identity[lane]["local"]
        if routed != hop:
            fail(f"bench_disagg {lane}: the routed answer {routed} is not "
                 f"the in-process hop's {hop}")
        what = f"bench_disagg {lane} identity"
        if lane == "greedy":
            rec = token_check(torch, lm, body["tokens"], hop, local, what,
                              buckets)
        else:
            rec = draws_check(torch, lm, body["tokens"], hop, local,
                              (hop_draws.events, oracle_draws.events), 1.0,
                              what, buckets)
        ident[lane] = {"routed_equals_local": routed == local,
                       "routed_equals_hop": True, "check": rec,
                       "routed": routed, "local": local}
    identity_s = time.perf_counter() - t0
    del lm, sd
    gc.collect()
    torch.cuda.empty_cache()
    dis, col = result["disaggregated"], result["collapsed"]

    def phases(arm):
        return {n: {k: p.get(k) for k in (
            "short_requests", "long_requests", "short_p50_s", "short_p99_s",
            "long_p50_s", "blocks_migrated", "blocks_per_s_migrated")
            if k in p} for n, p in arm["phases"].items()}
    value, col_ratio = result["value"], result["collapsed_ratio"]
    rec = {"phase": "bench_disagg", "card": REPORT["card"],
           "config": f"llama_8b bf16 flash+fused, {CUT_LAYERS} layers, "
                     "max_seq_len "
                     "128, bridge.init_params seed 0 in each pod; "
                     "k8s_tpu_torch.harness.bench_disagg measure + judge",
           "model": model,
           "reduced": {"layers": [32, CUT_LAYERS],
                       "max_seq_len": [8192, model["max_seq_len"]]},
           "workload": result["workload"],
           "disaggregated_ratio": value, "collapsed_ratio": col_ratio,
           "flat_factor_bound": result["flat_factor_bound"],
           "convoy_factor_bound": result["convoy_factor_bound"],
           "within_bound": {
               "flat": value is not None
               and value <= result["flat_factor_bound"],
               "convoy": col_ratio is not None
               and col_ratio >= result["convoy_factor_bound"]},
           "twin_failures": failures,
           "phases": {"disaggregated": phases(dis),
                      "collapsed": phases(col)},
           "prefill_convoys_total": {
               "disaggregated": dis["prefill_convoys_total"],
               "collapsed": col["prefill_convoys_total"]},
           "migrations": dis["migrations"],
           "migrate_seconds_total": dis["migrate_seconds_total"],
           "migrate_s_per_migration": dis["migrate_s_per_migration"],
           "transfer_overhead_s_per_token":
               dis["transfer_overhead_s_per_token"],
           "kv_exports": dis["kv_exports"], "kv_imports": dis["kv_imports"],
           "identity": ident, "weights": digest, "pods": pods,
           "launches": launches, "nvcc_s": nvcc_s, "measure_s": measure_s,
           "identity_s": identity_s,
           "phase_s": time.perf_counter() - t_start}
    emit(rec)
    REPORT["bench_disagg"] = rec
    return launches


def serve_spec(torch, tlib, server, common, sd):
    """Speculative decoding at the served width, on the served weights
    (``sd``): ``speculative: 4`` requests over HTTP on the engine's
    batched lane (``LmServer(slots=4)``, no prefix reuse, so every prefill
    is cold) and on the single-flight lane (``slots=0``, the exclusive
    program), against vanilla greedy requests for the same prompts on the
    same server, in turns (vanilla, spec, spec, vanilla).  Prompts: a
    seeded 23-token pattern repeated to 509 tokens, the same to 128, and
    a random 64.  Each lane's requests run with the counters zeroed just
    before and read just after: K1 must show 2·CUT_LAYERS+1 launches per
    model
    call (the engine's ``model_calls``; on single-flight every
    ``Transformer`` call, counted by ``ModelCalls``), K2 one launch a layer
    per single-flight prefill and none on the batched lane.  Spec tokens are
    held against vanilla greedy's on the same lane and across the lanes
    by ``token_check``."""
    cfg, sd = cut_depth(dataclasses.replace(
        tlib.llama_8b(), use_flash_attention=True, use_fused_norm=True,
        dtype=torch.bfloat16), sd)
    # no prefix reuse: the prompts share a pattern, and a spec request
    # attaching its vanilla twin's blocks would skip the prefill the
    # vanilla request paid
    lms = {"batched": server.LmServer(config=cfg, params=sd, slots=4,
                                      prefix_blocks=0, device="cuda"),
           "single_flight": server.LmServer(config=cfg, params=sd, slots=0,
                                            device="cuda")}
    httpds = {k: server.serve(lm, "127.0.0.1", 0) for k, lm in lms.items()}
    urls = {k: "http://%s:%d" % h.server_address[:2]
            for k, h in httpds.items()}
    rng = torch.Generator().manual_seed(6)
    pattern = torch.randint(0, cfg.vocab_size, (23,), generator=rng).tolist()
    prompts = {"rep_509": (pattern * 23)[:509], "rep_128": (pattern * 6)[:128],
               "random_64": torch.randint(0, cfg.vocab_size, (64,),
                                          generator=rng).tolist()}
    new = 32

    def post(lane, p, **extra):
        code, body, secs = http(urls[lane] + "/v1/generate", dict(
            tokens=p, max_new_tokens=new, **extra))
        toks = body.get("tokens")
        if code != 200 or not isinstance(toks, list) or len(toks) != new \
                or not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"serve_spec {lane} ({len(p)} tokens, {extra}): {code} "
                 f"{str(body)[:300]}")
        return toks, secs

    out = {"phase": "serve_spec", "card": REPORT["card"],
           "config": "llama_8b bf16 flash+fused", "layers": cfg.layers,
           "draft_k": 4, "new_tokens": new, "lanes": {}}
    launches = {}
    try:
        for lane in lms:
            post(lane, prompts["random_64"][:20], speculative=4)  # warm-up
        for lane, lm in lms.items():
            eng = lm.engine
            st0 = eng.stats() if eng else None
            per, vanilla = {}, {}

            def spec_request(p):
                """One spec request: its tokens, seconds and verify and
                model calls (the engine's counts, or ModelCalls')."""
                s0 = eng.stats() if eng else None
                calls0 = dict(mc.by_mode)
                toks, secs = post(lane, p, speculative=4)
                if eng:
                    s1 = eng.stats()
                    return toks, secs, s1["spec_steps"] - s0["spec_steps"], \
                        s1["model_calls"] - s0["model_calls"]
                return toks, secs, mc.by_mode["decode"] - calls0["decode"], \
                    mc.total - sum(calls0.values())

            # the lane's run: counters zeroed just before, read after;
            # vanilla and spec alternate (v s s v) so a drift of the
            # host's speed does not bias their ratio
            common.reset_launches()
            with ModelCalls(tlib) as mc:
                for n, p in prompts.items():
                    v1 = post(lane, p)
                    s1, s2 = spec_request(p), spec_request(p)
                    v2 = post(lane, p)
                    if v1[0] != v2[0] or s1[0] != s2[0] or s1[2:] != s2[2:]:
                        fail(f"serve_spec {lane} {n}: a repeated request "
                             "gave other tokens or calls")
                    vanilla[n] = v1
                    spec_s, vanilla_s = s1[1] + s2[1], v1[1] + v2[1]
                    per[n] = {"tokens": s1[0], "spec_s": [s1[1], s2[1]],
                              "vanilla_s": [v1[1], v2[1]],
                              "verify_calls": s1[2], "model_calls": s1[3],
                              "tokens_per_call": (new - 1) / max(s1[2], 1),
                              "spec_tokens_per_s": 2 * new / spec_s,
                              "vanilla_tokens_per_s": 2 * new / vanilla_s,
                              "spec_over_vanilla": vanilla_s / spec_s}
                torch.cuda.synchronize()
                got = common.launches()
            if eng:
                calls = eng.stats()["model_calls"] - st0["model_calls"]
                prefills = 0
            else:
                calls, prefills = mc.total, mc.by_mode["prefill"]
            want = {"flash_fwd": cfg.layers * prefills,
                    "rms_norm": (2 * cfg.layers + 1) * calls,
                    "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
            if got != want:
                fail(f"serve_spec {lane} launches {got}, expected {want} "
                     f"({calls} model calls, {prefills} prefills)")
            launches[lane] = got
            for n in prompts:
                per[n]["vs_vanilla"] = token_check(
                    torch, lm.model, prompts[n], per[n]["tokens"],
                    vanilla[n][0], f"serve_spec {lane} {n} spec vs vanilla",
                    (eng or lms["batched"].engine).buckets)
            out["lanes"][lane] = {"model_calls": calls, "prefills": prefills,
                                  "launches": got, "expected_launches": want,
                                  "requests": per}
    finally:
        for k in lms:
            httpds[k].shutdown()
            httpds[k].server_close()
            lms[k].close()
    b, f = out["lanes"]["batched"], out["lanes"]["single_flight"]
    out["batched_vs_single_flight"] = {n: token_check(
        torch, lms["single_flight"].model, prompts[n],
        b["requests"][n]["tokens"], f["requests"][n]["tokens"],
        f"serve_spec {n}: batched vs single-flight spec",
        lms["batched"].engine.buckets) for n in prompts}
    for lane in out["lanes"].values():
        for r in lane["requests"].values():
            r.pop("tokens")
    emit(out)
    REPORT["serve_spec"] = out
    return launches


def beam_llama(torch, tlib, decode, common, sd):
    """Beam search at the served width on the served weights: beam 1 on a
    random 509-token prompt must equal greedy (the same single-row decode
    path); then beam 4 with ``max_memory_allocated`` taken over it (the
    dense cache repeated to 4 rows, 131,072 B a token x 8192 slots a row,
    gathered by parent beam every step).  K1 must show 2·32+1 launches a
    model call and K2 32 a prefill, over both beam runs."""
    cfg = dataclasses.replace(tlib.llama_8b(), use_flash_attention=True,
                              use_fused_norm=True, dtype=torch.bfloat16)
    model = tlib.Transformer(cfg, sd, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (1, 509),
                           generator=torch.Generator().manual_seed(7)).cuda()
    new = 32
    greedy = decode.make_generate_fn(cfg, new)(model, prompt)[0].tolist()
    common.reset_launches()
    with ModelCalls(tlib) as mc:
        b1, s1 = decode.make_beam_generate_fn(cfg, new, beam_size=1)(
            model, prompt)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        b4, s4 = decode.make_beam_generate_fn(cfg, new, beam_size=4)(
            model, prompt)
        torch.cuda.synchronize()
        beam4_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    launches = common.launches()
    want = {"flash_fwd": cfg.layers * mc.by_mode["prefill"],
            "rms_norm": (2 * cfg.layers + 1) * mc.total,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    if launches != want or mc.total != 2 * new:
        fail(f"beam launches {launches}, expected {want} ({mc.by_mode})")
    if b1[0].tolist() != greedy:
        fail(f"beam 1 {b1[0].tolist()} differs from greedy {greedy}")
    b4 = b4[0].tolist()
    if len(b4) != new or not all(0 <= t < cfg.vocab_size for t in b4) or \
            not all(math.isfinite(float(x)) for x in (s1[0], s4[0])):
        fail(f"beam 4 tokens {b4}, scores {s1.tolist()} {s4.tolist()}")
    rec = {"phase": "beam", "card": REPORT["card"],
           "config": "llama_8b bf16 flash+fused", "prompt_len": 509,
           "new_tokens": new, "beam1_equals_greedy": True,
           "beam1_score": float(s1[0]), "beam4_score": float(s4[0]),
           "beam4_s": beam4_s,
           "memory_allocated_before_gib": base / 2 ** 30,
           "beam4_max_memory_allocated_gib": peak / 2 ** 30,
           "beam4_peak_over_before_gib": (peak - base) / 2 ** 30,
           "model_calls": mc.by_mode, "launches": launches,
           "expected_launches": want}
    emit(rec)
    REPORT["beam"] = rec
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


class Messages(logging.Handler):
    """Collects the messages of the loggers it is added to."""

    def __init__(self):
        super().__init__()
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def serve_lm_runs(torch, tlib, common, train_dir, cfg) -> dict:
    """``python -m k8s_tpu_torch.serve_lm`` on the exported artifact, run
    in this process (``runpy``, as ``-m`` runs it) so its launches can be
    counted: ``--beam 4``, ``--chunked_prefill`` and ``--speculative 4``
    on a 32-token prompt, 16 new tokens each.  Each run's counters are
    zeroed just before and read just after: K2 must show one launch per
    layer per prefill-mode call (none under chunked prefill, which streams
    the prompt through decode-mode chunks), K1 2·layers+1 per model call
    when the artifact turns it on (gpt2-small does not)."""
    import contextlib
    import io
    import runpy

    prompt = ",".join(str(t) for t in list(range(101, 117)) * 2)
    handler = Messages()
    logs = handler.lines
    logging.getLogger("serve_lm").addHandler(handler)
    out = {}
    try:
        for mode, extra in (("beam", ["--beam", "4"]),
                            ("chunked_prefill", ["--chunked_prefill"]),
                            ("speculative", ["--speculative", "4"])):
            argv = ["serve_lm", f"--train_dir={train_dir}",
                    f"--tokens={prompt}", "--max_new_tokens=16",
                    "--device=cuda", *extra]
            saved, sys.argv, buf = sys.argv, argv, io.StringIO()
            logs.clear()
            common.reset_launches()
            t0 = time.perf_counter()
            try:
                with ModelCalls(tlib) as mc, contextlib.redirect_stdout(buf):
                    runpy.run_module("k8s_tpu_torch.serve_lm",
                                     run_name="__main__", alter_sys=True)
            except SystemExit as e:
                if e.code not in (0, None):
                    fail(f"serve_lm {mode} exited {e.code}")
            finally:
                sys.argv = saved
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = common.launches()
            want = {"flash_fwd": cfg.layers * mc.by_mode["prefill"],
                    "rms_norm": (2 * cfg.layers + 1) * mc.total
                    if cfg.use_fused_norm else 0,
                    "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
            toks = [int(t) for t in buf.getvalue().split()[-1].split(",")]
            if launches != want or len(toks) != 16 or \
                    not all(0 <= t < cfg.vocab_size for t in toks):
                fail(f"serve_lm {mode}: tokens {toks}, launches {launches} "
                     f"(expected {want}, calls {mc.by_mode})")
            if mode == "chunked_prefill" and mc.by_mode["prefill"]:
                fail(f"serve_lm --chunked_prefill ran {mc.by_mode}")
            out[mode] = {"seconds": secs, "tokens": toks,
                         "model_calls": dict(mc.by_mode),
                         "launches": launches, "log": list(logs)}
    finally:
        logging.getLogger("serve_lm").removeHandler(handler)
    spec = out["speculative"]
    calls = sum(spec["model_calls"].values())
    line = next((m for m in spec["log"] if m.startswith("speculative: ")),
                "")
    if not line.endswith(f" over {calls} calls"):
        fail(f"serve_lm --speculative logged {line!r} for {calls} model "
             "calls")
    return out


def train_main_path(torch, train_lm, server, serving, common, tlib):
    """train_lm.main at the gpt2-small preset, full width and depth.  The
    step time is read from the per-step metrics records (each written
    after a host sync on that step's loss), leaving out warm-up and the
    steps that saved a checkpoint.  The exported artifact then serves
    through the server and through ``serve_lm`` (``serve_lm_runs``)."""
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
        lm_runs = serve_lm_runs(torch, tlib, common, train_dir, cfg)
        # the export mesh_nccl serves later, after this directory is gone
        KEPT["gpt2_export"] = tempfile.mkdtemp(prefix="gpt2_export_")
        shutil.copytree(os.path.join(train_dir, "serving"),
                        os.path.join(KEPT["gpt2_export"], "serving"))
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
    rec = {"phase": "serve_lm", "config": "gpt2-small artifact of train",
           **lm_runs}
    emit(rec)
    REPORT["serve_lm"] = rec
    return launches, {mode: r["launches"] for mode, r in lm_runs.items()}


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


# -- phase 6b: head_dims other than 64 and 128 at full width ------------------


def head_dim_configs(tlib) -> dict:
    """The attention and MLP widths of two public models with head_dims
    the Llama presets lack, on the repo's Llama-architecture Transformer
    (SwiGLU, RMSNorm, RoPE, tied head): their shapes, not their weights.
    Phi-3-mini-4k-instruct (config.json: hidden 3072, intermediate 8192,
    32 layers, 32 heads and kv heads, head_dim 3072 / 32 = 96, vocab
    32064) runs D 96 on the D-128 wgmma body; Gemma-7B (config.json:
    hidden 3072, intermediate 24576, 28 layers, 16 heads and kv heads,
    head_dim 256, so heads x D = 4096 != hidden, vocab 256000) runs the
    Dp-256 body."""
    base = tlib.TransformerConfig
    return {
        "phi3_mini_d96": base(vocab_size=32064, hidden=3072, ffn_hidden=8192,
                              layers=32, heads=32, kv_heads=32, head_dim=96,
                              max_seq_len=4096, rope_theta=10000.0),
        "gemma_7b_d256": base(vocab_size=256000, hidden=3072,
                              ffn_hidden=24576, layers=28, heads=16,
                              kv_heads=16, head_dim=256, max_seq_len=8192,
                              rope_theta=10000.0)}


# the training cut of each: 2 layers, and the batch each trains on
HEAD_DIM_TRAIN = {"phi3_mini_d96": (2, 2048), "gemma_7b_d256": (1, 4096)}
HEAD_DIM_PROMPT, HEAD_DIM_NEW = 509, 32


def head_dim_serve(torch, tlib, bridge, server, common, decode, cfg, seed):
    """Single-flight serving at full depth over HTTP (the lane whose
    prefill runs K2): one 509-token prompt, 32 greedy tokens; exact K1 and
    K2 launches; the tokens against the plain path's on the same weights
    (``token_check``)."""
    cfg = dataclasses.replace(cfg, use_flash_attention=True,
                              use_fused_norm=True, dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = bridge.init_params(cfg, seed=seed, device="cuda")
    lm = server.LmServer(config=cfg, params=params, slots=0, device="cuda",
                         default_max_new_tokens=HEAD_DIM_NEW)
    del params
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    httpd = server.serve(lm, "127.0.0.1", 0)
    url = "http://%s:%d" % httpd.server_address[:2]
    prompt = torch.randint(0, cfg.vocab_size, (HEAD_DIM_PROMPT,),
                           generator=torch.Generator().manual_seed(seed)
                           ).tolist()
    try:
        common.reset_launches()
        code, body, secs = http(url + "/v1/generate", dict(
            tokens=prompt, max_new_tokens=HEAD_DIM_NEW))
        torch.cuda.synchronize()
        launches = common.launches()
    finally:
        httpd.shutdown()
        httpd.server_close()
        lm.close()
    toks = body.get("tokens")
    if code != 200 or not isinstance(toks, list) or \
            len(toks) != HEAD_DIM_NEW or \
            not all(0 <= t < cfg.vocab_size for t in toks):
        fail(f"head_dims {cfg.head_dim} serve: {code} {str(body)[:300]}")
    want = {"flash_fwd": cfg.layers,
            "rms_norm": (2 * cfg.layers + 1) * HEAD_DIM_NEW,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    if launches != want:
        fail(f"head_dims {cfg.head_dim} serve launches {launches}, expected "
             f"{want}")
    ref_cfg = dataclasses.replace(cfg, use_flash_attention=False,
                                  use_fused_norm=False)
    plain = decode.generate(ref_cfg, lm.model.state_dict(), [prompt],
                            HEAD_DIM_NEW, device="cuda")[0].tolist()
    check = token_check(torch, lm.model, prompt, toks, plain,
                        f"head_dims {cfg.head_dim} serve vs plain",
                        decode.prefill_buckets_for(cfg))
    rec = {"prompt_len": HEAD_DIM_PROMPT, "new_tokens": HEAD_DIM_NEW,
           "seconds": secs, "setup_s": setup_s, "launches": launches,
           "expected_launches": want, "vs_plain": check,
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2 ** 30}
    del lm
    return rec, launches


def head_dim_train(torch, tlib, bridge, train_lib, common, cfg, seed, B, L):
    """The ``models/train.py`` step at 2 layers (bf16, flash and RMSNorm
    kernels on, no remat) on one batch: exact K1-K4 launches for the step;
    its gradients (taken before the update) and loss against the same
    weights and batch through the plain attention, both held against the
    plain step in f32, by ``grads_at_width``'s bounds (kernels vs plain
    within 5e-2 a tensor, relative Frobenius; the kernels no further from
    f32 than twice the plain path's distance, or 1e-2; losses within
    1e-2)."""
    cfg = dataclasses.replace(cfg, layers=2, remat=False,
                              use_flash_attention=True, use_fused_norm=True,
                              dtype=torch.bfloat16)
    params = bridge.init_params(cfg, seed, "cuda", dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (B, L),
                           generator=torch.Generator().manual_seed(seed + 1)
                           ).cuda()
    grads, loss = {}, {}
    # the references first: the kernels' step updates the shared weights
    for name, kw in (("plain", {"use_flash_attention": False}),
                     ("f32", {"use_flash_attention": False,
                              "dtype": torch.float32})):
        model = tlib.Transformer(dataclasses.replace(cfg, **kw), params,
                                 device="cuda", trainable=True)
        lv = train_lib.lm_loss(model(tokens), tokens)
        lv.backward()
        loss[name] = lv.item()
        grads[name] = {n: p.grad for n, p in model.named_parameters()}
        del model, lv
    model = tlib.Transformer(cfg, params, device="cuda", trainable=True)
    opt = train_lib.default_optimizer(1e-4)
    state = train_lib.init_state(model, opt)
    step = train_lib.make_train_step(lambda m, x: m(x), train_lib.lm_loss,
                                     opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    common.reset_launches()
    t0 = time.perf_counter()
    state, lv = step(state, (tokens, tokens))
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = common.launches()
    loss["kernels"] = lv.item()
    grads["kernels"] = {n: p.grad for n, p in model.named_parameters()}
    want = {"flash_fwd": cfg.layers, "flash_bwd_dq": cfg.layers,
            "flash_bwd_dkv": cfg.layers, "rms_norm": 2 * cfg.layers + 1}
    if launches != want or not all(map(math.isfinite, loss.values())):
        fail(f"head_dims {cfg.head_dim} train launches {launches} (expected "
             f"{want}), losses {loss}")
    missing = [n for g in grads.values() for n, x in g.items() if x is None]
    if missing:
        fail(f"head_dims {cfg.head_dim} train left no gradient on {missing}")

    def rel(a, b):
        return {n: ((grads[a][n].float() - g.float()).norm()
                    / g.float().norm()).item() for n, g in grads[b].items()}

    k_p, k_f, p_f = rel("kernels", "plain"), rel("kernels", "f32"), \
        rel("plain", "f32")
    bad = [n for n in k_p if not (k_p[n] <= 5e-2
                                  and k_f[n] <= max(2 * p_f[n], 1e-2))]
    if bad or abs(loss["kernels"] - loss["plain"]) > 1e-2:
        n = (bad or [max(k_p, key=k_p.get)])[0]
        fail(f"head_dims {cfg.head_dim} grads: {n} kernels vs plain {k_p[n]},"
             f" vs f32 {k_f[n]} (plain vs f32 {p_f[n]}), losses {loss}")
    rec = {"batch": [B, L], "reduced": {"layers": [None, 2]},
           "losses": loss, "step_s": step_s, "launches": launches,
           "expected_launches": want, "tol_kernels_vs_plain": 5e-2,
           "max_rel_err_kernels_vs_plain": max(k_p.values()),
           "max_rel_err_kernels_vs_f32": max(k_f.values()),
           "max_rel_err_plain_vs_f32": max(p_f.values()),
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2 ** 30}
    del model, state, opt, step, grads, params
    return rec, launches


def head_dims(torch, tlib, bridge, server, train_lib, common, decode) -> dict:
    """Each configuration of ``head_dim_configs``: single-flight serving
    at full depth, then the 2-layer training step; returns each path's
    launches (the serve run's and the train step's, each counted from
    zero just before it and read just after, summed)."""
    paths = {}
    for i, (name, cfg) in enumerate(head_dim_configs(tlib).items()):
        serve, s_l = head_dim_serve(torch, tlib, bridge, server, common,
                                    decode, cfg, 40 + i)
        gc.collect()
        torch.cuda.empty_cache()
        B, L = HEAD_DIM_TRAIN[name]
        train, t_l = head_dim_train(torch, tlib, bridge, train_lib, common,
                                    cfg, 50 + i, B, L)
        train["reduced"]["layers"][0] = cfg.layers
        gc.collect()
        torch.cuda.empty_cache()
        launches = {k: s_l[k] + t_l[k] for k in s_l}
        rec = {"phase": "head_dims", "config": name,
               "widths": {k: getattr(cfg, k) for k in (
                   "vocab_size", "hidden", "ffn_hidden", "layers", "heads",
                   "kv_heads", "head_dim")},
               "serve": serve, "train": train, "launches": launches}
        emit(rec)
        REPORT.setdefault("head_dims", {})[name] = rec
        paths[f"head_dims_{name}"] = launches
    return paths


# -- phase 7: tracing, the MoE Transformer and the token-shard dataset --------


TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"
TRACE_PARENT = "00f067aa0ba902b7"
TRACEPARENT = f"00-{TRACE_ID}-{TRACE_PARENT}-01"


def trace_spans(url: str, trace_id: str = TRACE_ID) -> list[dict]:
    """Every span of ``trace_id`` in the server's ``/debug/traces``, as
    ``{"name", "parent", "attributes", "duration_ms"}`` with the parent's
    name (``<inbound>`` for the caller's span)."""
    code, body, _ = http(url + "/debug/traces?n=1000000")
    if code != 200:
        fail(f"/debug/traces answered {code}")

    def walk(node):
        yield node
        for c in node["children"]:
            yield from walk(c)
    spans = [s for t in body["traces"] for s in walk(t)]
    names = {s["span_id"]: s["name"] for s in spans}
    names[TRACE_PARENT] = "<inbound>"
    return [{"name": s["name"], "parent": names.get(s["parent_id"]),
             "attributes": s["attributes"], "duration_ms": s["duration_ms"]}
            for s in spans if s["trace_id"] == trace_id]


def need_spans(spans: list, pairs, what: str) -> None:
    have = {(s["name"], s["parent"]) for s in spans}
    missing = [p for p in pairs if p not in have]
    if missing:
        fail(f"{what}: trace {TRACE_ID} lacks {missing}; it holds "
             f"{sorted(have, key=str)}")


def traced_migration(trace, purl, dec, prompt, kv_dest, new, want):
    """One request through ``kv_dest`` under a caller's W3C traceparent,
    with tracing on for it alone: the prefill server's ``/debug/traces``
    must show ``serve_request`` under the caller's span and ``prefill`` and
    ``kv_migrate`` under it, the migrate frame must carry the trace id to
    the decode server's request recorder, and the tokens must equal the
    colocated answer ``want``.  Both servers trace through this process's
    one tracer."""
    trace.configure(sample_rate=1.0, exporter=trace.RingBufferExporter(4096))
    try:
        code, body, secs = http(
            purl + "/v1/generate",
            dict(tokens=prompt, max_new_tokens=new, kv_dest=kv_dest),
            headers={"traceparent": TRACEPARENT})
        spans = trace_spans(purl)
    finally:
        trace.configure(sample_rate=0.0, exporter=trace.RingBufferExporter())
    if code != 200 or body.get("tokens") != want:
        fail(f"traced migration answered {code} {str(body)[:200]}, the "
             f"colocated engine {want}")
    need_spans(spans, [("serve_request", "<inbound>"),
                       ("prefill", "serve_request"),
                       ("kv_migrate", "serve_request")], "disagg")
    seated = [r for r in dec.engine._reqlog.snapshot()
              if r.get("trace_id") == TRACE_ID and r["kind"] == "migrated"]
    if not seated:
        fail("disagg: the decode server's recorder has no request under "
             f"trace {TRACE_ID} (the migrate frame's trace_id)")
    return {"seconds": secs, "spans": spans,
            "decode_recorder_kinds": [r["kind"] for r in seated]}


def moe_config(tlib, torch, **kw):
    """Llama-3-8B's attention and vocabulary with Mixtral-8x7B's expert
    layout: 8 SwiGLU experts of 4096 -> 14336, top-2, capacity 1.25."""
    return dataclasses.replace(
        tlib.llama_8b(), num_experts=8, expert_top_k=2,
        expert_capacity_factor=1.25, use_flash_attention=True,
        use_fused_norm=True, dtype=torch.bfloat16, **kw)


class RouteStats:
    """While active, each MoE layer's routing of every call (with
    ``decode_rows``: of every decode call of that many rows, input
    ``[rows, 1, d]``) is recomputed from the layer's input (``moe.route``,
    the forward's own routing) and summed on the device: per-expert kept
    pairs and all pairs.  Off the timed paths: the hooks add device work
    and host launches."""

    def __init__(self, torch, moe, model, decode_rows=None):
        self.torch, self.moe, self.rows = torch, moe, decode_rows
        self.layers = [b.moe_mlp for b in model.layers]
        E = self.layers[0].num_experts
        dev = self.layers[0].router.device
        self.kept = torch.zeros(E, dtype=torch.long, device=dev)
        self.pairs = torch.zeros((), dtype=torch.long, device=dev)
        self.calls = 0

    def hook(self, layer, args):
        x = args[0]
        T = x.shape[0] * x.shape[1]
        if self.rows is not None and tuple(x.shape[:2]) != (self.rows, 1):
            return
        with self.torch.no_grad():
            _, _, idx, _, keep, _ = self.moe.route(
                x.reshape(T, -1), layer.router, layer.top_k,
                layer.capacity_factor)
            E = layer.num_experts
            self.kept += self.torch.bincount(idx[keep], minlength=E)
            self.pairs += keep.numel()
        self.calls += 1

    def __enter__(self):
        self.handles = [m.register_forward_pre_hook(self.hook)
                        for m in self.layers]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()

    def result(self) -> dict:
        kept = self.kept.tolist()
        pairs = int(self.pairs)
        return {"layer_calls": self.calls, "pairs": pairs,
                "kept_by_expert": kept,
                "dropped_share": (pairs - sum(kept)) / pairs if pairs
                else None}


def moe_parity(torch, tlib, bridge, decode, train_lib, moe):
    """The tiny MoE model (tiny_test with 4 experts, top-2, 2 layers, f32,
    both kernels on) on cuda (kernels) against cpu (plain versions) from
    the same parameters: greedy tokens equal, logits within 1e-4 in
    prefill and decode; the first batch's gradients (loss plus weighted
    aux, through ``make_moe_apply_fn``) agree per tensor within 1e-4 of
    its largest magnitude, and its per-expert kept pairs are equal; 3
    Adam steps give losses and aux losses within 1e-4 (train_parity's
    tolerance).  The parameters after them are held within 3 x lr: Adam's
    update g / (|g| + eps) is at most lr a step whatever g is, so a
    last-bit difference on a near-zero gradient moves a parameter by up
    to that (the gradient check is where a wrong kernel shows)."""
    cfg = dataclasses.replace(tlib.tiny_test(), num_experts=4,
                              expert_top_k=2, use_flash_attention=True,
                              use_fused_norm=True)
    params = bridge.init_params(cfg, seed=13, device="cpu")
    # the reference's router init, N(0, 0.02), routes near-uniformly:
    # widen it so the routing and its capacity drops vary by token
    params = {n: t * 50 if n.endswith(".router") else t
              for n, t in params.items()}
    prompt = torch.randint(0, cfg.vocab_size, (1, 37),
                           generator=torch.Generator().manual_seed(14))
    toks = {dev: decode.generate(cfg, params, prompt, 24, device=dev).cpu()
            for dev in ("cuda", "cpu")}
    if not torch.equal(toks["cuda"], toks["cpu"]):
        fail(f"tiny MoE greedy tokens differ: cuda {toks['cuda'].tolist()} "
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
        fail(f"tiny MoE logits cuda vs cpu differ by {max(errs)} (> 1e-4)")
    gen = torch.Generator().manual_seed(15)
    batches = [torch.randint(0, cfg.vocab_size, (4, 96), generator=gen)
               for _ in range(3)]
    losses, auxes, finals, kept, grads = {}, {}, {}, {}, {}
    for dev in ("cuda", "cpu"):
        model = tlib.Transformer(cfg, params, device=dev, trainable=True)
        opt = train_lib.default_optimizer(1e-3, clip_norm=1.0)
        state = train_lib.init_state(model, opt)
        apply = train_lib.make_moe_apply_fn(model)
        aux_log = []

        def apply_fn(m, x, apply=apply, aux_log=aux_log):
            logits, aux = apply(m, x)
            aux_log.append(aux.detach())
            return logits, aux
        step = train_lib.make_train_step(apply_fn, train_lib.lm_loss, opt)
        with RouteStats(torch, moe, model) as rs:
            b = batches[0].to(dev)
            train_lib._combined_loss(apply, train_lib.lm_loss, model,
                                     (b, b)).backward()
        kept[dev] = rs.result()
        grads[dev] = {n: p.grad.detach().cpu()
                      for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        aux_log.clear()
        out = []
        for b in batches:
            b = b.to(dev)
            state, loss = step(state, (b, b))
            out.append(loss)
        losses[dev] = torch.stack(out).tolist()
        auxes[dev] = torch.stack(aux_log).tolist()
        finals[dev] = {n: p.detach().cpu()
                       for n, p in model.named_parameters()}
    loss_err = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
    aux_err = max(abs(a - b) for a, b in zip(auxes["cuda"], auxes["cpu"]))
    param_errs = {n: (finals["cuda"][n] - finals["cpu"][n]).abs().max().item()
                  for n in finals["cpu"]}
    param_name = max(param_errs, key=param_errs.get)
    param_err = param_errs[param_name]
    grad_errs = {n: ((grads["cuda"][n] - g).abs().max()
                     / g.abs().max().clamp_min(1e-30)).item()
                 for n, g in grads["cpu"].items()}
    grad_name = max(grad_errs, key=grad_errs.get)
    if not (loss_err <= 1e-4 and aux_err <= 1e-4
            and grad_errs[grad_name] <= 1e-4 and param_err <= 3e-3) \
            or kept["cuda"]["kept_by_expert"] != \
            kept["cpu"]["kept_by_expert"]:
        fail(f"tiny MoE training cuda vs cpu: loss err {loss_err}, aux err "
             f"{aux_err} (tol 1e-4), grad rel err {grad_errs[grad_name]} "
             f"at {grad_name} (tol 1e-4), param err {param_err} at "
             f"{param_name} (tol 3e-3), kept {kept}")
    rec = {"phase": "moe_parity",
           "config": "tiny_test f32 flash+fused, 4 experts top-2",
           "prompt_len": 37, "new_tokens": 24, "tokens_equal": True,
           "logits_max_abs_err": max(errs), "steps": len(batches),
           "losses_cuda": losses["cuda"], "losses_cpu": losses["cpu"],
           "aux_cuda": auxes["cuda"], "aux_cpu": auxes["cpu"],
           "loss_max_abs_err": loss_err, "aux_max_abs_err": aux_err,
           "grad_max_rel_err": grad_errs[grad_name],
           "grad_max_rel_err_at": grad_name,
           "param_max_abs_err": param_err, "param_max_abs_err_at": param_name,
           "tol": 1e-4, "tol_params": 3e-3,
           "routing_first_batch": kept["cuda"]}
    emit(rec)
    REPORT["moe_parity"] = rec


# llama_8b's 32 layers cut to fit 8 bf16 experts a layer (20 until the
# whole script came to 860 s of the 1200)
MOE_SERVE_LAYERS = 10


def host_and_device_ms(torch, fn, n: int = 4) -> dict:
    """One call's host wall (``n`` calls from an idle stream, synchronized:
    issue and wait) and, from ``torch.profiler`` over ``n`` more, its
    device busy time (the sum of its kernels' device intervals) and
    kernel count, with the kernels that took the most device time.  A
    many-kernel call cannot be timed behind a spin kernel: the launch
    queue fills and the host blocks.  The profiler session comes last in
    the script: after one, host clocks in the process read slower
    (PERF.md §6)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    by_name: dict = {}
    for e in kernels:
        rec = by_name.setdefault(e.name[:80], [0, 0.0])
        rec[0] += 1
        rec[1] += e.time_range.elapsed_us() / 1e3 / n
    busy = sum(ms for _, ms in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"host_wall_ms": host_ms,
            "device_busy_ms": busy if kernels else None,
            "kernels_a_call": len(kernels) / n,
            "top": [{"name": k, "count": c // n, "ms": ms}
                    for k, (c, ms) in top]}


def moe_serve(torch, tlib, bridge, server, common, requestlog, moe, trace):
    """The MoE Transformer served at Llama-3-8B width with 8 experts, 10
    layers (``reduced``: 32 -> 10; 32 bf16 layers of experts are 92 GB),
    random bf16 weights drawn on the card, behind ``LmServer(slots=4,
    batch_sampling=False)`` with span tracing on: eight concurrent greedy
    requests (prompts 17-509, 32 new tokens), a repeat of the longest
    (a prefix hit: its first token equals the batch's, and a second
    repeat gives the same 32 tokens), then a fixed-seed sampled request
    twice (the exclusive lane: the single-flight program, K2 in its
    prefill; both answers equal).  Counters zeroed just before and read
    just after: K1 at 2·10+1 launches a model call (``ModelCalls``), K2
    10 a single-flight prefill.  Then a POST with a W3C traceparent whose
    trace ``/debug/traces`` shows (``serve_request`` under the caller,
    ``prefill`` under it) beside the ``decode_step`` spans; the share of
    (token, choice) pairs dropped at decode with 4 rows (C = 2 a call);
    the engine's step time with tracing at 0 and 1 in turns (off, on,
    on, off); a 4-row decode call's host wall against its device time
    (``host_and_device_ms``, a profiler session: this phase runs last);
    the single-flight prefill logits against the plain attention and
    norm on the same weights."""
    import threading

    cfg = moe_config(tlib, torch, layers=MOE_SERVE_LAYERS)
    os.environ["K8S_TPU_REQUEST_LOG"] = "1"
    requestlog.set_active(None)
    trace.configure(sample_rate=1.0,
                    exporter=trace.RingBufferExporter(1 << 16))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = bridge.init_params(cfg, seed=21, device="cuda")
    lm = server.LmServer(config=cfg, params=params, slots=4, device="cuda",
                         batch_sampling=False, default_max_new_tokens=32)
    del params
    eng = lm.engine
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    weights_gib = sum(t.numel() * t.element_size()
                      for t in lm.model.state_dict().values()) / 2 ** 30
    pool_gib = sum(t.numel() * t.element_size() for node in eng._pool
                   for t in node.values()) / 2 ** 30
    httpd = server.serve(lm, "127.0.0.1", 0)
    url = "http://%s:%d" % httpd.server_address[:2]
    rng = torch.Generator().manual_seed(22)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()

    def post(p, new, headers=None, **extra):
        code, body, secs = http(url + "/v1/generate", dict(
            tokens=p, max_new_tokens=new, **extra), headers=headers)
        toks = body.get("tokens")
        if code != 200 or not isinstance(toks, list) or len(toks) != new \
                or not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"moe request ({len(p)} tokens): {code} {str(body)[:300]}")
        return toks, secs

    def step_mean_s(st0, st1, h0, h1):
        """Mean host wall of an engine decode iteration between two
        stats/histogram readings (a fused step of k counts k)."""
        iters = st1["steps"] - st0["steps"]
        return (h1[0] - h0[0]) / iters if iters else None

    def hist():
        h = lm.metrics["step_duration"]._default_child()
        return h.total, h.count

    try:
        post(prompt(33), 4)  # warm-up: allocator, cuBLAS handles
        prompts = {n: prompt(n) for n in (17, 64, 128, 509)}
        batch = [n for n in (17, 64, 128, 509) for _ in range(2)]
        sampled = {"temperature": 0.8, "top_k": 50, "seed": 7}
        st0 = eng.stats()
        # the main path's run: counters zeroed just before, read just after
        common.reset_launches()
        results: dict = {}
        with ModelCalls(tlib) as mc:
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
                fail(f"moe batch: {len(results)} of {len(batch)} answered")
            st1 = eng.stats()
            code_r, reqs, _ = http(url + "/debug/requests?n=64")
            again = [post(prompts[509], 32) for _ in range(2)]
            st2 = eng.stats()
            single = [post(prompts[64], 32, **sampled) for _ in range(2)]
            torch.cuda.synchronize()
            launches = common.launches()
        calls = dict(mc.by_mode)
        want = {"flash_fwd": cfg.layers * calls["prefill"],
                "rms_norm": (2 * cfg.layers + 1) * mc.total,
                "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        engine_calls = st2["model_calls"] - st0["model_calls"]
        if launches != want or calls["prefill"] != 2 or calls["train"] or \
                calls["decode"] < engine_calls:
            fail(f"moe_serve launches {launches}, expected {want} (model "
                 f"calls {calls}, engine {engine_calls})")
        hits = st2["prefix_hits"] - st1["prefix_hits"]
        saved = st2["prefix_tokens_saved"] - st1["prefix_tokens_saved"]
        firsts = {results[i][0][0] for i, n in enumerate(batch) if n == 509}
        if hits != 2 or saved < 2 * 496 or again[0][0] != again[1][0] or \
                firsts != {again[0][0][0]}:
            fail(f"moe 509-token repeats: prefix hits +{hits}, tokens "
                 f"saved +{saved}, first tokens {firsts} / "
                 f"{[a[0][0] for a in again]}, answers equal "
                 f"{again[0][0] == again[1][0]}")
        if single[0][0] != single[1][0]:
            fail("moe: the repeated sampled single-flight request (seed 7) "
                 f"gave {single[0][0]} and {single[1][0]}")

        # the trace join: caller -> ingress -> engine
        traced, traced_s = post(prompts[128], 8,
                                headers={"traceparent": TRACEPARENT})
        spans = trace_spans(url)
        need_spans(spans, [("serve_request", "<inbound>"),
                           ("prefill", "serve_request")], "moe_serve")
        code_t, tbody, _ = http(url + "/debug/traces?n=1000000")
        steps = [t for t in tbody["traces"] if t["name"] == "decode_step"]
        if not steps:
            fail("moe_serve: /debug/traces holds no decode_step span")
        step_spans_ms = sorted(t["duration_ms"] for t in steps)

        # routing at decode, 4 rows a call: C = ceil(2·4/8·1.25) = 2
        with RouteStats(torch, moe, lm.model, decode_rows=4) as rs:
            got: dict = {}
            threads = [threading.Thread(
                target=lambda i=i: got.__setitem__(
                    i, post(prompt(64), 32))) for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
        routing = rs.result()

        # step time with tracing at 0 and 1, in turns
        turns = []
        for rate in (0.0, 1.0, 1.0, 0.0):
            trace.configure(sample_rate=rate)
            s0, h0 = eng.stats(), hist()
            done: dict = {}
            threads = [threading.Thread(
                target=lambda i=i: done.__setitem__(
                    i, post(prompt(64), 24))) for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            turns.append({"sample_rate": rate,
                          "step_s": step_mean_s(s0, eng.stats(), h0, hist()),
                          "iterations": eng.stats()["steps"]
                          - s0["steps"]})
        trace.configure(sample_rate=1.0)
        code, health, _ = http(url + "/healthz")
        st3 = eng.stats()
        eng.debug_check_blocks()
    finally:
        httpd.shutdown()
        httpd.server_close()
        lm.close()
        trace.configure(sample_rate=0.0, exporter=trace.RingBufferExporter())
    peak = torch.cuda.max_memory_allocated()

    # one 4-row decode call at a 509-token context (dense cache), device
    # time against host wall
    with torch.inference_mode():
        cache = lm.model.new_cache()
        ctx = torch.tensor([prompts[509]] * 4, device="cuda")
        lm.model(ctx, mode="prefill", cache=cache)
        tok = torch.zeros(4, 1, dtype=torch.long, device="cuda")
        pos = torch.full((4, 1), 509, device="cuda")
        step_call = host_and_device_ms(torch, lambda: lm.model(
            tok, positions=pos, mode="decode", cache=cache))
        del cache
    torch.cuda.empty_cache()
    expert_bytes = 3 * cfg.num_experts * cfg.hidden * cfg.ffn_hidden * 2 \
        * cfg.layers
    step_call["bound_ms_expert_bytes"] = expert_bytes / PEAK_BYTES * 1e3
    moe_against_plain(torch, tlib, lm, prompts)
    emitted = sum(len(toks) - 1 for toks, _ in results.values())
    ttft = {}
    for r in reqs["requests"]:
        if r.get("ttft_s") is not None and r["prompt_len"] in prompts:
            ttft.setdefault(str(r["prompt_len"]), []).append(r["ttft_s"])
    rec = {"phase": "moe_serve", "card": REPORT["card"],
           "config": "llama_8b width + 8 experts top-2 cf 1.25 (Mixtral "
                     "8x7B layout), bf16 flash+fused, LmServer(slots=4, "
                     "batch_sampling=False), tracing on",
           "layers": cfg.layers, "reduced": {"layers": [32, cfg.layers]},
           "setup_s": setup_s, "weights_gib": weights_gib,
           "pool_gib": pool_gib, "pool_blocks": st3["pool_blocks"],
           "max_memory_allocated_gib": peak / 2 ** 30,
           "batch": {"prompt_lens": batch, "new_tokens": 32,
                     "wall_s": batch_s, "decode_tokens": emitted,
                     "decode_tokens_per_s": emitted / batch_s,
                     "client_s": {str(i): results[i][1]
                                  for i in range(len(batch))}},
           "ttft_s_by_prompt_len": ttft,
           "peak_active": st1["peak_active"],
           "repeat_509": {"prefix_hits_delta": hits,
                          "prefix_tokens_saved_delta": saved,
                          "seconds": [a[1] for a in again],
                          "first_token_equal_batch": True,
                          "answers_equal": True},
           "single_flight_sampled": {"seconds": [x[1] for x in single],
                                     "identical": True},
           "trace": {"trace_id": TRACE_ID, "spans": spans,
                     "request_s": traced_s, "tokens": traced,
                     "decode_step_spans": len(steps),
                     "decode_step_ms_median":
                         step_spans_ms[len(step_spans_ms) // 2]},
           "decode_routing_4_rows": routing,
           "step_time_tracing_turns": turns,
           "decode_call_4_rows_509": step_call,
           "model_calls": calls, "engine_model_calls": engine_calls,
           "launches": launches, "expected_launches": want,
           "healthz": code,
           "stats": {k: v for k, v in st3.items()
                     if k != "occupancy_timeline"}}
    emit(rec)
    REPORT["moe_serve"] = rec
    requestlog.set_active(None)
    os.environ.pop("K8S_TPU_REQUEST_LOG", None)
    return launches


def moe_against_plain(torch, tlib, lm, prompts):
    """The served MoE model's single-flight prefill against the same
    weights through the plain attention and norm.  Routing is discrete:
    a bf16 difference that moves a near-tie across the top-k or capacity
    line sends a token to another expert, and the last layers' logits
    then differ by order one for that token, so the final logits are
    reported, not held.  Held (5e-2 of its largest value, as
    ``check_against_plain``): the first MoE layer's input, which the
    flash and RMSNorm kernels produce before any routing."""
    ref_cfg = dataclasses.replace(lm.config, use_flash_attention=False,
                                  use_fused_norm=False)
    ref = tlib.Transformer(ref_cfg, lm.model.state_dict(), device="cuda")
    seen: dict = {}

    def grab(key):
        def hook(layer, args):
            seen[key] = args[0].float()
        return hook
    handles = [m.layers[0].moe_mlp.register_forward_pre_hook(grab(k))
               for k, m in (("kernels", lm.model), ("plain", ref))]
    out = {}
    try:
        with torch.inference_mode():
            for n in (17, 509):
                toks = torch.tensor([prompts[n]], device="cuda")
                a = lm.model(toks, mode="prefill", cache=lm.model.new_cache())
                b = ref(toks, mode="prefill", cache=ref.new_cache())
                if not bool(torch.isfinite(a).all()):
                    fail(f"MoE prefill logits non-finite at length {n}")
                x, y = seen["kernels"], seen["plain"]
                rel_in = ((x - y).abs().max() / y.abs().max()).item()
                if rel_in > 5e-2:
                    fail(f"MoE layer-0 input vs plain path at length {n}: "
                         f"rel err {rel_in} (> 5e-2)")
                out[n] = {
                    "moe_input_rel_err": rel_in,
                    "logits_rel_err": ((a - b).abs().max()
                                       / b.abs().max()).item(),
                    "argmax_agreement": (a.argmax(-1) == b.argmax(-1))
                    .float().mean().item()}
    finally:
        for h in handles:
            h.remove()
    rec = {"phase": "moe_serve_vs_plain", "prompt_lens": out,
           "tol_rel_moe_input": 5e-2}
    emit(rec)
    REPORT["moe_serve_vs_plain"] = rec


def corpus_text(n_bytes: int, seed: int) -> list[str]:
    """Byte-tokenizable text from a seed: sentences over a fixed word
    list, about ``n_bytes`` long (no download)."""
    import random

    words = ("the operator schedules a gang of pods across slices and "
             "restarts every replica when one exits with a retryable code "
             "while the trainer resumes from its latest checkpoint").split()
    r = random.Random(seed)
    out, size = [], 0
    while size < n_bytes:
        line = " ".join(r.choice(words) for _ in range(r.randint(6, 18)))
        line = line.capitalize() + ".\n"
        out.append(line)
        size += len(line)
    return out


def moe_train(torch, tlib, bridge, train_lib, common, dataset, moe):
    """The MoE Transformer at Llama-3-8B width with 8 experts cut to 2
    layers (``reduced``: 32 -> 2: f32 masters, gradients and two Adam
    moments are 16 B a parameter, 23 GB a layer), B1 L2048, bf16, flash
    and RMSNorm kernels on, no remat, 3 Adam steps through
    ``make_moe_apply_fn``, its batches read by ``TokenDataset`` from a
    corpus ``write_text_corpus`` wrote into a temporary directory.  Exact
    launch counts: K1 2·2+1, K2-K4 2 a step."""
    steps, L = 3, 2048
    cfg = moe_config(tlib, torch, layers=2, remat=False)
    with tempfile.TemporaryDirectory() as d:
        dataset.write_text_corpus(d, corpus_text(steps * L + 4096, 31),
                                  shard_tokens=1 << 16)
        ds = dataset.TokenDataset(d)
        stream = ds.batches(1, L, seed=0)
        batches = [torch.from_numpy(next(stream)[0]).cuda()
                   for _ in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = tlib.Transformer(
        cfg, bridge.init_params(cfg, 23, "cuda", dtype=torch.float32),
        device="cuda", trainable=True)
    n_params = sum(p.numel() for p in model.parameters())
    opt = train_lib.default_optimizer(1e-4)
    state = train_lib.init_state(model, opt)
    apply = train_lib.make_moe_apply_fn(model)
    aux_log = []

    def apply_fn(m, x):
        logits, aux = apply(m, x)
        aux_log.append(aux.detach())
        return logits, aux
    step = train_lib.make_train_step(apply_fn, train_lib.lm_loss, opt)
    torch.cuda.synchronize()
    common.reset_launches()
    times, losses = [], []
    for b in batches:
        t0 = time.perf_counter()
        losses.append(step(state, (b, b))[1])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = common.launches()
    losses = torch.stack(losses).tolist()
    auxes = torch.stack(aux_log).tolist()
    want = {"flash_fwd": cfg.layers * steps,
            "flash_bwd_dq": cfg.layers * steps,
            "flash_bwd_dkv": cfg.layers * steps,
            "rms_norm": (2 * cfg.layers + 1) * steps}
    if launches != want or not all(map(math.isfinite, losses + auxes)):
        fail(f"moe training: launches {launches} (expected {want}), "
             f"losses {losses}, aux {auxes}")
    with RouteStats(torch, moe, model) as rs, torch.no_grad():
        model(batches[0])
    rec = {"phase": "moe_train", "card": REPORT["card"],
           "config": "llama_8b width + 8 experts top-2 cf 1.25, layers "
                     "32 -> 2, bf16 over f32 masters, flash+fused, "
                     "make_moe_apply_fn, TokenDataset batches",
           "reduced": {"layers": [32, 2]}, "batch": [1, L],
           "params": n_params, "steps": steps, "losses": losses,
           "aux_weighted": auxes, "step_s": times,
           "tokens_per_s_last": L / times[-1],
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2 ** 30,
           "routing_first_batch": rs.result(),
           "launches": launches, "expected_launches": want}
    emit(rec)
    REPORT["moe_train"] = rec
    del model, state, opt
    gc.collect()
    torch.cuda.empty_cache()
    return launches


DATA_ARGS = ["--preset", "gpt2-small", "--batch_size", "8", "--seq_len",
             "1024", "--eval_every", "3", "--eval_batches", "2",
             "--log_every", "1", "--device", "cuda"]


def readahead_bound(consumed: int, streams: int, B: int = 8) -> int:
    """The most windows a ``train_lm`` run's readers can deliver: the
    windows its steps and evals consumed, plus, on each of its ``streams``
    (the training stream and one for each eval), what the prefetch stage
    read ahead: its 2 queued batches, the one it holds and the one it draws
    before it sees the stop."""
    return consumed + streams * 4 * B


def data_path(torch, train_lm, common, dataset, native_dl):
    """``train_lm.main`` at gpt2-small (full width and depth) reading a
    token-shard corpus through ``--data_dir`` (``write_text_corpus`` into
    a temporary directory, ~600 KB of byte-tokenized text): 6 steps,
    checkpoints every 3, a held-out eval every 3.  Exact launch counts
    (K2 a layer per forward, training and eval; K3, K4 a layer per step).
    The windows come through the native reader (``reader="auto"``): its
    counter covers the windows the run consumed, and at most the prefetch
    stage's read-ahead more (``readahead_bound``).
    Then a second run stops at step 3 and a third resumes it to 6: the
    resumed run's step 4-6 losses equal the uninterrupted run's (within
    1e-4: the same windows through the same deterministic kernels; a
    resume at the wrong window moves the loss by ~1e-2)."""
    steps = 6
    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, "data")
        man = dataset.write_text_corpus(data, corpus_text(600_000, 41),
                                        shard_tokens=1 << 17)
        runs = {}
        for name, plan in (("full", [steps]), ("resumed", [3, steps])):
            train_dir = os.path.join(root, name)
            for n in plan:
                args = DATA_ARGS + ["--data_dir", data, "--train_dir",
                                    train_dir, "--train_steps", str(n),
                                    "--checkpoint_every", "3"]
                if name == "full":
                    torch.cuda.reset_peak_memory_stats()
                    common.reset_launches()
                    native_dl.reset_delivered()
                t0 = time.perf_counter()
                rc = train_lm.main(args)
                torch.cuda.synchronize()
                if name == "full":
                    launches = common.launches()
                    delivered = native_dl.delivered()
                    wall_s = time.perf_counter() - t0
                    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
                if rc != 0:
                    fail(f"train_lm --data_dir ({name}, {n} steps) exited "
                         f"{rc}")
            with open(os.path.join(train_dir, "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            wall = [r["wall_time"] for r in recs if "loss" in r]
            runs[name] = {
                "loss": {r["step"]: r["loss"] for r in recs if "loss" in r},
                "eval": [(r["step"], r["eval_loss"]) for r in recs
                         if "eval_loss" in r],
                # between consecutive step records, in step order: one
                # holds the warm-up, one the eval, one the checkpoint save
                "step_s": [b - a for a, b in zip(wall, wall[1:])]}
    full, res = runs["full"], runs["resumed"]
    evals = len(full["eval"])
    layers = 12
    want = {"flash_fwd": layers * (steps + 2 * evals),
            "flash_bwd_dq": layers * steps, "flash_bwd_dkv": layers * steps,
            "rms_norm": 0}
    if launches != want or sorted(full["loss"]) != list(range(1, steps + 1)):
        fail(f"data path launches {launches} (expected {want}, {evals} "
             f"evals), steps {sorted(full['loss'])}")
    consumed = 8 * (steps + 2 * evals)
    most = readahead_bound(consumed, 1 + evals)
    if not consumed <= delivered <= most:
        fail(f"data path: the native reader delivered {delivered} windows, "
             f"the run consumed {consumed} (at most {most} with the "
             "read-ahead): another reader fed it")
    diffs = {s: abs(res["loss"][s] - full["loss"][s])
             for s in range(4, steps + 1)}
    if sorted(res["loss"]) != list(range(1, steps + 1)) or \
            max(diffs.values()) > 1e-4:
        fail(f"data resume: losses {res['loss']} against the uninterrupted "
             f"{full['loss']} (tol 1e-4)")
    rec = {"phase": "data", "card": REPORT["card"],
           "config": "gpt2-small bf16 flash, train_lm.main --data_dir",
           "args": DATA_ARGS, "corpus_tokens": man["total_tokens"],
           "shards": len(man["shards"]), "steps": steps, "wall_s": wall_s,
           "step_s": full["step_s"],
           # the two shortest intervals: the ones holding neither the
           # warm-up, the eval nor the checkpoint save
           "tokens_per_s_shortest_2": 2 * 8 * 1024
           / sum(sorted(full["step_s"])[:2]),
           "losses": full["loss"], "eval_losses": full["eval"],
           "resumed_losses": res["loss"], "resume_abs_diff": diffs,
           "resume_tol": 1e-4, "max_memory_allocated_gib": peak_gib,
           "native_windows": {"delivered": delivered, "consumed": consumed,
                              "most": most},
           "launches": launches, "expected_launches": want}
    emit(rec)
    REPORT["data"] = rec
    return launches


# -- the native window reader and the profiler hooks -------------------------


CORPUS_SEED = 15
CORPUS_TOKENS = 512 << 20   # uint16: 1 GiB on disk
CORPUS_SHARD = 8 << 20      # 64 shards of 16 MiB
GPT2_VOCAB = 32000          # the gpt2-small preset's vocabulary
READ_WINDOWS, READ_L = 20_000, 1024


def write_corpus(dataset, root: str) -> tuple[str, dict, float]:
    """512M uint16 tokens drawn from CORPUS_SEED below gpt2-small's
    vocabulary, written by ``write_token_shards`` as 64 checksummed
    shards (~2 GiB of host memory at the peak: the draw and the writer's
    cast).  Returns the directory, the manifest and the seconds."""
    import numpy as np

    t0 = time.perf_counter()
    data = os.path.join(root, "corpus")
    toks = np.random.default_rng(CORPUS_SEED).integers(
        0, GPT2_VOCAB, CORPUS_TOKENS, dtype=np.uint16)
    man = dataset.write_token_shards(data, toks, shard_tokens=CORPUS_SHARD,
                                     vocab_size=GPT2_VOCAB)
    del toks
    return data, man, time.perf_counter() - t0


def read_windows(dataset, native_dl, data: str, reader: str) -> dict:
    """The first READ_WINDOWS shuffled windows of READ_L tokens through
    ``reader`` (checksums off: hashing is not the reader's work; the
    shards sit in the page cache, just written)."""
    import numpy as np

    ds = dataset.TokenDataset(data, verify=False)
    out = np.empty((READ_WINDOWS, READ_L), np.int32)
    native_dl.reset_delivered()
    t0 = time.perf_counter()
    it = ds.sequences(READ_L, shuffle=True, seed=CORPUS_SEED, reader=reader)
    for i in range(READ_WINDOWS):
        out[i] = next(it)
    it.close()
    s = time.perf_counter() - t0
    itemsize = np.dtype(ds.manifest["dtype"]).itemsize
    return {"reader": reader, "s": s, "windows_per_s": READ_WINDOWS / s,
            "MB_per_s": READ_WINDOWS * READ_L * itemsize / s / 1e6,
            "delivered": native_dl.delivered(), "windows": out}


def train_on(torch, train_lm, common, native_dl, data: str, metrics: str,
             extra: list, native: bool) -> dict:
    """One ``train_lm.main --data_dir`` run at gpt2-small (DATA_ARGS, 6
    steps, eval every 3, no checkpoints) with the reader ``"auto"`` picks,
    native or (``K8S_TPU_NATIVE=0``) mmap; its losses, step intervals,
    launches, windows the native reader delivered and peak memory."""
    args = DATA_ARGS + ["--data_dir", data, "--train_dir", "",
                        "--metrics_path", metrics, "--train_steps", "6",
                        *extra]
    if not native:
        os.environ["K8S_TPU_NATIVE"] = "0"
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        common.reset_launches()
        native_dl.reset_delivered()
        t0 = time.perf_counter()
        rc = train_lm.main(args)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = common.launches()
        delivered = native_dl.delivered()
    finally:
        os.environ.pop("K8S_TPU_NATIVE", None)
    if rc != 0:
        fail(f"native_reader: train_lm {extra} exited {rc}")
    with open(metrics) as f:
        recs = [json.loads(line) for line in f]
    wall = [r["wall_time"] for r in recs if "loss" in r]
    return {"args": extra, "reader": "native" if native else "mmap",
            "loss": {r["step"]: r["loss"] for r in recs if "loss" in r},
            "eval": [(r["step"], r["eval_loss"]) for r in recs
                     if "eval_loss" in r],
            "step_s": [b - a for a, b in zip(wall, wall[1:])],
            "wall_s": wall_s, "launches": launches, "delivered": delivered,
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2 ** 30}


def native_reader(torch, train_lm, common, dataset, native_dl, root: str,
                  corpus: tuple):
    """The native window reader on a corpus of real size (``corpus``, from
    ``write_corpus``: 1 GiB of uint16 tokens in 64 shards).  (a) The same 20,000 shuffled
    windows of 1024 tokens through ``reader="native"`` and ``"mmap"`` in
    turns native / mmap / mmap / native: equal byte for byte, windows/s
    and MB/s each.  (b) ``train_lm.main --data_dir`` at gpt2-small (B8
    L1024 bf16, flash on, 6 steps, eval every 3) under ``"auto"`` (the
    native reader: its counter within ``readahead_bound``) and again with
    ``K8S_TPU_NATIVE=0`` (mmap: the counter stays 0), from the same seed:
    losses equal within 1e-4 (the same windows through the same
    deterministic kernels), exact K2-K4 launches.  (c) ``--fused_ce on
    --grad_accum 2 --remat`` on the same corpus from the same weights:
    step 1's loss within 1e-3 of (b)'s native run (only the reduction
    order differs), steps 2-6 finite and within 2e-2, exact launches (K2
    12 · 2 · grad_accum a step, remat recomputing each block's forward,
    plus 12 an eval batch; K3 = K4 = 12 · grad_accum a step), peak memory
    beside (b)'s."""
    import numpy as np

    layers, steps, accum, evals, eval_batches = 12, 6, 2, 2, 2
    data, man, write_s = corpus
    reads = [read_windows(dataset, native_dl, data, r)
             for r in ("native", "mmap", "mmap", "native")]
    first = reads[0]["windows"]
    same = all(np.array_equal(r["windows"], first) for r in reads[1:])
    counts = [r["delivered"] for r in reads]
    if not same or counts != [READ_WINDOWS, 0, 0, READ_WINDOWS]:
        fail(f"native_reader: windows equal {same}, native counter "
             f"{counts} (expected {READ_WINDOWS} for native, 0 for mmap)")
    for r in reads:
        del r["windows"]
    del first
    runs = {
        "native": train_on(torch, train_lm, common, native_dl, data,
                           os.path.join(root, "native.jsonl"), [], True),
        "mmap": train_on(torch, train_lm, common, native_dl, data,
                         os.path.join(root, "mmap.jsonl"), [], False),
        "flags": train_on(torch, train_lm, common, native_dl, data,
                          os.path.join(root, "flags.jsonl"),
                          ["--fused_ce", "on", "--grad_accum", str(accum),
                           "--remat"], True)}
    consumed = 8 * (steps + evals * eval_batches)
    most = readahead_bound(consumed, 1 + evals)
    plain = {"flash_fwd": layers * (steps + evals * eval_batches),
             "flash_bwd_dq": layers * steps,
             "flash_bwd_dkv": layers * steps, "rms_norm": 0}
    flags = {"flash_fwd": layers * (2 * accum * steps + evals * eval_batches),
             "flash_bwd_dq": layers * accum * steps,
             "flash_bwd_dkv": layers * accum * steps, "rms_norm": 0}
    nat, mm, fl = runs["native"], runs["mmap"], runs["flags"]
    for name, run, want in (("native", nat, plain), ("mmap", mm, plain),
                            ("flags", fl, flags)):
        if run["launches"] != want or \
                sorted(run["loss"]) != list(range(1, steps + 1)) or \
                len(run["eval"]) != evals:
            fail(f"native_reader {name}: launches {run['launches']} "
                 f"(expected {want}), steps {sorted(run['loss'])}, evals "
                 f"{run['eval']}")
    if not (consumed <= nat["delivered"] <= most
            and consumed <= fl["delivered"] <= most
            and mm["delivered"] == 0):
        fail(f"native_reader: windows delivered native {nat['delivered']}, "
             f"flags {fl['delivered']} (consumed {consumed}, at most "
             f"{most}), mmap {mm['delivered']} (expected 0)")
    reader_diff = max(abs(nat["loss"][s] - mm["loss"][s])
                      for s in nat["loss"])
    reader_diff = max([reader_diff] + [abs(a[1] - b[1]) for a, b in
                                       zip(nat["eval"], mm["eval"])])
    flag_diff = {s: abs(fl["loss"][s] - nat["loss"][s]) for s in fl["loss"]}
    finite = all(map(math.isfinite, list(fl["loss"].values())
                     + [e[1] for e in fl["eval"]]))
    if reader_diff > 1e-4 or flag_diff[1] > 1e-3 or not finite or \
            max(flag_diff[s] for s in range(2, steps + 1)) > 2e-2:
        fail(f"native_reader: native vs mmap losses differ by {reader_diff} "
             f"(tol 1e-4); the flags run's against native {flag_diff} "
             f"(step 1 tol 1e-3, steps 2-6 2e-2), finite {finite}")
    rec = {"phase": "native_reader", "card": REPORT["card"],
           "corpus": {"tokens": man["total_tokens"], "dtype": man["dtype"],
                      "shards": len(man["shards"]), "seed": CORPUS_SEED,
                      "write_s": write_s},
           "reads": reads, "reads_equal": same,
           "train_args": DATA_ARGS + ["--train_steps", "6"],
           "runs": runs, "native_vs_mmap_max_abs_diff": reader_diff,
           "reader_tol": 1e-4, "flags_vs_native_abs_diff": flag_diff,
           "flags_tol": {"step_1": 1e-3, "steps_2_6": 2e-2},
           "windows": {"consumed": consumed, "most": most},
           "expected_launches": {"plain": plain, "flags": flags}}
    emit(rec)
    REPORT["native_reader"] = rec
    return {k: nat["launches"][k] + mm["launches"][k] + fl["launches"][k]
            for k in plain}


PROFILE_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from k8s_tpu_torch import train_lm
from k8s_tpu_torch.launcher import bootstrap
from k8s_tpu_torch.ops import _common
enabled = bootstrap.setup_observability()
_common.reset_launches()
rc = train_lm.main(json.loads(sys.argv[2]))
torch.cuda.synchronize()
launches = _common.launches()
bootstrap.stop_observability()
print("RESULT " + json.dumps({"enabled": enabled, "rc": rc,
                              "launches": launches}), flush=True)
"""

# the __global__ bodies of each wrapper's kernel in csrc/flash_fwd.cu and
# csrc/flash_bwd.cu, as the trace names them
KERNEL_EVENTS = {
    "flash_fwd": r"\bflash_fwd_(wgmma|mma|fma)\b",
    "flash_bwd_dq": r"\bflash_bwd_dq_(wgmma|mma|fma)\b",
    "flash_bwd_dkv": r"\bflash_bwd_dkv_(wgmma|mma|fma)\b",
}


def busy_share(events: list, t_from: float) -> float:
    """The share of [t_from, the last device event's end] in which some
    kernel, copy or fill ran (overlaps merged)."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e["ts"] + e["dur"] > t_from)
    busy, cur_a, cur_b = 0.0, None, None
    for a, b in spans:
        a = max(a, t_from)
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
    end = max(b for _, b in spans)
    return busy / (end - t_from)


def profile_hook(torch, data_dir: str) -> dict:
    """The bootstrap's profiler hooks in a child process of its own (its
    profiler session stays away from this process's host clocks), under
    the pod env ``JAX_PROFILE_DIR``, ``JAX_PROFILER_PORT=9999``,
    ``XLA_DUMP_TO`` and ``K8S_TPU_PLATFORM=gpu``: ``setup_observability()``,
    ``train_lm.main`` for 2 gpt2-small steps on ``data_dir`` through the
    native reader, ``stop_observability()``.  ``enabled`` is exactly
    ``{"profile_dir": ...}``, the two hooks without a counterpart are
    named in warnings and dump nothing, the one trace file carries the
    child's host and pid, and its CUDA kernel events named after each
    flash kernel equal the child's launch counters (kernels the main
    thread launched while the prefetch thread read).  Prints the device
    busy share over both steps and over step 2."""
    import re
    import socket

    with tempfile.TemporaryDirectory() as root:
        trace_dir = os.path.join(root, "trace")
        dump_dir = os.path.join(root, "xla_dump")
        env = dict(os.environ, JAX_PROFILE_DIR=trace_dir,
                   JAX_PROFILER_PORT="9999", XLA_DUMP_TO=dump_dir,
                   K8S_TPU_PLATFORM="gpu")
        env.pop("K8S_TPU_NATIVE", None)
        args = DATA_ARGS + ["--data_dir", data_dir, "--train_dir", "",
                            "--train_steps", "2", "--eval_every", "0"]
        t0 = time.perf_counter()
        p = subprocess.Popen(
            [sys.executable, "-c", PROFILE_CHILD, REPO, json.dumps(args)],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            fail("profile_hook: the child ran past 300 s")
        child_s = time.perf_counter() - t0
        lines = [x for x in out.splitlines() if x.startswith("RESULT ")]
        if p.returncode != 0 or not lines:
            fail(f"profile_hook: the child exited {p.returncode}: "
                 f"{out[-2000:]}{err[-3000:]}")
        res = json.loads(lines[-1][len("RESULT "):])
        files = sorted(os.listdir(trace_dir))
        prefix = f"{socket.gethostname()}_{p.pid}."
        if res["enabled"] != {"profile_dir": trace_dir} or res["rc"] != 0 \
                or len(files) != 1 or not files[0].startswith(prefix) \
                or os.path.exists(dump_dir) \
                or "JAX_PROFILER_PORT=9999 ignored" not in err \
                or f"XLA_DUMP_TO={dump_dir} ignored" not in err:
            fail(f"profile_hook: enabled {res['enabled']}, rc {res['rc']}, "
                 f"trace files {files} (expected one named {prefix}*), "
                 f"dump dir made {os.path.exists(dump_dir)}, stderr "
                 f"{err[-2000:]}")
        trace_mb = os.path.getsize(os.path.join(trace_dir, files[0])) / 1e6
        with open(os.path.join(trace_dir, files[0])) as f:
            events = json.load(f)["traceEvents"]
    device = [e for e in events if e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    kernels = [e for e in device if e["cat"] == "kernel"]
    counted = {k: [e for e in kernels if re.search(pat, e["name"])]
               for k, pat in KERNEL_EVENTS.items()}
    in_trace = {k: len(v) for k, v in counted.items()}
    want = {k: res["launches"][k] for k in KERNEL_EVENTS}
    if in_trace != want or want["flash_fwd"] != 12 * 2:
        fail(f"profile_hook: kernel events in the trace {in_trace} against "
             f"the child's launch counters {res['launches']} (K2 expected "
             "24 for 2 steps)")
    fwd = sorted(e["ts"] for e in counted["flash_fwd"])
    rec = {"phase": "profile_hook", "card": REPORT["card"],
           "enabled": res["enabled"], "child_s": child_s,
           "trace_file_mb": trace_mb, "trace_events": len(events),
           "device_events": {c: sum(e["cat"] == c for e in device)
                             for c in ("kernel", "gpu_memcpy",
                                       "gpu_memset")},
           "kernel_events": in_trace, "launches": res["launches"],
           # from the first flash forward of step 1 (or step 2) to the
           # last device event: both steps, then the second alone
           "device_busy_share_steps_1_2": busy_share(device, fwd[0]),
           "device_busy_share_step_2": busy_share(device, fwd[12]),
           "warnings": [x for x in err.splitlines() if "ignored" in x]}
    emit(rec)
    REPORT["profile_hook"] = rec
    return res["launches"]


# -- phase 8: the vision models and dist_mnist -------------------------------


VISION_TOL = 1e-4      # logits, losses, parameters after an SGD step
VISION_GRAD_TOL = 1e-3  # gradients, per tensor
BN_RTOL, BN_ATOL = 1e-5, 1e-6


def rel_err(got, want) -> float:
    """Max abs difference over the largest magnitude of ``want``."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return (got - want).abs().max().item() / max(want.abs().max().item(),
                                                 1e-12)


def vision_parity(torch, resnet, vit, mnist, train_lib):
    """``resnet18_thin`` (both stems), ``vit_tiny_test`` (fused norm on:
    K1 on the card) and ``MnistCNN``, f32, each built on the cpu and on
    the card with the same weights and fed the same batch: the logits
    (ResNet in eval mode), then one training step, its loss, every
    gradient and, for ResNet, the BatchNorm running stats after the step
    and the parameters after SGD(0.1, momentum 0.9).  Tolerances:
    logits, losses and parameters 1e-4 relative to the largest magnitude
    of the cpu tensor (summation order); gradients 1e-3 per tensor (cuDNN
    may pick an FFT or Winograd algorithm, whose f32 rounding differs more
    than a direct sum's; TF32 is off); running stats rtol 1e-5, atol
    1e-6."""
    g = torch.Generator().manual_seed(21)
    img32 = torch.randn(4, 32, 32, 3, generator=g)
    img28 = torch.rand(8, 28, 28, 1, generator=g)
    labels = torch.randint(0, 10, (8,), generator=g)
    cases = [("resnet18_thin_conv",
              lambda d: resnet.resnet18_thin(stem="conv", device=d, seed=3),
              img32, labels[:4], "sgd"),
             ("resnet18_thin_s2d",
              lambda d: resnet.resnet18_thin(stem="s2d", device=d, seed=3),
              img32, labels[:4], "sgd"),
             ("vit_tiny_fused",
              lambda d: vit.ViT(dataclasses.replace(
                  vit.vit_tiny_test(), use_fused_norm=True), device=d,
                  seed=4), img32, labels[:4], "adam"),
             ("mnist_cnn", lambda d: mnist.MnistCNN(device=d, seed=5),
              img28, labels, "adam")]
    out = {}
    for name, build, x, y, opt_name in cases:
        models = {"cpu": build("cpu")}
        # a copy: the state dict's tensors are the live ones, which the
        # step updates in place
        sd = {n: t.clone() for n, t in models["cpu"].state_dict().items()}
        models["cuda"] = build("cuda")
        models["cuda"].load_state_dict(sd)
        res = {}
        for dev, m in models.items():
            xd, yd = x.to(dev), y.to(dev)
            is_resnet = name.startswith("resnet")
            with torch.no_grad():
                logits = m(xd, train=False) if is_resnet else m(xd)
            if opt_name == "sgd":
                opt = torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9)
            else:
                opt = torch.optim.Adam(m.parameters(), lr=1e-3)
            loss = train_lib.cross_entropy_loss(
                m(xd, train=True) if is_resnet else m(xd), yd)
            loss.backward()
            grads = {n: p.grad.clone() for n, p in m.named_parameters()}
            opt.step()
            res[dev] = {"logits": logits, "loss": loss.detach(),
                        "grads": grads, "state": m.state_dict()}
        c, r = res["cuda"], res["cpu"]
        rec = {"phase": "vision_parity", "model": name,
               "logits_rel_err": rel_err(c["logits"], r["logits"]),
               "loss_rel_err": rel_err(c["loss"], r["loss"]),
               "grad_rel_err": max(rel_err(c["grads"][n], r["grads"][n])
                                   for n in r["grads"])}
        bad = rec["logits_rel_err"] > VISION_TOL or \
            rec["loss_rel_err"] > VISION_TOL or \
            rec["grad_rel_err"] > VISION_GRAD_TOL
        if name.startswith("resnet"):
            stats = [n for n in r["state"] if n.endswith((".mean", ".var"))]
            rec["bn_stats_max_abs_err"] = max(
                (c["state"][n].cpu() - r["state"][n]).abs().max().item()
                for n in stats)
            moved = [n for n in stats if not torch.equal(
                r["state"][n], sd[n])]
            rec["bn_stats_moved"] = f"{len(moved)}/{len(stats)}"
            rec["param_rel_err_after_sgd"] = max(
                rel_err(c["state"][n], r["state"][n])
                for n in r["grads"])
            bad = bad or len(moved) != len(stats) or \
                rec["param_rel_err_after_sgd"] > VISION_TOL or not all(
                    torch.allclose(c["state"][n].cpu(), r["state"][n],
                                   rtol=BN_RTOL, atol=BN_ATOL)
                    for n in stats)
        rec.update(tol=VISION_TOL, grad_tol=VISION_GRAD_TOL,
                   bn_rtol=BN_RTOL, bn_atol=BN_ATOL)
        if bad:
            fail(f"vision parity {name} cuda vs cpu: {rec}")
        emit(rec)
        out[name] = rec
    REPORT["vision_parity"] = out


RESNET_BATCH = 128
RESNET_WARMUP, RESNET_STEPS = 3, 10
RESNET_GFLOP = 4.1  # ResNet-50's forward, one 224x224 image
VIT_BATCH = 128
VIT_GFLOP = 17.6    # ViT-B/16's forward, one 224x224 image


def vision_batch(torch, B: int, seed: int):
    """Random NHWC images ``[B, 224, 224, 3]`` and labels in [0, 1000),
    on the card, from ``seed``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, 224, 224, 3, generator=g, device="cuda")
    return x, torch.randint(0, 1000, (B,), generator=g, device="cuda")


def resnet_path(torch, bench, common):
    """``resnet50(dtype=bf16)`` at full width and depth (bench.py's
    ResNet-50 cell: B128 at 224x224x3, 1000 classes), random NHWC images
    and labels from a seed, trained with SGD(lr 0.1, momentum 0.9), the
    ``optax.sgd(0.1, momentum=0.9)`` of the reference, through the bench
    cell's own ``resnet_trainer`` and ``_time_steps``
    (``k8s_tpu_torch/bench.py``): 3 warm-up steps (cuDNN's algorithm
    search, with ``cudnn.benchmark`` on for this phase), then 10 timed
    steps, with the 7x7 stem and then the s2d stem (images/s from the host
    clock around the 10).  The loss and every BatchNorm running stat must
    be finite and must have moved; no hand-written kernel may launch (the
    reference's convolutions are XLA, not Pallas)."""
    B = RESNET_BATCH
    x, y = vision_batch(torch, B, 31)
    flops = 3 * 2 * RESNET_GFLOP * 1e9 * B
    search = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    out, launches = {}, {}
    try:
        for stem in ("conv", "s2d"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            model, step = bench.resnet_trainer(x, y, stem, 32)
            stats0 = {n: b.clone() for n, b in model.named_buffers()}
            losses = []

            def run_step(state, step=step, losses=losses):
                losses.append(step())
                return state, losses[-1]
            common.reset_launches()
            t0 = time.perf_counter()
            (wall_s,) = bench._time_steps(run_step, None, RESNET_STEPS,
                                          RESNET_WARMUP)
            warm_s = time.perf_counter() - t0 - wall_s
            launches[stem] = common.launches()
            losses = torch.stack(losses).tolist()
            stats = dict(model.named_buffers())
            finite = all(math.isfinite(v) for v in losses) and all(
                bool(torch.isfinite(b).all()) for b in stats.values())
            moved = sum(not torch.equal(stats[n], stats0[n]) for n in stats)
            rec = {"phase": "resnet", "card": REPORT["card"],
                   "config": f"resnet50 bf16 stem={stem}, f32 params and "
                             "BN stats, channels_last, SGD(0.1, m=0.9)",
                   "batch": [B, 224, 224, 3], "cudnn_benchmark": True,
                   "warmup_steps": RESNET_WARMUP, "warmup_s": warm_s,
                   "steps": RESNET_STEPS, "wall_s": wall_s,
                   "images_per_s": B * RESNET_STEPS / wall_s,
                   "step_ms": wall_s / RESNET_STEPS * 1e3,
                   "flops_per_step": flops,
                   "peak_16bit_share":
                       flops / (wall_s / RESNET_STEPS) / PEAK_16BIT,
                   "max_memory_allocated_gib":
                       torch.cuda.max_memory_allocated() / 2 ** 30,
                   "params": sum(p.numel() for p in model.parameters()),
                   "losses": losses,
                   "bn_buffers_moved": f"{moved}/{len(stats)}",
                   "launches": launches[stem]}
            if not finite or moved != len(stats) or \
                    losses[0] == losses[-1] or \
                    any(launches[stem].values()):
                fail(f"resnet50 {stem}: losses {losses}, finite {finite}, "
                     f"BN buffers moved {moved}/{len(stats)}, launches "
                     f"{launches[stem]} (expected none)")
            emit(rec)
            out[stem] = rec
            del model, step, stats, stats0, run_step
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.benchmark = search
    REPORT["resnet"] = out
    return {k: sum(v[k] for v in launches.values()) for k in common.KERNELS}


VIT_STEPS = 5  # a turn


def vit_path(torch, vit, train_lib, bench, common):
    """``ViT(vit_b16(remat=False))`` at full width (hidden 768, 12 layers,
    12 heads, ffn 2048, 224/16 -> 197 tokens), bf16 over f32 masters,
    B128, AdamW (``default_optimizer(1e-3, weight_decay=0.05)``, as
    bench.py's cell), twice from the same weights: with
    ``use_fused_norm`` (K1 for every block's two norms and the final
    norm) and without, in turns on / off / off / on of 5 steps each after
    a warm-up step each (``cudnn.benchmark`` on).  Every norm scale is
    drawn from U[0.5, 1.5), not left at its init of 1, so that a K1 which
    dropped or misapplied the scale would show.  K1 must launch exactly
    2*12+1 = 25 times a step with fused norm on and never with it off.
    On the same batch and weights, fused norm on and off may differ by
    at most the bf16 model's own rounding error there, measured against
    the same weights run in f32 without gradients: the first forward's
    logits by at most twice max|logits(off) - logits(f32)| (each of on
    and off carries its own rounding error of that size), the first
    step's loss by at most |loss(off) - loss(f32)|, and never less than
    one bf16 step of the loss (2^-8 relative)."""
    B = VIT_BATCH
    x, y = vision_batch(torch, B, 41)
    base = vit.vit_b16(remat=False)
    flops = 3 * 2 * VIT_GFLOP * 1e9 * B
    search = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    weights = vit.ViT(base, device="cuda", seed=42).state_dict()
    g = torch.Generator(device="cuda").manual_seed(43)
    for name, t in weights.items():
        if name.endswith(".scale"):
            t.copy_(0.5 + torch.rand(t.shape, generator=g, device="cuda"))
    runs = {}
    for fused in (True, False):
        model, step = bench.vit_trainer(
            dataclasses.replace(base, use_fused_norm=fused), x, y, weights)
        runs[fused] = {"model": model, "step": step, "wall_s": [],
                       "launches": [], "losses": []}
    try:
        with torch.no_grad():
            ref = vit.ViT(dataclasses.replace(base, dtype=torch.float32),
                          device="cuda")
            ref.load_state_dict(weights)
            logits_f32 = ref(x).float()
            loss_f32 = train_lib.cross_entropy_loss(logits_f32, y).item()
            del ref
            logits = {fused: r["model"](x).float()
                      for fused, r in runs.items()}
        logit_err = (logits[False] - logits_f32).abs().max().item()
        logit_diff = (logits[True] - logits[False]).abs().max().item()
        logit_scale = logits_f32.abs().max().item()
        del logits, logits_f32
        first = {}
        for fused, r in runs.items():  # warm-up: the same first batch
            first[fused] = r["step"]().item()
        for fused in (True, False, False, True):
            r = runs[fused]
            losses = []

            def run_step(state, step=r["step"], losses=losses):
                losses.append(step())
                return state, losses[-1]
            torch.cuda.synchronize()
            common.reset_launches()
            r["wall_s"] += bench._time_steps(run_step, None, VIT_STEPS, 0)
            r["launches"].append(common.launches())
            r["losses"] += torch.stack(losses).tolist()
    finally:
        torch.backends.cudnn.benchmark = search
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want_k1 = 25 * VIT_STEPS
    launches = {fused: {k: sum(lc[k] for lc in r["launches"])
                        for k in common.KERNELS}
                for fused, r in runs.items()}
    ok = all(lc == {**dict.fromkeys(common.KERNELS, 0),
                    "rms_norm": want_k1 if fused else 0}
             for fused, r in runs.items() for lc in r["launches"])
    bound = max(abs(first[False] - loss_f32), 2 ** -8 * abs(loss_f32))
    diff = abs(first[True] - first[False])
    finite = all(math.isfinite(v) for r in runs.values()
                 for v in r["losses"])
    rec = {"phase": "vit", "card": REPORT["card"],
           "config": "vit_b16(remat=False) bf16 over f32 masters, plain "
                     "attention, AdamW(1e-3, wd 0.05)",
           "batch": [B, 224, 224, 3], "cudnn_benchmark": True,
           "turns": ["on", "off", "off", "on"], "steps_per_turn": VIT_STEPS,
           "flops_per_step": flops,
           "fused_on": {"turn_wall_s": runs[True]["wall_s"],
                        "images_per_s": [B * VIT_STEPS / w
                                         for w in runs[True]["wall_s"]],
                        "launches_per_turn": runs[True]["launches"]},
           "fused_off": {"turn_wall_s": runs[False]["wall_s"],
                         "images_per_s": [B * VIT_STEPS / w
                                          for w in runs[False]["wall_s"]],
                         "launches_per_turn": runs[False]["launches"]},
           "norm_scales": "U[0.5, 1.5) from seed 43",
           "first_logits": {"max_abs_diff_on_off": logit_diff,
                            "bound": 2 * logit_err,
                            "max_abs_err_off_vs_f32": logit_err,
                            "max_abs_f32": logit_scale},
           "first_step_loss": {"on": first[True], "off": first[False],
                               "f32_no_grad": loss_f32},
           "first_step_loss_abs_diff": diff, "loss_diff_bound": bound,
           "losses_on": runs[True]["losses"],
           "losses_off": runs[False]["losses"],
           "max_memory_allocated_gib": peak,
           "params": sum(p.numel() for p in runs[True]["model"].parameters()),
           "expected_rms_norm_per_turn": {"on": want_k1, "off": 0}}
    rec["peak_16bit_share_on"] = flops * VIT_STEPS / min(
        runs[True]["wall_s"]) / PEAK_16BIT
    if not ok or diff > bound or logit_diff > 2 * logit_err or not finite:
        fail(f"vit_b16: {rec}")
    emit(rec)
    REPORT["vit"] = rec
    del runs, weights
    gc.collect()
    torch.cuda.empty_cache()
    return launches[True]


# the bench cells at their shapes with fewer iterations: BENCH_REPEATS=2
# and these arguments (the twin's defaults are 5 repeats of 30-40 steps)
BENCH_REPEATS = 2
BENCH_KW = {"vit": dict(iters=3, warmup=1), "decode": dict(calls=1),
            "decode_depth": dict(calls=1),
            "resnet50": dict(iters=3, warmup=1),
            "transformer": dict(iters=3, warmup=1)}
BENCH_CONTROL_REPEATS = 3  # as the twin's main() runs the control
BENCH_LAYERS = 12          # gpt2-small's: one K2 (K3, K4) a layer a call
# |flash - plain| first loss over |plain|: one bf16 step of the loss
BENCH_LOSS_BOUND = 2 ** -8


def bench_expected(cell: str, kw: dict, repeats: int) -> dict:
    """K2-K4 launches a cell makes, from the code: the transformer step
    runs K2 in its forward and K3 and K4 in its backward once a layer
    (warm-up + repeats x iters steps); the plain-attention control none.
    Each generate call's full-prompt prefill runs K2 once a layer, its
    decode steps and chunked prefill (decode-mode chunks) none; a cell
    calls ``generate`` once to start, ``warmup - 1`` more (decode) or once
    more (decode_depth) and then repeats x calls times; decode_depth has
    five sub-cells with a full prefill (one-shot, greedy, beam 4, the
    sweep point, speculative) and the chunked one without.  ResNet and
    ViT-B/16 (plain attention, no fused norm) launch nothing."""
    counts = dict(flash_fwd=0, rms_norm=0, flash_bwd_dq=0, flash_bwd_dkv=0)
    if cell == "transformer":
        steps = kw["warmup"] + repeats * kw["iters"]
        for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            counts[k] = BENCH_LAYERS * steps
    elif cell == "decode":
        calls = 1 + max(0, kw.get("warmup", 1) - 1) + repeats * kw["calls"]
        counts["flash_fwd"] = BENCH_LAYERS * calls
    elif cell == "decode_depth":
        counts["flash_fwd"] = BENCH_LAYERS * 5 * (2 + repeats * kw["calls"])
    return counts


def bench_cells(torch, bench, common):
    """``k8s_tpu_torch/bench.py``'s five cells on the card at their
    shapes (ResNet-50 and ViT-B/16 B128, gpt2-small B8 L1024 with K2-K4
    and its plain-attention control, greedy decode B32 128+128, the
    decode-depth A/Bs) with fewer iterations (``BENCH_KW``,
    ``BENCH_REPEATS=2``), recorded by the twin's ``Recorder`` into a file
    of this script's under chip_reports/ and assembled into the twin's
    line by ``bench.assemble``, printed on a line of its own.  Checks: a
    complete line (no ``partial``); every MFU and the decode HBM share in
    (0, 1]; each cell's K2-K4 launches, zeroed before it and read after,
    equal to ``bench_expected``; the flash step's and the control's first
    losses (the same seed, weights and batch) within ``BENCH_LOSS_BOUND``
    of each other; all six records persisted; no file at the repository
    root written or changed."""
    t_start = time.perf_counter()

    def root_files():
        return {n: os.stat(os.path.join(REPO, n)).st_mtime_ns
                for n in os.listdir(REPO)
                if os.path.isfile(os.path.join(REPO, n))}
    root0 = root_files()
    kind = torch.cuda.get_device_name(0)
    path = os.path.join(OUT_DIR, "bench_smoke_lastgood.json")
    if os.path.exists(path):
        os.remove(path)
    recorder = bench.Recorder(path)
    tf_kw = BENCH_KW["transformer"]
    cells = (("vit", bench.bench_vit, BENCH_KW["vit"]),
             ("decode", bench.bench_decode, BENCH_KW["decode"]),
             ("decode_depth", bench.bench_decode_depth,
              BENCH_KW["decode_depth"]),
             ("resnet50", bench.bench_resnet50, BENCH_KW["resnet50"]),
             ("transformer", bench.bench_transformer, tf_kw),
             ("transformer_xla_control", bench.bench_transformer,
              {**tf_kw, "use_flash": False,
               "repeats": BENCH_CONTROL_REPEATS}))
    results, launches, seconds = {}, {}, {}
    repeats = os.environ.get("BENCH_REPEATS")
    os.environ["BENCH_REPEATS"] = str(BENCH_REPEATS)
    try:
        for name, fn, kw in cells:
            torch.cuda.synchronize()
            common.reset_launches()
            t0 = time.perf_counter()
            results[name] = fn(**kw)
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            launches[name] = common.launches()
            recorder.record(name, results[name], True, kind)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if repeats is None:
            del os.environ["BENCH_REPEATS"]
        else:
            os.environ["BENCH_REPEATS"] = repeats
    line = bench.assemble(recorder, dict.fromkeys(bench.CELLS, True),
                          allow_stale=False, device_kind=kind, n_chips=1)
    print(json.dumps(line), flush=True)
    expected = {name: bench_expected(name, kw, BENCH_REPEATS)
                for name, _, kw in cells}
    shares = {k: (line or {}).get(k) for k in (
        "resnet50_mfu", "transformer_mfu", "vit_mfu", "decode_mfu",
        "decode_hbm_utilization")}
    first = {name: results[name]["first_loss"]
             for name in ("transformer", "transformer_xla_control")}
    loss_diff = abs(first["transformer"] - first["transformer_xla_control"])
    loss_bound = BENCH_LOSS_BOUND * abs(first["transformer_xla_control"])
    with open(path) as f:
        persisted = sorted(json.load(f)["benchmarks"])
    changed = sorted(n for n, t in root_files().items()
                     if root0.get(n) != t)
    rec = {"phase": "bench", "card": REPORT["card"],
           "repeats": BENCH_REPEATS, "kwargs": BENCH_KW,
           "seconds": seconds, "launches": launches, "expected": expected,
           "shares": shares, "first_loss": first,
           "first_loss_abs_diff": loss_diff, "loss_bound": loss_bound,
           "persisted": persisted, "root_files_changed": changed,
           "s": time.perf_counter() - t_start}
    bad = []
    if line is None or line.get("partial"):
        bad.append("the line is partial")
    if not all(isinstance(v, float) and 0 < v <= 1 for v in shares.values()):
        bad.append(f"shares outside (0, 1]: {shares}")
    if launches != expected:
        bad.append(f"launches {launches} != expected {expected}")
    if not loss_diff <= loss_bound:
        bad.append(f"first losses {first} differ by {loss_diff} > "
                   f"{loss_bound}")
    if persisted != sorted(results):
        bad.append(f"persisted {persisted}")
    if changed:
        bad.append(f"root files written: {changed}")
    if bad:
        fail(f"bench: {'; '.join(bad)}: {rec}")
    emit(rec)
    REPORT["bench"] = {**rec, "line": line}
    return {k: sum(lc[k] for lc in launches.values()) for k in common.KERNELS}


MNIST_ARGS = ["--device", "cuda", "--eval_holdout", "256",
              "--checkpoint_every", "50"]
MNIST_STEPS = 200


def mnist_path(torch, dist_mnist, mnist, mnist_data, train_lib, common):
    """``k8s_tpu_torch.dist_mnist.main`` in-process on the committed
    real-digit fixture (``tests/fixtures/mnist``, 1797 digits; the last
    256 held out): 200 steps with a checkpoint every 50, then a second
    training directory run to step 100 and resumed to 200.  A resumed run
    reseeds its batch stream with the resume step, as the reference's
    does, so the resumed run's logged losses from step 100 on and its
    final weights must equal exactly those of an in-process control that
    restores the same step-100 checkpoint and trains on
    ``array_batches(..., seed=100)`` through the same step, with
    deterministic kernels (``cudnn.deterministic`` on,
    ``cudnn.benchmark`` off, for this phase only).  The step time is a
    separate clock of the same step (``make_train_step``, Adam, B64) over
    50 steps ending in a sync, after 5 warm-up steps.  No hand-written
    kernel may launch."""
    from k8s_tpu_torch.models import data as data_lib

    data = os.path.join(REPO, "tests", "fixtures", "mnist")
    logger = logging.getLogger("dist_mnist")
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    logs, weights = {}, {}
    half = MNIST_STEPS // 2
    try:
        with tempfile.TemporaryDirectory() as root:
            kept = os.path.join(root, "at_resume")
            for name, plan in (("full", [MNIST_STEPS]),
                               ("resumed", [half, MNIST_STEPS])):
                d = os.path.join(root, name)
                handler = Messages()
                logger.addHandler(handler)
                try:
                    if name == "full":
                        common.reset_launches()
                        t0 = time.perf_counter()
                    for n in plan:
                        rc = dist_mnist.main(MNIST_ARGS + [
                            "--data_dir", data, "--train_dir", d,
                            "--train_steps", str(n)])
                        if rc != 0:
                            fail(f"dist_mnist ({name}, {n} steps) exited "
                                 f"{rc}")
                        if n == half:  # the checkpoint the resume reads
                            os.makedirs(kept)
                            shutil.copy(
                                os.path.join(d, dist_mnist.CKPT_NAME), kept)
                    torch.cuda.synchronize()
                    if name == "full":
                        wall_s = time.perf_counter() - t0
                        launches = common.launches()
                finally:
                    logger.removeHandler(handler)
                logs[name] = handler.lines
                weights[name] = torch.load(
                    os.path.join(d, dist_mnist.CKPT_NAME),
                    map_location="cpu", weights_only=True)
            # the control: the step-100 checkpoint on the reseeded stream
            model = mnist.MnistCNN(device="cuda", seed=0)
            opt = train_lib.default_optimizer(1e-3)
            state = train_lib.init_state(model, opt)
            restored_at = dist_mnist.restore_checkpoint(kept, state, "cuda")
            ds_x, ds_y = mnist_data.load_dataset(data)
            ds_x, ds_y = ds_x[:-256], ds_y[:-256]  # --eval_holdout 256
            step = train_lib.make_train_step(
                lambda m, b: m(b), train_lib.cross_entropy_loss, opt)
            it = data_lib.prefetch_to_device(
                data_lib.array_batches((ds_x, ds_y), 64, seed=half), "cuda")
            control = {}
            try:
                for i in range(half, MNIST_STEPS):
                    state, loss = step(state, next(it))
                    if i % 10 == 0 or i == MNIST_STEPS - 1:
                        control[i] = "%.4f" % float(loss)
            finally:
                it.close()
            control_weights = {n: t.detach().cpu()
                               for n, t in model.state_dict().items()}
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = det

    def losses(lines, start):
        out = {}
        for m in lines:
            parts = m.split()
            if len(parts) == 4 and parts[0] == "step" and parts[2] == "loss":
                if int(parts[1]) >= start:
                    out[int(parts[1])] = parts[3]
        return out
    full, res = logs["full"], logs["resumed"]
    acc = [m for m in full if m.startswith("held-out accuracy")]
    restored = [m for m in res if m.startswith("restored checkpoint")]
    got = losses(res, half)
    same_weights = all(
        torch.equal(t, weights["resumed"]["model"][n])
        for n, t in control_weights.items())
    if not (acc and restored and restored_at == half and control
            and got == control and same_weights
            and weights["resumed"]["step"] == MNIST_STEPS
            and not any(launches.values())):
        fail(f"dist_mnist: accuracy {acc}, restored {restored}, losses "
             f"{got} vs the reseeded control {control}, same weights "
             f"{same_weights}, launches {launches}")

    # the step's own time, outside main's logging and checkpoints
    x, y = (torch.from_numpy(a[:64]).cuda()
            for a in mnist_data.load_dataset(data))
    model = mnist.MnistCNN(device="cuda", seed=0)
    opt = train_lib.default_optimizer(1e-3)
    state = train_lib.init_state(model, opt)
    step = train_lib.make_train_step(lambda m, b: m(b),
                                     train_lib.cross_entropy_loss, opt)
    for _ in range(5):
        step(state, (x, y))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        step(state, (x, y))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 50 * 1e3
    rec = {"phase": "mnist", "card": REPORT["card"],
           "config": "dist_mnist.main, MnistCNN f32, Adam 1e-3, B64, "
                     "tests/fixtures/mnist (1797 digits, 256 held out)",
           "args": MNIST_ARGS, "steps": MNIST_STEPS,
           "cudnn_deterministic": True, "full_run_wall_s": wall_s,
           "held_out_accuracy": acc[0], "resumed_from": restored[0],
           "losses_from_resume": got,
           "control": f"the step-{half} checkpoint on "
                      f"array_batches(seed={half})",
           "resumed_weights_equal_control": same_weights,
           "step_ms": step_ms, "launches": launches}
    emit(rec)
    REPORT["mnist"] = rec
    return launches


# -- phase 9: multi-process bring-up and FSDP training, at world 1 ----------

FSDP_STEPS = 10
FSDP_TURNS = (("sharded", 0, 5), ("plain", 0, 5), ("plain", 5, 10),
              ("sharded", 5, 10))


def dist_parity(torch, tlib, bridge, train_lib, mesh):
    """``tiny_test`` in f32 (flash on) on the one-rank NCCL mesh: 3 steps of
    ``make_sharded_train_step`` (FSDP2, clip 0.1 active) against
    ``make_train_step`` from the same weights and batches.  At world 1
    the all-gather and the reduce-scatter copy, so only the clip's norm
    is summed in another order: losses and parameters within 1e-6 of
    their largest magnitude."""
    cfg = dataclasses.replace(tlib.tiny_test(), use_flash_attention=True)
    params = bridge.init_params(cfg, seed=12, device="cuda",
                                dtype=torch.float32)
    gen = torch.Generator().manual_seed(13)
    batches = [torch.randint(0, cfg.vocab_size, (4, 96), generator=gen
                             ).cuda() for _ in range(3)]
    opt = train_lib.default_optimizer(1e-3, clip_norm=0.1)
    # the clip is active: the first gradient's norm is above it
    model = tlib.Transformer(cfg, params, device="cuda", trainable=True)
    train_lib.lm_loss(model(batches[0]), batches[0]).backward()
    norm = torch.linalg.vector_norm(torch.stack(
        [p.grad.norm() for p in model.parameters()])).item()
    del model
    losses, finals = {}, {}
    for name in ("sharded", "plain"):
        model = tlib.Transformer(cfg, params, device="cuda", trainable=True)
        state = train_lib.init_state(model, opt)
        if name == "sharded":
            state, sh = train_lib.shard_train_state(state, mesh)
            step = train_lib.make_sharded_train_step(
                lambda m, x: m(x), train_lib.lm_loss, opt, mesh, sh)
        else:
            step = train_lib.make_train_step(lambda m, x: m(x),
                                             train_lib.lm_loss, opt)
        out = []
        for b in batches:
            state, loss = step(state, (b, b))
            out.append(loss)
        losses[name] = torch.stack(out)
        finals[name] = {
            n: (p.full_tensor() if hasattr(p, "full_tensor") else p).detach()
            for n, p in state["model"].named_parameters()}
    loss_err = rel_err(losses["sharded"], losses["plain"])
    param_err = max(rel_err(finals["sharded"][n], p)
                    for n, p in finals["plain"].items())
    if not (loss_err <= 1e-6 and param_err <= 1e-6 and norm > 0.1):
        fail(f"dist_parity: loss err {loss_err}, param err {param_err} "
             f"(tol 1e-6), first gradient norm {norm} (clip 0.1)")
    rec = {"phase": "dist_parity", "card": REPORT["card"],
           "config": "tiny_test f32 flash, B4 L96, adam 1e-3 clip 0.1, "
                     "one-rank NCCL mesh", "steps": len(batches),
           "losses_sharded": losses["sharded"].tolist(),
           "losses_plain": losses["plain"].tolist(),
           "loss_rel_err": loss_err, "param_rel_err": param_err, "tol": 1e-6,
           "first_grad_norm": norm}
    emit(rec)
    REPORT["dist_parity"] = rec


def fsdp_train(torch, tlib, bridge, train_lib, train_lm, common, checkpoint,
               mesh):
    """gpt2-small at full width and depth (bf16 over f32 masters, flash on,
    B8 L1024, Adam 1e-4, clip 1.0): the FSDP2 step over the one-rank NCCL
    mesh and the unsharded step from the same weights and batches, in
    turns sharded / plain / plain / sharded (5 steps a turn, each step
    clocked between syncs).  Then a DCP save of the sharded state,
    synchronous and asynchronous (the ms the loop is blocked, the rest of
    the async write behind one more step), and restores of both that give
    that step's loss again.  The launch counters, zeroed just before each
    sharded turn and read just after, must show 12 launches of K2, K3 and
    K4 a step and none of K1."""
    cfg = train_lm.build_config(train_lm.parse_args(TRAIN_ARGS), True)
    params = bridge.init_params(cfg, 0, "cuda", dtype=torch.float32)
    gen = torch.Generator().manual_seed(14)
    batches = [torch.randint(0, cfg.vocab_size, (8, 1024), generator=gen
                             ).cuda() for _ in range(FSDP_STEPS + 1)]
    opt = train_lib.default_optimizer(1e-4, clip_norm=1.0)
    states, steps = {}, {}
    for name in ("sharded", "plain"):
        state = train_lib.init_state(tlib.Transformer(
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
    losses = {"sharded": [], "plain": []}
    step_ms = {"sharded": [], "plain": []}
    peak = {"sharded": 0, "plain": 0}
    launches = dict.fromkeys(common.KERNELS, 0)
    for name, lo, hi in FSDP_TURNS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if name == "sharded":
            common.reset_launches()
        for i in range(lo, hi):
            b = batches[i]
            t0 = time.perf_counter()
            states[name], loss = steps[name](states[name], (b, b))
            losses[name].append(loss.item())  # syncs
            step_ms[name].append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        if name == "sharded":
            for k, v in common.launches().items():
                launches[k] += v
        peak[name] = max(peak[name], torch.cuda.max_memory_allocated())
    loss_diff = max(abs(a - b) for a, b in zip(losses["sharded"],
                                                losses["plain"]))
    want = {"flash_fwd": 12 * FSDP_STEPS, "rms_norm": 0,
            "flash_bwd_dq": 12 * FSDP_STEPS,
            "flash_bwd_dkv": 12 * FSDP_STEPS}
    if launches != want or not loss_diff <= 1e-4 or not all(
            math.isfinite(x) for x in losses["sharded"]):
        fail(f"fsdp_train: launches {launches} (want {want}), loss diff "
             f"{loss_diff} (bound 1e-4), losses {losses}")

    # DCP: sync, async, and restores that give the next step's loss again
    state, step = states["sharded"], steps["sharded"]
    del states["plain"], steps["plain"]
    gc.collect()
    torch.cuda.empty_cache()
    nxt = batches[FSDP_STEPS]
    with tempfile.TemporaryDirectory() as root:
        sync = checkpoint.Checkpointer(os.path.join(root, "sync"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sync.save(FSDP_STEPS, state, force=True)
        sync_ms = (time.perf_counter() - t0) * 1e3
        asy = checkpoint.Checkpointer(os.path.join(root, "async"),
                                      async_save=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        asy.save(FSDP_STEPS, state, force=True)
        async_block_ms = (time.perf_counter() - t0) * 1e3
        state, loss = step(state, (nxt, nxt))
        next_loss = loss.item()
        t0 = time.perf_counter()
        asy.wait()
        async_wait_ms = (time.perf_counter() - t0) * 1e3
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, fs in os.walk(os.path.join(root, "sync"))
                     for f in fs)
        again = {}
        for name, ck in (("async", asy), ("sync", sync)):
            state, _ = ck.restore_latest(state)
            state, loss = step(state, (nxt, nxt))
            again[name] = loss.item()
    if any(v != next_loss for v in again.values()):
        fail(f"fsdp_train: the step after a restore gives {again}, the "
             f"step after the save {next_loss}")

    def median(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2]

    rec = {"phase": "fsdp_train", "card": REPORT["card"],
           "config": "gpt2-small (12 x 768, vocab 32000) bf16 over f32 "
                     "masters, flash on, B8 L1024, adam 1e-4 clip 1.0; "
                     "FSDP2 over the one-rank NCCL mesh vs unsharded",
           "turns": [t[0] for t in FSDP_TURNS],
           "step_ms": step_ms,
           "median_step_ms": {k: median(v[1:]) for k, v in step_ms.items()},
           "sharded_over_plain": median(step_ms["sharded"][1:])
           / median(step_ms["plain"][1:]),
           "peak_gib": {k: v / 2 ** 30 for k, v in peak.items()},
           "losses": losses, "max_loss_diff": loss_diff,
           "loss_bound": 1e-4, "launches": launches,
           "dcp": {"bytes": nbytes, "sync_ms": sync_ms,
                   "async_blocked_ms": async_block_ms,
                   "async_wait_after_one_step_ms": async_wait_ms,
                   "next_loss": next_loss, "next_loss_after_restore": again}}
    emit(rec)
    REPORT["fsdp_train"] = rec
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def gang_env(port: int) -> dict:
    """The env the operator gives the one worker of a one-replica TFJob
    (``controller_v2.tpu_config.gen_env_vars``), its coordinator on
    loopback, and the platform the card is."""
    host = "rdzv-worker-0.rdzv.e2e.svc.cluster.local"
    config = json.dumps({"cluster": {"worker": [f"{host}:{port}"]},
                         "task": {"index": 0, "type": "worker"}},
                        sort_keys=True)
    return {**os.environ, "TPU_CONFIG": config, "TF_CONFIG": config,
            "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
            "JAX_NUM_PROCESSES": "1", "JAX_PROCESS_ID": "0",
            "TPU_WORKER_ID": "0", "TPU_WORKER_HOSTNAMES": host,
            "K8S_TPU_PLATFORM": "gpu",
            "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             "")}


def gang_path(torch):
    """The operator's in-pod payloads as one-worker gangs, in their own
    processes on the card: ``python -m k8s_tpu_torch.e2e.rendezvous_worker``
    (membership sum 1, one sharded step, a finite loss, the RDZV_OK keys),
    ``python -m k8s_tpu_torch.launcher.tpu_smoke``, a worker preempted at
    ``step_2`` of 4 (exit 143, a checkpoint every step) beside an
    uninterrupted control, then the preempted one resumed: its final loss
    must equal the control's exactly."""
    with tempfile.TemporaryDirectory() as root:
        env = gang_env(29500)
        ckpt = {"K8S_TPU_E2E_STEPS": "4", "K8S_TPU_E2E_CKPT_EVERY": "1"}
        worker = "k8s_tpu_torch.e2e.rendezvous_worker"
        runs = {
            "worker": (worker, env),
            "tpu_smoke": ("k8s_tpu_torch.launcher.tpu_smoke", env),
            "preempted": (worker, {**env, **ckpt, "K8S_TPU_E2E_FAIL":
                                   "0:143:step_2", "CHECKPOINT_DIR":
                                   os.path.join(root, "gang")}),
            "control": (worker, {**env, **ckpt, "CHECKPOINT_DIR":
                                 os.path.join(root, "control")}),
        }

        def start(module, env):
            return subprocess.Popen(
                [sys.executable, "-m", module], env=env, cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

        t0 = time.perf_counter()
        procs = {k: start(*v) for k, v in runs.items()}
        # the preempted worker resumes as soon as it has exited, beside
        # the runs still going
        out = {"preempted": procs["preempted"].communicate(timeout=600)[0]}
        procs["resumed"] = start(worker, {**runs["preempted"][1],
                                          "K8S_TPU_E2E_FAIL": ""})
        out.update({k: p.communicate(timeout=600)[0]
                    for k, p in procs.items() if k not in out})
        rcs = {k: p.returncode for k, p in procs.items()}
        wall_s = time.perf_counter() - t0

    def rdzv(text):
        for line in text.splitlines():
            if line.startswith("RDZV_OK "):
                return json.loads(line[len("RDZV_OK "):])
        return None

    def kernel_launches(text):
        for line in text.splitlines():
            if "kernel launches " in line:
                return json.loads(line.split("kernel launches ", 1)[1])
        return None

    res = {k: rdzv(out[k]) for k in ("worker", "control", "resumed")}
    keys = {"process_id", "num_processes", "is_chief", "global_devices",
            "mesh", "num_slices", "membership_sum", "loss", "step",
            "start_step"}
    launches = kernel_launches(out["worker"])
    ok = (rcs == {"worker": 0, "tpu_smoke": 0, "preempted": 143,
                  "control": 0, "resumed": 0}
          and all(r is not None and set(r) == keys for r in res.values())
          and res["worker"]["membership_sum"] == 1.0
          and res["worker"]["step"] == 1
          and math.isfinite(res["worker"]["loss"])
          and "smoke OK on 1 devices" in out["tpu_smoke"]
          and res["resumed"]["start_step"] == 2
          and res["resumed"]["step"] == 4
          and res["control"]["start_step"] == 0
          and res["resumed"]["loss"] == res["control"]["loss"]
          and launches is not None)
    if not ok:
        fail(f"gang: exit codes {rcs}, results {res}, outputs "
             + json.dumps({k: v[-1500:] for k, v in out.items()}))
    rec = {"phase": "gang", "card": REPORT["card"],
           "config": "rendezvous_worker (vocab 64, hidden 32, 1 layer, "
                     "L16, no flash) and tpu_smoke as one-worker gangs "
                     "over NCCL", "exit_codes": rcs, "results": res,
           "resumed_equals_control": True, "launches": launches,
           "wall_s": wall_s}
    emit(rec)
    REPORT["gang"] = rec
    return launches


# -- phase 10: sequence parallelism on one card ---------------------------------


SP = 4  # ThreadRing ranks: NCCL puts no two ranks on one card
GPT2_W = (12, 12, 64)    # heads, kv heads, head_dim of gpt2-small / bert-base
LLAMA_W = (32, 8, 128)   # of Llama-3-8B
SP_CASES = (
    # name, widths, L, variant, causal, window
    ("gpt2_contiguous", GPT2_W, 16384, "contiguous", True, None),
    ("gpt2_zigzag", GPT2_W, 16384, "zigzag", True, None),
    ("gpt2_ulysses", GPT2_W, 16384, "ulysses", True, None),
    ("llama_contiguous", LLAMA_W, 32768, "contiguous", True, None),
    ("llama_zigzag", LLAMA_W, 32768, "zigzag", True, None),
    ("llama_window_4096", LLAMA_W, 32768, "contiguous", True, 4096),
    ("llama_window_12288", LLAMA_W, 32768, "contiguous", True, 12288),
    ("llama_window_16384", LLAMA_W, 32768, "contiguous", True, 16384),
    ("bert_full_8192", GPT2_W, 8192, "contiguous", False, None),
)
SP_SMALL_L = 512  # the size at which the plain ring on the CPU joins in


def sp_calls(variant: str, causal: bool, window, n: int, Lc: int) -> int:
    """Flash calls (each one K2, and in the backward one K3 and one K4) a
    ring makes over its n ranks: contiguous causal rank r visits r + 1
    chunks; zigzag, non-causal and Ulysses every rank the same (n steps,
    or one whole-sequence call); windowed hop 0 on every rank plus each
    hop whose keys are all in the window (the rest are plain band
    blocks) on the ranks past it."""
    if variant == "ulysses":
        return n
    if window is not None:
        hops = min(n - 1, -(-(window - 1) // Lc))
        return n + sum(n - m for m in range(1, hops + 1)
                       if window - m * Lc >= Lc)
    if variant == "zigzag" or not causal:
        return n * n
    return n * (n + 1) // 2


class _Recorder:
    """Each ThreadRing rank's calls of the functions the ring modules call
    by name (the flash kernels' wrappers and the plain band blocks),
    recorded as they happen so that a rank's calls can be replayed and
    timed alone afterwards."""

    def __init__(self, threading, modules, names):
        self.local = threading.local()
        self.calls: dict = {}
        self.saved = [(m, n, getattr(m, n)) for m in modules for n in names
                      if hasattr(m, n)]

    def __enter__(self):
        for m, n, fn in self.saved:
            setattr(m, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)

    def _wrap(self, name, fn):
        def wrapped(*a, **kw):
            rank = getattr(self.local, "rank", None)
            if rank is not None:
                self.calls.setdefault(rank, []).append((name, fn, a, kw))
            return fn(*a, **kw)
        return wrapped


def events_ms(torch, fn, iters: int) -> float:
    """One call's ms between CUDA events around ``iters`` calls, after one
    warm-up, from an idle stream."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def sp_kernels(torch, flash, ring_flash, ulysses, collectives, common):
    """K2-K4 inside the sequence-parallel ring on one card: ``ThreadRing``
    at sp 4 (one thread a rank, bf16), each rank calling the ring's
    forward and backward functions directly (``ring_flash_forward`` /
    ``ring_flash_backward``, ``ulysses_flash_forward`` / ``_backward``),
    at gpt2-small width (H12 D64, L 16384: contiguous causal, zigzag,
    Ulysses; bert-base's non-causal contiguous at L 8192) and Llama-3-8B
    width (H32 Hkv8 D128, L 32768: contiguous, zigzag, windows 4096,
    12288 and 16384).

    Held against the whole-sequence kernels (K2 forward, K3 + K4
    backward) on the same inputs.  Tolerances: o within 4 * 2^-9 *
    max|v| (the ring rounds each partial o to bf16 and the merged o once
    more, the whole-sequence kernel once; both round p to bf16 before
    p.v); lse within 1e-3 (f32 sums over up to 32768 terms in another
    grouping, as ``flash_cases``); dq, dk, dv within 4e-2 of each
    tensor's largest |value| (each side within ``flash_bwd_cases``' 2e-2
    of exact; the ring sums bf16-rounded partial gradients in f32).  At
    L 512 the same rings are held against the plain ring
    (``parallel.ring_attention``, f32 on the CPU over ``ThreadRing``,
    autograd for the gradients) or, windowed, the whole-sequence plain
    flash, at the same tolerances.

    The launch counters, zeroed just before each case's ring run and read
    just after, must equal ``sp_calls`` for K2, K3 and K4.  Each rank's
    recorded calls are then replayed alone under CUDA events: its kernel
    device ms (forward and backward) and its band blocks' ms, and the
    max/mean ratio over ranks (the reference's balance claim for zigzag,
    ``k8s_tpu/parallel/ring_flash.py:198-222``)."""
    import threading

    ThreadRing = collectives.ThreadRing
    totals = dict.fromkeys(common.KERNELS, 0)
    out = {}
    g = torch.Generator(device="cuda").manual_seed(17)
    for name, (H, Hkv, D), L, variant, causal, window in SP_CASES:
        Lc = L // SP
        scale = D ** -0.5
        q, do = (torch.randn(1, H, L, D, generator=g, device="cuda"
                             ).to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(1, Hkv, L, D, generator=g, device="cuda"
                            ).to(torch.bfloat16) for _ in range(2))
        if variant == "ulysses":  # Ulysses takes [B, L, H, D] chunks
            k, v = (t.repeat_interleave(H // Hkv, 1) for t in (k, v))
        kw = {} if variant == "ulysses" else dict(
            causal=causal, layout=variant, window=window)
        rec_calls = _Recorder(threading, (ring_flash, ulysses),
                              ("flash_fwd", "flash_bwd", "_band_block",
                               "_band_bwd"))

        def body(ring, q=q, k=k, v=v, do=do, kw=kw, variant=variant,
                 Lc=Lc, rec=rec_calls):
            rec.local.rank = ring.rank
            sl = slice(ring.rank * Lc, (ring.rank + 1) * Lc)
            with torch.no_grad():
                if variant == "ulysses":
                    t = [x.transpose(1, 2)[:, sl] for x in (q, k, v, do)]
                    o, saved = ulysses.ulysses_flash_forward(
                        *t[:3], ring, causal=causal)
                    grads = ulysses.ulysses_flash_backward(saved, t[3], ring,
                                                           causal=causal)
                    # this rank's head group of the whole sequence's lse
                    return (o.transpose(1, 2), saved[4][..., 0],
                            [x.transpose(1, 2) for x in grads])
                o, lse, saved = ring_flash.ring_flash_forward(
                    q[:, :, sl], k[:, :, sl], v[:, :, sl], ring, **kw)
                grads = ring_flash.ring_flash_backward(saved, do[:, :, sl],
                                                       ring, **kw)
                return o, lse, list(grads)

        torch.cuda.synchronize()
        with rec_calls:
            common.reset_launches()
            t0 = time.perf_counter()
            res = ThreadRing.run(SP, body)
            torch.cuda.synchronize()
            ring_wall_ms = (time.perf_counter() - t0) * 1e3
            launches = common.launches()
        calls = sp_calls(variant, causal, window, SP, Lc)
        want = {"flash_fwd": calls, "rms_norm": 0, "flash_bwd_dq": calls,
                "flash_bwd_dkv": calls}
        if launches != want:
            fail(f"sp_kernels {name}: launches {launches}, the ring makes "
                 f"{want}")
        for kname, n in launches.items():
            totals[kname] += n

        # the whole-sequence kernels on the same inputs
        o_ref, lse_ref = flash.flash_fwd(q, k, v, scale, causal, window)
        g_ref = flash.flash_bwd(q, k, v, o_ref, lse_ref, do, scale, causal,
                                window)
        o = torch.cat([r[0] for r in res], dim=2)
        if variant == "ulysses":
            lse = torch.cat([r[1] for r in res], dim=1)
        else:
            lse = torch.cat([r[1] for r in res], dim=2)
        grads = [torch.cat([r[2][i] for r in res], dim=2) for i in range(3)]
        tol_o = 4 * 2 ** -9 * v.float().abs().max().item()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_l = (lse - lse_ref[..., 0]).abs().max().item()
        errs = {}
        for gname, a, r in zip(("dq", "dk", "dv"), grads, g_ref):
            top = r.float().abs().max().item()
            errs[gname] = {"max_abs_err": (a.float() - r.float()).abs()
                           .max().item(), "max_abs": top}
            if not (a.shape == r.shape and a.dtype == r.dtype
                    and errs[gname]["max_abs_err"] <= 4e-2 * top):
                fail(f"sp_kernels {name} {gname}: {errs[gname]} (tol 4e-2 "
                     f"of max), shape {tuple(a.shape)} vs {tuple(r.shape)}")
        if not (err_o <= tol_o and err_l <= 1e-3):
            fail(f"sp_kernels {name}: o err {err_o} (tol {tol_o}), lse err "
                 f"{err_l} (tol 1e-3)")
        del res, o, lse, grads

        # each rank's recorded calls, replayed alone
        per_rank = []
        for r in range(SP):
            mine = rec_calls.calls.get(r, [])
            kern = [c for c in mine if c[0].startswith("flash")]
            band = [c for c in mine if c[0].startswith("_band")]

            def replay(cs):
                return lambda: [fn(*a, **kw2) for _, fn, a, kw2 in cs]

            with torch.no_grad():
                fwd = [c for c in kern if c[0] == "flash_fwd"]
                bwd = [c for c in kern if c[0] == "flash_bwd"]
                t_f = time_ms(torch, replay(fwd), iters=3, warmup=1)
                t_b = time_ms(torch, replay(bwd), iters=3, warmup=1)
                # plain torch: hundreds of small launches, so no spin
                # kernel in front (the events bracket any host gaps too)
                band_ms = events_ms(torch, replay(band), iters=1) \
                    if band else 0.0
            per_rank.append({"rank": r, "flash_calls": len(fwd),
                             "band_blocks": sum(c[0] == "_band_block"
                                                for c in band),
                             "fwd_ms": t_f["ms"], "bwd_ms": t_b["ms"],
                             "kernel_ms": t_f["ms"] + t_b["ms"],
                             "band_ms": band_ms})
        rec_calls.calls.clear()
        with torch.no_grad():
            whole_f = time_ms(torch, lambda: flash.flash_fwd(
                q, k, v, scale, causal, window), iters=3, warmup=1)
            whole_b = time_ms(torch, lambda: flash.flash_bwd(
                q, k, v, o_ref, lse_ref, do, scale, causal, window),
                iters=3, warmup=1)
        ks = [p["kernel_ms"] for p in per_rank]
        rec = {"phase": "sp_kernels", "case": name, "card": REPORT["card"],
               "sp": SP, "H": H, "Hkv": Hkv, "D": D, "L": L, "chunk": Lc,
               "variant": variant, "causal": causal, "window": window,
               "dtype": "torch.bfloat16", "launches": launches,
               "expected_launches": want, "o_max_abs_err": err_o,
               "tol_o": tol_o, "lse_max_abs_err": err_l, "tol_lse": 1e-3,
               "grad_errors": errs, "tol_grad_share_of_max": 4e-2,
               "per_rank": per_rank,
               "rank_kernel_ms_max_over_mean": max(ks) / (sum(ks) / SP),
               "ring_kernel_ms_critical_path": max(ks),
               "whole_sequence_fwd_ms": whole_f["ms"],
               "whole_sequence_bwd_ms": whole_b["ms"],
               "ring_wall_ms": ring_wall_ms}
        emit(rec)
        REPORT.setdefault("sp_kernels", []).append(rec)
        out[name] = rec
        del q, k, v, do, o_ref, lse_ref, g_ref
        gc.collect()
        torch.cuda.empty_cache()
    for w in ("gpt2", "llama"):
        emit({"phase": "sp_balance", "width": w,
              "contiguous_max_over_mean":
                  out[f"{w}_contiguous"]["rank_kernel_ms_max_over_mean"],
              "zigzag_max_over_mean":
                  out[f"{w}_zigzag"]["rank_kernel_ms_max_over_mean"]})
    sp_small(torch, ring_flash, ulysses, collectives)
    return totals


def sp_small(torch, ring_flash, ulysses, collectives):
    """The sp_kernels rings at L 512 on the card against the plain ring
    (``parallel.ring_attention``) run in f32 on the CPU over ThreadRing,
    values and (through autograd) gradients; windowed cases against the
    whole-sequence plain flash on the CPU.  Tolerances as sp_kernels."""
    from k8s_tpu_torch.ops import flash_attention as flash
    from k8s_tpu_torch.parallel import ring_attention

    ThreadRing = collectives.ThreadRing
    g = torch.Generator().manual_seed(19)
    rows = []
    for name, (H, Hkv, D), _, variant, causal, window in SP_CASES:
        L, Lc = SP_SMALL_L, SP_SMALL_L // SP
        q, do = (torch.randn(1, H, L, D, generator=g).to(torch.bfloat16)
                 for _ in range(2))
        k, v = (torch.randn(1, Hkv, L, D, generator=g).to(torch.bfloat16)
                for _ in range(2))
        if variant == "ulysses":
            k, v = (t.repeat_interleave(H // Hkv, 1) for t in (k, v))
        qc, kc, vc, doc = (t.cuda() for t in (q, k, v, do))
        kw = {} if variant == "ulysses" else dict(
            causal=causal, layout=variant, window=window)

        def card(ring, kw=kw, variant=variant, Lc=Lc):
            sl = slice(ring.rank * Lc, (ring.rank + 1) * Lc)
            with torch.no_grad():
                if variant == "ulysses":
                    t = [x.transpose(1, 2)[:, sl] for x in (qc, kc, vc, doc)]
                    o, saved = ulysses.ulysses_flash_forward(
                        *t[:3], ring, causal=causal)
                    grads = ulysses.ulysses_flash_backward(
                        saved, t[3], ring, causal=causal)
                    return [x.transpose(1, 2).cpu() for x in (o, *grads)]
                o, _, saved = ring_flash.ring_flash_forward(
                    qc[:, :, sl], kc[:, :, sl], vc[:, :, sl], ring, **kw)
                grads = ring_flash.ring_flash_backward(
                    saved, doc[:, :, sl], ring, **kw)
                return [x.cpu() for x in (o, *grads)]

        got = ThreadRing.run(SP, card)
        got = [torch.cat([r[i] for r in got], dim=2).float()
               for i in range(4)]
        qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
        if window is not None:
            o, lse = flash.flash_fwd_plain(qf, kf, vf, D ** -0.5, causal,
                                           window)
            want = [o, *flash.flash_bwd_plain(qf, kf, vf, o, lse, dof,
                                              D ** -0.5, causal, window)]
            against = "whole-sequence plain flash (f32, CPU)"
        else:
            def plain(ring, Lc=Lc):
                sl = slice(ring.rank * Lc, (ring.rank + 1) * Lc)
                ins = [x[:, :, sl].transpose(1, 2).clone().requires_grad_()
                       for x in (qf, kf, vf)]
                rep = H // Hkv if variant != "ulysses" else 1
                kk, vv = (x.repeat_interleave(rep, 2) for x in ins[1:])
                o = ring_attention.ring_attention_local(ins[0], kk, vv, ring,
                                                        causal=causal)
                o.backward(dof[:, :, sl].transpose(1, 2))
                return [x.transpose(1, 2).detach()
                        for x in (o, *(t.grad for t in ins))]

            res = ThreadRing.run(SP, plain)
            want = [torch.cat([r[i] for r in res], dim=2) for i in range(4)]
            against = "plain ring (parallel.ring_attention, f32, CPU)"
        tol_o = 4 * 2 ** -9 * vf.abs().max().item()
        err = {n: (a - b).abs().max().item()
               for n, a, b in zip(("o", "dq", "dk", "dv"), got, want)}
        tops = {n: b.abs().max().item()
                for n, b in zip(("o", "dq", "dk", "dv"), want)}
        if not (err["o"] <= tol_o and all(err[n] <= 4e-2 * tops[n]
                                          for n in ("dq", "dk", "dv"))):
            fail(f"sp_small {name}: errors {err}, largest {tops} (o tol "
                 f"{tol_o}, gradients 4e-2 of the largest)")
        rows.append({"case": name, "L": L, "against": against,
                     "max_abs_err": err, "max_abs": tops, "tol_o": tol_o})
    rec = {"phase": "sp_small", "sp": SP, "cases": rows}
    emit(rec)
    REPORT["sp_small"] = rec


SP_MODEL_L = 8192


def sp_model(torch, tlib, bridge, collectives, common):
    """The gpt2-small Transformer (12 layers, width 768, 12 heads, vocab
    32000, bf16, flash on, random weights from a seed) at L 8192: the
    forward under no_grad with sp 4 over ThreadRing (each thread a rank
    calling the model on its chunk, ``forward(mesh=MeshRings)``) for the
    flash ring contiguous and zigzag and Ulysses, against the unsharded
    model (K2 over the whole sequence) on the card.  Logits within 5e-2
    of the largest (through 12 random bf16 layers a one-step bf16
    difference in one attention output moves later activations, as
    ``check_against_plain``); the argmax agreement is reported.  Exact
    K2 launches: 12 layers x the ring's calls, no other kernel."""
    ThreadRing, MeshRings = collectives.ThreadRing, collectives.MeshRings
    cfg = tlib.TransformerConfig(
        vocab_size=32000, hidden=768, ffn_hidden=3072, layers=12, heads=12,
        kv_heads=12, max_seq_len=SP_MODEL_L, dtype=torch.bfloat16,
        use_flash_attention=True, remat=False)
    params = bridge.init_params(cfg, seed=23, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (1, SP_MODEL_L),
                           generator=torch.Generator().manual_seed(24)
                           ).cuda()
    whole = tlib.Transformer(cfg, params, device="cuda")
    with torch.no_grad():
        want = whole(tokens)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        whole(tokens)
        torch.cuda.synchronize()
        whole_ms = (time.perf_counter() - t0) * 1e3
    totals = dict.fromkeys(common.KERNELS, 0)
    rows = {}
    Lc = SP_MODEL_L // SP
    for variant, kw in (("contiguous", {}),
                        ("zigzag", {"ring_layout": "zigzag"}),
                        ("ulysses", {"sp_strategy": "ulysses"})):
        model = tlib.Transformer(dataclasses.replace(
            cfg, use_ring_attention=True, **kw), params, device="cuda")

        def body(ring, model=model):
            with torch.no_grad():
                sl = slice(ring.rank * Lc, (ring.rank + 1) * Lc)
                return model(tokens[:, sl], mesh=MeshRings(sp=ring))

        body_calls = sp_calls(variant, True, None, SP, Lc)
        ThreadRing.run(SP, body)  # warm
        torch.cuda.synchronize()
        common.reset_launches()
        t0 = time.perf_counter()
        res = ThreadRing.run(SP, body)
        torch.cuda.synchronize()
        ring_ms = (time.perf_counter() - t0) * 1e3
        launches = common.launches()
        expect = {"flash_fwd": cfg.layers * body_calls, "rms_norm": 0,
                  "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        if launches != expect:
            fail(f"sp_model {variant}: launches {launches}, expected "
                 f"{expect}")
        for kname, n in launches.items():
            totals[kname] += n
        got = torch.cat(res, dim=1)
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            fail(f"sp_model {variant}: logits {tuple(got.shape)}, finite "
                 f"{bool(torch.isfinite(got).all())}")
        rel = ((got - want).abs().max() / want.abs().max()).item()
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        if rel > 5e-2:
            fail(f"sp_model {variant}: logits rel err {rel} (tol 5e-2)")
        rows[variant] = {"launches": launches, "logits_rel_err": rel,
                         "argmax_agreement": agree, "ring_wall_ms": ring_ms}
        del model, res, got
    rec = {"phase": "sp_model", "card": REPORT["card"],
           "config": "gpt2-small (12 x 768, 12 heads, vocab 32000) bf16 "
                     "flash, random weights (seed 23), B1 L8192, sp 4 over "
                     "ThreadRing, forward under no_grad",
           "variants": rows, "tol_rel": 5e-2,
           "whole_sequence_wall_ms": whole_ms}
    emit(rec)
    REPORT["sp_model"] = rec
    del whole, want, params
    gc.collect()
    torch.cuda.empty_cache()
    return totals


# -- phase 11: pipeline and expert parallelism -----------------------------


PP = 4  # ThreadRing pp and ep ranks on the one card
PP_M = 8
PP_WARM, PP_TIMED = 2, 3
PP_SCHEDULES = (("1f1b", 1), ("interleaved", 3))
PP_LOSS_BOUND = 1e-2
PP_LLAMA_M, PP_LLAMA_STEPS = 4, 2
EP_ARGMAX = 0.9


class _StageCalls:
    """Each pp rank's flash calls, recorded as they happen so that a
    rank's calls can be replayed and timed alone afterwards: the forward
    (``_launch``, K2) from the rank's own thread, and the backward
    (``flash_bwd``, K3 + K4), which CUDA's autograd engine runs on its
    device thread, by the rank whose forward made its saved q (the
    storage stays that forward's until its backward has run)."""

    def __init__(self, threading, flash):
        self.local = threading.local()
        self.flash = flash
        self.owner: dict = {}
        self.calls: dict = {}
        self.saved = [(n, getattr(flash, n)) for n in ("_launch",
                                                       "flash_bwd")]

    def __enter__(self):
        for n, fn in self.saved:
            setattr(self.flash, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved:
            setattr(self.flash, n, fn)

    def _wrap(self, name, fn):
        def wrapped(*a, **kw):
            q = a[0]
            if name == "_launch":
                rank = getattr(self.local, "rank", None)
                self.owner[q.data_ptr()] = rank
            else:
                rank = self.owner.get(q.data_ptr())
            if rank is not None:
                self.calls.setdefault(rank, []).append((fn, a, kw))
            return fn(*a, **kw)
        return wrapped

    def device_ms(self, torch) -> list:
        """Each rank's recorded calls replayed alone, queued behind the
        spin kernel (``time_ms``): kernel device ms.  (From an idle
        stream these small calls would time the host's launches.)"""
        out = []
        for rank in sorted(self.calls):
            calls = self.calls[rank]
            out.append(time_ms(torch, lambda calls=calls: [
                fn(*a, **kw) for fn, a, kw in calls], iters=2,
                warmup=1)["ms"])
        return out


def _stage_states(torch, pp_lm, train_lib, cfg, params, opt, v):
    return [train_lib.init_state(pp_lm.LmStage(
        cfg, params, rank=r, num_stages=PP, num_virtual=v, device="cuda"),
        opt) for r in range(PP)]


def _pp_step(torch, pp_lm, collectives, cfg, opt, states, stats, batch, M,
             v, calls=None):
    """One pp train step over ThreadRing ranks (each thread a rank calling
    ``make_pp_train_step``'s step on its state); returns the loss."""

    def body(rings):
        r = rings.pp.rank
        if calls is not None:
            calls.local.rank = r
        step = pp_lm.make_pp_train_step(cfg, opt, rings, num_microbatches=M,
                                        num_virtual=v, stats=stats[r])
        states[r], loss = step(states[r], batch)
        return loss

    losses = collectives.ThreadRing.run_mesh(1, 1, body, pp=PP)
    return losses[0]


def pp_train(torch, tlib, bridge, train_lib, train_lm, pp_lm, pipeline,
             collectives, flash, common):
    """gpt2-small at full width and depth (12 layers, bf16 over f32
    masters, flash on, B8 L1024, AdamW 1e-4 wd 0.01, clip 0.1: active)
    on four pp ``ThreadRing`` ranks (threads of this process, each
    running ``pp_lm.make_pp_train_step`` on its ``LmStage``): 1F1B (3
    blocks a stage) and interleaved at v 3 (1 block a chunk), M 8, each
    2 warm-up and 3 timed steps, in turns with the unpipelined
    ``train.make_train_step`` from the same weights and batches (plain,
    1F1B, interleaved each step).  Each step's loss against the plain
    step's (bound ``PP_LOSS_BOUND``); exact launches a step, zeroed just
    before it: K2 12 x M x 2 (the forward stream and the recompute), K3 =
    K4 12 x M, the plain step 12 each; peak memory and each rank's most
    stashed inputs against ``peak_activation_microbatches``; then one
    more step with each rank's flash calls recorded and replayed alone
    (kernel device ms a rank, max/mean).  Four threads on one card
    measure neither the bubble nor pp throughput: the ranks' kernels
    serialize on the one device and one host issues for all four."""
    import threading

    cfg = train_lm.build_config(train_lm.parse_args(TRAIN_ARGS), True)
    params = bridge.init_params(cfg, 0, "cuda", dtype=torch.float32)
    gen = torch.Generator().manual_seed(33)
    n_steps = PP_WARM + PP_TIMED
    batches = [torch.randint(0, cfg.vocab_size, (8, 1024), generator=gen
                             ).cuda() for _ in range(n_steps + 1)]
    opt = train_lib.default_optimizer(1e-4, weight_decay=0.01,
                                      clip_norm=0.1)
    plain = train_lib.init_state(tlib.Transformer(
        cfg, params, device="cuda", trainable=True), opt)
    plain_step = train_lib.make_train_step(lambda m, x: m(x),
                                           train_lib.lm_loss, opt)
    runs = {name: {"states": _stage_states(torch, pp_lm, train_lib, cfg,
                                           params, opt, v),
                   "stats": [{} for _ in range(PP)], "v": v}
            for name, v in PP_SCHEDULES}
    del params
    per = 12 * PP_M
    want = {"flash_fwd": 2 * per, "rms_norm": 0, "flash_bwd_dq": per,
            "flash_bwd_dkv": per}
    want_plain = {"flash_fwd": 12, "rms_norm": 0, "flash_bwd_dq": 12,
                  "flash_bwd_dkv": 12}
    rec = {name: {"losses": [], "step_ms": [], "peak_gib": [],
                  "extra_gib": [], "grad_norm": [], "launches": None}
           for name in ("plain", *runs)}
    totals = dict.fromkeys(common.KERNELS, 0)
    for i in range(n_steps):
        b = (batches[i], batches[i])
        for name in ("plain", *runs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            common.reset_launches()
            t0 = time.perf_counter()
            if name == "plain":
                plain, loss = plain_step(plain, b)
            else:
                run = runs[name]
                loss = _pp_step(torch, pp_lm, collectives, cfg, opt,
                                run["states"], run["stats"], b, PP_M,
                                run["v"])
            loss = loss.item()  # syncs
            ms = (time.perf_counter() - t0) * 1e3
            launches = common.launches()
            r = rec[name]
            r["losses"].append(loss)
            r["step_ms"].append(ms)
            r["peak_gib"].append(torch.cuda.max_memory_allocated() / 2 ** 30)
            r["extra_gib"].append(
                (torch.cuda.max_memory_allocated() - before) / 2 ** 30)
            expect = want_plain if name == "plain" else want
            if launches != expect:
                fail(f"pp_train {name} step {i}: launches {launches}, "
                     f"expected {expect}")
            r["launches"] = launches
            if name != "plain":
                r["grad_norm"].append(
                    float(runs[name]["stats"][0]["grad_norm"]))
                for k, n in launches.items():
                    totals[k] += n
    for name, run in runs.items():
        r = rec[name]
        diffs = [abs(a - b) for a, b in zip(r["losses"],
                                            rec["plain"]["losses"])]
        r["max_loss_diff"] = max(diffs)
        if not all(map(math.isfinite, r["losses"])) \
                or r["max_loss_diff"] > PP_LOSS_BOUND:
            fail(f"pp_train {name}: losses {r['losses']} against plain "
                 f"{rec['plain']['losses']} (bound {PP_LOSS_BOUND})")
        if min(r["grad_norm"]) < 0.1:
            fail(f"pp_train {name}: the clip at 0.1 was not active "
                 f"(norms {r['grad_norm']})")
        sched = "interleaved" if run["v"] > 1 else "1f1b"
        r["peak_stashed_by_rank"] = [s["peak_stashed"] for s in run["stats"]]
        r["peak_activation_microbatches"] = \
            pipeline.peak_activation_microbatches(sched, PP_M, PP, run["v"])
        if max(r["peak_stashed_by_rank"]) > r["peak_activation_microbatches"]:
            fail(f"pp_train {name}: stashed {r['peak_stashed_by_rank']} "
                 f"past the schedule's {r['peak_activation_microbatches']}")
        r["stash_bytes_a_microbatch"] = 1024 * cfg.hidden * 2
        r["bubble_fraction"] = pipeline.bubble_fraction(sched, PP_M, PP,
                                                        run["v"])
        with _StageCalls(threading, flash) as calls:
            b = (batches[n_steps], batches[n_steps])
            _pp_step(torch, pp_lm, collectives, cfg, opt, run["states"],
                     run["stats"], b, PP_M, run["v"], calls)
            torch.cuda.synchronize()
        ms = calls.device_ms(torch)
        # each rank's 12 / PP blocks: two forwards and a backward a
        # microbatch
        if len(ms) != PP or any(len(c) != 3 * (12 // PP) * PP_M
                                for c in calls.calls.values()):
            fail(f"pp_train {name}: recorded calls by rank "
                 f"{ {k: len(c) for k, c in calls.calls.items()} }")
        r["rank_kernel_ms"] = ms
        r["rank_max_over_mean"] = max(ms) / (sum(ms) / len(ms))
        del calls
    for name in ("plain", *runs):
        r = rec[name]
        r["median_timed_step_ms"] = sorted(r["step_ms"][PP_WARM:])[
            PP_TIMED // 2]
    out = {"phase": "pp_train", "card": REPORT["card"],
           "config": "gpt2-small (12 x 768, 12 heads, vocab 32000) bf16 "
                     "over f32 masters, flash on, B8 L1024, AdamW 1e-4 wd "
                     "0.01 clip 0.1, random weights (seed 0); 4 pp "
                     "ThreadRing ranks, M 8: 1F1B and interleaved v 3, in "
                     "turns with the unpipelined step",
           "warm_steps": PP_WARM, "timed_steps": PP_TIMED,
           "loss_bound": PP_LOSS_BOUND, "runs": rec,
           "expected_launches": {"pp": want, "plain": want_plain}}
    emit(out)
    REPORT["pp_train"] = out
    del runs, plain
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def pp_llama(torch, tlib, bridge, train_lib, pp_lm, pipeline, collectives,
             flash, common):
    """``llama_8b()`` widths (H32, Hkv8, D128, vocab 128256, bf16 over f32
    masters, flash on), ``reduced`` to 4 layers (one a stage), B4 L2048,
    1F1B with M 4 over four pp ``ThreadRing`` ranks, AdamW 1e-4, clip
    1.0, 2 steps: exact launches a step (K2 4 x M x 2, K3 = K4 4 x M),
    finite losses, peak memory, each rank's most stashed inputs, and the
    second step's flash calls replayed alone by rank.  Ranks 0 and 3 each
    hold the tied 525M-parameter embedding with its moments."""
    import threading

    cfg = dataclasses.replace(tlib.llama_8b(), layers=4, remat=False,
                              use_flash_attention=True, max_seq_len=2048)
    gen = torch.Generator().manual_seed(34)
    batches = [torch.randint(0, cfg.vocab_size, (4, 2048), generator=gen
                             ).cuda() for _ in range(PP_LLAMA_STEPS)]
    opt = train_lib.default_optimizer(1e-4, weight_decay=0.01, clip_norm=1.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = bridge.init_params(cfg, 0, "cuda", dtype=torch.float32)
    n_params = sum(t.numel() for t in params.values())
    states = _stage_states(torch, pp_lm, train_lib, cfg, params, opt, 1)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    stats = [{} for _ in range(PP)]
    want = {"flash_fwd": 2 * cfg.layers * PP_LLAMA_M, "rms_norm": 0,
            "flash_bwd_dq": cfg.layers * PP_LLAMA_M,
            "flash_bwd_dkv": cfg.layers * PP_LLAMA_M}
    totals = dict.fromkeys(common.KERNELS, 0)
    losses, step_ms, peaks = [], [], []
    calls = _StageCalls(threading, flash)
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        common.reset_launches()
        t0 = time.perf_counter()
        if i == len(batches) - 1:
            with calls:
                loss = _pp_step(torch, pp_lm, collectives, cfg, opt, states,
                                stats, (b, b), PP_LLAMA_M, 1, calls)
        else:
            loss = _pp_step(torch, pp_lm, collectives, cfg, opt, states,
                            stats, (b, b), PP_LLAMA_M, 1)
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = common.launches()
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        if launches != want:
            fail(f"pp_llama step {i}: launches {launches}, expected {want}")
        for k, n in launches.items():
            totals[k] += n
    if not all(map(math.isfinite, losses)):
        fail(f"pp_llama: losses {losses}")
    ms = calls.device_ms(torch)
    del calls
    out = {"phase": "pp_llama", "card": REPORT["card"],
           "config": "llama_8b widths (32/8 heads, D128, vocab 128256) bf16 "
                     "over f32 masters, flash on, random weights (seed 0); "
                     "4 pp ThreadRing ranks, 1F1B M 4, B4 L2048, AdamW 1e-4 "
                     "clip 1.0",
           "reduced": {"layers": [32, 4]}, "params": n_params,
           "losses": losses, "step_ms": step_ms, "peak_gib": peaks,
           "grad_norm": [float(stats[0]["grad_norm"])],
           "peak_stashed_by_rank": [s["peak_stashed"] for s in stats],
           "peak_activation_microbatches":
               pipeline.peak_activation_microbatches("1f1b", PP_LLAMA_M, PP),
           "stash_bytes_a_microbatch": 2048 * cfg.hidden * 2,
           "rank_kernel_ms": ms,
           "rank_max_over_mean": max(ms) / (sum(ms) / len(ms)),
           "launches": want}
    emit(out)
    REPORT["pp_llama"] = out
    del states
    gc.collect()
    torch.cuda.empty_cache()
    return totals


class _RankOf(object):
    """A rank's place on a ring, without its links: what ``MoeMLP.place_``
    slices the experts by (the ring itself is bound in the rank's
    thread)."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size


def ep_moe(torch, tlib, bridge, common, moe, collectives):
    """Llama-3-8B widths with Mixtral-8x7B's 8 experts, top-2 (``moe_config``:
    bf16, flash and fused norm on), ``reduced`` to the 2 layers of
    ``moe_train``, B1 L2048, served weights from a seed, with four ep
    ``ThreadRing`` ranks of 2 experts each (``MoeMLP.place_``):

    - each MoE layer on the unsharded model's own input to it: the ep
      ranks' output within 2 bf16 steps (2^-7) of the largest against
      the unsharded layer's (only the f32 sum over the ranks' experts is
      reassociated), and every rank's kept pairs by expert
      (``RouteStats``) equal to the unsharded router's;
    - the whole forward under no_grad: exact launches (K1 4 x (2*2+1),
      K2 4 x 2), the four ranks' logits bit-equal (the replicated part
      runs alike everywhere), and against the unsharded model's logits
      the argmax agreement (at least ``EP_ARGMAX``) and the largest
      difference.  No tight bound holds there: a last-bit difference
      in a layer's output can move a near tie of the next layer's
      router, and with it which tokens its capacity drops.

    Then a probe of the ep backward on the card (``ep_backward_probe``)."""
    MeshRings = collectives.MeshRings
    cfg = moe_config(tlib, torch, layers=2, remat=False)
    params = bridge.init_params(cfg, 41, "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048),
                           generator=torch.Generator().manual_seed(42)
                           ).cuda()
    whole = tlib.Transformer(cfg, params, device="cuda")
    seen = []

    def keep_io(m, a, out):
        seen.append((a[0], out[0]))

    hooks = [b.moe_mlp.register_forward_hook(keep_io) for b in whole.layers]
    with torch.no_grad():
        want = whole(tokens)
    for h in hooks:
        h.remove()
    routing_whole = []
    for i, (x, _) in enumerate(seen):
        with torch.no_grad(), RouteStats(torch, moe, whole) as rs:
            whole.layers[i].moe_mlp(x)
        routing_whole.append(rs.result()["kept_by_expert"])
    del whole
    models = []
    for r in range(PP):
        m = tlib.Transformer(cfg, params, device="cuda")
        for block in m.layers:
            block.moe_mlp.place_(MeshRings(ep=_RankOf(r, PP)))
        models.append(m)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    def bind(rings):
        m = models[rings.ep.rank]
        for block in m.layers:
            block.moe_mlp.ep = rings.ep
        return m

    def layers(rings):
        m, out = bind(rings), []
        for i, (x, _) in enumerate(seen):
            with torch.no_grad(), RouteStats(torch, moe, m) as rs:
                y, _ = m.layers[i].moe_mlp(x)
            out.append((y, rs.result()["kept_by_expert"]))
        return out

    layer_errs = []
    for r, res in enumerate(collectives.ThreadRing.run_mesh(1, 1, layers,
                                                            ep=PP)):
        for i, (y, kept) in enumerate(res):
            y_want = seen[i][1]
            err = ((y.float() - y_want.float()).abs().max()
                   / y_want.float().abs().max()).item()
            layer_errs.append(err)
            if err > 2 ** -7 or kept != routing_whole[i]:
                fail(f"ep_moe rank {r} layer {i}: rel err {err} (tol "
                     f"2^-7), kept {kept} against {routing_whole[i]}")

    def body(rings):
        with torch.no_grad():
            return bind(rings)(tokens)

    collectives.ThreadRing.run_mesh(1, 1, body, ep=PP)  # warm
    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    got = collectives.ThreadRing.run_mesh(1, 1, body, ep=PP)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = common.launches()
    expect = {"flash_fwd": PP * cfg.layers, "rms_norm":
              PP * (2 * cfg.layers + 1), "flash_bwd_dq": 0,
              "flash_bwd_dkv": 0}
    if launches != expect:
        fail(f"ep_moe: launches {launches}, expected {expect}")
    logits = got[0]
    if logits.shape != want.shape or not bool(torch.isfinite(logits).all()) \
            or any(not torch.equal(g, logits) for g in got[1:]):
        fail(f"ep_moe: logits {tuple(logits.shape)}, finite, equal on "
             "every rank?")
    err = ((logits - want).abs().max() / want.abs().max()).item()
    agree = (logits.argmax(-1) == want.argmax(-1)).float().mean().item()
    if agree < EP_ARGMAX:
        fail(f"ep_moe: argmax agreement {agree} (at least {EP_ARGMAX})")
    del models, got, want, seen
    gc.collect()
    torch.cuda.empty_cache()
    out = {"phase": "ep_moe", "card": REPORT["card"],
           "config": "llama_8b width + 8 experts top-2 cf 1.25, bf16, flash "
                     "+ fused norm, served weights (seed 41), B1 L2048, 4 ep "
                     "ThreadRing ranks x 2 experts, forward under no_grad",
           "reduced": {"layers": [32, 2]},
           "layer_rel_err_by_rank": layer_errs, "layer_tol_rel": 2 ** -7,
           "kept_by_expert_unsharded": routing_whole,
           "kept_equal_on_every_rank": True,
           "logits_rel_err": err, "argmax_agreement": agree,
           "argmax_bound": EP_ARGMAX, "ranks_bit_equal": True,
           "ep_wall_ms": wall_ms, "launches": launches,
           "backward_probe": ep_backward_probe(torch, tlib, bridge, moe,
                                               collectives)}
    emit(out)
    REPORT["ep_moe"] = out
    return launches


def ep_backward_probe(torch, tlib, bridge, moe, collectives) -> dict:
    """The tiny MoE Transformer (4 experts, f32) at ep 2 over ThreadRing
    on the card, forward and backward in each rank's thread with a 10 s
    ring timeout.  Finishing, its gradients must equal the unsharded
    model's (2e-5 of each tensor's largest); a timeout is the engine's
    one device thread serializing the ranks' backward (recorded, not a
    failure: the ep train step is held against JAX over gloo processes
    on the CPU, tests/test_torch_moe_ep.py)."""
    cfg = dataclasses.replace(tlib.tiny_test(), num_experts=4)
    sd = bridge.init_params(cfg, 43, "cuda", dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(44)
                           ).cuda()
    whole = tlib.Transformer(cfg, sd, device="cuda", trainable=True)
    aux: list = []
    (whole(tokens, aux_losses=aux).square().mean() + sum(aux)).backward()
    want = {n: p.grad for n, p in whole.named_parameters()}

    def body(rings):
        m = tlib.Transformer(cfg, sd, device="cuda", trainable=True)
        for block in m.layers:
            block.moe_mlp.place_(rings)
        a: list = []
        (m(tokens, aux_losses=a).square().mean() + sum(a)).backward()
        return {n: p.grad for n, p in m.named_parameters()}

    t0 = time.perf_counter()
    try:
        got = collectives.ThreadRing.run_mesh(1, 1, body, ep=2, timeout=10.0)
    except (TimeoutError, RuntimeError) as e:
        if "ThreadRing rank" not in str(e):
            raise
        torch.cuda.synchronize()
        return {"finished": False, "s": time.perf_counter() - t0,
                "error": str(e)}
    worst = 0.0
    for r, grads in enumerate(got):
        for n, g in grads.items():
            w = moe.expert_slice(n, _RankOf(r, 2))(want[n])
            worst = max(worst, ((g - w).abs().max()
                                / w.abs().max().clamp_min(1e-30)).item())
    if worst > 2e-5:
        fail(f"ep backward probe: gradients {worst} off the unsharded")
    return {"finished": True, "s": time.perf_counter() - t0,
            "max_grad_rel_err": worst}


# -- phase 12: tensor-parallel mesh serving ------------------------------------


def mesh_parity(torch, tlib, bridge, engine_lib, mesh_serve, common):
    """The engine on a ``MeshPlacement`` at tp 2 and tp 4 (``ThreadRing``
    ranks on the one card, followers replaying the chief's plan over the
    real plan bus on loopback) against the ``LocalPlacement`` engine on
    the same weights, on the tiny model in f32 with the RMSNorm kernel on:
    greedy, fixed-seed sampled and speculative (greedy and sampled)
    requests give the same tokens; the greedy ones also equal the CPU
    plain engine's.  The counters, zeroed just before the two mesh runs
    and read just after, must show K1 at 2·layers+1 launches a model call
    on every rank (the chief's ``model_calls`` times tp) and no flash
    launch; every rank's pool share must be 1/tp."""
    import numpy as np

    cfg = dataclasses.replace(tlib.tiny_test(), use_flash_attention=True,
                              use_fused_norm=True)
    params = bridge.init_params(cfg, seed=13, device="cpu")
    rng = torch.Generator().manual_seed(15)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()

    rep = [3, 9, 4, 1, 7] * 4
    reqs = [dict(ids=prompt(5), max_new_tokens=8),
            dict(ids=prompt(13), max_new_tokens=6),
            dict(ids=prompt(9), max_new_tokens=8, temperature=0.8, top_k=5,
                 seed=3),
            dict(ids=prompt(7), max_new_tokens=6, temperature=1.0, seed=4),
            dict(ids=rep[:18], max_new_tokens=8, speculative=3),
            dict(ids=rep[:14], max_new_tokens=8, speculative=4,
                 temperature=0.9, seed=21)]
    greedy = [i for i, r in enumerate(reqs) if not r.get("temperature")]
    kw = dict(slots=2, queue_limit=32)

    def run(placement=None, device="cuda", which=range(len(reqs))):
        eng = engine_lib.Engine(cfg, params, placement=placement,
                                device=device, **kw)
        try:
            return [eng.submit(np.asarray(reqs[i]["ids"]),
                               **{k: v for k, v in reqs[i].items()
                                  if k != "ids"}, timeout=300)
                    for i in which], eng.stats()
        finally:
            eng.shutdown()

    t0 = time.perf_counter()
    want, _ = run()
    plain, _ = run(device="cpu", which=greedy)
    if plain != [want[i] for i in greedy]:
        fail(f"mesh_parity: the card's local engine {want} and the CPU "
             f"plain engine {plain} disagree on the greedy requests")
    rec = {"phase": "mesh_parity", "card": REPORT["card"],
           "config": "tiny_test f32 flash+fused", "slots": 2,
           "requests": len(reqs), "tp": {}}
    common.reset_launches()
    calls = {}
    for tp in (2, 4):
        def chief(placement):
            toks, st = run(placement)
            return toks, st, placement.pool_local_fraction
        (toks, st, frac0), reports = mesh_serve.run_in_threads(
            tp, cfg, params, chief, device="cuda", timeout=300)
        if toks != want:
            fail(f"mesh_parity tp {tp}: tokens {toks}, local {want}")
        fracs = [frac0] + [r["pool_local_fraction"] for r in reports]
        if any(f != round(1 / tp, 4) for f in fracs) or \
                (st["placement"], st["tp_degree"]) != ("mesh", tp):
            fail(f"mesh_parity tp {tp}: pool shares {fracs}, stats "
                 f"{st['placement']} tp {st['tp_degree']}")
        calls[tp] = st["model_calls"]
        rec["tp"][str(tp)] = {"model_calls": st["model_calls"],
                              "pool_local_fraction": fracs,
                              "follower_ops": [r["ops"] for r in reports]}
    torch.cuda.synchronize()
    launches = common.launches()
    want_l = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
              "rms_norm": (2 * cfg.layers + 1) * sum(
                  tp * c for tp, c in calls.items())}
    if launches != want_l:
        fail(f"mesh_parity launches {launches}, expected {want_l}")
    rec.update(tokens_equal=True, greedy_equal_cpu_plain=True,
               launches=launches, s=time.perf_counter() - t0)
    emit(rec)
    REPORT["mesh_parity"] = rec
    return launches


# the largest |logit| difference a sound tp 4 mesh may show against the
# whole model on the same prefill (bf16 at Llama-3-8B width: the ranks'
# partial sums round apart from the whole model's products).  On an H100
# a sound mesh read 0.138 (the whole model's own decode paths spread
# 0.139) and a fault planted in rank 0's last o_proj all-reduce 0.836,
# which must exceed it
MESH_LOGIT_BOUND = 0.35


class _SkippedSum:
    """A planted fault: a tp ring whose ``all_reduce`` takes part in the
    collective, so no other rank waits, but returns this rank's own
    partial sum, as a rank that skipped the sum would."""

    def __init__(self, ring):
        self.ring, self.rank, self.size = ring, ring.rank, ring.size

    def all_reduce(self, x):
        self.ring.all_reduce(x)
        return x


def mesh_prefill_logits(torch, eng, ids):
    """A cold prefill of ``ids`` through the mesh engine's own prefill
    body, bucket chunk by chunk, on the engine thread: each chunk goes
    over the plan bus first, so every follower rank replays it.  It
    writes into free blocks of the served pool, which go back to the
    free list after.  Returns the last position's f32 logits ``[V]``."""
    import numpy as np

    from k8s_tpu_torch.models.decode import split_prefill

    bs = eng.block_size

    def run():
        blocks = [eng._alloc_block() for _ in range(-(-len(ids) // bs))]
        try:
            table = np.asarray(blocks, dtype=np.int32)
            off = 0
            for c in split_prefill(len(ids), eng.buckets):
                last = eng._prefill_fn(c)(
                    eng._pool, table[:-(-(off + c) // bs)],
                    np.asarray([ids[off:off + c]], dtype=np.int64),
                    (off + np.arange(c, dtype=np.int64))[None, :])
                off += c
            return last[0].float()
        finally:
            for b in blocks:
                eng._pool_alloc.release(b)
    return eng.submit_exclusive(run, timeout=600)


def mesh_serve_llama(torch, tlib, engine_lib, mesh_serve, common, weights):
    """Tensor-parallel serving at the served width: llama_8b (32 layers,
    bf16, both forward kernels on) on the weights ``serve_engine`` served,
    at tp 4 over ``ThreadRing`` ranks on the one card (rank 0 the engine
    with 4 slots, three followers replaying its plan over the plan bus),
    each rank's model built from its Megatron shard of those weights.
    ``serve_engine``'s 17/64/128/509-token prompts with 4 greedy tokens
    each and one speculative request (draft_k 4, its 128-token prompt),
    submitted together after a one-call warm-up; then its 128-token
    prompt once more through the mesh engine's prefill body, whose
    last-position logits must lie within :data:`MESH_LOGIT_BOUND` of the
    whole model's over the same paged chunks, and once with a fault
    planted in rank 0's last ``o_proj`` all-reduce, whose logits must
    not.  The counters, zeroed just before the ranks start and read once
    all have ended (a follower may launch a call's last norm after the
    chief's last all-reduce), must show K1 at 2·32+1 launches a chief
    model call on each of the 4 ranks and no flash launch.  The greedy
    and speculative tokens are held against ``serve_engine``'s first 4
    for the same prompts by ``token_check``; every rank's measured pool
    share must be 0.25.  Reports each rank's pool and params shares, the
    plan bus's counters, peak memory and the aggregate decode tokens/s
    beside ``serve_engine``'s (context only: four ranks on one card are
    not faster; each rank's host ops are the bound, chip_profile.py
    --path mesh)."""
    cfg = dataclasses.replace(tlib.llama_8b(), use_flash_attention=True,
                              use_fused_norm=True, dtype=torch.bfloat16)
    kept = KEPT["serve_engine"]
    prompts = kept["prompts"]
    whole = tlib.Transformer(cfg, weights, device="cuda")
    new = 4  # of serve_engine's 8: each chief call takes ~1 s
    reqs = {f"greedy_{n}": dict(ids=prompts[n], max_new_tokens=new)
            for n in (17, 64, 128, 509)}
    reqs["spec_128"] = dict(ids=prompts[128], max_new_tokens=new,
                            speculative=4)
    check_ids = list(prompts[128])
    # one model call: each rank thread's cuBLAS handle and allocator
    # warm before the timed batch
    warm = torch.randint(0, cfg.vocab_size, (1,),
                         generator=torch.Generator().manual_seed(9)).tolist()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30

    def chief(placement):
        t0 = time.perf_counter()
        eng = engine_lib.Engine(cfg, weights, slots=4, queue_limit=32,
                                placement=placement)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        out: dict = {}
        try:
            eng.submit(warm, 1, timeout=600)
            st0 = eng.stats()

            def client(name):
                r = reqs[name]
                out[name] = eng.submit(r["ids"], r["max_new_tokens"],
                                       **{k: v for k, v in r.items()
                                          if k not in ("ids",
                                                       "max_new_tokens")},
                                       timeout=600)
            threads = [threading.Thread(target=client, args=(n,))
                       for n in reqs]
            t_batch = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            batch_s = time.perf_counter() - t_batch
            st1 = eng.stats()
            t_check = time.perf_counter()
            logits = {"sound": mesh_prefill_logits(torch, eng, check_ids)}
            attn = eng._compute.model.layers[-1].attn
            ring = attn.tp
            attn.tp = _SkippedSum(ring)
            try:
                logits["fault"] = mesh_prefill_logits(torch, eng, check_ids)
            finally:
                attn.tp = ring
            check_s = time.perf_counter() - t_check
            st2 = eng.stats()
        finally:
            eng.shutdown()
        return {"tokens": out, "st0": st0, "st1": st1, "st2": st2,
                "batch_s": batch_s, "setup_s": setup_s, "check_s": check_s,
                "logits": logits, "buckets": eng.buckets,
                "pool_local_fraction": placement.pool_local_fraction,
                "params_local_fraction": placement.params_local_fraction,
                "plan_bus": placement.plan_bus_stats(),
                "pool_gib": sum(t.numel() * t.element_size()
                                for node in eng._pool
                                for t in node.values()) / 2 ** 30}

    t0 = time.perf_counter()
    # the main path's run, warm-up included: counters zeroed just before,
    # read once every rank has ended (a follower's last launches of a call
    # may follow the chief's last all-reduce, so not before its bye)
    common.reset_launches()
    res, reports = mesh_serve.run_in_threads(4, cfg, weights, chief,
                                             device="cuda", timeout=900)
    torch.cuda.synchronize()
    res["launches"] = common.launches()
    wall_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    toks = res["tokens"]
    if len(toks) != len(reqs) or any(
            len(t) != new or not all(0 <= x < cfg.vocab_size for x in t)
            for t in toks.values()):
        fail(f"mesh_serve: answers {toks}")
    calls = res["st2"]["model_calls"]
    want_l = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
              "rms_norm": (2 * cfg.layers + 1) * 4 * calls}
    if res["launches"] != want_l:
        fail(f"mesh_serve launches {res['launches']}, expected {want_l} "
             f"({calls} chief model calls, 4 ranks)")
    fracs = [res["pool_local_fraction"]] + [r["pool_local_fraction"]
                                            for r in reports]
    if fracs != [0.25] * 4:
        fail(f"mesh_serve: measured pool shares {fracs}, want 0.25 each")
    ref = path_logits(torch, whole, check_ids, res["buckets"])
    errs = {k: (v - ref["paged"]).abs().max().item()
            for k, v in res["logits"].items()}
    logit_check = {"prompt_len": len(check_ids), "bound": MESH_LOGIT_BOUND,
                   "max_abs_err": errs["sound"],
                   "max_abs_err_vs_flash_prefill": (
                       res["logits"]["sound"] - ref["prefill"]).abs().max()
                   .item(),
                   "planted_fault_max_abs_err": errs["fault"],
                   "whole_model_path_spread": max(
                       (x - ref["prefill"]).abs().max().item()
                       for k, x in ref.items() if k != "prefill")}
    if not all(torch.isfinite(v).all() for v in res["logits"].values()):
        fail("mesh_serve: non-finite prefill logits")
    if not errs["sound"] <= MESH_LOGIT_BOUND:
        fail(f"mesh_serve: tp 4 prefill logits {errs['sound']} from the "
             f"whole model's, bound {MESH_LOGIT_BOUND}")
    if not errs["fault"] > MESH_LOGIT_BOUND:
        fail(f"mesh_serve: a skipped all-reduce moved the logits only "
             f"{errs['fault']}, within the bound {MESH_LOGIT_BOUND}: the "
             "check cannot see a wrong rank")
    checks = {}
    for name, n in (("greedy_17", 17), ("greedy_64", 64),
                    ("greedy_128", 128), ("greedy_509", 509),
                    ("spec_128", 128)):
        checks[name] = token_check(
            torch, whole, prompts[n], toks[name],
            kept["tokens"][n][:new],
            f"mesh_serve {name} (tp 4) vs serve_engine", kept["buckets"])
    emitted = sum(len(t) - 1 for t in toks.values())
    engine_tps = REPORT["serve_engine"]["batch"]["decode_tokens_per_s"]
    rec = {"phase": "mesh_serve", "card": REPORT["card"],
           "config": "llama_8b bf16 flash+fused, MeshPlacement tp 4 "
                     "(ThreadRing ranks, plan bus on loopback), slots 4",
           "layers": cfg.layers, "tp": 4, "requests": sorted(reqs),
           "new_tokens": new, "setup_s": res["setup_s"], "wall_s": wall_s,
           "batch_s": res["batch_s"], "logit_check_s": res["check_s"],
           "decode_tokens": emitted,
           "batch_model_calls": res["st1"]["model_calls"]
           - res["st0"]["model_calls"],
           "s_per_batch_model_call": res["batch_s"] / max(
               1, res["st1"]["model_calls"] - res["st0"]["model_calls"]),
           "decode_tokens_per_s": emitted / res["batch_s"],
           "serve_engine_decode_tokens_per_s": engine_tps,
           "model_calls": calls, "launches": res["launches"],
           "expected_launches": want_l,
           "pool_local_fraction": fracs,
           "params_local_fraction": [res["params_local_fraction"]]
           + [r["params_local_fraction"] for r in reports],
           "follower_ops": [r["ops"] for r in reports],
           "pool_gib_per_rank": res["pool_gib"],
           "plan_bus": res["plan_bus"],
           "memory_allocated_before_gib": base_gib,
           "max_memory_allocated_gib": peak_gib,
           "prefill_logits_vs_whole": logit_check,
           "tokens_vs_serve_engine": checks,
           "tokens_equal_serve_engine": sum(
               c["equal"] for c in checks.values())}
    emit(rec)
    REPORT["mesh_serve"] = rec
    return res["launches"]


def _server_process(argv: list, env: dict):
    """Start ``python -m k8s_tpu_torch.models.server ...``; returns the
    process, its URL (from its READY line) and the lines it printed."""
    p = subprocess.Popen([sys.executable, "-m", "k8s_tpu_torch.models.server"]
                         + argv, env=env, cwd=REPO, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    lines: list = []
    url = None
    for line in p.stdout:
        lines.append(line)
        if line.startswith("READY "):
            url = line.split()[1]
            break
    if url is None:
        p.wait(timeout=60)
        fail(f"mesh_nccl: the server exited {p.returncode} before READY: "
             + "".join(lines)[-3000:])
    # keep draining, so a chatty server never blocks on a full pipe
    threading.Thread(target=lambda: lines.extend(p.stdout),
                     daemon=True).start()
    return p, url, lines


def mesh_nccl(torch, engine_lib, server, serving, mesh_serve, collectives,
              common):
    """Mesh serving over the one-rank NCCL group ``make_training_mesh``
    made, on the gpt2-small export of the train phase: in process, the
    engine on a ``MeshPlacement`` over the group's ``ProcessGroupRing``
    (tp 1, the RMSNorm kernel turned on: 2·12+1 launches a model call)
    against the ``LocalPlacement`` engine on the same weights; then
    ``python -m k8s_tpu_torch.models.server`` with
    ``K8S_TPU_SERVE_MESH=1`` in a process of its own under the operator's
    one-worker env (``gang_env``): its HTTP answers to three requests
    (greedy, sampled, speculative) must equal a ``LocalPlacement``
    server's on the same artifact, and SIGINT must end it with exit 0."""
    import numpy as np

    export = KEPT["gpt2_export"]
    cfg0, sd = serving.load_for_serving(export, device="cuda")
    cfg = dataclasses.replace(cfg0, use_fused_norm=True)
    ring = mesh_serve.build_serve_mesh()
    if not isinstance(ring, collectives.ProcessGroupRing) or ring.size != 1:
        fail(f"mesh_nccl: the serving ring is {type(ring).__name__} of "
             f"{ring.size}, not the one-rank NCCL group's")
    rng = torch.Generator().manual_seed(21)
    pattern = torch.randint(0, cfg.vocab_size, (9,), generator=rng).tolist()
    reqs = [dict(ids=torch.randint(0, cfg.vocab_size, (40,),
                                   generator=rng).tolist(),
                 max_new_tokens=8),
            dict(ids=torch.randint(0, cfg.vocab_size, (100,),
                                   generator=rng).tolist(),
                 max_new_tokens=8, temperature=0.8, top_k=40, seed=5),
            dict(ids=(pattern * 8)[:64], max_new_tokens=8, speculative=4)]

    def run(placement=None):
        eng = engine_lib.Engine(cfg, sd, slots=2, placement=placement,
                                device="cuda")
        try:
            return [eng.submit(np.asarray(r["ids"]), **{
                k: v for k, v in r.items() if k != "ids"}, timeout=300)
                for r in reqs], eng.stats()
        finally:
            eng.shutdown()

    t0 = time.perf_counter()
    want, _ = run()
    common.reset_launches()
    placement = mesh_serve.MeshPlacement(cfg, ring, device="cuda")
    got, st = run(placement)
    torch.cuda.synchronize()
    launches = common.launches()
    want_l = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
              "rms_norm": (2 * cfg.layers + 1) * st["model_calls"]}
    if got != want or launches != want_l or \
            (st["placement"], st["tp_degree"]) != ("mesh", 1):
        fail(f"mesh_nccl in process: tokens {got} vs local {want}, "
             f"launches {launches} vs {want_l}, stats {st['placement']} "
             f"tp {st['tp_degree']}")
    in_process_s = time.perf_counter() - t0

    # the server entry under K8S_TPU_SERVE_MESH=1, in its own process
    bodies = [{"tokens": r["ids"], **{k: v for k, v in r.items()
                                      if k != "ids"}} for r in reqs]
    lm = server.LmServer(export, device="cuda")
    try:
        local = [lm.generate(server.parse_request(cfg0, b, 8))["tokens"]
                 for b in bodies]
    finally:
        lm.close()
    t1 = time.perf_counter()
    env = {**gang_env(29501), "K8S_TPU_SERVE_MESH": "1",
           "K8S_TPU_SERVE_PLAN_PORT": "0"}
    p, url, lines = _server_process(["--train_dir", export, "--port", "0"],
                                    env)
    try:
        ready_s = time.perf_counter() - t1
        served = [http(url + "/v1/generate", b)[1].get("tokens")
                  for b in bodies]
        health = http(url + "/healthz")[1]["serving"]
        p.send_signal(signal.SIGINT)
        rc = p.wait(timeout=120)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    if served != local or rc != 0 or (health["placement"],
                                      health["tp_degree"]) != ("mesh", 1):
        fail(f"mesh_nccl server: tokens {served} vs local {local}, exit "
             f"{rc}, healthz {health.get('placement')} tp "
             f"{health.get('tp_degree')}: " + "".join(lines)[-2000:])
    rec = {"phase": "mesh_nccl", "card": REPORT["card"],
           "config": "gpt2-small export of train (bf16), fused norm on in "
                     "process; MeshPlacement over the one-rank NCCL group",
           "ring": type(ring).__name__, "in_process_tokens_equal": True,
           "in_process_model_calls": st["model_calls"],
           "launches": launches, "expected_launches": want_l,
           "in_process_s": in_process_s,
           "server": {"env": "K8S_TPU_SERVE_MESH=1 under gang_env",
                      "ready_s": ready_s, "tokens_equal_local": True,
                      "healthz": {k: health[k] for k in (
                          "placement", "num_processes", "mesh_shape",
                          "tp_degree")}, "exit_code": rc},
           "s": time.perf_counter() - t0}
    emit(rec)
    REPORT["mesh_nccl"] = rec
    return launches


def kernel_bodies(recs) -> dict:
    """Every body a kernel's cases ran (``body`` at its padded width
    ``dp``, when the plan has one), with its cases, their largest error,
    its registers, spills and shared memory: the ``kernels`` line's
    ``bodies``."""
    out: dict = {}
    for r in recs:
        if "body" not in r:
            continue
        key = r["body"].split(":", 1)[1] + (f"@{r['dp']}" if "dp" in r
                                            else "")
        b = out.setdefault(key, {"entry": r.get("entry"), "cases": [],
                                 "max_abs_err": 0.0, **{
            f: r.get(f) for f in ("registers", "spill_stores",
                                  "spill_loads", "smem_dynamic_bytes")}})
        b["cases"].append(r["case"])
        b["max_abs_err"] = max(b["max_abs_err"], r.get("max_abs_err") or 0.0)
    return out


# every phase by name, in the order a whole run drives them, and what a
# phase needs run before it (``--phases``)
PHASES = ("kernels", "parity", "engine_parity", "spec_parity",
          "mesh_parity", "train_parity", "moe_parity", "vision_parity",
          "serve", "serve_engine", "spill", "disagg", "bench_serve",
          "bench_kvtier", "bench_serve_mp", "bench_disagg", "serve_spec",
          "beam", "mesh_serve", "train", "grads", "llama_train", "head_dims",
          "moe_train",
          "data", "native_reader", "profile_hook", "resnet", "vit", "bench",
          "mnist",
          "dist_parity", "fsdp_train", "gang", "mesh_nccl", "sp_kernels",
          "sp_model", "pp_train", "pp_llama", "ep_moe", "moe_serve")
NEEDS = {name: ("serve_engine",) for name in (
    "spill", "disagg", "bench_serve", "bench_kvtier", "serve_spec", "beam",
    "mesh_serve")}
NEEDS["mesh_nccl"] = ("train",)  # serves train's gpt2-small export


# Wall seconds of each phase of this run (``phase``), and the watchdog: a
# run still going after WATCHDOG_S seconds dumps every thread's stack and
# exits 1 (``faulthandler``), below the ``start`` line of the phase it was
# in, rather than being cut without a word at the run's 1200 s limit.
WATCHDOG_S = 1080
PHASE_S: dict = {}


@contextlib.contextmanager
def phase(name: str):
    """Print ``{"phase": name, "start": true}``, run the body, then print
    ``{"phase": name, "s": wall seconds}`` and add them to ``PHASE_S``."""
    emit({"phase": name, "start": True})
    t0 = time.perf_counter()
    yield
    secs = time.perf_counter() - t0
    PHASE_S[name] = PHASE_S.get(name, 0.0) + secs
    emit({"phase": name, "s": secs})


def selected_phases(argv) -> frozenset:
    """The phases to run: every one by default, else those named by
    ``--phases`` and what they need."""
    import argparse

    p = argparse.ArgumentParser(
        description="Drive the port on one card (see the module docstring)")
    p.add_argument("--phases", default=None, metavar="NAME,...",
                   help="run only these phases and those they need "
                   f"(default: all): {', '.join(PHASES)}")
    args = p.parse_args(argv)
    if args.phases is None:
        return frozenset(PHASES)
    names = {n.strip() for n in args.phases.split(",") if n.strip()}
    unknown = sorted(names - set(PHASES))
    if unknown or not names:
        p.error(f"unknown phases {unknown}; choose from {', '.join(PHASES)}")
    todo = list(names)
    while todo:
        for need in NEEDS.get(todo.pop(), ()):
            if need not in names:
                names.add(need)
                todo.append(need)
    return frozenset(names)


def main(argv=None) -> int:
    # an overrun dumps every thread's stack (below the start line of the
    # phase it is in) and exits 1, inside a run's 1200 s limit
    t_start = time.perf_counter()
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch

    run = selected_phases(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke runs on the "
             "card")
    sys.path.insert(0, REPO)
    try:
        from k8s_tpu_torch import bench, dist_mnist, trace, train_lm
        from k8s_tpu_torch.harness import bench_disagg, bench_kvtier
        from k8s_tpu_torch.harness import bench_serve, bench_serve_mp
        from k8s_tpu_torch.launcher import bootstrap
        from k8s_tpu_torch.models import bridge, checkpoint, dataset, decode
        from k8s_tpu_torch.models import mesh_serve, moe, mp_serve, pp_lm
        from k8s_tpu_torch.models import mnist, mnist_data, resnet, vit
        from k8s_tpu_torch.models import server, serving
        from k8s_tpu_torch.models import engine as engine_lib
        from k8s_tpu_torch.models import requestlog
        from k8s_tpu_torch.models import train as train_lib
        from k8s_tpu_torch.models import transformer as tlib
        from k8s_tpu_torch.native import dataloader as native_dl
        from k8s_tpu_torch.ops import _build, _common
        from k8s_tpu_torch.ops import flash_attention as flash
        from k8s_tpu_torch.ops import fused_norm
        from k8s_tpu_torch.parallel import collectives, pipeline
        from k8s_tpu_torch.parallel import ring_flash, ulysses
    except ImportError as e:
        fail(f"k8s_tpu_torch is not beside this script ({e}); run it from "
             "a checkout of the repository")
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(OUT_DIR, exist_ok=True)

    card = card_line()
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(card, flush=True)
    emit({"phase": "card", "nvidia_smi": card, "device": name,
          "count": count, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "phases": [p for p in PHASES if p in run]})
    REPORT["card"] = card

    with phase("build"):
        nvcc_s = _build.build_all()
        x = torch.ones(4, 64, device="cuda")
        fused_norm.rms_norm(x, torch.ones(64, device="cuda"))
        torch.cuda.synchronize()
        build = {"phase": "build_report", "nvcc_s": nvcc_s}
        emit(build)
        REPORT["build"] = build
        with open(os.path.join(OUT_DIR, "build_log.txt"), "w") as f:
            for src, text in _build.BUILD_LOGS.items():
                f.write(f"== {src}\n{text}\n")

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # each path's launches (zeroed just before it is driven, read just
    # after), in the order the paths run
    paths: dict = {}
    if "kernels" in run:
        with phase("kernels"):
            rms = rms_cases(torch, F, fused_norm, _build)
            fl = flash_cases(torch, F, flash, _build)
            bw = flash_bwd_cases(torch, F, flash, _build)
            free()
    if "parity" in run:
        with phase("parity"):
            parity(torch, tlib, bridge, decode)
    if "engine_parity" in run:
        with phase("engine_parity"):
            engine_parity(torch, tlib, bridge, decode, engine_lib)
    if "spec_parity" in run:
        with phase("spec_parity"):
            spec_parity(torch, tlib, bridge, decode, engine_lib)
    if "mesh_parity" in run:
        with phase("mesh_parity"):
            paths["mesh_parity"] = mesh_parity(torch, tlib, bridge,
                                               engine_lib, mesh_serve,
                                               _common)
    if "train_parity" in run:
        with phase("train_parity"):
            train_parity(torch, tlib, bridge, train_lib, _common)
    if "moe_parity" in run:
        with phase("moe_parity"):
            moe_parity(torch, tlib, bridge, decode, train_lib, moe)
    if "vision_parity" in run:
        with phase("vision_parity"):
            vision_parity(torch, resnet, vit, mnist, train_lib)
    if "serve" in run:
        with phase("serve"):
            paths["serve_llama_8b"] = serve_main_path(torch, tlib, bridge,
                                                      server, _common)
            free()
    if "serve_engine" in run:
        with phase("serve_engine"):
            paths["serve_engine_llama_8b"], weights = serve_engine(
                torch, tlib, bridge, server, _common, requestlog)
            free()
    if "spill" in run:
        with phase("spill"):
            paths["serve_spill_llama_8b"] = serve_spill(
                torch, tlib, server, _common, requestlog, weights)
            free()
    if "disagg" in run:
        with phase("disagg"):
            paths["serve_disagg_llama_8b"] = serve_disagg(
                torch, tlib, server, _common, requestlog, weights, trace)
            free()
    if "bench_serve" in run:
        with phase("bench_serve"):
            paths["bench_serve_llama_8b"] = bench_serve_llama(
                torch, tlib, bridge, decode, _common, weights, bench_serve)
            free()
    if "bench_kvtier" in run:
        with phase("bench_kvtier"):
            paths["bench_kvtier_llama_8b_seq128"] = bench_kvtier_llama(
                torch, tlib, _common, weights, bench_kvtier)
            free()
    if "bench_serve_mp" in run:
        with phase("bench_serve_mp"):
            paths["bench_serve_mp_nccl_world1"] = bench_serve_mp_card(
                torch, server, mp_serve, bench_serve_mp)
            free()
    if "bench_disagg" in run:
        with phase("bench_disagg"):
            paths["bench_disagg_llama_8b_3_pods"] = bench_disagg_card(
                torch, tlib, decode, engine_lib, _build, bench_disagg)
            free()
    if "serve_spec" in run:
        with phase("serve_spec"):
            spec = serve_spec(torch, tlib, server, _common, weights)
            paths["serve_spec_batched_llama_8b"] = spec["batched"]
            paths["serve_spec_single_flight_llama_8b"] = \
                spec["single_flight"]
            free()
    if "beam" in run:
        with phase("beam"):
            paths["beam_llama_8b"] = beam_llama(torch, tlib, decode,
                                                _common, weights)
            free()
    if "mesh_serve" in run:
        with phase("mesh_serve"):
            paths["serve_mesh_tp4_llama_8b"] = mesh_serve_llama(
                torch, tlib, engine_lib, mesh_serve, _common, weights)
    weights = None
    free()
    if "train" in run:
        with phase("train"):
            paths["train_gpt2_small"], lm_runs = train_main_path(
                torch, train_lm, server, serving, _common, tlib)
            for mode, r in lm_runs.items():
                paths[f"serve_lm_{mode}_gpt2_small"] = r
    if "grads" in run:
        with phase("grads"):
            grads_at_width(torch, tlib, bridge, train_lib, train_lm)
    if "llama_train" in run:
        with phase("llama_train"):
            paths["train_llama_width_2_layers"] = llama_width_training(
                torch, tlib, bridge, train_lib, _common)
            free()
    if "head_dims" in run:
        with phase("head_dims"):
            paths.update(head_dims(torch, tlib, bridge, server, train_lib,
                                   _common, decode))
            free()
    if "moe_train" in run:
        with phase("moe_train"):
            paths["train_moe_llama_width_e8_2_layers"] = moe_train(
                torch, tlib, bridge, train_lib, _common, dataset, moe)
    if "data" in run:
        with phase("data"):
            paths["train_lm_data_dir_gpt2_small"] = data_path(
                torch, train_lm, _common, dataset, native_dl)
            free()
    if "native_reader" in run or "profile_hook" in run:
        with tempfile.TemporaryDirectory() as root:
            with phase("corpus"):
                corpus = write_corpus(dataset, root)
            if "native_reader" in run:
                with phase("native_reader"):
                    paths["native_reader_gpt2_small"] = native_reader(
                        torch, train_lm, _common, dataset, native_dl, root,
                        corpus)
                    free()
            if "profile_hook" in run:
                with phase("profile_hook"):
                    paths["profile_hook_gpt2_small"] = profile_hook(
                        torch, corpus[0])
    if "resnet" in run:
        with phase("resnet"):
            paths["train_resnet50_both_stems"] = resnet_path(torch, bench,
                                                             _common)
    if "vit" in run:
        with phase("vit"):
            paths["train_vit_b16_fused_norm"] = vit_path(
                torch, vit, train_lib, bench, _common)
    if "bench" in run:
        with phase("bench"):
            paths["bench"] = bench_cells(torch, bench, _common)
            free()
    if "mnist" in run:
        with phase("mnist"):
            paths["dist_mnist"] = mnist_path(torch, dist_mnist, mnist,
                                             mnist_data, train_lib, _common)
            free()
    if run & {"dist_parity", "fsdp_train", "gang", "mesh_nccl"}:
        # one process: make_training_mesh makes the one-rank NCCL group
        with phase("nccl_group"):
            mesh, _ = bootstrap.make_training_mesh(
                config=bootstrap.LauncherConfig())
        if "dist_parity" in run:
            with phase("dist_parity"):
                dist_parity(torch, tlib, bridge, train_lib, mesh)
        if "fsdp_train" in run:
            with phase("fsdp_train"):
                paths["train_gpt2_small_fsdp_nccl_world1"] = fsdp_train(
                    torch, tlib, bridge, train_lib, train_lm, _common,
                    checkpoint, mesh)
        if "gang" in run:
            with phase("gang"):
                paths["rendezvous_worker"] = gang_path(torch)
        if "mesh_nccl" in run:
            with phase("mesh_nccl"):
                paths["mesh_nccl_world1_gpt2_small"] = mesh_nccl(
                    torch, engine_lib, server, serving, mesh_serve,
                    collectives, _common)
        torch.distributed.destroy_process_group()
    if "gpt2_export" in KEPT:
        shutil.rmtree(KEPT.pop("gpt2_export"), ignore_errors=True)
    if "sp_kernels" in run:
        with phase("sp_kernels"):
            paths["sp_kernels_thread_ring_sp4"] = sp_kernels(
                torch, flash, ring_flash, ulysses, collectives, _common)
    if "sp_model" in run:
        with phase("sp_model"):
            paths["sp_model_gpt2_small_l8192"] = sp_model(
                torch, tlib, bridge, collectives, _common)
    if "pp_train" in run:
        with phase("pp_train"):
            paths["pp_train_gpt2_small_4_ranks"] = pp_train(
                torch, tlib, bridge, train_lib, train_lm, pp_lm, pipeline,
                collectives, flash, _common)
    if "pp_llama" in run:
        with phase("pp_llama"):
            paths["pp_llama_8b_width_4_layers"] = pp_llama(
                torch, tlib, bridge, train_lib, pp_lm, pipeline,
                collectives, flash, _common)
    if "ep_moe" in run:
        with phase("ep_moe"):
            paths["ep_moe_llama_width_e8_2_layers"] = ep_moe(
                torch, tlib, bridge, _common, moe, collectives)
    free()
    # last: its profiler session slows every later host clock
    if "moe_serve" in run:
        with phase("moe_serve"):
            paths["serve_moe_llama_8b_e8_10_layers"] = moe_serve(
                torch, tlib, bridge, server, _common, requestlog, moe,
                trace)

    # launches: every main path's count, summed, and each path's beside it
    kernels = []
    if "kernels" in run:
        for kname, route, source, replaces, rec in (
                ("flash_fwd", "cuda", "k8s_tpu_torch/csrc/flash_fwd.cu",
                 "k8s_tpu/ops/flash_attention.py:99", fl["gpt2_train"]),
                ("rms_norm", "cuda", "k8s_tpu_torch/csrc/rms_norm.cu",
                 "k8s_tpu/ops/fused_norm.py:29", rms["bf16x_bf16s"]),
                ("flash_bwd_dq", "cuda", "k8s_tpu_torch/csrc/flash_bwd.cuh",
                 "k8s_tpu/ops/flash_attention.py:233",
                 bw[("flash_bwd_dq", "gpt2_train")]),
                ("flash_bwd_dkv", "cuda", "k8s_tpu_torch/csrc/flash_bwd.cuh",
                 "k8s_tpu/ops/flash_attention.py:289",
                 bw[("flash_bwd_dkv", "gpt2_train")])):
            by_path = {path: counts[kname] for path, counts in paths.items()}
            kernels.append({"name": kname, "route": route, "source": source,
                            "replaces": replaces,
                            "launches": sum(by_path.values()),
                            "launches_by_path": by_path,
                            "case": rec["case"],
                            "max_abs_err": rec["max_abs_err"],
                            "ms": rec["ms"], "wall_ms": rec["wall_ms"],
                            "plain_ms": rec["plain_ms"],
                            "bound_ms": rec["bound_ms"],
                            "bound_by": rec["bound_by"],
                            "library_ms": rec["library_ms"],
                            **{key: rec[key] for key in (
                                "body", "plan", "registers", "spill_stores",
                                "spill_loads", "smem_static_bytes",
                                "smem_dynamic_bytes")
                               if key in rec}})
            if kname.startswith("flash"):
                # the padded and Dp-256 bodies at the Phi-3-mini and
                # Gemma-7B attention shapes
                kernels[-1]["head_dim_cases"] = {
                    case: {key: r[key] for key in (
                        "D", "plan", "max_abs_err", "ms", "plain_ms",
                        "library_ms", "bound_ms", "bound_by", "bound_share",
                        "registers", "spill_stores", "spill_loads",
                        "smem_dynamic_bytes") if key in r}
                    for case in HEAD_DIM_TIMED
                    for r in [fl[case] if kname == "flash_fwd"
                              else bw[(kname, case)]]}
        # K1 at the ViT-B/16 training shape, the first shape no earlier
        # path gave it
        vit_case = rms["vit_b16_train"]
        kernels[1]["vit_case"] = {
            key: vit_case[key] for key in (
                "case", "shape", "max_abs_err", "ms", "wall_ms", "plain_ms",
                "library_ms", "bound_ms", "bound_by", "bound_share", "body",
                "plan", "registers", "spill_stores", "spill_loads")
            if key in vit_case}
    if kernels:
        for k, recs in zip(kernels, (
                fl.values(), rms.values(),
                [r for (kn, _), r in bw.items() if kn == "flash_bwd_dq"],
                [r for (kn, _), r in bw.items() if kn == "flash_bwd_dkv"])):
            k["bodies"] = kernel_bodies(recs)
    REPORT["kernels"] = kernels
    REPORT["timing"] = {
        "phase": "timing",
        "phases": dict(sorted(PHASE_S.items(), key=lambda kv: -kv[1])),
        "total_s": time.perf_counter() - t_start,
        "watchdog_s": WATCHDOG_S}
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(REPORT, f, indent=1)
    emit(REPORT["timing"])
    if kernels:
        emit({"kernels": kernels})
    faulthandler.cancel_dump_traceback_later()
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
