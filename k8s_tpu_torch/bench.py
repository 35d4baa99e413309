#!/usr/bin/env python3
"""Benchmark: training and decode throughput of the port on one CUDA
device, with MFU and HBM-roofline accounting.  The port of the root
``bench.py``: the same five cells, knobs, record files' rules, single
JSON line and exit codes.

    python -m k8s_tpu_torch.bench                      # resnet + transformer
    BENCH_ONLY=decode python -m k8s_tpu_torch.bench    # one cell
    K8S_TPU_PLATFORM=cpu BENCH_SMOKE=1 python -m k8s_tpu_torch.bench

Cells (``BENCH_ONLY`` = resnet | transformer | decode | vit |
decode_depth; unset runs resnet and transformer, the reference's
default):

- ResNet-50 train step (images/sec/chip), B128 at 224x224x3, bf16, SGD
  momentum; ``BENCH_RESNET_STEM`` conv | s2d.  The headline metric.
- GPT-2-small causal LM train step (tokens/sec/chip), B8 L1024, bf16,
  Adam, with the hand-written flash kernels (K2 forward, K3/K4 backward)
  on CUDA, then the plain-attention control (``flash_attention_speedup``)
  unless ``BENCH_NO_CONTROL``.  ``BENCH_SEQ``, ``BENCH_WINDOW`` (flash
  only), ``BENCH_FUSED_CE``.
- ViT-B/16 train step (images/sec/chip), B128, AdamW.
- KV-cached greedy generation, B32, 128 prompt + 128 new tokens, bf16
  params (``BENCH_DECODE_PARAM_DTYPE``), ``BENCH_KV_CACHE=int8``, with
  the HBM roofline.
- Serving depth: one-shot against chunked prefill (B32 L1024, chunk
  256), beam-4 against greedy, a B128 decode point and speculative
  decoding on a periodic prompt.

Prints exactly one JSON line:
  {"metric": "...", "value": N, "unit": "images/sec/chip", "vs_baseline": N, ...}
Exit codes: 0 complete; 2 no device answered and no record to show (or
a setup fault); 3 a hang or a device loss mid-run with nothing to show;
4 a partial line (``partial``, ``missing``).

Where it differs from the reference, by design:

- The device is CUDA unless ``K8S_TPU_PLATFORM=cpu`` asks for the CPU
  (the port's ``JAX_PLATFORMS=cpu``); without a card it never measures
  on the CPU instead.  One device is driven: ``n_chips`` is 1.
- Device work is never retried in-process: a CUDA error is sticky in
  its process, so the reference's relay retries would only repeat it.
  The preflight probe still runs, and retries a hang, in a throwaway
  subprocess.
- ``xla_flops_per_step`` is null: eager PyTorch has no compiled program
  to ask, and a FLOP counter over aten ops would not see the
  hand-written kernels.
- The peak tables know the H100 SXM only (989 TFLOP/s dense bf16,
  3350 GB/s); another device reports no MFU.  No TPU entry.
- The last-good record and the baseline are the port's own files under
  ``chip_reports/`` (``bench_torch_lastgood.json``,
  ``bench_torch_baseline.json``); the root ``BENCH_*.json`` hold a TPU's
  numbers and are never read or written here.
- ``BENCH_FLASH_BLOCK_Q`` / ``BENCH_FLASH_BLOCK_K`` are refused: the
  flash kernels tile themselves and take no block size.
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import threading
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
REPORT_DIR = os.path.join(os.path.dirname(_HERE), "chip_reports")
BASELINE_FILE = os.path.join(REPORT_DIR, "bench_torch_baseline.json")
# Timestamped last-good-on-hardware record: every cell lands here the
# moment it is measured on CUDA at the default shapes, and the final line
# falls back to it (with provenance and timestamps) when no device answers
# at emission time.
LASTGOOD_FILE = os.path.join(REPORT_DIR, "bench_torch_lastgood.json")

IMAGE_SIZE = 224     # the vision cells' images, 224x224x3
NUM_CLASSES = 1000

# Peak dense bf16 FLOP/s per device, by torch.cuda.get_device_name()
# substring (NVIDIA's H100 SXM data sheet).  The MFU denominator.
PEAK_FLOPS = [
    ("h100 80gb hbm3", 989e12),   # H100 SXM
]


def peak_flops_for(device_kind: str) -> float | None:
    kind = device_kind.lower()
    for key, peak in PEAK_FLOPS:
        if key in kind:
            return peak
    return None


# Peak HBM bandwidth per device, GB/s (the same data sheet).  Decode is
# HBM-bound — every generated token re-reads the params and the KV cache
# — so its utilization denominator is bandwidth, not FLOPs.
PEAK_HBM_GBPS = [
    ("h100 80gb hbm3", 3350.0),
]


def peak_hbm_gbps_for(device_kind: str) -> float | None:
    kind = device_kind.lower()
    for key, bw in PEAK_HBM_GBPS:
        if key in kind:
            return bw
    return None


# CUDA errors that mean the device itself was lost or is held elsewhere,
# not that the bench's code is wrong.
_TRANSIENT = (
    "busy or unavailable", "fallen off the bus", "launch timed out",
    "ecc error", "devices unavailable",
)


def is_transient(err: BaseException) -> bool:
    if isinstance(err, ProbeTimeout):
        # a phase hang: fall back to partial/last-good evidence
        return True
    msg = str(err).lower()
    return any(t in msg for t in _TRANSIENT)


def run_phase(fn, what: str = ""):
    """Run fn() once, between start/done lines on stderr: the bench's
    phase trace, so that a hang shows which phase absorbed it.

    No retry: a CUDA error is sticky in its process.  BENCH_PHASE_TIMEOUT
    bounds the phase (0, the default, disables it); a phase that outlives
    it raises :class:`ProbeTimeout`.
    """
    t0 = time.perf_counter()
    print(f"bench: [{_utcnow()}] start {what or 'device work'}",
          file=sys.stderr, flush=True)
    phase_timeout = float(os.environ.get("BENCH_PHASE_TIMEOUT", "0") or 0)
    if phase_timeout > 0:
        out = run_with_timeout(fn, phase_timeout, what or "device work")
    else:
        out = fn()
    print(f"bench: [{_utcnow()}] done {what or 'device work'} "
          f"in {time.perf_counter() - t0:.1f}s", file=sys.stderr, flush=True)
    return out


class ProbeTimeout(Exception):
    pass


def run_with_timeout(fn, timeout: float, what: str):
    """Run fn() in a daemon thread; raise ProbeTimeout if it blocks.

    A hung driver call cannot be cancelled, but the daemon thread lets the
    caller detect the hang and exit with a diagnostic instead of riding
    into an outer time limit.
    """
    result: list = []
    error: list = []

    def target():
        try:
            result.append(fn())
        except BaseException as e:  # noqa: BLE001 - re-raised below
            error.append(e)

    t = threading.Thread(target=target, daemon=True, name=f"bench-{what}")
    t.start()
    t.join(timeout)
    if t.is_alive():
        raise ProbeTimeout(f"{what} still blocked after {timeout:.0f}s")
    if error:
        raise error[0]
    return result[0]


def _utcnow() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ"
    )


def _atomic_write_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


# Keys a persisted record must carry for build_output to consume it.  The
# last-good file survives across code versions, so a record written by
# older code (schema drift) must read as "absent", not KeyError —
# especially inside die(), where an exception would kill the watchdog
# thread and hang the process with no JSON line at all.
_REQUIRED_KEYS = {
    "resnet50": ("images_per_sec_per_chip", "images_per_sec_per_chip_std",
                 "stem", "repeats", "step_time_ms", "flops_per_step",
                 "flops_per_sec_per_chip"),
    "transformer": ("tokens_per_sec_per_chip", "tokens_per_sec_per_chip_std",
                    "step_time_ms", "n_params", "flash_attention",
                    "fused_ce", "flops_per_sec_per_chip"),
    "transformer_xla_control": ("tokens_per_sec_per_chip",),
    "decode": ("tokens_per_sec_per_chip", "tokens_per_sec_per_chip_std",
               "per_token_ms", "n_params", "batch_per_chip", "prompt_len",
               "new_tokens"),
    "vit": ("images_per_sec_per_chip", "images_per_sec_per_chip_std",
            "repeats", "step_time_ms", "flops_per_step",
            "flops_per_sec_per_chip"),
    "decode_depth": ("prefill_oneshot_prompt_tokens_per_sec_per_chip",
                     "prefill_chunked_prompt_tokens_per_sec_per_chip",
                     "chunked_prefill_vs_oneshot", "beam4_overhead",
                     "repeats"),
}


class Recorder:
    """Incrementally persists cell results as they are measured.

    - every result is printed to stderr the moment it exists, so a log tail
      survives any later hang;
    - results measured on hardware (CUDA, the default shapes) are merged
      into the last-good file atomically (tmp+rename), each stamped with
      measured_at/device_kind, so a device lost mid-run cannot erase the
      evidence measured before it.
    """

    def __init__(self, path: str = LASTGOOD_FILE):
        self.path = path
        self.fresh: dict = {}
        self._lock = threading.Lock()
        self.last_good: dict = {"benchmarks": {}}
        try:
            with open(path) as f:
                data = json.load(f)
            if isinstance(data.get("benchmarks"), dict):
                self.last_good = data
        except (OSError, ValueError):
            pass

    def record(self, name: str, result: dict, on_hardware: bool,
               device_kind: str | None = None):
        if os.environ.get("BENCH_NO_PERSIST"):
            # variant runs explore non-default configs; their numbers are
            # captured by their driver, not the last-good record
            on_hardware = False
        if (on_hardware and result.get("repeats", 1) < 2
                and not os.environ.get("BENCH_ALLOW_SINGLE_REPEAT")):
            # a single measurement has no std and must not become the
            # headline evidence; BENCH_ALLOW_SINGLE_REPEAT=1 overrides
            print(f"bench: NOT persisting {name}: repeats="
                  f"{result.get('repeats', 1)} < 2 (set "
                  "BENCH_ALLOW_SINGLE_REPEAT=1 to override)", file=sys.stderr)
            on_hardware = False
        with self._lock:
            result = dict(result)
            result["measured_at"] = _utcnow()
            if device_kind:
                result["device_kind"] = device_kind
            self.fresh[name] = result
            print(f"bench: measured {name}: {json.dumps(result)}",
                  file=sys.stderr)
            sys.stderr.flush()
            if on_hardware:
                self.last_good["benchmarks"][name] = result
                self.last_good["updated_at"] = result["measured_at"]
                try:
                    os.makedirs(os.path.dirname(self.path) or ".",
                                exist_ok=True)
                    _atomic_write_json(self.path, self.last_good)
                except OSError as e:  # persistence is best-effort
                    print(f"bench: warning: could not persist last-good "
                          f"record: {e}", file=sys.stderr)

    def get(self, name: str, allow_stale: bool):
        """Fresh result for ``name``, else last-good (marked) if allowed."""
        if name in self.fresh:
            return self.fresh[name], False
        if allow_stale:
            stale = self.last_good["benchmarks"].get(name)
            if isinstance(stale, dict) and all(
                k in stale for k in _REQUIRED_KEYS.get(name, ())
            ):
                return stale, True
        return None, False


_PROBE = """\
import sys
import torch
dev = sys.argv[1]
if dev == "cuda" and not torch.cuda.is_available():
    print("PROBE_NO_DEVICE")
    sys.exit(3)
x = torch.ones((128, 128), dtype=torch.bfloat16, device=dev)
v = float((x @ x).sum())
assert v == 128 * 128 * 128, v
print("PROBE_OK", torch.cuda.get_device_name(0) if dev == "cuda" else "cpu")
"""


def _probe_subprocess(timeout: float, device: str) -> tuple[str, str]:
    """Run the device probe (CUDA init and one bf16 matmul) in a THROWAWAY
    subprocess.

    A hung in-process driver init would poison this process for good; a
    subprocess can hang and be killed without touching our interpreter,
    so the preflight can retry across a window and initialize CUDA
    in-process only once a probe has succeeded.

    Returns (status, detail): status is "ok", "hang", "absent" (no CUDA
    device at all: nothing to wait for), "transient" (a device lost or
    held elsewhere — retry), or "fatal" (code/setup bug — do NOT retry or
    mask with stale evidence).
    """
    try:
        r = subprocess.run(
            [sys.executable, "-c", _PROBE, device],
            capture_output=True, text=True, timeout=timeout,
            env=dict(os.environ),
        )
    except subprocess.TimeoutExpired:
        return "hang", f"probe subprocess hung past {timeout:.0f}s"
    except OSError as e:
        return "fatal", f"probe spawn failed: {e}"
    if r.returncode == 0 and "PROBE_OK" in r.stdout:
        return "ok", r.stdout.strip()
    if "PROBE_NO_DEVICE" in r.stdout:
        return "absent", "torch.cuda.is_available() is False"
    full = ((r.stderr or "") + "\n" + (r.stdout or "")).lower()
    tail = (r.stderr or r.stdout or "").strip().splitlines()
    detail = tail[-1][:200] if tail else f"rc={r.returncode}"
    status = "transient" if any(t in full for t in _TRANSIENT) else "fatal"
    return status, detail


def preflight(device: str) -> bool:
    """Bounded retry-with-backoff device check.

    Returns True when the device answered, False when there is no CUDA
    device or the retry window was exhausted on hangs and lost-device
    errors (the caller decides whether last-good evidence lets it emit
    anyway).  Other failures — a broken install, a bad probe result —
    FATAL immediately: retrying a deterministic bug for the whole window
    and then reporting rc=0 from stale numbers would mask it.  Each
    attempt is subprocess-isolated — see _probe_subprocess.
    """
    probe_timeout = float(os.environ.get("BENCH_PREFLIGHT_TIMEOUT", "120"))
    window = float(os.environ.get("BENCH_PREFLIGHT_WINDOW", "600"))
    deadline = time.monotonic() + window
    delay = 15.0
    attempt = 0
    while True:
        attempt += 1
        status, detail = _probe_subprocess(probe_timeout, device)
        if status == "ok":
            if attempt > 1:
                print(f"bench: preflight green on attempt {attempt} "
                      f"({detail})", file=sys.stderr)
            return True
        if status == "absent":
            print(f"bench: preflight: no CUDA device ({detail})",
                  file=sys.stderr)
            return False
        if status == "fatal":
            print(
                "bench: FATAL: preflight failed with a non-device error "
                "(this is a code/setup bug, not device availability):\n"
                f"  {detail}",
                file=sys.stderr,
            )
            raise SystemExit(2)
        remaining = deadline - time.monotonic()
        print(
            f"bench: preflight attempt {attempt} failed ({detail}); "
            f"{max(0, remaining):.0f}s left in retry window",
            file=sys.stderr,
        )
        if remaining <= delay:
            return False
        time.sleep(delay)
        delay = min(delay * 2, 120.0)


def _device() -> torch.device:
    """The cells' device: ``K8S_TPU_PLATFORM`` if set, else CUDA (which
    raises without a card)."""
    from k8s_tpu_torch.launcher.bootstrap import default_device
    from k8s_tpu_torch.ops._common import resolve_device

    return resolve_device(default_device())


def _time_steps(run_step, state, iters: int, warmup: int, repeats: int = 1):
    """Time ``repeats`` independent repetitions of ``iters`` dependent steps;
    returns a list of per-repetition elapsed seconds.

    Sync is a host read of the loss (``loss.item()``: it cannot complete
    before the whole chain has run).  Warmup runs once; each repetition
    then times a fresh chain, so the caller can report median + spread
    instead of a single sample.  ``run_step(state) -> (state, loss)``.
    """
    for _ in range(warmup):
        state, loss = run_step(state)
    if warmup:
        _ = loss.item()
    times = []
    for _ in range(max(1, repeats)):
        start = time.perf_counter()
        for _ in range(iters):
            state, loss = run_step(state)
        _ = loss.item()
        times.append(time.perf_counter() - start)
    return times


def _median(xs):
    import statistics

    return statistics.median(xs)


def _stdev(xs):
    import statistics

    return statistics.stdev(xs) if len(xs) > 1 else 0.0


def _repeats_default() -> int:
    return int(os.environ.get("BENCH_REPEATS", "5"))


def _images(dev, batch: int, size: int):
    """bf16 NHWC images and labels in [0, NUM_CLASSES), from seed 0."""
    g = torch.Generator(device=dev).manual_seed(0)
    images = torch.randn(batch, size, size, 3, generator=g, device=dev)
    labels = torch.randint(0, NUM_CLASSES, (batch,), generator=g, device=dev)
    return images.to(torch.bfloat16), labels


class _CudnnSearch:
    """cuDNN picks each convolution's algorithm by timing the candidates
    (``cudnn.benchmark``) inside the block, as a compiler's autotuner
    would; the search's cost falls in the warm-up."""

    def __enter__(self):
        self.old = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = True

    def __exit__(self, *exc):
        torch.backends.cudnn.benchmark = self.old


def resnet_trainer(x, y, stem: str, seed: int):
    """``resnet50(dtype=bf16, stem=stem)`` on ``x``'s device with
    SGD(lr 0.1, momentum 0.9), the reference's ``optax.sgd(0.1,
    momentum=0.9)``: ``(model, step)``, where ``step()`` trains once on
    (x, y) and returns the loss."""
    from k8s_tpu_torch.models import resnet
    from k8s_tpu_torch.models import train as train_lib

    model = resnet.resnet50(dtype=torch.bfloat16, stem=stem,
                            device=x.device, seed=seed)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = train_lib.cross_entropy_loss(model(x, train=True), y)
        loss.backward()
        opt.step()
        return loss.detach()
    return model, step


def vit_trainer(cfg, x, y, weights=None, seed: int = 0):
    """``ViT(cfg)`` on ``x``'s device (from the state dict ``weights``, or
    drawn from ``seed``) with AdamW (``default_optimizer(1e-3,
    weight_decay=0.05)``, the reference's ``optax.adamw(1e-3,
    weight_decay=0.05)``): ``(model, step)``, where ``step()`` trains once
    on (x, y) and returns the loss."""
    from k8s_tpu_torch.models import train as train_lib
    from k8s_tpu_torch.models import vit

    model = vit.ViT(cfg, device=x.device, seed=seed)
    if weights is not None:
        model.load_state_dict(weights)
    opt = train_lib.default_optimizer(1e-3, weight_decay=0.05)
    state = train_lib.init_state(model, opt)
    train_step = train_lib.make_train_step(
        lambda m, b: m(b), train_lib.cross_entropy_loss, opt)
    return model, lambda: train_step(state, (x, y))[1]


def _steps(step):
    """A ``_time_steps`` ``run_step`` over a ``step()`` that trains in
    place and returns the loss."""
    return lambda state: (state, step())


def bench_resnet50(batch_per_chip: int = 128, iters: int = 40, warmup: int = 5,
                   stem: str | None = None):
    dev = _device()
    batch = batch_per_chip
    if stem is None:
        stem = os.environ.get("BENCH_RESNET_STEM", "conv")
    if stem not in ("conv", "s2d"):
        raise ValueError(f"unknown BENCH_RESNET_STEM {stem!r} "
                         "(expected 'conv' or 's2d')")
    images, labels = _images(dev, batch, IMAGE_SIZE)
    _, step = resnet_trainer(images, labels, stem, seed=1)
    # MFU uses the 2*MACs FLOP convention — the convention the hardware
    # peak numbers (and bench_transformer's 6*params/token) use.
    # ResNet-50 fwd is ~4.1 G MACs/img at 224^2 = ~8.2 GFLOP/img; train
    # ~3x fwd.
    flops = 3 * 2 * 4.1e9 * batch
    with _CudnnSearch():
        times = run_phase(
            lambda: _time_steps(_steps(step), None, iters, warmup,
                                repeats=_repeats_default()),
            what="resnet timing",
        )
    elapsed = _median(times)
    rates = [batch * iters / t for t in times]
    return {
        "stem": stem,
        "images_per_sec_per_chip": _median(rates),
        "images_per_sec_per_chip_std": _stdev(rates),
        "repeats": len(times),
        "flops_per_step": flops,
        "xla_flops_per_step": None,
        "flops_per_sec_per_chip": flops * iters / elapsed,
        "step_time_ms": elapsed / iters * 1000,
    }


def _gpt2_small_config(max_seq_len: int, **overrides):
    """The benchmarked GPT-2-small shape, shared by the training and decode
    benches so their params/MFU always describe the SAME model."""
    from k8s_tpu_torch.models.transformer import TransformerConfig

    kw = dict(
        vocab_size=32000, hidden=768, ffn_hidden=3072, layers=12, heads=12,
        kv_heads=12, max_seq_len=max_seq_len, dtype=torch.bfloat16,
        remat=False,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def _tokens(dev, shape, vocab_size: int, seed: int):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, vocab_size, shape, generator=g, device=dev)


def _params(cfg, dev):
    """The cells' weights: f32, drawn from seed 1 (the reference's
    ``init(PRNGKey(1))``)."""
    from k8s_tpu_torch.models.bridge import init_params

    return init_params(cfg, 1, device=dev, dtype=torch.float32)


def bench_transformer(batch_per_chip: int = 8, seq: int = 1024,
                      iters: int = 30, warmup: int = 5,
                      use_flash: bool | None = None,
                      repeats: int | None = None):
    """GPT-2-small-shaped causal LM train step.

    ``use_flash=None`` selects the hand-written flash kernels on CUDA and
    plain attention elsewhere; passing False forces the plain-attention
    control so a single bench run can capture both numbers in the line.
    The result also carries ``first_loss``, the warm-up's first step.
    """
    from k8s_tpu_torch.models import train as train_lib
    from k8s_tpu_torch.models.transformer import Transformer

    def _env_int(name):
        raw = os.environ.get(name)
        return int(raw) if raw else None

    for name in ("BENCH_FLASH_BLOCK_Q", "BENCH_FLASH_BLOCK_K"):
        if os.environ.get(name):
            raise SystemExit(
                f"{name} is set, but the port's flash kernels tile "
                "themselves and take no block size; unset "
                "BENCH_FLASH_BLOCK_Q and BENCH_FLASH_BLOCK_K")
    dev = _device()
    seq = _env_int("BENCH_SEQ") or seq
    batch = batch_per_chip
    if use_flash is None:
        use_flash = dev.type == "cuda"  # the kernels are CUDA-only

    cfg = _gpt2_small_config(
        max_seq_len=seq,
        use_flash_attention=use_flash,
        # sliding-window A/B knob (flash path only; the kernels skip
        # out-of-window tiles, so this measures the O(L*window) claim)
        window_size=_env_int("BENCH_WINDOW") if use_flash else None,
    )
    if _env_int("BENCH_WINDOW") and not use_flash:
        # dropping the window silently would let an 'swa' variant measure
        # full-causal attention under a windowed name
        raise SystemExit(
            "BENCH_WINDOW needs the flash path (CUDA); refusing to run "
            "the windowed variant as full-causal attention")
    tokens = _tokens(dev, (batch, seq), cfg.vocab_size, 0)
    model = Transformer(cfg, _params(cfg, dev), device=dev, trainable=True)
    optimizer = train_lib.default_optimizer(1e-4)
    state = train_lib.init_state(model, optimizer)

    use_fused_ce = bool(os.environ.get("BENCH_FUSED_CE"))
    if use_fused_ce:
        # chunked head+CE: [B, L, V] logits never materialize
        step = train_lib.make_train_step(
            train_lib.make_fused_lm_apply_fn(model),
            train_lib.fused_loss_passthrough, optimizer)
    else:
        step = train_lib.make_train_step(lambda m, t: m(t),
                                         train_lib.lm_loss, optimizer)
    # Analytic model FLOPs for MFU: 6N per token (fwd+bwd dense, incl. the
    # tied-embedding logits matmul) + attention 12*layers*hidden*ctx
    # (full-matrix convention; ctx = window when SWA bounds the context —
    # crediting skipped tiles would inflate MFU).
    n_params = sum(p.numel() for p in model.parameters())
    attn_ctx = min(seq, cfg.window_size) if cfg.window_size else seq
    flops = (6 * n_params
             + 12 * cfg.layers * cfg.hidden * attn_ctx) * batch * seq
    first_loss = []

    def run_step(state):
        state, loss = step(state, (tokens, tokens))
        if not first_loss:
            first_loss.append(loss.item())
        return state, loss

    times = run_phase(
        lambda: _time_steps(
            run_step, state, iters, warmup,
            repeats=_repeats_default() if repeats is None else repeats,
        ),
        what="transformer timing",
    )
    elapsed = _median(times)
    rates = [batch * seq * iters / t for t in times]
    return {
        "tokens_per_sec_per_chip": _median(rates),
        "tokens_per_sec_per_chip_std": _stdev(rates),
        "repeats": len(times),
        "flops_per_step": flops,
        "xla_flops_per_step": None,
        "flops_per_sec_per_chip": flops * iters / elapsed,
        "step_time_ms": elapsed / iters * 1000,
        "n_params": n_params,
        "flash_attention": cfg.use_flash_attention,
        "fused_ce": use_fused_ce,
        "window": cfg.window_size,
        "seq": seq,
        "first_loss": first_loss[0],
    }


def bench_vit(batch_per_chip: int = 128, iters: int = 30, warmup: int = 5):
    """ViT-B/16 train step, images/sec/chip (models/vit.py).

    FLOP convention: 2*MACs.  ViT-B/16 fwd is ~17.6 G MACs/img at 224^2
    with the SwiGLU-2048 blocks = ~35.2 GFLOP/img; train ~3x fwd.
    """
    from k8s_tpu_torch.models import vit

    dev = _device()
    batch = batch_per_chip
    # remat off: like the other benches this measures the throughput
    # config (remat trades FLOPs for memory; B/16 at batch 128 fits)
    cfg = vit.vit_b16(remat=False)
    images, labels = _images(dev, batch, cfg.image_size)
    _, step = vit_trainer(cfg, images, labels, seed=1)
    flops = 3 * 2 * 17.6e9 * batch  # 2*MACs convention, train ~3x fwd
    with _CudnnSearch():
        times = run_phase(
            lambda: _time_steps(_steps(step), None, iters, warmup,
                                repeats=_repeats_default()),
            what="vit timing")
    elapsed = _median(times)
    rates = [batch * iters / t for t in times]
    return {
        "images_per_sec_per_chip": _median(rates),
        "images_per_sec_per_chip_std": _stdev(rates),
        "repeats": len(times),
        "flops_per_step": flops,
        "xla_flops_per_step": None,
        "flops_per_sec_per_chip": flops * iters / elapsed,
        "step_time_ms": elapsed / iters * 1000,
    }


def _decode_model(cfg, params, dev):
    """The decode cells' model over the state dict ``params``: bf16 params
    are served as they are; f32 params are held in f32 and each
    projection is cast at use, as the reference reads its f32 params."""
    from k8s_tpu_torch.models.transformer import Transformer

    f32 = params["layers.0.attn.q_proj.weight"].dtype == torch.float32
    model = Transformer(cfg, params, device=dev, trainable=f32)
    return model.requires_grad_(False)


def decode_roofline(cfg, params: dict, batch_per_chip: int, prompt_len: int,
                    new_tokens: int) -> dict:
    """The decode cell's HBM accounting over the state dict it serves.

    Each decode STEP re-reads the full params once plus each row's KV
    cache up to its current length; per generated token that is
    params/batch + 2*layers*kv_heads*head_dim*avg_len*itemsize.  The
    port serves the embedding in f32 (the tied head's operand), which
    this accounting, the reference's, does not count.
    """
    n_params = sum(t.numel() for t in params.values())
    param_bytes = sum(t.numel() * t.element_size() for t in params.values())
    head_dim = cfg.dims_per_head
    if cfg.kv_cache_dtype == "int8":
        # int8 vector + one f32 absmax scale per (slot, head) per k/v
        kv_vec_bytes = head_dim * 1 + 4
    else:
        kv_vec_bytes = head_dim * torch.empty((), dtype=cfg.dtype).itemsize
    avg_len = prompt_len + new_tokens / 2.0
    kv_bytes_per_token = 2 * cfg.layers * cfg.kv_heads * kv_vec_bytes * avg_len
    bytes_per_token = param_bytes / batch_per_chip + kv_bytes_per_token
    return {
        "n_params": n_params,
        "param_bytes": int(param_bytes),
        "hbm_bytes_per_token": int(bytes_per_token),
        "kv_cache_bytes_per_token": int(kv_bytes_per_token),
    }


def _done(out):
    """Wait for a generation call: a host read of its last token."""
    tokens = out[0] if isinstance(out, tuple) else out
    _ = int(tokens[-1, -1])
    return out


def bench_decode(batch_per_chip: int = 32, prompt_len: int = 128,
                 new_tokens: int = 128, calls: int = 4, warmup: int = 1):
    """KV-cached autoregressive generation throughput (models/decode.py).

    One generate call: a prefill over the prompt (K2 on CUDA) and cached
    single-token steps, greedy sampling.  The measured unit is GENERATED
    tokens/sec/chip end-to-end (prefill amortized across new_tokens).
    Decode is memory-bound (matmuls are [B,1,*]), so MFU here is expected
    to be far below the training benches — the per-token step time is
    the headline.
    """
    from k8s_tpu_torch.models.decode import make_generate_fn
    from k8s_tpu_torch.models.serving import cast_params_for_serving

    dev = _device()
    batch = batch_per_chip
    kv_cache_dtype = os.environ.get("BENCH_KV_CACHE") or None
    cfg = _gpt2_small_config(
        max_seq_len=prompt_len + new_tokens,
        use_flash_attention=dev.type == "cuda",  # the prefill's attention
        kv_cache_dtype=kv_cache_dtype,
    )
    prompt = _tokens(dev, (batch, prompt_len), cfg.vocab_size, 0)
    params = _params(cfg, dev)
    # Serving runs inference-dtype params (decode re-reads ALL of them
    # every token — at f32 they are the dominant HBM term); the roofline
    # below accounts the CAST bytes, so the number stays honest.
    param_dtype = os.environ.get("BENCH_DECODE_PARAM_DTYPE", "bfloat16")
    if param_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"BENCH_DECODE_PARAM_DTYPE={param_dtype!r}")
    if param_dtype == "bfloat16":
        params = cast_params_for_serving(params)
    analytics = decode_roofline(cfg, params, batch_per_chip, prompt_len,
                                new_tokens)
    n_params = analytics.pop("n_params")
    model = _decode_model(cfg, params, dev)
    del params
    gen = make_generate_fn(cfg, new_tokens)
    rng = torch.Generator(device=dev).manual_seed(2)

    def one_call():
        return _done(gen(model, prompt, rng))

    run_phase(one_call, what="decode first call")
    for _ in range(max(0, warmup - 1)):
        one_call()

    def timed():
        times = []
        for _ in range(max(1, _repeats_default())):
            start = time.perf_counter()
            for _ in range(calls):
                one_call()
            times.append(time.perf_counter() - start)
        return times

    times = run_phase(timed, what="decode timing")
    elapsed = _median(times)
    rates = [batch * new_tokens * calls / t for t in times]
    # fwd-only analytic FLOPs per generated token ~ 2 * params (matmul
    # MACs x2), ignoring the O(L) attention term — the standard decode
    # accounting; prefill FLOPs are excluded from MFU but included in the
    # measured wall time, which understates utilization slightly
    flops_per_token = 2.0 * n_params
    analytics["param_dtype"] = param_dtype
    analytics["kv_cache_dtype"] = cfg.kv_cache_dtype or str(
        cfg.dtype).replace("torch.", "")
    hbm = peak_hbm_gbps_for(_device_kind(dev))
    if hbm:
        bound = hbm * 1e9 / analytics["hbm_bytes_per_token"]
        analytics["hbm_bound_tokens_per_sec_per_chip"] = round(bound, 1)
        analytics["hbm_utilization"] = round(_median(rates) / bound, 4)
    return {
        **analytics,
        "tokens_per_sec_per_chip": _median(rates),
        "tokens_per_sec_per_chip_std": _stdev(rates),
        "repeats": len(times),
        "per_token_ms": elapsed / calls / new_tokens * 1000,
        "step_time_ms": elapsed / calls * 1000,  # one full generate() call
        "flops_per_sec_per_chip": (flops_per_token * batch * new_tokens
                                   * calls / elapsed),
        "n_params": n_params,
        "batch_per_chip": batch_per_chip,
        "prompt_len": prompt_len,
        "new_tokens": new_tokens,
        "flash_prefill": cfg.use_flash_attention,
    }


def _device_kind(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def bench_decode_depth(batch_per_chip: int = 32, prompt_len: int = 1024,
                       chunk: int = 256, beam_prompt: int = 128,
                       beam_new: int = 32, sweep_batch: int = 128,
                       calls: int = 3):
    """Serving-depth A/Bs: the numbers that give the inference surface a
    perf identity beyond headline tokens/s.

    - one-shot vs CHUNKED prefill throughput (prompt tokens/s consuming a
      ``prompt_len`` prompt; chunked streams ``chunk``-token chunks through
      the cache in decode mode — O(chunk x cache) activation memory, and
      no flash kernel);
    - beam-4 overhead: per-token cost of make_beam_generate_fn(beam=4)
      relative to greedy at the same shapes;
    - a ``sweep_batch`` decode point: decode is KV/param-read bound, so
      tokens/s/chip should scale sublinearly from the headline batch;
    - speculative decoding on a PERIODIC prompt (the favorable case —
      prompt-lookup drafts hit).
    """
    from k8s_tpu_torch.models.decode import (make_beam_generate_fn,
                                             make_generate_fn,
                                             make_speculative_generate_fn)

    dev = _device()
    on_cuda = dev.type == "cuda"
    repeats = _repeats_default()

    def timed_call(fn, *args):
        """(times, last_result): callers needing the deterministic output
        (e.g. speculative stats) reuse it instead of paying another run."""
        def one():
            return _done(fn(*args))

        run_phase(one, what="decode_depth first call")
        one()  # steady-state warmup
        times = []
        out = None
        for _ in range(max(1, repeats)):
            start = time.perf_counter()
            for _ in range(calls):
                out = one()
            times.append((time.perf_counter() - start) / calls)
        return times, out

    out = {"repeats": repeats, "batch_per_chip": batch_per_chip,
           "prompt_len": prompt_len, "chunk": chunk}

    # -- prefill A/B: one-shot vs chunked ---------------------------------
    new_tail = 8  # a token of decode tail so both paths run the full api
    cfg = _gpt2_small_config(max_seq_len=prompt_len + new_tail,
                             use_flash_attention=on_cuda,
                             prefill_chunk=chunk)
    batch = batch_per_chip
    prompt = _tokens(dev, (batch, prompt_len), cfg.vocab_size, 0)
    model = _decode_model(cfg, _params(cfg, dev), dev)
    rng = torch.Generator(device=dev).manual_seed(2)
    for label, chunked in (("prefill_oneshot", False),
                           ("prefill_chunked", True)):
        gen = make_generate_fn(cfg, new_tail, chunked_prefill=chunked)
        times, _ = timed_call(gen, model, prompt, rng)
        rates = [batch * prompt_len / t for t in times]
        out[f"{label}_prompt_tokens_per_sec_per_chip"] = round(_median(rates), 1)
        out[f"{label}_std"] = round(_stdev(rates), 1)
    out["chunked_prefill_vs_oneshot"] = round(
        out["prefill_chunked_prompt_tokens_per_sec_per_chip"]
        / out["prefill_oneshot_prompt_tokens_per_sec_per_chip"], 4)
    del model

    # -- beam-4 overhead ---------------------------------------------------
    bcfg = _gpt2_small_config(max_seq_len=beam_prompt + beam_new,
                              use_flash_attention=on_cuda)
    bprompt = _tokens(dev, (batch, beam_prompt), bcfg.vocab_size, 3)
    bmodel = _decode_model(bcfg, _params(bcfg, dev), dev)
    greedy = make_generate_fn(bcfg, beam_new)
    gtimes, _ = timed_call(greedy, bmodel, bprompt, rng)
    beam = make_beam_generate_fn(bcfg, beam_new, beam_size=4)
    btimes, _ = timed_call(beam, bmodel, bprompt)
    out["greedy_per_token_ms"] = round(
        _median(gtimes) / beam_new / batch * 1000, 4)
    out["beam4_per_token_ms"] = round(
        _median(btimes) / beam_new / batch * 1000, 4)
    out["beam4_overhead"] = round(_median(btimes) / _median(gtimes), 3)
    out["beam_prompt"], out["beam_new"] = beam_prompt, beam_new
    del bmodel

    # -- batch sweep point -------------------------------------------------
    scfg = _gpt2_small_config(max_seq_len=128 + 128,
                              use_flash_attention=on_cuda)
    sbatch = sweep_batch
    sprompt = _tokens(dev, (sbatch, 128), scfg.vocab_size, 4)
    smodel = _decode_model(scfg, _params(scfg, dev), dev)
    sgen = make_generate_fn(scfg, 128)
    stimes, _ = timed_call(sgen, smodel, sprompt, rng)
    srates = [sbatch * 128 / t for t in stimes]
    out[f"decode_b{sweep_batch}_tokens_per_sec_per_chip"] = round(
        _median(srates), 1)
    out[f"decode_b{sweep_batch}_std"] = round(_stdev(srates), 1)
    out["sweep_batch"] = sweep_batch
    del smodel

    # -- speculative decoding on a PERIODIC prompt (the favorable case —
    # prompt-lookup drafts hit; random prompts degrade to vanilla pace,
    # measured by the plain decode bench) -------------------------------
    sp_prompt_len, sp_new, sp_k = (16, 16, 4) if os.environ.get(
        "BENCH_SMOKE") else (128, 128, 4)
    pcfg = _gpt2_small_config(
        max_seq_len=sp_prompt_len + sp_new + sp_k,
        use_flash_attention=on_cuda)
    period = torch.arange(4, device=dev) + 5
    pprompt = period.repeat(batch, sp_prompt_len // 4)
    pmodel = _decode_model(pcfg, _params(pcfg, dev), dev)
    spec = make_speculative_generate_fn(pcfg, sp_new, draft_k=sp_k,
                                        return_stats=True)
    sptimes, (_, stats) = timed_call(spec, pmodel, pprompt)
    sprates = [batch * sp_new / t for t in sptimes]
    out["spec_tokens_per_sec_per_chip"] = round(_median(sprates), 1)
    out["spec_std"] = round(_stdev(sprates), 1)
    out["spec_tokens_per_call"] = round(float(stats["tokens_per_call"]), 2)
    out["spec_draft_k"] = sp_k
    out["spec_prompt"] = "periodic4"
    return out


def build_output(recorder: Recorder, want_resnet: bool, want_transformer: bool,
                 allow_stale: bool, device_kind: str | None,
                 n_chips: int | None, want_decode: bool = False,
                 want_vit: bool = False,
                 want_decode_depth: bool = False) -> dict:
    """Assemble the single JSON line from fresh + (optionally) last-good
    results, with per-result provenance so stale evidence is never silently
    presented as this run's measurement."""
    baseline = {}
    if os.path.exists(BASELINE_FILE):
        try:
            with open(BASELINE_FILE) as f:
                baseline = json.load(f)
        except (OSError, ValueError):
            baseline = {}

    resnet = transformer = control = decode = vit = depth = None
    stale_names = []
    if want_decode_depth:
        depth, stale = recorder.get("decode_depth", allow_stale)
        if stale:
            stale_names.append("decode_depth")
    if want_vit:
        vit, stale = recorder.get("vit", allow_stale)
        if stale:
            stale_names.append("vit")
    if want_decode:
        decode, stale = recorder.get("decode", allow_stale)
        if stale:
            stale_names.append("decode")
    if want_resnet:
        resnet, stale = recorder.get("resnet50", allow_stale)
        if stale:
            stale_names.append("resnet50")
    if want_transformer:
        transformer, t_stale = recorder.get("transformer", allow_stale)
        if t_stale:
            stale_names.append("transformer")
        # a stale control may only pair with a stale transformer (same
        # persisted battery, same default config); dividing a fresh —
        # possibly env-tweaked — run by an hours-old control would present
        # a cross-run ratio as this run's flash speedup
        control, stale = recorder.get(
            "transformer_xla_control",
            allow_stale and transformer is not None and t_stale,
        )
        if stale:
            stale_names.append("transformer_xla_control")

    if device_kind is None:
        for r in (resnet, transformer, decode, vit):
            if r and r.get("device_kind"):
                device_kind = r["device_kind"]
                break
    peak = peak_flops_for(device_kind) if device_kind else None

    def peak_for(result) -> float | None:
        # MFU must use the peak of the device the result was MEASURED on
        kind = (result or {}).get("device_kind") or device_kind
        return peak_flops_for(kind) if kind else None

    out = {
        "metric": "resnet50_images_per_sec_per_chip",
        "value": None,
        "unit": "images/sec/chip",
        "vs_baseline": 1.0,
        "device_kind": device_kind,
    }
    if n_chips is not None:
        out["n_chips"] = n_chips
    if resnet:
        out["value"] = round(resnet["images_per_sec_per_chip"], 2)
        base = baseline.get("resnet50_images_per_sec_per_chip")
        if base:
            out["vs_baseline"] = round(out["value"] / base, 4)
        out["resnet50_std"] = round(resnet["images_per_sec_per_chip_std"], 2)
        out["resnet50_stem"] = resnet["stem"]
        out["repeats"] = resnet["repeats"]
        out["resnet50_step_time_ms"] = round(resnet["step_time_ms"], 2)
        out["resnet50_flops_per_step"] = resnet["flops_per_step"]
        rn_peak = peak_for(resnet)
        if rn_peak:
            out["resnet50_mfu"] = round(
                resnet["flops_per_sec_per_chip"] / rn_peak, 4)
    if transformer:
        out["transformer_tokens_per_sec_per_chip"] = round(
            transformer["tokens_per_sec_per_chip"], 1
        )
        out["transformer_std"] = round(
            transformer["tokens_per_sec_per_chip_std"], 1
        )
        out["transformer_step_time_ms"] = round(transformer["step_time_ms"], 2)
        out["transformer_n_params"] = transformer["n_params"]
        out["transformer_flash_attention"] = transformer["flash_attention"]
        out["transformer_fused_ce"] = transformer["fused_ce"]
        if transformer.get("window"):
            out["transformer_window"] = transformer["window"]
        if transformer.get("seq"):
            out["transformer_seq"] = transformer["seq"]
        if control:
            out["transformer_xla_attention_tokens_per_sec"] = round(
                control["tokens_per_sec_per_chip"], 1
            )
            out["flash_attention_speedup"] = round(
                transformer["tokens_per_sec_per_chip"]
                / control["tokens_per_sec_per_chip"],
                4,
            )
        base = baseline.get("transformer_tokens_per_sec_per_chip")
        # the baseline is the default shape (seq 1024, no window): a
        # seq/window-overridden run must not report a phantom ratio
        default_shape = (transformer.get("seq", 1024) == 1024
                         and not transformer.get("window"))
        if base and default_shape:
            out["transformer_vs_baseline"] = round(
                out["transformer_tokens_per_sec_per_chip"] / base, 4
            )
        tf_peak = peak_for(transformer)
        if tf_peak:
            out["transformer_mfu"] = round(
                transformer["flops_per_sec_per_chip"] / tf_peak, 4
            )
        if resnet is None:  # transformer-only run: promote to headline metric
            out["metric"] = "transformer_tokens_per_sec_per_chip"
            out["value"] = out["transformer_tokens_per_sec_per_chip"]
            out["unit"] = "tokens/sec/chip"
            out["vs_baseline"] = out.get("transformer_vs_baseline", 1.0)
    if vit:
        out["vit_images_per_sec_per_chip"] = round(
            vit["images_per_sec_per_chip"], 2)
        out["vit_std"] = round(vit["images_per_sec_per_chip_std"], 2)
        out["vit_step_time_ms"] = round(vit["step_time_ms"], 2)
        vt_peak = peak_for(vit)
        if vt_peak:
            out["vit_mfu"] = round(vit["flops_per_sec_per_chip"] / vt_peak, 4)
        if resnet is None and transformer is None and decode is None:
            out["metric"] = "vit_images_per_sec_per_chip"
            out["value"] = out["vit_images_per_sec_per_chip"]
            out["unit"] = "images/sec/chip"
            base = baseline.get("vit_images_per_sec_per_chip")
            out["vs_baseline"] = (round(out["value"] / base, 4)
                                  if base else 1.0)
    if decode:
        out["decode_tokens_per_sec_per_chip"] = round(
            decode["tokens_per_sec_per_chip"], 1)
        out["decode_std"] = round(decode["tokens_per_sec_per_chip_std"], 1)
        out["decode_per_token_ms"] = round(decode["per_token_ms"], 3)
        out["decode_batch_per_chip"] = decode["batch_per_chip"]
        out["decode_prompt_len"] = decode["prompt_len"]
        out["decode_new_tokens"] = decode["new_tokens"]
        dc_peak = peak_for(decode)
        if dc_peak:
            out["decode_mfu"] = round(
                decode["flops_per_sec_per_chip"] / dc_peak, 4)
        for k in ("hbm_bound_tokens_per_sec_per_chip", "hbm_utilization",
                  "hbm_bytes_per_token"):
            if k in decode:
                out[f"decode_{k}"] = decode[k]
        if resnet is None and transformer is None:  # decode-only run
            out["metric"] = "decode_tokens_per_sec_per_chip"
            out["value"] = out["decode_tokens_per_sec_per_chip"]
            out["unit"] = "generated tokens/sec/chip"
            base = baseline.get("decode_tokens_per_sec_per_chip")
            out["vs_baseline"] = (round(out["value"] / base, 4)
                                  if base else 1.0)
    if depth:
        for k in ("prefill_oneshot_prompt_tokens_per_sec_per_chip",
                  "prefill_chunked_prompt_tokens_per_sec_per_chip",
                  "chunked_prefill_vs_oneshot", "beam4_overhead",
                  "greedy_per_token_ms", "beam4_per_token_ms",
                  "spec_tokens_per_sec_per_chip", "spec_tokens_per_call",
                  "spec_draft_k"):
            if k in depth:
                out[f"decode_depth_{k}"] = depth[k]
        sweep = depth.get("sweep_batch")
        if sweep:
            key = f"decode_b{sweep}_tokens_per_sec_per_chip"
            if key in depth:
                out[f"decode_depth_{key}"] = depth[key]
        if (resnet is None and transformer is None and decode is None
                and vit is None):
            out["metric"] = "chunked_prefill_vs_oneshot"
            out["value"] = depth["chunked_prefill_vs_oneshot"]
            out["unit"] = "ratio"
            out["vs_baseline"] = 1.0
    if peak:
        out["peak_flops_per_chip"] = peak
    if stale_names:
        out["results_from_last_good"] = stale_names
        out["last_good_measured_at"] = {
            n: recorder.last_good["benchmarks"][n].get("measured_at")
            for n in stale_names
        }
    return out


CELLS = ("resnet50", "transformer", "decode", "vit", "decode_depth")


def assemble(recorder: Recorder, wants: dict, allow_stale: bool,
             device_kind=None, n_chips=None) -> dict | None:
    """The line for the cells ``wants`` names (``{cell: bool}``, the
    names of :data:`CELLS`), marked ``partial`` with the ``missing`` cells
    when one is absent; None when nothing at all is there to show."""
    want = {name: bool(wants.get(name)) for name in CELLS}
    out = build_output(recorder, want["resnet50"], want["transformer"],
                       allow_stale, device_kind, n_chips,
                       want_decode=want["decode"], want_vit=want["vit"],
                       want_decode_depth=want["decode_depth"])
    missing = []
    if want["resnet50"] and "resnet50_step_time_ms" not in out:
        missing.append("resnet50")
    if want["decode"] and "decode_per_token_ms" not in out:
        missing.append("decode")
    if want["vit"] and "vit_step_time_ms" not in out:
        missing.append("vit")
    if want["decode_depth"] and "decode_depth_beam4_overhead" not in out:
        missing.append("decode_depth")
    have_transformer = "transformer_step_time_ms" in out
    if want["transformer"] and not have_transformer:
        missing.append("transformer")
    if (want["transformer"] and have_transformer
            and out.get("transformer_flash_attention")
            and not out.get("transformer_window")
            and not os.environ.get("BENCH_NO_CONTROL")
            and "flash_attention_speedup" not in out):
        # the plain-attention control was expected (flash ran, control
        # not suppressed) but never landed: without this, a device loss
        # during the control run would emit a full-looking line and the
        # flash-speedup A/B would silently vanish
        missing.append("transformer_xla_control")
    requested = [n for n in CELLS if want[n]]
    if missing and all(n in missing for n in requested):
        return None  # nothing at all to show (single-benchmark runs too)
    if missing:
        out["partial"] = True
        out["missing"] = missing
    return out


def main() -> int:
    from k8s_tpu_torch.launcher.bootstrap import apply_platform_env

    only = os.environ.get("BENCH_ONLY", "").lower()
    if only not in ("", "resnet", "transformer", "decode", "vit",
                    "decode_depth"):
        print(
            f"bench: FATAL: unknown BENCH_ONLY={only!r} "
            "(expected 'resnet', 'transformer', 'decode', 'vit' or "
            "'decode_depth')",
            file=sys.stderr,
        )
        return 2
    device = apply_platform_env() or "cuda"
    wants = {
        "resnet50": only in ("", "resnet"),
        "transformer": only in ("", "transformer"),
        # inference throughput is opt-in (BENCH_ONLY=decode): the default
        # run stays the two training headlines
        "decode": only == "decode",
        "vit": only == "vit",
        "decode_depth": only == "decode_depth",
    }

    recorder = Recorder(LASTGOOD_FILE)
    # Variant runs (sweeps, A/B drivers) set BENCH_NO_PERSIST: their configs
    # differ from the persisted default-config record, so falling back to it
    # would attribute stale default numbers to a variant.  For those runs
    # an outage must be a hard failure.  Smoke runs are non-default shapes
    # for the same reason (they already don't persist).
    non_default_param_dtype = os.environ.get(
        "BENCH_DECODE_PARAM_DTYPE", "bfloat16") != "bfloat16"
    stale_ok = not (os.environ.get("BENCH_NO_PERSIST")
                    or os.environ.get("BENCH_SMOKE")
                    or os.environ.get("BENCH_SEQ")
                    or os.environ.get("BENCH_WINDOW")
                    or os.environ.get("BENCH_KV_CACHE")
                    or non_default_param_dtype)

    def emit(allow_stale: bool, device_kind=None, n_chips=None) -> int:
        """Print the JSON line; return an exit code: 0 every requested
        cell is present (fresh or marked stale), 4 a line was printed but
        a requested cell is MISSING, -1 nothing to print."""
        out = assemble(recorder, wants, allow_stale and stale_ok,
                       device_kind, n_chips)
        if out is None:
            return -1
        print(json.dumps(out))
        sys.stdout.flush()
        return 4 if out.get("partial") else 0

    # Global watchdog: if the device hangs mid-bench (after a green
    # preflight), emit whatever evidence exists — fresh results from this
    # run plus timestamped last-good — instead of dying empty-handed.
    total_timeout = float(os.environ.get("BENCH_TOTAL_TIMEOUT", "2400"))

    def die():
        print(
            f"bench: wall-clock exceeded {total_timeout:.0f}s — the device "
            "most likely hung mid-run (preflight was green). Emitting "
            "partial/last-good evidence.",
            file=sys.stderr,
        )
        rc = emit(allow_stale=True)
        sys.stderr.flush()
        os._exit(3 if rc < 0 else rc)

    watchdog = threading.Timer(total_timeout, die)
    watchdog.daemon = True
    watchdog.start()

    if not preflight(device):
        # No device answered. Fall back to the persisted last-good record
        # rather than erasing the evidence; only FATAL when there is truly
        # nothing to show.
        watchdog.cancel()
        rc = emit(allow_stale=True)
        if rc >= 0:
            print(
                "bench: no CUDA device answered — emitted the last-good "
                "record (see results_from_last_good/timestamps).",
                file=sys.stderr,
            )
            return rc
        reason = ("no last-good record exists" if stale_ok else
                  "stale fallback is disabled for smoke/variant runs")
        print(
            f"bench: FATAL: no CUDA device answered and {reason}.\n"
            "  On a host without a card run with K8S_TPU_PLATFORM=cpu "
            "for a smoke value.",
            file=sys.stderr,
        )
        return 2

    # First in-process CUDA init after the subprocess probes: bound it
    # like a probe — on a hang, fall back to last-good instead of burning
    # the watchdog's budget.
    def _init_backend():
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.init()
        return _device_kind(dev)

    try:
        device_kind = run_with_timeout(
            _init_backend,
            float(os.environ.get("BENCH_PREFLIGHT_TIMEOUT", "120")) * 2,
            "backend init",
        )
    except ProbeTimeout as e:
        print(f"bench: the device hung between preflight and init ({e}); "
              "emitting last-good evidence.", file=sys.stderr)
        rc = emit(allow_stale=True)
        return 2 if rc < 0 else rc
    n_chips = 1  # one device is driven
    on_hardware = device == "cuda"

    # Smoke knobs (CPU validation / quick runs); defaults are the real bench.
    rn_kw = {}
    tf_kw = {}
    dc_kw = {}
    vt_kw = {}
    dd_kw = {}
    if os.environ.get("BENCH_SMOKE"):
        rn_kw = dict(batch_per_chip=2, iters=2, warmup=1)
        tf_kw = dict(batch_per_chip=1, seq=128, iters=2, warmup=1)
        dc_kw = dict(batch_per_chip=2, prompt_len=16, new_tokens=16,
                     calls=2, warmup=1)
        vt_kw = dict(batch_per_chip=2, iters=2, warmup=1)
        dd_kw = dict(batch_per_chip=2, prompt_len=64, chunk=16,
                     beam_prompt=16, beam_new=8, sweep_batch=4, calls=1)
    if on_hardware and (os.environ.get("BENCH_SMOKE")
                        or os.environ.get("BENCH_SEQ")
                        or os.environ.get("BENCH_WINDOW")
                        or os.environ.get("BENCH_KV_CACHE")
                        or non_default_param_dtype):
        on_hardware = False  # non-default shapes must not overwrite evidence

    try:
        if wants["vit"]:
            recorder.record("vit", bench_vit(**vt_kw), on_hardware,
                            device_kind)
        if wants["decode"]:
            recorder.record("decode", bench_decode(**dc_kw), on_hardware,
                            device_kind)
        if wants["decode_depth"]:
            recorder.record("decode_depth", bench_decode_depth(**dd_kw),
                            on_hardware, device_kind)
        if wants["resnet50"]:
            recorder.record("resnet50", bench_resnet50(**rn_kw), on_hardware,
                            device_kind)
        if wants["transformer"]:
            transformer = bench_transformer(**tf_kw)
            recorder.record("transformer", transformer, on_hardware,
                            device_kind)
            if (transformer["flash_attention"]
                    and not transformer.get("window")
                    and not os.environ.get("BENCH_NO_CONTROL")):
                # plain-attention control: same model/shapes, flash off,
                # fewer repeats — it anchors the flash speedup in the
                # line, not a precision measurement of the slow path.
                recorder.record(
                    "transformer_xla_control",
                    bench_transformer(
                        **{**tf_kw, "use_flash": False, "repeats": 3}),
                    on_hardware, device_kind,
                )
    except Exception as e:  # noqa: BLE001 - a lost device, else re-raised
        watchdog.cancel()
        if not is_transient(e):
            raise
        # The device was lost mid-measurement: emit what exists — fresh
        # results already recorded plus last-good — exactly like die()
        # does for hangs, instead of dying with a traceback and no line.
        print(
            "bench: device lost mid-measurement "
            f"({str(e).splitlines()[0][:200]}); emitting partial/last-good "
            "evidence.",
            file=sys.stderr,
        )
        rc = emit(allow_stale=True, device_kind=device_kind, n_chips=n_chips)
        return 3 if rc < 0 else rc

    # Every requested cell ran: emit fresh-only (no stale fill) so a
    # normal green run is never contaminated by old numbers.  Cancel the
    # watchdog first — a die() firing at the boundary would print a second
    # JSON line and clobber the exit code.
    watchdog.cancel()
    rc = emit(allow_stale=False, device_kind=device_kind, n_chips=n_chips)
    return max(rc, 0)


if __name__ == "__main__":
    sys.exit(main())
