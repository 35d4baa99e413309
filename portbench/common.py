"""What every part of the benchmark shares: files found by name, the model
spec read from a configuration file, weights made from the seed, the
nearest-rank quantile, the timers and the reduction of a profiler trace.

Nothing here imports the port: the reference builds on this module too.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import json
import os
import sys
from typing import Optional

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
# top-level module names that may not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "k8s_tpu")
# idle gaps shorter than this are launch latency; they are summed apart
SHORT_GAP_NS = 10_000


def load_json(kind: str, name: str) -> dict:
    """``portbench/<kind>/<name>.json``: a configuration or a cell."""
    path = os.path.join(PKG, kind, name + ".json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    """The benchmark's definition, ``BENCHMARK.json`` at the checkout's
    root."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """A decoder's sizes as a configuration file states them (the
    published ``config.json`` keys, with the port's departures)."""

    vocab: int
    hidden: int
    ffn: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    max_seq_len: int
    rope_theta: float
    window: Optional[int]
    eps: float
    experts: int = 0
    top_k: int = 0
    capacity_factor: float = 0.0
    dtype: str = "bfloat16"

    @classmethod
    def from_config(cls, c: dict) -> "ModelSpec":
        """The sizes as run: the file's published keys, with its
        ``departures`` (the values the port forces, each ``as_run``) in
        their place."""
        c = dict(c, **{k: v["as_run"]
                       for k, v in c.get("departures", {}).items()})
        if not c.get("tie_word_embeddings", False):
            raise ValueError("the port ties its head to the embedding; the "
                             "file must state tie_word_embeddings true")
        if c.get("hidden_act", "silu") != "silu":
            raise ValueError("the port's MLP is SwiGLU (silu)")
        heads = c["num_attention_heads"]
        return cls(
            vocab=c["vocab_size"], hidden=c["hidden_size"],
            ffn=c["intermediate_size"], layers=c["num_hidden_layers"],
            heads=heads, kv_heads=c.get("num_key_value_heads", heads),
            head_dim=c.get("head_dim") or c["hidden_size"] // heads,
            max_seq_len=c["max_position_embeddings"],
            rope_theta=float(c["rope_theta"]),
            window=c.get("sliding_window"), eps=float(c["rms_norm_eps"]),
            experts=c.get("num_local_experts", 0) or 0,
            top_k=c.get("num_experts_per_tok", 0) or 0,
            capacity_factor=float(c.get("expert_capacity_factor", 0.0)),
            dtype=c.get("torch_dtype", "bfloat16"))

    @property
    def torch_dtype(self):
        import torch

        return getattr(torch, self.dtype)

    def layer_leaves(self) -> list[tuple[str, tuple, float]]:
        """One layer's random leaves in the port's state-dict names
        (without the ``layers.{i}.`` prefix): ``(name, shape, std)``, std
        1/sqrt(fan_in).  The norm scales (ones) and an MoE router (f32)
        are not among them."""
        d, f, D = self.hidden, self.ffn, self.head_dim
        H, Hk = self.heads, self.kv_heads
        out = [("attn.q_proj.weight", (H * D, d), d ** -0.5),
               ("attn.k_proj.weight", (Hk * D, d), d ** -0.5),
               ("attn.v_proj.weight", (Hk * D, d), d ** -0.5),
               ("attn.o_proj.weight", (d, H * D), (H * D) ** -0.5)]
        if self.experts:
            E = self.experts
            out += [("moe_mlp.w_gate", (E, d, f), d ** -0.5),
                    ("moe_mlp.w_up", (E, d, f), d ** -0.5),
                    ("moe_mlp.w_down", (E, f, d), f ** -0.5)]
        else:
            out += [("mlp.gate_proj.weight", (f, d), d ** -0.5),
                    ("mlp.up_proj.weight", (f, d), d ** -0.5),
                    ("mlp.down_proj.weight", (d, f), f ** -0.5)]
        return out


def sub_seed(seed: int, label: str) -> int:
    """A 63-bit generator seed for one group of weights, from the run's
    seed (any whole number) and the group's label."""
    h = hashlib.sha256(f"{int(seed)}:{label}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def _group(seed, label, leaves, dtype, device):
    """One group of leaves from one ``torch.randn`` call on ``device``:
    views of a flat buffer, each scaled by its std."""
    import torch

    total = sum(_numel(s) for _, s, _ in leaves)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, label))
    flat = torch.randn(total, generator=g, device=device, dtype=dtype)
    out, off = {}, 0
    for name, shape, std in leaves:
        n = _numel(shape)
        out[name] = flat[off:off + n].view(shape).mul_(std)
        off += n
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def embedding(spec: ModelSpec, seed: int, device, dtype):
    """The embedding (and tied head), N(0, 0.02)."""
    return _group(seed, "embedding", [("embedding", (spec.vocab, spec.hidden),
                                       0.02)], dtype, device)["embedding"]


def layer_params(spec: ModelSpec, seed: int, i: int, device, dtype) -> dict:
    """Layer ``i``'s weights as the port names them (without the prefix):
    projections and expert stacks from one call in ``dtype``, norm
    scales f32 ones, an MoE router N(0, 0.02) in f32 from its own call."""
    import torch

    out = _group(seed, f"layer{i}", spec.layer_leaves(), dtype, device)
    for name in ("attn_norm.scale", "mlp_norm.scale"):
        out[name] = torch.ones(spec.hidden, dtype=torch.float32,
                               device=device)
    if spec.experts:
        out["moe_mlp.router"] = _group(
            seed, f"router{i}", [("r", (spec.hidden, spec.experts), 0.02)],
            torch.float32, device)["r"]
    return out


def make_params(spec: ModelSpec, seed: int, device, dtype) -> dict:
    """The whole model's state dict in the port's layout, made on
    ``device`` from ``seed`` (one draw for each layer); the reference
    rebuilds any layer of it alone with :func:`layer_params`."""
    import torch

    sd = {"embedding": embedding(spec, seed, device, dtype)}
    for i in range(spec.layers):
        for name, t in layer_params(spec, seed, i, device, dtype).items():
            sd[f"layers.{i}.{name}"] = t
    sd["final_norm.scale"] = torch.ones(spec.hidden, dtype=torch.float32,
                                        device=device)
    return sd


def quantile_nearest(sorted_vals, q: float) -> float:
    """Nearest-rank quantile of an ascending sequence (None when empty)."""
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1,
              max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[int(idx)]


def cuda_seconds(fn, reps: int = 10, warmup: int = 2) -> float:
    """Device seconds a call of ``fn``: CUDA events around ``reps`` calls
    after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def _union(intervals):
    """Merged ``(start, end)`` intervals, ascending."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def profile_summary(prof, host_window_s: float, top: int = 10) -> dict:
    """Reduce a ``torch.profiler`` trace of a slice of the window:
    ``busy_s`` (the union of device activity), ``window_s`` (the slice:
    its host length, or the span of the device activity where that is
    longer), the ``top`` device operations by summed time, and the
    longest idle gaps summed by the host operation that was running at
    each gap's midpoint (the innermost recorded one)."""
    from torch._C._autograd import DeviceType

    dev, host, ops = [], [], {}
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            # a user annotation spans a host range replayed on the device
            # timeline: it is no device work
            if dur > 0 and not e.is_user_annotation():
                dev.append((start, start + dur))
                name = e.name()[:160]
                ops[name] = ops.get(name, 0) + dur
        elif dur > 0:
            host.append((start, start + dur, e.name()[:160]))
    merged = _union(dev)
    busy_ns = sum(e - s for s, e in merged)
    span_ns = merged[-1][1] - merged[0][0] if merged else 0
    gaps: dict[str, int] = {}
    host.sort()
    starts = [h[0] for h in host]
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        gap, mid = s1 - e0, (e0 + s1) // 2
        if gap < SHORT_GAP_NS:
            label = "gaps under 10 us"
        else:
            # nested host ops: the innermost one running at mid is the
            # latest-starting one that has not ended
            label = "no host op recorded"
            j = bisect.bisect_right(starts, mid) - 1
            for k in range(j, max(-1, j - 500), -1):
                if host[k][1] >= mid:
                    label = host[k][2]
                    break
        gaps[label] = gaps.get(label, 0) + gap

    def by_time(d):
        return sorted(d.items(), key=lambda kv: -kv[1])[:top]

    return {
        "busy_s": busy_ns / 1e9,
        "window_s": max(host_window_s, span_ns / 1e9),
        "device_ops": [[n, v / 1e9] for n, v in by_time(ops)],
        "idle_gaps": [[n, v / 1e9] for n, v in by_time(gaps)],
    }


def log(t_start: float, what: str) -> None:
    """A progress line on standard error, with the seconds since the
    run's start."""
    import time

    print(f"portbench: {time.perf_counter() - t_start:9.2f} s {what}",
          file=sys.stderr, flush=True)


def check_line(name: str, value, limit, ok: bool) -> dict:
    """One compared number beside its limit, as the result line and the
    last lines of standard error carry it."""
    return {"name": name, "value": value, "limit": limit, "ok": bool(ok)}
