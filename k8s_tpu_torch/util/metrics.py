"""Prometheus-style metrics: the port's own copy of the parts of
``k8s_tpu/util/metrics.py`` the server uses — Counter, Gauge, Histogram,
``Registry.expose`` (text exposition format 0.0.4) and the serving
families of the single-flight lane and the continuous-batching engine
(the reference's names and help text; its speculative and kv-transfer
families are left out with those features)."""

from __future__ import annotations

import bisect
import threading
from typing import Iterable, Sequence

_DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _format_labels(label_names: Sequence[str],
                   label_values: Sequence[str]) -> str:
    if not label_names:
        return ""
    pairs = ",".join(
        f'{k}="{_escape(v)}"' for k, v in zip(label_names, label_values))
    return "{" + pairs + "}"


def _escape(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _format_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class _Metric:
    """Base: one named metric with zero or more labeled children."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str,
                 label_names: Sequence[str] = ()):
        self.name = name
        self.help = help_text
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._children: dict[tuple, object] = {}

    def labels(self, *label_values: str):
        if len(label_values) != len(self.label_names):
            raise ValueError(f"{self.name}: expected labels "
                             f"{self.label_names}, got {label_values}")
        key = tuple(str(v) for v in label_values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._new_child()
                self._children[key] = child
            return child

    def _default_child(self):
        return self.labels()

    def _new_child(self):
        raise NotImplementedError

    def collect(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} {self.kind}"
        with self._lock:
            items = list(self._children.items())
        for key, child in items:
            yield from self._collect_child(key, child)

    def _collect_child(self, key: tuple, child) -> Iterable[str]:
        raise NotImplementedError


class _ValueChild:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _CounterChild(_ValueChild):
    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        super().inc(amount)


class Counter(_Metric):
    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    @property
    def value(self) -> float:
        return self._default_child().value

    def _collect_child(self, key, child):
        yield (f"{self.name}{_format_labels(self.label_names, key)} "
               f"{_format_value(child.value)}")


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help_text, label_names=(), fn=None):
        super().__init__(name, help_text, label_names)
        self._fn = fn  # callable gauge, sampled at scrape time

    def _new_child(self):
        return _ValueChild()

    def set(self, value: float) -> None:
        self._default_child().set(value)

    @property
    def value(self) -> float:
        return self._default_child().value

    def collect(self):
        if self._fn is not None:
            yield f"# HELP {self.name} {self.help}"
            yield f"# TYPE {self.name} {self.kind}"
            yield f"{self.name} {_format_value(float(self._fn()))}"
            return
        yield from super().collect()

    def _collect_child(self, key, child):
        yield (f"{self.name}{_format_labels(self.label_names, key)} "
               f"{_format_value(child.value)}")


class _HistogramChild:
    __slots__ = ("buckets", "counts", "total", "count", "_lock")

    def __init__(self, buckets: Sequence[float]):
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.total = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self.total += value
            self.count += 1
            # per-bucket counts; collect() accumulates into cumulative le=
            i = bisect.bisect_left(self.buckets, value)
            if i < len(self.buckets):
                self.counts[i] += 1


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_text, label_names=(),
                 buckets: Sequence[float] = _DEFAULT_BUCKETS):
        super().__init__(name, help_text, label_names)
        self.buckets = tuple(sorted(buckets))

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._default_child().observe(value)

    def _collect_child(self, key, child):
        with child._lock:
            counts, total, count = list(child.counts), child.total, child.count
        cumulative = 0
        for bound, n in zip(child.buckets, counts):
            cumulative += n
            labels = _format_labels(self.label_names + ("le",),
                                    key + (_format_value(bound),))
            yield f"{self.name}_bucket{labels} {cumulative}"
        inf = _format_labels(self.label_names + ("le",), key + ("+Inf",))
        yield f"{self.name}_bucket{inf} {count}"
        plain = _format_labels(self.label_names, key)
        yield f"{self.name}_sum{plain} {_format_value(total)}"
        yield f"{self.name}_count{plain} {count}"


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def register(self, metric: _Metric) -> _Metric:
        """Adds ``metric``; on a name collision returns the existing one."""
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                return existing
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name, help_text="", label_names=()) -> Counter:
        return self.register(Counter(name, help_text, label_names))

    def gauge(self, name, help_text="", label_names=(), fn=None) -> Gauge:
        return self.register(Gauge(name, help_text, label_names, fn=fn))

    def histogram(self, name, help_text="", label_names=(),
                  buckets=_DEFAULT_BUCKETS) -> Histogram:
        return self.register(Histogram(name, help_text, label_names,
                                       buckets))

    def expose(self) -> str:
        """Text exposition format 0.0.4."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.collect())
        return "\n".join(lines) + "\n" if lines else ""


def serving_metrics(registry: Registry) -> dict:
    """The inference-server families: request totals by result,
    backpressure rejections, emitted tokens, batch occupancy, admission
    queue depth (a callable gauge its server binds), end-to-end request
    latency, the paged KV cache's prefix-reuse counters and block gauge,
    and the per-request phase histograms."""
    r = registry
    return {
        "requests": r.counter(
            "serve_requests_total",
            "Generate requests by result (ok / bad_request / rejected / "
            "error).",
            ("result",),
        ),
        "rejected": r.counter(
            "serve_rejected_total",
            "Requests shed by admission-queue backpressure (HTTP 503 + "
            "Retry-After).",
        ),
        "tokens": r.counter(
            "serve_tokens_total",
            "Tokens emitted across all completed generations.",
        ),
        "occupancy": r.gauge(
            "serve_batch_occupancy",
            "Active decode slots in the most recent batched step "
            "(continuous-batching engine; 0..K8S_TPU_SERVE_SLOTS).",
        ),
        "queue_depth": r.gauge(
            "serve_queue_depth",
            "Requests waiting in the bounded admission queue, sampled at "
            "scrape time.",
        ),
        "duration": r.histogram(
            "serve_request_duration_seconds",
            "End-to-end /v1/generate latency (parse to response body), "
            "successful requests.",
        ),
        # -- paged KV cache / shared-prefix reuse ---------------------------
        "prefix_hits": r.counter(
            "serve_prefix_hits_total",
            "Requests that attached to at least one shared-prefix KV "
            "block instead of prefilling it (radix prefix tree).",
        ),
        "prefill_saved": r.counter(
            "serve_prefill_tokens_saved_total",
            "Prompt tokens whose prefill was skipped by shared-prefix "
            "KV reuse (attached by reference or copy-on-write).",
        ),
        "sampled_batched": r.counter(
            "serve_sampled_batched_total",
            "temperature>0 generations served on the batched slot lanes "
            "(row-wise sampling) instead of the exclusive lane.",
        ),
        "blocks_in_use": r.gauge(
            "serve_kv_blocks_in_use",
            "Live KV-cache pool blocks (slot tables + prefix tree), "
            "sampled after each allocation/release.",
        ),
        # -- per-request phase metrics --------------------------------------
        "ttft": r.histogram(
            "serve_ttft_seconds",
            "Time to first token: request submit to the first emitted "
            "token (queue wait + prefill + first sample), batched-lane "
            "generations.",
        ),
        "tpot": r.histogram(
            "serve_tpot_seconds",
            "Time per output token after the first: (e2e - TTFT) / "
            "(tokens - 1), per completed generation with >= 2 tokens.",
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 1.0),
        ),
        "queue_wait": r.histogram(
            "serve_queue_wait_seconds",
            "Admission-queue wait: request submit to slot admission "
            "(or to the exclusive lane picking it up).",
        ),
        "step_duration": r.histogram(
            "serve_step_duration_seconds",
            "Wall time of one batched engine program call (fused decode "
            "scan or speculative verify step), host read included.",
            buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 1.0, 2.5),
        ),
        "prefill_convoy": r.counter(
            "serve_prefill_convoy_total",
            "Admissions whose prefill ran while >= 1 decode-ready slot "
            "waited (the prefill convoy: decode stalled behind another "
            "request's prefill).",
        ),
    }
