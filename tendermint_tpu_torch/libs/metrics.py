"""Prometheus-style metrics: registry, instruments, text exposition.

Counterpart: tendermint_tpu/libs/metrics.py:1-690 (reference: the go-kit
prometheus metrics of every subsystem, internal/consensus/metrics.go,
internal/p2p/metrics.go, internal/mempool/metrics.go,
internal/state/metrics.go, catalog docs/nodes/metrics.md:21-53, and the
endpoint node/node.go:606): Counter, Gauge and Histogram with static
label names, the mergeable LatencySketch (:268) and its Sketch
instrument (:478), Registry (:555-655) and the DEFAULT_REGISTRY helpers
(:658-690), rendered in the Prometheus text exposition format 0.0.4 with
the JAX escaping (:46-70). The output is the JAX package's byte for
byte, so a dashboard reads both packages alike.

Per-node registries: each subsystem has a go-kit-style struct
(consensus/metrics.py, state/metrics.py, evidence/metrics.py,
mempool/metrics.py, p2p/metrics.py, rpc/metrics.py, eventbus
EventBusMetrics) built against a Registry. node/node.py builds one
Registry a node and threads the structs through the constructors, so
nodes in one process scrape disjoint series. A struct built without a
registry lands on DEFAULT_REGISTRY, which also holds the process-wide
families: the device verifier's gpu_* (crypto/gpu_verifier.py), the
verified-signature cache's sigcache_* and the breakers' breaker_*. No
decision of the port reads a metric.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "LatencySketch",
    "Sketch",
    "Registry",
    "DEFAULT_REGISTRY",
    "new_counter",
    "new_gauge",
    "new_histogram",
    "new_sketch",
]


def _escape_label(v: str) -> str:
    """Text-format escaping: backslash, quote, newline — one corrupt
    label value must not make the whole scrape unparseable."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_labels(names: Sequence[str], values: Tuple[str, ...]) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)
    )
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v)


class _Metric:
    kind = ""

    def __init__(
        self, name: str, help_: str, label_names: Sequence[str] = ()
    ) -> None:
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()

    def with_labels(self, **labels: str):
        """Bound child for a label combination."""
        key = tuple(str(labels[n]) for n in self.label_names)
        return self._child(key)

    def _child(self, key: Tuple[str, ...]):
        raise NotImplementedError

    def render(self) -> List[str]:
        raise NotImplementedError

    def _header(self) -> List[str]:
        return [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.kind}",
        ]


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help_, label_names=()):
        super().__init__(name, help_, label_names)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            # Prometheus counters are monotonic; a negative inc would
            # silently corrupt every rate() over the series
            raise ValueError(
                f"counter {self.name} cannot decrease (inc by {amount})"
            )
        key = tuple(str(labels[n]) for n in self.label_names)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        key = tuple(str(labels[n]) for n in self.label_names)
        return self._values.get(key, 0.0)

    def render(self) -> List[str]:
        out = self._header()
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.label_names:
            items = [((), 0.0)]
        for key, v in items:
            out.append(
                f"{self.name}{_fmt_labels(self.label_names, key)}"
                f" {_fmt_value(v)}"
            )
        return out


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help_, label_names=()):
        super().__init__(name, help_, label_names)
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, value: float, **labels: str) -> None:
        key = tuple(str(labels[n]) for n in self.label_names)
        with self._lock:
            self._values[key] = float(value)

    def add(self, amount: float, **labels: str) -> None:
        key = tuple(str(labels[n]) for n in self.label_names)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        key = tuple(str(labels[n]) for n in self.label_names)
        return self._values.get(key, 0.0)

    def render(self) -> List[str]:
        out = self._header()
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.label_names:
            items = [((), 0.0)]
        for key, v in items:
            out.append(
                f"{self.name}{_fmt_labels(self.label_names, key)}"
                f" {_fmt_value(v)}"
            )
        return out


_DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(
        self,
        name,
        help_,
        label_names=(),
        buckets: Sequence[float] = _DEFAULT_BUCKETS,
    ):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(sorted(buckets))
        # key -> (per-bucket counts, sum, count)
        self._values: Dict[Tuple[str, ...], list] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = tuple(str(labels[n]) for n in self.label_names)
        with self._lock:
            entry = self._values.get(key)
            if entry is None:
                entry = [[0] * len(self.buckets), 0.0, 0]
                self._values[key] = entry
            counts, _, _ = entry
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            entry[1] += value
            entry[2] += 1

    def time(self, **labels: str):
        """Context manager observing elapsed seconds."""
        return _Timer(self, labels)

    def count(self, **labels: str) -> int:
        key = tuple(str(labels[n]) for n in self.label_names)
        entry = self._values.get(key)
        return entry[2] if entry else 0

    def sum(self, **labels: str) -> float:
        key = tuple(str(labels[n]) for n in self.label_names)
        entry = self._values.get(key)
        return entry[1] if entry else 0.0

    def render(self) -> List[str]:
        out = self._header()
        with self._lock:
            items = sorted(self._values.items())
        for key, (counts, total, n) in items:
            cum = 0
            for i, b in enumerate(self.buckets):
                cum = counts[i]
                lbls = dict(zip(self.label_names, key))
                lbls["le"] = _fmt_value(float(b))
                names = list(self.label_names) + ["le"]
                vals = tuple(lbls[x] for x in names)
                out.append(
                    f"{self.name}_bucket{_fmt_labels(names, vals)} {cum}"
                )
            names = list(self.label_names) + ["le"]
            vals = tuple(list(key) + ["+Inf"])
            out.append(
                f"{self.name}_bucket{_fmt_labels(names, vals)} {n}"
            )
            out.append(
                f"{self.name}_sum{_fmt_labels(self.label_names, key)}"
                f" {_fmt_value(total)}"
            )
            out.append(
                f"{self.name}_count{_fmt_labels(self.label_names, key)} {n}"
            )
        return out


class _Timer:
    def __init__(self, hist: Histogram, labels: dict) -> None:
        self.hist = hist
        self.labels = labels

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.observe(
            time.perf_counter() - self._t0, **self.labels
        )
        return False


class LatencySketch:
    """Mergeable log-bucketed latency sketch (DDSketch/HDR-style).

    Values land in geometric buckets `(gamma**(i-1), gamma**i]` with
    `gamma = (1+eps)/(1-eps)`; a bucket's reported value is its
    harmonic midpoint `2*gamma**i/(gamma+1)`, so every quantile
    estimate is within **relative error `eps`** (default 1%) of the
    sample the same nearest-rank rule would pick from the sorted data —
    for values inside `[min_value, max_value]` (outside, the value is
    clamped to the edge bucket and the bound does not hold; the
    defaults cover 1 µs .. ~28 h of latency). Memory is bounded by the
    bucket-index range: `ceil(log(max/min)/log(gamma)) + 1` buckets
    (~1.2k at eps=1%), independent of observation count.

    Sketches with identical `(relative_error, min_value, max_value)`
    merge exactly (bucket-wise count addition): per-worker or per-node
    sketches combine into fleet quantiles without re-recording — the
    property ad-hoc "sort all the samples" percentile math lacks once
    samples outlive one process. merge() is associative and
    commutative; quantiles of a merged sketch carry the same eps bound.
    """

    __slots__ = (
        "relative_error",
        "min_value",
        "max_value",
        "_gamma",
        "_log_gamma",
        "_min_idx",
        "_max_idx",
        "_counts",
        "_count",
        "_sum",
        "_min",
        "_max",
        "_lock",
    )

    def __init__(
        self,
        relative_error: float = 0.01,
        min_value: float = 1e-6,
        max_value: float = 1e5,
    ) -> None:
        if not 0.0 < relative_error < 1.0:
            raise ValueError(
                f"relative_error must be in (0, 1): {relative_error}"
            )
        if not 0.0 < min_value < max_value:
            raise ValueError(
                f"need 0 < min_value < max_value: {min_value}, {max_value}"
            )
        self.relative_error = relative_error
        self.min_value = min_value
        self.max_value = max_value
        self._gamma = (1.0 + relative_error) / (1.0 - relative_error)
        self._log_gamma = math.log(self._gamma)
        self._min_idx = math.ceil(math.log(min_value) / self._log_gamma)
        self._max_idx = math.ceil(math.log(max_value) / self._log_gamma)
        # bucket index -> count; key range is clamped to
        # [_min_idx, _max_idx], so the dict is bounded at ~1.2k entries
        # regardless of how many values are recorded
        self._counts: Dict[int, int] = {}
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def _index(self, value: float) -> int:
        if value <= self.min_value:
            return self._min_idx
        i = math.ceil(math.log(value) / self._log_gamma)
        if i > self._max_idx:
            return self._max_idx
        return i

    def _value_of(self, idx: int) -> float:
        return 2.0 * self._gamma ** idx / (self._gamma + 1.0)

    def record(self, value: float) -> None:
        """Record one observation (seconds, bytes, depth — any
        positive-ish magnitude; <= 0 clamps into the lowest bucket)."""
        v = float(value)
        i = self._index(v)
        with self._lock:
            self._counts[i] = self._counts.get(i, 0) + 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def min(self) -> float:
        return self._min if self._count else 0.0

    @property
    def max(self) -> float:
        return self._max if self._count else 0.0

    def _compatible(self, other: "LatencySketch") -> bool:
        return (
            self.relative_error == other.relative_error
            and self.min_value == other.min_value
            and self.max_value == other.max_value
        )

    def merge(self, other: "LatencySketch") -> "LatencySketch":
        """Fold `other`'s observations into this sketch (in place).
        Both must share bucket parameters — merging sketches with
        different error bounds would silently produce neither bound."""
        if not self._compatible(other):
            raise ValueError(
                "cannot merge sketches with different parameters: "
                f"(eps={self.relative_error}, range=[{self.min_value}, "
                f"{self.max_value}]) vs (eps={other.relative_error}, "
                f"range=[{other.min_value}, {other.max_value}])"
            )
        with other._lock:
            counts = dict(other._counts)
            o_count, o_sum = other._count, other._sum
            o_min, o_max = other._min, other._max
        with self._lock:
            for i, c in counts.items():
                self._counts[i] = self._counts.get(i, 0) + c
            self._count += o_count
            self._sum += o_sum
            if o_min < self._min:
                self._min = o_min
            if o_max > self._max:
                self._max = o_max
        return self

    def snapshot(self) -> "LatencySketch":
        """An independent point-in-time copy (safe to merge/quantile
        while the original keeps recording)."""
        out = LatencySketch(
            self.relative_error, self.min_value, self.max_value
        )
        with self._lock:
            out._counts = dict(self._counts)
            out._count = self._count
            out._sum = self._sum
            out._min = self._min
            out._max = self._max
        return out

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile estimate: the bucket holding the
        `ceil(q*count)`-th smallest observation, reported at the bucket
        midpoint (within `relative_error` of the true sample for
        in-range values). Returns 0.0 on an empty sketch."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1]: {q}")
        with self._lock:
            if self._count == 0:
                return 0.0
            rank = max(1, math.ceil(q * self._count))
            cum = 0
            for i in sorted(self._counts):
                cum += self._counts[i]
                if cum >= rank:
                    return self._value_of(i)
        return self._value_of(self._max_idx)  # pragma: no cover

    def quantiles(self, qs: Sequence[float]) -> List[float]:
        return [self.quantile(q) for q in qs]

    def to_dict(self) -> dict:
        """JSON-encodable form (BENCH_LOAD rows, cross-process merge)."""
        with self._lock:
            return {
                "relative_error": self.relative_error,
                "min_value": self.min_value,
                "max_value": self.max_value,
                "counts": {str(i): c for i, c in self._counts.items()},
                "count": self._count,
                "sum": self._sum,
                "min": self._min if self._count else 0.0,
                "max": self._max if self._count else 0.0,
            }

    @classmethod
    def from_dict(cls, d: dict) -> "LatencySketch":
        out = cls(
            float(d["relative_error"]),
            float(d["min_value"]),
            float(d["max_value"]),
        )
        out._counts = {int(i): int(c) for i, c in d["counts"].items()}
        out._count = int(d["count"])
        out._sum = float(d["sum"])
        if out._count:
            out._min = float(d["min"])
            out._max = float(d["max"])
        return out


class Sketch(_Metric):
    """Registry instrument wrapping one LatencySketch per label set,
    rendered as a Prometheus `summary` (quantile series + _sum +
    _count). Where Histogram answers "how many under 100 ms", Sketch
    answers "what IS p999" — with a documented error bound and
    mergeable children (`sketch()` hands out the live LatencySketch)."""

    kind = "summary"

    QUANTILES = (0.5, 0.9, 0.99, 0.999)

    def __init__(
        self,
        name,
        help_,
        label_names=(),
        relative_error: float = 0.01,
    ):
        super().__init__(name, help_, label_names)
        self.relative_error = relative_error
        self._values: Dict[Tuple[str, ...], LatencySketch] = {}

    def _child(self, key: Tuple[str, ...]) -> LatencySketch:
        with self._lock:
            sk = self._values.get(key)
            if sk is None:
                sk = LatencySketch(self.relative_error)
                self._values[key] = sk
            return sk

    def sketch(self, **labels: str) -> LatencySketch:
        """The live per-label-set sketch (record/merge/quantile)."""
        key = tuple(str(labels[n]) for n in self.label_names)
        return self._child(key)

    def observe(self, value: float, **labels: str) -> None:
        self.sketch(**labels).record(value)

    def quantile(self, q: float, **labels: str) -> float:
        return self.sketch(**labels).quantile(q)

    def count(self, **labels: str) -> int:
        return self.sketch(**labels).count

    def merged(self) -> LatencySketch:
        """All label sets folded into one sketch (fleet view)."""
        out = LatencySketch(self.relative_error)
        with self._lock:
            children = list(self._values.values())
        for sk in children:
            out.merge(sk.snapshot())
        return out

    def render(self) -> List[str]:
        out = self._header()
        with self._lock:
            items = sorted(self._values.items())
        for key, sk in items:
            snap = sk.snapshot()
            names = list(self.label_names) + ["quantile"]
            for q in self.QUANTILES:
                vals = tuple(list(key) + [str(q)])
                out.append(
                    f"{self.name}{_fmt_labels(names, vals)}"
                    f" {_fmt_value(snap.quantile(q))}"
                )
            out.append(
                f"{self.name}_sum{_fmt_labels(self.label_names, key)}"
                f" {_fmt_value(snap.sum)}"
            )
            out.append(
                f"{self.name}_count"
                f"{_fmt_labels(self.label_names, key)} {snap.count}"
            )
        return out


class Registry:
    """Named collection rendered as one exposition document."""

    def __init__(self, namespace: str = "tendermint_tpu") -> None:
        self.namespace = namespace
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def register(self, metric: _Metric) -> _Metric:
        """Idempotent for an identical spec (node restarts in-process
        return the live instrument); a CONFLICTING re-registration —
        same name, different kind, label names, or buckets — raises,
        because the typo'd duplicate would silently record into the
        wrong series."""
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                if (
                    existing.kind != metric.kind
                    or existing.label_names != metric.label_names
                    or getattr(existing, "buckets", None)
                    != getattr(metric, "buckets", None)
                    or getattr(existing, "relative_error", None)
                    != getattr(metric, "relative_error", None)
                ):
                    raise ValueError(
                        f"metric {metric.name!r} already registered as "
                        f"{existing.kind}{existing.label_names} "
                        f"(conflicts with {metric.kind}"
                        f"{metric.label_names})"
                    )
                return existing
            self._metrics[metric.name] = metric
            return metric

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def names(self) -> frozenset:
        with self._lock:
            return frozenset(self._metrics)

    def full_name(self, subsystem: str, name: str) -> str:
        return f"{self.namespace}_{subsystem}_{name}"

    def counter(
        self, subsystem: str, name: str, help_: str, label_names=()
    ) -> Counter:
        return self.register(
            Counter(self.full_name(subsystem, name), help_, label_names)
        )

    def gauge(
        self, subsystem: str, name: str, help_: str, label_names=()
    ) -> Gauge:
        return self.register(
            Gauge(self.full_name(subsystem, name), help_, label_names)
        )

    def histogram(
        self, subsystem: str, name: str, help_: str, label_names=(),
        buckets=None,
    ) -> Histogram:
        return self.register(
            Histogram(
                self.full_name(subsystem, name),
                help_,
                label_names,
                buckets=buckets or _DEFAULT_BUCKETS,
            )
        )

    def sketch(
        self,
        subsystem: str,
        name: str,
        help_: str,
        label_names=(),
        relative_error: float = 0.01,
    ) -> Sketch:
        return self.register(
            Sketch(
                self.full_name(subsystem, name),
                help_,
                label_names,
                relative_error=relative_error,
            )
        )

    def render(self, exclude=frozenset()) -> str:
        """The exposition document; `exclude` skips series by full name
        (node/node.py merges the per-node registry with the
        process-global one without emitting duplicate series)."""
        lines: List[str] = []
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in metrics:
            if m.name in exclude:
                continue
            lines.extend(m.render())
        return "\n".join(lines) + "\n" if lines else ""


DEFAULT_REGISTRY = Registry()


def new_counter(
    subsystem: str, name: str, help_: str, label_names=()
) -> Counter:
    return DEFAULT_REGISTRY.counter(subsystem, name, help_, label_names)


def new_gauge(subsystem: str, name: str, help_: str, label_names=()) -> Gauge:
    return DEFAULT_REGISTRY.gauge(subsystem, name, help_, label_names)


def new_histogram(
    subsystem: str, name: str, help_: str, label_names=(), buckets=None
) -> Histogram:
    return DEFAULT_REGISTRY.histogram(
        subsystem, name, help_, label_names, buckets=buckets
    )


def new_sketch(
    subsystem: str,
    name: str,
    help_: str,
    label_names=(),
    relative_error: float = 0.01,
) -> Sketch:
    return DEFAULT_REGISTRY.sketch(
        subsystem, name, help_, label_names, relative_error=relative_error
    )
