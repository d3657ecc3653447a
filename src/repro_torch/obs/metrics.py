"""Typed counter / gauge / histogram registry with labels (DESIGN.md #11).

The registry is the cross-cutting view over the per-call stats objects
(`SelfJoinStats`, `ServiceStats`): those stay the public API and are
*mirrored* into the registry by the instrumentation layer while tracing is
enabled.  Metrics carry free-form string labels (tier, bucket, worker,
epoch, ...), support ``snapshot()``/``diff()`` for windowed accounting, and
export as JSON or Prometheus text exposition format.

Keys in a snapshot are ``(metric_name, ((label, value), ...))`` with labels
sorted, so two snapshots diff with plain dict arithmetic.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "HistogramValue",
    "MetricsRegistry",
    "REGISTRY",
    "metric_value",
]

LabelKey = Tuple[Tuple[str, str], ...]
SnapKey = Tuple[str, LabelKey]

DEFAULT_BUCKETS = (
    1e-4,
    1e-3,
    1e-2,
    0.1,
    0.5,
    1.0,
    5.0,
    10.0,
    60.0,
    float("inf"),
)


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, lock: threading.Lock):
        self.name = name
        self.help = help
        self._lock = lock
        self._values: Dict[LabelKey, object] = {}

    def labeled(self) -> List[Tuple[LabelKey, object]]:
        with self._lock:
            return list(self._values.items())


class Counter(_Metric):
    """Monotonically increasing count; ``inc`` with optional labels."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease (got {value})")
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._values.get(_label_key(labels), 0.0))


class Gauge(_Metric):
    """Point-in-time value; ``set``/``inc``/``dec`` with optional labels."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def inc(self, value: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def dec(self, value: float = 1.0, **labels) -> None:
        self.inc(-value, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._values.get(_label_key(labels), 0.0))


class HistogramValue:
    """Immutable histogram reading: cumulative bucket counts + sum + count."""

    __slots__ = ("bounds", "bucket_counts", "sum", "count")

    def __init__(self, bounds, bucket_counts, sum_, count):
        self.bounds = tuple(bounds)
        self.bucket_counts = tuple(bucket_counts)
        self.sum = sum_
        self.count = count

    def __sub__(self, other: "HistogramValue") -> "HistogramValue":
        if self.bounds != other.bounds:
            raise ValueError("histogram bounds mismatch in diff")
        return HistogramValue(
            self.bounds,
            tuple(a - b for a, b in zip(self.bucket_counts, other.bucket_counts)),
            self.sum - other.sum,
            self.count - other.count,
        )

    def __eq__(self, other):
        return (
            isinstance(other, HistogramValue)
            and self.bounds == other.bounds
            and self.bucket_counts == other.bucket_counts
            and self.sum == other.sum
            and self.count == other.count
        )

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"HistogramValue(count={self.count}, sum={self.sum})"

    def to_json(self):
        return {
            "bounds": [b if b != float("inf") else "+Inf" for b in self.bounds],
            "bucket_counts": list(self.bucket_counts),
            "sum": self.sum,
            "count": self.count,
        }


class Histogram(_Metric):
    """Cumulative-bucket histogram; ``observe`` with optional labels."""

    kind = "histogram"

    def __init__(self, name, help, lock, buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, lock)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds or bounds[-1] != float("inf"):
            bounds = bounds + (float("inf"),)
        self.bounds = bounds

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            cell = self._values.get(key)
            if cell is None:
                cell = self._values[key] = [[0] * len(self.bounds), 0.0, 0]
            counts, _, _ = cell
            for i, b in enumerate(self.bounds):
                if value <= b:
                    counts[i] += 1
            cell[1] += value
            cell[2] += 1

    def value(self, **labels) -> HistogramValue:
        with self._lock:
            cell = self._values.get(_label_key(labels))
            if cell is None:
                return HistogramValue(self.bounds, [0] * len(self.bounds), 0.0, 0)
            return HistogramValue(self.bounds, list(cell[0]), cell[1], cell[2])


class MetricsRegistry:
    """Get-or-create registry of typed metrics.

    Metric names are unique across kinds: asking for ``counter("x")`` after
    ``gauge("x")`` raises, which catches taxonomy drift early.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str, **kwargs) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, self._lock, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, requested {cls.kind}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "", buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def clear(self) -> None:
        with self._lock:
            self._metrics = {}

    def snapshot(self) -> Dict[SnapKey, object]:
        """Flat copy: ``(name, labels)`` -> float or :class:`HistogramValue`."""
        out: Dict[SnapKey, object] = {}
        for m in self.metrics():
            for key, _ in m.labeled():
                out[(m.name, key)] = m.value(**dict(key))
        return out

    def diff(self, before: Dict[SnapKey, object]) -> Dict[SnapKey, object]:
        """Delta vs an earlier snapshot.

        Counters and histograms subtract; gauges report their current value
        (a gauge delta is rarely what a caller wants).  Keys absent from
        ``before`` diff against zero.
        """
        gauges = {m.name for m in self.metrics() if isinstance(m, Gauge)}
        out: Dict[SnapKey, object] = {}
        for key, after in self.snapshot().items():
            name, _ = key
            prior = before.get(key)
            if name in gauges or prior is None:
                out[key] = after
            else:
                out[key] = after - prior
        return out

    # -- exporters ---------------------------------------------------------

    def to_json(self) -> str:
        doc = []
        for m in self.metrics():
            series = []
            for key, _ in sorted(m.labeled()):
                v = m.value(**dict(key))
                series.append(
                    {
                        "labels": dict(key),
                        "value": v.to_json() if isinstance(v, HistogramValue) else v,
                    }
                )
            doc.append({"name": m.name, "kind": m.kind, "help": m.help, "series": series})
        return json.dumps(doc, indent=2, sort_keys=True)

    def to_prometheus_text(self) -> str:
        lines: List[str] = []
        for m in self.metrics():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for key, _ in sorted(m.labeled()):
                v = m.value(**dict(key))
                if isinstance(v, HistogramValue):
                    for bound, c in zip(v.bounds, v.bucket_counts):
                        le = "+Inf" if bound == float("inf") else repr(bound)
                        lines.append(f"{m.name}_bucket{_prom_labels(key, le=le)} {c}")
                    lines.append(f"{m.name}_sum{_prom_labels(key)} {v.sum}")
                    lines.append(f"{m.name}_count{_prom_labels(key)} {v.count}")
                else:
                    lines.append(f"{m.name}{_prom_labels(key)} {_prom_num(v)}")
        return "\n".join(lines) + "\n"


def _prom_labels(key: LabelKey, **extra) -> str:
    items = list(key) + sorted(extra.items())
    if not items:
        return ""
    body = ",".join(f'{k}="{_prom_escape(v)}"' for k, v in items)
    return "{" + body + "}"


def _prom_escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _prom_num(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


def metric_value(snap: Dict[SnapKey, object], name: str, **labels) -> float:
    """Sum a snapshot/diff's entries for ``name`` whose labels ⊇ ``labels``.

    Histograms contribute their ``count``.  Convenient for parity checks:
    ``metric_value(cap.metrics, "selfjoin_device_dispatches_total")``.
    """
    want = {k: str(v) for k, v in labels.items()}
    total = 0.0
    for (n, key), v in snap.items():
        if n != name:
            continue
        have = dict(key)
        if any(have.get(k) != wv for k, wv in want.items()):
            continue
        total += v.count if isinstance(v, HistogramValue) else v
    return total


REGISTRY = MetricsRegistry()
"""Process-wide default registry used by the mirror helpers."""
