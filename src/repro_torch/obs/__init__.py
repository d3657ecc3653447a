"""Span tracing + metrics registry of the PyTorch port (DESIGN.md #11).

A copy of the JAX package's ``repro.obs`` (kept separate so that
``repro_torch`` imports nothing of that package):

- :mod:`repro_torch.obs.trace` -- the span tracer, its ring buffer, the
  Chrome-trace exporter, and the ``torch.profiler`` bridge
  (``capture(torch_bridge=True)``, the counterpart of the reference's
  ``jax_bridge``);
- :mod:`repro_torch.obs.metrics` -- the counter/gauge/histogram registry
  that the stats objects are mirrored into;
- :mod:`repro_torch.obs.report` -- the per-phase/per-worker breakdown CLI
  (``python -m repro_torch.obs.report TRACE.json``).

The port's engine emits the reference engine's spans and events at the
same seams, and a few more of its own (the index build's phases,
``snapshot.*``, and the copies of a join's answer to the host,
``engine.*.readback``), so ``capture()`` windows read alike:

    from repro_torch import obs

    with obs.capture() as cap:
        engine.pairs()                  # or a stream of service requests
    assert cap.span_count(cat="dispatch") == result.stats.num_device_dispatches

Mirroring and recording only happen while tracing is enabled (normally via
``obs.capture()``), so production paths pay a single attribute check; a
chunk loop (``chunk_loop``) pays it once per loop, not per chunk.
"""

from __future__ import annotations

import json as _json
import logging as _logging
from typing import Dict, List, Optional

from repro_torch.obs import trace as _trace_mod
from repro_torch.obs.metrics import REGISTRY, MetricsRegistry, metric_value
from repro_torch.obs.trace import (
    DEFAULT_CAPACITY,
    SpanEvent,
    clear,
    disable,
    chunk_loop,
    dropped_count,
    enable,
    enabled,
    epoch_ns,
    event,
    event_count,
    events,
    span,
    span_series,
    to_chrome_trace,
    write_chrome_trace,
)

__all__ = [
    "DEFAULT_CAPACITY",
    "SpanEvent",
    "MetricsRegistry",
    "REGISTRY",
    "metric_value",
    "enable",
    "disable",
    "enabled",
    "clear",
    "events",
    "event_count",
    "dropped_count",
    "epoch_ns",
    "span",
    "event",
    "span_series",
    "chunk_loop",
    "to_chrome_trace",
    "write_chrome_trace",
    "inc",
    "observe",
    "set_gauge",
    "mirror_selfjoin_stats",
    "mirror_service_stats",
    "request_log",
    "Capture",
    "capture",
]

_LOG = _logging.getLogger("repro_torch.obs")


# -- registry convenience (all gated on the tracer switch) -------------------

def inc(name: str, value: float = 1.0, **labels) -> None:
    """Increment a counter in the default registry (no-op when disabled)."""
    if _trace_mod._state.enabled:
        REGISTRY.counter(name).inc(value, **labels)


def observe(name: str, value: float, **labels) -> None:
    """Record a histogram observation (no-op when disabled)."""
    if _trace_mod._state.enabled:
        REGISTRY.histogram(name).observe(value, **labels)


def set_gauge(name: str, value: float, **labels) -> None:
    """Set a gauge (no-op when disabled)."""
    if _trace_mod._state.enabled:
        REGISTRY.gauge(name).set(value, **labels)


def mirror_selfjoin_stats(stats, *, path: str, mode: str) -> None:
    """Mirror a completed join's ``SelfJoinStats`` into the registry.

    ``path`` names the execution path ("engine", "ring_host", "ring_fused"),
    ``mode`` the result shape ("count", "pairs", "count_query").  The tier
    label is the tier that actually ran.  Counts mirror 1:1, with the same
    metric names as the JAX package.
    """
    if not _trace_mod._state.enabled:
        return
    tier = stats.execution or "indexed"
    labels = dict(path=path, mode=mode, tier=tier)
    c = REGISTRY.counter
    c("selfjoin_joins_total", "completed self-join calls").inc(1, **labels)
    c("selfjoin_device_dispatches_total", "host->device program launches").inc(
        stats.num_device_dispatches, **labels
    )
    c("selfjoin_chunks_total", "chunk programs in the final attempt").inc(
        stats.num_chunks, **labels
    )
    c("selfjoin_candidates_total", "point comparisons evaluated").inc(
        stats.num_candidates, **labels
    )
    c("selfjoin_results_total", "result rows (|R|)").inc(stats.num_results, **labels)
    c("selfjoin_overflow_retries_total", "pairs-buffer regrow retries").inc(
        stats.overflow_retries, **labels
    )


def mirror_service_stats(stats, *, kind: str) -> None:
    """Mirror one request's ``ServiceStats`` into the registry.

    ``kind`` is the request type ("range_count", "range_pairs", "knn").
    Gauges track the churn state the request observed (epoch, delta size,
    tombstones); counters mirror the per-request work counters.
    """
    if not _trace_mod._state.enabled:
        return
    tier = stats.execution or "indexed"
    labels = dict(kind=kind, tier=tier)
    c = REGISTRY.counter
    c("service_requests_total", "requests served").inc(stats.num_requests, **labels)
    c("service_queries_total", "query rows served").inc(stats.num_queries, **labels)
    c("service_traces_total", "new chunk-program traces caused").inc(
        stats.num_traces, **labels
    )
    c("service_dispatches_total", "chunk-program launches").inc(
        stats.num_device_dispatches, **labels
    )
    c("service_results_total", "neighbours counted / pairs returned").inc(
        stats.num_results, **labels
    )
    c("service_eps_rounds_total", "eps-expansion passes").inc(
        stats.eps_rounds, **labels
    )
    c("service_index_rebuilds_total", "over-radius temporary snapshots").inc(
        stats.index_rebuilds, **labels
    )
    g = REGISTRY.gauge
    g("service_epoch", "compaction epoch last pinned").set(stats.epoch)
    g("service_delta_size", "delta-buffer points at last request").set(stats.delta_size)
    g("service_tombstones", "tombstoned points at last request").set(
        stats.tombstone_count
    )
    REGISTRY.histogram("service_request_queries", "query rows per request").observe(
        stats.num_queries, kind=kind
    )


def request_log(kind: str, stats) -> None:
    """Per-request structured log record: instant trace event + debug log."""
    fields = {
        "kind": kind,
        "nq": stats.num_queries,
        "bucket": stats.bucket,
        "eps": round(float(stats.eps), 6),
        "eps_rounds": stats.eps_rounds,
        "traces": stats.num_traces,
        "dispatches": stats.num_device_dispatches,
        "results": stats.num_results,
        "tier": stats.execution,
        "epoch": stats.epoch,
    }
    if _trace_mod._state.enabled:
        event("service.request", "log", **fields)
    if _LOG.isEnabledFor(_logging.DEBUG):
        _LOG.debug("request %s", _json.dumps(fields, sort_keys=True))


class Capture:
    """Result of an ``obs.capture()`` window: events, registry delta, drops,
    and the Unix time (ns) the events' ``ts_us`` count from."""

    def __init__(self):
        self.events: List[SpanEvent] = []
        self.metrics: Dict = {}
        self.dropped: int = 0
        self.epoch_ns: int = 0

    def spans(self, name: Optional[str] = None, cat: Optional[str] = None) -> List[SpanEvent]:
        return [
            e
            for e in self.events
            if (name is None or e.name == name) and (cat is None or e.cat == cat)
        ]

    def span_count(self, name: Optional[str] = None, cat: Optional[str] = None) -> int:
        return len(self.spans(name, cat))

    def metric(self, name: str, **labels) -> float:
        """Summed registry delta for ``name`` (labels filter as a subset)."""
        return metric_value(self.metrics, name, **labels)

    def chrome_trace(self) -> dict:
        return to_chrome_trace(self.events, epoch_ns=self.epoch_ns)

    def write_chrome_trace(self, path: str) -> str:
        return write_chrome_trace(path, self.events, epoch_ns=self.epoch_ns)


class capture:
    """Context manager: record spans + a registry delta over a window.

    Enables the tracer on entry (fresh ring buffer) and restores the
    previous tracer state on exit: an enclosing ``enable()`` window is
    re-opened with a fresh buffer and its own ``torch_bridge`` setting.
    ``torch_bridge=True`` opens a ``torch.profiler.record_function`` range
    around every span of the window.
    """

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        *,
        registry: Optional[MetricsRegistry] = None,
        torch_bridge: bool = False,
    ):
        self._capacity = capacity
        self._registry = registry if registry is not None else REGISTRY
        self._torch_bridge = torch_bridge
        self._cap: Optional[Capture] = None
        self._before: Optional[Dict] = None
        self._prev_enabled = False
        self._prev_bridge = False

    def __enter__(self) -> Capture:
        self._prev_enabled = enabled()
        self._prev_bridge = _trace_mod._state.bridge is not None
        enable(self._capacity, torch_bridge=self._torch_bridge)
        self._before = self._registry.snapshot()
        self._cap = Capture()
        return self._cap

    def __exit__(self, exc_type, exc, tb):
        cap = self._cap
        cap.events = events()
        cap.dropped = dropped_count()
        cap.epoch_ns = epoch_ns()
        cap.metrics = self._registry.diff(self._before)
        disable()
        clear()
        if self._prev_enabled:
            enable(self._capacity, torch_bridge=self._prev_bridge)
        return False
