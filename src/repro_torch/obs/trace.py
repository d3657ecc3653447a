"""Zero-overhead-when-disabled span tracer (DESIGN.md #11).

Spans are context managers recording monotonic wall times (microseconds),
nesting depth, and typed attributes into a bounded ring buffer.  The module
is off by default: ``span()``/``event()`` check one module attribute and
return a shared no-op object / return immediately, so instrumented hot paths
cost a dict lookup and a branch when tracing is disabled.

When enabled, events accumulate in a ring buffer of fixed capacity; once
full the oldest events are overwritten and ``dropped_count()`` reports how
many were lost, so a runaway request stream can never exhaust host memory.

``to_chrome_trace()`` exports the buffer in Chrome-trace / Perfetto JSON
(``chrome://tracing``, https://ui.perfetto.dev).  ``enable(torch_bridge=True)``
additionally opens a ``torch.profiler.record_function`` range around every
span, closed on exit (exceptions included), so obs spans appear as ranges in
a ``torch.profiler`` trace around the kernels they launched: the port's
counterpart of the JAX package's ``enable(jax_bridge=True)``.

The PyTorch port keeps its own copy of the tracer, so that ``repro_torch``
imports nothing of the JAX package.  ``torch`` is imported lazily inside
:func:`enable`, only when the bridge is asked for.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional

DEFAULT_CAPACITY = 65536

__all__ = [
    "SpanEvent",
    "DEFAULT_CAPACITY",
    "enable",
    "disable",
    "enabled",
    "clear",
    "events",
    "event_count",
    "dropped_count",
    "span",
    "event",
    "to_chrome_trace",
    "write_chrome_trace",
]


class SpanEvent:
    """One recorded span ("X") or instant ("i") event, Chrome-trace shaped."""

    __slots__ = ("name", "cat", "ph", "ts_us", "dur_us", "tid", "depth", "attrs")

    def __init__(self, name, cat, ph, ts_us, dur_us, tid, depth, attrs):
        self.name = name
        self.cat = cat
        self.ph = ph
        self.ts_us = ts_us
        self.dur_us = dur_us
        self.tid = tid
        self.depth = depth
        self.attrs = attrs

    def __repr__(self):  # pragma: no cover - debugging aid
        return (
            f"SpanEvent({self.name!r}, cat={self.cat!r}, ph={self.ph!r}, "
            f"ts={self.ts_us:.1f}us, dur={self.dur_us:.1f}us, attrs={self.attrs!r})"
        )


class _State:
    __slots__ = ("enabled", "capacity", "buf", "next_i", "dropped", "t0", "bridge", "lock")

    def __init__(self):
        self.enabled = False
        self.capacity = DEFAULT_CAPACITY
        self.buf: List[SpanEvent] = []
        self.next_i = 0
        self.dropped = 0
        self.t0 = 0.0
        self.bridge: Optional[Callable[[str], Any]] = None
        self.lock = threading.Lock()


_state = _State()
_tls = threading.local()


def enabled() -> bool:
    """True when the tracer is currently recording."""
    return _state.enabled


def enable(capacity: int = DEFAULT_CAPACITY, *, torch_bridge: bool = False) -> None:
    """Start recording into a fresh ring buffer of ``capacity`` events.

    ``torch_bridge=True`` wraps every span in a
    ``torch.profiler.record_function`` range so obs spans appear in
    ``torch.profiler`` timelines too.
    """
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    bridge = None
    if torch_bridge:
        from torch.profiler import record_function

        bridge = record_function
    with _state.lock:
        _state.capacity = int(capacity)
        _state.buf = []
        _state.next_i = 0
        _state.dropped = 0
        _state.t0 = time.perf_counter()
        _state.bridge = bridge
        _state.enabled = True


def disable() -> None:
    """Stop recording and drop the bridge.  The buffer stays readable via
    :func:`events`; a span opened under the bridge still closes its range."""
    _state.enabled = False
    _state.bridge = None


def clear() -> None:
    """Drop all recorded events (does not change enabled/disabled)."""
    with _state.lock:
        _state.buf = []
        _state.next_i = 0
        _state.dropped = 0


def events() -> List[SpanEvent]:
    """Recorded events, oldest first (post-overwrite order for full rings)."""
    with _state.lock:
        buf = _state.buf
        if len(buf) < _state.capacity or _state.next_i == 0:
            return list(buf)
        i = _state.next_i
        return buf[i:] + buf[:i]


def event_count() -> int:
    """Number of events currently held in the ring buffer."""
    return len(_state.buf)


def dropped_count() -> int:
    """Events overwritten because the ring buffer was full."""
    return _state.dropped


def _record(ev: SpanEvent) -> None:
    with _state.lock:
        buf = _state.buf
        if len(buf) < _state.capacity:
            buf.append(ev)
        else:
            buf[_state.next_i] = ev
            _state.next_i = (_state.next_i + 1) % _state.capacity
            _state.dropped += 1


def _depth_stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class _NoopSpan:
    """Shared span stand-in returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **attrs):
        return self


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "cat", "attrs", "_t0", "_depth", "_ann")

    def __init__(self, name: str, cat: str, attrs: Dict[str, Any]):
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self._t0 = 0.0
        self._depth = 0
        self._ann = None

    def set(self, **attrs):
        """Attach attributes discovered mid-span (e.g. sampled hit rates)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        stack = _depth_stack()
        self._depth = len(stack)
        stack.append(self.name)
        bridge = _state.bridge
        if bridge is not None:
            self._ann = bridge(self.name)
            self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc, tb)
        stack = _depth_stack()
        if stack:
            stack.pop()
        if _state.enabled:  # may have been disabled mid-span
            _record(
                SpanEvent(
                    self.name,
                    self.cat,
                    "X",
                    (self._t0 - _state.t0) * 1e6,
                    (t1 - self._t0) * 1e6,
                    threading.get_ident(),
                    self._depth,
                    self.attrs,
                )
            )
        return False


def span(name: str, cat: str = "span", **attrs):
    """Context manager recording a timed span.  One-branch no-op if disabled."""
    if not _state.enabled:
        return _NOOP
    return _Span(name, cat, attrs)


def event(name: str, cat: str = "event", **attrs) -> None:
    """Record an instant event (zero duration).  No-op if disabled."""
    if not _state.enabled:
        return
    _record(
        SpanEvent(
            name,
            cat,
            "i",
            (time.perf_counter() - _state.t0) * 1e6,
            0.0,
            threading.get_ident(),
            len(_depth_stack()),
            attrs,
        )
    )


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    # numpy scalars, 0-dim tensors, enums, ... -- anything with item()/name
    item = getattr(v, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass
    return str(v)


def to_chrome_trace(evts: Optional[List[SpanEvent]] = None, *, process_name: str = "repro_torch") -> dict:
    """Export events as a Chrome-trace / Perfetto ``traceEvents`` dict."""
    if evts is None:
        evts = events()
    trace_events = [
        {
            "ph": "M",
            "pid": 0,
            "tid": 0,
            "name": "process_name",
            "args": {"name": process_name},
        }
    ]
    for e in evts:
        rec = {
            "name": e.name,
            "cat": e.cat,
            "ph": e.ph,
            "ts": round(e.ts_us, 3),
            "pid": 0,
            "tid": e.tid,
            "args": {k: _jsonable(v) for k, v in e.attrs.items()},
        }
        if e.ph == "X":
            rec["dur"] = round(e.dur_us, 3)
        else:
            rec["s"] = "t"  # instant scope: thread
        rec["args"]["depth"] = e.depth
        trace_events.append(rec)
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, evts: Optional[List[SpanEvent]] = None, *, process_name: str = "repro_torch") -> str:
    """Write :func:`to_chrome_trace` JSON to ``path`` and return the path."""
    with open(path, "w") as f:
        json.dump(to_chrome_trace(evts, process_name=process_name), f)
    return path
