"""Zero-overhead-when-disabled span tracer (DESIGN.md #11).

Spans are context managers recording wall times, nesting depth, and typed
attributes into a bounded ring buffer.  The module is off by default:
``span()``/``event()`` check one module attribute and return a shared no-op
object / return immediately, so instrumented hot paths cost a dict lookup
and a branch when tracing is disabled.

Times are read on the Unix clock (``time.time_ns``, CLOCK_REALTIME), the
clock ``torch.profiler`` converts its events to.  ``SpanEvent.ts_us`` counts
microseconds from ``enable()``, whose Unix time is :func:`epoch_ns`, so a
span's absolute start is ``epoch_ns() / 1e3 + ts_us`` microseconds.

When enabled, events accumulate in a ring buffer of fixed capacity; once
full the oldest events are overwritten and ``dropped_count()`` reports how
many were lost, so a runaway request stream can never exhaust host memory.

A chunk loop (:func:`chunk_loop`) reads the switch once per loop.  Off, it
is a plain loop.  On, it reads the clock once per chunk boundary into a
preallocated list and hands the list over as one record
(:func:`span_series`), which :func:`events` expands into one contiguous
span per chunk and which counts as its chunks toward the capacity.

``to_chrome_trace()`` exports the buffer in Chrome-trace / Perfetto JSON
(``chrome://tracing``, https://ui.perfetto.dev) with absolute Unix
microseconds as ``ts``, so it overlays a ``torch.profiler`` trace with no
offset.  ``enable(torch_bridge=True)`` additionally opens a
``torch.profiler.record_function`` range around every span, closed on exit
(exceptions included), so obs spans appear as ranges in a
``torch.profiler`` trace around the kernels they launched: the port's
counterpart of the JAX package's ``enable(jax_bridge=True)``.  A chunk loop
under the bridge opens a span per chunk, since ranges cannot be batched.

The PyTorch port keeps its own copy of the tracer, so that ``repro_torch``
imports nothing of the JAX package.  ``torch`` is imported lazily inside
:func:`enable`, only when the bridge is asked for.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

DEFAULT_CAPACITY = 1 << 18  # above one uncut Syn16D2M count join's 170,192 chunk spans

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
    "epoch_ns",
    "span",
    "event",
    "span_series",
    "chunk_loop",
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


class _Series:
    """Contiguous spans of one name, ``times[i]`` to ``times[i + 1]`` (Unix
    ns), recorded as one ring entry; ``first`` skips the overwritten ones."""

    __slots__ = ("name", "cat", "times", "first", "tid", "depth", "t0_ns")

    def __init__(self, name, cat, times, tid, depth, t0_ns):
        self.name = name
        self.cat = cat
        self.times = times
        self.first = 0
        self.tid = tid
        self.depth = depth
        self.t0_ns = t0_ns

    def __len__(self):
        return len(self.times) - 1 - self.first

    def expand(self) -> List[SpanEvent]:
        t, t0 = self.times, self.t0_ns
        return [
            SpanEvent(self.name, self.cat, "X", (t[i] - t0) / 1e3, (t[i + 1] - t[i]) / 1e3,
                      self.tid, self.depth, {})
            for i in range(self.first, len(t) - 1)
        ]


class _State:
    __slots__ = ("enabled", "capacity", "buf", "held", "dropped", "t0_ns", "bridge", "lock")

    def __init__(self):
        self.enabled = False
        self.capacity = DEFAULT_CAPACITY
        self.buf: collections.deque = collections.deque()  # SpanEvent | _Series, oldest first
        self.held = 0  # events in buf, a series counting as its spans
        self.dropped = 0
        self.t0_ns = 0
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
        _state.buf = collections.deque()
        _state.held = 0
        _state.dropped = 0
        _state.t0_ns = time.time_ns()
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
        _state.buf = collections.deque()
        _state.held = 0
        _state.dropped = 0


def events() -> List[SpanEvent]:
    """Recorded events, oldest first, each span series expanded."""
    with _state.lock:
        recs = list(_state.buf)
    out: List[SpanEvent] = []
    for r in recs:
        if type(r) is _Series:
            out.extend(r.expand())
        else:
            out.append(r)
    return out


def event_count() -> int:
    """Number of events currently held in the ring buffer."""
    return _state.held


def dropped_count() -> int:
    """Events overwritten because the ring buffer was full."""
    return _state.dropped


def epoch_ns() -> int:
    """Unix time (ns) of the last ``enable()``: the zero of ``ts_us``."""
    return _state.t0_ns


def _record(rec, n: int = 1) -> None:
    """Append ``rec`` (``n`` events), dropping the oldest events over capacity."""
    with _state.lock:
        buf = _state.buf
        buf.append(rec)
        _state.held += n
        excess = _state.held - _state.capacity
        while excess > 0:
            old = buf[0]
            w = len(old) if type(old) is _Series else 1
            if w <= excess:
                buf.popleft()
            else:  # drop the series' oldest spans only
                old.first += excess
                w = excess
            _state.held -= w
            _state.dropped += w
            excess -= w


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
        self._t0 = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.time_ns()
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
                    (self._t0 - _state.t0_ns) / 1e3,
                    (t1 - self._t0) / 1e3,
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
            (time.time_ns() - _state.t0_ns) / 1e3,
            0.0,
            threading.get_ident(),
            len(_depth_stack()),
            attrs,
        )
    )


def span_series(name: str, cat: str, times_ns: Sequence[int]) -> None:
    """Record ``len(times_ns) - 1`` contiguous spans, the i-th from
    ``times_ns[i]`` to ``times_ns[i + 1]`` (``time.time_ns()`` reads), one
    level below the innermost open span.  The list is kept, not copied.
    No-op if disabled."""
    if not _state.enabled or len(times_ns) < 2:
        return
    rec = _Series(name, cat, times_ns, threading.get_ident(), len(_depth_stack()), _state.t0_ns)
    _record(rec, len(rec))


def chunk_loop(name: str, step: Callable, chunks: Sequence[tuple]) -> int:
    """Run ``step(*c)`` for every chunk ``c`` and return ``len(chunks)``.

    Reads the switch once: disabled, a plain loop with no tracer call per
    chunk; under the bridge, a ``dispatch`` span ``name`` per chunk; else
    one clock read per chunk boundary, recorded after the loop as one
    :func:`span_series`.
    """
    if not _state.enabled:
        for c in chunks:
            step(*c)
        return len(chunks)
    if _state.bridge is not None:
        for c in chunks:
            with _Span(name, "dispatch", {}):
                step(*c)
        return len(chunks)
    now = time.time_ns
    times = [0] * (len(chunks) + 1)
    times[0] = now()
    try:
        for i, c in enumerate(chunks, 1):
            step(*c)
            times[i] = now()
    except BaseException:
        span_series(name, "dispatch", times[: times.index(0)])  # the chunks that completed
        raise
    span_series(name, "dispatch", times)
    return len(chunks)


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


def to_chrome_trace(
    evts: Optional[List[SpanEvent]] = None,
    *,
    process_name: str = "repro_torch",
    epoch_ns: Optional[int] = None,
) -> dict:
    """Export events as a Chrome-trace / Perfetto ``traceEvents`` dict.

    ``ts`` is absolute Unix microseconds: ``epoch_ns`` (default the current
    window's :func:`epoch_ns`) plus each event's ``ts_us``.
    """
    if evts is None:
        evts = events()
    epoch_us = (_state.t0_ns if epoch_ns is None else epoch_ns) / 1e3
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
            "ts": round(epoch_us + e.ts_us, 3),
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


def write_chrome_trace(
    path: str,
    evts: Optional[List[SpanEvent]] = None,
    *,
    process_name: str = "repro_torch",
    epoch_ns: Optional[int] = None,
) -> str:
    """Write :func:`to_chrome_trace` JSON to ``path`` and return the path."""
    with open(path, "w") as f:
        json.dump(to_chrome_trace(evts, process_name=process_name, epoch_ns=epoch_ns), f)
    return path
