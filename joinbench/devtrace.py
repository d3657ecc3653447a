"""What the card did during the traced joins, from ``torch.profiler``.

``profile_joins`` runs whole joins under one profiler session (CPU and
CUDA activity), each inside a ``joinbench.join`` range, and reads back:

- the device intervals: kernels, copies and fills, merged into the time in
  which something ran on the card (``busy_s``) inside the traced window,
  from the first join's start to the last one's end (``window_s``);
- per kernel, keyed by its family and template ``MODE`` parsed from the
  full device name (``dense_kernel<MT, MODE, KD>``: 0 per pair, 1 the
  count step, 2 and 3 the pairs step's two passes), the records kept and
  their device time; the port's launch counters say how many there were;
- the idle gaps, each named by the innermost ``obs`` span open on the host
  at its midpoint.  The program's spans run on ``time.perf_counter``; they
  are placed on the profiler's clock by the ``joinbench.join`` span that
  opens with each range.

CUPTI on the card has kept fewer records than launches in some sessions,
and none at all in a few.  A session that keeps no record of a kernel some
metric reads is run again, up to ``PROFILER_TRIES`` sessions, and then
fails: no number is ever made up where the card gave none.
"""
from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

PROFILER_TRIES = 3
JOIN_RANGE = "joinbench.join"
KERNEL_NAME = re.compile(r"(\w+)<\s*(\d+)\s*,\s*(\d+)\s*,\s*(\d+)\s*>")


def kernel_key(name: str) -> Optional[Tuple[str, int]]:
    """(family, MODE) of a templated tile kernel's device name, else None."""
    m = KERNEL_NAME.search(name)
    return (m.group(1), int(m.group(3))) if m else None


def short_name(name: str) -> str:
    m = KERNEL_NAME.search(name)
    if m:
        return m.group(0).replace(" ", "")
    return name[:64]


def merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Union of intervals, sorted and disjoint."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals: Sequence[Tuple[float, float]], w0: float, w1: float) -> List[Tuple[float, float]]:
    return [(max(s, w0), min(e, w1)) for s, e in intervals if e > w0 and s < w1]


def gaps(busy: Sequence[Tuple[float, float]], w0: float, w1: float) -> List[Tuple[float, float]]:
    """The parts of [w0, w1] that ``busy`` (merged, clipped) leaves free."""
    out, t = [], w0
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if w1 > t:
        out.append((t, w1))
    return out


class SpanIndex:
    """Innermost span containing a time: spans (name, start, end, depth)
    on one thread, where spans of one depth never overlap."""

    def __init__(self, spans: Iterable[Tuple[str, float, float, int]]):
        by_depth: Dict[int, List[Tuple[float, float, str]]] = {}
        for name, s, e, depth in spans:
            by_depth.setdefault(depth, []).append((s, e, name))
        self._levels = []
        for depth in sorted(by_depth, reverse=True):
            rows = sorted(by_depth[depth])
            self._levels.append(([r[0] for r in rows], rows))

    def at(self, t: float) -> Optional[str]:
        for starts, rows in self._levels:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and rows[i][0] <= t <= rows[i][1]:
                return rows[i][2]
        return None


@dataclass
class DeviceTrace:
    """One profiler session's reading, in seconds on the profiler's clock."""

    window: Tuple[float, float]
    busy_s: float
    kernels: Dict[Tuple[str, int], List[float]]   # (family, MODE) -> kept records' durations, s
    ops: Dict[str, float]                         # device op (short name) -> total s kept
    records: int                                  # device records kept in the window
    idle_by_span: Dict[str, float] = field(default_factory=dict)
    join_ranges: List[Tuple[float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernel_mean_s(self, key: Tuple[str, int]) -> Optional[float]:
        d = self.kernels.get(key)
        return sum(d) / len(d) if d else None

    def breakdown(self) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in idle]}


def read_events(events, host_spans: Sequence[Tuple[str, float, float, int]],
                join_span_starts: Sequence[float]) -> DeviceTrace:
    """A ``DeviceTrace`` from profiler events (``FunctionEvent``-like: name,
    device_type, time_range in us) and the program's spans on the host
    (name, start s, end s, depth, on ``perf_counter``), of which
    ``join_span_starts`` are the ``joinbench.join`` spans' starts."""
    from torch.autograd import DeviceType

    host_names, ranges, device = set(), [], []
    for e in events:
        s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == DeviceType.CPU:
            host_names.add(e.name)
            if e.name == JOIN_RANGE:
                ranges.append((s, t))
        elif e.device_type == DeviceType.CUDA:
            device.append((e.name, s, t))
    # a record_function range is mirrored on the device timeline as an
    # annotation spanning its kernels: not device work
    device = [d for d in device if d[0] not in host_names]
    if not ranges:
        raise RuntimeError("the profiler kept no joinbench.join range")
    ranges.sort()
    w0, w1 = ranges[0][0], ranges[-1][1]
    inside = [(n, s, t) for n, s, t in device if t > w0 and s < w1]
    busy = clip(merge((s, t) for _, s, t in inside), w0, w1)
    kernels: Dict[Tuple[str, int], List[float]] = {}
    ops: Dict[str, float] = {}
    for n, s, t in inside:
        key = kernel_key(n)
        if key is not None:
            kernels.setdefault(key, []).append(t - s)
        ops[short_name(n)] = ops.get(short_name(n), 0.0) + (t - s)
    idle: Dict[str, float] = {}
    if host_spans and join_span_starts:
        starts = sorted(join_span_starts)[: len(ranges)]
        offset = sum(r[0] - s for r, s in zip(ranges, starts)) / len(starts)
        index = SpanIndex((n, s + offset, t + offset, d) for n, s, t, d in host_spans)
        for g0, g1 in gaps(busy, w0, w1):
            name = index.at((g0 + g1) / 2) or "(no span)"
            idle[name] = idle.get(name, 0.0) + (g1 - g0)
    return DeviceTrace(window=(w0, w1), busy_s=sum(t - s for s, t in busy), kernels=kernels, ops=ops,
                       records=len(inside), idle_by_span=idle, join_ranges=ranges)


def profile_joins(run_joins: Callable[[], None], host_spans: Callable[[], tuple],
                  needed: Iterable[Tuple[str, int]], log: Callable[[str], None]) -> DeviceTrace:
    """Profile ``run_joins`` (which opens a ``joinbench.join`` range around
    each join) until a session keeps a record of every ``needed`` kernel.

    ``host_spans()`` returns the program's spans of the session and the
    starts of its ``joinbench.join`` spans (called after each session).
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    needed = set(needed)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)  # CUPTI's own start-up, outside the traced session
        torch.cuda.synchronize()
    for attempt in range(1, PROFILER_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run_joins()
            torch.cuda.synchronize()
        spans, join_starts = host_spans()
        trace = read_events(prof.events(), spans, join_starts)
        missing = sorted(k for k in needed if not trace.kernels.get(k))
        log(f"profiler session {attempt}: {trace.records} device records in {trace.window_s:.6f} s; "
            f"kernel records kept {dict((f'{k[0]}<MODE {k[1]}>', len(v)) for k, v in trace.kernels.items())}"
            + (f"; none of {missing}" if missing else ""))
        if not missing:
            return trace
    raise RuntimeError(f"torch.profiler kept no record of {sorted(needed)} in {PROFILER_TRIES} sessions")
