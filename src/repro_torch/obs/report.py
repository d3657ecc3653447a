"""Per-phase / per-worker breakdown of a Chrome-trace dump.

A copy of the JAX package's ``repro.obs.report``: each package's loader
reads the other's traces to the same report.

``python -m repro_torch.obs.report TRACE.json`` prints an aggregate table grouped
by span category and name, plus per-worker and per-round breakdowns when
the spans carry ``worker`` / ``round`` attributes (the ring tier does).
``--json`` emits the same report as JSON for machine consumption; a
malformed trace exits non-zero.

The loader accepts both the object form ``{"traceEvents": [...]}`` and the
bare-array form of the Chrome trace format, and validates each event enough
to catch truncated or hand-mangled dumps.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

__all__ = ["TraceFormatError", "load_trace", "build_report", "format_report", "main"]


class TraceFormatError(ValueError):
    """Raised when a trace file is not a well-formed Chrome trace."""


def load_trace(path: str) -> List[dict]:
    """Load + validate a Chrome-trace JSON file, returning its events."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise TraceFormatError(f"{path}: cannot parse trace: {e}") from e
    if isinstance(doc, dict):
        events = doc.get("traceEvents")
        if not isinstance(events, list):
            raise TraceFormatError(f"{path}: missing 'traceEvents' array")
    elif isinstance(doc, list):
        events = doc
    else:
        raise TraceFormatError(f"{path}: top level must be an object or array")
    for i, e in enumerate(events):
        _validate_event(path, i, e)
    return events


def _validate_event(path: str, i: int, e: object) -> None:
    if not isinstance(e, dict):
        raise TraceFormatError(f"{path}: event {i} is not an object")
    ph = e.get("ph")
    if not isinstance(ph, str) or not ph:
        raise TraceFormatError(f"{path}: event {i} has no phase ('ph')")
    if ph == "M":
        return  # metadata events carry only name/args
    if not isinstance(e.get("name"), str):
        raise TraceFormatError(f"{path}: event {i} has no name")
    ts = e.get("ts")
    if not isinstance(ts, (int, float)):
        raise TraceFormatError(f"{path}: event {i} has non-numeric ts: {ts!r}")
    if ph == "X":
        dur = e.get("dur")
        if not isinstance(dur, (int, float)) or dur < 0:
            raise TraceFormatError(f"{path}: event {i} has bad dur: {dur!r}")
    args = e.get("args")
    if args is not None and not isinstance(args, dict):
        raise TraceFormatError(f"{path}: event {i} has non-object args")


class _Agg:
    __slots__ = ("count", "total_us", "max_us")

    def __init__(self):
        self.count = 0
        self.total_us = 0.0
        self.max_us = 0.0

    def add(self, dur_us: float) -> None:
        self.count += 1
        self.total_us += dur_us
        self.max_us = max(self.max_us, dur_us)

    def to_json(self) -> dict:
        return {
            "count": self.count,
            "total_us": round(self.total_us, 3),
            "mean_us": round(self.total_us / self.count, 3) if self.count else 0.0,
            "max_us": round(self.max_us, 3),
        }


def build_report(events: List[dict]) -> dict:
    """Aggregate events per (category, name), per worker, and per round."""
    phases: Dict[str, Dict[str, _Agg]] = {}
    workers: Dict[str, _Agg] = {}
    rounds: Dict[str, _Agg] = {}
    n_spans = n_instants = 0
    t_min = float("inf")
    t_max = float("-inf")
    for e in events:
        ph = e.get("ph")
        if ph not in ("X", "i"):
            continue
        dur = float(e.get("dur", 0.0))
        ts = float(e["ts"])
        t_min = min(t_min, ts)
        t_max = max(t_max, ts + dur)
        if ph == "X":
            n_spans += 1
        else:
            n_instants += 1
        cat = e.get("cat", "span")
        phases.setdefault(cat, {}).setdefault(e["name"], _Agg()).add(dur)
        args = e.get("args") or {}
        if "worker" in args:
            workers.setdefault(str(args["worker"]), _Agg()).add(dur)
        if "round" in args:
            rounds.setdefault(str(args["round"]), _Agg()).add(dur)
    return {
        "num_spans": n_spans,
        "num_instants": n_instants,
        "wall_us": round(t_max - t_min, 3) if n_spans + n_instants else 0.0,
        "phases": {
            cat: {name: agg.to_json() for name, agg in sorted(names.items())}
            for cat, names in sorted(phases.items())
        },
        "workers": {w: a.to_json() for w, a in sorted(workers.items())},
        "rounds": {r: a.to_json() for r, a in sorted(rounds.items())},
    }


def _table(rows: List[tuple], header: tuple) -> List[str]:
    widths = [max(len(str(r[i])) for r in [header] + rows) for i in range(len(header))]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    out = [fmt.format(*header), fmt.format(*("-" * w for w in widths))]
    out.extend(fmt.format(*map(str, r)) for r in rows)
    return out


def format_report(rep: dict) -> str:
    lines = [
        f"events: {rep['num_spans']} spans + {rep['num_instants']} instants, "
        f"wall {rep['wall_us'] / 1e3:.3f} ms"
    ]
    rows = []
    for cat, names in rep["phases"].items():
        for name, a in names.items():
            rows.append(
                (cat, name, a["count"], f"{a['total_us'] / 1e3:.3f}",
                 f"{a['mean_us'] / 1e3:.3f}", f"{a['max_us'] / 1e3:.3f}")
            )
    rows.sort(key=lambda r: -float(r[3]))
    lines.append("")
    lines.extend(_table(rows, ("cat", "span", "count", "total_ms", "mean_ms", "max_ms")))
    for title, sec in (("worker", rep["workers"]), ("round", rep["rounds"])):
        if not sec:
            continue
        lines.append("")
        sub = [
            (k, a["count"], f"{a['total_us'] / 1e3:.3f}", f"{a['mean_us'] / 1e3:.3f}")
            for k, a in sec.items()
        ]
        lines.extend(_table(sub, (title, "count", "total_ms", "mean_ms")))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Per-phase/per-worker breakdown of a repro_torch Chrome-trace dump.",
    )
    ap.add_argument("trace", help="Chrome-trace JSON file written by repro_torch.obs")
    ap.add_argument("--json", action="store_true", help="emit the report as JSON")
    args = ap.parse_args(argv)
    try:
        events = load_trace(args.trace)
    except TraceFormatError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    rep = build_report(events)
    if args.json:
        json.dump(rep, sys.stdout, indent=2, sort_keys=True)
        print()
    else:
        print(format_report(rep))
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    sys.exit(main())
