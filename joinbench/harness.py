"""One run of one cell: set-up, then the measured window or the traced
joins, then the check.

Set-up makes the points from the seed, builds the program's engine
(``SelfJoinEngine``: REORDER, the grid and the tile plan on the host, the
tables on the card) and runs one warm join at the top of the traffic's
radius range, which loads the kernels, moves the chunk lists to the card
and sizes the allocator's blocks for the largest answer.

``--trace 0``: whole cycles of the traffic's radii (``generator``), one
join after another, until ``--seconds`` have passed since the first began;
the window runs from the first join's start to the last one's end.  ``--trace 1``: ``trace_joins`` joins (a number of
the traffic file) under ``torch.profiler`` with the program's spans on.

Each join ends when its answer is on the host.  Every answer is kept and
checked once the window has closed, the peak memory read and the engine
freed (``check``).
"""
from __future__ import annotations

import dataclasses
import gc
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from joinbench import check, datagen, devtrace, generator, spec
from repro_torch import obs
from repro_torch.core.engine import SelfJoinEngine
from repro_torch.core.types import EngineConfig, SelfJoinConfig
from repro_torch.kernels import dense_tile, distance_tile

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SPAN_CAPACITY = 1 << 20   # above a few joins' chunk spans (a Syn16D2M count join has 69,345)
COUNTERS = {"distance_tile": distance_tile.LAUNCHES, "dense_tile": dense_tile.LAUNCHES}


@dataclass
class Join:
    eps: float
    start: float                   # perf_counter
    end: float
    counts: np.ndarray
    pairs: Optional[np.ndarray]
    stats: dict                    # the join's SelfJoinStats


@dataclass
class Context:
    """What a metric reader reads."""

    cell: spec.Cell
    joins: List[Join]              # the window's joins, or the traced session's
    window_s: float
    setup_s: Optional[float] = None
    setup_spans: list = field(default_factory=list)   # obs spans of the set-up (trace 1)
    spans: list = field(default_factory=list)         # obs spans of the traced session
    trace: Optional[devtrace.DeviceTrace] = None
    launches: Dict[str, int] = field(default_factory=dict)  # counter increase over the traced session


def forbidden_modules() -> List[str]:
    """Top-level names of JAX or of the JAX package loaded in this process."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def launch_counts() -> Dict[str, int]:
    return {f"{mod}.{k}": v for mod, d in COUNTERS.items() for k, v in d.items()}


def card_info() -> dict:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout
        return {"nvidia_smi": out.strip().splitlines()[0]}
    except (OSError, subprocess.SubprocessError) as e:
        return {"nvidia_smi": f"unread: {e}"}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _join(call: Callable, eps: float, mode: str) -> Join:
    with obs.span(devtrace.JOIN_RANGE, "bench", eps=eps):
        start = time.perf_counter()
        res = call(eps)
        end = time.perf_counter()
    return Join(eps, start, end, res.counts, res.pairs if mode == "pairs" else None,
                dataclasses.asdict(res.stats))


def _describe(j: Join) -> str:
    s = j.stats
    return (f"join eps={j.eps:.6f} {j.end - j.start:.6f} s results={s['num_results']} "
            f"tile_pairs={s['num_tile_pairs_evaluated']} chunks={s['num_chunks']} tier={s['execution']} "
            f"retries={s['overflow_retries']} capacity={s['pairs_capacity']}")


def _spans(events) -> list:
    return [e for e in events if e.ph == "X"]


def run(root: Path, workload: str, *, seed: int, seconds: float, trace: bool, device="cuda",
        t0: Optional[float] = None, log: Callable[[str], None] = print, here: Path = spec.HERE):
    """One run of ``workload``; returns (the result line's object, the
    check's numbers)."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = spec.load_cell(root, workload, here=here)
    cfg, trf, mode = cell.config, cell.traffic, cell.mode
    sj = SelfJoinConfig(**cfg["self_join"])
    top = generator.index_eps(trf)
    if top > sj.eps:
        raise ValueError(f"the traffic's radii reach {top}, above the index's {sj.eps}: every join would rebuild it")
    t = time.perf_counter()
    points = datagen.make_points(cfg, seed)
    eps_iter = generator.eps_sequence(trf, seed)
    cycle = len(generator.radii(trf))
    log(f"set-up: points made in {time.perf_counter() - t:.3f} s, {t - t0:.3f} s after start")
    if trace:
        obs.enable(SPAN_CAPACITY)
    t = time.perf_counter()
    engine = SelfJoinEngine(points, sj, EngineConfig(**cfg.get("engine", {})), device=device)
    log(f"set-up: engine built in {time.perf_counter() - t:.3f} s")
    call = engine.count if mode == "count" else engine.pairs
    warm = _join(call, top, mode)
    _sync(device)
    log(f"set-up: warm-up {_describe(warm)}")
    del warm

    ctx = Context(cell=cell, joins=[], window_s=0.0)
    checked: List[Join] = []
    if not trace:
        ctx.setup_s = time.perf_counter() - t0
        while len(checked) % cycle or not checked or checked[-1].end - checked[0].start < seconds:
            checked.append(_join(call, next(eps_iter), mode))
        ctx.joins = checked
        ctx.window_s = checked[-1].end - checked[0].start
    else:
        ctx.setup_spans = _spans(obs.events())
        log(f"spans: {obs.event_count()} held after set-up, {obs.dropped_count()} dropped")
        from torch.profiler import record_function

        sessions = []

        def run_joins():
            obs.clear()
            before = launch_counts()
            batch = []
            for _ in range(int(trf["trace_joins"])):
                with record_function(devtrace.JOIN_RANGE):
                    batch.append(_join(call, next(eps_iter), mode))
            after = launch_counts()
            sessions.append((batch, {k: after[k] - before[k] for k in after if after[k] != before[k]},
                             obs.dropped_count()))

        def host_spans():
            evs = _spans(obs.events())
            return ([(e.name, e.ts_us / 1e6, (e.ts_us + e.dur_us) / 1e6, e.depth) for e in evs],
                    [e.ts_us / 1e6 for e in evs if e.name == devtrace.JOIN_RANGE])

        needed = set()
        for m in cell.per_layer:
            needed |= set(getattr(spec.load_reader(m["name"], here), "KERNELS", {}))
        t = time.perf_counter()
        ctx.trace = devtrace.profile_joins(run_joins, host_spans, needed, log)
        log(f"traced and read in {time.perf_counter() - t:.3f} s")
        ctx.spans = _spans(obs.events())
        batch, ctx.launches, dropped = sessions[-1]
        obs.disable()
        log(f"spans: {len(ctx.spans)} in the traced session, {dropped} dropped; launches {ctx.launches}")
        ctx.joins = batch
        ctx.window_s = ctx.trace.window_s
        checked = [j for b, _, _ in sessions for j in b]
    for j in checked:
        log(_describe(j))

    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    del engine, call
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check.check_joins(points, checked, mode=mode, check_rows=int(trf["check_rows"]), seed=seed,
                                device=device)
    log(f"checked {len(checked)} joins in {time.perf_counter() - t_check:.3f} s")

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.load_reader(m["name"], here).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": check.passed(numbers), "attempted": len(checked), "failed": 0, "metrics": metrics,
              "device": dev}
    if trace:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
        result["breakdown"] = ctx.trace.breakdown()
    result["workload"], result["seed"] = workload, seed
    if on_card:
        result["card"] = card_info()
    result["checks"] = check.limits(numbers)
    return result, numbers
