"""Arithmetic shared by the metric readers in ``metrics/``.

A reader returns ``None`` where its run has nothing for it to read (another
mode or tier, no trace), and the harness then leaves its metric out.
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

from joinbench import workcount


def join_seconds(ctx, mode: str) -> Optional[float]:
    """The window's wall time over the joins completed in it."""
    if ctx.cell.mode != mode or not ctx.joins:
        return None
    return ctx.window_s / len(ctx.joins)


def idle_pct(ctx, mode: str) -> Optional[float]:
    """Share of the traced window in which nothing ran on the card, %."""
    if ctx.trace is None or ctx.cell.mode != mode or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def roofline_pct(ctx, *, mode: str, tier: str, kernels: Iterable[Tuple[Tuple[str, int], str, float]]) -> Optional[float]:
    """The traced joins' least time (``workcount``) over the device time of
    the kernels that did their work, %.

    ``kernels``: ((family, MODE), launch counter, launches of this kernel per
    counter step).  A kernel's device time is the mean over the records the
    profiler kept times its launches by the port's counter.
    """
    if ctx.trace is None or ctx.cell.mode != mode:
        return None
    joins = [j for j in ctx.joins if j.stats["execution"] == tier]
    if not joins or len(joins) != len(ctx.joins):
        return None
    sj = ctx.cell.config["self_join"]
    least = 0.0
    for j in joins:
        flop, nbytes = workcount.stats_work(j.stats, tile_size=sj["tile_size"], dim_block=sj["dim_block"], mode=mode)
        least += workcount.least_time(flop, nbytes)[0]
    device = 0.0
    for key, counter, per_step in kernels:
        per_launch = ctx.trace.kernel_mean_s(key)
        launches = ctx.launches.get(counter, 0) * per_step
        if per_launch is None or launches <= 0:
            return None
        device += per_launch * launches
    return 100.0 * least / device

