"""launch_idle_pct.count: share of the traced count joins' window in which
the card idled while the host was in the chunk loop (the gaps whose middle
falls in an ``engine.count.chunk`` span, one a launch), %."""

SPAN = "engine.count.chunk"


def read(ctx):
    if ctx.trace is None or ctx.cell.mode != "count" or ctx.trace.window_s <= 0:
        return None
    if not any(e.name == SPAN for e in ctx.spans):
        return None
    return 100.0 * ctx.trace.idle_by_span.get(SPAN, 0.0) / ctx.trace.window_s
