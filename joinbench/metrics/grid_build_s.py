"""grid_build_s: the index build's grid in set-up (``snapshot.grid``:
``build_grid``), s."""


def read(ctx):
    d = [e.dur_us for e in ctx.setup_spans if e.name == "snapshot.grid"]
    return sum(d) / 1e6 if d else None
