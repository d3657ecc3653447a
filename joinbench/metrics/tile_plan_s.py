"""tile_plan_s: the index build's tile-pair plan in set-up
(``snapshot.tile_plan``: ``build_tile_plan``), s."""


def read(ctx):
    d = [e.dur_us for e in ctx.setup_spans if e.name == "snapshot.tile_plan"]
    return sum(d) / 1e6 if d else None
