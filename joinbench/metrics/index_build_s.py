"""index_build_s: the engine's ``engine.snapshot_build`` span in set-up
(REORDER, the grid, the tile plan, the tables placed on the card)."""


def read(ctx):
    spans = [e for e in ctx.setup_spans if e.name == "engine.snapshot_build"]
    return spans[0].dur_us / 1e6 if spans else None
