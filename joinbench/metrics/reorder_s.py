"""reorder_s: the index build's REORDER phase in set-up (``snapshot.reorder``:
``variance_reorder`` and ``apply_reorder``), s."""


def read(ctx):
    d = [e.dur_us for e in ctx.setup_spans if e.name == "snapshot.reorder"]
    return sum(d) / 1e6 if d else None
