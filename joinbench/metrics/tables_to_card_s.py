"""tables_to_card_s: the index's tables placed on the card in set-up: the
indexed tier's (``snapshot.tables``, in the build) and the dense tier's,
made on its first join (``snapshot.dense_tables``), s."""

SPANS = ("snapshot.tables", "snapshot.dense_tables")


def read(ctx):
    d = [e.dur_us for e in ctx.setup_spans if e.name in SPANS]
    return sum(d) / 1e6 if d else None
