"""chunk_upload_s: the tile-pair list cut into padded chunks and moved to the
card on the warm join (``snapshot.chunks``, once per chunk size), s."""


def read(ctx):
    d = [e.dur_us for e in ctx.setup_spans if e.name == "snapshot.chunks"]
    return sum(d) / 1e6 if d else None
