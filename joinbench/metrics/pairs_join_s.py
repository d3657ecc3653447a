"""pairs_join_s: the window's wall time over the pairs joins completed in it."""
from joinbench import readers


def read(ctx):
    return readers.join_seconds(ctx, "pairs")
