"""count_join_s: the window's wall time over the count joins completed in it."""
from joinbench import readers


def read(ctx):
    return readers.join_seconds(ctx, "count")
