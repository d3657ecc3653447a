"""device_idle_pct.count: share of the traced count joins' wall time in
which no kernel, copy or fill ran on the card, %."""
from joinbench import readers


def read(ctx):
    return readers.idle_pct(ctx, "count")
