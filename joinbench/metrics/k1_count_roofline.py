"""k1_count_roofline: the indexed count joins' least time over the device
time of K1's fused count step (``k1_kernel`` MODE 1, epilogue (b) of
``distance_tile_counts.cu``), %."""
from joinbench import readers

KERNELS = {("k1_kernel", 1): ("distance_tile.tile_pair_count_scatter", 1.0)}


def read(ctx):
    return readers.roofline_pct(ctx, mode="count", tier="indexed",
                                kernels=[(k, c, s) for k, (c, s) in KERNELS.items()])
