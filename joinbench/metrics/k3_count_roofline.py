"""k3_count_roofline: the dense count joins' least time over the device
time of K3's fused count step (``dense_kernel`` MODE 1, epilogue (b) of
``dense_tile_fused.cu``), %."""
from joinbench import readers

KERNELS = {("dense_kernel", 1): ("dense_tile.dense_count_scatter", 1.0)}


def read(ctx):
    return readers.roofline_pct(ctx, mode="count", tier="dense",
                                kernels=[(k, c, s) for k, (c, s) in KERNELS.items()])
