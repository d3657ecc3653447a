"""Work of a join as the kernels were handed it, and the least time it needs.

A frozen copy of the arithmetic of the port's smoke run (``bound()``),
summed over a whole join from what the join reported of its own work
(``SelfJoinStats``): the tile pairs evaluated, the dimension blocks in
them and those SHORTC skipped.  Only the real dimensions count, not the
padding up to ``n_pad``, and of those only the blocks that were computed.

Operations per tile pair, per computed dimension: 2 T^2 for the products
and 4 T for the norms; per computed block 4 T^2 for the fold.  Bytes: each
referenced tile's real dimensions and its length read once, the pair list
read once, the output written once (the count vector, or the result pairs).
A pairs step's second pass recomputes what the first did; the work counts
one evaluation, so the share reads what a redesign could still gain.

The per-pair dimension counts are not reported, only the totals, so the
dimensions of the pairs whose last block is partial are taken at the most
the totals allow: the operations are a lower bound, exact where every pair
computes the same blocks (no SHORTC skip, or a single block), and a share
built on them cannot read above the true one.
"""
from __future__ import annotations

from typing import Tuple

PEAK_FP32_FLOPS = 67e12   # NVIDIA H100 SXM, fp32 on the CUDA cores (the kernels use no TF32)
PEAK_HBM_BYTES = 3.35e12  # NVIDIA H100 SXM, HBM3


def computed_dims(pairs: int, blocks_computed: int, num_dims: int, n_pad: int, dim_block: int) -> int:
    """Sum over the tile pairs of the real dimensions their computed blocks
    hold (a lower bound where the totals leave it open; see above)."""
    nb = n_pad // dim_block
    if pairs == 0:
        return 0
    if nb == 1:
        return pairs * num_dims
    # every pair computes its first block; a pair that computed all nb blocks
    # computed nb - 1 more, so at most (blocks - pairs) // (nb - 1) of them did
    full = min(pairs, (blocks_computed - pairs) // (nb - 1))
    return blocks_computed * dim_block - full * (n_pad - num_dims)


def join_work(*, pairs: int, tiles: int, blocks_total: int, blocks_skipped: int, num_dims: int, n_pad: int,
              dim_block: int, tile_size: int, out_bytes: int) -> Tuple[int, int]:
    """(operations, bytes) of one join's kernel work."""
    t = tile_size
    blocks = blocks_total - blocks_skipped
    dims = computed_dims(pairs, blocks, num_dims, n_pad, dim_block)
    flop = (2 * t * t + 4 * t) * dims + 4 * t * t * blocks
    nbytes = tiles * t * num_dims * 4 + tiles * 4 + pairs * 8 + out_bytes
    return flop, nbytes


def least_time(flop: int, nbytes: int) -> Tuple[float, str]:
    """(seconds, "operations" | "bytes"): max of the two bounds, and which."""
    by_ops = flop / PEAK_FP32_FLOPS
    by_bytes = nbytes / PEAK_HBM_BYTES
    return max(by_ops, by_bytes), ("bytes" if by_bytes > by_ops else "operations")


def stats_work(stats: dict, *, tile_size: int, dim_block: int, mode: str) -> Tuple[int, int]:
    """``join_work`` of one join from its ``SelfJoinStats`` (as a dict).

    The dense tier's plan is the full cross product of ``ceil(N / T)``
    sequential tiles; the indexed tier's pairs every tile with itself, so
    every one of ``num_tiles`` is referenced.  Output: the count vector
    (``N + 1`` int32 and the skipped total) in count mode, the result pairs
    (two int32 each) in pairs mode.
    """
    n = int(stats["num_dims"])
    n_pad = -(-n // dim_block) * dim_block
    npts = int(stats["num_points"])
    if stats["execution"] == "dense":
        tiles = -(-npts // tile_size)
    else:
        tiles = int(stats["num_tiles"])
    out = (npts + 2) * 4 if mode == "count" else int(stats["num_results"]) * 8
    return join_work(pairs=int(stats["num_tile_pairs_evaluated"]), tiles=tiles,
                     blocks_total=int(stats["dim_blocks_total"]), blocks_skipped=int(stats["dim_blocks_skipped"]),
                     num_dims=n, n_pad=n_pad, dim_block=dim_block, tile_size=tile_size, out_bytes=out)
