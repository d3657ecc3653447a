"""GPU-Join (paper Alg. 1) on PyTorch + CUDA: the top-level self-join entry point.

Pipeline (paper lines 1-10, adapted per DESIGN.md #1):

  1. REORDER the dimensions by sampled variance          (Sec. 4.2)
  2. build the grid index over the first k dims          (Secs. 3.2.1, 4.1)
  3. build the candidate tile-pair plan, SORTIDU-pruned  (Sec. 4.3)
  4. estimate the result size, preallocate the pairs
     buffer                                              (Sec. 3.2.2)
  5. evaluate chunks with the tile distance kernels
     (SHORTC dimension-blocked pruning)                  (Sec. 4.4)
  6. scatter per-point counts / compact pairs back to
     the original point order (constructNeighborTable)

``self_join`` is a thin wrapper over ``SelfJoinEngine``, which keeps steps
4-6 on the device.  ``config.execution`` selects the execution tier
(DESIGN.md #9): ``"indexed"``, ``"dense"`` or ``"auto"`` (cost model).  The
original host-loop implementation is kept as ``self_join_hostloop``: the
baseline the engine is measured against, and a second oracle for parity
tests; it is indexed-tier only.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import batching as batching_mod
from repro_torch.core.engine import SelfJoinEngine
from repro_torch.core.grid import build_grid, build_tile_plan
from repro_torch.core.reorder import variance_reorder
from repro_torch.core.snapshot import resolve_device
from repro_torch.core.types import SelfJoinConfig, SelfJoinResult, SelfJoinStats
from repro_torch.kernels import ops


def self_join(
    d: np.ndarray,
    config: SelfJoinConfig,
    return_pairs: bool = False,
    max_pairs: Optional[int] = None,
    *,
    device="cuda",
) -> SelfJoinResult:
    """Find all ordered pairs within config.eps; counts per original point.

    Runs on ``device`` (default ``"cuda"``); without a card this raises
    unless ``device="cpu"`` is given.
    """
    engine = SelfJoinEngine(d, config, device=device)
    if return_pairs:
        return engine.pairs(max_pairs=max_pairs)
    return engine.count()


def self_join_hostloop(
    d: np.ndarray,
    config: SelfJoinConfig,
    return_pairs: bool = False,
    max_pairs: Optional[int] = None,
    *,
    device="cuda",
) -> SelfJoinResult:
    """Pre-engine reference path: host-side tiling loop, ``np.add.at``
    count scatter and ``np.nonzero`` pair extraction between device calls.

    The host builds the grid, the plan and the tile table, which goes to
    ``device`` once; counts mode evaluates every tile pair with K1 per pair
    (``ops.tile_counts``), pairs mode the masks of each batch with K2 per
    pair (``ops.tile_mask``).  Runs on ``device`` (default ``"cuda"``);
    without a card this raises unless ``device="cpu"`` is given.
    """
    dev = resolve_device(device)
    pts = np.ascontiguousarray(np.asarray(d, dtype=np.float32))
    n_pts, n = pts.shape
    stats = SelfJoinStats(num_points=n_pts, num_dims=n, k=min(config.k, n))
    if n_pts == 0:
        return SelfJoinResult(counts=np.zeros(0, np.int64), stats=stats,
                              pairs=np.zeros((0, 2), np.int32) if return_pairs else None)

    work = pts
    if config.reorder:
        work, _ = variance_reorder(pts, config.sample_frac)

    grid = build_grid(work, config.eps, config.k)
    plan = build_tile_plan(grid, config.tile_size, config.sortidu)
    stats.num_nonempty_cells = grid.num_cells
    stats.num_tiles = plan.num_tiles
    stats.num_tile_pairs_total = plan.num_tile_pairs_total
    stats.num_tile_pairs_evaluated = plan.num_pairs
    stats.num_candidates = plan.num_candidates

    tiles_np, tile_len_np = ops.make_tiles(
        grid.pts_sorted, plan.tile_start, plan.tile_len,
        config.tile_size, config.dim_block,
    )
    tiles_pts = torch.from_numpy(tiles_np).to(dev)
    tile_len = torch.from_numpy(tile_len_np).to(dev)
    backend = "pallas" if config.use_pallas else "jnp"
    n_pad = tiles_np.shape[2]
    nb_blocks = n_pad // config.dim_block

    counts_sorted = np.zeros(n_pts, dtype=np.int64)
    pairs_out: List[np.ndarray] = []
    t = config.tile_size
    lane = np.arange(t, dtype=np.int64)

    if return_pairs:
        # batching (Sec. 3.2.2): estimate |R|, derive n_b, process batch-wise
        est = batching_mod.estimate_result_size(
            tiles_pts, tile_len, plan, eps=config.eps,
            dim_block=config.dim_block, backend=backend,
            sample_frac=config.sample_frac, num_dims=n,
        )
        n_b = batching_mod.compute_num_batches(
            est, config.batch_size, config.min_batches
        )
        for lo, hi in batching_mod.batch_ranges(plan.num_pairs, n_b):
            pa, pb = plan.pair_a[lo:hi], plan.pair_b[lo:hi]
            for off, mask in ops.tile_mask(
                tiles_pts, tile_len, pa, pb, eps=config.eps,
                dim_block=config.dim_block, backend=backend, num_dims=n,
            ):
                pp, ii, jj = np.nonzero(mask)
                a_sorted = plan.tile_start[pa[off + pp]].astype(np.int64) + ii
                b_sorted = plan.tile_start[pb[off + pp]].astype(np.int64) + jj
                np.add.at(counts_sorted, a_sorted, 1)
                a_orig = grid.point_order[a_sorted]
                b_orig = grid.point_order[b_sorted]
                pairs_out.append(
                    np.stack([a_orig, b_orig], axis=1).astype(np.int32)
                )
                if max_pairs is not None and sum(x.shape[0] for x in pairs_out) > max_pairs:
                    raise RuntimeError(
                        f"result exceeded max_pairs={max_pairs}; raise the cap "
                        f"or lower eps"
                    )
        stats.dim_blocks_total = plan.num_pairs * nb_blocks
    else:
        counts_pair, skipped = ops.tile_counts(
            tiles_pts, tile_len, plan.pair_a, plan.pair_b,
            eps=config.eps, dim_block=config.dim_block,
            shortc=config.shortc, backend=backend, num_dims=n,
        )
        pa = plan.pair_a
        idx = plan.tile_start[pa].astype(np.int64)[:, None] + lane[None, :]
        valid = lane[None, :] < plan.tile_len[pa][:, None]
        np.add.at(
            counts_sorted,
            np.where(valid, idx, 0),
            np.where(valid, counts_pair.astype(np.int64), 0),
        )
        stats.dim_blocks_skipped = int(skipped.sum())
        stats.dim_blocks_total = plan.num_pairs * nb_blocks

    counts = np.zeros(n_pts, dtype=np.int64)
    counts[grid.point_order] = counts_sorted
    stats.num_results = int(counts.sum())

    pairs = np.concatenate(pairs_out) if pairs_out else (
        np.zeros((0, 2), np.int32) if return_pairs else None
    )
    return SelfJoinResult(counts=counts, stats=stats, pairs=pairs)
