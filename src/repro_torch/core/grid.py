"""Grid index over the first k dimensions (paper Sections 3.2.1 and 4.1).

Construction happens on the host, exactly as in the paper ("On the host, the
data points D are sorted into unit-length bins in each dimension").  Only
non-empty cells are stored; points are kept in a lookup array sorted by
(linearized cell id, u-coordinate), so cell-mates are contiguous in memory --
the property the paper uses for coalescing.

Tile adaptation (DESIGN.md #1.1): the per-thread 3^k adjacent-cell walk of the
paper's CUDA kernel becomes *candidate tile-pair generation*: every non-empty cell is
split into fixed-size tiles and each (cell, adjacent cell) pair contributes
its tile cross-product to a flat work list that the distance kernel consumes
as dense, regular work.  The self-join's list is written where the index is
placed (``build_tile_plan``: a CUDA kernel on a card); the query plan's on
the host.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import tile_plan

_MAX_LINEAR = np.int64(2) ** 62


@dataclasses.dataclass
class GridIndex:
    """Non-empty-cell grid over the first ``k`` dims of the (reordered) data."""

    eps: float
    k: int
    n: int
    u_dim: int                     # SORTIDU dimension (first un-indexed, or last indexed if k == n)
    origin: np.ndarray             # (k,) int64 cell-coordinate offset (per-dim min)
    cells_per_dim: np.ndarray      # (k,) int64
    strides: np.ndarray            # (k,) int64
    point_order: np.ndarray        # (N,) int64; pts_sorted[i] == D[point_order[i]]
    pts_sorted: np.ndarray         # (N, n) float32
    cell_coords: np.ndarray        # (C, k) int64 coords of non-empty cells, id-sorted
    cell_ids: np.ndarray           # (C,) int64 sorted linearized ids
    cell_start: np.ndarray         # (C,) int64 into pts_sorted
    cell_count: np.ndarray         # (C,) int64

    @property
    def num_cells(self) -> int:
        return int(self.cell_ids.shape[0])

    @property
    def bin_width(self) -> float:
        """Cell edge length (eps, or 1.0 for the degenerate eps == 0 grid)."""
        return self.eps if self.eps > 0 else 1.0

    @property
    def data_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-dimension (min, max) of the indexed points, reordered frame.

        The serving tier's kNN search (``repro.join``) uses this to cap its
        eps expansion: the diagonal of the joint query/data bounding box is
        an upper bound on any pairwise distance, so one pass at that radius
        is guaranteed to see every point.
        """
        got = getattr(self, "_bounds_cache", None)
        if got is None:
            if self.pts_sorted.shape[0] == 0:
                z = np.zeros(self.n, np.float64)
                got = (z, z)
            else:
                pts = self.pts_sorted.astype(np.float64)
                got = (pts.min(axis=0), pts.max(axis=0))
            self._bounds_cache = got  # static per grid; rebuilds make a new one
        return got


@dataclasses.dataclass
class QueryTilePlan:
    """Bipartite work list: evaluate q_sorted[Q tile] x pts_sorted[D tile].

    External query points Q are binned into an existing ``GridIndex`` over
    D, and the candidate set is the 3^k adjacent-cell cross product at tile
    granularity -- the same index filtering as the self-join, for an
    arbitrary query set.  ``pair_q`` indexes the query tiling here;
    ``pair_d`` indexes the data grid's own ``TilePlan`` tiles.
    """

    tile_size: int
    q_order: np.ndarray            # (Nq,) int64; q_sorted[i] == Q[q_order[i]]
    q_sorted: np.ndarray           # (Nq, n) float32, cell- then u-sorted
    q_tile_start: np.ndarray       # (num_q_tiles,) int32 into q_sorted
    q_tile_len: np.ndarray         # (num_q_tiles,) int32, 1..tile_size
    pair_q: np.ndarray             # (P,) int32 query-tile index
    pair_d: np.ndarray             # (P,) int32 data-tile index (into TilePlan)
    num_tile_pairs_total: int      # before SORTIDU window pruning
    num_candidates: int            # sum(q_len * d_len) over evaluated pairs

    @property
    def num_q_tiles(self) -> int:
        return int(self.q_tile_start.shape[0])

    @property
    def num_pairs(self) -> int:
        return int(self.pair_q.shape[0])


@dataclasses.dataclass
class TilePlan:
    """Flat candidate work list: evaluate pts[A tile] x pts[B tile] pairs."""

    tile_size: int
    tile_start: np.ndarray         # (num_tiles,) int32 into pts_sorted
    tile_len: np.ndarray           # (num_tiles,) int32, 1..tile_size
    tile_cell: np.ndarray          # (num_tiles,) int32 owning cell index
    pair_a: np.ndarray             # (P,) int32 tile index
    pair_b: np.ndarray             # (P,) int32 tile index
    num_tile_pairs_total: int      # before SORTIDU window pruning
    num_candidates: int            # sum(len_a * len_b) over evaluated pairs

    @property
    def num_tiles(self) -> int:
        return int(self.tile_start.shape[0])

    @property
    def num_pairs(self) -> int:
        return int(self.pair_a.shape[0])


def build_grid(d: np.ndarray, eps: float, k: int) -> GridIndex:
    """Assign points to eps-length cells in the first k dims and sort them.

    Cell coordinates are ``floor(x_j / eps)`` (paper Sec. 3.2.1).  Points
    within a cell are secondarily sorted by the u-coordinate (SORTIDU,
    Sec. 4.3); u is the first un-indexed dimension (highest-variance one
    after REORDER) or the last indexed dimension when k == n.
    """
    pts = np.ascontiguousarray(np.asarray(d, dtype=np.float32))
    n_pts, n = pts.shape
    k = int(min(k, n))
    u_dim = k if k < n else n - 1

    # eps == 0 (duplicate join): bin at unit width -- any positive cell
    # width is correct for a radius not exceeding it.
    bin_width = eps if eps > 0 else 1.0
    coords = np.floor(pts[:, :k].astype(np.float64) / bin_width).astype(np.int64)
    if n_pts:
        cmin = coords.min(axis=0)
        coords -= cmin  # origin at 0 per dim
        cells_per_dim = coords.max(axis=0).astype(np.int64) + 1
    else:
        cmin = np.zeros(k, dtype=np.int64)
        cells_per_dim = np.ones(k, dtype=np.int64)

    # linearization strides; fall back to row-rank ids on (theoretical) overflow
    total = np.prod(cells_per_dim.astype(object))
    if total < int(_MAX_LINEAR):
        strides = np.ones(k, dtype=np.int64)
        for j in range(k - 2, -1, -1):
            strides[j] = strides[j + 1] * cells_per_dim[j + 1]
        ids = coords @ strides
    else:  # pragma: no cover - only hit for k*log2(cells) > 62
        strides = np.zeros(k, dtype=np.int64)
        _, ids = np.unique(coords, axis=0, return_inverse=True)
        ids = ids.astype(np.int64)

    order = np.lexsort((pts[:, u_dim], ids))
    ids_sorted = ids[order]
    pts_sorted = np.ascontiguousarray(pts[order])

    uniq_ids, first, counts = np.unique(
        ids_sorted, return_index=True, return_counts=True
    )
    cell_coords = coords[order][first] if n_pts else np.zeros((0, k), np.int64)

    return GridIndex(
        eps=float(eps),
        k=k,
        n=n,
        u_dim=u_dim,
        origin=cmin,
        cells_per_dim=cells_per_dim,
        strides=strides,
        point_order=order.astype(np.int64),
        pts_sorted=pts_sorted,
        cell_coords=cell_coords,
        cell_ids=uniq_ids,
        cell_start=first.astype(np.int64),
        cell_count=counts.astype(np.int64),
    )


def bucket_rows(n: int, floor: int = 1) -> int:
    """Power-of-two row bucket: smallest pow2 >= max(n, floor, 1).

    The shape-bucket contract of the snapshot/engine split (DESIGN.md #10):
    device tables whose row count depends on the DATA (tile tables, the
    combined-order data segment, dense tiles) are padded to pow2 buckets,
    and a rebuilt snapshot carries the old snapshot's buckets forward as
    floors -- so replacing the data behind a warm engine presents identical
    array shapes to every compiled program as long as the new index still
    fits the bucket.
    """
    return 1 << (max(int(n), int(floor), 1) - 1).bit_length()


def pad_axis0(a: np.ndarray, target: int, fill=0) -> np.ndarray:
    """Pad ``a`` along axis 0 to ``target`` rows with the sentinel ``fill``.

    The uniform-shape contract of the fused distributed ring (DESIGN.md #7):
    every per-(worker, round) tile table and pair list is padded to the
    fleet-wide maximum so a single trace fits all ring positions.  ``fill``
    is 0 for tile lengths (the chunk program's validity mask drops empty
    tiles) and an out-of-range index for scatter maps (``mode="drop"``).
    """
    if a.shape[0] >= target:
        return a
    pad = np.full((target - a.shape[0],) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


def _neighbor_offsets(k: int) -> np.ndarray:
    """The (3^k, k) array of {-1, 0, 1} cell-coordinate offsets (Fig. 1)."""
    return np.stack(
        np.meshgrid(*([np.array([-1, 0, 1], dtype=np.int64)] * k), indexing="ij"),
        axis=-1,
    ).reshape(-1, k)


def adjacent_cell_pairs(grid: GridIndex) -> Tuple[np.ndarray, np.ndarray]:
    """All ordered (cell, non-empty adjacent cell) index pairs.

    For every non-empty cell the 3^k neighbourhood (paper Fig. 1) is probed
    with a vectorized binary search into the sorted non-empty ids -- the same
    ``|D| * 3^k * log2(|G|)`` search structure the paper models in Sec. 5.6,
    but amortized per *cell* instead of per point.  The self-join case is
    the bipartite probe applied to the grid's own cells.
    """
    return _probe_query_cells(grid, grid.cell_coords)


def split_cells_into_tiles(
    cell_start: np.ndarray, cell_count: np.ndarray, tile_size: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Split each cell's contiguous point run into fixed-size tiles.

    Returns ``(tile_start, tile_len, tile_cell, cell_tile_first)`` -- the
    shared tiling step of the self-join plan (cells of D vs. themselves) and
    the bipartite query plan (cells of Q vs. cells of D).
    """
    t = int(tile_size)
    counts = cell_count
    n_tiles_per_cell = (counts + t - 1) // t if counts.size else counts
    tile_cell = np.repeat(
        np.arange(cell_start.shape[0], dtype=np.int64), n_tiles_per_cell
    )
    if tile_cell.size:
        cell_tile_first = np.concatenate([[0], np.cumsum(n_tiles_per_cell)[:-1]])
        within = np.arange(tile_cell.size, dtype=np.int64) - cell_tile_first[tile_cell]
        tile_start = cell_start[tile_cell] + within * t
        tile_end = np.minimum(tile_start + t, cell_start[tile_cell] + counts[tile_cell])
        tile_len = tile_end - tile_start
    else:
        cell_tile_first = np.zeros(0, np.int64)
        tile_start = np.zeros(0, np.int64)
        tile_len = np.zeros(0, np.int64)
    return tile_start, tile_len, tile_cell, cell_tile_first


def _expand_cell_pairs_to_tile_pairs(
    ca: np.ndarray,
    cb: np.ndarray,
    n_tiles_per_cell_a: np.ndarray,
    n_tiles_per_cell_b: np.ndarray,
    cell_tile_first_a: np.ndarray,
    cell_tile_first_b: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Expand each (cell a, cell b) pair into its tiles(a) x tiles(b) grid."""
    na, nb = n_tiles_per_cell_a[ca], n_tiles_per_cell_b[cb]
    reps = na * nb
    pair_cell_a = np.repeat(ca, reps)
    pair_cell_b = np.repeat(cb, reps)
    if reps.size:
        offs = np.concatenate([[0], np.cumsum(reps)[:-1]])
        local = np.arange(int(reps.sum()), dtype=np.int64) - np.repeat(offs, reps)
        la = local // np.repeat(nb, reps)
        lb = local % np.repeat(nb, reps)
        pair_a = cell_tile_first_a[pair_cell_a] + la
        pair_b = cell_tile_first_b[pair_cell_b] + lb
    else:
        pair_a = np.zeros(0, np.int64)
        pair_b = np.zeros(0, np.int64)
    return pair_a, pair_b


def tile_plan_tables(grid: GridIndex, tile_size: int, device="cpu"):
    """The tables ``kernels.tile_plan.tile_pairs`` reads, placed on ``device``.

    Returns ``(tables, tile_start, tile_len, tile_cell, pairs_total)``: the
    eight tensors in ``tile_pairs``' order, the tiles as numpy (from
    ``split_cells_into_tiles``), and the number of tile pairs before SORTIDU.
    The host does only per-cell work here (tiles, the adjacent-cell probe,
    each tile's u window).
    """
    t = int(tile_size)
    counts = grid.cell_count
    n_tiles_per_cell = (counts + t - 1) // t if counts.size else counts
    tile_start, tile_len, tile_cell, cell_tile_first = split_cells_into_tiles(
        grid.cell_start, counts, t
    )

    # each A tile walks its cell's adjacent cells in cell order: with cells
    # numbered in order, each cell's tiles contiguous and the cell pairs
    # unique, that writes the tile pairs in sorted order
    ca, cb = adjacent_cell_pairs(grid)
    srt = np.lexsort((cb, ca))
    ca, cb = ca[srt], cb[srt]
    adj_ptr = np.concatenate([[0], np.cumsum(np.bincount(ca, minlength=grid.num_cells))])
    pairs_total = int((n_tiles_per_cell[ca] * n_tiles_per_cell[cb]).sum())

    # per-tile u window; points are u-sorted within each cell, so the window
    # is [first point, last point] of the tile
    u = grid.pts_sorted[:, grid.u_dim]
    dev = torch.device(device)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    tables = (
        put(tile_cell, np.int32), put(tile_len, np.int32),
        put(u[tile_start], np.float32), put(u[tile_start + tile_len - 1], np.float32),
        put(cell_tile_first, np.int32), put(n_tiles_per_cell, np.int32),
        put(adj_ptr, np.int64), put(cb, np.int32),
    )
    return tables, tile_start, tile_len, tile_cell, pairs_total


def build_tile_plan(grid: GridIndex, tile_size: int, sortidu: bool, device="cpu") -> TilePlan:
    """Split cells into tiles and list the candidate tile pairs, on ``device``.

    SORTIDU (Sec. 4.3) is applied at tile granularity: each tile's [min,max]
    u-coordinate window is precomputed (points are u-sorted within cells) and
    a tile pair is pruned when the windows are more than eps apart -- the
    paper's Fig. 3 r..s window.  The host does the per-cell work
    (``tile_plan_tables``); ``kernels.tile_plan.tile_pairs`` writes the
    per-tile-pair list where the tables are placed (the CUDA kernel on a card,
    its plain version on the CPU), already grouped by A tile in the JAX
    package's ``lexsort((pair_b, pair_a))`` order, so the two packages
    evaluate identical chunks.  The list comes back to the host.
    """
    tables, tile_start, tile_len, tile_cell, pairs_total = tile_plan_tables(grid, tile_size, device)
    pair_a, pair_b, num_candidates = tile_plan.tile_pairs(*tables, eps=grid.eps, sortidu=sortidu)
    return TilePlan(
        tile_size=int(tile_size),
        tile_start=tile_start.astype(np.int32),
        tile_len=tile_len.astype(np.int32),
        tile_cell=tile_cell.astype(np.int32),
        pair_a=pair_a.cpu().numpy(),
        pair_b=pair_b.cpu().numpy(),
        num_tile_pairs_total=pairs_total,
        num_candidates=num_candidates,
    )


def _probe_query_cells(
    grid: GridIndex, qcell_coords: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """All (probe cell, adjacent non-empty data cell) index pairs.

    ``qcell_coords`` are in the data grid's coordinate frame (origin
    subtracted) but may lie outside its bounding box -- such probe cells
    still find whichever of their 3^k neighbours fall inside.  Probing the
    grid's own ``cell_coords`` yields the self-join adjacency.
    """
    cq = qcell_coords.shape[0]
    c = grid.num_cells
    if cq == 0 or c == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    k = grid.k
    offsets = _neighbor_offsets(k)
    if not grid.strides.any() and k > 1:  # pragma: no cover - rank-id fallback
        lookup = {tuple(cc): i for i, cc in enumerate(grid.cell_coords)}
        out_q, out_d = [], []
        for i, qc in enumerate(qcell_coords):
            for off in offsets:
                j = lookup.get(tuple(qc + off))
                if j is not None:
                    out_q.append(i)
                    out_d.append(j)
        return np.asarray(out_q, np.int64), np.asarray(out_d, np.int64)

    out_q, out_d = [], []
    for off in offsets:
        ncoords = qcell_coords + off[None, :]
        in_bounds = np.all(
            (ncoords >= 0) & (ncoords < grid.cells_per_dim[None, :]), axis=1
        )
        nids = np.where(in_bounds[:, None], ncoords, 0) @ grid.strides
        pos = np.searchsorted(grid.cell_ids, nids)
        pos_c = np.minimum(pos, c - 1)
        found = in_bounds & (grid.cell_ids[pos_c] == nids)
        src = np.nonzero(found)[0]
        out_q.append(src)
        out_d.append(pos_c[src])
    return np.concatenate(out_q), np.concatenate(out_d)


def build_query_tile_plan(
    grid: GridIndex,
    plan: TilePlan,
    q: np.ndarray,
    sortidu: bool,
) -> QueryTilePlan:
    """Bin query points into ``grid`` and emit the Q-tile x D-tile work list.

    ``q`` must be in the same (reordered) coordinate frame as the points the
    grid was built over.  Queries are grouped by data-grid cell, u-sorted
    within each group (so SORTIDU windows apply on both sides), tiled at
    ``plan.tile_size``, and each (query cell, adjacent non-empty data cell)
    pair contributes its tile cross product.  Correct for any query radius
    not exceeding ``grid.eps`` (the candidate set is a superset; the
    distance filter runs at the queried radius).
    """
    q_pts = np.ascontiguousarray(np.asarray(q, dtype=np.float32))
    nq = q_pts.shape[0]
    t = int(plan.tile_size)
    k = grid.k
    if nq == 0:
        return QueryTilePlan(
            tile_size=t,
            q_order=np.zeros(0, np.int64),
            q_sorted=np.zeros((0, grid.n), np.float32),
            q_tile_start=np.zeros(0, np.int32),
            q_tile_len=np.zeros(0, np.int32),
            pair_q=np.zeros(0, np.int32),
            pair_d=np.zeros(0, np.int32),
            num_tile_pairs_total=0,
            num_candidates=0,
        )

    coords = (
        np.floor(q_pts[:, :k].astype(np.float64) / grid.bin_width).astype(np.int64)
        - grid.origin[None, :]
    )
    # group queries by cell; unique rows handle out-of-box coords robustly
    qcell_coords, inv = np.unique(coords, axis=0, return_inverse=True)
    order = np.lexsort((q_pts[:, grid.u_dim], inv))
    q_sorted = np.ascontiguousarray(q_pts[order])
    qcell_count = np.bincount(inv, minlength=qcell_coords.shape[0]).astype(np.int64)
    qcell_start = np.concatenate([[0], np.cumsum(qcell_count)[:-1]])

    q_tile_start, q_tile_len, _, q_cell_tile_first = split_cells_into_tiles(
        qcell_start, qcell_count, t
    )
    n_q_tiles_per_cell = (qcell_count + t - 1) // t

    # data-side tiling parameters, reconstructed to match ``plan``'s layout
    # (same splitting routine build_tile_plan used, so indices line up)
    d_counts = grid.cell_count
    n_d_tiles_per_cell = (d_counts + t - 1) // t if d_counts.size else d_counts
    _, _, _, d_cell_tile_first = split_cells_into_tiles(
        grid.cell_start, d_counts, t
    )

    cq, cd = _probe_query_cells(grid, qcell_coords)
    pair_q, pair_d = _expand_cell_pairs_to_tile_pairs(
        cq, cd, n_q_tiles_per_cell, n_d_tiles_per_cell,
        q_cell_tile_first, d_cell_tile_first,
    )
    total_pairs = int(pair_q.size)

    if sortidu and pair_q.size:
        uq = q_sorted[:, grid.u_dim]
        uq_lo = uq[q_tile_start]
        uq_hi = uq[q_tile_start + q_tile_len - 1]
        ud = grid.pts_sorted[:, grid.u_dim]
        ud_lo = ud[plan.tile_start[pair_d]]
        ud_hi = ud[plan.tile_start[pair_d] + plan.tile_len[pair_d] - 1]
        gap_lo = ud_lo - uq_hi[pair_q]         # d entirely above q
        gap_hi = uq_lo[pair_q] - ud_hi         # q entirely above d
        keep = np.maximum(gap_lo, gap_hi) <= np.float32(grid.eps)
        pair_q, pair_d = pair_q[keep], pair_d[keep]

    if pair_q.size:
        # group by Q tile, as build_tile_plan groups by A tile (the fused
        # count step stages each run of one A tile once)
        srt = np.lexsort((pair_d, pair_q))
        pair_q, pair_d = pair_q[srt], pair_d[srt]

    num_candidates = (
        int((q_tile_len[pair_q] * plan.tile_len[pair_d].astype(np.int64)).sum())
        if pair_q.size
        else 0
    )

    return QueryTilePlan(
        tile_size=t,
        q_order=order.astype(np.int64),
        q_sorted=q_sorted,
        q_tile_start=q_tile_start.astype(np.int32),
        q_tile_len=q_tile_len.astype(np.int32),
        pair_q=pair_q.astype(np.int32),
        pair_d=pair_d.astype(np.int32),
        num_tile_pairs_total=total_pairs,
        num_candidates=num_candidates,
    )
