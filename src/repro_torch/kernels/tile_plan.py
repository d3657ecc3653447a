"""The self-join's candidate tile-pair list, built where its tables live.

Not a port of a TPU kernel: the JAX package builds this list on the host
(``src/repro/core/grid.py:build_tile_plan``).  ``tile_pairs`` takes the
plan's small tables -- each tile's cell, length and u window, each cell's
first tile and tile count, and the CSR of each cell's adjacent cells sorted
by (cell, adjacent cell) -- and returns ``pair_a`` / ``pair_b`` already in
``lexsort((pair_b, pair_a))`` order, with no sort: every A tile walks the
B tiles of its cell's adjacent cells in cell order, and each cell's tiles
are contiguous.  SORTIDU keeps a pair when
``max(u_lo[b] - u_hi[a], u_lo[a] - u_hi[b]) <= eps`` in float32.

Routes, by device only (no fallback between them): CPU tensors run
``tile_pairs_plain``; CUDA tensors launch ``csrc/tile_plan.cu`` twice (the
kept counts, then the pairs at their scanned offsets).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

# kernel launches (reset by callers): two per plan on the card, none for an empty grid
LAUNCHES = {"tile_plan": 0}


def _repeat(values: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """``repeat_interleave(values, lens)``, int64, as a cumsum of the steps
    at each segment's start: torch's CPU ``repeat_interleave`` splits even a
    few elements over every thread, which stalls when the cores are busy."""
    lens = lens.long()
    out = torch.zeros(int(lens.sum()), dtype=torch.int64, device=lens.device)
    filled = lens > 0
    v = values.long()[filled]
    out[(torch.cumsum(lens, 0) - lens)[filled]] = torch.diff(v, prepend=v.new_zeros(1))
    return torch.cumsum(out, 0)


def _ranges(starts: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """``cat([arange(s, s + n) for s, n in zip(starts, lens)])``, int64."""
    lens = lens.long()
    out = _repeat(starts.long() - (torch.cumsum(lens, 0) - lens), lens)
    return out + torch.arange(out.shape[0], device=out.device)


def tile_pairs_plain(tile_cell, tile_len, u_lo, u_hi, cell_tile_first, cell_tiles, adj_ptr, adj, *, eps, sortidu):
    """Plain PyTorch version of ``tile_pairs``: the same walk, vectorized."""
    nb = cell_tiles[adj].long()
    seq = _ranges(cell_tile_first[adj], nb)  # each cell's B tiles, cell after cell
    ends = torch.cat([nb.new_zeros(1), torch.cumsum(nb, 0)])
    seq_start, seq_len = ends[adj_ptr[:-1]], ends[adj_ptr[1:]] - ends[adj_ptr[:-1]]
    a_cell = tile_cell.long()
    per_a = seq_len[a_cell]
    pair_a = _repeat(torch.arange(tile_cell.shape[0], device=tile_cell.device), per_a)
    pair_b = seq[_ranges(seq_start[a_cell], per_a)]
    if sortidu:
        keep = (u_lo[pair_b] - u_hi[pair_a] <= eps) & (u_lo[pair_a] - u_hi[pair_b] <= eps)
        pair_a, pair_b = pair_a[keep], pair_b[keep]
    num_candidates = int((tile_len[pair_a].long() * tile_len[pair_b].long()).sum())
    return pair_a.int(), pair_b.int(), num_candidates


def _check(tile_cell, tile_len, u_lo, u_hi, cell_tile_first, cell_tiles, adj_ptr, adj) -> None:
    n_tiles, n_cells = tile_cell.shape[0], cell_tile_first.shape[0]
    for arg, what, dtype, rows in (
        (tile_cell, "tile_cell", torch.int32, n_tiles), (tile_len, "tile_len", torch.int32, n_tiles),
        (u_lo, "u_lo", torch.float32, n_tiles), (u_hi, "u_hi", torch.float32, n_tiles),
        (cell_tile_first, "cell_tile_first", torch.int32, n_cells),
        (cell_tiles, "cell_tiles", torch.int32, n_cells), (adj_ptr, "adj_ptr", torch.int64, n_cells + 1),
        (adj, "adj", torch.int32, adj.shape[0]),
    ):
        if arg.dtype != dtype or arg.dim() != 1 or arg.shape[0] != rows:
            raise ValueError(f"{what} must be a 1-D {dtype} tensor of {rows} rows, got {arg.dtype} "
                             f"{tuple(arg.shape)}")
        if arg.device != tile_cell.device or not arg.is_contiguous():
            raise ValueError("tile plan tables must be contiguous and on one device")


def tile_pairs(tile_cell, tile_len, u_lo, u_hi, cell_tile_first, cell_tiles, adj_ptr, adj, *, eps, sortidu):
    """The kept tile pairs ``(pair_a, pair_b)`` (int32, on the tables'
    device) in (A tile, B tile) order, and ``sum(len_a * len_b)`` over them.

    ``eps`` is compared in float32 (``np.float32(eps)``, as numpy does).
    """
    _check(tile_cell, tile_len, u_lo, u_hi, cell_tile_first, cell_tiles, adj_ptr, adj)
    eps = float(np.float32(eps))
    dev = tile_cell.device
    if dev.type == "cpu":
        return tile_pairs_plain(tile_cell, tile_len, u_lo, u_hi, cell_tile_first, cell_tiles, adj_ptr, adj,
                                eps=eps, sortidu=sortidu)
    if dev.type != "cuda":
        raise ValueError(f"tile_pairs runs on a cpu or cuda device, got {dev}")
    n = tile_cell.shape[0]
    tables = [x.data_ptr() for x in (tile_cell, tile_len, u_lo, u_hi, cell_tile_first, cell_tiles, adj_ptr, adj)]
    head = (*tables, n, int(bool(sortidu)), eps)
    stream = torch.cuda.current_stream(dev).cuda_stream
    kept = torch.zeros(n, dtype=torch.int64, device=dev)
    cand = torch.zeros(n, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        if n:
            _launch("tile_plan_count", *head, kept.data_ptr(), cand.data_ptr(), stream)
        ends = torch.cumsum(kept, 0)
        total, num_candidates = (int(v) for v in torch.stack([ends[-1:].sum(), cand.sum()]).tolist())
        pair_a = torch.empty(total, dtype=torch.int32, device=dev)
        pair_b = torch.empty(total, dtype=torch.int32, device=dev)
        if total:
            offsets = ends - kept
            _launch("tile_plan_write", *head, offsets.data_ptr(), pair_a.data_ptr(), pair_b.data_ptr(), stream)
    return pair_a, pair_b, num_candidates


def _launch(symbol, *args) -> None:
    err = _build.function("tile_plan", symbol)(*args)
    if err != 0:
        raise RuntimeError(f"{symbol}: CUDA launch failed with cudaError {err}")
    LAUNCHES["tile_plan"] += 1
