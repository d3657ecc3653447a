"""K3 / K4: dense (unfiltered) tile-pair evaluation, and the dense tier's chunk steps.

The port of ``src/repro/kernels/dense_tile.py:dense_tile_distance`` (the
Pallas TPU kernel, bodies ``_kernel`` and ``_mask_kernel``): the same
accumulation as ``distance_tile`` with no SHORTC branch, and
``d2 = max(d2, 0)`` before the eps test -- the clamped matmul identity that
keeps self and duplicate pairs at tiny eps on raw fp32 data.  Same calling
convention as ``distance_tile.tile_pair_distance``; it returns no
``skipped`` (the dense tier skips nothing).

Routes, by device only (no fallback between them): CPU tensors run the
plain versions; CUDA tensors launch ``csrc/dense_tile_fused.cu``, over the
data's real dims (``num_dims``):

  * ``dense_tile_distance``  -- epilogue (a): counts (K3) and, with
    ``return_mask``, the (P, T, T) int8 hit mask (K4), per pair;
  * ``DenseCountScatter``    -- epilogue (b): the dense count chunk step
    (``repro.core.engine.count_chunk_step`` with a dense backend), one
    launch that scatters the counts itself;
  * ``DensePairsCompact``    -- epilogue (c): the dense pairs chunk step
    (``repro.core.engine.pairs_chunk_step`` with a dense backend), two
    launches that write the hits into the pair buffer in the reference's
    order, with no mask in device memory.

The two steps are bound once per pass (tables checked, kernel and stream
looked up), like ``distance_tile.CountScatter``.  Their plain versions are
``dense_count_scatter_plain`` (K3's plain version, then ``scatter_counts``)
and ``dense_pairs_compact_plain`` (per-pair hit totals, an exclusive scan,
an ordered write: the fused kernel's algorithm, not the reference's
rank-select).  ``dense_tile_distance_tile_eval`` launches the kernel K3 / K4
ran before (``csrc/dense_tile.cu``, the ``tile_eval.cuh`` body), for
comparing the two on the card; nothing on the main path calls it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.distance_tile import (
    K1_MAX_SMEM,
    K1_SLAB,
    PairsCompact,
    _dims,
    _k1_pitch,
    blocked_eval,
    check_chunk,
    check_step_tables,
    eps_squared,
    scatter_counts,
    write_ranked_hits,
)

# kernel launches, by kernel (reset by callers): each wrapper counts its own
LAUNCHES = {
    "dense_tile_distance": 0,            # K3, csrc/dense_tile_fused.cu epilogue (a)
    "dense_tile_distance_mask": 0,       # K4, csrc/dense_tile_fused.cu epilogue (a) with the mask
    "dense_count_scatter": 0,            # K3 + the dense count chunk step, epilogue (b)
    "dense_pairs_compact": 0,            # K4 + the dense pairs chunk step, epilogue (c): two per step
    "dense_tile_distance_tile_eval": 0,  # K3 / K4's earlier kernel, csrc/dense_tile.cu
}


def dense_tile_distance_plain(tiles, tile_len, pair_a, pair_b, *, eps, dim_block, return_mask=False,
                              num_dims=None):
    """Plain PyTorch version of K3 (counts) / K4 (``return_mask``)."""
    res = blocked_eval(
        tiles, tile_len, pair_a, pair_b, eps_squared(eps),
        dim_block=dim_block, shortc=False, clamp=True, return_mask=return_mask, num_dims=num_dims,
    )
    return (res[0], res[2]) if return_mask else (res[0],)


def dense_staging(t, num_dims) -> int:
    """How ``dense_tile_fused.cu`` stages tiles (its ``choose_staging``, by
    shape only): 0 where an A tile and two B tiles of whole rows, with two
    sets of row norms, fit in a block's shared memory, else ``K1_SLAB``, the
    width of the slices it stages instead."""
    rs = 16 * (1 if t <= 16 else 2 if t <= 32 else 4 if t <= 64 else 8)
    whole = (3 * rs * _k1_pitch(num_dims) + 4 * rs + 10) * 4
    return 0 if whole <= K1_MAX_SMEM else K1_SLAB


def _fn(symbol):
    return _build.function("dense_tile_fused", symbol)


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def dense_tile_distance(tiles, tile_len, pair_a, pair_b, *, eps, dim_block=32, return_mask=False, num_dims=None,
                        max_ctas=0):
    """Evaluate every listed tile pair densely (K3, or K4 with ``return_mask``).

    Returns ``(counts (P,T) int32,)`` or ``(counts, mask (P,T,T) int8)``.
    ``num_dims`` (default ``n_pad``) is the data's dimension count, the dims
    past it being zero padding.  A CUDA ``tiles`` launches epilogue (a) of
    ``csrc/dense_tile_fused.cu`` (T <= 128; ``max_ctas > 0`` caps its
    persistent grid, changing no result); a CPU ``tiles`` runs the plain
    version.
    """
    n = _dims(tiles, dim_block, num_dims)
    if tiles.device.type == "cpu":
        return dense_tile_distance_plain(
            tiles, tile_len, pair_a, pair_b,
            eps=eps, dim_block=dim_block, return_mask=return_mask, num_dims=n,
        )
    if tiles.device.type != "cuda":
        raise ValueError(f"dense_tile_distance runs on cpu or cuda tensors, not {tiles.device}")
    _build.check_tile_args(tiles, tile_len, pair_a, pair_b)
    p, t = pair_a.shape[0], tiles.shape[1]
    counts = torch.empty((p, t), dtype=torch.int32, device=tiles.device)
    mask = torch.empty((p, t, t), dtype=torch.int8, device=tiles.device) if return_mask else None
    with torch.cuda.device(tiles.device):
        err = _fn("dense_tile_pair_eval")(
            tiles.data_ptr(), tile_len.data_ptr(), pair_a.data_ptr(), pair_b.data_ptr(),
            p, t, tiles.shape[2], n, dim_block, eps_squared(eps),
            counts.data_ptr(), mask.data_ptr() if return_mask else None, int(max_ctas), _stream(tiles.device))
    if err != 0:
        raise RuntimeError(f"dense_tile_pair_eval: CUDA launch failed with cudaError {err}")
    LAUNCHES["dense_tile_distance_mask" if return_mask else "dense_tile_distance"] += 1
    return (counts, mask) if return_mask else (counts,)


def dense_tile_distance_tile_eval(tiles, tile_len, pair_a, pair_b, *, eps, dim_block=32, return_mask=False):
    """K3 / K4 on CUDA tensors through the ``tile_eval.cuh`` body
    (``csrc/dense_tile.cu``), all ``n_pad`` dims, one block per pair: the
    kernel they ran before ``csrc/dense_tile_fused.cu``, kept to compare the
    two on the same inputs."""
    _dims(tiles, dim_block, None)
    if tiles.device.type != "cuda":
        raise ValueError(f"dense_tile_distance_tile_eval runs on cuda tensors, not {tiles.device}")
    p, t = pair_a.shape[0], tiles.shape[1]
    outs = [torch.empty((p, t), dtype=torch.int32, device=tiles.device)]
    if return_mask:
        outs.append(torch.empty((p, t, t), dtype=torch.int8, device=tiles.device))
    _build.launch_tile_kernel("dense_tile", "dense_tile_mask" if return_mask else "dense_tile_counts",
                              tiles, tile_len, pair_a, pair_b, eps_squared(eps), dim_block, outs)
    LAUNCHES["dense_tile_distance_tile_eval"] += 1
    return tuple(outs)


# ---------------------------------------------------------------------------
# The dense tier's chunk steps.
# ---------------------------------------------------------------------------


def dense_count_scatter_plain(counts_sorted, tiles, tile_len, tile_start, pa, pb, real, eps, *, dim_block,
                              num_dims=None):
    """Plain version of the dense count chunk step, in place: K3's plain
    version, then ``scatter_counts`` (the dense tier adds no skipped blocks)."""
    (counts,) = dense_tile_distance_plain(tiles, tile_len, pa, pb, eps=eps, dim_block=dim_block,
                                          num_dims=num_dims)
    scatter_counts(counts_sorted, None, counts, None, tile_len, tile_start, pa, real)


def dense_pairs_compact_plain(buf, offset, max_chunk_hits, tiles, tile_len, tile_start, point_order, pa, pb,
                              real, eps, *, hit_cap, dim_block, num_dims=None):
    """Plain version of the dense pairs chunk step, in place, by the fused
    kernel's own algorithm: K4's plain version for the row counts and the
    mask, then ``distance_tile.write_ranked_hits`` (each pair's hit total,
    their exclusive scan, every hit written at ``min(offset, cap) + base[p]
    + (its index among pair p's hits in row-major order)`` where that rank
    is below ``hit_cap``; then ``offset += hits``, ``max_chunk_hits =
    max(max_chunk_hits, hits)``).  Rows of ``buf`` no hit lands on are left
    as they were."""
    counts, mask = dense_tile_distance_plain(tiles, tile_len, pa, pb, eps=eps, dim_block=dim_block,
                                             return_mask=True, num_dims=num_dims)
    write_ranked_hits(buf, offset, max_chunk_hits, counts, mask, tile_start, point_order, pa, pb, real,
                      hit_cap=hit_cap)


class DenseCountScatter:
    """The dense count chunk step bound to one pass's tables on the card.

    ``step(pa, pb, real)`` is one launch of ``dense_tile_count_scatter``
    (``csrc/dense_tile_fused.cu`` epilogue (b)) on chunk ``(pa, pb)`` (int32,
    contiguous, on the tables' device; pairs past ``real`` ignored): the
    count of each valid row goes into ``counts_sorted[tile_start[pa] + r]``
    (rows at or past N drop).  Holds its tables for as long as it lives; the
    caller keeps ``tiles``'s device current while it calls.
    """

    __slots__ = ("_fn", "_tables", "_args", "_tail", "_stream", "_device")

    def __init__(self, counts_sorted, tiles, tile_len, tile_start, eps, *, dim_block, num_dims=None, max_ctas=0):
        n = check_step_tables("DenseCountScatter", tiles, tile_len, tile_start, dim_block, num_dims,
                              counts_sorted=counts_sorted)
        self._fn = _fn("dense_tile_count_scatter")
        # the kernel keeps raw pointers: the tensors live as long as the step
        self._tables = (tiles, tile_len, tile_start, counts_sorted)
        self._args = (tiles.data_ptr(), tile_len.data_ptr(), tile_start.data_ptr())
        self._tail = (tiles.shape[1], tiles.shape[2], n, dim_block, eps_squared(eps), counts_sorted.data_ptr(),
                      counts_sorted.shape[0] - 1, int(max_ctas))
        self._stream = _stream(tiles.device)
        self._device = tiles.device

    def __call__(self, pa, pb, real) -> None:
        check_chunk(pa, pb, real, self._device)
        if real == 0:
            return
        err = self._fn(*self._args, pa.data_ptr(), pb.data_ptr(), real, *self._tail, self._stream)
        if err != 0:
            raise RuntimeError(f"dense_tile_count_scatter: CUDA launch failed with cudaError {err}")
        LAUNCHES["dense_count_scatter"] += 1


class DensePairsCompact(PairsCompact):
    """The dense pairs chunk step bound to one pass's state on the card:
    ``distance_tile.PairsCompact``'s contract, with the dense tier's kernel.

    Each ``step(pa, pb, real)`` is two launches of
    ``dense_tile_pairs_compact`` (``csrc/dense_tile_fused.cu`` epilogue (c),
    no SHORTC, the clamped eps test): the chunk's hits of rank below
    ``hit_cap`` land in ``buf`` at ``min(offset, cap)`` in the reference's
    order, and ``offset`` / ``max_chunk_hits`` move on the device.
    """

    __slots__ = ()
    _SOURCE = ("dense_tile_fused", "dense_tile_pairs_compact")
    _LAUNCHES, _KEY = LAUNCHES, "dense_pairs_compact"


def dense_count_scatter(counts_sorted, tiles, tile_len, tile_start, pa, pb, real, eps, *, dim_block,
                        num_dims=None):
    """One dense count chunk, in place: on CUDA one launch of epilogue (b);
    on the CPU ``dense_count_scatter_plain``."""
    if tiles.device.type == "cpu":
        return dense_count_scatter_plain(counts_sorted, tiles, tile_len, tile_start, pa, pb, real, eps,
                                         dim_block=dim_block, num_dims=num_dims)
    _build.check_tile_args(tiles, tile_len, pa, pb)
    with torch.cuda.device(tiles.device):
        DenseCountScatter(counts_sorted, tiles, tile_len, tile_start, eps, dim_block=dim_block,
                          num_dims=num_dims)(pa, pb, real)
