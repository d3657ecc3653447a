"""K1 / K2: eps-neighbourhood evaluation of candidate tile pairs, with SHORTC.

The port of ``src/repro/kernels/distance_tile.py:tile_pair_distance`` (the
Pallas TPU kernel, bodies ``_kernel`` and ``_mask_kernel``).  For each
candidate pair ``(pair_a[p], pair_b[p])`` of a ``(num_tiles, T, n_pad)`` f32
tile table, ``d2 = |a|^2 + |b|^2 - 2 a.b^T`` accumulates over
``dim_block``-wide blocks; a pair stops (SHORTC) once the min of d2 over its
valid lanes exceeds eps^2, and ``skipped`` counts the blocks it never
computed.  Outputs: ``counts (P, T) int32`` and ``skipped (P,) int32``, plus
the ``(P, T, T) int8`` hit mask in mask mode.

Routes (``_route``, by device and mode only; no fallback between them):

  * CPU tensors                -> ``tile_pair_distance_plain``, the same
    blocked algorithm in plain PyTorch (the twin of
    ``repro.kernels.ops._eval_jnp``);
  * CUDA, counts (K1) and mask (K2) -> ``csrc/distance_tile_counts.cu``,
    epilogue (a), over the data's real dims only (``num_dims``).

The indexed tier's chunk steps are fused into the same kernel and bound
once per pass (tables checked, kernel and stream looked up):

  * ``CountScatter``  -- epilogue (b): the count chunk step (the
    counterpart of ``repro.core.engine.count_chunk_step``), one launch that
    scatters the counts into the grid-sorted counts vector itself; its
    plain version is ``tile_pair_count_scatter_plain``
    (``tile_pair_distance_plain`` followed by an ``index_add_``), and
    ``tile_pair_count_scatter`` runs one chunk of either;
  * ``PairsCompact``  -- epilogue (c): the pairs chunk step (the
    counterpart of ``repro.core.engine.pairs_chunk_step``), two launches
    that write the hits into the pair buffer in the reference's order with
    no mask in device memory; its plain version is
    ``tile_pair_pairs_compact_plain`` (per-pair hit totals, an exclusive
    scan, an ordered write: the kernel's algorithm, not the reference's
    rank-select).

``tile_pair_distance_tile_eval`` launches the kernel K1 / K2 ran before
(``csrc/distance_tile.cu``, the ``tile_eval.cuh`` body), for comparing the
two on the card; nothing on the main path calls it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

NEG_LARGE = 3.0e38  # invalid lanes in the SHORTC min (distance_tile.py:34)

# kernel launches, by kernel (reset by callers): each wrapper counts its own
LAUNCHES = {
    "tile_pair_distance": 0,            # K1, csrc/distance_tile_counts.cu, per pair
    "tile_pair_count_scatter": 0,       # K1, csrc/distance_tile_counts.cu, fused chunk step
    "tile_pair_distance_mask": 0,       # K2, csrc/distance_tile_counts.cu, per pair
    "tile_pair_pairs_compact": 0,       # K2, csrc/distance_tile_counts.cu, fused pairs step: two per step
    "tile_pair_distance_tile_eval": 0,  # K1 / K2's earlier tile_eval.cuh kernel, csrc/distance_tile.cu
}


def eps_squared(eps) -> float:
    """eps^2 as the reference computes it: eps rounded to f32, squared in f32.

    The JAX package evaluates ``jnp.asarray(eps, jnp.float32) ** 2``
    (``distance_tile.py:134``, ``ops.py:201``); a Python ``eps * eps`` in
    float64 can round to a different f32 threshold.
    """
    e = np.float32(eps)
    return float(e * e)


def _gather(tiles, tile_len, pair_a, pair_b):
    """A and B tiles of every pair, and the (P, T, T) lane-validity mask."""
    t = tiles.shape[1]
    pa = pair_a.long()
    pb = pair_b.long()
    rows = torch.arange(t, device=tiles.device)
    valid = (rows[None, :, None] < tile_len[pa][:, None, None]) & (
        rows[None, None, :] < tile_len[pb][:, None, None]
    )
    return tiles[pa], tiles[pb], valid


def _fold(d2, a, b):
    """One dim block of the accumulation, in the Pallas kernel's order:
    ``((d2 + |a|^2) + |b|^2) - 2 a.b^T`` (``distance_tile.py:82``)."""
    na = (a * a).sum(-1)
    nb = (b * b).sum(-1)
    prod = torch.bmm(a, b.transpose(1, 2))
    return d2 + na[:, :, None] + nb[:, None, :] - 2.0 * prod


def blocked_eval(tiles, tile_len, pair_a, pair_b, eps2, *, dim_block, shortc, clamp, return_mask,
                 num_dims=None):
    """Plain PyTorch body shared by the four kernels' plain versions.

    ``shortc`` stops a pair once its valid-lane min of d2 exceeds ``eps2``
    (checked after every computed block, the last one included) and counts
    the blocks it skipped; ``clamp`` applies ``max(d2, 0)`` before the eps
    test.  Each block multiplies only dims below ``num_dims`` (default
    ``n_pad``); the dims past it are the zero padding, so this changes no
    result.  Returns ``(counts (P,T) int32, skipped (P,) int32[, mask])``.
    """
    t, n_pad = tiles.shape[1], tiles.shape[2]
    n = n_pad if num_dims is None else num_dims
    p = pair_a.shape[0]
    a, b, valid = _gather(tiles, tile_len, pair_a, pair_b)
    eps2_t = torch.tensor(eps2, dtype=torch.float32, device=tiles.device)
    d2 = torch.zeros((p, t, t), dtype=torch.float32, device=tiles.device)
    done = torch.zeros(p, dtype=torch.bool, device=tiles.device)
    skipped = torch.zeros(p, dtype=torch.int32, device=tiles.device)
    for k0 in range(0, n_pad, dim_block):
        k1 = max(k0, min(k0 + dim_block, n))
        blk = _fold(d2, a[:, :, k0:k1], b[:, :, k0:k1])
        if shortc:
            skipped += done.to(torch.int32)
            d2 = torch.where(done[:, None, None], d2, blk)
            masked = torch.where(valid, d2, torch.full_like(d2, NEG_LARGE))
            done |= masked.amin(dim=(1, 2)) > eps2_t
        else:
            d2 = blk
    if clamp:
        d2 = d2.clamp_min(0.0)
    within = (d2 <= eps2_t) & valid
    counts = within.sum(dim=2, dtype=torch.int32)
    if return_mask:
        return counts, skipped, within.to(torch.int8)
    return counts, skipped


def tile_pair_distance_plain(tiles, tile_len, pair_a, pair_b, *, eps, dim_block, return_mask=False,
                             num_dims=None):
    """Plain PyTorch version of K1 (counts) / K2 (``return_mask``)."""
    return blocked_eval(
        tiles, tile_len, pair_a, pair_b, eps_squared(eps),
        dim_block=dim_block, shortc=True, clamp=False, return_mask=return_mask, num_dims=num_dims,
    )


def _route(device, return_mask):
    """``"plain"`` for a CPU ``device``; on CUDA ``"counts"``
    (``csrc/distance_tile_counts.cu``) for counts (K1) and for the mask (K2)
    alike.  Reads only the device and the mode."""
    if device.type == "cpu":
        return "plain"
    if device.type != "cuda":
        raise ValueError(f"tile_pair_distance runs on cpu or cuda tensors, not {device}")
    return "counts"


def _dims(tiles, dim_block, num_dims):
    """Check ``n_pad % dim_block`` and return ``num_dims`` (default ``n_pad``)."""
    n_pad = tiles.shape[2]
    if n_pad % dim_block:
        raise ValueError(f"n_pad={n_pad} not a multiple of dim_block={dim_block}")
    n = n_pad if num_dims is None else int(num_dims)
    if not 1 <= n <= n_pad:
        raise ValueError(f"num_dims must lie in 1..n_pad={n_pad}, got {n}")
    return n


K1_MAX_SMEM = 232448  # distance_tile_counts.cu: kMaxSmem, a block's shared memory on sm_90
K1_SLAB = 32  # distance_tile_counts.cu: kSlab, dims per slice where whole rows do not fit


def _k1_pitch(dims) -> int:
    """``tile_pitch`` of ``distance_tile_counts.cu``: a multiple of 4 floats
    whose quarter is odd."""
    pitch = -(-dims // 4) * 4
    return pitch + 4 if (pitch // 4) % 2 == 0 else pitch


def k1_staging(t, num_dims) -> int:
    """How ``distance_tile_counts.cu`` stages tiles (its ``choose_staging``,
    by shape only): 0 where an A tile and two B tiles of whole rows, with
    the norms, the SHORTC partial mins and the pairs step's two hit slots,
    fit in a block's shared memory, else ``K1_SLAB``, the width of the
    slices it stages instead."""
    rs = 16 * (1 if t <= 16 else 2 if t <= 32 else 4 if t <= 64 else 8)
    whole = (3 * rs * _k1_pitch(num_dims) + 2 * rs + 10) * 4
    return 0 if whole <= K1_MAX_SMEM else K1_SLAB


def tile_pair_distance(tiles, tile_len, pair_a, pair_b, *, eps, dim_block=32, return_mask=False,
                       num_dims=None, max_ctas=0):
    """Evaluate all candidate tile pairs (K1, or K2 with ``return_mask``).

    ``tiles (num_tiles, T, n_pad) f32``, ``tile_len (num_tiles,) int32``,
    ``pair_a / pair_b (P,) int32``; ``n_pad % dim_block == 0``; ``num_dims``
    (default ``n_pad``) is the data's dimension count, the dims past it
    being zero padding.  Returns ``(counts (P,T) int32, skipped (P,) int32[,
    mask (P,T,T) int8])``.  CUDA ``tiles`` launch epilogue (a) of
    ``csrc/distance_tile_counts.cu`` (T <= 128, see ``_route``); CPU
    ``tiles`` run the plain version.  ``max_ctas > 0`` caps the kernel's
    persistent grid on the card, so that each CTA walks a longer range of
    pairs (it changes no result; the tests use it to put many runs of
    ``pair_a`` in one range).
    """
    n = _dims(tiles, dim_block, num_dims)
    if _route(tiles.device, return_mask) == "plain":
        return tile_pair_distance_plain(
            tiles, tile_len, pair_a, pair_b,
            eps=eps, dim_block=dim_block, return_mask=return_mask, num_dims=n,
        )
    _build.check_tile_args(tiles, tile_len, pair_a, pair_b)
    p, t = pair_a.shape[0], tiles.shape[1]
    counts = torch.empty((p, t), dtype=torch.int32, device=tiles.device)
    skipped = torch.empty((p,), dtype=torch.int32, device=tiles.device)
    mask = torch.empty((p, t, t), dtype=torch.int8, device=tiles.device) if return_mask else None
    fn = _build.function("distance_tile_counts", "distance_tile_pair_counts")
    with torch.cuda.device(tiles.device):
        err = fn(tiles.data_ptr(), tile_len.data_ptr(), pair_a.data_ptr(), pair_b.data_ptr(),
                 p, t, tiles.shape[2], n, dim_block, eps_squared(eps),
                 counts.data_ptr(), skipped.data_ptr(), mask.data_ptr() if return_mask else None,
                 int(max_ctas), torch.cuda.current_stream(tiles.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"distance_tile_pair_counts: CUDA launch failed with cudaError {err}")
    LAUNCHES["tile_pair_distance_mask" if return_mask else "tile_pair_distance"] += 1
    return (counts, skipped, mask) if return_mask else (counts, skipped)


def tile_pair_distance_tile_eval(tiles, tile_len, pair_a, pair_b, *, eps, dim_block=32, return_mask=False):
    """K1 (counts) / K2 (``return_mask``) on CUDA tensors through the
    ``tile_eval.cuh`` body (``csrc/distance_tile.cu``), all ``n_pad`` dims,
    one block per pair: the kernel they ran before
    ``csrc/distance_tile_counts.cu``, kept to compare the two on the same
    inputs.  Returns ``(counts, skipped[, mask])``."""
    _dims(tiles, dim_block, None)
    if tiles.device.type != "cuda":
        raise ValueError(f"tile_pair_distance_tile_eval runs on cuda tensors, not {tiles.device}")
    p, t = pair_a.shape[0], tiles.shape[1]
    outs = [torch.empty((p, t), dtype=torch.int32, device=tiles.device),   # counts
            torch.empty((p,), dtype=torch.int32, device=tiles.device)]     # skipped
    if return_mask:
        outs.append(torch.empty((p, t, t), dtype=torch.int8, device=tiles.device))
    _build.launch_tile_kernel("distance_tile", "distance_tile_mask" if return_mask else "distance_tile_counts",
                              tiles, tile_len, pair_a, pair_b, eps_squared(eps), dim_block, outs)
    LAUNCHES["tile_pair_distance_tile_eval"] += 1
    return tuple(outs)


# ---------------------------------------------------------------------------
# The indexed count chunk step.
# ---------------------------------------------------------------------------


def scatter_counts(counts_sorted, skipped_tot, counts, skipped, tile_len, tile_start, pa, real):
    """Add one evaluated chunk into the running state, in place: the count
    of each valid row ``r < tile_len[pa]`` of each pair ``p < real`` into
    ``counts_sorted[tile_start[pa] + r]`` (``index_add_``; invalid lanes, and
    rows at or past ``N``, add 0 to the sink row ``N``), and the valid pairs' ``skipped`` into
    ``skipped_tot`` (left alone where ``skipped`` is None, as in the dense
    tier).  ``counts.at[idx].add(..., mode="drop")`` of the JAX package
    (``src/repro/core/engine.py:120-126``)."""
    c, t = counts.shape
    dev = pa.device
    n = counts_sorted.shape[0] - 1
    lane = torch.arange(t, device=dev)
    pal = pa.long()
    pair_valid = torch.arange(c, device=dev) < real
    valid = pair_valid[:, None] & (lane[None, :] < tile_len[pal][:, None])
    idx = tile_start[pal].long()[:, None] + lane[None, :]
    valid &= idx < n  # rows past N drop, as mode="drop" does
    idx = torch.where(valid, idx, n)
    counts_sorted.index_add_(0, idx.reshape(-1), torch.where(valid, counts, 0).reshape(-1))
    if skipped is not None:
        skipped_tot += torch.where(pair_valid, skipped, 0).sum(dtype=torch.int32)


def tile_pair_count_scatter_plain(counts_sorted, skipped_tot, tiles, tile_len, tile_start, pa, pb, real, eps,
                                  *, dim_block, shortc, num_dims=None):
    """Plain version of the fused step: ``tile_pair_distance_plain``, then
    ``scatter_counts``.  ``shortc=False`` adds no skipped blocks (the
    evaluation short-circuits all the same, as in ``ops.eval_tile_pairs``)."""
    counts, skipped = tile_pair_distance_plain(
        tiles, tile_len, pa, pb, eps=eps, dim_block=dim_block, num_dims=num_dims)
    if not shortc:
        skipped = torch.zeros_like(skipped)
    scatter_counts(counts_sorted, skipped_tot, counts, skipped, tile_len, tile_start, pa, real)


def check_step_tables(what, tiles, tile_len, tile_start, dim_block, num_dims, **state):
    """Validate the tables a fused chunk step binds (``what`` names it in
    errors): CUDA float32 tiles with their int32 ``tile_len`` and
    ``tile_start``, and each of ``state`` a contiguous int32 tensor on the
    same device (``skipped_tot`` and the other scalars holding one value,
    ``counts_sorted`` (N + 1,)); the device is checked last, so tables of
    the wrong type or shape are named as such on any device.  Returns
    ``num_dims`` (default n_pad)."""
    n = _dims(tiles, dim_block, num_dims)
    empty = torch.zeros(0, dtype=torch.int32, device=tiles.device)
    _build.check_tile_args(tiles, tile_len, empty, empty)
    for name, arg in (("tile_start", tile_start), *state.items()):
        if arg.dtype != torch.int32 or arg.device != tiles.device or not arg.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on {tiles.device}")
    if tile_start.shape != tile_len.shape:
        raise ValueError(f"tile_start must match tile_len, got {tuple(tile_start.shape)}")
    if "counts_sorted" in state and (state["counts_sorted"].dim() != 1 or state["counts_sorted"].shape[0] < 1):
        raise ValueError("counts_sorted must be (N + 1,)")
    for name in ("skipped_tot", "offset", "max_chunk_hits"):
        if name in state and state[name].numel() != 1:
            raise ValueError(f"{name} must hold one value")
    if tiles.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda tensors, not {tiles.device}")
    return n


def check_chunk(pa, pb, real, device, chunk=None) -> None:
    """A chunk ``(pa, pb)`` a bound step takes: contiguous int32 on
    ``device``, with ``0 <= real <= len`` and, for a step whose scratch is
    sized for ``chunk`` pairs, ``real <= chunk``."""
    if (pa.dtype != torch.int32 or pb.dtype != torch.int32 or not pa.is_contiguous()
            or not pb.is_contiguous() or pa.device != device or pb.device != device):
        raise ValueError(f"pa and pb must be contiguous int32 tensors on {device}")
    if not 0 <= real <= min(pa.shape[0], pb.shape[0]):
        raise ValueError(f"real={real} outside 0..{min(pa.shape[0], pb.shape[0])}")
    if chunk is not None and real > chunk:
        raise ValueError(f"real={real} exceeds the bound chunk length {chunk}")


class CountScatter:
    """The fused chunk step bound to one pass's tables on the card.

    Validates the tables, looks up the kernel and the current stream once,
    and holds the tables for as long as it lives; each call ``step(pa, pb,
    real)`` checks the chunk's dtype, layout and length and is one launch
    of ``distance_tile_count_scatter`` on chunk ``(pa, pb)`` (int32,
    contiguous, on the tables' device; pairs past ``real`` ignored).  The
    caller keeps ``tiles``'s device current (``torch.cuda.device``) while
    it calls.  ``max_ctas`` is ``tile_pair_distance``'s.
    """

    __slots__ = ("_fn", "_tables", "_args", "_tail", "_stream", "_device")

    def __init__(self, counts_sorted, skipped_tot, tiles, tile_len, tile_start, eps, *, dim_block, shortc,
                 num_dims=None, max_ctas=0):
        n = check_step_tables("CountScatter", tiles, tile_len, tile_start, dim_block, num_dims,
                              skipped_tot=skipped_tot, counts_sorted=counts_sorted)
        self._fn = _build.function("distance_tile_counts", "distance_tile_count_scatter")
        # the kernel keeps raw pointers: the tensors live as long as the step
        self._tables = (tiles, tile_len, tile_start, counts_sorted, skipped_tot)
        self._args = (tiles.data_ptr(), tile_len.data_ptr(), tile_start.data_ptr())
        self._tail = (tiles.shape[1], tiles.shape[2], n, dim_block, eps_squared(eps),
                      counts_sorted.data_ptr(), counts_sorted.shape[0] - 1, skipped_tot.data_ptr(),
                      int(bool(shortc)), int(max_ctas))
        self._stream = torch.cuda.current_stream(tiles.device).cuda_stream
        self._device = tiles.device

    def __call__(self, pa, pb, real) -> None:
        check_chunk(pa, pb, real, self._device)
        if real == 0:
            return
        err = self._fn(*self._args, pa.data_ptr(), pb.data_ptr(), real, *self._tail, self._stream)
        if err != 0:
            raise RuntimeError(f"distance_tile_count_scatter: CUDA launch failed with cudaError {err}")
        LAUNCHES["tile_pair_count_scatter"] += 1


def tile_pair_count_scatter(counts_sorted, skipped_tot, tiles, tile_len, tile_start, pa, pb, real, eps,
                            *, dim_block, shortc, num_dims=None):
    """One indexed count chunk, in place (K1 + the count scatter).

    ``counts_sorted (N + 1,) int32`` (row ``N`` a sink), ``skipped_tot ()
    int32``, the tile tables, a padded chunk ``pa, pb (C,) int32`` of which
    the first ``real`` pairs count.  On CUDA one launch of the fused kernel;
    on the CPU ``tile_pair_count_scatter_plain``.
    """
    if _route(tiles.device, False) == "plain":
        return tile_pair_count_scatter_plain(
            counts_sorted, skipped_tot, tiles, tile_len, tile_start, pa, pb, real, eps,
            dim_block=dim_block, shortc=shortc, num_dims=num_dims)
    _build.check_tile_args(tiles, tile_len, pa, pb)
    with torch.cuda.device(tiles.device):
        CountScatter(counts_sorted, skipped_tot, tiles, tile_len, tile_start, eps,
                     dim_block=dim_block, shortc=shortc, num_dims=num_dims)(pa, pb, real)


# ---------------------------------------------------------------------------
# The indexed pairs chunk step.
# ---------------------------------------------------------------------------


def write_ranked_hits(buf, offset, max_chunk_hits, counts, mask, tile_start, point_order, pa, pb, real, *,
                      hit_cap) -> None:
    """The ordered write of a fused pairs step, in plain PyTorch, in place,
    from an evaluated chunk's row counts ``(C, T)`` and hit mask ``(C, T,
    T)``: each pair's hit total, their exclusive scan, and every hit written
    at ``min(offset, cap) + base[p] + (its index among pair p's hits in
    row-major order)`` where that rank is below ``hit_cap``; then ``offset
    += hits``, ``max_chunk_hits = max(max_chunk_hits, hits)``.  Rows of
    ``buf`` no hit lands on are left as they were."""
    t = mask.shape[1]
    cap = buf.shape[0] - hit_cap
    pair_hits = counts[:real].sum(1, dtype=torch.int32)
    base = torch.cumsum(pair_hits, 0, dtype=torch.int32) - pair_hits      # exclusive
    hits = mask[:real].reshape(real, t * t).bool()
    p_, flat = hits.nonzero(as_tuple=True)                                 # row-major (p, i, j) order
    within = torch.cumsum(hits, 1, dtype=torch.int32)[p_, flat] - 1        # rank inside the pair
    rank = base[p_] + within
    land = rank < hit_cap
    p_, flat, rank = p_[land], flat[land], rank[land].long()
    rows_a = tile_start[pa[p_].long()].long() + flat // t
    rows_b = tile_start[pb[p_].long()].long() + flat % t
    block = torch.stack([point_order[rows_a], point_order[rows_b]], dim=1)
    woff = torch.clamp(offset, max=cap).long()
    buf.index_copy_(0, woff + rank, block)
    nh = pair_hits.sum(dtype=torch.int32)
    offset += nh
    torch.maximum(max_chunk_hits, nh, out=max_chunk_hits)


def tile_pair_pairs_compact_plain(buf, offset, max_chunk_hits, tiles, tile_len, tile_start, point_order, pa, pb,
                                  real, eps, *, hit_cap, dim_block, num_dims=None):
    """Plain version of the indexed pairs chunk step, in place, by the fused
    kernel's own algorithm: ``tile_pair_distance_plain`` (with SHORTC) for
    the row counts and the mask, then ``write_ranked_hits``.  ``buf[:offset]``
    equals the reference's rank-select (``engine.pairs_chunk_step``) row
    for row; the tests and the smoke run use it, the engine never does."""
    counts, _, mask = tile_pair_distance_plain(tiles, tile_len, pa, pb, eps=eps, dim_block=dim_block,
                                               return_mask=True, num_dims=num_dims)
    write_ranked_hits(buf, offset, max_chunk_hits, counts, mask, tile_start, point_order, pa, pb, real,
                      hit_cap=hit_cap)


class PairsCompact:
    """The indexed pairs chunk step bound to one pass's state on the card.

    ``buf (cap + hit_cap, 2) int32``, ``offset`` and ``max_chunk_hits`` (one
    int32 each) are the pass's running state, as in
    ``engine.pairs_chunk_step``; ``tile_start`` and ``point_order`` may be
    any position tables the tiles index (the self-join's, or combined query
    | data tables); ``chunk`` is the longest chunk the pass will give (the
    scratch of pass 1 -> pass 2 is sized for it).  Each ``step(pa, pb,
    real)`` is two launches of ``distance_tile_pairs_compact``
    (``csrc/distance_tile_counts.cu`` epilogue (c)): the chunk's hits of
    rank below ``hit_cap`` land in ``buf`` at ``min(offset, cap)`` in the
    reference's order, and ``offset`` / ``max_chunk_hits`` move on the
    device.  The caller keeps ``tiles``'s device current while it calls.
    """

    __slots__ = ("_fn", "_tables", "_args", "_tail", "_stream", "_device", "_chunk")
    _SOURCE = ("distance_tile_counts", "distance_tile_pairs_compact")
    _LAUNCHES, _KEY = LAUNCHES, "tile_pair_pairs_compact"

    def __init__(self, buf, offset, max_chunk_hits, tiles, tile_len, tile_start, point_order, eps, *, hit_cap,
                 chunk, dim_block, num_dims=None, max_ctas=0):
        if buf.dim() != 2 or buf.shape[1] != 2 or not 1 <= hit_cap <= buf.shape[0] or buf.data_ptr() % 8:
            raise ValueError(f"buf must be (cap + hit_cap, 2) with hit_cap={hit_cap} >= 1, got {tuple(buf.shape)}")
        if chunk < 1:
            raise ValueError(f"chunk must be positive, got {chunk}")
        n = check_step_tables(type(self).__name__, tiles, tile_len, tile_start, dim_block, num_dims,
                              buf=buf, offset=offset, max_chunk_hits=max_chunk_hits, point_order=point_order)
        t = tiles.shape[1]
        scratch = torch.empty(1 + chunk + chunk * t, dtype=torch.int32, device=tiles.device)
        self._fn = _build.function(*self._SOURCE)
        # the kernel keeps raw pointers: the tensors live as long as the step
        self._tables = (tiles, tile_len, tile_start, point_order, buf, offset, max_chunk_hits, scratch)
        self._args = (tiles.data_ptr(), tile_len.data_ptr(), tile_start.data_ptr(), point_order.data_ptr())
        self._tail = (t, tiles.shape[2], n, dim_block, eps_squared(eps), buf.data_ptr(),
                      buf.shape[0] - hit_cap, int(hit_cap), offset.data_ptr(), max_chunk_hits.data_ptr(),
                      scratch.data_ptr(), int(max_ctas))
        self._stream = torch.cuda.current_stream(tiles.device).cuda_stream
        self._device = tiles.device
        self._chunk = chunk

    def __call__(self, pa, pb, real) -> None:
        check_chunk(pa, pb, real, self._device, self._chunk)
        if real == 0:
            return
        err = self._fn(*self._args, pa.data_ptr(), pb.data_ptr(), real, *self._tail, self._stream)
        if err != 0:
            raise RuntimeError(f"{self._SOURCE[1]}: CUDA launch failed with cudaError {err}")
        self._LAUNCHES[self._KEY] += 2
