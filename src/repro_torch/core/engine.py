"""Device-resident self-join engine (DESIGN.md #1.5, #10), PyTorch port.

The port of ``repro.core.engine`` for the self-join path.  Index
construction (REORDER, grid build, tile-pair planning) runs on the host, as
in the paper; everything downstream runs on the snapshot's device:

  tiling       -- ``ops.make_tiles_device``: one gather on the device;
  evaluation   -- the tile kernels (K1/K2 indexed with SHORTC, K3/K4
                  dense), eps a runtime argument;
  count scatter-- per-point counts accumulate into the grid-sorted counts
                  vector, in place: on the card K1 (indexed) and K3 (dense)
                  scatter them themselves, one launch per chunk; the CPU
                  uses ``index_add_``;
  pairs        -- compaction of the hits into a preallocated buffer, in
                  place, with the exact overflow accounting of the JAX
                  package: on the card K2 (indexed) and K4 (dense) write
                  them themselves, in the reference's order (two launches
                  per chunk, no mask in device memory); the CPU runs the
                  reference's rank-select over the hit mask.

The candidate tile-pair list runs in fixed-size zero-padded chunks of the
same sizes as in the JAX package, so chunk counts, dispatch counts, the
``hit_cap`` window and the retry ladder match it step for step.  The chunk
loop reads nothing back from the device until a pass ends.

The bipartite query plan (``prepare_query`` / ``count_query``, DESIGN.md
#8) runs the same chunk steps over combined (query | data) tables: query
tiles first, then the snapshot's data tiles, with the data side's
positions offset by the query slots, so the fused kernels on the card take
them as they take the self-join's tables.

``repro_torch.core.selfjoin.self_join`` is a thin wrapper over this class.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import batching as batching_mod
from repro_torch.core import cost as cost_mod
from repro_torch.core.grid import (
    GridIndex,
    QueryTilePlan,
    TilePlan,
    build_query_tile_plan,
    pad_axis0,
)
from repro_torch.core.reorder import apply_reorder
from repro_torch.core.snapshot import Chunk, GridSnapshot, _chunk_list
from repro_torch.core.types import (
    EngineConfig,
    SelfJoinConfig,
    SelfJoinResult,
    SelfJoinStats,
)
from repro_torch.kernels import dense_tile, distance_tile, ops

_MAX_AUTO_GROW = 8  # doublings before giving up on an auto-sized buffer


# ---------------------------------------------------------------------------
# Device steps.  Where the JAX code returned rebuilt arrays, these update the
# running state (counts vector, pairs buffer, scalars) in place.
# ---------------------------------------------------------------------------


def count_chunk_step(
    counts_sorted,  # (N + 1,) int32 running per-point counts, grid-sorted; row N is a sink
    skipped_tot,    # ()  int32 running SHORTC skipped-block total
    tiles,          # (num_tiles, T, n_pad) f32
    tile_len,       # (num_tiles,) int32
    tile_start,     # (num_tiles,) int32
    pa, pb,         # (C,) int32 padded chunk of the candidate pair list
    real,           # int: valid prefix of the chunk
    eps,            # float search radius
    *,
    dim_block, shortc, backend, num_dims=None,
) -> None:
    """One counts-mode chunk: evaluate + scatter-add, in place.

    The indexed tier (``"pallas"`` / ``"jnp"``) is one call of
    ``distance_tile.tile_pair_count_scatter``, the dense tier one of
    ``dense_tile.dense_count_scatter`` (which adds no skipped blocks): on
    the card each is one launch that scatters its own counts; on the CPU
    the plain version, whose ``index_add_`` takes the place of
    ``counts.at[idx].add(..., mode="drop")`` of the JAX package, invalid
    lanes adding 0 to the sink row ``N``.
    """
    if backend in ("pallas", "jnp"):
        distance_tile.tile_pair_count_scatter(
            counts_sorted, skipped_tot, tiles, tile_len, tile_start, pa, pb, real, eps,
            dim_block=dim_block, shortc=shortc, num_dims=num_dims,
        )
        return
    if backend not in ("dense", "dense_jnp"):
        raise ValueError(f"unknown backend {backend!r}; expected one of {ops.BACKENDS}")
    dense_tile.dense_count_scatter(
        counts_sorted, tiles, tile_len, tile_start, pa, pb, real, eps, dim_block=dim_block, num_dims=num_dims,
    )


def count_step(
    counts_sorted, skipped_tot, tiles, tile_len, tile_start, eps,
    *, dim_block, shortc, backend, num_dims=None,
) -> Callable[[torch.Tensor, torch.Tensor, int], None]:
    """``step(pa, pb, real)``: the count chunk step bound to one pass's
    state, the engine's one entry to it.

    On the card each tier binds its fused kernel once (a
    ``distance_tile.CountScatter`` indexed, a ``dense_tile.DenseCountScatter``
    dense: tables checked, kernel and stream looked up), so a chunk costs
    one launch and no other host work; the caller keeps the tables' device
    current.  The CPU calls ``count_chunk_step``.  Reads only the backend
    and the device.
    """
    if tiles.device.type == "cuda":
        if backend in ("pallas", "jnp"):
            return distance_tile.CountScatter(
                counts_sorted, skipped_tot, tiles, tile_len, tile_start, eps,
                dim_block=dim_block, shortc=shortc, num_dims=num_dims,
            )
        if backend in ("dense", "dense_jnp"):
            return dense_tile.DenseCountScatter(
                counts_sorted, tiles, tile_len, tile_start, eps, dim_block=dim_block, num_dims=num_dims,
            )

    def step(pa, pb, real):
        count_chunk_step(
            counts_sorted, skipped_tot, tiles, tile_len, tile_start, pa, pb, real, eps,
            dim_block=dim_block, shortc=shortc, backend=backend, num_dims=num_dims,
        )

    return step


def pairs_chunk_step(
    buf,            # (cap + hit_cap, 2) int32 result buffer, original ids
    offset,         # ()  int32 pairs found so far (may exceed cap)
    max_chunk_hits, # ()  int32 largest per-chunk hit count seen
    tiles, tile_len, tile_start,
    point_order,    # (N,) int32 grid-sorted -> original id
    pa, pb, real, eps,
    *,
    hit_cap, dim_block, backend,
) -> None:
    """One pairs-mode chunk: evaluate + compact into ``buf``, in place.

    Rank-select compaction, as in the JAX package: a row-wise prefix sum
    over the hit mask gives every hit its global rank; ``searchsorted``
    (left side) recovers the flat positions of ranks 1..hit_cap, and the
    gathered (a, b) rows land in ``buf`` as one block of ``hit_cap`` rows at
    ``min(offset, cap)``.  The JAX code's ``dynamic_update_slice`` becomes
    an ``index_copy_`` at rows ``woff + arange(hit_cap)``, which keeps the
    offset on the device (a Python slice would read it back every chunk);
    the block always fits, since ``buf`` has ``cap + hit_cap`` rows.  Ranks
    past the chunk's true hit count select clamped garbage that the next
    block (or the final slice) overwrites.  ``offset`` advances by the exact
    hit count, and ``max_chunk_hits`` tells the host when one chunk outgrew
    the rank window.
    """
    _, _, mask = ops.eval_tile_pairs(
        tiles, tile_len, pa, pb, eps,
        dim_block=dim_block, shortc=True, backend=backend, return_mask=True,
    )
    compact_mask(buf, offset, max_chunk_hits, mask, tile_start, point_order, pa, pb, real, hit_cap=hit_cap)


def compact_mask(buf, offset, max_chunk_hits, mask, tile_start, point_order, pa, pb, real, *, hit_cap) -> None:
    """``pairs_chunk_step``'s compaction of an evaluated chunk's hit mask
    ``(C, T, T) int8`` into ``buf``, in place (the rank-select above)."""
    t = mask.shape[1]
    c = pa.shape[0]
    dev = buf.device
    cap = buf.shape[0] - hit_cap

    pair_valid = torch.arange(c, device=dev) < real
    hits = (mask.bool() & pair_valid[:, None, None]).reshape(c, t * t).to(torch.int32)
    row_cum = torch.cumsum(hits, dim=1, dtype=torch.int32)   # C independent prefix sums
    row_tot = row_cum[:, -1]
    base = torch.cumsum(row_tot, dim=0, dtype=torch.int32) - row_tot  # (C,) exclusive
    cum = (row_cum + base[:, None]).reshape(-1)               # global inclusive ranks
    nh = row_tot.sum(dtype=torch.int32)
    ranks = torch.arange(1, hit_cap + 1, dtype=torch.int32, device=dev)
    hit_idx = torch.searchsorted(cum, ranks).clamp_(max=c * t * t - 1)
    p_ = hit_idx // (t * t)
    i_ = (hit_idx // t) % t
    j_ = hit_idx % t
    # garbage ranks may point past a tail tile; clamp as the JAX gather does
    last = point_order.shape[0] - 1
    a_orig = point_order[(tile_start[pa[p_].long()].long() + i_).clamp_(max=last)]
    b_orig = point_order[(tile_start[pb[p_].long()].long() + j_).clamp_(max=last)]
    block = torch.stack([a_orig, b_orig], dim=1)             # (hit_cap, 2)
    woff = torch.clamp(offset, max=cap).long()  # post-overflow blocks land in padding
    buf.index_copy_(0, woff + torch.arange(hit_cap, device=dev), block)

    offset += nh
    torch.maximum(max_chunk_hits, nh, out=max_chunk_hits)


def pairs_step(
    buf, offset, max_chunk_hits, tiles, tile_len, tile_start, point_order, eps,
    *, hit_cap, dim_block, backend, chunk, num_dims=None,
) -> Callable[[torch.Tensor, torch.Tensor, int], None]:
    """``step(pa, pb, real)``: the pairs chunk step bound to one pass's
    state (``buf``, ``offset``, ``max_chunk_hits`` at ``hit_cap``), the
    engine's one entry to it.

    On the card each tier binds its fused kernel once for chunks of up to
    ``chunk`` pairs (a ``distance_tile.PairsCompact`` indexed, a
    ``dense_tile.DensePairsCompact`` dense): a chunk costs two launches,
    which write its hits into ``buf`` in the reference's order with no
    mask in device memory.  ``tile_start`` / ``point_order`` are whatever
    position tables the tiles index (the self-join's, or combined query |
    data tables).  The CPU calls ``pairs_chunk_step``.  Reads only the
    backend and the device.
    """
    if tiles.device.type == "cuda" and backend in ops.BACKENDS:
        bound = distance_tile.PairsCompact if backend in ("pallas", "jnp") else dense_tile.DensePairsCompact
        return bound(
            buf, offset, max_chunk_hits, tiles, tile_len, tile_start, point_order, eps,
            hit_cap=hit_cap, chunk=chunk, dim_block=dim_block, num_dims=num_dims,
        )

    def step(pa, pb, real):
        pairs_chunk_step(
            buf, offset, max_chunk_hits, tiles, tile_len, tile_start, point_order, pa, pb, real, eps,
            hit_cap=hit_cap, dim_block=dim_block, backend=backend,
        )

    return step


def _unsort_counts(counts_sorted, point_order):
    """Grid-sorted counts -> original point order (one device scatter)."""
    out = torch.empty_like(counts_sorted)
    out[point_order.long()] = counts_sorted
    return out


def on_card(dev: torch.device):
    """``torch.cuda.device(dev)`` on the card, a null context on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


# ---------------------------------------------------------------------------
# The bipartite query-plan API (DESIGN.md #8).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QueryPlanTables:
    """Device-ready combined (query | data) tables for one bipartite batch.

    Produced by ``SelfJoinEngine.prepare_query`` and consumed with one
    layout by ``SelfJoinEngine.count_query`` (the count chunk step) and by
    the serving tier (``repro_torch.join.QueryService``: the count *and*
    pairs chunk steps), with ``pad_queries_to`` rounding the query side up
    to a shape bucket so a request stream reuses a bounded set of
    workspaces.

    Layout contract (the JAX package's, array for array): positions ``[0,
    n_slots)`` are query rows in q-sorted order (real rows first, zero
    padding after), positions ``[n_slots, n_slots + point_rows)`` are the
    engine's grid-sorted data points padded to the snapshot's pow2
    ``point_rows`` bucket (pad positions are never referenced by a valid
    lane or pair list).  ``tile_start`` and ``order`` address that combined
    position space, so the *same* tensors serve counts mode (A-side scatter
    into an ``(n_slots + 1,)`` vector whose last row is the sink; B-side
    starts never read below ``n_slots``) and pairs mode (both sides decode
    through ``order`` to original query rows / data ids).
    """

    eps: float                     # radius the plan was built for
    nq: int                        # real query rows
    n_slots: int                   # padded query-position space (>= nq)
    qplan: QueryTilePlan           # the host-side plan (stats + q_order live here)
    tiles: torch.Tensor            # (q_tile_rows + d_tile_rows, T, n_pad) f32
    tile_len: torch.Tensor         # (q_tile_rows + d_tile_rows,) int32
    tile_start: torch.Tensor       # combined position space (B side + n_slots)
    order: torch.Tensor            # (n_slots + point_rows,) int32 position -> id
    pair_a: np.ndarray             # (P,) int32 combined-table A (query-tile) index
    pair_b: np.ndarray             # (P,) int32 combined-table B (data-tile) index
    execution: str = "indexed"     # tier the tables realize: "indexed" | "dense"
    cost_indexed: float = 0.0      # cost model's indexed-tier estimate
    cost_dense: float = 0.0        # cost model's dense-tier estimate
    num_candidates: int = 0        # point comparisons this tier will evaluate
    _chunk_cache: Dict[int, list] = dataclasses.field(default_factory=dict)

    @property
    def num_pairs(self) -> int:
        return int(self.pair_a.shape[0])

    def chunks(self, chunk: int) -> List[Chunk]:
        """Padded chunks of the candidate pair list on the tables' device,
        cached per chunk size."""
        return _chunk_list(self.pair_a, self.pair_b, chunk, self._chunk_cache, self.tiles.device)


# ---------------------------------------------------------------------------
# The engine.
# ---------------------------------------------------------------------------


class SelfJoinEngine:
    """Reusable device-resident self-join over one dataset snapshot.

    Builds a ``GridSnapshot`` once (at construction, for ``config.eps``) on
    ``device`` (default ``"cuda"``; without a card this raises unless
    ``device="cpu"`` is given).  ``count()`` / ``pairs()`` / ``query()``
    reuse the snapshot; querying a *larger* eps than the snapshot was built
    for swaps in a rebuilt snapshot (a smaller eps reuses it -- the
    candidate set is a superset, and the distance filter runs at the
    queried eps).

    ``eps == 0`` is supported (duplicates + self); the grid is then binned
    at unit width.  The fp32 matmul-form numerics (DESIGN.md #6) make
    exact-duplicate matches at eps near 0 a guarantee only on quantized
    coordinates (e.g. a 1/64 grid).
    """

    def __init__(
        self,
        d: np.ndarray,
        config: SelfJoinConfig,
        engine_config: Optional[EngineConfig] = None,
        *,
        device="cuda",
    ):
        self.config = config
        self.engine = engine_config or EngineConfig()
        with obs.span(
            "engine.snapshot_build", "plan", n=int(np.asarray(d).shape[0])
        ):
            self.snapshot = GridSnapshot.build(d, config, device=device)

    @classmethod
    def from_snapshot(
        cls,
        snapshot: GridSnapshot,
        engine_config: Optional[EngineConfig] = None,
    ) -> "SelfJoinEngine":
        """Engine over an existing snapshot (no host build at all)."""
        self = object.__new__(cls)
        self.config = snapshot.config
        self.engine = engine_config or EngineConfig()
        self.snapshot = snapshot
        return self

    @classmethod
    def from_prebuilt(
        cls,
        pts: np.ndarray,
        perm: Optional[np.ndarray],
        grid: Optional[GridIndex],
        plan: Optional[TilePlan],
        index_eps: Optional[float],
        config: SelfJoinConfig,
        engine_config: Optional[EngineConfig] = None,
        *,
        device="cuda",
    ) -> "SelfJoinEngine":
        """Engine over an already-built index: no REORDER, no grid build.

        The persistence path of ``repro_torch.join.SimilarityIndex``: a
        server restart loads the saved (perm, grid, plan) triple and only the
        device placement runs again, so the restarted engine serves as the
        one that was saved did.
        """
        return cls.from_snapshot(
            GridSnapshot.from_arrays(pts, perm, grid, plan, index_eps, config, device=device),
            engine_config,
        )

    # -- snapshot management ----------------------------------------------

    def swap_snapshot(self, snapshot: GridSnapshot) -> None:
        """Replace the data snapshot behind the engine (one assignment)."""
        if snapshot.config != self.config:
            raise ValueError(
                "snapshot was built under a different SelfJoinConfig"
            )
        self.snapshot = snapshot

    def snapshot_for(self, eps: float) -> GridSnapshot:
        """A snapshot whose index covers ``eps``, WITHOUT swapping."""
        snap = self.snapshot
        if snap.num_points == 0 or (
            snap.index_eps is not None and eps <= snap.index_eps
        ):
            return snap
        with obs.span(
            "engine.snapshot_rebuild", "plan",
            eps=eps, n=snap.num_points, pinned=True,
        ):
            return snap.rebuilt(eps)

    def _ensure_index(self, eps: float) -> None:
        snap = self.snapshot
        if snap.num_points == 0:
            return
        if snap.index_eps is None or eps > snap.index_eps:
            with obs.span(
                "engine.snapshot_rebuild", "plan", eps=eps, n=snap.num_points
            ):
                self.swap_snapshot(snap.rebuilt(eps))

    # -- delegating views ---------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.snapshot.device

    @property
    def num_points(self) -> int:
        return self.snapshot.num_points

    @property
    def num_dims(self) -> int:
        return self.snapshot.num_dims

    @property
    def grid(self) -> Optional[GridIndex]:
        return self.snapshot.grid

    @property
    def plan(self) -> Optional[TilePlan]:
        return self.snapshot.plan

    @property
    def n_pad(self) -> int:
        """Padded dimension count of the tile layout (n -> dim_block multiple)."""
        return self.snapshot.n_pad

    # read-only aliases of the snapshot's fields, as the reference engine has

    @property
    def _pts(self) -> np.ndarray:
        return self.snapshot.pts

    @property
    def _perm(self) -> Optional[np.ndarray]:
        return self.snapshot.perm

    @property
    def _index_eps(self) -> Optional[float]:
        return self.snapshot.index_eps

    @property
    def _tiles(self) -> torch.Tensor:
        return self.snapshot.tiles

    @property
    def _tile_len(self) -> torch.Tensor:
        return self.snapshot.tile_len

    @property
    def _tile_start(self) -> torch.Tensor:
        return self.snapshot.tile_start

    @property
    def _point_order(self) -> torch.Tensor:
        return self.snapshot.point_order

    @property
    def _num_dim_blocks(self) -> int:
        return self.snapshot.num_dim_blocks

    def resolve_execution(
        self, eps: Optional[float] = None,
        snapshot: Optional[GridSnapshot] = None,
    ) -> cost_mod.TierDecision:
        """Cost-model tier decision for a self-join at ``eps`` (DESIGN.md #9)."""
        eps = self.config.eps if eps is None else float(eps)
        cfg = self.config
        if snapshot is None:
            if self.num_points == 0:
                return cost_mod.decide(0.0, 0.0, cfg.execution)
            self._ensure_index(eps)
            snapshot = self.snapshot
        if snapshot.num_points == 0:
            return cost_mod.decide(0.0, 0.0, cfg.execution)
        ci = cost_mod.indexed_join_cost(
            snapshot.plan.num_pairs, snapshot.plan.num_candidates,
            cfg.tile_size, snapshot.n_pad,
        )
        cd = cost_mod.dense_join_cost(
            snapshot.num_points, snapshot.num_points,
            cfg.tile_size, snapshot.n_pad,
        )
        return cost_mod.decide(ci, cd, cfg.execution)

    def _base_stats(self, eps: float, snap: GridSnapshot) -> SelfJoinStats:
        stats = SelfJoinStats(
            num_points=snap.num_points,
            num_dims=snap.num_dims,
            k=min(self.config.k, snap.num_dims),
        )
        if snap.plan is not None:
            stats.num_nonempty_cells = snap.grid.num_cells
            stats.num_tiles = snap.plan.num_tiles
            stats.num_tile_pairs_total = snap.plan.num_tile_pairs_total
            stats.num_tile_pairs_evaluated = snap.plan.num_pairs
            stats.num_candidates = snap.plan.num_candidates
            stats.num_candidates_dense = snap.num_points * snap.num_points
        return stats

    @staticmethod
    def _record_decision(stats: SelfJoinStats, dec: cost_mod.TierDecision) -> None:
        stats.execution = dec.execution
        stats.cost_indexed = dec.cost_indexed
        stats.cost_dense = dec.cost_dense

    def build_query_plan(
        self,
        q_pts: np.ndarray,
        eps: Optional[float] = None,
        snapshot: Optional[GridSnapshot] = None,
    ) -> Optional[QueryTilePlan]:
        """Bipartite Q-tile x D-tile plan for ``q_pts`` against this index.

        ``q_pts`` is in ORIGINAL coordinates; the engine applies its own
        REORDER permutation.  With an explicit ``snapshot`` the plan is built
        against it (the serving tier's pinned epoch); otherwise the engine's
        resident snapshot is used, rebuilt if ``eps`` outgrows it.  Returns
        ``None`` when the snapshot indexes no points.
        """
        eps = self.config.eps if eps is None else float(eps)
        if snapshot is None:
            if self.num_points == 0:
                return None
            self._ensure_index(eps)
            snapshot = self.snapshot
        if snapshot.num_points == 0:
            return None
        q_work = (
            apply_reorder(q_pts, snapshot.perm)
            if snapshot.perm is not None else q_pts
        )
        with obs.span(
            "engine.build_query_plan", "plan",
            nq=int(q_work.shape[0]), eps=eps,
        ):
            return build_query_tile_plan(
                snapshot.grid, snapshot.plan, q_work, self.config.sortidu
            )

    def prepare_query(
        self,
        q_pts: np.ndarray,
        eps: Optional[float] = None,
        *,
        pad_queries_to: Optional[int] = None,
        snapshot: Optional[GridSnapshot] = None,
    ) -> Optional[QueryPlanTables]:
        """Build the combined (query | data) tables for ``q_pts`` on the
        snapshot's device.

        The query-plan API (DESIGN.md #8): everything between the host-side
        ``build_query_plan`` and the chunk steps -- the cost model's tier
        choice, query tiling on the device, the concatenated (Q | D) tile
        table, the combined position -> original-id map, and the B-side
        index offset -- shared by ``count_query`` and the serving tier.

        ``pad_queries_to`` rounds the *query side* of every table up to that
        many rows (q-sorted points, query tiles and the scatter target pad
        to the same bucket; padding tiles carry length 0 and padded
        positions are never referenced by a valid lane), so all batches in
        the same bucket present the same shapes.  The data side is padded by
        the snapshot's own pow2 buckets.  ``snapshot`` pins an explicit
        snapshot (no engine mutation); by default the resident one serves,
        rebuilt if ``eps`` outgrows it.  Returns ``None`` when either side
        is empty.
        """
        with obs.span(
            "engine.prepare_query", "plan", nq=int(np.asarray(q_pts).shape[0])
        ):
            return self._prepare_query_impl(
                q_pts, eps, pad_queries_to=pad_queries_to, snapshot=snapshot
            )

    def _prepare_query_impl(
        self,
        q_pts: np.ndarray,
        eps: Optional[float] = None,
        *,
        pad_queries_to: Optional[int] = None,
        snapshot: Optional[GridSnapshot] = None,
    ) -> Optional[QueryPlanTables]:
        eps = self.config.eps if eps is None else float(eps)
        q_pts = np.ascontiguousarray(np.asarray(q_pts, dtype=np.float32))
        nq = q_pts.shape[0]
        if snapshot is None:
            if nq == 0 or self.num_points == 0:
                return None
            self._ensure_index(eps)
            snapshot = self.snapshot
        snap = snapshot
        if nq == 0 or snap.num_points == 0:
            return None
        qplan = self.build_query_plan(q_pts, eps, snapshot=snap)
        cfg = self.config
        n_slots = nq if pad_queries_to is None else int(pad_queries_to)
        if n_slots < nq:
            raise ValueError(
                f"pad_queries_to={n_slots} smaller than the batch ({nq})"
            )
        # cost-model tier dispatch (DESIGN.md #9): the indexed estimate comes
        # from the grid probe that just ran, the dense estimate from the
        # batch shape alone.  Both tiers share q_sorted / q_order (the dense
        # tier only re-tiles the already-sorted rows sequentially).
        dec = cost_mod.decide(
            cost_mod.indexed_join_cost(
                qplan.num_pairs, qplan.num_candidates, cfg.tile_size,
                snap.n_pad,
            ),
            cost_mod.dense_join_cost(
                nq, snap.num_points, cfg.tile_size, snap.n_pad
            ),
            cfg.execution,
        )
        t = cfg.tile_size
        # every cell holds >= 1 point, so num_q_tiles <= nq <= n_slots: one
        # bucket dimension pads the q-sorted rows AND the q-tile rows
        qt_rows = n_slots
        if pad_queries_to is None:
            qt_rows = qplan.num_q_tiles if dec.execution == "indexed" else -(-nq // t)
        q_sorted = pad_axis0(qplan.q_sorted, n_slots)
        if dec.execution == "dense":
            dt = snap.dense_tables()
            q_start = (np.arange(qt_rows, dtype=np.int64) * t).astype(np.int32)
            q_len = np.clip(nq - q_start.astype(np.int64), 0, t).astype(np.int32)
            nqt = -(-nq // t)  # real (non-empty) query tiles
            pair_a = np.repeat(np.arange(nqt, dtype=np.int64), dt.plan.num_tiles)
            pair_d = np.tile(np.arange(dt.plan.num_tiles, dtype=np.int64), nqt)
            d_tiles, d_len, d_start = dt.tiles, dt.tile_len, dt.tile_start
            num_candidates = nq * snap.num_points
        else:
            q_start = pad_axis0(qplan.q_tile_start, qt_rows)
            q_len = pad_axis0(qplan.q_tile_len, qt_rows)
            pair_a = qplan.pair_q.astype(np.int64)
            pair_d = qplan.pair_d.astype(np.int64)
            d_tiles, d_len, d_start = snap.tiles, snap.tile_len, snap.tile_start
            num_candidates = qplan.num_candidates
        dev = snap.device
        q_start_t = torch.from_numpy(np.ascontiguousarray(q_start, np.int32)).to(dev)
        q_len_t = torch.from_numpy(np.ascontiguousarray(q_len, np.int32)).to(dev)
        q_tiles = ops.make_tiles_device(
            torch.from_numpy(q_sorted).to(dev), q_start_t, q_len_t,
            tile_size=cfg.tile_size, dim_block=cfg.dim_block,
        )
        tiles = torch.cat([q_tiles, d_tiles])
        tile_len = torch.cat([q_len_t, d_len])
        tile_start = torch.cat([q_start_t, d_start + n_slots])
        # position -> original id: query rows first (pad rows are never
        # addressed by a valid lane; their fill value is irrelevant), then
        # the data points' grid-sort permutation, padded to the snapshot's
        # point_rows bucket so the shape survives snapshot swaps
        q_order = pad_axis0(qplan.q_order, n_slots)
        order = torch.cat([
            torch.from_numpy(q_order.astype(np.int32)).to(dev),
            snap.point_order_padded,
        ])
        pair_b = (pair_d + qt_rows).astype(np.int32)
        return QueryPlanTables(
            eps=eps,
            nq=nq,
            n_slots=n_slots,
            qplan=qplan,
            tiles=tiles,
            tile_len=tile_len,
            tile_start=tile_start,
            order=order,
            pair_a=pair_a.astype(np.int32),
            pair_b=pair_b,
            execution=dec.execution,
            cost_indexed=dec.cost_indexed,
            cost_dense=dec.cost_dense,
            num_candidates=num_candidates,
        )

    def packed_tile_table(self, num_tiles: int):
        """Host tile table padded to ``num_tiles`` rows (delegates to the
        snapshot; kept for callers that hold only the engine)."""
        return self.snapshot.packed_tile_table(num_tiles)

    # -- queries ----------------------------------------------------------

    def _self_tables(self, dec: cost_mod.TierDecision, snap: GridSnapshot):
        """Device tables of the tier ``dec`` chose, one tuple for both modes.

        Returns ``(tiles, tile_len, tile_start, chunks_fn, plan, backend,
        shortc)``.  Both tiers address the same grid-sorted point space.
        """
        cfg = self.config
        if dec.execution == "dense":
            dt = snap.dense_tables()
            return (
                dt.tiles, dt.tile_len, dt.tile_start, dt.chunks, dt.plan,
                ops.backend_name("dense", cfg.use_pallas), False,
            )
        return (
            snap.tiles, snap.tile_len, snap.tile_start, snap.chunks,
            snap.plan, ops.backend_name("indexed", cfg.use_pallas), cfg.shortc,
        )

    def count(self, eps: Optional[float] = None) -> SelfJoinResult:
        """Per-point neighbour counts (original order); no pair buffer."""
        eps = self.config.eps if eps is None else float(eps)
        if self.num_points == 0:
            return SelfJoinResult(
                counts=np.zeros(0, np.int64),
                stats=self._base_stats(eps, self.snapshot),
            )
        self._ensure_index(eps)
        snap = self.snapshot
        cfg, eng = self.config, self.engine
        dec = self.resolve_execution(eps)
        tiles, tile_len, tile_start, chunks, plan, backend, shortc = (
            self._self_tables(dec, snap)
        )
        stats = self._base_stats(eps, snap)
        self._record_decision(stats, dec)
        if dec.execution == "dense":
            stats.num_tile_pairs_evaluated = plan.num_pairs
            stats.num_candidates = plan.num_candidates

        dev = snap.device
        counts_sorted = torch.zeros(snap.num_points + 1, dtype=torch.int32, device=dev)
        skipped_tot = torch.zeros((), dtype=torch.int32, device=dev)
        step = count_step(
            counts_sorted, skipped_tot, tiles, tile_len, tile_start, eps,
            dim_block=cfg.dim_block, shortc=shortc, backend=backend,
            num_dims=snap.num_dims,
        )
        with obs.span(
            "engine.count", "join",
            n=snap.num_points, eps=eps, tier=dec.execution,
        ), on_card(dev):
            n_chunks = obs.chunk_loop("engine.count.chunk", step, chunks(eng.count_chunk))
            stats.num_chunks += n_chunks
            stats.num_device_dispatches += n_chunks
            with obs.span("engine.count.readback", "copy"):
                counts = (
                    _unsort_counts(counts_sorted[:-1], snap.point_order)
                    .cpu().numpy().astype(np.int64)
                )
        stats.num_results = int(counts.sum())
        stats.dim_blocks_skipped = int(skipped_tot)
        stats.dim_blocks_total = plan.num_pairs * snap.num_dim_blocks
        obs.mirror_selfjoin_stats(stats, path="engine", mode="count")
        return SelfJoinResult(counts=counts, stats=stats)

    def count_query(
        self,
        q: np.ndarray,
        eps: Optional[float] = None,
        snapshot: Optional[GridSnapshot] = None,
    ) -> SelfJoinResult:
        """Per-query-point counts of indexed points within eps of each q.

        External query points are binned into this engine's grid, tiled,
        and each (query tile, adjacent data tile) candidate pair runs
        through the same count chunk step as the self-join (on the card, one
        launch of the tier's fused count kernel per chunk) -- index
        filtering, SHORTC and SORTIDU included.  ``q`` is given in ORIGINAL
        coordinates; counts come back in ``q``'s row order.  Querying the
        engine's own dataset equals ``count()``:
        ``count_query(d).counts == count().counts``.
        """
        eps = self.config.eps if eps is None else float(eps)
        q_pts = np.ascontiguousarray(np.asarray(q, dtype=np.float32))
        nq = q_pts.shape[0]
        cfg, eng = self.config, self.engine
        tab = self.prepare_query(q_pts, eps, snapshot=snapshot)
        snap = snapshot if snapshot is not None else self.snapshot
        if tab is None:
            return SelfJoinResult(
                counts=np.zeros(nq, np.int64),
                stats=self._base_stats(eps, snap),
            )
        qplan = tab.qplan

        stats = self._base_stats(eps, snap)
        stats.num_points = nq
        stats.num_tile_pairs_total = qplan.num_tile_pairs_total
        stats.num_tile_pairs_evaluated = tab.num_pairs
        stats.num_candidates = tab.num_candidates
        stats.num_candidates_dense = nq * snap.num_points
        stats.num_tiles = int(tab.tiles.shape[0])
        stats.execution = tab.execution
        stats.cost_indexed = tab.cost_indexed
        stats.cost_dense = tab.cost_dense
        backend = ops.backend_name(tab.execution, cfg.use_pallas)
        shortc = cfg.shortc and tab.execution == "indexed"

        dev = snap.device
        # the query slots and the sink row (the scatter drops rows >= n_slots)
        counts_sorted = torch.zeros(tab.n_slots + 1, dtype=torch.int32, device=dev)
        skipped_tot = torch.zeros((), dtype=torch.int32, device=dev)
        step = count_step(
            counts_sorted, skipped_tot, tab.tiles, tab.tile_len, tab.tile_start, eps,
            dim_block=cfg.dim_block, shortc=shortc, backend=backend,
            num_dims=snap.num_dims,
        )
        with obs.span(
            "engine.count_query", "join",
            nq=nq, eps=eps, tier=tab.execution,
        ), on_card(dev):
            n_chunks = obs.chunk_loop("engine.count.chunk", step, tab.chunks(eng.count_chunk))
            stats.num_chunks += n_chunks
            stats.num_device_dispatches += n_chunks
            with obs.span("engine.count.readback", "copy"):
                q_order = torch.from_numpy(qplan.q_order).to(dev)
                counts = (
                    _unsort_counts(counts_sorted[:nq], q_order)
                    .cpu().numpy().astype(np.int64)
                )
        stats.num_results = int(counts.sum())
        stats.dim_blocks_skipped = int(skipped_tot)
        stats.dim_blocks_total = tab.num_pairs * snap.num_dim_blocks
        obs.mirror_selfjoin_stats(stats, path="engine", mode="count_query")
        return SelfJoinResult(counts=counts, stats=stats)

    def pairs(
        self,
        eps: Optional[float] = None,
        max_pairs: Optional[int] = None,
        _cap_hint: Optional[int] = None,
    ) -> SelfJoinResult:
        """Counts plus the materialized (a, b) pair list, original ids.

        With an explicit ``max_pairs`` (here or in ``EngineConfig``),
        overflow raises ``RuntimeError``.  Otherwise the buffer is sized
        from the paper's result-size estimate (Sec. 3.2.2); on overflow the
        exact |R| is known after the pass, so the buffer regrows to it in a
        single retry.  ``_cap_hint`` lets ``query()`` supply one shared
        auto-mode capacity for a whole eps sweep.
        """
        eps = self.config.eps if eps is None else float(eps)
        if self.num_points == 0:
            return SelfJoinResult(
                counts=np.zeros(0, np.int64),
                stats=self._base_stats(eps, self.snapshot),
                pairs=np.zeros((0, 2), np.int32),
            )
        self._ensure_index(eps)
        snap = self.snapshot
        cfg, eng = self.config, self.engine
        dec = self.resolve_execution(eps)
        tiles, tile_len, tile_start, chunks, plan, backend, _ = (
            self._self_tables(dec, snap)
        )

        explicit = max_pairs if max_pairs is not None else eng.max_pairs
        auto = explicit is None
        if not auto:
            cap = int(explicit)
        elif _cap_hint is not None:
            cap = int(_cap_hint)
        else:
            cap = self._auto_capacity(eps, dec)
        t = cfg.tile_size
        flat_per_chunk = eng.pairs_chunk * t * t
        hit_cap = min(flat_per_chunk, 4096)

        dev = snap.device
        retries = 0
        dispatches = 0
        while True:
            stats = self._base_stats(eps, snap)
            self._record_decision(stats, dec)
            if dec.execution == "dense":
                stats.num_tile_pairs_evaluated = plan.num_pairs
                stats.num_candidates = plan.num_candidates
            buf = torch.zeros((cap + hit_cap, 2), dtype=torch.int32, device=dev)
            offset = torch.zeros((), dtype=torch.int32, device=dev)
            max_hits = torch.zeros((), dtype=torch.int32, device=dev)
            step = pairs_step(
                buf, offset, max_hits, tiles, tile_len, tile_start, snap.point_order, eps,
                hit_cap=hit_cap, dim_block=cfg.dim_block, backend=backend,
                chunk=eng.pairs_chunk, num_dims=snap.num_dims,
            )
            with obs.span(
                "engine.pairs", "join",
                n=snap.num_points, eps=eps, tier=dec.execution,
                attempt=retries,
            ), on_card(dev):
                n_chunks = obs.chunk_loop("engine.pairs.chunk", step, chunks(eng.pairs_chunk))
                stats.num_chunks += n_chunks
                dispatches += n_chunks
                num = int(offset)
            # exact totals are known after a full pass, so each overflow kind
            # resolves in one retry: widen the per-chunk rank window first,
            # then (auto mode) regrow the buffer to the true |R|.
            if int(max_hits) > hit_cap and retries < _MAX_AUTO_GROW:
                obs.event(
                    "engine.pairs.retry", "retry", kind="hit_cap",
                    max_hits=int(max_hits), hit_cap=hit_cap,
                )
                hit_cap = min(flat_per_chunk, -(-int(max_hits) // 1024) * 1024)
                retries += 1
                continue
            if num > cap:
                if auto and eng.auto_grow and retries < _MAX_AUTO_GROW:
                    obs.event(
                        "engine.pairs.retry", "retry", kind="capacity",
                        num=num, cap=cap,
                    )
                    cap = batching_mod.suggest_pairs_capacity(num, 1.0)
                    retries += 1
                    continue
                raise RuntimeError(
                    f"result exceeded max_pairs={cap}; raise the cap or "
                    f"lower eps"
                )
            break

        with obs.span("engine.pairs.readback", "copy", num=num):
            found = buf[:num]
            pairs = found.cpu().numpy()
            counts = (
                torch.bincount(found[:, 0].long(), minlength=snap.num_points)
                .cpu().numpy().astype(np.int64)
            )
        stats.num_results = int(counts.sum())
        stats.dim_blocks_total = plan.num_pairs * snap.num_dim_blocks
        stats.pairs_capacity = cap
        stats.overflow_retries = retries
        stats.num_device_dispatches = dispatches
        obs.mirror_selfjoin_stats(stats, path="engine", mode="pairs")
        return SelfJoinResult(counts=counts, stats=stats, pairs=pairs)

    def _auto_capacity(self, eps: float, dec: cost_mod.TierDecision) -> int:
        """Auto-mode pairs-buffer capacity from the paper's |R| estimate.

        The estimate samples the *chosen* tier's candidate pair list with
        that tier's kernel, so the capacity reflects the tables that will
        actually run.
        """
        cfg, eng = self.config, self.engine
        tiles, tile_len, _, _, plan, backend, _ = self._self_tables(
            dec, self.snapshot
        )
        est = batching_mod.estimate_result_size(
            tiles, tile_len, plan, eps=eps,
            dim_block=cfg.dim_block, backend=backend,
            sample_frac=cfg.sample_frac, num_dims=self.snapshot.num_dims,
        )
        return batching_mod.suggest_pairs_capacity(est, eng.pairs_headroom)

    def query(
        self,
        eps_values: Sequence[float],
        return_pairs: bool = False,
        max_pairs: Optional[int] = None,
    ) -> List[SelfJoinResult]:
        """Multi-eps sweep over one snapshot.

        The snapshot is built once at ``max(eps_values)``; in auto-sized
        pairs mode the result-size estimate also runs once, at the largest
        eps -- its capacity bounds every smaller sweep point.
        """
        eps_list = [float(e) for e in eps_values]
        if eps_list and self.num_points:
            self._ensure_index(max(eps_list))
        if return_pairs:
            cap_hint = None
            explicit = max_pairs if max_pairs is not None else self.engine.max_pairs
            if explicit is None and eps_list and self.num_points:
                dec = self.resolve_execution(max(eps_list))
                cap_hint = self._auto_capacity(max(eps_list), dec)
            return [
                self.pairs(e, max_pairs=max_pairs, _cap_hint=cap_hint)
                for e in eps_list
            ]
        return [self.count(e) for e in eps_list]
