"""Batched online query serving over a ``SimilarityIndex`` (DESIGN.md #8, #10).

The port of ``repro.join.service``: the same requests, the same bucketing,
retry ladder, churn epilogue and kNN expansion, and the same answers and
``ServiceStats``, run on the index's ``torch.device``.  On the card each
chunk loop binds the engine's chunk step once per pass, so a count chunk is
one launch of the tier's fused count kernel and a pairs chunk two launches
of its fused pairs kernel, over the combined (query | data) tables.

``QueryService`` answers three request kinds against one resident index:

  ``range_count(q, eps)``  per-query counts of live points within eps;
  ``range_pairs(q, eps)``  the materialized (query row, global id) pairs;
  ``knn(q, k)``            k nearest live points per query, found by
                           adaptive eps expansion on the count program
                           (double the radius until every query holds >= k
                           candidates, then one pairs pass + exact top-k).

Epoch pinning (DESIGN.md #10): every request pins an ``IndexView`` at
entry -- the engine's frozen ``GridSnapshot`` plus the churn state (delta
buffer, tombstones) of that instant -- and serves entirely from it, so a
concurrent ``compact()`` swap lands without tearing a request and without
touching its answers.  A radius above the pinned snapshot's build radius
serves from a TEMPORARY rebuilt snapshot (``GridSnapshot.rebuilt``,
counted in ``stats.index_rebuilds``) that is dropped at request end; the
resident snapshot -- and every warm executable keyed to its shape buckets
-- is never disturbed.  This replaces the old grid-restore special case.

Mutable-index epilogue: the snapshot pass answers for the snapshot's
points; a small dense bipartite pass (plain PyTorch over pow2-padded
delta/tombstone tables) then SUBTRACTS tombstoned matches and ADDS
delta-buffer matches, so counts, pairs, and kNN always reflect the live
set = snapshot 'minus' tombstones 'plus' inserts.  Pair results carry GLOBAL
ids (stable across compactions).

Shape discipline -- the property that makes this a *service* rather than a
loop of one-shot joins: request batches are padded to power-of-two shape
buckets (``SelfJoinEngine.prepare_query(pad_queries_to=...)``), the
snapshot's data-side tables are padded to its own pow2 row buckets, and eps
is a runtime argument, so an arbitrary request stream presents a bounded
set of shapes.  The service records, for each of its three programs
(count, pairs, aux), the shape keys it has run -- keyed exactly as the JAX
package's ``jax.jit`` keys its three programs (input shapes and static
arguments).  A *trace* is the first request of a key:
``ServiceStats.num_traces`` counts them per request (the JAX package counts
its traces, and the two agree request for request), and a snapshot swap of
unchanged buckets adds ZERO.  ``QueryService.total`` accumulates it across
the stream.  Device buffers are allocated per request (PyTorch's caching
allocator reuses their memory); the service holds none between requests.

Execution tiers (DESIGN.md #9): every request batch flows through the
engine's cost-model dispatch (``SelfJoinConfig.execution``), so a
high-dimensional stream where the grid has lost its filtering power is
served by the dense tier.  The tier is part of each shape key
(``backend``/``shortc``), so a mixed stream straddling the dispatch
boundary traces at most one count and one pairs key per shape bucket
*per tier*; ``ServiceStats`` records the tier served and the cost model's
two estimates.

kNN tie-breaking is deterministic: neighbours sort by (distance, global
id), and queries with fewer than k reachable neighbours (k >= live count)
pad with id -1 / distance +inf.  The eps expansion is capped at the
diagonal of the joint query/live-data bounding box, which provably
contains every candidate, so termination never depends on the data
distribution.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Set, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.engine import QueryPlanTables, on_card, count_step, pairs_step
from repro_torch.join.index import IndexView, SimilarityIndex
from repro_torch.kernels import ops

_MAX_HITCAP_RETRIES = 8


@dataclasses.dataclass
class ServiceStats:
    """Per-request (and, via ``QueryService.total``, cumulative) counters."""

    num_requests: int = 0        # requests served (1 per response object)
    num_queries: int = 0         # query rows in the batch
    bucket: int = 0              # padded slot count the batch was served in
    eps: float = 0.0             # final radius evaluated
    eps_rounds: int = 0          # kNN eps-expansion count passes (1 = no growth)
    num_traces: int = 0          # NEW program shape keys this request caused
    num_device_dispatches: int = 0  # chunk-step and aux calls
    num_candidates: int = 0      # point comparisons the chosen tier evaluated
    num_results: int = 0         # neighbours counted / pairs returned
    index_rebuilds: int = 0      # temporary snapshots built for over-radius requests
    epoch: int = 0               # compaction epoch the request pinned
    delta_size: int = 0          # live delta-buffer points joined alongside
    tombstone_count: int = 0     # tombstoned points masked at the epilogue
    execution: str = ""          # tier that served this request ("mixed" across
                                 # requests/eps rounds that disagree)
    cost_indexed: float = 0.0    # summed cost-model indexed-tier estimates
    cost_dense: float = 0.0      # summed cost-model dense-tier estimates

    def record_tier(self, execution: str, ci: float, cd: float) -> None:
        if self.execution and self.execution != execution:
            self.execution = "mixed"
        else:
            self.execution = execution
        self.cost_indexed += ci
        self.cost_dense += cd

    def accumulate(self, other: "ServiceStats") -> None:
        self.num_requests += other.num_requests
        self.num_queries += other.num_queries
        self.bucket = max(self.bucket, other.bucket)
        self.eps = max(self.eps, other.eps)
        self.eps_rounds += other.eps_rounds
        self.num_traces += other.num_traces
        self.num_device_dispatches += other.num_device_dispatches
        self.num_candidates += other.num_candidates
        self.num_results += other.num_results
        self.index_rebuilds += other.index_rebuilds
        # high-water marks of the churn state seen across the stream
        self.epoch = max(self.epoch, other.epoch)
        self.delta_size = max(self.delta_size, other.delta_size)
        self.tombstone_count = max(self.tombstone_count, other.tombstone_count)
        if other.execution:
            self.record_tier(
                other.execution, other.cost_indexed, other.cost_dense
            )


@dataclasses.dataclass
class RangeCountResult:
    counts: np.ndarray           # (nq,) int64, batch row order
    stats: ServiceStats


@dataclasses.dataclass
class RangePairsResult:
    pairs: np.ndarray            # (R, 2) int64 (query row, global id), lexsorted
    counts: np.ndarray           # (nq,) int64
    stats: ServiceStats


@dataclasses.dataclass
class KnnResult:
    indices: np.ndarray          # (nq, k) int64 global ids, -1 where < k exist
    distances: np.ndarray        # (nq, k) float64, +inf where < k exist
    counts: np.ndarray           # (nq,) int64 candidates at the final radius
    stats: ServiceStats


_AUX_BLOCK = 1 << 24  # (bucket, rows) elements of one block of the aux pass


def aux_membership(q: torch.Tensor, pts: torch.Tensor, real: int, eps: float) -> torch.Tensor:
    """The delta/tombstone epilogue's dense bipartite membership pass:
    ``(bucket, rows)`` bool, row ``i`` column ``j`` true where aux point ``j
    < real`` lies within eps of query ``i``.

    Plain fp32 difference-square distances, as the JAX package's
    ``_aux_step`` computes them (exact on quantized coordinates, DESIGN.md
    #6), not the matmul identity; eps^2 is eps rounded to f32, squared in
    f32.  The squares are added one dimension at a time, in dimension
    order, over blocks of at most ``_AUX_BLOCK`` (query, row) entries, so
    the temporaries stay bounded however large the aux table grows.  Rows
    past ``real`` are padding and stay false.
    """
    e = torch.tensor(eps, dtype=torch.float32, device=q.device)
    e2 = e * e
    out = torch.zeros((q.shape[0], pts.shape[0]), dtype=torch.bool, device=q.device)
    step = max(1, _AUX_BLOCK // max(1, q.shape[0]))
    for j0 in range(0, int(real), step):
        blk = pts[j0:min(j0 + step, int(real))]
        d2 = torch.zeros((q.shape[0], blk.shape[0]), dtype=torch.float32, device=q.device)
        for k in range(q.shape[1]):
            d2 += (q[:, k, None] - blk[None, :, k]) ** 2
        out[:, j0:j0 + blk.shape[0]] = d2 <= e2
    return out


class QueryService:
    """Batched range + kNN serving over one ``SimilarityIndex``.

    Queries are given in ORIGINAL coordinates; the service permutes them
    with the index's persisted REORDER permutation where the grid needs it.
    Each request pins the index epoch at entry and serves from that pinned
    view; inserts, deletes and compactions land between requests without
    retracing anything warm.
    """

    def __init__(self, index: SimilarityIndex, *, min_bucket: int = 16):
        if min_bucket < 1:
            raise ValueError("min_bucket must be >= 1")
        self.index = index
        self.min_bucket = int(min_bucket)
        self.total = ServiceStats()
        self.buckets_used: Set[int] = set()
        self._trace_count = 0

        eng = index.engine.engine
        self._count_chunk = eng.count_chunk
        self._pairs_chunk = eng.pairs_chunk
        # the (program, shape key)s run so far; see _trace
        self._traced: Set[tuple] = set()

    # -- bucketing ---------------------------------------------------------

    def bucket_size(self, nq: int) -> int:
        """Power-of-two slot count (>= min_bucket) the batch is padded to."""
        return 1 << (max(int(nq), self.min_bucket) - 1).bit_length()

    # -- shape keys ----------------------------------------------------------

    def _trace(self, program: str, key: tuple) -> None:
        """Record that ``program`` runs at one shape key.

        ``key`` holds what the JAX package's ``jax.jit`` keys that program
        on -- the input shapes and the static arguments -- so a new key here
        is exactly a new trace there: it counts one in ``num_traces`` and
        fires the ``service.trace`` event (trace-span count ==
        ``ServiceStats.num_traces``).
        """
        full = (program,) + key
        if full not in self._traced:
            self._traced.add(full)
            self._trace_count += 1
            obs.event("service.trace", "trace", program=program)

    # -- internal execution ------------------------------------------------

    def _pin(self, stats: ServiceStats) -> IndexView:
        """Pin the index epoch for one request and record its churn state."""
        with obs.span("service.pin", "service"):
            view = self.index.view()
        stats.epoch = view.epoch
        stats.delta_size = view.delta_size
        stats.tombstone_count = view.tombstone_count
        return view

    def _prepare(
        self, q: np.ndarray, eps: float, view: IndexView, stats: ServiceStats
    ) -> Optional[QueryPlanTables]:
        """Plan tables against the PINNED snapshot (never the live engine).

        An eps above the pinned build radius gets a temporary rebuilt
        snapshot -- same permutation, buckets floored at the pinned one's --
        which this request alone serves from and then drops.
        """
        bucket = self.bucket_size(q.shape[0])
        snap = view.snapshot
        if (
            snap.num_points
            and snap.index_eps is not None
            and eps > snap.index_eps
        ):
            snap = snap.rebuilt(eps)
            stats.index_rebuilds += 1
        tab = self.index.engine.prepare_query(
            q, eps, pad_queries_to=bucket, snapshot=snap
        )
        stats.bucket = bucket
        self.buckets_used.add(bucket)
        if tab is not None:
            stats.record_tier(tab.execution, tab.cost_indexed, tab.cost_dense)
        return tab

    def _tier_kwargs(self, tab: QueryPlanTables) -> dict:
        cfg = self.index.config
        return {
            "backend": ops.backend_name(tab.execution, cfg.use_pallas),
            "shortc": cfg.shortc and tab.execution == "indexed",
        }

    def _run_counts(
        self, tab: QueryPlanTables, eps: float, stats: ServiceStats
    ) -> np.ndarray:
        tier = self._tier_kwargs(tab)
        counts = np.zeros(tab.nq, np.int64)
        stats.num_candidates += tab.num_candidates
        chunks = tab.chunks(self._count_chunk)
        if not chunks:  # no candidate pair: the step never runs
            return counts
        dev = tab.tiles.device
        # the query slots and the sink row (the scatter drops rows >= n_slots)
        self._trace("count", (tab.n_slots, *tab.tiles.shape, self._count_chunk, tier["backend"], tier["shortc"]))
        counts_sorted = torch.zeros(tab.n_slots + 1, dtype=torch.int32, device=dev)
        skipped = torch.zeros((), dtype=torch.int32, device=dev)
        step = count_step(
            counts_sorted, skipped, tab.tiles, tab.tile_len, tab.tile_start, eps,
            dim_block=self.index.config.dim_block, num_dims=self.index.num_dims, **tier,
        )
        with on_card(dev):
            for pa, pb, real in chunks:
                with obs.span(
                    "service.count.chunk", "dispatch", bucket=tab.n_slots
                ):
                    step(pa, pb, real)
                stats.num_device_dispatches += 1
        counts[tab.qplan.q_order] = counts_sorted[: tab.nq].cpu().numpy()
        return counts

    def _run_pairs(
        self, tab: QueryPlanTables, eps: float, total: int, stats: ServiceStats
    ) -> np.ndarray:
        """One pairs pass sized exactly from the known count total."""
        cfg = self.index.config
        t = int(cfg.tile_size)
        backend = self._tier_kwargs(tab)["backend"]
        flat_per_chunk = self._pairs_chunk * t * t
        hit_cap = min(flat_per_chunk, 4096)
        cap = 1 << (max(int(total), 1) - 1).bit_length()  # pow2: bounded shape keys
        dev = tab.tiles.device
        for _ in range(_MAX_HITCAP_RETRIES + 1):
            self._trace("pairs", (cap + hit_cap, *tab.tiles.shape, tab.order.shape[0], self._pairs_chunk,
                                  hit_cap, backend))
            buf = torch.zeros((cap + hit_cap, 2), dtype=torch.int32, device=dev)
            offset = torch.zeros((), dtype=torch.int32, device=dev)
            max_hits = torch.zeros((), dtype=torch.int32, device=dev)
            step = pairs_step(
                buf, offset, max_hits, tab.tiles, tab.tile_len, tab.tile_start, tab.order, eps,
                hit_cap=hit_cap, dim_block=cfg.dim_block, backend=backend,
                chunk=self._pairs_chunk, num_dims=self.index.num_dims,
            )
            with on_card(dev):
                for pa, pb, real in tab.chunks(self._pairs_chunk):
                    with obs.span(
                        "service.pairs.chunk", "dispatch", bucket=tab.n_slots
                    ):
                        step(pa, pb, real)
                    stats.num_device_dispatches += 1
            if int(max_hits) <= hit_cap:
                break
            # a single chunk outgrew the rank window: widen to the observed
            # maximum (pow2 so the retry shapes stay bounded) and redo
            obs.event(
                "service.pairs.retry", "retry", kind="hit_cap",
                max_hits=int(max_hits), hit_cap=hit_cap,
            )
            hit_cap = min(
                flat_per_chunk, 1 << (int(max_hits) - 1).bit_length()
            )
        num = int(offset)
        if num != total:
            raise RuntimeError(
                f"pairs pass found {num} pairs but the count pass said {total}"
            )
        return buf[:num].cpu().numpy()

    def _aux_mask(
        self,
        q: np.ndarray,
        pts_dev: Optional[torch.Tensor],
        m: int,
        eps: float,
        stats: ServiceStats,
    ) -> Optional[np.ndarray]:
        """(nq, m_padded) within-eps membership of q against an aux table."""
        if pts_dev is None or q.shape[0] == 0:
            return None
        nq = q.shape[0]
        bucket = self.bucket_size(nq)
        self._trace("aux", (bucket, *pts_dev.shape))
        with obs.span("service.aux", "dispatch", m=m):
            qb = torch.zeros((bucket, q.shape[1]), dtype=torch.float32, device=pts_dev.device)
            qb[:nq].copy_(torch.from_numpy(q))
            mask = aux_membership(qb, pts_dev, m, eps)
        stats.num_device_dispatches += 1
        stats.num_candidates += nq * m
        return mask[:nq].cpu().numpy()

    def _query_pass(
        self, q: np.ndarray, eps: float, view: IndexView, stats: ServiceStats
    ):
        """Snapshot counts + churn epilogue at one radius.

        Returns ``(tab, snap_counts, counts, delta_mask)``: the plan tables
        (None for an empty snapshot), the UNCORRECTED snapshot counts (they
        size the pairs pass), the live-set counts, and the delta membership
        mask (None when the delta is empty).
        """
        with obs.span(
            "service.eps_round", "service", eps=eps, nq=int(q.shape[0])
        ):
            tab = self._prepare(q, eps, view, stats)
            if tab is not None:
                snap_counts = self._run_counts(tab, eps, stats)
            else:
                snap_counts = np.zeros(q.shape[0], np.int64)
            counts = snap_counts.copy()
            dead_mask = self._aux_mask(
                q, view.dead_dev, view.tombstone_count, eps, stats
            )
            if dead_mask is not None:
                counts -= dead_mask.sum(axis=1)
            delta_mask = self._aux_mask(
                q, view.delta_dev, view.delta_size, eps, stats
            )
            if delta_mask is not None:
                counts += delta_mask.sum(axis=1)
            return tab, snap_counts, counts, delta_mask

    def _global_pairs(
        self,
        eps: float,
        tab: Optional[QueryPlanTables],
        view: IndexView,
        snap_counts: np.ndarray,
        delta_mask: Optional[np.ndarray],
        stats: ServiceStats,
    ) -> np.ndarray:
        """Materialized (query row, GLOBAL id) pairs of the live set."""
        with obs.span("service.epilogue", "service", eps=eps):
            return self._global_pairs_impl(
                eps, tab, view, snap_counts, delta_mask, stats
            )

    def _global_pairs_impl(
        self,
        eps: float,
        tab: Optional[QueryPlanTables],
        view: IndexView,
        snap_counts: np.ndarray,
        delta_mask: Optional[np.ndarray],
        stats: ServiceStats,
    ) -> np.ndarray:
        parts = []
        snap_total = int(snap_counts.sum())
        if tab is not None and snap_total:
            sp = self._run_pairs(tab, eps, snap_total, stats)
            if view.tombstone_count:
                sp = sp[~np.isin(sp[:, 1], view.dead_rows)]
            if sp.shape[0]:
                parts.append(np.column_stack(
                    [sp[:, 0].astype(np.int64), view.snap_ids[sp[:, 1]]]
                ))
        if delta_mask is not None:
            qr, j = np.nonzero(delta_mask)
            if qr.size:
                parts.append(np.column_stack(
                    [qr.astype(np.int64), view.delta_ids[j]]
                ))
        if not parts:
            return np.zeros((0, 2), np.int64)
        pairs = np.concatenate(parts)
        srt = np.lexsort((pairs[:, 1], pairs[:, 0]))
        return np.ascontiguousarray(pairs[srt])

    def _finish(
        self, stats: ServiceStats, traces_before: int, kind: str
    ) -> ServiceStats:
        stats.num_requests = 1
        stats.num_traces = self._trace_count - traces_before
        self.total.accumulate(stats)
        obs.event("service.unpin", "service", epoch=stats.epoch)
        obs.mirror_service_stats(stats, kind=kind)
        obs.request_log(kind, stats)
        return stats

    def _eps_cap(self, q: np.ndarray, view: IndexView) -> float:
        """Diagonal of the joint query/live-data bounding box: a provable
        upper bound on any query-to-live-point distance (small fp slack
        added).  Both sides are in the ORIGINAL frame (the diagonal length
        is permutation-invariant), and the data side is the pinned view's
        LIVE bounds -- so the cap, and with it the kNN eps trajectory, is
        identical before and after a compact of the same live set."""
        lo_d, hi_d = view.live_bounds
        q64 = q.astype(np.float64)
        lo = np.minimum(lo_d, q64.min(axis=0))
        hi = np.maximum(hi_d, q64.max(axis=0))
        diag = float(np.sqrt(((hi - lo) ** 2).sum()))
        return diag * (1.0 + 2**-10) + 1e-6

    # -- requests ----------------------------------------------------------

    def range_count(
        self, q: np.ndarray, eps: Optional[float] = None
    ) -> RangeCountResult:
        """Per-query counts of live points within eps (self not excluded)."""
        q = np.ascontiguousarray(np.asarray(q, dtype=np.float32))
        eps = self.index.config.eps if eps is None else float(eps)
        stats = ServiceStats(num_queries=q.shape[0], eps=eps)
        traces0 = self._trace_count
        with obs.span(
            "service.request", "request",
            kind="range_count", nq=int(q.shape[0]), eps=eps,
        ):
            view = self._pin(stats)
            counts = np.zeros(q.shape[0], np.int64)
            if q.shape[0]:
                _, _, counts, _ = self._query_pass(q, eps, view, stats)
            stats.num_results = int(counts.sum())
            return RangeCountResult(
                counts=counts,
                stats=self._finish(stats, traces0, "range_count"),
            )

    def range_pairs(
        self, q: np.ndarray, eps: Optional[float] = None
    ) -> RangePairsResult:
        """All (query row, global id) pairs within eps, lexsorted.

        Runs the count program first (reusing the same plan tables), so the
        pairs buffer is sized to the exact snapshot result and never
        overflows; tombstoned rows are filtered and delta matches merged
        afterwards.
        """
        q = np.ascontiguousarray(np.asarray(q, dtype=np.float32))
        eps = self.index.config.eps if eps is None else float(eps)
        stats = ServiceStats(num_queries=q.shape[0], eps=eps)
        traces0 = self._trace_count
        with obs.span(
            "service.request", "request",
            kind="range_pairs", nq=int(q.shape[0]), eps=eps,
        ):
            view = self._pin(stats)
            counts = np.zeros(q.shape[0], np.int64)
            pairs = np.zeros((0, 2), np.int64)
            if q.shape[0]:
                tab, snap_counts, counts, delta_mask = self._query_pass(
                    q, eps, view, stats
                )
                pairs = self._global_pairs(
                    eps, tab, view, snap_counts, delta_mask, stats
                )
            stats.num_results = int(counts.sum())
            return RangePairsResult(
                pairs=pairs, counts=counts,
                stats=self._finish(stats, traces0, "range_pairs"),
            )

    def knn(
        self, q: np.ndarray, k: int, eps0: Optional[float] = None
    ) -> KnnResult:
        """k nearest live points per query, exact, ties broken by global id.

        Adaptive eps expansion (Hybrid KNN-Join, arXiv:1810.04758, on the
        range-query index of arXiv:1803.04120): run the count program at a
        starting radius (``eps0``, default the index build radius), double
        it until every query holds >= min(k, live) candidates (capped at
        the joint bounding-box diagonal, where every point is a candidate),
        then materialize pairs once at the final radius and take the exact
        top-k by (distance, global id) per query.
        """
        q = np.ascontiguousarray(np.asarray(q, dtype=np.float32))
        nq = q.shape[0]
        k = int(k)
        if k < 0:
            raise ValueError(f"k must be >= 0, got {k}")
        stats = ServiceStats(num_queries=nq)
        traces0 = self._trace_count
        with obs.span(
            "service.request", "request", kind="knn", nq=nq, k=k,
        ):
            view = self._pin(stats)
            indices = np.full((nq, k), -1, np.int64)
            distances = np.full((nq, k), np.inf, np.float64)
            counts = np.zeros(nq, np.int64)
            if nq == 0 or view.live_count == 0 or k == 0:
                return KnnResult(
                    indices=indices, distances=distances, counts=counts,
                    stats=self._finish(stats, traces0, "knn"),
                )

            k_eff = min(k, view.live_count)
            eps_cap = self._eps_cap(q, view)
            eps = self.index.config.eps if eps0 is None else float(eps0)
            if eps <= 0.0:  # an eps==0 index would never grow by doubling
                eps = eps_cap / 1024.0
            eps = min(eps, eps_cap)
            while True:
                tab, snap_counts, counts, delta_mask = self._query_pass(
                    q, eps, view, stats
                )
                stats.eps_rounds += 1
                if (counts >= k_eff).all() or eps >= eps_cap:
                    break
                eps = min(2.0 * eps, eps_cap)
            stats.eps = eps

            pairs = self._global_pairs(
                eps, tab, view, snap_counts, delta_mask, stats
            )
            indices, distances = self._topk_from_pairs(q, pairs, k, nq)
            stats.num_results = int((indices >= 0).sum())
            return KnnResult(
                indices=indices, distances=distances, counts=counts,
                stats=self._finish(stats, traces0, "knn"),
            )

    def _topk_from_pairs(
        self, q: np.ndarray, pairs: np.ndarray, k: int, nq: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact per-query top-k over the candidate pairs, float64 distances."""
        indices = np.full((nq, k), -1, np.int64)
        distances = np.full((nq, k), np.inf, np.float64)
        if pairs.shape[0] == 0:
            return indices, distances
        qi = pairs[:, 0].astype(np.int64)
        di = pairs[:, 1].astype(np.int64)
        diffs = q[qi].astype(np.float64) - self.index.coords_of(di).astype(
            np.float64
        )
        dist = np.sqrt(np.einsum("ij,ij->i", diffs, diffs))
        srt = np.lexsort((di, dist, qi))   # by query, then distance, then id
        qi, di, dist = qi[srt], di[srt], dist[srt]
        seg = np.concatenate([[0], np.cumsum(np.bincount(qi, minlength=nq))])
        rank = np.arange(qi.shape[0], dtype=np.int64) - seg[qi]
        sel = rank < k
        indices[qi[sel], rank[sel]] = di[sel]
        distances[qi[sel], rank[sel]] = dist[sel]
        return indices, distances
