"""Grid-indexed distributed self-join (paper Sec. 6 + DESIGN.md #7), PyTorch
port of the host-driven engine.

``DistributedSelfJoinEngine`` composes three pieces:

  * **entity partitioning** (``core/partition.py``, Sec. 6.2): the query set
    is over-decomposed into N_b batches and assigned to the |p| workers --
    round-robin by default, or cost-estimate-driven LPT (``assign_dynamic``)
    when per-batch cost estimates are requested (paper Figs. 10-11);
  * **ring rotation** (Sec. 6.3): the dataset is entity-partitioned into
    |p| shards E_0..E_{p-1}; in round r worker k holds shard (k - r) mod
    |p|, so after |p| BSP supersteps every query batch has met the whole
    dataset while only (|p|-1)|D| points crossed the wire;
  * **the grid index** (``core/grid.py`` / ``core/engine.py``, Secs. 3-4):
    each worker's local join per round runs through the shard's
    ``SelfJoinEngine.count_query`` / ``prepare_query`` -- REORDER, SORTIDU
    window pruning and SHORTC included -- and its chunk steps, which on the
    card are the fused kernels (K1's count step and K2's pairs step on the
    indexed tier, K3 / K4's on the dense tier).

``SelfJoinResult.stats`` reports both ``num_candidates`` (what the index
evaluated) and ``num_candidates_dense`` (the |Q| x |E| volume a dense ring
pays): their ratio is the distributed filtering power.

Execution model, as in the JAX package's default (``fused=False``): index
construction is host-side and the per-block tile evaluation is device
code.  The BSP loop re-enters Python between rounds and runs the |p|^2
(worker, shard) blocks one after another in one process, on the device
that holds the shards (``device``, default ``"cuda"``): the workers are
simulated.  The transport between processes is ``core/distributed.py``'s
``ring_scan``.  The device-fused ring of the JAX package (``fused=True``:
the whole schedule as one program) is not ported; asking for it raises.

Unequal shards from a non-divisible |D| need no sentinel padding (shard
tile tables are per-shard anyway).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.distributed import AxisNames, _axes_tuple, ring_comm_elements
from repro_torch.core.engine import (
    _MAX_AUTO_GROW,
    SelfJoinEngine,
    count_step,
    on_card,
    pairs_step,
)
from repro_torch.core.grid import adjacent_cell_pairs, build_grid
from repro_torch.core.partition import EntityPartition, assign_dynamic, make_partition
from repro_torch.core.reorder import variance_reorder
from repro_torch.core.snapshot import resolve_device
from repro_torch.core.types import (
    EngineConfig,
    SelfJoinConfig,
    SelfJoinResult,
    SelfJoinStats,
)
from repro_torch.kernels import ops

_TOPK_ROWS = 1 << 22  # candidate pairs per row block of _topk_from_pairs' distances

_FUSED_NOT_PORTED = (
    "the device-fused ring (fused=True) is not ported yet (ROADMAP Queue A "
    "item 8); use the host-driven engine (fused=False)"
)


@dataclasses.dataclass
class DistributedKnnResult:
    """k nearest neighbours per dataset point, exact, global ids.

    ``indices[i, :]`` are the ids of the k nearest points to point i
    (self included, ties broken by id), -1 padded when k exceeds the
    dataset; ``distances`` are the matching float64 Euclidean distances,
    inf padded.  ``stats`` is the final candidate pass's
    ``SelfJoinStats``.
    """

    indices: np.ndarray      # (n, k) int64
    distances: np.ndarray    # (n, k) float64
    counts: np.ndarray       # (n,) int64 neighbour counts at eps_used
    eps_used: float          # final radius of the adaptive expansion
    eps_rounds: int          # candidate passes run (1 = no growth)
    stats: SelfJoinStats


def _mesh_workers(mesh, axes: AxisNames) -> int:
    """Ring size of a ``DeviceMesh`` over its dims named ``axes``."""
    names = tuple(mesh.mesh_dim_names or ())
    size = 1
    for a in _axes_tuple(axes):
        size *= mesh.size(names.index(a))
    return int(size)


class DistributedSelfJoinEngine:
    """Entity-partitioned, grid-indexed ring self-join over |p| workers.

    ``num_workers`` may be given directly or derived from a
    ``torch.distributed`` ``DeviceMesh`` (``mesh=`` plus the names of the
    dims the ring spans, ``axes`` -- a 1-D ``("data",)`` mesh and the
    joint ``("pod", "data")`` dims of a 2-D mesh both work; the ring spans
    the product of the named dims, as in
    ``distributed.ring_self_join_counts``).

    ``assignment="round_robin"`` reproduces the paper's default batch
    assignment; ``assignment="dynamic"`` runs the sampling-style cost
    estimate (adjacent-cell candidate volume per batch) through the greedy
    LPT scheduler for straggler mitigation (paper Sec. 6.2).

    Every shard's ``SelfJoinEngine`` lives on ``device`` (default
    ``"cuda"``; without a card this raises unless ``device="cpu"`` is
    given).  ``fused=True`` raises ``NotImplementedError``: the fused ring
    is not ported.
    """

    def __init__(
        self,
        d: np.ndarray,
        config: SelfJoinConfig,
        *,
        num_workers: Optional[int] = None,
        mesh=None,
        axes: AxisNames = "data",
        num_batches: Optional[int] = None,
        assignment: str = "round_robin",
        engine_config: Optional[EngineConfig] = None,
        fused: bool = False,
        device="cuda",
    ):
        if num_workers is None:
            if mesh is None:
                raise ValueError("pass num_workers or a mesh")
            num_workers = _mesh_workers(mesh, axes)
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if assignment not in ("round_robin", "dynamic"):
            raise ValueError(f"unknown assignment {assignment!r}")
        if fused:
            raise NotImplementedError(_FUSED_NOT_PORTED)
        dev = resolve_device(device)

        self.config = config
        self.engine_config = engine_config
        self._pts = np.ascontiguousarray(np.asarray(d, dtype=np.float32))
        self.num_points, self.num_dims = self._pts.shape
        self.num_workers = int(num_workers)

        # dataset shards E_j: contiguous entity partition, unequal tails ok
        self.shard_bounds = np.linspace(
            0, self.num_points, self.num_workers + 1
        ).round().astype(np.int64)
        self.shards: List[SelfJoinEngine] = [
            SelfJoinEngine(
                self._pts[self.shard_bounds[j]:self.shard_bounds[j + 1]],
                config,
                engine_config,
                device=dev,
            )
            for j in range(self.num_workers)
        ]

        # query batches Q_l, over-decomposed (N_b defaults to 4|p|)
        n_b = num_batches if num_batches is not None else 4 * self.num_workers
        self.partition: EntityPartition = make_partition(
            self.num_points, self.num_workers, n_b
        )
        self._batch_costs: Optional[np.ndarray] = None
        if assignment == "dynamic":
            self.partition.assignment = assign_dynamic(
                self.estimate_batch_costs(), self.num_workers
            )
        self.assignment = assignment

    # -- partitioning -----------------------------------------------------

    def worker_query_index(self, worker: int) -> np.ndarray:
        """Original-order indices of all query points owned by ``worker``."""
        ranges = [
            np.arange(*self.partition.query_range(b), dtype=np.int64)
            for b in self.partition.batches_of(worker)
        ]
        if not ranges:
            return np.zeros(0, np.int64)
        return np.concatenate(ranges)

    def estimate_batch_costs(self) -> np.ndarray:
        """Per-batch candidate-volume estimates from one global grid probe.

        The cost of joining a batch is dominated by its candidate count; the
        grid gives it cheaply: for every point, the total population of its
        3^k adjacent non-empty cells.  One ``build_grid`` over the full
        (reordered) dataset plus one vectorized adjacency probe -- the same
        sampling-pass flavour the paper uses to drive its scheduler.
        """
        if self._batch_costs is not None:
            return self._batch_costs
        costs = np.zeros(self.partition.num_batches, dtype=np.float64)
        if self.num_points == 0:
            self._batch_costs = costs
            return costs
        work = self._pts
        if self.config.reorder:
            work, _ = variance_reorder(self._pts, self.config.sample_frac)
        grid = build_grid(work, self.config.eps, self.config.k)
        ca, cb = adjacent_cell_pairs(grid)
        cell_cand = np.zeros(grid.num_cells, dtype=np.float64)
        np.add.at(cell_cand, ca, grid.cell_count[cb].astype(np.float64))
        cell_of_point = np.repeat(
            np.arange(grid.num_cells, dtype=np.int64), grid.cell_count
        )
        per_point = np.empty(self.num_points, dtype=np.float64)
        per_point[grid.point_order] = cell_cand[cell_of_point]
        for b in range(self.partition.num_batches):
            lo, hi = self.partition.query_range(b)
            costs[b] = per_point[lo:hi].sum()
        self._batch_costs = costs
        return costs

    def worker_loads(self) -> np.ndarray:
        """Estimated candidate load per worker under the current assignment."""
        costs = self.estimate_batch_costs()
        loads = np.zeros(self.num_workers, dtype=np.float64)
        for b in range(self.partition.num_batches):
            loads[self.partition.assignment[b]] += costs[b]
        return loads

    # -- ring schedule ----------------------------------------------------

    def ring_schedule(self) -> List[List[Tuple[int, int]]]:
        """Round r -> [(worker k, shard it holds)]: shard (k - r) mod |p|."""
        p = self.num_workers
        return [[(k, (k - r) % p) for k in range(p)] for r in range(p)]

    def comm_elements(self) -> int:
        """Ring transport volume in points: (|p| - 1) |D| (paper Sec. 6.3)."""
        return ring_comm_elements(self.num_points, self.num_workers)

    def _new_stats(self) -> SelfJoinStats:
        return SelfJoinStats(
            num_points=self.num_points,
            num_dims=self.num_dims,
            k=min(self.config.k, self.num_dims),
            num_workers=self.num_workers,
            comm_elements=self.comm_elements(),
        )

    def _index_stats(self, stats: SelfJoinStats) -> SelfJoinStats:
        stats.num_tiles = sum(
            e.snapshot.plan.num_tiles for e in self.shards if e.snapshot.plan
        )
        stats.num_nonempty_cells = sum(
            e.snapshot.grid.num_cells for e in self.shards if e.snapshot.grid
        )
        return stats

    def _dense_candidates(self, nq: List[int]) -> int:
        shard_sizes = np.diff(self.shard_bounds)
        return int(
            sum(
                nq[k] * shard_sizes[j]
                for sched in self.ring_schedule()
                for k, j in sched
            )
        )

    # -- host-driven BSP loop ---------------------------------------------

    def _block_pairs(
        self,
        k: int,
        j: int,
        q_pts_k: np.ndarray,
        eps: float,
        eng: EngineConfig,
        stats: SelfJoinStats,
    ) -> np.ndarray:
        """Exact (global query id, global data id) pairs of one (Q_k, E_j)
        block, via the host-driven count-then-pairs pattern of the serving
        tier: the count pass sizes the buffer exactly, so the pairs pass
        never overflows (only the per-chunk rank window may widen)."""
        e = self.shards[j]
        tab = e.prepare_query(q_pts_k, eps)
        if tab is None:
            return np.zeros((0, 2), np.int64)
        cfg = self.config
        backend = ops.backend_name(tab.execution, cfg.use_pallas)
        shortc = cfg.shortc and tab.execution == "indexed"
        dev = tab.tiles.device

        # the query slots and the sink row (the scatter drops rows >= n_slots)
        counts_sorted = torch.zeros(tab.n_slots + 1, dtype=torch.int32, device=dev)
        skipped = torch.zeros((), dtype=torch.int32, device=dev)
        step = count_step(
            counts_sorted, skipped, tab.tiles, tab.tile_len, tab.tile_start, eps,
            dim_block=cfg.dim_block, shortc=shortc, backend=backend,
            num_dims=e.num_dims,
        )
        with on_card(dev):
            for pa, pb, real in tab.chunks(eng.count_chunk):
                with obs.span(
                    "ring.block.count.chunk", "dispatch", worker=k, shard=j
                ):
                    step(pa, pb, real)
                stats.num_device_dispatches += 1
            total = int(counts_sorted[: tab.n_slots].sum())

        t = cfg.tile_size
        flat_per_chunk = eng.pairs_chunk * t * t
        hit_cap = min(flat_per_chunk, 4096)
        cap = 1 << (max(total, 1) - 1).bit_length()  # pow2, as the reference sizes it
        for _ in range(_MAX_AUTO_GROW + 1):
            buf = torch.zeros((cap + hit_cap, 2), dtype=torch.int32, device=dev)
            offset = torch.zeros((), dtype=torch.int32, device=dev)
            max_hits = torch.zeros((), dtype=torch.int32, device=dev)
            step = pairs_step(
                buf, offset, max_hits, tab.tiles, tab.tile_len, tab.tile_start, tab.order, eps,
                hit_cap=hit_cap, dim_block=cfg.dim_block, backend=backend,
                chunk=eng.pairs_chunk, num_dims=e.num_dims,
            )
            with on_card(dev):
                for pa, pb, real in tab.chunks(eng.pairs_chunk):
                    with obs.span(
                        "ring.block.pairs.chunk", "dispatch", worker=k, shard=j
                    ):
                        step(pa, pb, real)
                    stats.num_device_dispatches += 1
                    stats.num_chunks += 1
            if int(max_hits) <= hit_cap:
                break
            hit_cap = min(
                flat_per_chunk, 1 << (int(max_hits) - 1).bit_length()
            )
        num = int(offset)
        if num != total:
            raise RuntimeError(
                f"block ({k}, {j}) pairs pass found {num} pairs but the "
                f"count pass said {total}"
            )
        stats.num_tile_pairs_total += tab.qplan.num_tile_pairs_total
        stats.num_tile_pairs_evaluated += tab.num_pairs
        stats.num_candidates += tab.num_candidates

        blk = buf[:num].cpu().numpy().astype(np.int64)
        if num:
            # order decodes A-side to q-row ids, B-side to shard-local ids
            blk[:, 0] = self.worker_query_index(k)[blk[:, 0]]
            blk[:, 1] += self.shard_bounds[j]
        return blk

    def _pairs_host(
        self, eps: float, max_pairs: Optional[int] = None
    ) -> SelfJoinResult:
        """Host-driven BSP pairs join.

        Same |p|-round schedule as ``count()``, each (worker, shard) block
        materialized through the chunked pairs step and decoded to global
        ids on the host.  Exact by construction (count-first sizing); an
        explicit ``max_pairs`` below the true |R| raises.
        """
        eng = self.engine_config or EngineConfig()
        stats = self._new_stats()
        q_index = [self.worker_query_index(k) for k in range(self.num_workers)]
        q_points = [self._pts[idx] for idx in q_index]
        blocks = []
        for r, round_sched in enumerate(self.ring_schedule()):
            with obs.span(
                "ring.round", "ring",
                round=r, workers=self.num_workers, mode="pairs",
            ):
                for k, j in round_sched:
                    if q_index[k].size == 0:
                        continue
                    blocks.append(
                        self._block_pairs(k, j, q_points[k], eps, eng, stats)
                    )
            stats.num_rounds += 1
        pairs = (
            np.concatenate(blocks) if blocks else np.zeros((0, 2), np.int64)
        ).astype(np.int32)
        explicit = max_pairs if max_pairs is not None else eng.max_pairs
        if explicit is not None and pairs.shape[0] > int(explicit):
            raise RuntimeError(
                f"result exceeded max_pairs={int(explicit)}; raise the cap "
                f"or lower eps"
            )
        counts = np.zeros(self.num_points, dtype=np.int64)
        if pairs.shape[0]:
            counts = np.bincount(
                pairs[:, 0], minlength=self.num_points
            ).astype(np.int64)
        stats.num_results = int(pairs.shape[0])
        stats.num_candidates_dense = self._dense_candidates(
            [idx.size for idx in q_index]
        )
        obs.mirror_selfjoin_stats(stats, path="ring_host", mode="pairs")
        return SelfJoinResult(
            counts=counts, stats=self._index_stats(stats), pairs=pairs
        )

    # -- queries ----------------------------------------------------------

    def count(self, eps: Optional[float] = None) -> SelfJoinResult:
        """Per-point neighbour counts (self included), original order.

        Executes the |p|-round BSP schedule: in round r every worker joins
        its query batches against the shard it currently holds, through that
        shard's grid index (``SelfJoinEngine.count_query``).  Counts
        accumulate across rounds; after |p| rounds each query point has met
        every shard exactly once, so the result equals the single-device
        ``SelfJoinEngine.count()`` and the brute-force oracle.
        """
        eps = self.config.eps if eps is None else float(eps)
        counts = np.zeros(self.num_points, dtype=np.int64)
        stats = self._new_stats()
        q_index = [self.worker_query_index(k) for k in range(self.num_workers)]
        q_points = [self._pts[idx] for idx in q_index]
        shard_sizes = np.diff(self.shard_bounds)
        for r, round_sched in enumerate(self.ring_schedule()):
            with obs.span(
                "ring.round", "ring",
                round=r, workers=self.num_workers, mode="count",
            ):
                for k, j in round_sched:
                    if q_index[k].size == 0:
                        continue
                    res = self.shards[j].count_query(q_points[k], eps)
                    counts[q_index[k]] += res.counts
                    s = res.stats
                    stats.num_tile_pairs_total += s.num_tile_pairs_total
                    stats.num_tile_pairs_evaluated += s.num_tile_pairs_evaluated
                    stats.num_candidates += s.num_candidates
                    stats.num_chunks += s.num_chunks
                    stats.num_device_dispatches += s.num_chunks
                    stats.dim_blocks_skipped += s.dim_blocks_skipped
                    stats.dim_blocks_total += s.dim_blocks_total
                    stats.num_candidates_dense += int(
                        q_index[k].size * shard_sizes[j]
                    )
            stats.num_rounds += 1
        self._index_stats(stats)
        stats.num_results = int(counts.sum())
        obs.mirror_selfjoin_stats(stats, path="ring_host", mode="count")
        return SelfJoinResult(counts=counts, stats=stats)

    def self_join_pairs(
        self,
        eps: Optional[float] = None,
        max_pairs: Optional[int] = None,
        fused: Optional[bool] = None,
    ) -> SelfJoinResult:
        """Counts plus the materialized (a, b) pair list, GLOBAL ids.

        Distributed analogue of ``SelfJoinEngine.pairs``: both (a, b) and
        (b, a) appear, as does (a, a); ``counts`` equals ``count()``.  The
        pairs come in schedule order (round, then worker), each block's in
        the order of its chunks.  ``fused=True`` raises
        ``NotImplementedError`` (the fused ring is not ported).
        """
        if fused:
            raise NotImplementedError(_FUSED_NOT_PORTED)
        eps = self.config.eps if eps is None else float(eps)
        return self._pairs_host(eps, max_pairs)

    def knn(
        self,
        k_neighbors: int,
        eps0: Optional[float] = None,
        fused: Optional[bool] = None,
    ) -> DistributedKnnResult:
        """Exact k nearest neighbours of every dataset point, global ids.

        Adaptive eps expansion over the distributed pairs join (the same
        Hybrid-KNN-join recipe as ``QueryService.knn``): run the candidate
        pass at a starting radius (``eps0``, default the build radius),
        double until every point holds >= min(k, n) candidates (capped at
        the bounding-box diagonal, where everything is a candidate), then
        take the exact per-point top-k by (distance, id) from the final
        pair list.  ``fused`` is passed to ``self_join_pairs``.
        """
        k = int(k_neighbors)
        if k < 0:
            raise ValueError(f"k_neighbors must be >= 0, got {k}")
        n = self.num_points
        indices = np.full((n, k), -1, np.int64)
        distances = np.full((n, k), np.inf, np.float64)
        if n == 0 or k == 0:
            return DistributedKnnResult(
                indices=indices, distances=distances,
                counts=np.zeros(n, np.int64), eps_used=0.0, eps_rounds=0,
                stats=SelfJoinStats(
                    num_points=n, num_dims=self.num_dims,
                    num_workers=self.num_workers,
                ),
            )
        k_eff = min(k, n)
        lo = self._pts.min(axis=0).astype(np.float64)
        hi = self._pts.max(axis=0).astype(np.float64)
        eps_cap = float(np.sqrt(((hi - lo) ** 2).sum())) * (1.0 + 2**-10) + 1e-6
        eps = self.config.eps if eps0 is None else float(eps0)
        if eps <= 0.0:  # an eps==0 start would never grow by doubling
            eps = eps_cap / 1024.0
        eps = min(eps, eps_cap)
        rounds = 0
        while True:
            obs.event("ring.knn.round", "ring", round=rounds, eps=eps, k=k)
            res = self.self_join_pairs(eps=eps, fused=fused)
            rounds += 1
            if (res.counts >= k_eff).all() or eps >= eps_cap:
                break
            eps = min(2.0 * eps, eps_cap)
        indices, distances = self._topk_from_pairs(res.pairs, k)
        return DistributedKnnResult(
            indices=indices, distances=distances, counts=res.counts,
            eps_used=eps, eps_rounds=rounds, stats=res.stats,
        )

    def _topk_from_pairs(
        self, pairs: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact per-point top-k over the candidate pairs, float64 distances."""
        n = self.num_points
        indices = np.full((n, k), -1, np.int64)
        distances = np.full((n, k), np.inf, np.float64)
        if pairs.shape[0] == 0:
            return indices, distances
        qi = pairs[:, 0].astype(np.int64)
        di = pairs[:, 1].astype(np.int64)
        # row blocks bound the float64 temporaries (the reference's one-shot
        # form needs ~500 bytes per pair); each row's sum is the same
        dist = np.empty(qi.shape[0], np.float64)
        for s in range(0, qi.shape[0], _TOPK_ROWS):
            diffs = self._pts[qi[s:s + _TOPK_ROWS]].astype(np.float64) - self._pts[
                di[s:s + _TOPK_ROWS]].astype(np.float64)
            dist[s:s + _TOPK_ROWS] = np.sqrt((diffs * diffs).sum(axis=1))
        order = np.lexsort((di, dist, qi))
        qi, di, dist = qi[order], di[order], dist[order]
        seg = np.cumsum(np.bincount(qi, minlength=n))
        starts = np.concatenate([[0], seg[:-1]])
        rank = np.arange(qi.shape[0]) - starts[qi]
        keep = rank < k
        indices[qi[keep], rank[keep]] = di[keep]
        distances[qi[keep], rank[keep]] = dist[keep]
        return indices, distances
