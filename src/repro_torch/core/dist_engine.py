"""Grid-indexed distributed self-join (paper Sec. 6 + DESIGN.md #7), PyTorch
port.

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
    each worker's local join per round runs through the shard's bipartite
    query plan (``build_query_plan`` / ``prepare_query``) -- REORDER,
    SORTIDU window pruning and SHORTC included -- and the chunk steps, which
    on the card are the fused kernels (K1's count step and K2's pairs step
    on the indexed tier, K3 / K4's on the dense tier).

``SelfJoinResult.stats`` reports both ``num_candidates`` (what the index
evaluated) and ``num_candidates_dense`` (the |Q| x |E| volume a dense ring
pays): their ratio is the distributed filtering power.

Index construction is host-side and the tile evaluation is device code
(``device``, default ``"cuda"``).  Two drivers share that contract, as in
the JAX package:

  * the **host-driven** BSP loop (default): one process runs the |p|^2
    (worker, shard) blocks one after another -- the workers are simulated
    -- and re-enters Python between rounds; it is the differential oracle
    of
  * the **device-fused** ring (``fused=True``): every rank of a
    ``torch.distributed`` group is one worker (its ring position).  It
    packs its own row of the |p|^2 bipartite plans once per radius,
    padded to fleet-wide maxima that the ranks agree on by collectives,
    into uniform sentinel-masked tables on its device; its shard's tile
    tables are the payload ``core.distributed.ring_scan`` moves between
    rounds.  The count program runs each round's chunks through one bound
    K1 fused count step over a combined (query | shard) table allocated
    once per pack and folds them into the worker's counts; the pairs
    program runs K2's fused pairs step into the worker's (buffer, cursor,
    max-chunk-hits) carry, the ids decoded through a combined (query |
    shard) order table whose shard half rides the payload.  Overflow
    accounting is exact, so every rank takes the same retry decision from
    the gathered fleet maxima.  eps is a runtime argument: an eps sweep at
    or below the packed radius re-runs the same programs.

Unequal shards from a non-divisible |D| need no sentinel padding on the
host-driven path (shard tile tables are per-shard anyway); the fused path
pads every table to the fleet-wide maximum -- padded tiles carry length 0,
padded pair-list entries sit past the per-chunk ``real`` prefix, and padded
query slots scatter to the counts vector's sink row.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.core import batching as batching_mod
from repro_torch.core.distributed import (
    AxisNames,
    _axes_tuple,
    carrier_device,
    ring_all_gather,
    ring_broadcast,
    ring_comm_elements,
    ring_of,
    ring_scan,
)
from repro_torch.core.engine import (
    _MAX_AUTO_GROW,
    SelfJoinEngine,
    count_step,
    on_card,
    pairs_step,
)
from repro_torch.core.grid import adjacent_cell_pairs, build_grid, pad_axis0
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
    """Ring size of a ``ProcessGroup`` (its size), or of a ``DeviceMesh``
    over its dims named ``axes``."""
    if isinstance(mesh, dist.ProcessGroup):
        return int(dist.get_world_size(mesh))
    names = tuple(mesh.mesh_dim_names or ())
    size = 1
    for a in _axes_tuple(axes):
        size *= mesh.size(names.index(a))
    return int(size)


class DistributedSelfJoinEngine:
    """Entity-partitioned, grid-indexed ring self-join over |p| workers.

    ``num_workers`` may be given directly or derived from a
    ``torch.distributed`` ``ProcessGroup`` or ``DeviceMesh`` (``mesh=``,
    plus for a mesh the names of the dims the ring spans, ``axes`` -- a 1-D
    ``("data",)`` mesh and the joint ``("pod", "data")`` dims of a 2-D mesh
    both work; the ring spans the product of the named dims, as in
    ``distributed.ring_self_join_counts``).

    ``assignment="round_robin"`` reproduces the paper's default batch
    assignment; ``assignment="dynamic"`` runs the sampling-style cost
    estimate (adjacent-cell candidate volume per batch) through the greedy
    LPT scheduler for straggler mitigation (paper Sec. 6.2).

    Every shard's ``SelfJoinEngine`` lives on ``device`` (default
    ``"cuda"``; without a card this raises unless ``device="cpu"`` is
    given).

    ``fused=True`` needs a mesh whose ring size equals ``num_workers``, and
    is constructed on every rank of the ring with the same arguments: rank
    k of ``ring_of(mesh, axes)`` is worker k (module docstring).  Its
    ``count()`` / ``self_join_pairs()`` / ``knn()`` return on every rank
    what the reference's controller returns.  ``num_device_dispatches``
    keeps the reference's meaning, executions of the rank program (one per
    join, one more per retry), not kernel launches; ``fused_traces`` /
    ``fused_pairs_traces`` count program builds at the keys the reference
    compiles (once per pack; pairs once per ``(cap, hit_cap)``) and
    ``fused_executions`` / ``fused_pairs_executions`` count runs.  The
    payload travels where the group's backend carries it
    (``distributed.carrier_device``: the card under NCCL, host memory under
    gloo, copied into the combined table each round); the kernels run on
    ``device`` under both.
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
            if mesh is None:
                raise ValueError("fused=True needs a mesh (one ring position per device)")
            if num_workers != _mesh_workers(mesh, axes):
                raise ValueError(
                    "fused=True requires num_workers == mesh ring size "
                    f"({num_workers} != {_mesh_workers(mesh, axes)})"
                )
        dev = resolve_device(device)

        self.config = config
        self.engine_config = engine_config
        self.mesh = mesh
        self.axes = axes
        self.device = dev
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

        # fused-ring state (packed lazily on the first fused join)
        self.fused = bool(fused)
        self._ring = ring_of(mesh, axes) if fused else None
        self._fused_pack = None
        self.fused_traces = 0            # fused count program builds
        self.fused_executions = 0        # ... and runs
        self.fused_pairs_traces = 0      # fused pairs program builds
        self.fused_pairs_executions = 0  # ... and runs

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

    # -- device-fused ring (DESIGN.md #7a/#7b) ------------------------------

    def _pack_fused(self, eps: float):
        """Pack this rank's fused-ring tables, once per index radius.

        Rank k packs what the reference's pack holds at index k: its row of
        the |p|^2 bipartite query plans (worker k's batches binned into
        shard (k - r) mod |p|'s grid for round r), padded to fleet-wide
        maxima so every ring position runs one shape, plus its own shard's
        padded tile tables, round 0's payload.  eps is not baked in: a sweep
        at or below the packed radius reuses the pack and its programs.
        """
        with obs.span(
            "ring.pack", "plan", workers=self.num_workers, eps=float(eps)
        ):
            return self._pack_fused_impl(eps)

    def _pack_fused_impl(self, eps: float):
        ring, p = self._ring, self.num_workers
        me = ring.position
        cfg = self.config
        eng = self.engine_config or EngineConfig()
        t = cfg.tile_size
        n_pad = self.shards[0].snapshot.n_pad
        dev = self.device

        q_index = [self.worker_query_index(k) for k in range(p)]
        nq = [int(idx.size) for idx in q_index]
        max_nq = max(max(nq), 1)
        q_pts = self._pts[q_index[me]]
        # every shard's index covers eps on every rank, as on the reference's
        # controller, whose workers with queries plan against every shard
        for e in self.shards:
            e._ensure_index(eps)

        # this rank's row of block plans (None where it has no queries:
        # fully masked rounds that still take part in every rotation)
        plans = []
        for r in range(p):
            qp = None
            if nq[me]:
                with obs.span(
                    "ring.pack.plan", "ring", worker=me, round=r, nq=nq[me],
                ):
                    qp = self.shards[(me - r) % p].build_query_plan(q_pts, eps)
            plans.append(qp)
        # the fleet's plan sizes, [worker, round, (q tiles, tile pairs, tile
        # pairs before pruning, candidates)]: every fleet-wide number below
        # is read off this one gather, so all ranks agree on it
        mine = [
            (qp.num_q_tiles, qp.num_pairs, qp.num_tile_pairs_total, qp.num_candidates)
            if qp is not None else (0, 0, 0, 0)
            for qp in plans
        ]
        fleet = ring_all_gather(
            ring, torch.tensor(mine, dtype=torch.int64, device=dev)
        ).cpu().numpy()
        max_qt = max(int(fleet[..., 0].max()), 1)
        max_pr = int(fleet[..., 1].max())
        max_dt = max(max((e.snapshot.plan.num_tiles if e.snapshot.plan else 0
                          for e in self.shards), default=0), 1)
        chunk = max(1, min(eng.count_chunk, max(max_pr, 1)))
        n_chunks = max(-(-max_pr // chunk), 1)
        chunk_p = max(1, min(eng.pairs_chunk, max(max_pr, 1)))
        n_chunks_p = max(-(-max_pr // chunk_p), 1)
        shard_sizes = np.diff(self.shard_bounds)
        max_sn = max(int(shard_sizes.max()) if shard_sizes.size else 0, 1)

        qt = torch.zeros((p, max_qt, t, n_pad), dtype=torch.float32, device=dev)
        qstart = np.zeros((p, max_qt), np.int32)
        qlen = np.zeros((p, max_qt), np.int32)
        qord = np.full((p, max_nq), max_nq, np.int32)   # sentinel: the sink row
        pq = np.zeros((p, n_chunks, chunk), np.int32)
        pd = np.zeros((p, n_chunks, chunk), np.int32)
        real = np.zeros((p, n_chunks), np.int32)
        # pairs mode (DESIGN.md #7b): the same plans re-chunked at the pairs
        # granularity, and the query half of the global-id decode table
        qog = np.zeros((p, max_nq), np.int32)
        pqp = np.zeros((p, n_chunks_p, chunk_p), np.int32)
        pdp = np.zeros((p, n_chunks_p, chunk_p), np.int32)
        realp = np.zeros((p, n_chunks_p), np.int32)
        for r, qp in enumerate(plans):
            if qp is None:
                continue
            if qp.num_q_tiles:
                qt[r, : qp.num_q_tiles] = ops.make_tiles_device(
                    torch.from_numpy(qp.q_sorted).to(dev),
                    torch.from_numpy(qp.q_tile_start.astype(np.int32)).to(dev),
                    torch.from_numpy(qp.q_tile_len.astype(np.int32)).to(dev),
                    tile_size=t, dim_block=cfg.dim_block,
                )
                qlen[r] = pad_axis0(qp.q_tile_len, max_qt)
                qstart[r] = pad_axis0(qp.q_tile_start, max_qt)
            qord[r, : nq[me]] = qp.q_order
            # pairs decode: q-sorted position -> GLOBAL query id
            qog[r, : nq[me]] = q_index[me][qp.q_order]
            if qp.num_pairs:
                # B side indexes the combined [query | shard] table
                pq[r].reshape(-1)[: qp.num_pairs] = qp.pair_q
                pd[r].reshape(-1)[: qp.num_pairs] = qp.pair_d + max_qt
                real[r] = np.clip(qp.num_pairs - np.arange(n_chunks) * chunk, 0, chunk)
                pqp[r].reshape(-1)[: qp.num_pairs] = qp.pair_q
                pdp[r].reshape(-1)[: qp.num_pairs] = qp.pair_d + max_qt
                realp[r] = np.clip(qp.num_pairs - np.arange(n_chunks_p) * chunk_p, 0, chunk_p)

        # the payload: this rank's shard, with the shard half of the decode
        # table (tile starts and grid-sort permutation, offset to global ids)
        own = self.shards[me].snapshot
        dt, dlen = own.packed_tile_table(max_dt)
        dstart = np.zeros(max_dt, np.int32)
        dord = np.zeros(max_sn, np.int32)
        if own.plan is not None:
            dstart[:] = pad_axis0(own.plan.tile_start.astype(np.int32), max_dt)
        if own.grid is not None:
            dord[: shard_sizes[me]] = self.shard_bounds[me] + own.grid.point_order

        # the combined (query | shard) tables the programs fill each round,
        # allocated once per pack
        comb = (
            torch.zeros((max_qt + max_dt, t, n_pad), dtype=torch.float32, device=dev),
            torch.zeros(max_qt + max_dt, dtype=torch.int32, device=dev),
            torch.zeros(max_qt + max_dt, dtype=torch.int32, device=dev),
            torch.zeros(max_nq + max_sn, dtype=torch.int32, device=dev),
        )

        # pairs capacity seeding: a hit-rate sample on the heaviest (worker,
        # round) block -- the first in worker-major order -- run by its
        # owner and broadcast, scaled by each worker's candidate volume
        hit_rate = 0.0
        if max_pr:
            k0, r0 = (int(i) for i in np.unravel_index(np.argmax(fleet[..., 1]), (p, p)))
            if k0 == me:
                with obs.span("ring.pack.sample", "plan", worker=k0, round=r0) as sp:
                    hit_rate, n_s = self._sample_hit_rate(
                        plans[r0], comb, qt[r0], qlen[r0], (me - r0) % p, max_qt, max_dt, eps
                    )
                    sp.set(hit_rate=hit_rate, sampled_pairs=n_s)
            hit_rate = float(ring_broadcast(
                ring, torch.tensor([hit_rate], dtype=torch.float64, device=dev), k0
            )[0])
        pairs_est = [int(np.ceil(hit_rate * int(fleet[k, :, 3].sum()))) for k in range(p)]
        pairs_cap = batching_mod.suggest_pairs_capacity(
            max(pairs_est, default=0), eng.pairs_headroom
        )

        def on_dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        carrier = carrier_device(ring, dev)
        payload = tuple(torch.from_numpy(a).to(carrier) for a in (dt, dlen, dstart, dord))
        qstart_t, qlen_t = on_dev(qstart), on_dev(qlen)
        self._fused_pack = dict(
            eps=float(eps), q_index=q_index, nq=nq, max_nq=max_nq, max_qt=max_qt,
            n_chunks=n_chunks, n_chunks_p=n_chunks_p, chunk_p=chunk_p,
            stats=(int(fleet[..., 2].sum()), int(fleet[..., 1].sum()), int(fleet[..., 3].sum())),
            # the reference's packed arguments at this rank's index, in its order
            args=(qt, qstart_t, qlen_t, on_dev(qord), on_dev(pq), on_dev(pd), real, *payload[:2]),
            pairs_args=(qt, qstart_t, qlen_t, on_dev(qog), on_dev(pqp), on_dev(pdp), realp, *payload),
            comb=comb, fn=None,
            pairs_fns={},                       # (cap, hit_cap) -> program
            pairs_cap=pairs_cap, pairs_est=pairs_est,
            pairs_flat_per_chunk=chunk_p * t * t,
            # expected hits in one full pairs chunk, for rank-window seeding
            pairs_hit_est=int(np.ceil(hit_rate * chunk_p * t * t)),
        )
        return self._fused_pack

    def _sample_hit_rate(self, qp, comb, q_tiles, q_len, j, max_qt, max_dt, eps):
        """Hit rate of up to 512 sampled tile pairs of block ``qp`` (this
        worker's queries against shard ``j``), evaluated per pair (K1 on the
        card) over the combined (query | shard) tables; returns
        ``(hit_rate, sampled pairs)``."""
        cfg = self.config
        tiles, tlen, _, _ = comb
        n_s = min(qp.num_pairs, 512)
        rng = np.random.default_rng(0)
        sel = (
            rng.choice(qp.num_pairs, size=n_s, replace=False)
            if qp.num_pairs > n_s else np.arange(n_s)
        )
        d_tiles, d_len = self.shards[j].snapshot.packed_tile_table(max_dt)
        len_c = np.concatenate([q_len, d_len])
        tiles[:max_qt].copy_(q_tiles)
        tiles[max_qt:].copy_(torch.from_numpy(d_tiles))
        tlen.copy_(torch.from_numpy(len_c))
        counts_s, _ = ops.tile_counts(
            tiles, tlen, qp.pair_q[sel], qp.pair_d[sel] + max_qt,
            eps=eps, dim_block=cfg.dim_block, shortc=cfg.shortc,
            backend=ops.backend_name("indexed", cfg.use_pallas), chunk=min(n_s, 512),
            num_dims=self.num_dims,
        )
        cand_s = float(
            (len_c[qp.pair_q[sel]].astype(np.float64)
             * len_c[qp.pair_d[sel] + max_qt]).sum()
        )
        return float(counts_s.sum()) / max(cand_s, 1.0), int(n_s)

    @staticmethod
    def _stage(pack, r, payload, d_start):
        """Copy round ``r``'s query tables and the arriving shard's tile
        table into the pack's combined (query | shard) tables: one ``copy_``
        per table (from host memory where the payload rides there).  The
        B-side starts are ``d_start`` offset past the query slots (the
        combined position space), or zero where ``d_start`` is None."""
        qt, qstart, qlen = pack["args"][:3]
        tiles, tlen, tstart, _ = pack["comb"]
        max_qt = pack["max_qt"]
        tiles[:max_qt].copy_(qt[r])
        tiles[max_qt:].copy_(payload[0])
        tlen[:max_qt].copy_(qlen[r])
        tlen[max_qt:].copy_(payload[1])
        tstart[:max_qt].copy_(qstart[r])
        if d_start is None:
            tstart[max_qt:].zero_()
        else:
            tstart[max_qt:].copy_(d_start)
            tstart[max_qt:] += pack["max_nq"]

    def _count_program(self, pack):
        """The fused count program of this rank: ``run(eps)`` -> the
        worker's ``(max_nq,)`` int32 counts over the whole ring."""
        self.fused_traces += 1
        obs.event("ring.trace", "compile", program="fused_count")
        cfg, ring, dev = self.config, self._ring, self.device
        _, _, _, qord, pq, pd, real, dt, dlen = pack["args"]
        tiles, tlen, tstart, _ = pack["comb"]
        max_nq, n_chunks = pack["max_nq"], pack["n_chunks"]

        def run(eps):
            counts_sorted = torch.zeros(max_nq + 1, dtype=torch.int32, device=dev)
            skipped = torch.zeros((), dtype=torch.int32, device=dev)
            step = count_step(
                counts_sorted, skipped, tiles, tlen, tstart, eps,
                dim_block=cfg.dim_block, shortc=cfg.shortc,
                backend=ops.backend_name("indexed", cfg.use_pallas), num_dims=self.num_dims,
            )

            def round_body(r, counts_local, payload):
                with obs.span("ring.fused.stage", "ring", round=r):
                    # B-side starts are never read (only pair_a rows scatter)
                    self._stage(pack, r, payload, None)
                    counts_sorted.zero_()
                with obs.span("ring.fused.chunks", "ring", round=r), on_card(dev):
                    for c in range(n_chunks):
                        step(pq[r, c], pd[r, c], int(real[r, c]))
                    # per-round q_order: q-sorted position -> worker-local
                    # slot (the sentinel max_nq lands in the dropped row)
                    return counts_local.index_add_(0, qord[r], counts_sorted[:max_nq])

            counts0 = torch.zeros(max_nq + 1, dtype=torch.int32, device=dev)
            return ring_scan(ring, round_body, counts0, (dt, dlen))[:max_nq]

        return run

    def _pairs_program(self, pack, cap: int, hit_cap: int):
        """The fused pairs program of this rank at ``(cap, hit_cap)``:
        ``run(eps)`` -> the worker's ``(buf, cursor, max_chunk_hits)``.

        Same transport as the count program; the carry is the worker's
        ``(cap + hit_cap, 2)`` buffer and its two scalars, which stay on the
        device between rounds, and the payload also carries the shard half
        of the decode table.
        """
        self.fused_pairs_traces += 1
        obs.event("ring.trace", "compile", program="fused_pairs", cap=cap, hit_cap=hit_cap)
        cfg, ring, dev = self.config, self._ring, self.device
        _, _, _, qog, pqp, pdp, realp, *payload = pack["pairs_args"]
        tiles, tlen, tstart, order = pack["comb"]
        max_nq, n_chunks_p = pack["max_nq"], pack["n_chunks_p"]

        def run(eps):
            buf = torch.zeros((cap + hit_cap, 2), dtype=torch.int32, device=dev)
            offset = torch.zeros((), dtype=torch.int32, device=dev)
            max_hits = torch.zeros((), dtype=torch.int32, device=dev)
            step = pairs_step(
                buf, offset, max_hits, tiles, tlen, tstart, order, eps,
                hit_cap=hit_cap, dim_block=cfg.dim_block,
                backend=ops.backend_name("indexed", cfg.use_pallas),
                chunk=pack["chunk_p"], num_dims=self.num_dims,
            )

            def round_body(r, carry, payload):
                with obs.span("ring.fused.stage", "ring", round=r):
                    # ids decode through the combined order table to GLOBAL
                    # point ids
                    self._stage(pack, r, payload, payload[2])
                    order[:max_nq].copy_(qog[r])
                    order[max_nq:].copy_(payload[3])
                with obs.span("ring.fused.chunks", "ring", round=r), on_card(dev):
                    for c in range(n_chunks_p):
                        step(pqp[r, c], pdp[r, c], int(realp[r, c]))
                return carry

            return ring_scan(ring, round_body, (buf, offset, max_hits), tuple(payload))

        return run

    def _fused_stats(self, pack, n_chunks: int) -> SelfJoinStats:
        stats = self._new_stats()
        stats.num_rounds = self.num_workers
        (stats.num_tile_pairs_total, stats.num_tile_pairs_evaluated,
         stats.num_candidates) = pack["stats"]
        stats.num_chunks = self.num_workers * n_chunks
        stats.num_candidates_dense = self._dense_candidates(pack["nq"])
        return stats

    def _count_fused(self, eps: float) -> SelfJoinResult:
        """Fused ring count: one execution of the rank program (counts ==
        host-driven ``count()``), the same result on every rank."""
        pack = self._fused_pack
        if pack is None or eps > pack["eps"]:
            pack = self._pack_fused(max(eps, self.config.eps))
        if pack["fn"] is None:
            pack["fn"] = self._count_program(pack)
        p = self.num_workers
        with obs.span(
            "ring.fused.count", "dispatch", workers=p, rounds=p, eps=eps,
        ):
            out = ring_all_gather(self._ring, pack["fn"](eps)).cpu().numpy()
        self.fused_executions += 1
        counts = np.zeros(self.num_points, dtype=np.int64)
        for k in range(p):
            counts[pack["q_index"][k]] = out[k, : pack["nq"][k]]
        stats = self._fused_stats(pack, pack["n_chunks"])
        stats.num_device_dispatches = 1
        stats.num_results = int(counts.sum())
        obs.mirror_selfjoin_stats(self._index_stats(stats), path="ring_fused", mode="count")
        return SelfJoinResult(counts=counts, stats=stats)

    def _pairs_fused(
        self, eps: float, max_pairs: Optional[int] = None
    ) -> SelfJoinResult:
        """Fused ring pairs join (DESIGN.md #7b), the same result on every rank.

        Every worker fills its own (capacity + hit_cap, 2) buffer; after
        each execution the ranks gather every worker's cursor and max-chunk
        hit watermark, so overflow is detected exactly and every rank takes
        the same step of the retry ladder (a rank that decided alone would
        hang the others): widen the per-chunk rank window first, then
        regrow the buffer to the measured fleet-max |R_k| (auto mode only;
        an explicit ``max_pairs`` raises).  Each (cap, hit_cap) builds its
        program once per pack, so a non-overflowing join costs one build
        and one execution.
        """
        pack = self._fused_pack
        if pack is None or eps > pack["eps"]:
            pack = self._pack_fused(max(eps, self.config.eps))
        eng = self.engine_config or EngineConfig()
        p, ring = self.num_workers, self._ring
        explicit = max_pairs if max_pairs is not None else eng.max_pairs
        auto = explicit is None
        cap = pack["pairs_cap"] if auto else int(explicit)
        flat_per_chunk = pack["pairs_flat_per_chunk"]
        # rank-window seed: 4x the sampled expected per-chunk hits absorbs
        # chunk-to-chunk skew, so the first join rarely needs the widen retry
        hit_cap = min(
            flat_per_chunk,
            max(4096, -(-4 * pack["pairs_hit_est"] // 1024) * 1024),
        )
        warm = pack.get("pairs_warm")
        if warm is not None:  # converged settings of an earlier join: 0 retries
            hit_cap = max(hit_cap, warm[1])
            if auto:
                cap = max(cap, warm[0])

        retries = 0
        while True:
            key = (cap, hit_cap)
            fn = pack["pairs_fns"].get(key)
            if fn is None:
                fn = self._pairs_program(pack, cap, hit_cap)
                pack["pairs_fns"][key] = fn
            with obs.span(
                "ring.fused.pairs", "dispatch",
                workers=p, rounds=p, eps=eps, attempt=retries,
                cap=cap, hit_cap=hit_cap,
            ):
                buf, off, mh = fn(eps)
                marks = ring_all_gather(ring, torch.stack([off, mh]).long()).cpu().numpy()
            self.fused_pairs_executions += 1
            off_np, mh_np = marks[:, 0], marks[:, 1]
            max_off, max_mh = int(off_np.max()), int(mh_np.max())
            # exact totals are known after the one execution, so each
            # overflow kind resolves in one retry (same ladder as
            # SelfJoinEngine.pairs), decided alike on every rank
            if max_mh > hit_cap:
                if retries >= _MAX_AUTO_GROW:
                    raise RuntimeError(
                        f"fused pairs rank window did not converge "
                        f"(max chunk hits {max_mh} > hit_cap {hit_cap})"
                    )
                obs.event(
                    "ring.pairs.retry", "retry", kind="hit_cap",
                    max_hits=max_mh, hit_cap=hit_cap,
                )
                hit_cap = min(flat_per_chunk, -(-max_mh // 1024) * 1024)
                retries += 1
                continue
            if max_off > cap:
                if auto and eng.auto_grow and retries < _MAX_AUTO_GROW:
                    obs.event(
                        "ring.pairs.retry", "retry", kind="capacity",
                        num=max_off, cap=cap,
                    )
                    cap = batching_mod.suggest_pairs_capacity(max_off, 1.0)
                    retries += 1
                    continue
                raise RuntimeError(
                    f"fused ring worker found {max_off} pairs, exceeding "
                    f"max_pairs={cap}; raise the cap or lower eps"
                )
            if auto:
                pack["pairs_warm"] = (cap, hit_cap)
            break

        # each worker's buffer cut at its cursor, in worker order
        pairs = np.zeros((0, 2), np.int32)
        if max_off:
            got = ring_all_gather(ring, buf[:max_off]).cpu().numpy()
            pairs = np.concatenate([got[k, : off_np[k]] for k in range(p)])
        counts = np.bincount(pairs[:, 0], minlength=self.num_points).astype(np.int64)
        stats = self._fused_stats(pack, pack["n_chunks_p"])
        stats.num_device_dispatches = 1 + retries
        stats.pairs_capacity = cap
        stats.overflow_retries = retries
        stats.worker_pair_cursors = tuple(int(x) for x in off_np)
        stats.worker_max_chunk_hits = tuple(int(x) for x in mh_np)
        stats.num_results = int(pairs.shape[0])
        obs.mirror_selfjoin_stats(stats, path="ring_fused", mode="pairs")
        return SelfJoinResult(
            counts=counts, stats=self._index_stats(stats), pairs=pairs
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

        With ``fused=True`` the same schedule runs as one execution of each
        rank's program (``_count_fused``); this host-driven loop is its
        differential oracle.
        """
        eps = self.config.eps if eps is None else float(eps)
        if self.fused and self.num_points:
            return self._count_fused(eps)
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
        (b, a) appear, as does (a, a); ``counts`` equals ``count()``.
        ``fused=None`` follows the engine's construction mode; ``fused=
        False`` forces the host-driven BSP loop (the differential oracle)
        even on a fused engine; ``fused=True`` requires one.  The host path
        gives the pairs in schedule order (round, then worker), each
        block's in the order of its chunks; the fused path gives each
        worker's buffer in worker order (``_pairs_fused``).  The pair SET
        is the same.
        """
        eps = self.config.eps if eps is None else float(eps)
        use_fused = self.fused if fused is None else bool(fused)
        if use_fused and not self.fused:
            raise ValueError(
                "fused=True requires an engine constructed with fused=True "
                "(a mesh-backed ring)"
            )
        if use_fused and self.num_points:
            return self._pairs_fused(eps, max_pairs)
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
        pair list.  ``fused`` routes the candidate passes exactly as in
        ``self_join_pairs``.
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
