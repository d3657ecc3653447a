"""Persistent, *mutable* device-resident similarity index (DESIGN.md #8, #10).

The port of ``repro.join.index``: the same churn machinery, global-id log
and version-2 ``.npz`` (a file either package writes loads in the other and
serves the same answers), with the snapshot and the churn tables on one
``torch.device`` (default ``"cuda"``; without a card this raises unless
``device="cpu"`` is given).

``SimilarityIndex`` owns the serving tier's data plane: a ``SelfJoinEngine``
whose frozen ``GridSnapshot`` answers the bulk of every query, plus the
mutable churn state that lets the dataset change without a rebuild:

  inserts    -- ``insert(points)`` appends to a delta buffer (host log +
                lazily device-placed pow2-padded tensor) that the service
                brute/dense-joins against every query batch;
  deletes    -- ``delete(ids)`` tombstones snapshot points (delta points
                are simply dropped from the buffer); tombstoned rows are
                masked out of counts/pairs/kNN at the query epilogue;
  compaction -- ``compact()`` rebuilds a fresh snapshot over the live set
                (base points minus tombstones plus delta, ascending global
                id) and atomically swaps it in via
                ``SelfJoinEngine.swap_snapshot``; the build phase is pure
                (``prepare_compact``) so it can run off the serving path,
                and the swap is one reference assignment.

Every point carries a **global id**, stable across compactions: the base
dataset gets ids ``0..N-1`` and each insert allocates fresh ids upward.
Query results (``range_pairs`` data column, kNN indices) are global ids.
``IndexView`` is the consistent read snapshot a request pins: compacting
under a pinned view changes none of its arrays (all mutation is
copy-on-write), which is what makes answers bit-identical across the swap.

``save``/``load`` persist the derived snapshot state (permutation, grid
arrays, tile plan) AND the churn state (global ids, delta buffer,
tombstones, the id->coordinates log) in one ``.npz``, so a restarted server
resumes the exact epoch it left -- stale snapshot, pending delta and all --
and serves bit-identically (``SelfJoinEngine.from_prebuilt`` only re-places
arrays on the device).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.engine import QueryPlanTables, SelfJoinEngine
from repro_torch.core.grid import GridIndex, TilePlan, bucket_rows, pad_axis0
from repro_torch.core.reorder import apply_reorder
from repro_torch.core.snapshot import GridSnapshot
from repro_torch.core.tuning import select_k
from repro_torch.core.types import EngineConfig, SelfJoinConfig

_SAVE_VERSION = 2

_GRID_ARRAYS = (
    "origin", "cells_per_dim", "strides", "point_order", "pts_sorted",
    "cell_coords", "cell_ids", "cell_start", "cell_count",
)
_PLAN_ARRAYS = ("tile_start", "tile_len", "tile_cell", "pair_a", "pair_b")

# smallest device row bucket for the delta/tombstone aux tables: churny
# streams grow through few shapes before settling into pow2 doubling
_AUX_MIN_ROWS = 8


def _npz_path(path) -> str:
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


@dataclasses.dataclass(frozen=True)
class IndexView:
    """One request's consistent read snapshot of a mutable index.

    Pinned at request entry (``QueryService``): the frozen ``GridSnapshot``
    plus the churn arrays *as of that instant*.  All index mutation is
    copy-on-write (arrays are replaced, never written in place), so a view
    stays valid -- and keeps answering identically -- while inserts,
    deletes, or a ``compact`` swap land behind it.
    """

    epoch: int                    # compaction epoch the view pins
    snapshot: GridSnapshot        # the frozen base index
    snap_ids: np.ndarray          # (N,) int64 global id per snapshot row
    delta_ids: np.ndarray         # (m,) int64 global ids of live delta points
    delta_pts: np.ndarray         # (m, n) f32 their coords, ORIGINAL frame
    dead_rows: np.ndarray         # (d,) int64 tombstoned snapshot ROWS
    dead_pts: np.ndarray          # (d, n) f32 their coords, ORIGINAL frame
    delta_dev: Optional[torch.Tensor]  # (pow2 >= m, n) f32 device delta table
    dead_dev: Optional[torch.Tensor]   # (pow2 >= d, n) f32 device dead table
    live_count: int               # |snapshot| - |tombstones| + |delta|
    live_bounds: Tuple[np.ndarray, np.ndarray]  # per-dim (min, max) of the
                                  # live set, ORIGINAL frame, float64

    @property
    def delta_size(self) -> int:
        return int(self.delta_ids.shape[0])

    @property
    def tombstone_count(self) -> int:
        return int(self.dead_rows.shape[0])


@dataclasses.dataclass(frozen=True)
class PendingCompact:
    """The pure build half of a compaction, produced off the serving path.

    ``apply_compact`` refuses a pending snapshot whose ``mut_version`` no
    longer matches the index (mutations landed since the build started);
    the caller re-prepares against the new state.
    """

    snapshot: GridSnapshot
    snap_ids: np.ndarray
    mut_version: int


class SimilarityIndex:
    """Mutable, device-resident index over one evolving dataset.

    An ownership layer over ``SelfJoinEngine``: the engine's snapshot holds
    the REORDER permutation, the grid, the tile plan and the device-resident
    packed tiles; this class adds auto-k selection at build time, the
    insert/delete/compact churn machinery, and the persistence contract a
    serving process needs.

    ``k_candidates`` (optional) runs the paper's Sec. 5.6 memory-op model
    (``tuning.select_k``) over the given candidate list and bakes the winner
    into the stored config, so a restarted server never re-tunes.
    """

    def __init__(
        self,
        d: np.ndarray,
        config: SelfJoinConfig,
        engine_config: Optional[EngineConfig] = None,
        *,
        k_candidates: Optional[Sequence[int]] = None,
        auto_compact_fraction: Optional[float] = None,
        device="cuda",
    ):
        pts = np.ascontiguousarray(np.asarray(d, dtype=np.float32))
        if k_candidates is not None and pts.shape[0] > 2:
            k = select_k(
                pts, config.eps, list(k_candidates),
                reorder=config.reorder, sample_frac=config.sample_frac,
                tile_size=config.tile_size,
            )
            config = dataclasses.replace(config, k=k)
        if auto_compact_fraction is not None and auto_compact_fraction <= 0:
            raise ValueError(
                f"auto_compact_fraction must be > 0, "
                f"got {auto_compact_fraction}"
            )
        self.engine = SelfJoinEngine(pts, config, engine_config, device=device)
        n = pts.shape[0]
        self._init_churn_state(
            snap_ids=np.arange(n, dtype=np.int64),
            id_pts=pts.copy(),
            next_id=n,
            epoch=0,
            auto_compact_fraction=auto_compact_fraction,
        )

    def _init_churn_state(
        self,
        snap_ids: np.ndarray,
        id_pts: np.ndarray,
        next_id: int,
        epoch: int,
        delta_ids: Optional[np.ndarray] = None,
        delta_pts: Optional[np.ndarray] = None,
        dead_ids: Optional[np.ndarray] = None,
        auto_compact_fraction: Optional[float] = None,
    ) -> None:
        n_dims = self.engine.num_dims
        # delta-buffer spill policy: when set, insert() auto-compacts once
        # the delta outgrows this fraction of the snapshot (DESIGN.md #10)
        self.auto_compact_fraction = (
            None if auto_compact_fraction is None
            else float(auto_compact_fraction)
        )
        self.auto_compactions = 0     # spill-policy-triggered compactions
        self._snap_ids = np.asarray(snap_ids, np.int64)      # ascending
        self._id_pts = np.asarray(id_pts, np.float32)        # (next_id, n) log
        self._next_id = int(next_id)
        self.epoch = int(epoch)
        empty_ids = np.zeros(0, np.int64)
        empty_pts = np.zeros((0, n_dims), np.float32)
        self._delta_ids = (
            empty_ids if delta_ids is None else np.asarray(delta_ids, np.int64)
        )
        self._delta_pts = (
            empty_pts if delta_pts is None else np.asarray(delta_pts, np.float32)
        )
        self._dead_ids = (                                   # sorted, snapshot-side
            empty_ids if dead_ids is None else np.sort(np.asarray(dead_ids, np.int64))
        )
        # copy-on-write version counter: bumps on every mutation, keys the
        # device-table and live-bounds caches
        self._mut_version = 0
        self._delta_dev_cache: Optional[Tuple[int, torch.Tensor]] = None
        self._dead_dev_cache: Optional[Tuple[int, torch.Tensor]] = None
        self._bounds_cache = None

    @classmethod
    def _wrap(cls, engine: SelfJoinEngine) -> "SimilarityIndex":
        """An index over an engine already built (its snapshot becomes epoch
        0, ids ``0..N-1``), so a caller can serve it without a second build."""
        self = object.__new__(cls)
        self.engine = engine
        n = engine.num_points
        self._init_churn_state(
            snap_ids=np.arange(n, dtype=np.int64),
            id_pts=engine.snapshot.pts.copy(),
            next_id=n,
            epoch=0,
        )
        return self

    # -- introspection ----------------------------------------------------

    @property
    def config(self) -> SelfJoinConfig:
        return self.engine.config

    @property
    def num_points(self) -> int:
        """LIVE point count: snapshot minus tombstones plus delta."""
        return self.live_count

    @property
    def live_count(self) -> int:
        return (
            int(self._snap_ids.shape[0])
            - int(self._dead_ids.shape[0])
            + int(self._delta_ids.shape[0])
        )

    @property
    def delta_size(self) -> int:
        return int(self._delta_ids.shape[0])

    @property
    def tombstone_count(self) -> int:
        return int(self._dead_ids.shape[0])

    @property
    def num_dims(self) -> int:
        return self.engine.num_dims

    @property
    def device(self) -> torch.device:
        return self.engine.device

    @property
    def points(self) -> np.ndarray:
        """The SNAPSHOT dataset (original frame); excludes the delta buffer."""
        return self.engine.snapshot.pts

    @property
    def perm(self) -> Optional[np.ndarray]:
        """The persisted REORDER dim permutation (None when reorder=False)."""
        return self.engine.snapshot.perm

    @property
    def index_eps(self) -> Optional[float]:
        """Radius the current grid was built for (queries at <= this reuse it)."""
        return self.engine.snapshot.index_eps

    def coords_of(self, ids: np.ndarray) -> np.ndarray:
        """Coordinates (original frame, f32) of global ids, live or dead.

        The id->coordinates log is append-only and ids are never recycled,
        so this is stable under concurrent mutation and valid for any id a
        pinned view ever returned.
        """
        return self._id_pts[np.asarray(ids, np.int64)]

    def transform_queries(self, q: np.ndarray) -> np.ndarray:
        """Apply the dataset's REORDER permutation to external query points."""
        if self.perm is None:
            return np.asarray(q)
        return apply_reorder(q, self.perm)

    def bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-dimension (min, max) of the SNAPSHOT points, REORDERED frame.

        Kept for snapshot-level consumers; the serving tier's kNN cap uses
        ``live_bounds`` (original frame, live set) instead.
        """
        return self.engine.snapshot.data_bounds

    def live_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-dim (min, max) of the LIVE set, original frame, float64.

        Cached per mutation version: the serving tier reads this on every
        kNN request to cap its eps expansion, and the live set only changes
        when a mutation lands.
        """
        got = self._bounds_cache
        if got is not None and got[0] == self._mut_version:
            return got[1]
        parts = []
        snap_pts = self.engine.snapshot.pts
        if self._dead_ids.shape[0]:
            alive = np.ones(snap_pts.shape[0], bool)
            alive[np.searchsorted(self._snap_ids, self._dead_ids)] = False
            snap_pts = snap_pts[alive]
        if snap_pts.shape[0]:
            parts.append(snap_pts)
        if self._delta_pts.shape[0]:
            parts.append(self._delta_pts)
        if parts:
            live = np.concatenate(parts).astype(np.float64)
            val = (live.min(axis=0), live.max(axis=0))
        else:
            z = np.zeros(self.num_dims, np.float64)
            val = (z, z)
        self._bounds_cache = (self._mut_version, val)
        return val

    def prepare_query(
        self,
        q: np.ndarray,
        eps: Optional[float] = None,
        *,
        pad_queries_to: Optional[int] = None,
    ) -> Optional[QueryPlanTables]:
        """The engine's bipartite query-plan API (original-frame queries).

        Covers the SNAPSHOT only; a mutated index's delta/tombstone
        epilogue is the service's job (``QueryService``).
        """
        return self.engine.prepare_query(q, eps, pad_queries_to=pad_queries_to)

    # -- mutation ----------------------------------------------------------

    def _bump(self) -> None:
        self._mut_version += 1

    def insert(self, points: np.ndarray) -> np.ndarray:
        """Append new points; returns their freshly allocated global ids.

        The points land in the delta buffer -- no grid rebuild, no compiled
        program invalidated -- and are visible to the very next query (the
        service dense-joins the delta against every batch).  ``compact()``
        eventually folds them into a fresh snapshot; with
        ``auto_compact_fraction`` set, that happens here automatically once
        the delta outgrows that fraction of the snapshot (the spill
        policy), so answers before and after the spill stay bit-identical
        by the compaction contract.
        """
        pts = np.ascontiguousarray(np.asarray(points, dtype=np.float32))
        if pts.ndim != 2 or pts.shape[1] != self.num_dims:
            raise ValueError(
                f"expected (m, {self.num_dims}) points, got {pts.shape}"
            )
        m = pts.shape[0]
        ids = np.arange(self._next_id, self._next_id + m, dtype=np.int64)
        if m == 0:
            return ids
        with obs.span("index.insert", "index", m=m, delta=self.delta_size):
            self._id_pts = np.concatenate([self._id_pts, pts])
            self._delta_ids = np.concatenate([self._delta_ids, ids])
            self._delta_pts = np.concatenate([self._delta_pts, pts])
            self._next_id += m
            self._bump()
            obs.inc("index_inserts_total", m)
            self._maybe_auto_compact()
        return ids

    def _maybe_auto_compact(self) -> None:
        """The delta-buffer spill policy: compact when the delta outgrows
        ``auto_compact_fraction`` of the snapshot (floor 1 row, so an index
        born empty still converges instead of thrashing)."""
        frac = self.auto_compact_fraction
        if frac is None:
            return
        threshold = frac * max(int(self._snap_ids.shape[0]), 1)
        if self.delta_size > threshold:
            with obs.span(
                "index.auto_compact", "index",
                delta=self.delta_size, snapshot=int(self._snap_ids.shape[0]),
            ):
                self.apply_compact(self.prepare_compact())
            self.auto_compactions += 1
            obs.inc("index_auto_compactions_total")

    def delete(self, ids) -> int:
        """Delete live points by global id; returns how many were removed.

        Snapshot points get a tombstone (masked out of every answer at the
        query epilogue until ``compact`` drops the row); delta points are
        simply removed from the buffer.  Raises ``KeyError`` if any id is
        unknown or already deleted -- duplicates within one call are
        collapsed first.
        """
        ids = np.unique(np.asarray(ids, dtype=np.int64).reshape(-1))
        if ids.size == 0:
            return 0
        in_delta = np.isin(ids, self._delta_ids)
        snap_side = ids[~in_delta]
        if snap_side.size:
            pos = np.searchsorted(self._snap_ids, snap_side)
            pos_ok = pos < self._snap_ids.shape[0]
            known = np.zeros(snap_side.shape[0], bool)
            known[pos_ok] = (
                self._snap_ids[pos[pos_ok]] == snap_side[pos_ok]
            )
            bad = snap_side[~known | np.isin(snap_side, self._dead_ids)]
            if bad.size:
                raise KeyError(
                    f"cannot delete unknown or already-deleted ids {bad.tolist()}"
                )
        with obs.span("index.delete", "index", m=int(ids.size)):
            if in_delta.any():
                keep = ~np.isin(self._delta_ids, ids)
                self._delta_ids = self._delta_ids[keep]
                self._delta_pts = self._delta_pts[keep]
            if snap_side.size:
                self._dead_ids = np.union1d(self._dead_ids, snap_side)
            self._bump()
            obs.inc("index_deletes_total", int(ids.size))
        return int(ids.size)

    def prepare_compact(self) -> PendingCompact:
        """Pure build half of a compaction: a fresh snapshot over the live set.

        No index state changes -- safe to run on a background thread while
        the foreground keeps serving (and mutating).  The rebuilt snapshot
        keeps the current permutation frame and carries the current
        snapshot's shape buckets forward as floors, so applying it
        invalidates no warm executable whose bucket still fits.
        """
        with obs.span(
            "index.prepare_compact", "index",
            live=self.live_count, delta=self.delta_size,
            tombstones=int(self._dead_ids.shape[0]),
        ):
            old = self.engine.snapshot
            alive = np.ones(self._snap_ids.shape[0], bool)
            if self._dead_ids.shape[0]:
                alive[np.searchsorted(self._snap_ids, self._dead_ids)] = False
            live_ids = np.concatenate([self._snap_ids[alive], self._delta_ids])
            srt = np.argsort(live_ids, kind="stable")
            live_ids = live_ids[srt]
            live_pts = self.coords_of(live_ids)
            perm = old.perm if old.num_points else "auto"
            snapshot = GridSnapshot.build(
                live_pts, self.config, old.index_eps,
                perm=perm,
                device=old.device,
                min_tile_rows=old.tile_rows,
                min_point_rows=old.point_rows,
                min_dense_rows=old.dense_rows,
            )
            return PendingCompact(
                snapshot=snapshot,
                snap_ids=live_ids,
                mut_version=self._mut_version,
            )

    def apply_compact(self, pending: PendingCompact) -> None:
        """Atomically swap a prepared snapshot in and reset the churn state.

        One reference assignment plus array replacements -- a request that
        pinned an ``IndexView`` before this call keeps its old epoch and
        answers unchanged.  Raises ``RuntimeError`` if mutations landed
        since ``prepare_compact`` (the pending snapshot is stale; re-prepare).
        """
        if pending.mut_version != self._mut_version:
            raise RuntimeError(
                "index mutated since prepare_compact(); rebuild the pending "
                "snapshot against the current state"
            )
        with obs.span(
            "index.apply_compact", "index",
            epoch=self.epoch + 1, n=int(pending.snap_ids.shape[0]),
        ):
            self.engine.swap_snapshot(pending.snapshot)
            self._snap_ids = pending.snap_ids
            self._delta_ids = np.zeros(0, np.int64)
            self._delta_pts = np.zeros((0, self.num_dims), np.float32)
            self._dead_ids = np.zeros(0, np.int64)
            self.epoch += 1
            self._bump()
            obs.inc("index_compactions_total")

    def compact(self) -> "SimilarityIndex":
        """Rebuild the snapshot over the live set and swap it in (both halves)."""
        self.apply_compact(self.prepare_compact())
        return self

    # -- pinned views ------------------------------------------------------

    def _aux_table(self, pts: np.ndarray) -> torch.Tensor:
        """``pts`` on the index's device, rows padded to a pow2 bucket."""
        rows = bucket_rows(pts.shape[0], _AUX_MIN_ROWS)
        return torch.from_numpy(np.ascontiguousarray(pad_axis0(pts, rows))).to(self.device)

    def _delta_device(self) -> Optional[torch.Tensor]:
        """Delta coords on device, pow2-padded rows; None when empty."""
        m = self._delta_pts.shape[0]
        if m == 0:
            return None
        got = self._delta_dev_cache
        if got is None or got[0] != self._mut_version:
            got = (self._mut_version, self._aux_table(self._delta_pts))
            self._delta_dev_cache = got
        return got[1]

    def _dead_device(self) -> Optional[torch.Tensor]:
        """Tombstoned coords on device, pow2-padded rows; None when empty."""
        d = self._dead_ids.shape[0]
        if d == 0:
            return None
        got = self._dead_dev_cache
        if got is None or got[0] != self._mut_version:
            got = (self._mut_version, self._aux_table(self._id_pts[self._dead_ids]))
            self._dead_dev_cache = got
        return got[1]

    def view(self) -> IndexView:
        """Pin the current epoch: the consistent read snapshot of one request."""
        dead_rows = np.searchsorted(self._snap_ids, self._dead_ids)
        return IndexView(
            epoch=self.epoch,
            snapshot=self.engine.snapshot,
            snap_ids=self._snap_ids,
            delta_ids=self._delta_ids,
            delta_pts=self._delta_pts,
            dead_rows=dead_rows.astype(np.int64),
            dead_pts=self._id_pts[self._dead_ids],
            delta_dev=self._delta_device(),
            dead_dev=self._dead_device(),
            live_count=self.live_count,
            live_bounds=self.live_bounds(),
        )

    # -- persistence -------------------------------------------------------

    def save(self, path) -> str:
        """Write dataset + index + churn state to ``path`` (.npz); return it."""
        eng = self.engine
        snap = eng.snapshot
        meta = {
            "version": _SAVE_VERSION,
            "config": dataclasses.asdict(eng.config),
            "index_eps": snap.index_eps,
            "has_perm": snap.perm is not None,
            "has_index": snap.grid is not None,
            "epoch": self.epoch,
            "next_id": self._next_id,
            "auto_compact_fraction": self.auto_compact_fraction,
        }
        arrays = {
            "pts": snap.pts,
            "snap_ids": self._snap_ids,
            "id_pts": self._id_pts,
            "delta_ids": self._delta_ids,
            "delta_pts": self._delta_pts,
            "dead_ids": self._dead_ids,
        }
        if snap.perm is not None:
            arrays["perm"] = np.asarray(snap.perm)
        if snap.grid is not None:
            g, p = snap.grid, snap.plan
            meta["grid"] = {
                "eps": g.eps, "k": g.k, "n": g.n, "u_dim": g.u_dim,
            }
            meta["plan"] = {
                "tile_size": p.tile_size,
                "num_tile_pairs_total": p.num_tile_pairs_total,
                "num_candidates": p.num_candidates,
            }
            for name in _GRID_ARRAYS:
                arrays[f"grid_{name}"] = getattr(g, name)
            for name in _PLAN_ARRAYS:
                arrays[f"plan_{name}"] = getattr(p, name)
        path = _npz_path(path)
        with open(path, "wb") as f:
            np.savez_compressed(f, meta=np.array(json.dumps(meta)), **arrays)
        return path

    @classmethod
    def load(
        cls, path, engine_config: Optional[EngineConfig] = None, *, device="cuda"
    ) -> "SimilarityIndex":
        """Rebuild the index from ``save`` output without host recompute, on
        ``device``.  Reads the files of either package."""
        with np.load(_npz_path(path), allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            if meta["version"] != _SAVE_VERSION:
                raise ValueError(
                    f"unsupported index save version {meta['version']}"
                )
            pts = z["pts"]
            perm = z["perm"] if meta["has_perm"] else None
            grid = plan = None
            if meta["has_index"]:
                grid = GridIndex(
                    **meta["grid"],
                    **{name: z[f"grid_{name}"] for name in _GRID_ARRAYS},
                )
                plan = TilePlan(
                    **meta["plan"],
                    **{name: z[f"plan_{name}"] for name in _PLAN_ARRAYS},
                )
            config = SelfJoinConfig(**meta["config"])
            engine = SelfJoinEngine.from_prebuilt(
                pts, perm, grid, plan, meta["index_eps"], config, engine_config,
                device=device,
            )
            self = object.__new__(cls)
            self.engine = engine
            self._init_churn_state(
                snap_ids=z["snap_ids"],
                id_pts=z["id_pts"],
                next_id=meta["next_id"],
                epoch=meta["epoch"],
                delta_ids=z["delta_ids"],
                delta_pts=z["delta_pts"],
                dead_ids=z["dead_ids"],
                # additive meta key: absent in version-2 saves from before
                # the spill policy existed
                auto_compact_fraction=meta.get("auto_compact_fraction"),
            )
        return self
