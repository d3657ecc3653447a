"""Immutable data snapshot of the self-join engine (DESIGN.md #10).

The port of ``repro.core.snapshot``.  ``GridSnapshot`` holds everything
derived from the point set -- the points, the REORDER permutation, the
grid, the tile plan, the device tile tables and the lazy dense-tier tables
-- on one ``torch.device``.  ``SelfJoinEngine`` holds only configuration,
so swapping a new snapshot behind an engine is one reference assignment.

Shape buckets: the device tile table (``tile_rows``), the combined
bipartite order's data segment (``point_rows``) and the dense tile table
(``dense_rows``) are padded to power-of-two row buckets
(``grid.bucket_rows``), and ``rebuilt`` and the mutable index's ``compact``
carry the old buckets forward as floors, exactly as in the JAX package, so
a rebuild whose data still fits the old buckets presents the same table
shapes to the serving tier (no new workspace, ``ServiceStats.num_traces``
stays 0).  Padding tile rows carry ``tile_len == 0`` and are never
referenced by a candidate pair list.

``snapshot_from_numpy`` carries a snapshot across packages: it takes the
JAX package's ``GridSnapshot`` arrays as numpy and places them on a device.

The build's phases are spans (cat ``plan``) inside the engine's
``engine.snapshot_build`` / ``engine.snapshot_rebuild``: ``snapshot.reorder``
(absent without REORDER), ``snapshot.grid``, ``snapshot.tile_plan`` and
``snapshot.tables`` (the device placement); the lazy parts are spans of the
join that first needs them, on a cache miss only: ``snapshot.dense_tables``
and ``snapshot.chunks`` (a chunk size's padded pair list on the device).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.grid import (
    GridIndex,
    TilePlan,
    bucket_rows,
    build_grid,
    build_tile_plan,
    pad_axis0,
)
from repro_torch.core.reorder import apply_reorder, variance_reorder
from repro_torch.core.types import SelfJoinConfig
from repro_torch.kernels import ops

# sentinel for GridSnapshot.build's perm argument: "compute it from the
# config", as opposed to an explicit permutation (or explicit None)
_AUTO_PERM = "auto"

Chunk = Tuple[torch.Tensor, torch.Tensor, int]


def resolve_device(device) -> torch.device:
    """The ``torch.device`` an entry point runs on; raises rather than fall back.

    ``"cuda"`` (the default of every entry point) needs a card: without one
    this raises, and the caller must ask for ``device="cpu"`` explicitly,
    where every kernel runs its plain PyTorch version.
    """
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a cuda or cpu device, got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    return dev


def _chunk_list(
    pair_a: np.ndarray, pair_b: np.ndarray, chunk: int, cache: dict, device,
    span: Optional[str] = None,
) -> List[Chunk]:
    """Padded device chunks of a candidate pair list, cached per chunk size;
    a miss is traced as ``span`` where one is named."""
    got = cache.get(chunk)
    if got is None:
        with obs.span(span, "plan", chunk=chunk) if span else contextlib.nullcontext():
            got = [
                (pa, pb, real)
                for _, pa, pb, real in ops._chunks(pair_a, pair_b, chunk, device)
            ]
        cache[chunk] = got
    return got


def make_dense_plan(n_points: int, tile_size: int) -> TilePlan:
    """Sequential full-tile plan: the dense tier's work list.

    The dense tier re-tiles ``pts_sorted`` sequentially -- every tile full
    except the last -- and lists the complete tile cross product.  Same
    ``TilePlan`` type, same chunk steps downstream.
    """
    t = int(tile_size)
    num_tiles = -(-int(n_points) // t) if n_points else 0
    tile_start = np.arange(num_tiles, dtype=np.int64) * t
    tile_len = np.minimum(int(n_points) - tile_start, t)
    idx = np.arange(num_tiles, dtype=np.int64)
    return TilePlan(
        tile_size=t,
        tile_start=tile_start.astype(np.int32),
        tile_len=tile_len.astype(np.int32),
        tile_cell=np.zeros(num_tiles, np.int32),  # no cells in the dense tier
        pair_a=np.repeat(idx, num_tiles).astype(np.int32),
        pair_b=np.tile(idx, num_tiles).astype(np.int32),
        num_tile_pairs_total=num_tiles * num_tiles,
        num_candidates=int(n_points) * int(n_points),
    )


@dataclasses.dataclass
class DenseTables:
    """Device-resident dense-tier twin of the snapshot's indexed tables."""

    plan: TilePlan
    tiles: torch.Tensor       # (dense_rows, T, n_pad) f32, sequential layout
    tile_len: torch.Tensor    # (dense_rows,) int32; padding rows are 0
    tile_start: torch.Tensor  # (dense_rows,) int32 into pts_sorted
    _chunk_cache: Dict[int, list] = dataclasses.field(default_factory=dict)

    def chunks(self, chunk: int) -> List[Chunk]:
        return _chunk_list(self.plan.pair_a, self.plan.pair_b, chunk,
                           self._chunk_cache, self.tiles.device, "snapshot.chunks")


class GridSnapshot:
    """One dataset's complete, frozen index state, resident on ``device``.

    Construct via ``build`` (REORDER, grid, tile plan, device placement),
    ``from_arrays`` (arrays already built, only device placement runs) or
    ``rebuilt`` (same points at a larger radius, same permutation, buckets
    floored at this snapshot's).
    """

    __slots__ = (
        "config", "device", "pts", "perm", "work", "index_eps", "grid", "plan",
        "num_points", "num_dims", "tile_rows", "point_rows", "dense_rows",
        "tiles", "tile_len", "tile_start", "point_order",
        "point_order_padded", "_dense", "_chunk_cache",
    )

    def __init__(
        self,
        config: SelfJoinConfig,
        pts: np.ndarray,
        perm: Optional[np.ndarray],
        work: np.ndarray,
        index_eps: Optional[float],
        grid: Optional[GridIndex],
        plan: Optional[TilePlan],
        *,
        device,
        min_tile_rows: int = 1,
        min_point_rows: int = 1,
        min_dense_rows: int = 1,
    ):
        self.config = config
        self.device = resolve_device(device)
        self.pts = pts
        self.perm = perm
        self.work = work
        self.index_eps = None if index_eps is None else float(index_eps)
        self.grid = grid
        self.plan = plan
        self.num_points, self.num_dims = pts.shape
        n_tiles = plan.num_tiles if plan is not None else 0
        self.tile_rows = bucket_rows(n_tiles, min_tile_rows)
        self.point_rows = bucket_rows(self.num_points, min_point_rows)
        self.dense_rows = bucket_rows(
            -(-self.num_points // config.tile_size), min_dense_rows
        )
        self._dense: Optional[DenseTables] = None
        self._chunk_cache: dict = {}
        if grid is not None:
            with obs.span("snapshot.tables", "plan", tiles=n_tiles):
                self.tile_start = self._int32(pad_axis0(plan.tile_start, self.tile_rows))
                self.tile_len = self._int32(pad_axis0(plan.tile_len, self.tile_rows))
                # the grid-sort permutation (position -> original id) at its real
                # length (count scatters and _unsort_counts address exactly N rows) ...
                self.point_order = self._int32(grid.point_order)
                # ... and padded to the bucket for the combined bipartite order,
                # so the (query | data) order keeps one shape per bucket across
                # snapshot swaps (pad rows are never decoded)
                self.point_order_padded = self._int32(pad_axis0(grid.point_order, self.point_rows))
                self.tiles = ops.make_tiles_device(
                    torch.from_numpy(grid.pts_sorted).to(self.device),
                    self.tile_start,
                    self.tile_len,
                    tile_size=config.tile_size,
                    dim_block=config.dim_block,
                )
        else:
            self.tiles = None
            self.tile_len = None
            self.tile_start = None
            self.point_order = None
            self.point_order_padded = None

    def _int32(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(self.device)

    # -- constructors ------------------------------------------------------

    @classmethod
    def build(
        cls,
        d: np.ndarray,
        config: SelfJoinConfig,
        eps: Optional[float] = None,
        *,
        perm=_AUTO_PERM,
        device="cuda",
        min_tile_rows: int = 1,
        min_point_rows: int = 1,
        min_dense_rows: int = 1,
    ) -> "GridSnapshot":
        """Full index build: REORDER (unless ``perm`` is given), grid, plan.

        An explicit ``perm`` (or ``None``) reuses a previous snapshot's frame
        -- ``compact`` does this so the rebuilt index bins points identically
        to the one it replaces.
        """
        dev = resolve_device(device)  # before any host work
        pts = np.ascontiguousarray(np.asarray(d, dtype=np.float32))
        eps = config.eps if eps is None else float(eps)
        auto = isinstance(perm, str) and perm == _AUTO_PERM
        reorders = bool(config.reorder and pts.shape[0]) if auto else perm is not None
        with obs.span("snapshot.reorder", "plan") if reorders else contextlib.nullcontext():
            if auto:
                perm = variance_reorder(pts, config.sample_frac)[1] if reorders else None
            elif perm is not None:
                perm = np.asarray(perm)
            work = pts if perm is None else apply_reorder(pts, perm)
        grid = plan = None
        index_eps = None
        if pts.shape[0]:
            with obs.span("snapshot.grid", "plan"):
                grid = build_grid(work, eps, config.k)  # eps=0-safe (unit bins)
            with obs.span("snapshot.tile_plan", "plan") as sp:
                plan = build_tile_plan(grid, config.tile_size, config.sortidu)
                sp.set(tiles=plan.num_tiles, pairs=plan.num_pairs)
            index_eps = float(eps)
        return cls(
            config, pts, perm, work, index_eps, grid, plan,
            device=dev,
            min_tile_rows=min_tile_rows,
            min_point_rows=min_point_rows,
            min_dense_rows=min_dense_rows,
        )

    @classmethod
    def from_arrays(
        cls,
        pts: np.ndarray,
        perm: Optional[np.ndarray],
        grid: Optional[GridIndex],
        plan: Optional[TilePlan],
        index_eps: Optional[float],
        config: SelfJoinConfig,
        *,
        device="cuda",
        min_tile_rows: int = 1,
        min_point_rows: int = 1,
        min_dense_rows: int = 1,
    ) -> "GridSnapshot":
        """Snapshot over already-built arrays: only device placement runs.

        The persistence re-entry path (``SimilarityIndex.load`` via
        ``SelfJoinEngine.from_prebuilt``): a restarted server re-places the
        saved (perm, grid, plan) triple and serves as the process that saved
        it did.
        """
        pts = np.ascontiguousarray(np.asarray(pts, dtype=np.float32))
        perm = None if perm is None else np.asarray(perm)
        work = pts if perm is None else apply_reorder(pts, perm)
        return cls(
            config, pts, perm, work, index_eps, grid, plan,
            device=device,
            min_tile_rows=min_tile_rows,
            min_point_rows=min_point_rows,
            min_dense_rows=min_dense_rows,
        )

    def rebuilt(self, eps: float) -> "GridSnapshot":
        """Same points, same permutation, new grid at ``eps``, buckets floored."""
        return GridSnapshot.build(
            self.pts, self.config, eps,
            perm=self.perm,
            device=self.device,
            min_tile_rows=self.tile_rows,
            min_point_rows=self.point_rows,
            min_dense_rows=self.dense_rows,
        )

    # -- derived views -----------------------------------------------------

    @property
    def n_pad(self) -> int:
        """Padded dimension count of the tile layout (n -> dim_block multiple)."""
        db = self.config.dim_block
        return ((self.num_dims + db - 1) // db) * db

    @property
    def num_dim_blocks(self) -> int:
        return self.tiles.shape[2] // self.config.dim_block

    @property
    def data_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-dimension (min, max) of the snapshot points, reordered frame."""
        if self.grid is not None:
            return self.grid.data_bounds
        z = np.zeros(self.num_dims, np.float64)
        return z, z

    def chunks(self, chunk: int) -> List[Chunk]:
        """Padded device chunks of the self-join candidate pair list."""
        return _chunk_list(
            self.plan.pair_a, self.plan.pair_b, chunk, self._chunk_cache, self.device,
            "snapshot.chunks",
        )

    def dense_tables(self) -> DenseTables:
        """Build (lazily, once per snapshot) the dense-tier tables."""
        if self._dense is None:
            cfg = self.config
            with obs.span("snapshot.dense_tables", "plan"):
                plan = make_dense_plan(self.num_points, cfg.tile_size)
                start = self._int32(pad_axis0(plan.tile_start, self.dense_rows))
                length = self._int32(pad_axis0(plan.tile_len, self.dense_rows))
                tiles = ops.make_tiles_device(
                    torch.from_numpy(self.grid.pts_sorted).to(self.device),
                    start,
                    length,
                    tile_size=cfg.tile_size,
                    dim_block=cfg.dim_block,
                )
            self._dense = DenseTables(
                plan=plan, tiles=tiles, tile_len=length, tile_start=start
            )
        return self._dense

    def packed_tile_table(self, num_tiles: int) -> Tuple[np.ndarray, np.ndarray]:
        """Host-side ``(tiles, tile_len)`` padded to ``num_tiles`` rows.

        The fused ring's payload (``core/dist_engine.py``): every shard's
        tile table is padded to the fleet-wide maximum so all ring
        positions run one shape; padding rows carry ``tile_len == 0``, so
        they contribute nothing wherever a padded pair list references them.
        """
        t = self.config.tile_size
        tiles = np.zeros((num_tiles, t, self.n_pad), np.float32)
        tile_len = np.zeros(num_tiles, np.int32)
        if self.plan is not None and self.plan.num_tiles:
            real, lens = ops.make_tiles(
                self.grid.pts_sorted,
                self.plan.tile_start,
                self.plan.tile_len,
                t,
                self.config.dim_block,
            )
            tiles[: real.shape[0]] = real
            tile_len[: lens.shape[0]] = lens
        return tiles, tile_len


def snapshot_from_numpy(fields: dict, config: SelfJoinConfig, device="cuda") -> GridSnapshot:
    """The port's ``GridSnapshot`` over another package's snapshot arrays.

    ``fields`` holds numpy arrays and scalars under ``"pts"``, ``"perm"``
    (or None), ``"index_eps"`` (or None), ``"grid"`` (a dict of every
    ``GridIndex`` field, or None) and ``"plan"`` (a dict of every
    ``TilePlan`` field, or None) -- e.g. ``dataclasses.asdict`` of the JAX
    package's ``GridSnapshot.grid`` / ``.plan``.  The counterpart of
    ``repro.core.snapshot.GridSnapshot.from_arrays``.
    """
    grid = fields.get("grid")
    plan = fields.get("plan")
    return GridSnapshot.from_arrays(
        fields["pts"],
        fields.get("perm"),
        None if grid is None else GridIndex(**grid),
        None if plan is None else TilePlan(**plan),
        fields.get("index_eps"),
        config,
        device=device,
    )
