"""Core datatypes for the similarity self-join.

The vocabulary follows the paper (Gowanlock & Karsin 2018):
  D        -- database of |D| points in n dimensions, coordinates in [0,1]
  eps      -- Euclidean search distance
  k        -- number of indexed dimensions (Section 4.1), 2 <= k <= n
  REORDER  -- dimensionality reordering by variance (Section 4.2)
  SORTIDU  -- sort/window on the first un-indexed dimension u (Section 4.3)
  SHORTC   -- short-circuited distance accumulation (Section 4.4),
              realised as dimension-blocked pruning of tile pairs (DESIGN.md #1.2)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class SelfJoinConfig:
    """Configuration mirroring GPU-Join's knobs (paper Alg. 1)."""

    eps: float
    k: int = 6                   # indexed dimensions (paper uses k=6 throughout Sec. 5)
    reorder: bool = True         # REORDER (Sec. 4.2)
    sortidu: bool = True         # SORTIDU (Sec. 4.3) -> tile u-window pruning
    shortc: bool = True          # SHORTC (Sec. 4.4) -> dimension-blocked pruning
    tile_size: int = 64          # points per tile (the CUDA kernels take T <= 128)
    dim_block: int = 32          # dims per SHORTC block (padded)
    sample_frac: float = 0.01    # variance / result-size sampling fraction (Sec. 4.2, 5.6)
    batch_size: int = 10**8      # b_s, result pairs per batch (paper Sec. 3.2.2)
    min_batches: int = 3         # n_b >= 3 (paper: >= 3 CUDA streams)
    use_pallas: bool = False     # kept for config parity with the JAX package; a CUDA
                                 # tensor always runs the CUDA kernel, a CPU tensor
                                 # always its plain PyTorch version
    execution: str = "indexed"   # "indexed" | "dense" | "auto" tier dispatch;
                                 # "auto" picks by cost model (DESIGN.md #9)

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.eps < 0:
            raise ValueError(f"eps must be >= 0, got {self.eps}")
        if self.execution not in ("auto", "indexed", "dense"):
            raise ValueError(
                f"execution must be 'auto', 'indexed' or 'dense', "
                f"got {self.execution!r}"
            )


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Knobs of the device-resident ``SelfJoinEngine`` (DESIGN.md #1.5).

    The engine evaluates the candidate tile-pair list in fixed-size chunks;
    eps is a runtime kernel argument, so one built kernel serves every chunk,
    call and eps value.
    """

    count_chunk: int = 4096      # tile pairs per counts-mode device program
    pairs_chunk: int = 1024      # tile pairs per pairs-mode device program
    max_pairs: Optional[int] = None  # pairs-buffer capacity; None -> auto-size
    auto_grow: bool = True       # on auto-sized overflow, regrow to the
                                 # measured |R| (known after the pass) and retry
    pairs_headroom: float = 2.0  # auto capacity = headroom * estimated |R|
    interpret: bool = True       # kept for config parity; does not select the plain
                                 # version on the card

    def __post_init__(self):
        if self.count_chunk < 1 or self.pairs_chunk < 1:
            raise ValueError("chunk sizes must be >= 1")
        if self.max_pairs is not None and self.max_pairs < 0:
            raise ValueError(f"max_pairs must be >= 0, got {self.max_pairs}")


@dataclasses.dataclass
class SelfJoinStats:
    """Work counters used by the paper's evaluation (Secs. 5.5-5.7)."""

    num_points: int = 0
    num_dims: int = 0
    k: int = 0
    num_nonempty_cells: int = 0          # |G|
    num_tiles: int = 0
    num_tile_pairs_total: int = 0        # before SORTIDU window pruning
    num_tile_pairs_evaluated: int = 0    # after pruning
    num_candidates: int = 0              # point comparisons (mu in Sec. 5.6)
    num_results: int = 0                 # |R| including self-pairs
    dim_blocks_skipped: int = 0          # SHORTC effect (tile-level)
    dim_blocks_total: int = 0
    num_chunks: int = 0                  # device programs dispatched (engine)
    pairs_capacity: int = 0              # preallocated pairs buffer rows (engine)
    overflow_retries: int = 0            # auto-grow retries in pairs mode (engine)
    num_workers: int = 0                 # |p| (distributed engine)
    num_rounds: int = 0                  # ring rounds executed (= |p|)
    worker_pair_cursors: tuple = ()      # per-worker final pairs-buffer cursor
                                         # (exact pairs found, even past capacity)
    worker_max_chunk_hits: tuple = ()    # per-worker largest per-chunk hit count
                                         # (> hit_cap means the rank window clipped)
    num_device_dispatches: int = 0       # host->device chunk-program launches
                                         # per join (fused ring: exactly 1)
    num_candidates_dense: int = 0        # |Q| x |E| sum a dense ring pass would do
    comm_elements: int = 0               # ring transport volume, (|p|-1)|D| points
    execution: str = ""                  # tier that ran: "indexed" | "dense"
    cost_indexed: float = 0.0            # cost model's indexed-tier estimate
    cost_dense: float = 0.0              # cost model's dense-tier estimate

    @property
    def candidate_filter_ratio(self) -> float:
        """Fraction of the dense candidate volume the index actually evaluated."""
        if self.num_candidates_dense == 0:
            return 1.0
        return self.num_candidates / self.num_candidates_dense

    @property
    def selectivity(self) -> float:
        """S_D = (|R| - |D|) / |D|   (paper Eq. 1)."""
        if self.num_points == 0:
            return 0.0
        return (self.num_results - self.num_points) / self.num_points


@dataclasses.dataclass
class SelfJoinResult:
    """Result of a self-join.

    ``counts[i]`` is the number of points within eps of point i (including
    itself), indexed in the ORIGINAL point order.  ``pairs`` (optional) holds
    ordered (key, value) index pairs as in the paper's key/value result
    buffer; both (a,b) and (b,a) appear, as does (a,a).
    """

    counts: np.ndarray
    stats: SelfJoinStats
    pairs: Optional[np.ndarray] = None   # (num_results, 2) int32, original ids

    @property
    def total_results(self) -> int:
        return int(self.counts.sum())
