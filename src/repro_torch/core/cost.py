"""Cost model for hybrid dense/indexed execution dispatch (DESIGN.md #9).

The paper's optimization (i) is a filtering-vs-overhead trade-off: the grid
index prunes candidate pairs, but its tiles follow cell boundaries, so when
cells hold few points the indexed tier evaluates many partially-filled
``T x T`` tile pairs -- lane-work far above the surviving candidate count.
The dense tier re-tiles the data into *full* tiles and evaluates the
complete cross product with no per-pair branching.  Which tier
is cheaper is a property of the grid probe stats, known before any kernel
runs:

  indexed lane-work  =  (evaluated tile pairs) x T^2 x n_pad
  dense   lane-work  =  ceil(|A|/T) x ceil(|B|/T) x T^2 x n_pad

plus, for each tier, an epilogue term proportional to its candidate volume
(the scatter/compaction work per point comparison).  Both tiers run through
the same chunk programs, so per-pair dispatch overhead cancels out of the
comparison and is not modeled.

This is the within-one-accelerator analogue of the CPU/GPU work split of
the Hybrid KNN-Join paper (arXiv:1810.04758): route the request to the
executor whose modeled work is lower, using ``stats.candidate_filter_ratio``
as the online signal the model is calibrated against.  All costs are
deterministic functions of plan shape, so a recorded ``(cost_indexed,
cost_dense)`` pair fully explains the recorded dispatch decision --
``decide(ci, cd).execution == ("dense" if cd < ci else "indexed")``.
"""
from __future__ import annotations

import dataclasses

# Relative weight of the per-candidate epilogue (count scatter-add or pairs
# compaction, one lane op per point comparison) against one multiply-add lane op.
# Both tiers pay it over their own candidate volume; it only matters when
# n_pad is small enough that the matmul no longer dominates.
EPILOGUE_WEIGHT = 1.0

EXECUTION_MODES = ("auto", "indexed", "dense")


@dataclasses.dataclass(frozen=True)
class TierDecision:
    """One dispatch decision plus the two estimates that explain it."""

    execution: str        # tier that will run: "indexed" | "dense"
    cost_indexed: float   # modeled lane-work of the indexed tier
    cost_dense: float     # modeled lane-work of the dense tier
    forced: bool = False  # True when config pinned the tier (no comparison)


def tile_pair_lane_ops(tile_size: int, n_pad: int) -> float:
    """Multiply-add lane ops to evaluate one T x T tile pair over n_pad dimensions."""
    return float(tile_size) * float(tile_size) * float(max(n_pad, 1))


def indexed_join_cost(
    num_tile_pairs: int,
    num_candidates: int,
    tile_size: int,
    n_pad: int,
) -> float:
    """Modeled lane-work of the indexed tier for one (self- or bipartite) join.

    ``num_tile_pairs`` is the SORTIDU-pruned candidate tile-pair count (the
    fan-out term: partially-filled tiles make it exceed the ideal
    ``candidates / T^2``); ``num_candidates`` the surviving point
    comparisons (the epilogue term).
    """
    return (
        float(num_tile_pairs) * tile_pair_lane_ops(tile_size, n_pad)
        + EPILOGUE_WEIGHT * float(num_candidates)
    )


def dense_join_cost(n_a: int, n_b: int, tile_size: int, n_pad: int) -> float:
    """Modeled lane-work of the dense tier: full-tile cross product.

    ``n_a`` / ``n_b`` are the two point-set sizes (equal for a self-join);
    the candidate volume is all ``n_a * n_b`` ordered pairs.
    """
    t = max(int(tile_size), 1)
    tiles_a = -(-max(int(n_a), 0) // t)
    tiles_b = -(-max(int(n_b), 0) // t)
    return (
        float(tiles_a) * float(tiles_b) * tile_pair_lane_ops(t, n_pad)
        + EPILOGUE_WEIGHT * float(n_a) * float(n_b)
    )


def decide(
    cost_indexed: float, cost_dense: float, mode: str = "auto"
) -> TierDecision:
    """Resolve an execution mode against the two cost estimates.

    ``"auto"`` picks the cheaper tier; ties go to the indexed tier (the
    paper's path, and the one with filtering stats).  Forced modes keep both
    estimates in the decision so stats always record what the model thought.
    """
    if mode not in EXECUTION_MODES:
        raise ValueError(
            f"unknown execution mode {mode!r}; expected one of {EXECUTION_MODES}"
        )
    if mode != "auto":
        return TierDecision(
            execution=mode, cost_indexed=float(cost_indexed),
            cost_dense=float(cost_dense), forced=True,
        )
    chosen = "dense" if cost_dense < cost_indexed else "indexed"
    return TierDecision(
        execution=chosen, cost_indexed=float(cost_indexed),
        cost_dense=float(cost_dense),
    )
