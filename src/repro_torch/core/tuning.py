"""Selecting the number of indexed dimensions k (paper Section 5.6).

The paper's memory-operation model:

  search ops   = |D| * 3^k * log2(|G|)        (adjacent-cell binary searches)
  compare ops  = mu * (1/f)                   (sampled point comparisons)

A good k minimizes the total.  The model is reproduced exactly: for each
candidate k the grid is built, a fraction f of the candidate workload is
sampled for mu, and both terms are reported, plus an argmin helper.  A copy
of ``repro.core.tuning`` (host numpy only), so that ``SimilarityIndex(...,
k_candidates=...)`` picks the same k in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from repro_torch.core.grid import build_grid, build_tile_plan
from repro_torch.core.reorder import variance_reorder


@dataclasses.dataclass
class KEstimate:
    k: int
    num_cells: int                # |G|
    search_ops: float             # |D| * 3^k * log2(|G|)
    compare_ops: float            # mu / f
    total_ops: float


def estimate_k_costs(
    d: np.ndarray,
    eps: float,
    ks: Sequence[int],
    *,
    reorder: bool = True,
    sample_frac: float = 0.01,
    tile_size: int = 64,
    seed: int = 0,
) -> List[KEstimate]:
    # one generator threads through the REORDER variance sample and every
    # per-k mu sample: the k-cost estimates draw independent samples instead
    # of re-seeding default_rng(seed) inside the loop (which made every k's
    # mu sample identical to -- and correlated with -- the variance sample)
    rng = np.random.default_rng(seed)
    pts = np.asarray(d, dtype=np.float32)
    if reorder:
        pts, _ = variance_reorder(pts, sample_frac, rng=rng)
    n_pts, n = pts.shape
    out: List[KEstimate] = []
    for k in ks:
        k = int(min(k, n))
        grid = build_grid(pts, eps, k)
        g = max(grid.num_cells, 2)
        search = float(n_pts) * (3.0**k) * float(np.log2(g))
        # sample the candidate workload: a fraction of the tile pairs
        plan = build_tile_plan(grid, tile_size, sortidu=False)
        p = plan.num_pairs
        if p:
            n_sample = max(1, int(round(p * sample_frac)))
            sel = rng.choice(p, size=min(n_sample, p), replace=False)
            mu = float(
                (plan.tile_len[plan.pair_a[sel]].astype(np.int64)
                 * plan.tile_len[plan.pair_b[sel]].astype(np.int64)).sum()
            )
            compare = mu * (p / len(sel))
        else:
            compare = 0.0
        out.append(
            KEstimate(
                k=k,
                num_cells=grid.num_cells,
                search_ops=search,
                compare_ops=compare,
                total_ops=search + compare,
            )
        )
    return out


def select_k(d: np.ndarray, eps: float, ks: Sequence[int], **kw) -> int:
    """argmin-total-ops k (the paper's selection rule).

    Deterministic under ties: the smaller k wins (cheaper index build and a
    shallower 3^k adjacency), regardless of the order of ``ks``.
    """
    ests = estimate_k_costs(d, eps, ks, **kw)
    return min(ests, key=lambda e: (e.total_ops, e.k)).k
