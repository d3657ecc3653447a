"""EGO-order CPU baseline (the comparison target, paper Sections 2.1/5.3).

A copy of the JAX package's ``repro.core.ego`` (numpy only, on the host in
both packages: it is the CPU join the device join is compared with).

The paper benchmarks against Super-EGO (Kalashnikov 2013), an epsilon-grid-
order CPU join.  We implement its structural core so Table-3-style speedup
comparisons are reproducible in-framework: points are EGO-sorted (lexico-
graphic on eps-grid coordinates of the variance-reordered dims), and each
point scans a sorted window bounded by the first dimension (|x0 - y0| <= eps
after grid alignment), short-circuiting the distance accumulation -- the two
signature Super-EGO traits the paper calls out (dimensionality reordering and
short-circuiting).  It is a faithful *algorithmic class* baseline, not a port
of the Super-EGO codebase.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.reorder import variance_reorder


def ego_sort(d: np.ndarray, eps: float, reorder: bool = True) -> np.ndarray:
    """Return the EGO permutation: lexicographic on eps-grid coordinates."""
    pts = np.asarray(d, dtype=np.float32)
    if reorder:
        pts, _ = variance_reorder(pts)
    coords = np.floor(pts.astype(np.float64) / eps).astype(np.int64)
    return np.lexsort(tuple(coords[:, j] for j in range(coords.shape[1] - 1, -1, -1)))


def ego_join_counts(d: np.ndarray, eps: float, reorder: bool = True) -> np.ndarray:
    """Neighbour counts (self included) via the EGO sweep, original order."""
    pts_in = np.asarray(d, dtype=np.float32)
    pts = pts_in
    if reorder:
        pts, _ = variance_reorder(pts_in)
    order = ego_sort(pts, eps, reorder=False)
    s = pts[order].astype(np.float32)
    n = s.shape[0]
    eps32 = np.float32(eps)
    eps2 = eps32 * eps32
    counts_sorted = np.zeros(n, dtype=np.int64)
    x0 = s[:, 0]
    # window on dim 0: EGO order is lexicographic on grid coords, so any pair
    # within eps differs by <= 1 grid cell in dim 0 => |x0 diff| <= 2 eps in
    # the sorted-by-cell order is a safe (conservative) sweep bound.
    keys = np.floor(x0 / eps32)
    hi = np.searchsorted(keys, keys + 2, side="left")
    for i in range(n):
        j0, j1 = i + 1, int(hi[i])
        if j1 <= j0:
            counts_sorted[i] += 1  # self
            continue
        cand = s[j0:j1]
        diff = cand - s[i]
        d2 = np.einsum("ij,ij->i", diff, diff)
        m = int((d2 <= eps2).sum())
        counts_sorted[i] += m + 1          # + self
        # symmetric contribution to the matched partners
        hits = np.nonzero(d2 <= eps2)[0]
        counts_sorted[j0 + hits] += 1
    counts = np.zeros(n, dtype=np.int64)
    counts[order] = counts_sorted
    return counts
