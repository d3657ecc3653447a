"""REORDER -- dimensionality reordering by variance (paper Section 4.2).

The variance of each dimension is estimated on a sample of ``sample_frac`` of
|D| (the paper uses 1%), and the coordinate columns of every point are
permuted so variances are in descending order.  Reordering swaps coordinate
values only, so the pairwise Euclidean distances -- and hence the join result
-- are unchanged; the indexed prefix of dimensions (Section 4.1) gains
filtering power.

``apply_reorder`` / ``inverse_perm`` are the supported way to carry the same
permutation to *external* points: a serving tier that indexes D once must
permute every incoming query batch identically (``repro.join``), and
``inverse_perm`` undoes it for round-tripping back to original coordinates.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def apply_reorder(points: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Permute coordinate columns: ``out[:, j] == points[:, perm[j]]``.

    The companion of ``variance_reorder`` for points that were not part of
    the reordered dataset (e.g. query batches against a persisted index).
    Distances between any two points are unchanged.
    """
    pts = np.asarray(points)
    return np.ascontiguousarray(pts[:, np.asarray(perm)])


def inverse_perm(perm: np.ndarray) -> np.ndarray:
    """The permutation undoing ``perm``: ``apply_reorder(apply_reorder(d, p), inverse_perm(p)) == d``."""
    p = np.asarray(perm)
    inv = np.empty_like(p)
    inv[p] = np.arange(p.shape[0], dtype=p.dtype)
    return inv


def estimate_dim_variance(
    d: np.ndarray,
    sample_frac: float = 0.01,
    seed: int = 0,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Per-dimension variance estimated from a random sample of the points.

    Pass ``rng`` to draw from a caller-owned generator (so successive calls
    use independent samples); otherwise a fresh ``default_rng(seed)`` keeps
    the historical deterministic behaviour.
    """
    pts = np.asarray(d)
    n_pts = pts.shape[0]
    if n_pts <= 2:
        return pts.var(axis=0) if n_pts else np.zeros(pts.shape[1])
    n_sample = max(2, min(n_pts, int(round(n_pts * sample_frac))))
    if rng is None:
        rng = np.random.default_rng(seed)
    idx = rng.choice(n_pts, size=n_sample, replace=False)
    return pts[idx].var(axis=0)


def variance_reorder(
    d: np.ndarray,
    sample_frac: float = 0.01,
    seed: int = 0,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Return (reordered points, dim permutation), descending variance.

    ``reordered == apply_reorder(d, perm)``; applying the join to the
    reordered data yields identical pairs/counts (distances are
    permutation-invariant).
    """
    pts = np.asarray(d)
    var = estimate_dim_variance(pts, sample_frac, seed, rng=rng)
    # stable sort so equal-variance dims keep their input order (determinism)
    perm = np.argsort(-var, kind="stable")
    return apply_reorder(pts, perm), perm
