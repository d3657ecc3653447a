"""Dataset generators mirroring the paper's evaluation (Section 5.1).

The paper's synthetic worst-case datasets are exponential(lambda=40) in each
dimension, clipped to [0,1] -- near-identical variance in every dimension, so
REORDER cannot help.  Real-world datasets (SuSy, Songs, ColorHist, ...) are
not redistributable here; ``clustered_dataset`` generates stand-ins with the
same |D|/n and the skewed per-dimension variance profile that makes REORDER
effective (a mixture of tight Gaussian clusters plus low-variance nuisance
dimensions).  ``PAPER_DATASETS`` lists the paper's Table 1 at full size;
``paper_dataset(name, scale)`` lets benchmarks shrink |D| on CPU.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# Table 1 of the paper: name -> (|D|, n, kind)
PAPER_DATASETS: Dict[str, Tuple[int, int, str]] = {
    "CoocTexture": (68_040, 16, "clustered"),
    "LayoutHist": (66_616, 32, "clustered"),
    "ColorHist": (68_040, 32, "clustered"),
    "SuSy": (5_000_000, 18, "clustered"),
    "Songs": (515_345, 90, "clustered"),
    "Syn16D2M": (2_000_000, 16, "exponential"),
    "Syn32D2M": (2_000_000, 32, "exponential"),
    "Syn64D2M": (2_000_000, 64, "exponential"),
}


def exponential_dataset(
    num_points: int, num_dims: int, lam: float = 40.0, seed: int = 0
) -> np.ndarray:
    """Paper Sec. 5.1 synthetic: exponential(lambda=40) per dim, in [0,1]."""
    rng = np.random.default_rng(seed)
    x = rng.exponential(scale=1.0 / lam, size=(num_points, num_dims))
    return np.clip(x, 0.0, 1.0).astype(np.float32)


def uniform_dataset(num_points: int, num_dims: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.random((num_points, num_dims), dtype=np.float32)


def clustered_dataset(
    num_points: int,
    num_dims: int,
    num_clusters: int = 32,
    cluster_std: float = 0.02,
    low_variance_dims: int = 0,
    seed: int = 0,
) -> np.ndarray:
    """Real-world stand-in: Gaussian mixture with optional low-variance dims.

    ``low_variance_dims`` leading dimensions get near-constant values -- the
    Songs-like profile where the first dims carry no filtering power until
    REORDER moves high-variance dims forward (paper Fig. 6b).
    """
    rng = np.random.default_rng(seed)
    centers = rng.random((num_clusters, num_dims))
    which = rng.integers(0, num_clusters, size=num_points)
    pts = centers[which] + rng.normal(0.0, cluster_std, (num_points, num_dims))
    pts = np.clip(pts, 0.0, 1.0).astype(np.float32)
    if low_variance_dims:
        lv = min(low_variance_dims, num_dims)
        base = rng.random(lv)
        pts[:, :lv] = np.clip(
            base[None, :] + rng.normal(0, 1e-3, (num_points, lv)), 0, 1
        ).astype(np.float32)
    return pts


def paper_dataset(name: str, scale: float = 1.0, seed: int = 0) -> np.ndarray:
    """A Table-1 dataset (or stand-in) at ``scale`` x its published |D|."""
    size, dims, kind = PAPER_DATASETS[name]
    n = max(16, int(round(size * scale)))
    if kind == "exponential":
        return exponential_dataset(n, dims, seed=seed)
    low_var = {"Songs": 12}.get(name, 0)  # paper: Songs' first ~12 dims are low-variance
    return clustered_dataset(n, dims, low_variance_dims=low_var, seed=seed)
