"""Point sets of a configuration, made from ``--seed``.

A frozen copy of the generators of the paper's datasets (Gowanlock &
Karsin, arXiv:1809.09930, Sec. 5.1), so that the data cannot change with
the program: the synthetic sets are exponential with lambda = 40 in every
dimension, clipped to [0, 1]; the clustered stand-in (for the real-world
sets, e.g. Songs and CoocTexture) is a Gaussian mixture with optional
near-constant leading dimensions; uniform data is the easy case.

A configuration file picks one by ``"kind"`` and gives its parameters.
"""
from __future__ import annotations

import numpy as np


def exponential(num_points: int, num_dims: int, seed: int, lam: float = 40.0) -> np.ndarray:
    """exponential(lambda) per dimension, clipped to [0, 1] (paper Sec. 5.1)."""
    rng = np.random.default_rng(seed)
    x = rng.exponential(scale=1.0 / lam, size=(num_points, num_dims))
    return np.clip(x, 0.0, 1.0).astype(np.float32)


def uniform(num_points: int, num_dims: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.random((num_points, num_dims), dtype=np.float32)


def clustered(num_points: int, num_dims: int, seed: int, num_clusters: int = 32, cluster_std: float = 0.02,
              low_variance_dims: int = 0) -> np.ndarray:
    """Gaussian mixture in [0, 1]; ``low_variance_dims`` leading dimensions
    are near-constant (the Songs profile, where REORDER matters)."""
    rng = np.random.default_rng(seed)
    centers = rng.random((num_clusters, num_dims))
    which = rng.integers(0, num_clusters, size=num_points)
    pts = centers[which] + rng.normal(0.0, cluster_std, (num_points, num_dims))
    pts = np.clip(pts, 0.0, 1.0).astype(np.float32)
    if low_variance_dims:
        lv = min(low_variance_dims, num_dims)
        base = rng.random(lv)
        pts[:, :lv] = np.clip(base[None, :] + rng.normal(0, 1e-3, (num_points, lv)), 0, 1).astype(np.float32)
    return pts


KINDS = {"exponential": exponential, "uniform": uniform, "clustered": clustered}


def make_points(config: dict, seed: int) -> np.ndarray:
    """The ``(num_points, num_dims)`` float32 points of ``config`` for ``seed``."""
    data = config["data"]
    params = {k: v for k, v in data.items() if k not in ("kind", "num_points", "num_dims")}
    return KINDS[data["kind"]](int(config["num_points"]), int(config["num_dims"]), seed, **params)
