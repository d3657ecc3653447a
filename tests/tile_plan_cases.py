"""Inputs for the tile-plan tests: points, eps, k and tile size per case.

Shared by the CPU tests (the port's plan against the JAX package's) and the
card tests (the CUDA kernel's plan against the CPU's), so it imports no JAX.
The benchmark's datasets are REORDERed by the port's ``variance_reorder``,
as an engine's index build does; the edge cases keep their dims in place.
"""
import numpy as np

from repro_torch.core.reorder import variance_reorder
from repro_torch.data.synthetic import exponential_dataset


def _cells(sizes, eps, dims, seed):
    """Points in given 2-D cells of width ``eps``: ``sizes`` maps a cell's
    coordinates to its point count; the u dimension (index 2) spreads over
    [0, 0.5], so SORTIDU prunes some tile pairs."""
    rng = np.random.default_rng(seed)
    pts = []
    for (x, y), n in sizes.items():
        p = rng.random((n, dims)) * 0.5
        p[:, 0] = (x + 0.1 + 0.8 * rng.random(n)) * eps
        p[:, 1] = (y + 0.1 + 0.8 * rng.random(n)) * eps
        pts.append(p)
    return np.concatenate(pts).astype(np.float32)


def _edges():
    # cells of exactly T = 8 and T + 1 points (a last tile of length 1), a
    # single-point cell beside them, a far cell alone, and a 3-tile cell
    sizes = {(0, 0): 8, (1, 0): 9, (1, 1): 1, (5, 5): 3, (0, 1): 17}
    return _cells(sizes, 0.1, 4, seed=3), 0.1, 2, 8


CASES = {
    # eps 0: unit bins, on a 1/64 lattice so many points coincide
    "eps0": lambda: (np.round(exponential_dataset(300, 4, seed=1) * 64) / 64, 0.0, 4, 8),
    # every point in one cell
    "one_cell": lambda: (np.random.default_rng(2).random((200, 5)).astype(np.float32) * 0.09, 0.1, 3, 16),
    "t_and_t_plus_1": _edges,
    # k == n: u is the last indexed dimension
    "k_equals_n": lambda: (exponential_dataset(500, 3, seed=4), 0.05, 3, 8),
    **{f"exponential_k{k}": (lambda k=k: (exponential_dataset(1500, 8, seed=5), 0.08, k, 16)) for k in (3, 4, 5, 6)},
    # the benchmark's Syn16D2M (exponential, lambda 40) and Syn64D2M at
    # their index radii, k 6, T 64: the first points of the seed-0 set
    "syn16d2m_20k": lambda: (exponential_dataset(20_000, 16, seed=0), 0.05, 6, 64),
    "syn16d2m_200k": lambda: (exponential_dataset(200_000, 16, seed=0), 0.05, 6, 64),
    "syn64d2m_100k": lambda: (exponential_dataset(100_000, 64, seed=0), 0.18, 6, 64),
}
EDGE_CASES = [name for name in CASES if not name.startswith("syn")]
CPU_CASES = EDGE_CASES + ["syn16d2m_20k"]
CARD_CASES = EDGE_CASES + ["syn16d2m_200k", "syn64d2m_100k"]


def make(name):
    """(points, eps, k, tile size) of case ``name``."""
    d, eps, k, t = CASES[name]()
    d = np.asarray(d, np.float32)
    return (variance_reorder(d, 0.01)[0] if name.startswith("syn") else d), eps, k, t
