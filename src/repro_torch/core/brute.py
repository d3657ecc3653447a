"""Brute-force O(|D|^2) self-join references.

Oracles:
  * ``brute_counts`` -- float64 numpy, direct (a-b)^2 formulation.  Ground
    truth for correctness tests.
  * ``brute_counts_f32`` -- float32, matmul formulation, matching the numeric
    path of the tile kernels (DESIGN.md #6) for bit-comparable testing.
  * ``sqdist_f64`` -- float64 torch, direct formulation, on the inputs'
    device: the ground truth that ``chip_smoke.py`` spot-checks the card
    against at sizes where the numpy oracles are too slow.

The numpy oracles operate in blocks so |D| up to ~10^5 stays within memory.
"""
from __future__ import annotations

import numpy as np
import torch


def brute_counts(d: np.ndarray, eps: float, block: int = 1024) -> np.ndarray:
    """Number of points within eps of each point (self included), float64."""
    pts = np.asarray(d, dtype=np.float64)
    n = pts.shape[0]
    eps2 = np.float64(eps) ** 2
    counts = np.zeros(n, dtype=np.int64)
    for i0 in range(0, n, block):
        a = pts[i0 : i0 + block]
        for j0 in range(0, n, block):
            b = pts[j0 : j0 + block]
            diff = a[:, None, :] - b[None, :, :]
            d2 = np.einsum("ijk,ijk->ij", diff, diff)
            counts[i0 : i0 + block] += (d2 <= eps2).sum(axis=1)
    return counts


def brute_pairs(d: np.ndarray, eps: float) -> np.ndarray:
    """All ordered (a, b) pairs with dist <= eps, float64. Small inputs only."""
    pts = np.asarray(d, dtype=np.float64)
    diff = pts[:, None, :] - pts[None, :, :]
    d2 = np.einsum("ijk,ijk->ij", diff, diff)
    a, b = np.nonzero(d2 <= np.float64(eps) ** 2)
    return np.stack([a, b], axis=1).astype(np.int32)


def brute_counts_f32(d: np.ndarray, eps: float, block: int = 2048) -> np.ndarray:
    """float32 matmul-form counts: ||a||^2 + ||b||^2 - 2 a.b, matching the kernel."""
    pts = np.asarray(d, dtype=np.float32)
    n = pts.shape[0]
    eps2 = np.float32(eps) ** 2
    norms = np.einsum("ij,ij->i", pts, pts)
    counts = np.zeros(n, dtype=np.int64)
    for i0 in range(0, n, block):
        a = pts[i0 : i0 + block]
        na = norms[i0 : i0 + block]
        d2 = na[:, None] + norms[None, :] - 2.0 * (a @ pts.T)
        counts[i0 : i0 + block] = (d2 <= eps2).sum(axis=1)
    return counts


def sqdist_f64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float64 squared distances between the rows of ``a`` (..., Ta, n) and
    ``b`` (..., Tb, n), direct (a-b)^2 form, on their device.

    One dimension at a time, so memory stays at the (..., Ta, Tb) result.
    """
    a, b = a.double(), b.double()
    d2 = torch.zeros(a.shape[:-1] + b.shape[-2:-1], dtype=torch.float64, device=a.device)
    for k in range(a.shape[-1]):
        d2 += (a[..., :, None, k] - b[..., None, :, k]) ** 2
    return d2
