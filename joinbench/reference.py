"""The plain reference of the eps-range self-join, in PyTorch.

A brute force over every pair of points, in blocks, from the generated
points and the join's radius alone: no index, no tiles, no kernel, and
nothing of the program under test (this module imports only ``torch``).

The guarantee it holds the program to is exact range semantics: every
pair within eps is found and no other, except pairs whose distance lies
within fp32 rounding of eps.  The program computes in fp32, so a pair
(a, b) whose float64 d2 lies within ``BOUNDARY_REL * (|a|^2 + |b|^2)`` of
eps^2 may fall either way (the rounding of |a|^2 + |b|^2 - 2 a.b scales
with the norms, not with eps^2): a right count lies in [lo, hi], the float64
counts at eps^2 minus and plus that band.  ``BOUNDARY_REL`` is the value the
port's smoke run has held its kernels to (a frozen copy of its
``boundary_band``).

``brute_counts`` / ``brute_pairs`` compute the join itself at a stated
precision: the control that stands in for the program, in TF32 (or bf16
on a CPU, which has no TF32), must fail the comparison.
"""
from __future__ import annotations

from typing import Tuple

import torch

BOUNDARY_REL = 1e-5
ROW_BLOCK = 2048
COL_BLOCK = 1 << 17


def _blocks(n: int, size: int):
    for s in range(0, n, size):
        yield s, min(n, s + size)


def count_bounds(points: torch.Tensor, rows: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) int64: for each point ``rows[i]``, the float64 count of
    points within eps^2 minus / plus the boundary band.  ``points`` is
    (N, n) float64 on the device that computes.

    With a = the row, b = a column, band = R (|a|^2 + |b|^2):
    d2 - eps^2 <= -band  iff  (1 + R) |b|^2 - 2 a.b <= eps^2 - (1 + R) |a|^2,
    and the same with -R for +band, so each bound is one matmul with the
    column term as its bias and one comparison with a per-row threshold.
    """
    e2 = float(eps) ** 2
    norms = (points * points).sum(1)
    lo = torch.zeros(rows.shape[0], dtype=torch.int64, device=points.device)
    hi = torch.zeros_like(lo)
    sides = [(lo, 1.0 + BOUNDARY_REL), (hi, 1.0 - BOUNDARY_REL)]
    for r0, r1 in _blocks(rows.shape[0], ROW_BLOCK):
        q = points[rows[r0:r1]]
        limits = [(e2 - f * norms[rows[r0:r1]])[:, None] for _, f in sides]
        for c0, c1 in _blocks(points.shape[0], COL_BLOCK):
            cols = points[c0:c1].T
            for (out, f), limit in zip(sides, limits):
                m = torch.addmm(norms[None, c0:c1], q, cols, beta=f, alpha=-2.0)
                out[r0:r1] += (m <= limit).sum(1)
    return lo, hi


def pair_margins(points: torch.Tensor, a: torch.Tensor, b: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """For pairs (a[i], b[i]): (d2 - eps^2, band) in float64, the d2 in the
    same matmul form as ``count_bounds``."""
    pa, pb = points[a], points[b]
    na, nb = (pa * pa).sum(1), (pb * pb).sum(1)
    d2 = na + nb - 2.0 * (pa * pb).sum(1)
    return d2 - float(eps) ** 2, BOUNDARY_REL * (na + nb)


def _lowered(points: torch.Tensor, precision: str):
    """The points as the control computes them, and the product to use."""
    if precision == "bf16":
        return points.to(torch.bfloat16)
    if precision in ("fp32", "tf32"):
        return points.to(torch.float32)
    raise ValueError(f"unknown precision {precision!r}")


class _Precision:
    """``torch.backends.cuda.matmul.allow_tf32`` set for TF32 and cleared
    otherwise, inside the block only."""

    def __init__(self, precision: str):
        self.tf32 = precision == "tf32"

    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.saved
        return False


def _join_blocks(points: torch.Tensor, eps: float, precision: str):
    """(r0, r1, c0, hit mask) over every block of the all-pairs join, with
    d2 = |a|^2 + |b|^2 - 2 a.b computed in ``precision``."""
    x = _lowered(points, precision)
    norms = (x.float() * x.float()).sum(1)
    e2 = float(eps) ** 2
    with _Precision(precision):
        for r0, r1 in _blocks(x.shape[0], ROW_BLOCK):
            for c0, c1 in _blocks(x.shape[0], COL_BLOCK):
                prod = (x[r0:r1] @ x[c0:c1].T).float()
                d2 = norms[r0:r1, None] + norms[None, c0:c1] - 2.0 * prod
                yield r0, r1, c0, d2 <= e2


def brute_counts(points: torch.Tensor, eps: float, precision: str) -> torch.Tensor:
    """Neighbour counts of every point (itself included), int64."""
    counts = torch.zeros(points.shape[0], dtype=torch.int64, device=points.device)
    for r0, r1, _, hit in _join_blocks(points, eps, precision):
        counts[r0:r1] += hit.sum(1)
    return counts


def brute_pairs(points: torch.Tensor, eps: float, precision: str) -> torch.Tensor:
    """Every ordered pair (a, b) within eps, itself included, (M, 2) int32."""
    out = []
    for r0, _, c0, hit in _join_blocks(points, eps, precision):
        i, j = hit.nonzero(as_tuple=True)
        out.append(torch.stack([i + r0, j + c0], 1).to(torch.int32))
    return torch.cat(out) if out else torch.zeros((0, 2), dtype=torch.int32, device=points.device)
