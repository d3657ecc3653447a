"""Plain PyTorch oracles for the port's kernels.

The twins of ``repro.kernels.ref``: ``ref_tile_mask`` / ``ref_tile_counts``
evaluate candidate tile pairs with the *direct* ``(a-b)^2`` formulation in
float32 -- a different numeric path from the kernels' matmul form, so tests
exercise both (DESIGN.md #6; exactness tests quantize coordinates so both
forms are exact).  ``ref_attention`` is the dense softmax oracle of the
flash attention kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.distance_tile import eps_squared


def matmul_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Clamped matmul-form squared distances, ``max(|a|^2 + |b|^2 - 2 a.b^T, 0)``.

    ``a``: (..., Ta, n), ``b``: (..., Tb, n) -> (..., Ta, Tb) float32.
    """
    a = a.float()
    b = b.float()
    na = (a * a).sum(-1)[..., :, None]
    nb = (b * b).sum(-1)[..., None, :]
    prod = torch.einsum("...in,...jn->...ij", a, b)
    return (na + nb - 2.0 * prod).clamp_min(0.0)


def direct_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Direct-form squared distances ``|a - b|^2``, (..., Ta, Tb) float32."""
    diff = a.float()[..., :, None, :] - b.float()[..., None, :, :]
    return (diff * diff).sum(-1)


def ref_tile_mask(tiles_pts, tile_len, pair_a, pair_b, eps) -> torch.Tensor:
    """Boolean (P, T, T): pair (i, j) within eps and both lanes valid."""
    t = tiles_pts.shape[1]
    pa = pair_a.long()
    pb = pair_b.long()
    d2 = direct_sqdist(tiles_pts[pa], tiles_pts[pb])
    rows = torch.arange(t, device=tiles_pts.device)
    valid = (rows[None, :, None] < tile_len[pa][:, None, None]) & (
        rows[None, None, :] < tile_len[pb][:, None, None]
    )
    return (d2 <= eps_squared(eps)) & valid


def ref_tile_counts(tiles_pts, tile_len, pair_a, pair_b, eps) -> torch.Tensor:
    """Per-(pair, a-point) neighbour counts, (P, T) int32."""
    mask = ref_tile_mask(tiles_pts, tile_len, pair_a, pair_b, eps)
    return mask.sum(dim=2, dtype=torch.int32)


def ref_attention(q, k, v, *, causal=True, scale=None):
    """Dense softmax attention oracle. q: (BH, Sq, dh), k/v: (BH, Sk, dh/dv).

    Computed in float32, masked with -1e30 (not -inf), cast back to ``q.dtype``.
    """
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = s.shape[1], s.shape[2]
        mask = torch.arange(sk, device=s.device)[None, :] <= torch.arange(sq, device=s.device)[:, None]
        s = torch.where(mask[None], s, -1.0e30)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)
