"""K1 / K2: eps-neighbourhood evaluation of candidate tile pairs, with SHORTC.

The port of ``src/repro/kernels/distance_tile.py:tile_pair_distance`` (the
Pallas TPU kernel, bodies ``_kernel`` and ``_mask_kernel``).  For each
candidate pair ``(pair_a[p], pair_b[p])`` of a ``(num_tiles, T, n_pad)`` f32
tile table, ``d2 = |a|^2 + |b|^2 - 2 a.b^T`` accumulates over
``dim_block``-wide blocks; a pair stops (SHORTC) once the min of d2 over its
valid lanes exceeds eps^2, and ``skipped`` counts the blocks it never
computed.  Outputs: ``counts (P, T) int32`` and ``skipped (P,) int32``, plus
the ``(P, T, T) int8`` hit mask in mask mode.

``tile_pair_distance`` launches the CUDA kernel (``csrc/distance_tile.cu``)
for CUDA tensors and runs ``tile_pair_distance_plain`` -- the same blocked
algorithm in plain PyTorch, the twin of ``repro.kernels.ops._eval_jnp`` --
for CPU tensors.  There is no fallback between the two: on a CUDA tensor the
kernel runs or the call raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

NEG_LARGE = 3.0e38  # invalid lanes in the SHORTC min (distance_tile.py:34)

# kernel launches made by tile_pair_distance, by kernel (reset by callers)
LAUNCHES = {"tile_pair_distance": 0, "tile_pair_distance_mask": 0}


def eps_squared(eps) -> float:
    """eps^2 as the reference computes it: eps rounded to f32, squared in f32.

    The JAX package evaluates ``jnp.asarray(eps, jnp.float32) ** 2``
    (``distance_tile.py:134``, ``ops.py:201``); a Python ``eps * eps`` in
    float64 can round to a different f32 threshold.
    """
    e = np.float32(eps)
    return float(e * e)


def _gather(tiles, tile_len, pair_a, pair_b):
    """A and B tiles of every pair, and the (P, T, T) lane-validity mask."""
    t = tiles.shape[1]
    pa = pair_a.long()
    pb = pair_b.long()
    rows = torch.arange(t, device=tiles.device)
    valid = (rows[None, :, None] < tile_len[pa][:, None, None]) & (
        rows[None, None, :] < tile_len[pb][:, None, None]
    )
    return tiles[pa], tiles[pb], valid


def _fold(d2, a, b):
    """One dim block of the accumulation, in the Pallas kernel's order:
    ``((d2 + |a|^2) + |b|^2) - 2 a.b^T`` (``distance_tile.py:82``)."""
    na = (a * a).sum(-1)
    nb = (b * b).sum(-1)
    prod = torch.bmm(a, b.transpose(1, 2))
    return d2 + na[:, :, None] + nb[:, None, :] - 2.0 * prod


def blocked_eval(tiles, tile_len, pair_a, pair_b, eps2, *, dim_block, shortc, clamp, return_mask):
    """Plain PyTorch body shared by the four kernels' plain versions.

    ``shortc`` stops a pair once its valid-lane min of d2 exceeds ``eps2``
    (checked after every computed block, the last one included) and counts
    the blocks it skipped; ``clamp`` applies ``max(d2, 0)`` before the eps
    test.  Returns ``(counts (P,T) int32, skipped (P,) int32[, mask])``.
    """
    t, n_pad = tiles.shape[1], tiles.shape[2]
    p = pair_a.shape[0]
    a, b, valid = _gather(tiles, tile_len, pair_a, pair_b)
    eps2_t = torch.tensor(eps2, dtype=torch.float32, device=tiles.device)
    d2 = torch.zeros((p, t, t), dtype=torch.float32, device=tiles.device)
    done = torch.zeros(p, dtype=torch.bool, device=tiles.device)
    skipped = torch.zeros(p, dtype=torch.int32, device=tiles.device)
    for k0 in range(0, n_pad, dim_block):
        blk = _fold(d2, a[:, :, k0 : k0 + dim_block], b[:, :, k0 : k0 + dim_block])
        if shortc:
            skipped += done.to(torch.int32)
            d2 = torch.where(done[:, None, None], d2, blk)
            masked = torch.where(valid, d2, torch.full_like(d2, NEG_LARGE))
            done |= masked.amin(dim=(1, 2)) > eps2_t
        else:
            d2 = blk
    if clamp:
        d2 = d2.clamp_min(0.0)
    within = (d2 <= eps2_t) & valid
    counts = within.sum(dim=2, dtype=torch.int32)
    if return_mask:
        return counts, skipped, within.to(torch.int8)
    return counts, skipped


def tile_pair_distance_plain(tiles, tile_len, pair_a, pair_b, *, eps, dim_block, return_mask=False):
    """Plain PyTorch version of K1 (counts) / K2 (``return_mask``)."""
    return blocked_eval(
        tiles, tile_len, pair_a, pair_b, eps_squared(eps),
        dim_block=dim_block, shortc=True, clamp=False, return_mask=return_mask,
    )


def tile_pair_distance(tiles, tile_len, pair_a, pair_b, *, eps, dim_block=32, return_mask=False):
    """Evaluate all candidate tile pairs (K1, or K2 with ``return_mask``).

    ``tiles (num_tiles, T, n_pad) f32``, ``tile_len (num_tiles,) int32``,
    ``pair_a / pair_b (P,) int32``; ``n_pad % dim_block == 0``.  Returns
    ``(counts (P,T) int32, skipped (P,) int32[, mask (P,T,T) int8])``.  A
    CUDA ``tiles`` launches the CUDA kernel (T <= 128); a CPU ``tiles`` runs
    the plain version.
    """
    n_pad = tiles.shape[2]
    if n_pad % dim_block:
        raise ValueError(f"n_pad={n_pad} not a multiple of dim_block={dim_block}")
    if tiles.device.type == "cpu":
        return tile_pair_distance_plain(
            tiles, tile_len, pair_a, pair_b,
            eps=eps, dim_block=dim_block, return_mask=return_mask,
        )
    if tiles.device.type != "cuda":
        raise ValueError(f"tile_pair_distance runs on cpu or cuda tensors, not {tiles.device}")
    p, t = pair_a.shape[0], tiles.shape[1]
    outs = [torch.empty((p, t), dtype=torch.int32, device=tiles.device),   # counts
            torch.empty((p,), dtype=torch.int32, device=tiles.device)]     # skipped
    if return_mask:
        outs.append(torch.empty((p, t, t), dtype=torch.int8, device=tiles.device))
    symbol = "distance_tile_mask" if return_mask else "distance_tile_counts"
    _build.launch_tile_kernel("distance_tile", symbol, tiles, tile_len, pair_a, pair_b,
                              eps_squared(eps), dim_block, outs)
    LAUNCHES["tile_pair_distance_mask" if return_mask else "tile_pair_distance"] += 1
    return tuple(outs)
