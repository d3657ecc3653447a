"""K3 / K4: dense (unfiltered) tile-pair evaluation, counts and mask mode.

The port of ``src/repro/kernels/dense_tile.py:dense_tile_distance`` (the
Pallas TPU kernel, bodies ``_kernel`` and ``_mask_kernel``): the same
accumulation as ``distance_tile`` with no SHORTC branch, and
``d2 = max(d2, 0)`` before the eps test -- the clamped matmul identity that
keeps self and duplicate pairs at tiny eps on raw fp32 data.  Same calling
convention as ``distance_tile.tile_pair_distance``; it returns no
``skipped`` (the dense tier skips nothing).

``dense_tile_distance`` launches the CUDA kernel (``csrc/dense_tile.cu``)
for CUDA tensors and runs ``dense_tile_distance_plain`` -- the blocked twin
of ``repro.kernels.ops._eval_dense_jnp`` -- for CPU tensors, with no
fallback between the two.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.distance_tile import blocked_eval, eps_squared

# kernel launches made by dense_tile_distance, by kernel (reset by callers)
LAUNCHES = {"dense_tile_distance": 0, "dense_tile_distance_mask": 0}


def dense_tile_distance_plain(tiles, tile_len, pair_a, pair_b, *, eps, dim_block, return_mask=False):
    """Plain PyTorch version of K3 (counts) / K4 (``return_mask``)."""
    res = blocked_eval(
        tiles, tile_len, pair_a, pair_b, eps_squared(eps),
        dim_block=dim_block, shortc=False, clamp=True, return_mask=return_mask,
    )
    return (res[0], res[2]) if return_mask else (res[0],)


def dense_tile_distance(tiles, tile_len, pair_a, pair_b, *, eps, dim_block=32, return_mask=False):
    """Evaluate every listed tile pair densely (K3, or K4 with ``return_mask``).

    Returns ``(counts (P,T) int32,)`` or ``(counts, mask (P,T,T) int8)``.  A
    CUDA ``tiles`` launches the CUDA kernel (T <= 128); a CPU ``tiles`` runs
    the plain version.
    """
    n_pad = tiles.shape[2]
    if n_pad % dim_block:
        raise ValueError(f"n_pad={n_pad} not a multiple of dim_block={dim_block}")
    if tiles.device.type == "cpu":
        return dense_tile_distance_plain(
            tiles, tile_len, pair_a, pair_b,
            eps=eps, dim_block=dim_block, return_mask=return_mask,
        )
    if tiles.device.type != "cuda":
        raise ValueError(f"dense_tile_distance runs on cpu or cuda tensors, not {tiles.device}")
    p, t = pair_a.shape[0], tiles.shape[1]
    outs = [torch.empty((p, t), dtype=torch.int32, device=tiles.device)]   # counts
    if return_mask:
        outs.append(torch.empty((p, t, t), dtype=torch.int8, device=tiles.device))
    symbol = "dense_tile_mask" if return_mask else "dense_tile_counts"
    _build.launch_tile_kernel("dense_tile", symbol, tiles, tile_len, pair_a, pair_b,
                              eps_squared(eps), dim_block, outs)
    LAUNCHES["dense_tile_distance_mask" if return_mask else "dense_tile_distance"] += 1
    return tuple(outs)
