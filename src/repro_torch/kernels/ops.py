"""Tile-evaluation ops: tiling, backend dispatch, host-facing chunked entry points.

The port of ``repro.kernels.ops``.  Four backend strings with one contract
(two per execution tier, DESIGN.md #9), kept so that stats and configs read
as in the JAX package:

  * ``"pallas"`` / ``"jnp"``        -- the indexed tier: K1/K2
    (``distance_tile.tile_pair_distance``, SHORTC dimension-blocked);
  * ``"dense"`` / ``"dense_jnp"``   -- the dense tier: K3/K4
    (``dense_tile.dense_tile_distance``, no SHORTC, clamped identity).

In the port the two strings of a tier run the same wrapper: the wrapper
launches the CUDA kernel on a CUDA tensor and runs its plain PyTorch
version on a CPU tensor.  ``use_pallas`` therefore never selects a plain
version on the card.

``make_tiles`` re-lays the grid-sorted points into the (num_tiles, T, n_pad)
layout the kernels consume (host numpy); ``make_tiles_device`` is its
device twin.  ``eps`` is a runtime kernel argument: one built kernel serves
every chunk and every eps.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from repro_torch.kernels import dense_tile, distance_tile

BACKENDS = ("pallas", "jnp", "dense", "dense_jnp")


def backend_name(execution: str, use_pallas: bool) -> str:
    """Backend string for an execution tier (``"indexed"`` | ``"dense"``)."""
    if execution == "dense":
        return "dense" if use_pallas else "dense_jnp"
    return "pallas" if use_pallas else "jnp"


def make_tiles(
    pts_sorted: np.ndarray,
    tile_start: np.ndarray,
    tile_len: np.ndarray,
    tile_size: int,
    dim_block: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Re-lay points into (num_tiles, T, n_pad) with zero padding.

    Zero padding in both the point axis (tail tiles) and the dimension axis
    (n -> n_pad) is distance-neutral; validity is enforced via ``tile_len``.
    """
    num_tiles = tile_start.shape[0]
    n_pts, n = pts_sorted.shape
    n_pad = ((n + dim_block - 1) // dim_block) * dim_block
    if num_tiles == 0:
        return (
            np.zeros((1, tile_size, n_pad), dtype=np.float32),
            tile_len.astype(np.int32),
        )
    lane = np.arange(tile_size, dtype=np.int64)
    idx = tile_start.astype(np.int64)[:, None] + lane[None, :]   # (num_tiles, T)
    valid = lane[None, :] < tile_len.astype(np.int64)[:, None]
    gathered = pts_sorted[np.minimum(idx, max(n_pts - 1, 0))]    # (num_tiles, T, n)
    tiles = np.zeros((num_tiles, tile_size, n_pad), dtype=np.float32)
    tiles[:, :, :n] = np.where(valid[:, :, None], gathered, 0.0)
    return tiles, tile_len.astype(np.int32)


def make_tiles_device(
    pts_sorted: torch.Tensor,    # (N, n) f32
    tile_start: torch.Tensor,    # (num_tiles,) int32
    tile_len: torch.Tensor,      # (num_tiles,) int32
    *,
    tile_size: int,
    dim_block: int,
) -> torch.Tensor:
    """Device twin of ``make_tiles``: one gather + pad on ``pts_sorted``'s device.

    Returns (max(num_tiles,1), T, n_pad) f32.  Out-of-range rows (tail-tile
    lanes) are clamped, then zeroed by the validity mask, so the result is
    bit-identical to the host layout.
    """
    num_tiles = tile_start.shape[0]
    n_pts, n = pts_sorted.shape
    n_pad = ((n + dim_block - 1) // dim_block) * dim_block
    dev = pts_sorted.device
    if num_tiles == 0:
        return torch.zeros((1, tile_size, n_pad), dtype=torch.float32, device=dev)
    lane = torch.arange(tile_size, device=dev)
    idx = (tile_start.long()[:, None] + lane[None, :]).clamp_(max=max(n_pts - 1, 0))
    valid = lane[None, :] < tile_len[:, None]
    tiles = torch.zeros((num_tiles, tile_size, n_pad), dtype=torch.float32, device=dev)
    tiles[:, :, :n] = torch.where(valid[:, :, None], pts_sorted[idx], 0.0)
    return tiles


def eval_tile_pairs(
    tiles_pts,
    tile_len,
    pair_a,
    pair_b,
    eps,
    *,
    dim_block: int,
    shortc: bool = True,
    backend: str = "jnp",
    return_mask: bool = False,
    num_dims=None,
):
    """Evaluate one chunk of tile pairs on the tensors' device.

    Returns ``(counts (P,T) int32, skipped (P,) int32[, mask (P,T,T) int8])``.
    As in the JAX package, the indexed kernel always short-circuits;
    ``shortc=False`` only zeroes the ``skipped`` stat (``ops.py:141-143``).
    The dense backends ignore ``shortc`` and report 0 skipped blocks.
    ``num_dims`` (default ``n_pad``) is the data's dimension count: the
    kernels multiply no dim past it (the zero padding; no result changes).
    """
    if backend in ("pallas", "jnp"):
        res = distance_tile.tile_pair_distance(
            tiles_pts, tile_len, pair_a, pair_b,
            eps=eps, dim_block=dim_block, return_mask=return_mask, num_dims=num_dims,
        )
        counts, skipped = res[0], res[1]
        if not shortc:
            skipped = torch.zeros_like(skipped)
        return (counts, skipped, res[2]) if return_mask else (counts, skipped)
    if backend in ("dense", "dense_jnp"):
        res = dense_tile.dense_tile_distance(
            tiles_pts, tile_len, pair_a, pair_b,
            eps=eps, dim_block=dim_block, return_mask=return_mask, num_dims=num_dims,
        )
        skipped = torch.zeros(pair_a.shape[0], dtype=torch.int32, device=tiles_pts.device)
        return (res[0], skipped, res[1]) if return_mask else (res[0], skipped)
    raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")


def _chunks(
    pair_a: np.ndarray, pair_b: np.ndarray, chunk: int, device
) -> Iterator[Tuple[int, torch.Tensor, torch.Tensor, int]]:
    """Fixed-size, zero-padded chunks ``(start, pa, pb, real)`` of a pair list.

    The whole list goes to ``device`` in one copy, padded with tile index 0
    to a multiple of ``chunk``; each chunk is a view of it.  Pairs past
    ``real`` are evaluated and then masked by the callers' epilogues.
    """
    p = pair_a.shape[0]
    padded = -(-p // chunk) * chunk
    both = np.zeros((2, padded), np.int32)
    both[0, :p] = pair_a
    both[1, :p] = pair_b
    dev_both = torch.from_numpy(both).to(device)
    for s in range(0, p, chunk):
        yield s, dev_both[0, s : s + chunk], dev_both[1, s : s + chunk], min(chunk, p - s)


def tile_counts(
    tiles_pts,
    tile_len,
    pair_a: np.ndarray,
    pair_b: np.ndarray,
    *,
    eps: float,
    dim_block: int = 32,
    shortc: bool = True,
    backend: str = "jnp",
    chunk: int = 4096,
    num_dims=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Counts (P, T) and SHORTC-skipped block counts (P,) for all pairs.

    ``tiles_pts`` / ``tile_len`` may be numpy arrays (evaluated on the CPU)
    or tensors (evaluated on their device); results come back as numpy.
    ``num_dims`` as in ``eval_tile_pairs``.
    """
    tiles = torch.as_tensor(tiles_pts)
    lens = torch.as_tensor(tile_len, device=tiles.device)
    out_counts, out_skipped = [], []
    for _, pa, pb, real in _chunks(pair_a, pair_b, chunk, tiles.device):
        counts, skipped = eval_tile_pairs(
            tiles, lens, pa, pb, eps,
            dim_block=dim_block, shortc=shortc, backend=backend, num_dims=num_dims,
        )
        out_counts.append(counts[:real].cpu().numpy())
        out_skipped.append(skipped[:real].cpu().numpy())
    if not out_counts:
        t = tiles.shape[1]
        return np.zeros((0, t), np.int32), np.zeros((0,), np.int32)
    return np.concatenate(out_counts), np.concatenate(out_skipped)


def tile_mask(
    tiles_pts,
    tile_len,
    pair_a: np.ndarray,
    pair_b: np.ndarray,
    *,
    eps: float,
    dim_block: int = 32,
    backend: str = "jnp",
    chunk: int = 512,
    num_dims=None,
):
    """Yield (pair_slice_start, mask (Pc, T, T) int8 numpy) per chunk;
    ``num_dims`` as in ``eval_tile_pairs``."""
    tiles = torch.as_tensor(tiles_pts)
    lens = torch.as_tensor(tile_len, device=tiles.device)
    for s, pa, pb, real in _chunks(pair_a, pair_b, chunk, tiles.device):
        _, _, mask = eval_tile_pairs(
            tiles, lens, pa, pb, eps,
            dim_block=dim_block, shortc=True, backend=backend, return_mask=True,
            num_dims=num_dims,
        )
        yield s, mask[:real].cpu().numpy()
