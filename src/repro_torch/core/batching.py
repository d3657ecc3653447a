"""Result-set sizing and batching (paper Section 3.2.2).

The paper sizes batches by first running an *estimate kernel* over a
fraction of the work (returning only a count), then splits the join into
``n_b = max(3, ceil(|R_est| / b_s))`` batches so the result set never
overflows device memory and transfers overlap compute.  Here the estimate
evaluates a random sample of candidate tile pairs in counts mode on the
device that holds the tiles.  The sample is drawn with
``np.random.default_rng(seed)`` exactly as in the JAX package, so both
packages size the same buffer and the same batches.

Two consumers:

  * ``SelfJoinEngine`` preallocates its pairs buffer from the estimate
    (``suggest_pairs_capacity``); its chunking is fixed-size, so it needs
    no batch count;
  * the legacy host-loop path (``selfjoin.self_join_hostloop``) still uses
    ``compute_num_batches`` / ``batch_ranges`` as the paper does: per batch
    it evaluates the masks on the device and extracts the pairs on the host.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from repro_torch.kernels import ops


def estimate_result_size(
    tiles_pts,
    tile_len,
    plan,
    *,
    eps: float,
    dim_block: int,
    backend: str,
    sample_frac: float = 0.01,
    seed: int = 0,
    num_dims=None,
) -> int:
    """Estimated |R| from a sample of candidate tile pairs (counts only);
    ``num_dims`` as in ``ops.eval_tile_pairs``."""
    p = plan.num_pairs
    if p == 0:
        return 0
    n_sample = max(1, min(p, int(round(p * max(sample_frac, 1e-6)))))
    rng = np.random.default_rng(seed)
    sel = rng.choice(p, size=n_sample, replace=False)
    counts, _ = ops.tile_counts(
        tiles_pts, tile_len, plan.pair_a[sel], plan.pair_b[sel],
        eps=eps, dim_block=dim_block, shortc=True, backend=backend, num_dims=num_dims,
    )
    return int(round(float(counts.sum()) * (p / n_sample)))


def suggest_pairs_capacity(
    estimated_results: int, headroom: float = 2.0, floor: int = 4096
) -> int:
    """Pairs-buffer rows to preallocate for an estimated |R|.

    Headroom absorbs sampling error; the result is rounded up to a multiple
    of ``floor`` so repeated auto-sizing lands on few distinct buffer sizes.
    """
    want = int(max(estimated_results, 1) * max(headroom, 1.0))
    return max(floor, -(-want // floor) * floor)


def compute_num_batches(
    estimated_results: int, batch_size: int, min_batches: int = 3
) -> int:
    """n_b >= 3 always (the paper pipelines with >= 3 CUDA streams)."""
    by_size = -(-max(estimated_results, 1) // max(batch_size, 1))
    return max(min_batches, by_size)


def batch_ranges(num_pairs: int, num_batches: int) -> Iterator[Tuple[int, int]]:
    """Split [0, num_pairs) into num_batches near-equal contiguous ranges."""
    num_batches = max(1, min(num_batches, max(num_pairs, 1)))
    step = -(-num_pairs // num_batches)
    for lo in range(0, num_pairs, step):
        yield lo, min(lo + step, num_pairs)
    if num_pairs == 0:
        yield 0, 0
