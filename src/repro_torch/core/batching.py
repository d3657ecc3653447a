"""Result-set sizing for the pairs buffer (paper Section 3.2.2).

The paper sizes its result buffers by first running an *estimate kernel*
over a fraction of the work (returning only a count).  Here the estimate
evaluates a random sample of candidate tile pairs in counts mode on the
device that holds the tiles; ``SelfJoinEngine`` preallocates its pairs
buffer from it (``suggest_pairs_capacity``).  The sample is drawn with
``np.random.default_rng(seed)`` exactly as in the JAX package, so both
packages size the same buffer.
"""
from __future__ import annotations

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
