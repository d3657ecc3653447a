"""GPU-Join (paper Alg. 1) on PyTorch + CUDA: the top-level self-join entry point.

Pipeline (paper lines 1-10, adapted per DESIGN.md #1):

  1. REORDER the dimensions by sampled variance          (Sec. 4.2)
  2. build the grid index over the first k dims          (Secs. 3.2.1, 4.1)
  3. build the candidate tile-pair plan, SORTIDU-pruned  (Sec. 4.3)
  4. estimate the result size, preallocate the pairs
     buffer                                              (Sec. 3.2.2)
  5. evaluate chunks with the tile distance kernels
     (SHORTC dimension-blocked pruning)                  (Sec. 4.4)
  6. scatter per-point counts / compact pairs back to
     the original point order (constructNeighborTable)

``self_join`` is a thin wrapper over ``SelfJoinEngine``, which keeps steps
4-6 on the device.  ``config.execution`` selects the execution tier
(DESIGN.md #9): ``"indexed"``, ``"dense"`` or ``"auto"`` (cost model).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.engine import SelfJoinEngine
from repro_torch.core.types import SelfJoinConfig, SelfJoinResult


def self_join(
    d: np.ndarray,
    config: SelfJoinConfig,
    return_pairs: bool = False,
    max_pairs: Optional[int] = None,
    *,
    device="cuda",
) -> SelfJoinResult:
    """Find all ordered pairs within config.eps; counts per original point.

    Runs on ``device`` (default ``"cuda"``); without a card this raises
    unless ``device="cpu"`` is given.
    """
    engine = SelfJoinEngine(d, config, device=device)
    if return_pairs:
        return engine.pairs(max_pairs=max_pairs)
    return engine.count()
