"""Deterministic synthetic token pipeline (a copy of ``repro.data.tokens``).

Sharded, resumable iteration: the cursor (step index) lives in the
checkpoint ``extra`` dict, so restart resumes the exact batch sequence
(fault-tolerance invariant tested in tests/test_train.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    batch: int
    seq: int
    seed: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for a given step (resume = same stream)."""
        rng = np.random.default_rng((self.seed, step))
        # zipf-ish marginal: more realistic embedding-gather imbalance
        z = rng.zipf(1.3, size=(self.batch, self.seq))
        tokens = np.minimum(z - 1, self.vocab - 1).astype(np.int32)
        return {"tokens": tokens, "labels": tokens}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
