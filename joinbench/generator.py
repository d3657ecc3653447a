"""The one traffic generator: the radii of a cell's joins, from ``--seed``.

A traffic file (``traffic/<name>.json``) names the configuration, the
mode (``"count"``: ``SelfJoinEngine.count(eps)``; ``"pairs"``:
``SelfJoinEngine.pairs(eps)`` in auto-capacity mode), the radius range and
``eps_steps``.  The radii are the ``eps_steps`` midpoints of equal strata
of the range; each cycle of ``eps_steps`` joins takes every one once, in an
order drawn from the seed.  A window runs whole cycles, so every seed does
the same set of work, in another order, and a window's work does not swing
with the seed (a pairs join's time grows with eps, by a third over the
near-duplicate range).  The index is built at the top of the range, so
every radius reuses it.
"""
from __future__ import annotations

from typing import Iterator, List

import numpy as np

MODES = ("count", "pairs")


def radii(traffic: dict) -> List[float]:
    """The ``eps_steps`` radii of the range, ascending."""
    lo, hi = (float(v) for v in traffic["eps_range"])
    k = int(traffic["eps_steps"])
    if not (0 < lo <= hi) or k < 1:
        raise ValueError(f"bad eps_range / eps_steps: {traffic['eps_range']}, {k}")
    return [lo + (hi - lo) * (i + 0.5) / k for i in range(k)]


def index_eps(traffic: dict) -> float:
    """The radius the index is built for: the top of the range."""
    return float(traffic["eps_range"][1])


def eps_sequence(traffic: dict, seed: int) -> Iterator[float]:
    """The radii of the joins, in order, without end."""
    if traffic["mode"] not in MODES:
        raise ValueError(f"unknown mode {traffic['mode']!r}; expected one of {MODES}")
    values = radii(traffic)
    rng = np.random.default_rng([int(seed), 1])  # a stream of its own, apart from the data's
    while True:
        for i in rng.permutation(len(values)):
            yield values[int(i)]
