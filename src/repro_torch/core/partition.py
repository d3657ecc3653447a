"""Entity partitioning (paper Section 6.2), PyTorch port.

A copy of ``repro.core.partition`` (numpy only), kept so that
``repro_torch`` imports nothing of the JAX package.

Each processing element p_k (a GPU in the paper; a mesh slice here) gets a
round-robin selection of N_b query batches Q_l (l mod |p| == k), each of size
|D| / N_b, and joins Q_l against the full dataset.  Over-decomposition
(N_b >> |p|, N_b mod |p| == 0) is what gives the near-ideal balance of the
paper's Figs. 10-11 -- and doubles as straggler mitigation: a slow element
simply drains fewer batches when the host scheduler hands them out work-
stealing style (``assign_dynamic``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass
class EntityPartition:
    num_batches: int                 # N_b
    num_workers: int                 # |p|
    batch_bounds: np.ndarray         # (N_b + 1,) query-range boundaries
    assignment: np.ndarray           # (N_b,) worker of each batch (round robin)

    def batches_of(self, worker: int) -> List[int]:
        return [l for l in range(self.num_batches) if self.assignment[l] == worker]

    def query_range(self, batch: int):
        return int(self.batch_bounds[batch]), int(self.batch_bounds[batch + 1])


def make_partition(num_points: int, num_workers: int, num_batches: int) -> EntityPartition:
    """Round-robin entity partition; N_b is rounded up so N_b mod |p| == 0."""
    if num_workers < 1:
        raise ValueError("num_workers must be >= 1")
    n_b = max(num_batches, num_workers)
    if n_b % num_workers:
        n_b += num_workers - (n_b % num_workers)
    bounds = np.linspace(0, num_points, n_b + 1).round().astype(np.int64)
    assignment = np.arange(n_b, dtype=np.int64) % num_workers
    return EntityPartition(
        num_batches=n_b,
        num_workers=num_workers,
        batch_bounds=bounds,
        assignment=assignment,
    )


def assign_dynamic(batch_costs: Sequence[float], num_workers: int) -> np.ndarray:
    """Greedy longest-processing-time assignment (straggler mitigation).

    Used by the host scheduler when per-batch cost estimates exist (from the
    sampling pass); otherwise the paper's round-robin is already near-ideal
    because entity partitioning equalizes batch cost (Fig. 10).
    """
    costs = np.asarray(batch_costs, dtype=np.float64)
    order = np.argsort(-costs)
    load = np.zeros(num_workers)
    assignment = np.zeros(len(costs), dtype=np.int64)
    for b in order:
        w = int(np.argmin(load))
        assignment[b] = w
        load[w] += costs[b]
    return assignment


def simulate_scaling(
    batch_costs: Sequence[float],
    workers: Sequence[int],
    assignment: str = "round_robin",
):
    """Paper Fig. 11: simulated response time/speedup for |p| workers.

    ``assignment`` selects the paper's round-robin default or the greedy LPT
    scheduler (``"dynamic"``), so the straggler-mitigation benefit on skewed
    batch costs can be simulated directly.
    """
    costs = np.asarray(batch_costs, dtype=np.float64)
    out = []
    for p in workers:
        if assignment == "dynamic":
            assign = assign_dynamic(costs, p)
        else:
            assign = np.arange(len(costs)) % p
        t = max(costs[assign == w].sum() for w in range(p))
        out.append((p, t))
    t1 = out[0][1] if out else 1.0
    return [(p, t, t1 / t if t else float("inf")) for p, t in out]
