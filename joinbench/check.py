"""The comparison that decides ``correct``.

Every join of the window is checked once the window has closed, against
``reference`` on the card.  A run's first join is checked at every point;
in each later join a sample of ``check_rows`` points (a number of the
traffic file) drawn from the seed is checked against all points.  What
can be checked over every point or every pair cheaply is checked over all
of them in every join:

count mode
  ``rows_outside_band``  checked points whose count lies outside the
                         float64 [lo, hi] (``reference.count_bounds``);
  ``rows_without_self``  points whose count is below 1 (every point
                         is its own neighbour), over all points.

pairs mode, in addition to both of those on the returned counts
  ``pairs_outside_band`` returned pairs farther than eps^2 + band, over all;
  ``duplicate_pairs``    pairs returned more than once, over all;
  ``asymmetric_pairs``   (a, b) within eps^2 - band returned without (b, a),
                         over all (on the band the program's fp32 fold
                         may take (a, b) and drop (b, a): it adds the two
                         norms in the other order);
  ``counts_not_bincount`` points whose returned count is not the number
                         of returned pairs (a, .), over all;
  ``rows_incomplete``    checked points a for which fewer returned pairs
                         (a, .) lie within eps^2 - band than the float64
                         brute force finds there.

With no duplicates and every pair within the band, a checked point's
returned set is right exactly when ``rows_incomplete`` does not count it.
Each number is a count of faults, and its limit is 0.
``joins_unchecked`` counts joins whose answer did not have the shape of
one (no array, or the wrong length).
"""
from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np
import torch

from joinbench import reference

COUNT_NUMBERS = ("rows_outside_band", "rows_without_self", "joins_unchecked")
PAIRS_NUMBERS = COUNT_NUMBERS + ("pairs_outside_band", "duplicate_pairs", "asymmetric_pairs",
                                 "counts_not_bincount", "rows_incomplete")
PAIR_BLOCK = 1 << 22


def sample_rows(num_points: int, size: int, seed: int, join_index: int) -> np.ndarray:
    """The points checked in join ``join_index``: all of them in the first
    join or where ``size`` reaches ``num_points``, else ``size`` drawn from
    the seed, each join its own."""
    if join_index == 0 or size >= num_points:
        return np.arange(num_points)
    rng = np.random.default_rng([int(seed), 2, int(join_index)])
    return np.sort(rng.choice(num_points, size=size, replace=False))


def _count_faults(points, eps, counts, rows):
    """(fault counts, (counts, rows, lo) on the device, or None where the
    counts are not an answer)."""
    n = points.shape[0]
    if counts is None or np.asarray(counts).shape != (n,):
        return {"joins_unchecked": 1}, None
    c = torch.as_tensor(np.asarray(counts), dtype=torch.int64, device=points.device)
    r = torch.as_tensor(rows, dtype=torch.int64, device=points.device)
    lo, hi = reference.count_bounds(points, r, eps)
    got = c[r]
    faults = {"rows_outside_band": int(((got < lo) | (got > hi)).sum()),
              "rows_without_self": int((c < 1).sum())}
    return faults, (c, r, lo)


def check_count(points: torch.Tensor, eps: float, counts, rows) -> Dict[str, int]:
    """Fault counts of one count join (``points`` float64 on the device)."""
    return _count_faults(points, eps, counts, rows)[0]


def check_pairs(points: torch.Tensor, eps: float, counts, pairs, rows) -> Dict[str, int]:
    """Fault counts of one pairs join: the returned counts as a count join's,
    and the returned pair list over all pairs and over the sampled rows."""
    n = points.shape[0]
    faults, got = _count_faults(points, eps, counts, rows)
    if got is None:
        return faults
    c, r, lo = got
    p = np.asarray(pairs) if pairs is not None else None
    if p is None or p.ndim != 2 or p.shape[1] != 2:
        faults["joins_unchecked"] = 1
        return faults
    dev = points.device
    pt = torch.as_tensor(p.astype(np.int64), device=dev)
    a, b = pt[:, 0], pt[:, 1]
    if pt.shape[0] and (int(pt.min()) < 0 or int(pt.max()) >= n):
        faults["joins_unchecked"] = 1
        return faults
    outside = 0
    strict = torch.zeros(a.shape[0], dtype=torch.bool, device=dev)
    for s in range(0, a.shape[0], PAIR_BLOCK):
        margin, band = reference.pair_margins(points, a[s:s + PAIR_BLOCK], b[s:s + PAIR_BLOCK], eps)
        outside += int((margin > band).sum())
        strict[s:s + PAIR_BLOCK] = margin <= -band
    keys = torch.sort(a * n + b).values
    dup = int((keys[1:] == keys[:-1]).sum()) if keys.shape[0] > 1 else 0
    mirrored = b[strict] * n + a[strict]
    asym = int((~torch.isin(mirrored, keys)).sum())
    bc = torch.bincount(a, minlength=n)
    strict_rows = torch.bincount(a[strict], minlength=n)[r]
    faults.update({
        "pairs_outside_band": outside,
        "duplicate_pairs": dup,
        "asymmetric_pairs": asym,
        "counts_not_bincount": int((bc != c).sum()),
        "rows_incomplete": int((strict_rows != lo).sum()),
    })
    return faults


def check_joins(points_np: np.ndarray, joins: Iterable, *, mode: str, check_rows: int, seed: int,
                device) -> Dict[str, int]:
    """Summed fault counts over ``joins`` (each with ``eps``, ``counts`` and,
    in pairs mode, ``pairs``), every name of the mode present."""
    points = torch.as_tensor(points_np, device=device).double()
    names = COUNT_NUMBERS if mode == "count" else PAIRS_NUMBERS
    total = {k: 0 for k in names}
    for i, j in enumerate(joins):
        rows = sample_rows(points.shape[0], check_rows, seed, i)
        if mode == "count":
            got = check_count(points, j.eps, j.counts, rows)
        else:
            got = check_pairs(points, j.eps, j.counts, j.pairs, rows)
        for k, v in got.items():
            total[k] += v
    return total


def limits(numbers: Dict[str, int]) -> Dict[str, Dict[str, int]]:
    """Each number beside its limit (all exact: 0)."""
    return {k: {"value": int(v), "limit": 0} for k, v in numbers.items()}


def passed(numbers: Dict[str, int]) -> bool:
    return all(v <= 0 for v in numbers.values())


def lines(numbers: Dict[str, int]) -> List[str]:
    return [f"check {k} {v} limit 0" for k, v in numbers.items()]
