"""The plain reference and the check against a float64 NumPy brute force."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from joinbench import check, datagen, reference


def numpy_d2(x):
    x = x.astype(np.float64)
    return ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)


@pytest.fixture(scope="module")
def points():
    cfg = {"num_points": 700, "num_dims": 9, "data": {"kind": "clustered", "num_clusters": 6, "cluster_std": 0.04}}
    return datagen.make_points(cfg, 11)


@pytest.mark.parametrize("eps", [0.05, 0.12])
def test_count_bounds_hold_the_float64_counts(points, eps, monkeypatch):
    monkeypatch.setattr(reference, "ROW_BLOCK", 64)   # several blocks each way
    monkeypatch.setattr(reference, "COL_BLOCK", 256)
    d2 = numpy_d2(points)
    want = (d2 <= eps * eps).sum(1)
    rows = np.arange(0, points.shape[0], 3)
    lo, hi = reference.count_bounds(torch.from_numpy(points).double(), torch.from_numpy(rows), eps)
    lo, hi = lo.numpy(), hi.numpy()
    assert (lo <= want[rows]).all() and (want[rows] <= hi).all()
    near = (np.abs(d2 - eps * eps) <= 1e-4).any(1)[rows]
    assert (lo[~near] == hi[~near]).all()


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_brute_force_at_a_precision(points, precision):
    eps = 0.12
    x = torch.from_numpy(points)
    counts = reference.brute_counts(x, eps, precision).numpy()
    pairs = reference.brute_pairs(x, eps, precision).numpy()
    assert counts.sum() == pairs.shape[0]
    assert (np.bincount(pairs[:, 0], minlength=points.shape[0]) == counts).all()
    lo, hi = reference.count_bounds(x.double(), torch.arange(points.shape[0]), eps)
    outside = ((torch.from_numpy(counts) < lo) | (torch.from_numpy(counts) > hi)).sum()
    if precision == "fp32":
        assert outside == 0  # fp32 rounding stays inside the band
    else:
        assert outside > 0   # bf16 moves pairs across it: the control's kind of fault


def test_check_passes_the_float64_answer_and_names_each_fault(points):
    eps = 0.12
    d2 = numpy_d2(points)
    n = points.shape[0]
    a, b = np.nonzero(d2 <= eps * eps)
    counts = np.bincount(a, minlength=n)
    pairs = np.stack([a, b], 1).astype(np.int32)
    x = torch.from_numpy(points).double()
    rows = np.arange(n)
    assert not any(check.check_pairs(x, eps, counts, pairs, rows).values())
    assert not any(check.check_count(x, eps, counts, rows).values())
    far = np.argmax(d2[0])
    cases = {
        "rows_outside_band": (counts + (np.arange(n) == 5), pairs),
        "rows_without_self": (np.where(np.arange(n) == 7, 0, counts), pairs),
        "pairs_outside_band": (counts, np.concatenate([pairs[1:], [[0, far]]]).astype(np.int32)),
        "duplicate_pairs": (counts, np.concatenate([pairs[:-1], pairs[:1]]).astype(np.int32)),
        "counts_not_bincount": (counts, pairs[pairs[:, 0] != pairs[:, 1]]),
        "joins_unchecked": (counts[:-1], pairs),
    }
    for name, (c, p) in cases.items():
        assert check.check_pairs(x, eps, c, p, rows)[name] > 0, name
    # one row's neighbour left out: incomplete and asymmetric, counts adjusted to match
    drop = np.nonzero((pairs[:, 0] == 3) & (pairs[:, 1] != 3))[0][0]
    kept = np.delete(pairs, drop, 0)
    got = check.check_pairs(x, eps, np.bincount(kept[:, 0], minlength=n), kept, rows)
    assert got["rows_incomplete"] == 1 and got["asymmetric_pairs"] == 1 and got["rows_outside_band"] == 1


def test_sampled_rows_are_drawn_from_the_seed():
    a = check.sample_rows(10 ** 6, 100, 2 ** 33 + 1, 4)
    assert a.shape == (100,) and (a == check.sample_rows(10 ** 6, 100, 2 ** 33 + 1, 4)).all()
    assert not (a == check.sample_rows(10 ** 6, 100, 2 ** 33 + 1, 5)).all()
    assert (check.sample_rows(50, 100, 1, 3) == np.arange(50)).all()
    assert (check.sample_rows(10 ** 6, 100, 1, 0) == np.arange(10 ** 6)).all()  # the first join: every point


def test_joins_are_summed():
    x = np.zeros((4, 2), np.float32)
    joins = [SimpleNamespace(eps=0.1, counts=np.full(4, 4), pairs=None),
             SimpleNamespace(eps=0.1, counts=np.full(4, 3), pairs=None)]
    got = check.check_joins(x, joins, mode="count", check_rows=4, seed=0, device="cpu")
    assert got == {"rows_outside_band": 4, "rows_without_self": 0, "joins_unchecked": 0}
