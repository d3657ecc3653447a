"""PyTorch port vs the JAX package: the legacy host-loop join
(``self_join_hostloop``) and its batching (``compute_num_batches``,
``batch_ranges``) on the CPU.

Both packages get the same numpy points; the port runs with
``device="cpu"`` (K1 / K2 per pair through their plain PyTorch versions),
the reference with its jnp backend (and once with ``use_pallas=True``, the
Pallas kernel in interpret mode).  Coordinates are 1/64-quantized, so
counts, pair arrays (in order) and every ``SelfJoinStats`` field compare
with ``==``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as ref_core
from oracles import brute_counts, brute_pairs, make_dataset, pair_set
from repro.core import batching as ref_batching
from repro_torch.core import SelfJoinConfig, SelfJoinEngine, self_join_hostloop
from repro_torch.core import batching, selfjoin
from repro_torch.core.types import SelfJoinStats

STATS = [f.name for f in dataclasses.fields(SelfJoinStats)]


def _kw(eps, **kw):
    kw.setdefault("k", 4)
    kw.setdefault("tile_size", 16)
    kw.setdefault("dim_block", 8)
    return dict(eps=eps, **kw)


def _both(d, kw, return_pairs, **call):
    want = ref_core.self_join_hostloop(d, ref_core.SelfJoinConfig(**kw), return_pairs, **call)
    got = self_join_hostloop(d, SelfJoinConfig(**kw), return_pairs, device="cpu", **call)
    return want, got


def assert_same(want, got):
    assert got.counts.dtype == np.int64
    np.testing.assert_array_equal(got.counts, want.counts)
    for name in STATS:
        assert getattr(got.stats, name) == getattr(want.stats, name), name
    if want.pairs is None:
        assert got.pairs is None
    else:
        assert got.pairs.dtype == np.int32
        np.testing.assert_array_equal(got.pairs, want.pairs)  # in order


@pytest.mark.parametrize("est,batch_size,min_batches", [
    (0, 10 ** 8, 3), (10, 10 ** 8, 3), (10 ** 9, 10 ** 8, 3), (3 * 10 ** 8 + 1, 10 ** 8, 3),
    (500, 50, 3), (17, 0, 1), (1, 1, 5), (-4, 7, 2),
])
def test_num_batches_matches_reference(est, batch_size, min_batches):
    assert batching.compute_num_batches(est, batch_size, min_batches) == ref_batching.compute_num_batches(
        est, batch_size, min_batches)


@pytest.mark.parametrize("num_pairs,num_batches", [
    (0, 3), (0, 1), (1, 3), (5, 7), (7, 7), (1000, 7), (1001, 3), (10, 1), (3, 0),
])
def test_batch_ranges_match_reference(num_pairs, num_batches):
    if num_pairs == 0:
        # the reference's step is 0 here and range() refuses it; the host
        # loop never asks (a non-empty input has its self tile pairs)
        with pytest.raises(ValueError) as want:
            list(ref_batching.batch_ranges(num_pairs, num_batches))
        with pytest.raises(ValueError) as got:
            list(batching.batch_ranges(num_pairs, num_batches))
        assert str(got.value) == str(want.value)
        return
    got = list(batching.batch_ranges(num_pairs, num_batches))
    assert got == list(ref_batching.batch_ranges(num_pairs, num_batches))
    assert got[0][0] == 0 and got[-1][1] == num_pairs
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(got, got[1:]))


@pytest.mark.parametrize("return_pairs", [False, True], ids=["count", "pairs"])
def test_hostloop_matches_reference(dataset_case, return_pairs):
    name, d, eps = dataset_case
    want, got = _both(d, _kw(eps), return_pairs)
    assert_same(want, got)
    np.testing.assert_array_equal(got.counts, brute_counts(d, eps), err_msg=name)


def test_forced_batches_match_reference(monkeypatch):
    """batch_size=50 forces many batches (``tests/test_batching.py``'s case,
    here through the host loop)."""
    d = make_dataset("exponential", 400, 16, seed=31)
    kw = _kw(0.08, batch_size=50, min_batches=3)
    seen = []
    ranges = batching.batch_ranges

    def spy(num_pairs, num_batches):
        seen.append(num_batches)
        return ranges(num_pairs, num_batches)

    monkeypatch.setattr(batching, "batch_ranges", spy)
    want, got = _both(d, kw, True)
    assert_same(want, got)
    assert seen and seen[0] > 3
    assert pair_set(got.pairs) == pair_set(brute_pairs(d, 0.08))


def test_hostloop_matches_reference_pallas_interpret():
    """One tiny case against the reference's Pallas kernel (interpret mode)."""
    d = make_dataset("clustered", 120, 8, seed=4)
    kw = _kw(0.2, use_pallas=True)
    for return_pairs in (False, True):
        want, got = _both(d, kw, return_pairs)
        assert_same(want, got)


@pytest.mark.parametrize("shortc", [True, False])
def test_engine_matches_hostloop(dataset_case, shortc):
    """The port's engine against the port's host loop: counts, pair sets and
    the work counters the two share."""
    name, d, eps = dataset_case
    cfg = SelfJoinConfig(**_kw(eps, shortc=shortc))
    eng = SelfJoinEngine(d, cfg, device="cpu")
    old_c = self_join_hostloop(d, cfg, device="cpu")
    new_c = eng.count()
    np.testing.assert_array_equal(new_c.counts, old_c.counts, err_msg=name)
    for field in ("num_candidates", "dim_blocks_skipped", "dim_blocks_total", "num_results"):
        assert getattr(new_c.stats, field) == getattr(old_c.stats, field), (name, field)
    old_p = self_join_hostloop(d, cfg, return_pairs=True, device="cpu")
    new_p = eng.pairs()
    np.testing.assert_array_equal(new_p.counts, old_p.counts)
    assert pair_set(new_p.pairs) == pair_set(old_p.pairs)
    assert new_p.stats.num_candidates == old_p.stats.num_candidates


def test_max_pairs_error_text_matches_reference():
    d = make_dataset("exponential", 300, 8, seed=28)
    kw = _kw(0.2, k=3)
    total = self_join_hostloop(d, SelfJoinConfig(**kw), device="cpu").stats.num_results
    with pytest.raises(RuntimeError) as want:
        ref_core.self_join_hostloop(d, ref_core.SelfJoinConfig(**kw), True, total // 2)
    with pytest.raises(RuntimeError) as got:
        self_join_hostloop(d, SelfJoinConfig(**kw), True, total // 2, device="cpu")
    assert str(got.value) == str(want.value)
    assert f"max_pairs={total // 2}" in str(got.value)
    assert_same(*_both(d, kw, True, max_pairs=total))  # an exact cap suffices


@pytest.mark.parametrize("n", [0, 1])
@pytest.mark.parametrize("return_pairs", [False, True], ids=["count", "pairs"])
def test_empty_and_single_point_match_reference(n, return_pairs):
    d = make_dataset("uniform", 8, 8, seed=3)[:n]
    want, got = _both(d, _kw(0.1, k=2), return_pairs)
    assert_same(want, got)
    if return_pairs:
        assert got.pairs.shape == (n, 2)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    d = make_dataset("uniform", 20, 4, seed=1)
    for call in (
        lambda: self_join_hostloop(d, SelfJoinConfig(eps=0.1, k=2)),
        lambda: selfjoin.self_join_hostloop(d[:0], SelfJoinConfig(eps=0.1, k=2), True),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
