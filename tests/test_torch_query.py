"""PyTorch port vs the JAX package: the bipartite query plan on the CPU.

``build_query_tile_plan``, ``SelfJoinEngine.prepare_query`` (the combined
(query | data) tables, array for array, padding rows included),
``count_query`` (counts and the ``SelfJoinStats`` work counters),
``from_prebuilt`` and ``select_k``.  Both packages get the same numpy
points; the port runs with ``device="cpu"`` (every kernel through its plain
PyTorch version).  Coordinates are 1/64-quantized, so everything compares
with ``==``.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as ref_core
from repro.core.grid import build_query_tile_plan as ref_build_query_tile_plan
from oracles import bipartite_counts, make_dataset
from repro_torch.core import (
    GridIndex,
    SelfJoinConfig,
    SelfJoinEngine,
    TilePlan,
    build_query_tile_plan,
    estimate_k_costs,
    select_k,
)
from test_torch_engine import STATS

MODES = ("indexed", "dense", "auto")
TABLES = ("tiles", "tile_len", "tile_start", "order")
PLAN_FIELDS = (
    "tile_size", "q_order", "q_sorted", "q_tile_start", "q_tile_len", "pair_q",
    "pair_d", "num_tile_pairs_total", "num_candidates",
)


def _kw(eps, **kw):
    kw.setdefault("k", 4)
    kw.setdefault("tile_size", 16)
    kw.setdefault("dim_block", 8)
    return dict(eps=eps, **kw)


def _engines(d, kw):
    ref = ref_core.SelfJoinEngine(d, ref_core.SelfJoinConfig(**kw))
    port = SelfJoinEngine(d, SelfJoinConfig(**kw), device="cpu")
    return ref, port


def _queries(d, seed, n_extra=24):
    """Mixed batch: dataset rows (exact hits, duplicates) + fresh points."""
    extra = make_dataset("uniform", n_extra, d.shape[1], seed=seed)
    return np.concatenate([d[: min(41, len(d))], extra])


def assert_same_plan(want, got):
    for name in PLAN_FIELDS:
        w, g = getattr(want, name), getattr(got, name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert g == w, name


def assert_same_tables(want, got):
    assert want is not None and got is not None
    for name in ("eps", "nq", "n_slots", "execution", "cost_indexed", "cost_dense", "num_candidates", "num_pairs"):
        assert getattr(got, name) == getattr(want, name), name
    for name in TABLES:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    for name in ("pair_a", "pair_b"):
        w, g = getattr(want, name), getattr(got, name)
        assert g.dtype == w.dtype == np.int32, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert_same_plan(want.qplan, got.qplan)


def assert_same_result(want, got):
    assert got.counts.dtype == np.int64
    np.testing.assert_array_equal(got.counts, want.counts)
    for name in STATS:
        assert getattr(got.stats, name) == getattr(want.stats, name), name


def test_query_tile_plan_matches_reference(dataset_case):
    _, d, eps = dataset_case
    ref, port = _engines(d, _kw(eps))
    q = _queries(d, seed=71)
    q_work = q if ref.snapshot.perm is None else q[:, ref.snapshot.perm]
    for sortidu in (True, False):
        want = ref_build_query_tile_plan(ref.grid, ref.plan, q_work, sortidu)
        got = build_query_tile_plan(port.grid, port.plan, q_work, sortidu)
        assert_same_plan(want, got)
    # the engine's own entry applies the permutation itself
    assert_same_plan(ref.build_query_plan(q), port.build_query_plan(q))
    # queries far outside the data's box still probe whichever cells border it
    far = np.full((5, d.shape[1]), 1.5, np.float32)
    assert_same_plan(ref.build_query_plan(far), port.build_query_plan(far))


@pytest.mark.parametrize("pad", [None, 128], ids=["unpadded", "bucket128"])
@pytest.mark.parametrize("mode", MODES)
def test_prepare_query_tables_match_reference(dataset_case, mode, pad):
    _, d, eps = dataset_case
    ref, port = _engines(d, _kw(eps, execution=mode))
    q = _queries(d, seed=72)
    assert_same_tables(
        ref.prepare_query(q, eps, pad_queries_to=pad),
        port.prepare_query(q, eps, pad_queries_to=pad),
    )
    # a pinned snapshot at a larger radius: the engine's resident one stays
    want = ref.prepare_query(q, 1.5 * eps, pad_queries_to=pad, snapshot=ref.snapshot.rebuilt(1.5 * eps))
    got = port.prepare_query(q, 1.5 * eps, pad_queries_to=pad, snapshot=port.snapshot.rebuilt(1.5 * eps))
    assert_same_tables(want, got)
    assert port.snapshot.index_eps == ref.snapshot.index_eps == eps
    assert port.snapshot.point_rows == ref.snapshot.point_rows
    np.testing.assert_array_equal(port.snapshot.point_order_padded.numpy(), np.asarray(ref.snapshot.point_order_padded))
    for w, g in zip(ref.snapshot.data_bounds, port.snapshot.data_bounds):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", MODES)
def test_count_query_matches_reference_and_count(dataset_case, mode):
    _, d, eps = dataset_case
    ref, port = _engines(d, _kw(eps, execution=mode))
    q = _queries(d, seed=73)
    for e in (eps, eps / 2):  # a smaller radius reuses the index
        got = port.count_query(q, e)
        assert_same_result(ref.count_query(q, e), got)
        np.testing.assert_array_equal(got.counts, bipartite_counts(q, d, e))
    assert port.snapshot.index_eps == eps
    # querying the index with its own points is the self-join
    np.testing.assert_array_equal(port.count_query(d).counts, port.count().counts)
    assert_same_result(ref.count_query(d), port.count_query(d))


def test_count_query_edges_match_reference():
    d = make_dataset("uniform", 60, 6, seed=74)
    ref, port = _engines(d, _kw(0.2))
    empty = np.zeros((0, 6), np.float32)
    assert port.prepare_query(empty) is None and ref.prepare_query(empty) is None
    assert_same_result(ref.count_query(empty), port.count_query(empty))
    assert port.count_query(empty).counts.shape == (0,)
    with pytest.raises(ValueError, match="pad_queries_to"):
        port.prepare_query(d[:20], pad_queries_to=16)
    # a larger radius than the index rebuilds the resident snapshot, in both
    q = _queries(d, seed=75)
    assert_same_result(ref.count_query(q, 0.35), port.count_query(q, 0.35))
    assert port.snapshot.index_eps == ref.snapshot.index_eps == 0.35
    # an empty index answers zeros
    ref0, port0 = _engines(empty, _kw(0.2))
    assert port0.prepare_query(q) is None
    assert_same_result(ref0.count_query(q), port0.count_query(q))


def test_from_prebuilt_over_reference_grid(dataset_case):
    """An engine over the JAX package's (perm, grid, plan), no host build."""
    _, d, eps = dataset_case
    kw = _kw(eps)
    ref = ref_core.SelfJoinEngine(d, ref_core.SelfJoinConfig(**kw))
    snap = ref.snapshot
    port = SelfJoinEngine.from_prebuilt(
        snap.pts, snap.perm, GridIndex(**dataclasses.asdict(snap.grid)),
        TilePlan(**dataclasses.asdict(snap.plan)), snap.index_eps, SelfJoinConfig(**kw), device="cpu",
    )
    assert port.snapshot.tile_rows == snap.tile_rows and port.snapshot.point_rows == snap.point_rows
    np.testing.assert_array_equal(port.snapshot.tiles.numpy(), np.asarray(snap.tiles))
    q = _queries(d, seed=76)
    assert_same_result(ref.count_query(q), port.count_query(q))
    assert_same_result(ref.count(), port.count())


@pytest.mark.parametrize("kind,eps", [("exponential", 0.05), ("clustered", 0.1), ("uniform", 0.3)])
def test_select_k_matches_reference(kind, eps):
    d = make_dataset(kind, 500, 16, seed=56)
    ks = [2, 3, 4, 6]
    want = ref_core.estimate_k_costs(d, eps, ks, sample_frac=0.01, tile_size=16)
    got = estimate_k_costs(d, eps, ks, sample_frac=0.01, tile_size=16)
    assert [dataclasses.asdict(e) for e in got] == [dataclasses.asdict(e) for e in want]
    assert select_k(d, eps, ks, sample_frac=0.01, tile_size=16) == ref_core.select_k(
        d, eps, ks, sample_frac=0.01, tile_size=16)
