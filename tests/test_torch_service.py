"""PyTorch port vs the JAX package: ``SimilarityIndex`` + ``QueryService`` on the CPU.

The parity matrix of ``tests/test_service.py``: every request goes to the
port's service (``device="cpu"``,
every kernel through its plain PyTorch version) and to
``repro.join.QueryService`` on the same stream (``Twin``), and the two must
agree with ``==`` -- counts, pairs, kNN indices and distances, and every
``ServiceStats`` field, ``num_traces`` (the port's new shape keys against the
reference's jit traces) and ``num_device_dispatches`` included.  Where the
reference's tests hold the answers against the float64 oracles
(``bipartite_counts``, ``brute_topk``), so do these.
Coordinates are 1/64-quantized.  ``Twin`` and the helpers here serve
``tests/test_torch_mutation.py`` (the mutable index) too.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as ref_core
import repro.join as ref_join
from repro import obs as ref_obs
from oracles import bipartite_counts, brute_topk, make_dataset
from repro_torch import obs
from repro_torch.core import SelfJoinConfig
from repro_torch.join import QueryService, SimilarityIndex

RESULT_ARRAYS = ("counts", "pairs", "indices", "distances")


def _kw(eps, **kw):
    kw.setdefault("k", 4)
    kw.setdefault("tile_size", 16)
    kw.setdefault("dim_block", 8)
    return dict(eps=eps, **kw)


def _queries(d, seed, n_extra=24, n_rows=41):
    """Mixed batch: dataset rows (exact hits, duplicates) + fresh points."""
    extra = make_dataset("uniform", n_extra, d.shape[1], seed=seed)
    return np.concatenate([d[: min(n_rows, len(d))], extra])


def assert_same_answer(want, got):
    for name in RESULT_ARRAYS:
        if hasattr(want, name):
            w, g = getattr(want, name), getattr(got, name)
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)


class Twin:
    """The same index and request stream in both packages, compared per call."""

    def __init__(self, d, kw, ref_index=None, port_index=None, **index_kw):
        self.ri = ref_index or ref_join.SimilarityIndex(d, ref_core.SelfJoinConfig(**kw), **index_kw)
        self.pi = port_index or SimilarityIndex(d, SelfJoinConfig(**kw), device="cpu", **index_kw)
        self.rs = ref_join.QueryService(self.ri)
        self.ps = QueryService(self.pi)

    def _both(self, kind, *args):
        want = getattr(self.rs, kind)(*args)
        got = getattr(self.ps, kind)(*args)
        assert_same_answer(want, got)
        return got

    def range_count(self, q, eps=None):
        return self._both("range_count", q, eps)

    def range_pairs(self, q, eps=None):
        return self._both("range_pairs", q, eps)

    def knn(self, q, k, eps0=None):
        return self._both("knn", q, k, eps0)

    def insert(self, pts):
        ids = self.pi.insert(pts)
        np.testing.assert_array_equal(ids, self.ri.insert(pts))
        return ids

    def delete(self, ids):
        n = self.pi.delete(ids)
        assert n == self.ri.delete(ids)
        return n

    def compact(self):
        self.ri.compact()
        self.pi.compact()
        assert self.pi.epoch == self.ri.epoch

    def assert_totals(self):
        assert dataclasses.asdict(self.ps.total) == dataclasses.asdict(self.rs.total)
        assert self.ps.buckets_used == self.rs.buckets_used
        for name in ("num_points", "delta_size", "tombstone_count", "epoch", "index_eps"):
            assert getattr(self.pi, name) == getattr(self.ri, name), name


# -- range queries and kNN over the matrix -----------------------------------


def test_range_and_knn_match_reference(dataset_case):
    _, d, eps = dataset_case
    tw = Twin(d, _kw(eps))
    q = _queries(d, seed=31)
    rc = tw.range_count(q, eps)
    np.testing.assert_array_equal(rc.counts, bipartite_counts(q, d, eps))
    np.testing.assert_array_equal(rc.counts, tw.pi.engine.count_query(q, eps).counts)
    rp = tw.range_pairs(q, eps)
    assert rp.pairs.shape[0] == rc.stats.num_results
    half = tw.range_count(q, eps / 2)  # a smaller radius reuses the index
    np.testing.assert_array_equal(half.counts, bipartite_counts(q, d, eps / 2))
    assert half.stats.index_rebuilds == 0
    for k in (1, 5):
        kn = tw.knn(q, k)
        want_idx, want_dist = brute_topk(q, d, k)
        np.testing.assert_array_equal(kn.indices, want_idx)
        np.testing.assert_array_equal(kn.distances, want_dist)
    tw.assert_totals()


@pytest.mark.parametrize("case", ["k_above_size", "duplicated_ties", "far_queries", "eps0_index"])
def test_knn_edges_match_reference(case):
    if case == "k_above_size":  # pads with -1 / inf after growing to the cap
        d = make_dataset("uniform", 23, 6, seed=40)
        tw, q, k = Twin(d, _kw(0.2)), _queries(d, seed=41)[:9], 40
    elif case == "duplicated_ties":  # maximal tie pressure, ties by id
        d = make_dataset("duplicated", 90, 6, seed=42)
        tw, q, k = Twin(d, _kw(0.1)), d[:31], 7
    elif case == "far_queries":  # doubles out from a tiny radius
        d = make_dataset("clustered", 120, 8, seed=43)
        tw, q, k = Twin(d, _kw(0.01)), np.ones((5, 8), np.float32), 3
    else:  # an eps == 0 index seeds the expansion from the cap
        d = make_dataset("duplicated", 60, 6, seed=44)
        tw, q, k = Twin(d, _kw(0.0)), d[:8], 4
    kn = tw.knn(q, k)
    want_idx, want_dist = brute_topk(q, d, k)
    np.testing.assert_array_equal(kn.indices, want_idx)
    np.testing.assert_array_equal(kn.distances, want_dist)
    if case in ("k_above_size", "far_queries"):
        assert kn.stats.eps_rounds > 1
    if case == "far_queries":
        assert kn.stats.index_rebuilds >= 1
    tw.assert_totals()


# -- serving contracts: traces and dispatches ---------------------------------


def test_mixed_stream_traces_and_dispatches_match_reference():
    """Mixed-shape range requests: per request, the same new shape keys as
    the reference's new traces (at most one per bucket), and a second
    stream of the same shapes adds none."""
    d = make_dataset("exponential", 397, 16, seed=50)
    tw = Twin(d, _kw(0.08))
    pool = _queries(d, seed=51, n_extra=300)
    rng = np.random.default_rng(52)
    sizes = []
    for _ in range(40):
        nq = int(rng.integers(1, 300))
        sizes.append(nq)
        eps = float(rng.choice([0.08, 0.05, 0.031, 0.017]))  # all <= build eps
        q = pool[rng.choice(pool.shape[0], size=nq, replace=False)]
        res = tw.range_count(q, eps)
        np.testing.assert_array_equal(res.counts, bipartite_counts(q, d, eps))
    assert tw.ps.total.index_rebuilds == 0
    assert tw.ps.total.num_traces <= len(tw.ps.buckets_used) <= 6
    before = tw.ps.total.num_traces
    for nq in sizes[:6]:
        tw.range_count(pool[:nq], 0.06)
    assert tw.ps.total.num_traces == before
    tw.assert_totals()


def test_pairs_and_knn_repeats_add_no_traces():
    d = make_dataset("uniform", 211, 8, seed=53)
    tw = Twin(d, _kw(0.3))
    q = _queries(d, seed=54)
    first = tw.range_pairs(q, 0.3)
    assert first.stats.num_traces > 0
    again = tw.range_pairs(q, 0.3)
    assert again.stats.num_traces == 0
    np.testing.assert_array_equal(first.pairs, again.pairs)
    tw.knn(q, 4)
    assert tw.knn(q, 4).stats.num_traces == 0
    tw.assert_totals()


def test_resident_snapshot_stays_after_far_knn():
    d = make_dataset("clustered", 300, 8, seed=58)
    tw = Twin(d, _kw(0.05))
    q = _queries(d, seed=59)
    base = tw.range_count(q, 0.05)
    kn = tw.knn(np.ones((3, 8), np.float32), 2)
    assert kn.stats.index_rebuilds >= 2
    assert tw.pi.index_eps == 0.05
    after = tw.range_count(q, 0.05)
    np.testing.assert_array_equal(after.counts, base.counts)
    assert after.stats.num_candidates == base.stats.num_candidates
    assert after.stats.num_traces == 0
    tw.assert_totals()


def test_stream_straddling_tier_boundary_matches_reference():
    """``execution="auto"``: hot batches dispatch dense, cold ones indexed, in
    one bucket; at most one count shape key per bucket per tier, and the
    same traces as the reference request for request."""
    d = make_dataset("clustered", 300, 4, seed=60)
    tw = Twin(d, _kw(0.15, execution="auto"))
    hot = d[:48]
    cold = np.full((48, 4), 0.99, np.float32)
    for _ in range(2):
        for q, want_tier in ((hot, "dense"), (cold, "indexed")):
            res = tw.range_count(q, 0.15)
            np.testing.assert_array_equal(res.counts, bipartite_counts(q, d, 0.15))
            assert res.stats.execution == want_tier
    assert tw.ps.total.execution == "mixed"
    assert len(tw.ps.buckets_used) == 1 and tw.ps.total.num_traces <= 2
    for q in (hot, cold):
        rp = tw.range_pairs(q, 0.15)
        np.testing.assert_array_equal(rp.counts, bipartite_counts(q, d, 0.15))
    tw.assert_totals()


def test_service_spans_equal_stats_counters():
    """The service part of ``tests/test_obs.py``'s stream: the port's trace
    and dispatch spans and mirrored metrics equal its stats counters."""
    rng = np.random.default_rng(0)
    pts = make_dataset("uniform", 400, 4, seed=9)
    tw = Twin(pts, dict(eps=0.1, k=3, tile_size=16))
    tw.range_count(make_dataset("uniform", 16, 4, seed=10), 0.1)  # warm one bucket
    tr0, dd0 = tw.ps.total.num_traces, tw.ps.total.num_device_dispatches
    with obs.capture() as cap, ref_obs.capture() as ref_cap:
        for i in range(24):
            nq = 8 if i % 3 else 16
            q = make_dataset("uniform", nq, 4, seed=100 + i)
            if i % 4 == 0:
                tw.range_pairs(q, 0.1)
            elif i % 4 == 1:
                tw.knn(q[:4], 3)
            else:
                tw.range_count(q, 0.1)
            if i % 12 == 5:
                tw.insert(rng.random((5, 4), dtype=np.float32))
            if i == 20:
                tw.delete(tw.insert(rng.random((2, 4), dtype=np.float32)))
    d_tr = tw.ps.total.num_traces - tr0
    d_dd = tw.ps.total.num_device_dispatches - dd0
    assert d_tr > 0
    assert cap.span_count(cat="trace") == d_tr
    assert cap.span_count(cat="dispatch") == d_dd
    assert cap.metric("service_traces_total") == d_tr
    assert cap.metric("service_dispatches_total") == d_dd
    assert cap.metric("service_requests_total") == 24
    for name, cat, n in (("service.request", "request", 24), ("service.request", "log", 24),
                         ("service.pin", "service", 24), ("service.unpin", "service", 24),
                         ("index.insert", "index", 3), ("index.delete", "index", 1)):
        assert cap.span_count(name, cat) == ref_cap.span_count(name, cat) == n, name
    assert cap.metric("index_inserts_total") == ref_cap.metric("index_inserts_total") == 12
    assert cap.metric("index_deletes_total") == 2
    for kind in ("range_count", "range_pairs", "knn"):
        assert cap.metric("service_requests_total", kind=kind) == ref_cap.metric(
            "service_requests_total", kind=kind) > 0
    # the two packages emit the same spans, by name and category, beside the
    # port's own index-build phases (over-radius temporary snapshots)
    names = sorted((e.name, e.cat) for e in cap.events if not e.name.startswith("snapshot."))
    assert names == sorted((e.name, e.cat) for e in ref_cap.events)
    assert cap.dropped == 0
    tw.assert_totals()


def test_auto_k_selection_is_baked_into_the_index(tmp_path):
    d = make_dataset("exponential", 500, 16, seed=56)
    ks = [2, 3, 4, 6]
    idx = SimilarityIndex(d, SelfJoinConfig(**_kw(0.05, k=2)), k_candidates=ks, device="cpu")
    ref = ref_join.SimilarityIndex(d, ref_core.SelfJoinConfig(**_kw(0.05, k=2)), k_candidates=ks)
    assert idx.config.k == ref.config.k == ref_core.select_k(d, 0.05, ks, sample_frac=0.01, tile_size=16)
    assert SimilarityIndex.load(idx.save(tmp_path / "auto_k"), device="cpu").config.k == idx.config.k


def test_empty_edges_match_reference():
    d = make_dataset("uniform", 50, 6, seed=57)
    tw = Twin(d, _kw(0.2))
    empty_q = np.zeros((0, 6), np.float32)
    assert tw.range_count(empty_q).counts.shape == (0,)
    assert tw.range_pairs(empty_q).pairs.shape == (0, 2)
    assert tw.knn(empty_q, 3).indices.shape == (0, 3)
    assert tw.knn(d[:4], 0).indices.shape == (4, 0)
    tw.assert_totals()
    etw = Twin(np.zeros((0, 6), np.float32), _kw(0.2))
    assert (etw.range_count(d[:5]).counts == 0).all()
    assert etw.range_pairs(d[:5]).pairs.shape == (0, 2)
    kn = etw.knn(d[:5], 3)
    assert (kn.indices == -1).all() and np.isinf(kn.distances).all()
    etw.assert_totals()
