"""PyTorch port vs the JAX package: the host-driven distributed tier.

``repro_torch.core.DistributedSelfJoinEngine`` against
``repro.core.DistributedSelfJoinEngine(..., fused=False)`` on the shared
1/64-quantized matrix (``oracles.DATASET_CASES``), with ``==`` throughout:
``count()``, ``self_join_pairs()`` (pair arrays in order), ``knn``, every
``SelfJoinStats`` field, the partition and the cost estimates, the ring
schedule and the explicit-``max_pairs`` error text; the reference's edge
cases (``tests/test_dist_edge_cases.py``); the host ring's spans and
metrics on the port's ``obs.capture()``.  The port runs with
``device="cpu"`` (every kernel through its plain PyTorch version).  The
reference compiles one program per block shape, which dominates the time,
so the matrix spreads worker counts, assignments and tiers over the
datasets instead of crossing them.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import repro.core as ref_core
from oracles import DATASET_CASES, brute_counts, make_dataset
from repro_torch import obs
from repro_torch.core import (
    DistributedSelfJoinEngine,
    EngineConfig,
    SelfJoinConfig,
)
from repro_torch.core.dist_engine import DistributedKnnResult

DATA = {name: (d, eps) for name, d, eps in DATASET_CASES}

# (dataset, workers, assignment, execution): every dataset; 1, 3 and 8
# workers, both assignments (8 workers under "dynamic" in the edge cases
# below); all three tiers; |D| mod |p| != 0 wherever |p| > 1
MATRIX = [
    ("exp16", 1, "round_robin", "indexed"),
    ("clustered32", 1, "dynamic", "indexed"),
    ("uniform8", 3, "dynamic", "dense"),
    ("duplicated6", 8, "round_robin", "indexed"),
    ("duplicated6", 3, "dynamic", "indexed"),
    ("constantdims8", 3, "round_robin", "auto"),
    ("constantdims8", 1, "dynamic", "dense"),
]
MATRIX_IDS = ["-".join(map(str, c)) for c in MATRIX]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the plain versions run
    many tiny ops, and under a parallel test run a pool of spinning threads
    per worker oversubscribes the cores and slows every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(eps, **kw):
    kw.setdefault("k", 4)
    kw.setdefault("tile_size", 16)
    kw.setdefault("dim_block", 8)
    return dict(eps=eps, **kw)


def _engines(d, kw, **dkw):
    ref = ref_core.DistributedSelfJoinEngine(d, ref_core.SelfJoinConfig(**kw), **dkw)
    port = DistributedSelfJoinEngine(d, SelfJoinConfig(**kw), device="cpu", **dkw)
    return ref, port


@functools.lru_cache(maxsize=None)
def _run(case):
    """Both engines of a matrix case with their count() and pairs results."""
    name, p, assignment, execution = case
    d, eps = DATA[name]
    ref, port = _engines(d, _kw(eps, execution=execution), num_workers=p, assignment=assignment)
    return (ref, port), (ref.count(), port.count()), (ref.self_join_pairs(), port.self_join_pairs())


def assert_same_stats(want, got):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def assert_same_result(want, got, pairs=False):
    assert got.counts.dtype == want.counts.dtype
    np.testing.assert_array_equal(got.counts, want.counts)
    assert_same_stats(want.stats, got.stats)
    if pairs:
        assert got.pairs.dtype == want.pairs.dtype == np.int32
        np.testing.assert_array_equal(got.pairs, want.pairs)  # in order


@pytest.mark.parametrize("case", MATRIX, ids=MATRIX_IDS)
def test_count_matches_reference(case):
    _, (want, got), _ = _run(case)
    assert_same_result(want, got)
    d, eps = DATA[case[0]]
    np.testing.assert_array_equal(got.counts, brute_counts(d, eps))
    assert got.stats.num_rounds == got.stats.num_workers == case[1]


@pytest.mark.parametrize("case", MATRIX, ids=MATRIX_IDS)
def test_pairs_match_reference_in_order(case):
    _, (_, count), (want, got) = _run(case)
    assert_same_result(want, got, pairs=True)
    np.testing.assert_array_equal(got.counts, count.counts)


@pytest.mark.parametrize("case", MATRIX, ids=MATRIX_IDS)
def test_partition_costs_and_schedule_match_reference(case):
    (ref, port), _, _ = _run(case)
    np.testing.assert_array_equal(port.shard_bounds, ref.shard_bounds)
    for name in ("batch_bounds", "assignment"):
        w, g = getattr(ref.partition, name), getattr(port.partition, name)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w, err_msg=name)
    for name in ("estimate_batch_costs", "worker_loads"):
        w, g = getattr(ref, name)(), getattr(port, name)()
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert port.ring_schedule() == ref.ring_schedule()
    assert port.comm_elements() == ref.comm_elements()
    for k in range(port.num_workers):
        np.testing.assert_array_equal(port.worker_query_index(k), ref.worker_query_index(k))


def assert_same_knn(want, got):
    assert isinstance(got, DistributedKnnResult)
    for name in ("indices", "distances", "counts"):
        w, g = getattr(want, name), getattr(got, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got.eps_used, got.eps_rounds) == (want.eps_used, want.eps_rounds)
    assert_same_stats(want.stats, got.stats)


@pytest.mark.parametrize("name,p,k,eps0", [
    ("duplicated6", 2, 5, 0.06),      # grows: several candidate passes
    ("duplicated6", 1, 200, None),    # k > |D|: -1 / inf padded, to the diagonal
])
def test_knn_matches_reference(monkeypatch, name, p, k, eps0):
    from repro_torch.core import dist_engine

    monkeypatch.setattr(dist_engine, "_TOPK_ROWS", 97)  # the distances in many row blocks
    d, eps = DATA[name]
    ref, port = _engines(d, _kw(eps), num_workers=p)
    want, got = ref.knn(k, eps0=eps0), port.knn(k, eps0=eps0)
    assert_same_knn(want, got)
    if eps0 is not None:
        assert got.eps_rounds > 1


def test_knn_zero_and_negative_k_match_reference():
    d, eps = DATA["duplicated6"]
    ref, port = _engines(d, _kw(eps), num_workers=3)
    assert_same_knn(ref.knn(0), port.knn(0))
    with pytest.raises(ValueError) as want:
        ref.knn(-1)
    with pytest.raises(ValueError) as got:
        port.knn(-1)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("where", ["argument", "engine_config"])
def test_explicit_max_pairs_error_text_matches_reference(where):
    d, eps = DATA["duplicated6"]
    total = int(brute_counts(d, eps).sum())
    cap = total - 1
    eng = EngineConfig(max_pairs=cap) if where == "engine_config" else None
    ref = ref_core.DistributedSelfJoinEngine(
        d, ref_core.SelfJoinConfig(**_kw(eps)), num_workers=3,
        engine_config=ref_core.EngineConfig(max_pairs=cap) if eng else None)
    port = DistributedSelfJoinEngine(
        d, SelfJoinConfig(**_kw(eps)), num_workers=3, engine_config=eng, device="cpu")
    kw = {} if eng else {"max_pairs": cap}
    with pytest.raises(RuntimeError) as want:
        ref.self_join_pairs(**kw)
    with pytest.raises(RuntimeError) as got:
        port.self_join_pairs(**kw)
    assert str(got.value) == str(want.value)
    assert f"max_pairs={cap}" in str(got.value)
    # a cap at |R| exactly holds
    assert port.self_join_pairs(max_pairs=total).pairs.shape == (total, 2)


# -- the reference's edge cases (tests/test_dist_edge_cases.py) -------------

EDGE = {
    # name: (data, config kwargs, workers)
    "eps_zero_duplicates": (make_dataset("duplicated", 90, 6, seed=1),
                            dict(eps=0.0, k=3, tile_size=8, dim_block=8), 4),
    "single_point_many_workers": (make_dataset("uniform", 1, 5, seed=2), dict(eps=0.1, k=3), 8),
    "k_exceeds_num_dims": (make_dataset("uniform", 120, 3, seed=3), dict(eps=0.2, k=7, tile_size=8), 4),
    "empty_query_batches": (make_dataset("uniform", 5, 4, seed=4), dict(eps=0.3, k=2, tile_size=8), 8),
    "empty_dataset": (np.zeros((0, 4), np.float32), dict(eps=0.1, k=2), 4),
}


@pytest.mark.parametrize("assignment", ["round_robin", "dynamic"])
@pytest.mark.parametrize("name", list(EDGE))
def test_edge_cases_match_reference(name, assignment):
    d, kw, p = EDGE[name]
    ref, port = _engines(d, kw, num_workers=p, assignment=assignment)
    want, got = ref.count(), port.count()
    assert_same_result(want, got)
    np.testing.assert_array_equal(got.counts, brute_counts(d, kw["eps"]) if len(d) else np.zeros(0, np.int64))
    assert got.stats.num_rounds == p
    if name == "empty_query_batches":
        assert any(port.worker_query_index(k).size == 0 for k in range(p))
    if name == "eps_zero_duplicates":
        assert (got.counts >= 1).all() and got.counts.max() >= 3
    if name == "k_exceeds_num_dims":
        assert got.stats.k == 3
    if assignment == "round_robin":
        assert_same_result(ref.self_join_pairs(), port.self_join_pairs(), pairs=True)


def test_fused_ring_is_not_ported():
    """Since the fused ring is ported (``tests/test_torch_fused_ring.py``),
    this holds what a host-driven engine does with ``fused``: the
    reference's ``ValueError`` texts where no ring exists, and the host
    path for ``fused=False``."""
    d, eps = DATA["duplicated6"]
    kw = _kw(eps)
    with pytest.raises(ValueError) as want:
        ref_core.DistributedSelfJoinEngine(d, ref_core.SelfJoinConfig(**kw), num_workers=2, fused=True)
    with pytest.raises(ValueError) as got:
        DistributedSelfJoinEngine(d, SelfJoinConfig(**kw), num_workers=2, fused=True, device="cpu")
    assert str(got.value) == str(want.value) == "fused=True needs a mesh (one ring position per device)"
    ref, port = _engines(d, kw, num_workers=2)
    for fn in (lambda e: e.self_join_pairs(fused=True), lambda e: e.knn(3, fused=True)):
        with pytest.raises(ValueError) as want:
            fn(ref)
        with pytest.raises(ValueError) as got:
            fn(port)
        assert str(got.value) == str(want.value)
        assert "fused=True requires an engine constructed with fused=True" in str(got.value)
    assert port.self_join_pairs(fused=False).pairs.shape[0] == port.count().stats.num_results


def test_engine_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    d, eps = DATA["duplicated6"]
    cfg = SelfJoinConfig(**_kw(eps))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedSelfJoinEngine(d, cfg, num_workers=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedSelfJoinEngine(np.zeros((0, 4), np.float32), cfg, num_workers=2)
    port = DistributedSelfJoinEngine(d, cfg, num_workers=2, device="cpu")
    assert all(e.device == torch.device("cpu") for e in port.shards)
    with pytest.raises(ValueError, match="pass num_workers or a mesh"):
        DistributedSelfJoinEngine(d, cfg, device="cpu")


def test_host_ring_round_spans_and_parity():
    """tests/test_obs.py::test_host_ring_round_spans_and_parity on the port."""
    d = make_dataset("exponential", 403, 16, seed=5)
    de = DistributedSelfJoinEngine(
        d, SelfJoinConfig(eps=0.06, k=4, tile_size=16), num_workers=4, device="cpu"
    )
    with obs.capture() as cap:
        cres = de.count()
        pres = de.self_join_pairs()
    expect = (
        cres.stats.num_device_dispatches + pres.stats.num_device_dispatches
    )
    assert cap.span_count(cat="dispatch") == expect
    assert cap.metric("selfjoin_device_dispatches_total", path="ring_host") == expect
    # count() dispatches through the shards' count_query chunk spans, the
    # pairs blocks through their own, labelled by worker and shard
    assert cap.span_count("engine.count.chunk", "dispatch") == cres.stats.num_device_dispatches
    blocks = cap.spans("ring.block.count.chunk", "dispatch") + cap.spans("ring.block.pairs.chunk", "dispatch")
    assert len(blocks) == pres.stats.num_device_dispatches
    assert cap.span_count("ring.block.pairs.chunk", "dispatch") == pres.stats.num_chunks
    assert {(e.attrs["worker"], e.attrs["shard"]) for e in blocks} == {
        (k, j) for sched in de.ring_schedule() for k, j in sched}
    # one ring.round span per BSP round, both modes, rounds labelled 0..p-1
    rounds = cap.spans("ring.round", "ring")
    assert len(rounds) == 2 * 4
    assert {e.attrs["round"] for e in rounds} == {0, 1, 2, 3}
    assert {e.attrs["mode"] for e in rounds} == {"count", "pairs"}
    assert {e.attrs["workers"] for e in rounds} == {4}
    # kNN: one ring.knn.round event and one pairs pass per candidate pass
    with obs.capture() as kcap:
        kres = de.knn(3, eps0=0.02)
    assert kres.eps_rounds > 1
    events = [e for e in kcap.events if e.name == "ring.knn.round"]
    assert [e.attrs["round"] for e in events] == list(range(kres.eps_rounds))
    assert kcap.span_count("ring.round", "ring") == 4 * kres.eps_rounds
    assert kcap.metric("selfjoin_joins_total", path="ring_host", mode="pairs") == kres.eps_rounds
    assert kcap.span_count(cat="dispatch") == kcap.metric("selfjoin_device_dispatches_total", path="ring_host")
    np.testing.assert_array_equal(cres.counts, brute_counts(d, 0.06))
