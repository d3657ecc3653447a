"""PyTorch port vs the JAX package: the mutable ``SimilarityIndex`` on the CPU.

The parity matrix of ``tests/test_mutation.py``: inserts into the delta
buffer, tombstone deletes, compaction (atomic, no new trace), the spill
policy and an interleaved stream, each applied to the port's index and
service (``device="cpu"``) and to ``repro.join``'s on the same stream
(``test_torch_service.Twin``), which must agree with ``==`` -- answers and
every ``ServiceStats`` field -- and with the float64 ``ChurnOracle``.  A
``.npz`` written by either package, churn state included, loads in the
other and serves the same answers.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.join as ref_join
from oracles import ChurnOracle, make_dataset, pair_set
from repro_torch.core import SelfJoinConfig
from repro_torch.join import QueryService, SimilarityIndex
from test_torch_service import RESULT_ARRAYS, Twin, _kw, _queries


def _assert_matches_oracle(tw, oracle, q, eps, k=3):
    """range_count + range_pairs + kNN: both packages equal, and equal the
    churn oracle, bitwise."""
    rc = tw.range_count(q, eps)
    np.testing.assert_array_equal(rc.counts, oracle.range_count(q, eps))
    rp = tw.range_pairs(q, eps)
    np.testing.assert_array_equal(rp.pairs, oracle.range_pairs(q, eps))
    np.testing.assert_array_equal(rp.counts, rc.counts)
    kn = tw.knn(q, k)
    want_idx, want_dist = oracle.topk(q, k)
    np.testing.assert_array_equal(kn.indices, want_idx)
    np.testing.assert_array_equal(kn.distances, want_dist)
    return rc, rp, kn


def test_mutated_index_matches_reference_and_oracle(dataset_case):
    _, d, eps = dataset_case
    seed_pts, fresh = d[:-30], d[-30:]
    tw = Twin(seed_pts, _kw(eps))
    oracle = ChurnOracle(seed_pts)
    q = _queries(d, seed=81, n_extra=16, n_rows=25)
    ins = np.concatenate([fresh, seed_pts[:5]])
    np.testing.assert_array_equal(tw.insert(ins), oracle.insert(ins))
    dead = np.array([0, 3, len(seed_pts) // 2, len(seed_pts) + 2, len(seed_pts) + 31], np.int64)
    assert tw.delete(dead) == oracle.delete(dead) == len(dead)
    rc, _, _ = _assert_matches_oracle(tw, oracle, q, eps)
    assert rc.stats.delta_size > 0 and rc.stats.tombstone_count > 0
    over = tw.range_count(q, eps * 2)  # a TEMPORARY rebuild; the resident stays
    np.testing.assert_array_equal(over.counts, oracle.range_count(q, eps * 2))
    assert over.stats.index_rebuilds == 1 and tw.pi.index_eps == eps
    tw.compact()
    assert tw.pi.delta_size == 0 and tw.pi.tombstone_count == 0
    rc2, _, _ = _assert_matches_oracle(tw, oracle, q, eps)
    assert rc2.stats.epoch == 1
    more = oracle.insert(fresh[:7])
    np.testing.assert_array_equal(tw.insert(fresh[:7]), more)
    tw.delete(more[:2])
    oracle.delete(more[:2])
    tw.range_count(q, eps / 2)
    tw.assert_totals()


def test_compact_swap_is_atomic_with_zero_traces():
    d = make_dataset("exponential", 300, 8, seed=83)
    tw = Twin(d[:280], _kw(0.3))
    oracle = ChurnOracle(d[:280])
    q = _queries(d, seed=84, n_extra=16, n_rows=25)
    _assert_matches_oracle(tw, oracle, q, 0.3, k=1)
    tw.insert(d[280:])
    oracle.insert(d[280:])
    tw.delete(np.arange(0, 40, 3))
    oracle.delete(np.arange(0, 40, 3))
    before = _assert_matches_oracle(tw, oracle, q, 0.3, k=1)
    traces0 = tw.ps.total.num_traces
    pending_ref, pending = tw.ri.prepare_compact(), tw.pi.prepare_compact()
    mid = _assert_matches_oracle(tw, oracle, q, 0.3, k=1)
    assert mid[0].stats.epoch == 0
    tw.ri.apply_compact(pending_ref)
    tw.pi.apply_compact(pending)
    after = _assert_matches_oracle(tw, oracle, q, 0.3, k=1)
    assert after[0].stats.epoch == 1 and after[0].stats.delta_size == 0
    for b, m, a in zip(before, mid, after):
        for name in RESULT_ARRAYS:
            if hasattr(b, name):
                np.testing.assert_array_equal(getattr(b, name), getattr(m, name))
                np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
    assert tw.ps.total.num_traces == traces0  # the swap ran no new shape key
    tw.assert_totals()


def test_stale_compact_and_bad_deletes_refused_like_reference():
    d = make_dataset("uniform", 60, 6, seed=85)
    tw = Twin(d, _kw(0.2))
    pending = tw.pi.prepare_compact()
    tw.insert(d[:3])
    with pytest.raises(RuntimeError, match="mutated since prepare_compact"):
        tw.pi.apply_compact(pending)
    tw.compact()
    assert tw.pi.epoch == 1
    for bad in ([1000], [4, 4]):
        if bad == [4, 4]:
            tw.delete([4])
        with pytest.raises(KeyError) as got:
            tw.pi.delete(bad)
        with pytest.raises(KeyError) as want:
            tw.ri.delete(bad)
        assert str(got.value) == str(want.value)
    ids = tw.insert(d[:2])
    tw.delete(ids[:1])
    with pytest.raises(KeyError):
        tw.pi.delete(ids[:1])  # delta ids die too
    tw.assert_totals()


@pytest.mark.parametrize("case", ["delete_everything", "reinsert_same_coords", "eps_zero"])
def test_tombstone_edges_match_reference(case):
    if case == "delete_everything":
        d = make_dataset("uniform", 50, 6, seed=86)
        eps, q = 0.2, _queries(d, seed=87, n_extra=16, n_rows=25)
    elif case == "reinsert_same_coords":
        d = make_dataset("duplicated", 60, 6, seed=88)
        eps, q = 0.1, d[:12]
    else:
        d = make_dataset("duplicated", 45, 6, seed=89)
        eps, q = 0.0, d[:10]
    tw = Twin(d, _kw(eps))
    oracle = ChurnOracle(d)
    if case == "delete_everything":
        tw.delete(np.arange(50))
        oracle.delete(np.arange(50))
        assert (tw.range_count(q, eps).counts == 0).all()
        kn = tw.knn(q, 3)
        assert (kn.indices == -1).all()
        np.testing.assert_array_equal(tw.insert(d[:20]), oracle.insert(d[:20]))
    elif case == "reinsert_same_coords":
        tw.delete([7])
        oracle.delete([7])
        np.testing.assert_array_equal(tw.insert(d[7:8]), oracle.insert(d[7:8]))
    else:
        tw.delete([0])
        oracle.delete([0])
        _assert_matches_oracle(tw, oracle, q, eps)
        tw.insert(d[:1])
        oracle.insert(d[:1])
    _assert_matches_oracle(tw, oracle, q, eps)
    tw.compact()
    _assert_matches_oracle(tw, oracle, q, eps)
    tw.assert_totals()


def test_auto_compact_spill_policy_matches_reference():
    d = make_dataset("clustered", 160, 6, seed=37)
    pool = make_dataset("uniform", 120, 6, seed=38)
    tw = Twin(d, _kw(0.25), auto_compact_fraction=0.25)
    oracle = ChurnOracle(d)
    q = _queries(d, seed=39, n_extra=16, n_rows=25)
    for lo in range(0, len(pool), 30):
        batch = pool[lo: lo + 30]
        np.testing.assert_array_equal(tw.insert(batch), oracle.insert(batch))
        assert tw.pi.auto_compactions == tw.ri.auto_compactions
        rc = tw.range_count(q, 0.25)
        np.testing.assert_array_equal(rc.counts, oracle.range_count(q, 0.25))
    assert tw.pi.auto_compactions >= 1
    with pytest.raises(ValueError, match="auto_compact_fraction"):
        SimilarityIndex(d, SelfJoinConfig(**_kw(0.25)), auto_compact_fraction=0.0, device="cpu")
    tw.assert_totals()


def test_interleaved_stream_matches_reference():
    """A seeded insert / delete / compact / query stream: both packages and
    the churn oracle agree at every step."""
    pool = make_dataset("uniform", 200, 4, seed=93)
    rng = np.random.default_rng(94)
    tw = Twin(pool[:40], _kw(0.3))
    oracle = ChurnOracle(pool[:40])
    q = pool[40:52]
    ops = ["insert", "delete", "compact", "count", "pairs", "knn"]
    for _ in range(30):
        op = ops[int(rng.integers(0, len(ops)))]
        if op == "insert":
            lo, m = int(rng.integers(0, 191)), int(rng.integers(1, 11))
            np.testing.assert_array_equal(tw.insert(pool[lo: lo + m]), oracle.insert(pool[lo: lo + m]))
        elif op == "delete" and oracle.live_count:
            pick = rng.choice(oracle.live_count, size=int(rng.integers(1, min(8, oracle.live_count) + 1)),
                              replace=False)
            ids = oracle.live_ids[pick]
            assert tw.delete(ids) == oracle.delete(ids)
        elif op == "compact":
            tw.compact()
        elif op == "count":
            np.testing.assert_array_equal(tw.range_count(q, 0.3).counts, oracle.range_count(q, 0.3))
        elif op == "pairs":
            assert pair_set(tw.range_pairs(q, 0.3).pairs) == pair_set(oracle.range_pairs(q, 0.3))
        elif op == "knn":
            kn = tw.knn(q, 3)
            np.testing.assert_array_equal(kn.indices, oracle.topk(q, 3)[0])
        assert tw.pi.num_points == oracle.live_count
    _assert_matches_oracle(tw, oracle, q, 0.3)
    tw.assert_totals()


# -- persistence across packages ----------------------------------------------


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("mode", ["indexed", "dense", "auto"])
def test_npz_serves_the_same_in_either_package(tmp_path, mode, writer):
    """The writer's index, with churn, saved; the file loaded in both
    packages serves the writer's answers, with the same tier decisions."""
    d = make_dataset("exponential", 211, 16, seed=62)
    if writer == "reference":
        saver = ref_join.SimilarityIndex(d, ref_core.SelfJoinConfig(**_kw(0.06, execution=mode)))
        svc = ref_join.QueryService(saver)
    else:
        saver = SimilarityIndex(d, SelfJoinConfig(**_kw(0.06, execution=mode)), device="cpu")
        svc = QueryService(saver)
    q = _queries(d, seed=63)
    saver.insert(d[:5])
    saver.delete([3, 212])
    want = (svc.range_count(q, 0.06), svc.range_pairs(q, 0.06), svc.knn(q, 3))
    path = saver.save(tmp_path / f"{mode}_{writer}")
    loaded = Twin(None, None, ref_index=ref_join.SimilarityIndex.load(path),
                  port_index=SimilarityIndex.load(path, device="cpu"))
    assert loaded.pi.config == SelfJoinConfig(**dataclasses.asdict(loaded.ri.config))
    assert loaded.pi.config.execution == mode
    got = (loaded.range_count(q, 0.06), loaded.range_pairs(q, 0.06), loaded.knn(q, 3))
    for w, g in zip(want, got):
        for name in RESULT_ARRAYS:
            if hasattr(w, name):
                np.testing.assert_array_equal(getattr(g, name), getattr(w, name))
        assert g.stats.execution == w.stats.execution
        assert g.stats.cost_indexed == w.stats.cost_indexed
    # the reloaded index keeps allocating ids where the saver left off
    np.testing.assert_array_equal(loaded.insert(d[:1]), saver.insert(d[:1]))
    loaded.compact()
    loaded.assert_totals()


def test_aux_pass_in_blocks_equals_reference_step(monkeypatch):
    """The churn aux pass over a table many blocks long (a ragged last
    block, pow2 padding past ``real``) equals the reference's jitted
    ``_aux_step`` bit for bit on unquantized coordinates, and the pass in
    one block."""
    import jax.numpy as jnp

    from repro_torch.join import service

    rng = np.random.default_rng(90)
    q = rng.random((64, 5), dtype=np.float32)
    pts = rng.random((4096, 5), dtype=np.float32)
    real, eps = 3001, 0.8
    d = make_dataset("uniform", 50, 5, seed=91)
    ref = ref_join.QueryService(ref_join.SimilarityIndex(d, ref_core.SelfJoinConfig(eps=eps)))
    want = np.asarray(ref._aux_step(jnp.asarray(q), jnp.asarray(pts), jnp.int32(real), jnp.float32(eps)))
    assert want.any() and not want[:, :real].all()
    whole = service.aux_membership(torch.from_numpy(q), torch.from_numpy(pts), real, eps)
    monkeypatch.setattr(service, "_AUX_BLOCK", 64 * 100)
    blocked = service.aux_membership(torch.from_numpy(q), torch.from_numpy(pts), real, eps)
    np.testing.assert_array_equal(blocked.numpy(), want)
    np.testing.assert_array_equal(whole.numpy(), want)
