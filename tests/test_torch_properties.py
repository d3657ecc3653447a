"""Property-based tests (hypothesis) for the self-join invariants, on the port.

The 13 properties of ``tests/test_properties.py``, with its strategies, its
1/64 quantization (raw fp32 only for the matmul identity, as there) and
its ``max_examples``, run on ``repro_torch`` with ``device="cpu"`` and
held against the same oracles.  On the same draw, the join (indexed and
dense tier), the grid, the adjacency and the tile plan are also held
``==`` to ``repro``'s, and so are the host-side REORDER results and the
capacity suggestion.  Skipped when hypothesis is absent, as the
reference's file is.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.core as ref_core  # noqa: E402
from oracles import brute_counts, brute_pairs, brute_topk  # noqa: E402
from repro.core import batching as ref_batching  # noqa: E402
from repro.core import grid as ref_grid  # noqa: E402
from repro.core import reorder as ref_reorder  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import SelfJoinConfig, SelfJoinEngine, self_join  # noqa: E402
from repro_torch.core import batching  # noqa: E402
from repro_torch.core.grid import adjacent_cell_pairs, build_grid, build_tile_plan  # noqa: E402
from repro_torch.core.reorder import apply_reorder, inverse_perm, variance_reorder  # noqa: E402
from repro_torch.join import QueryService, SimilarityIndex  # noqa: E402
from repro_torch.kernels.ref import direct_sqdist, matmul_sqdist  # noqa: E402

CPU = "cpu"


def _data(draw, max_n=200, max_d=12):
    n = draw(st.integers(8, max_n))
    d = draw(st.integers(2, max_d))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    kind = draw(st.sampled_from(["uniform", "exp", "clustered"]))
    if kind == "uniform":
        pts = rng.random((n, d))
    elif kind == "exp":
        pts = np.clip(rng.exponential(1 / 40.0, (n, d)), 0, 1)
    else:
        c = rng.random((4, d))
        pts = np.clip(c[rng.integers(0, 4, n)] + rng.normal(0, 0.05, (n, d)), 0, 1)
    # quantize so fp32 distance sums are exact in every formulation
    return (np.round(pts * 64) / 64).astype(np.float32)


@st.composite
def dataset(draw):
    return _data(draw)


def assert_same_dataclass(got, want):
    """Every field of two dataclasses of the same name, arrays with ``==``."""
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g == w, f.name


def assert_same_join(got, want):
    np.testing.assert_array_equal(got.counts, want.counts)
    for name in ("execution", "num_tiles", "num_tile_pairs_evaluated", "num_candidates", "num_results",
                 "dim_blocks_skipped"):
        assert getattr(got.stats, name) == getattr(want.stats, name), name


@settings(max_examples=25, deadline=None)
@given(dataset(), st.sampled_from([0.05, 0.11, 0.23, 0.41]), st.integers(1, 6))
def test_join_equals_brute(d, eps, k):
    kw = dict(eps=eps, k=k, tile_size=8, dim_block=8)
    res = self_join(d, SelfJoinConfig(**kw), device=CPU)
    np.testing.assert_array_equal(res.counts, brute_counts(d, eps))
    assert_same_join(res, ref_core.self_join(d, ref_core.SelfJoinConfig(**kw)))


@settings(max_examples=15, deadline=None)
@given(dataset(), st.integers(0, 2**31 - 1))
def test_reorder_preserves_pairwise_distances(d, seed):
    r, perm = variance_reorder(d, 0.05, seed % 1000)
    assert sorted(perm.tolist()) == list(range(d.shape[1]))
    i, j = 0, min(5, d.shape[0] - 1)
    dd = np.linalg.norm(d[i] - d[j])
    rr = np.linalg.norm(r[i] - r[j])
    assert abs(dd - rr) < 1e-5
    want_r, want_perm = ref_reorder.variance_reorder(d, 0.05, seed % 1000)
    np.testing.assert_array_equal(perm, want_perm)
    np.testing.assert_array_equal(r, want_r)


@settings(max_examples=15, deadline=None)
@given(dataset(), st.integers(0, 2**31 - 1))
def test_apply_reorder_roundtrips_external_points(d, seed):
    """External points permute identically to the dataset, and invert back."""
    r, perm = variance_reorder(d, 0.05, seed % 1000)
    np.testing.assert_array_equal(r, apply_reorder(d, perm))
    external = d[:: max(1, d.shape[0] // 7)] + np.float32(1 / 64)
    round_trip = apply_reorder(apply_reorder(external, perm), inverse_perm(perm))
    np.testing.assert_array_equal(round_trip, external)
    inv = inverse_perm(perm)
    np.testing.assert_array_equal(perm[inv], np.arange(d.shape[1]))
    np.testing.assert_array_equal(inv[perm], np.arange(d.shape[1]))
    np.testing.assert_array_equal(inv, ref_reorder.inverse_perm(perm))
    np.testing.assert_array_equal(apply_reorder(external, perm), ref_reorder.apply_reorder(external, perm))


@settings(max_examples=10, deadline=None)
@given(dataset(), st.integers(1, 9))
def test_knn_equals_bruteforce_topk(d, k):
    """Service kNN == float64 brute-force top-k, ties by data id, any data."""
    svc = QueryService(
        SimilarityIndex(d, SelfJoinConfig(eps=0.2, k=3, tile_size=8, dim_block=8), device=CPU)
    )
    q = d[: min(16, d.shape[0])]
    res = svc.knn(q, k)
    want_idx, want_dist = brute_topk(q, d, k)
    np.testing.assert_array_equal(res.indices, want_idx)
    np.testing.assert_array_equal(res.distances, want_dist)


@settings(max_examples=15, deadline=None)
@given(dataset())
def test_counts_monotone_in_eps(d):
    c1 = self_join(d, SelfJoinConfig(eps=0.1, k=3, tile_size=8), device=CPU).counts
    c2 = self_join(d, SelfJoinConfig(eps=0.2, k=3, tile_size=8), device=CPU).counts
    assert (c2 >= c1).all()


@settings(max_examples=15, deadline=None)
@given(dataset(), st.sampled_from([0.1, 0.25]))
def test_grid_invariants(d, eps):
    grid = build_grid(d, eps, k=3)
    # every point appears exactly once in the sorted layout
    assert sorted(grid.point_order.tolist()) == list(range(d.shape[0]))
    assert int(grid.cell_count.sum()) == d.shape[0]
    # adjacency is symmetric and includes self-pairs
    ca, cb = adjacent_cell_pairs(grid)
    pairs = set(zip(ca.tolist(), cb.tolist()))
    assert all((b, a) in pairs for a, b in pairs)
    assert all((c, c) in pairs for c in range(grid.num_cells))
    # tile plan covers each cell's points exactly once
    plan = build_tile_plan(grid, 8, sortidu=False)
    covered = np.zeros(d.shape[0], bool)
    for s, l in zip(plan.tile_start, plan.tile_len):
        assert not covered[s : s + l].any()
        covered[s : s + l] = True
    assert covered.all()
    # and all of it == the reference on the same draw
    ref = ref_grid.build_grid(d, eps, k=3)
    assert_same_dataclass(grid, ref)
    rca, rcb = ref_grid.adjacent_cell_pairs(ref)
    np.testing.assert_array_equal(ca, rca)
    np.testing.assert_array_equal(cb, rcb)
    assert_same_dataclass(plan, ref_grid.build_tile_plan(ref, 8, sortidu=False))


@settings(max_examples=10, deadline=None)
@given(dataset())
def test_self_pairs_always_included(d):
    res = self_join(d, SelfJoinConfig(eps=0.01, k=3, tile_size=8), device=CPU)
    assert (res.counts >= 1).all()  # every point finds at least itself


@settings(max_examples=20, deadline=None)
@given(dataset(), st.sampled_from([0.1, 0.25]))
def test_grid_cell_assignment_roundtrips_point_order(d, eps):
    """pts_sorted IS D[point_order], and each point lies in its owning cell."""
    grid = build_grid(d, eps, k=3)
    np.testing.assert_array_equal(grid.pts_sorted, d[grid.point_order])
    coords = (
        np.floor(
            grid.pts_sorted[:, : grid.k].astype(np.float64) / grid.bin_width
        ).astype(np.int64)
        - grid.origin[None, :]
    )
    cell_of_sorted = np.repeat(
        np.arange(grid.num_cells, dtype=np.int64), grid.cell_count
    )
    np.testing.assert_array_equal(coords, grid.cell_coords[cell_of_sorted])
    starts = np.concatenate([[0], np.cumsum(grid.cell_count)[:-1]])
    np.testing.assert_array_equal(grid.cell_start, starts)
    assert_same_dataclass(grid, ref_grid.build_grid(d, eps, k=3))


@settings(max_examples=20, deadline=None)
@given(dataset(), st.sampled_from([0.05, 0.11, 0.23]))
def test_sortidu_plan_covers_all_true_pairs(d, eps):
    """The SORTIDU-pruned tile-pair plan is a superset of all true <=eps pairs."""
    grid = build_grid(d, eps, k=3)
    plan = build_tile_plan(grid, 8, sortidu=True)
    tile_of_pos = np.empty(d.shape[0], np.int64)
    for ti, (s, l) in enumerate(zip(plan.tile_start, plan.tile_len)):
        tile_of_pos[s : s + l] = ti
    pos_of_point = np.empty(d.shape[0], np.int64)
    pos_of_point[grid.point_order] = np.arange(d.shape[0])
    plan_pairs = set(zip(plan.pair_a.tolist(), plan.pair_b.tolist()))
    for a, b in brute_pairs(d, eps):
        ta = int(tile_of_pos[pos_of_point[a]])
        tb = int(tile_of_pos[pos_of_point[b]])
        assert (ta, tb) in plan_pairs, f"true pair {(a, b)} pruned"
    assert_same_dataclass(plan, ref_grid.build_tile_plan(ref_grid.build_grid(d, eps, k=3), 8, sortidu=True))


@settings(max_examples=10, deadline=None)
@given(dataset(), st.sampled_from([0.1, 0.25]))
def test_capacity_estimate_never_underallocates(d, eps):
    """A full-sample size estimate (and its capacity) covers the true |R|."""
    cfg = SelfJoinConfig(eps=eps, k=3, tile_size=8, dim_block=8)
    eng = SelfJoinEngine(d, cfg, device=CPU)
    est = batching.estimate_result_size(
        eng._tiles, eng._tile_len, eng.plan,
        eps=eps, dim_block=8, backend="jnp", sample_frac=1.0,
    )
    true_r = int(brute_counts(d, eps).sum())
    assert est >= true_r
    assert batching.suggest_pairs_capacity(est, 1.0) >= true_r
    res = eng.pairs()  # auto-sized buffer must end up fitting exactly |R|
    assert res.stats.pairs_capacity >= res.stats.num_results == true_r


@settings(max_examples=50, deadline=None)
@given(st.integers(0, 10**9), st.floats(0.0, 4.0))
def test_suggest_capacity_never_below_estimate(est, headroom):
    got = batching.suggest_pairs_capacity(est, headroom)
    assert got >= est
    assert got == ref_batching.suggest_pairs_capacity(est, headroom)


@st.composite
def raw_point_sets(draw):
    """Un-quantized fp32 point sets for the matmul-identity property, with
    the two adversarial shapes drawn explicitly: duplicated points and
    constant dimensions (``tests/test_properties.py``)."""
    n = draw(st.integers(2, 48))
    dims = draw(st.integers(1, 24))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    scale = draw(st.sampled_from([1.0, 17.0]))
    pts = (rng.random((n, dims)) * scale).astype(np.float32)
    variant = draw(st.sampled_from(["plain", "duplicated", "constant_dims"]))
    if variant == "duplicated":
        src = rng.integers(0, n, n // 2 + 1)
        dst = rng.integers(0, n, n // 2 + 1)
        pts[dst] = pts[src]
    elif variant == "constant_dims":
        const_cols = rng.integers(0, dims, dims // 2 + 1)
        pts[:, const_cols] = pts[0, const_cols]
    m = draw(st.integers(1, n))
    return pts[:m], pts[rng.permutation(n)]


@settings(max_examples=60, deadline=None)
@given(raw_point_sets())
def test_matmul_identity_clamped_and_close_to_direct(ab):
    """The dense kernel's clamped matmul identity: never negative, exactly
    zero on duplicated rows' own pairing, and within fp32 tolerance of the
    direct ``sum((a-b)^2)`` form on arbitrary data."""
    a, b = ab
    got = matmul_sqdist(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = direct_sqdist(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (a.shape[0], b.shape[0])
    assert (got >= 0.0).all()
    floor = 1e-5 * float(
        np.maximum(np.square(a).sum(1).max(), np.square(b).sum(1).max()) + 1.0
    )
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=floor)
    eq = (a[:, None, :] == b[None, :, :]).all(-1)
    assert (got[eq] <= floor).all()


@settings(max_examples=20, deadline=None)
@given(dataset(), st.sampled_from([0.07, 0.19]))
def test_dense_tier_join_equals_brute(d, eps):
    """Forced-dense execution is oracle-exact on quantized data, any kind."""
    kw = dict(eps=eps, k=3, tile_size=8, dim_block=8, execution="dense")
    res = self_join(d, SelfJoinConfig(**kw), device=CPU)
    assert res.stats.execution == "dense"
    np.testing.assert_array_equal(res.counts, brute_counts(d, eps))
    assert_same_join(res, ref_core.self_join(d, ref_core.SelfJoinConfig(**kw)))
