"""PyTorch port vs the JAX package: the host layer (REORDER, grid, tile plan,
tiling, cost model, result-size estimate), on the shared dataset matrix.

Both packages get the same numpy inputs; every array must be equal, dtype
included, and every scalar equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import batching as ref_batching
from repro.core import cost as ref_cost
from repro.core import grid as ref_grid
from repro.core import reorder as ref_reorder
from repro.core.snapshot import make_dense_plan as ref_make_dense_plan
from repro.kernels import ops as ref_ops
from repro_torch.core import batching, cost, grid, reorder
from repro_torch.core.snapshot import make_dense_plan
from repro_torch.kernels import ops, tile_plan
from tile_plan_cases import CPU_CASES, make


def assert_same_dataclass(want, got):
    assert type(want).__name__ == type(got).__name__
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if isinstance(w, np.ndarray):
            assert w.dtype == g.dtype, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert w == g, f.name


@pytest.mark.parametrize("sortidu", [True, False])
@pytest.mark.parametrize("k,tile_size", [(3, 8), (6, 16)])
def test_grid_and_plan_arrays_equal(dataset_case, sortidu, k, tile_size):
    _, d, eps = dataset_case
    work_r, perm_r = ref_reorder.variance_reorder(d, 0.01)
    work_p, perm_p = reorder.variance_reorder(d, 0.01)
    np.testing.assert_array_equal(perm_p, perm_r)
    np.testing.assert_array_equal(work_p, work_r)
    g_r = ref_grid.build_grid(work_r, eps, k)
    g_p = grid.build_grid(work_p, eps, k)
    assert_same_dataclass(g_r, g_p)
    p_r = ref_grid.build_tile_plan(g_r, tile_size, sortidu)
    p_p = grid.build_tile_plan(g_p, tile_size, sortidu)
    assert_same_dataclass(p_r, p_p)
    for db in (8, 32):
        t_r, l_r = ref_ops.make_tiles(g_r.pts_sorted, p_r.tile_start, p_r.tile_len, tile_size, db)
        t_p, l_p = ops.make_tiles(g_p.pts_sorted, p_p.tile_start, p_p.tile_len, tile_size, db)
        np.testing.assert_array_equal(t_p, t_r)
        np.testing.assert_array_equal(l_p, l_r)


@pytest.mark.parametrize("sortidu", [True, False])
@pytest.mark.parametrize("case", CPU_CASES)
def test_tile_plan_edge_cases_equal(case, sortidu):
    """The plan's CPU path (``tile_plan.tile_pairs_plain``, no sort) against
    the reference's expansion and lexsort: every field, order included."""
    d, eps, k, t = make(case)
    launches = dict(tile_plan.LAUNCHES)
    want = ref_grid.build_tile_plan(ref_grid.build_grid(d, eps, k), t, sortidu)
    assert_same_dataclass(want, grid.build_tile_plan(grid.build_grid(d, eps, k), t, sortidu, device="cpu"))
    assert tile_plan.LAUNCHES == launches


def test_make_tiles_device_matches_reference(dataset_case):
    _, d, eps = dataset_case
    g = ref_grid.build_grid(d, eps, 4)
    plan = ref_grid.build_tile_plan(g, 16, True)
    start = ref_grid.pad_axis0(plan.tile_start, plan.num_tiles + 5)  # padding rows
    length = ref_grid.pad_axis0(plan.tile_len, plan.num_tiles + 5)
    want = np.asarray(ref_ops.make_tiles_device(
        np.asarray(g.pts_sorted), np.asarray(start), np.asarray(length), tile_size=16, dim_block=8,
    ))
    got = ops.make_tiles_device(
        torch.from_numpy(g.pts_sorted), torch.from_numpy(start), torch.from_numpy(length),
        tile_size=16, dim_block=8,
    )
    np.testing.assert_array_equal(got.numpy(), want)
    empty = ops.make_tiles_device(
        torch.from_numpy(g.pts_sorted), torch.zeros(0, dtype=torch.int32),
        torch.zeros(0, dtype=torch.int32), tile_size=16, dim_block=8,
    )
    assert tuple(empty.shape) == (1, 16, -(-d.shape[1] // 8) * 8)


def test_dense_plan_and_buckets_equal():
    for n in (0, 1, 37, 64, 65, 200):
        assert_same_dataclass(ref_make_dense_plan(n, 8), make_dense_plan(n, 8))
    for n, floor in ((0, 1), (1, 1), (5, 1), (5, 16), (1024, 1), (1025, 8)):
        assert grid.bucket_rows(n, floor) == ref_grid.bucket_rows(n, floor)
    a = np.arange(6, dtype=np.int32)
    np.testing.assert_array_equal(grid.pad_axis0(a, 9, fill=-1), ref_grid.pad_axis0(a, 9, fill=-1))


def test_cost_model_equal(dataset_case):
    _, d, eps = dataset_case
    g = ref_grid.build_grid(d, eps, 6)
    plan = ref_grid.build_tile_plan(g, 16, True)
    n_pad = -(-d.shape[1] // 8) * 8
    ci = cost.indexed_join_cost(plan.num_pairs, plan.num_candidates, 16, n_pad)
    cd = cost.dense_join_cost(d.shape[0], d.shape[0], 16, n_pad)
    assert ci == ref_cost.indexed_join_cost(plan.num_pairs, plan.num_candidates, 16, n_pad)
    assert cd == ref_cost.dense_join_cost(d.shape[0], d.shape[0], 16, n_pad)
    for mode in ("auto", "indexed", "dense"):
        assert dataclasses.astuple(cost.decide(ci, cd, mode)) == dataclasses.astuple(
            ref_cost.decide(ci, cd, mode)
        )
    with pytest.raises(ValueError):
        cost.decide(1.0, 2.0, "gpu")


def test_result_size_estimate_and_capacity_equal(dataset_case):
    _, d, eps = dataset_case
    g = ref_grid.build_grid(d, eps, 4)
    plan = ref_grid.build_tile_plan(g, 16, True)
    tiles, lens = ref_ops.make_tiles(g.pts_sorted, plan.tile_start, plan.tile_len, 16, 8)
    for frac in (0.01, 0.3):
        want = ref_batching.estimate_result_size(
            tiles, lens, plan, eps=eps, dim_block=8, backend="jnp", sample_frac=frac
        )
        got = batching.estimate_result_size(
            tiles, lens, plan, eps=eps, dim_block=8, backend="jnp", sample_frac=frac
        )
        assert got == want
        for headroom in (1.0, 2.0):
            assert batching.suggest_pairs_capacity(got, headroom) == (
                ref_batching.suggest_pairs_capacity(want, headroom)
            )


def test_brute_oracles_equal(dataset_case):
    from repro.core import brute as ref_brute
    from repro_torch.core import brute

    _, d, eps = dataset_case
    np.testing.assert_array_equal(brute.brute_counts(d, eps), ref_brute.brute_counts(d, eps))
    np.testing.assert_array_equal(brute.brute_counts_f32(d, eps), ref_brute.brute_counts_f32(d, eps))
    np.testing.assert_array_equal(brute.brute_pairs(d[:120], eps), ref_brute.brute_pairs(d[:120], eps))
    pts = torch.from_numpy(np.asarray(d, np.float64))
    within = (brute.sqdist_f64(pts, pts) <= np.float64(eps) ** 2).sum(1).numpy()
    np.testing.assert_array_equal(within, ref_brute.brute_counts(d, eps))
