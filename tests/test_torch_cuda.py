"""The port's CUDA kernels (K1-K5) against their plain versions, on the card.

Every test here needs an NVIDIA card and skips without one.  On a machine
with a card (no JAX needed, so the shared conftest is skipped):

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Tile inputs are 1/64-quantized, so counts, skipped blocks and masks compare
with ``==``; K1's two epilogues (per pair, and the fused count step) are
also held against K1's earlier ``tile_eval.cuh`` kernel over
``chip_smoke.K1_CASES``, K2's (per pair with the mask, and the fused pairs
step) against their plain versions and K2's earlier kernel over
``chip_smoke.K2_CASES``, and K3 / K4's three epilogues (per pair, the
dense count step, the dense pairs step) against their plain versions and
K3 / K4's earlier kernel over ``chip_smoke.DENSE_CASES``; the end-to-end
tests hold the engine on the card against the same engine on the CPU (the
pair arrays row for row), and check that its steps launch the fused
kernels once per count chunk (twice per pairs chunk) and nothing else but
the result-size estimate's per-pair kernel; the serving tests hold
``QueryService`` over a card index against the same service over a CPU
index on one request stream with churn (answers and ``ServiceStats``,
``num_traces`` included), and check that its chunk loops launch only the
fused steps; the churn aux pass at a 262,144-row table stays within a few
blocks of card memory; the distributed engine on the card equals the same
engine on the CPU (counts, pair arrays row for row, kNN, stats) and its
blocks launch only the fused steps, and ``ring_self_join_counts`` on a
one-rank NCCL group equals the brute force; the host-loop join and dedup
on the card equal the same calls on the CPU, launching K1 / K2 per pair per
``ops`` chunk (dedup: the fused pairs step), and the profiler bridge puts
one range around each count chunk's fused kernel; reduced gemma3,
recurrentgemma, xlstm, deepseek-v2 and arctic on the card equal the same
parameters on the CPU (``chip_smoke.MODEL_TOL``), decode steps and states
included, and launch no kernel.  Flash attention compares within 2e-5 in f32 and
2e-2 in bf16 (one bf16 rounding of the output), the JAX tests' tolerances,
and at S >= 1024 within ``chip_smoke.ATTN_FULL_TOL`` (one bf16 step); each
call must count one launch of the kernel its route names (bf16 with head
widths that are multiples of 8: the tensor-core kernel; the rest: the
CUDA-core kernel).
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import EngineConfig, SelfJoinConfig, SelfJoinEngine, engine
from repro_torch.join import QueryService, SimilarityIndex
from repro_torch.kernels import dense_tile, distance_tile, flash_attention

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (  # noqa: E402
    ATTN_FULL_TOL, DENSE_CASES, K1_CASES, K2_CASES, dense_sweep_case, k1_sweep_case, k2_sweep_case, phase_bridge,
)

pytestmark = pytest.mark.cuda

SHAPES = [(8, 8, 8), (16, 24, 8), (32, 64, 32), (64, 32, 32), (100, 40, 40), (128, 96, 48), (5, 3, 8)]
KERNELS = [
    (distance_tile.tile_pair_distance, distance_tile.tile_pair_distance_plain, distance_tile.LAUNCHES,
     "tile_pair_distance"),
    (dense_tile.dense_tile_distance, dense_tile.dense_tile_distance_plain, dense_tile.LAUNCHES,
     "dense_tile_distance"),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tiles(t, n, db, seed, far, device):
    rng = np.random.default_rng(seed)
    n_pad = -(-n // db) * db
    pts = np.zeros((7, t, n_pad), np.float32)
    pts[:, :, :n] = np.round(rng.random((7, t, n)) * 64) / 64
    lens = rng.integers(0, t + 1, size=7).astype(np.int32)
    lens[:2] = t
    if far:  # tile 1 far from tile 0: SHORTC stops after the first block
        pts[0, :, :n] = 0.0
        pts[1, :, :n] = 0.90625
    for i in range(7):
        pts[i, lens[i]:] = 0.0
    pairs = rng.integers(0, 7, size=(50, 2)).astype(np.int32)
    pairs[:3] = [[0, 1], [1, 0], [0, 0]]
    return [torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for x in (pts, lens, pairs[:, 0], pairs[:, 1])]


@pytest.mark.parametrize("far", [False, True])
@pytest.mark.parametrize("return_mask", [False, True])
@pytest.mark.parametrize("t,n,db", SHAPES)
def test_kernels_equal_plain_versions(cuda, t, n, db, return_mask, far):
    args = _tiles(t, n, db, seed=t * 7 + n, far=far, device=cuda)
    eps = 0.05 if far else 0.3
    for wrapper, plain, launches, key in KERNELS:
        key = key + ("_mask" if return_mask else "")
        before = launches[key]
        got = wrapper(*args, eps=eps, dim_block=db, return_mask=return_mask)
        torch.cuda.synchronize()
        assert launches[key] == before + 1
        want = plain(*args, eps=eps, dim_block=db, return_mask=return_mask)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.device.type == "cuda" and g.dtype == w.dtype
            assert torch.equal(g, w)
    if far and n_blocks_of(n, db) > 1:
        skipped = distance_tile.tile_pair_distance(*args, eps=eps, dim_block=db)[1]
        assert int(skipped[0]) == n_blocks_of(n, db) - 1


def n_blocks_of(n, db):
    return -(-n // db)


def test_tile_size_above_the_limit_raises(cuda):
    args = _tiles(8, 8, 8, seed=0, far=False, device=cuda)
    big = torch.zeros((2, 129, 8), dtype=torch.float32, device=cuda)
    lens = torch.full((2,), 129, dtype=torch.int32, device=cuda)
    for wrapper, _, _, _ in KERNELS:
        with pytest.raises(ValueError, match="1..128"):
            wrapper(big, lens, args[2][:2] % 2, args[3][:2] % 2, eps=0.1, dim_block=8)
        with pytest.raises(ValueError, match="int32"):
            wrapper(args[0], args[1].long(), args[2], args[3], eps=0.1, dim_block=8)


@pytest.mark.parametrize("mode", ["indexed", "dense", "auto"])
def test_engine_on_the_card_equals_the_cpu(cuda, mode):
    rng = np.random.default_rng(5)
    d = (np.round(rng.exponential(1 / 40, size=(3000, 16)).clip(0, 1) * 64) / 64).astype(np.float32)
    cfg = SelfJoinConfig(eps=0.06, execution=mode)
    eng = EngineConfig(count_chunk=256, pairs_chunk=64)
    card = SelfJoinEngine(d, cfg, eng, device=cuda)
    host = SelfJoinEngine(d, cfg, eng, device="cpu")
    for got, want in ((card.count(), host.count()), (card.pairs(), host.pairs())):
        np.testing.assert_array_equal(got.counts, want.counts)
        assert got.stats == want.stats
    got_p = card.pairs().pairs
    want_p = host.pairs().pairs
    assert set(map(tuple, got_p.tolist())) == set(map(tuple, want_p.tolist()))
    np.testing.assert_array_equal(got_p, want_p)  # both tiers' fused steps write the reference's order


@pytest.mark.parametrize("eps", [0.3, 0.05])
@pytest.mark.parametrize("case", range(len(K1_CASES)))
def test_k1_epilogues_equal_plain_and_earlier_kernel(cuda, case, eps):
    t, n, db, order, c, real, shortc = K1_CASES[case]
    before = dict(distance_tile.LAUNCHES)
    k1_sweep_case(torch, np, distance_tile, t, n, db, order, c, real, shortc, eps, seed=3000 + case)
    grew = {k: distance_tile.LAUNCHES[k] - before[k] for k in before}
    # each epilogue on three grids (chip_smoke.k1_grids), the earlier kernel once
    assert grew == {"tile_pair_distance": 3, "tile_pair_count_scatter": 3, "tile_pair_distance_mask": 0,
                    "tile_pair_pairs_compact": 0, "tile_pair_distance_tile_eval": 1}


@pytest.mark.parametrize("eps", [0.3, 0.05])
@pytest.mark.parametrize("case", range(len(K2_CASES)))
def test_k2_epilogues_equal_plain_and_earlier_kernel(cuda, case, eps):
    t, n, db, order, c, real, _ = K2_CASES[case]
    before = dict(distance_tile.LAUNCHES)
    k2_sweep_case(torch, np, distance_tile, t, n, db, order, c, real, eps, seed=7000 + case)
    grew = {k: distance_tile.LAUNCHES[k] - before[k] for k in before}
    # K2 per pair on three grids (chip_smoke.k1_grids), the pairs step from
    # five states and in two launches on each, the earlier kernel once
    assert grew == {"tile_pair_distance": 0, "tile_pair_count_scatter": 0, "tile_pair_distance_mask": 3,
                    "tile_pair_pairs_compact": 30, "tile_pair_distance_tile_eval": 1}


@pytest.mark.parametrize("n,dim_block,eps", [(16, 32, 0.15), (20, 8, 0.2), (384, 32, 0.9)])
def test_engine_indexed_pairs_launch_only_the_fused_kernel(cuda, n, dim_block, eps):
    """The indexed tier's pairs on the card: 16 dims in one block (the T=64
    fast path), 20 over three blocks of 8 where SHORTC skips blocks, and 384
    at T = 64 (staged in slices).  Small chunks fire the hit_cap retry;
    ``pairs()`` launches the fused pairs kernel twice per chunk and nothing
    else but the result-size estimate's K1; counts, stats and the pair
    array equal the CPU's row for row."""
    rng = np.random.default_rng(n + 1)
    centers = rng.random((20, n))
    d = centers[rng.integers(0, 20, 3000)] + rng.normal(0, 0.03, (3000, n))
    d = (np.round(d.clip(0, 1) * 64) / 64).astype(np.float32)
    cfg = SelfJoinConfig(eps=eps, dim_block=dim_block, execution="indexed")
    eng = EngineConfig(count_chunk=256, pairs_chunk=16)
    card = SelfJoinEngine(d, cfg, eng, device=cuda)
    host = SelfJoinEngine(d, cfg, eng, device="cpu")
    snap = card.snapshot
    buf = torch.zeros((10, 2), dtype=torch.int32, device=cuda)
    scalars = [torch.zeros((), dtype=torch.int32, device=cuda) for _ in range(2)]
    for backend in ("pallas", "jnp"):
        assert isinstance(engine.pairs_step(buf, *scalars, snap.tiles, snap.tile_len, snap.tile_start,
                                            snap.point_order, eps, hit_cap=4, dim_block=dim_block, backend=backend,
                                            chunk=16), distance_tile.PairsCompact)
    before = _launches()
    got = card.pairs()
    torch.cuda.synchronize()
    grew = {k: v - before[k] for k, v in _launches().items()}
    est = grew["tile_pair_distance"]
    assert est > 0
    assert grew == {k: 2 * got.stats.num_device_dispatches if k == "tile_pair_pairs_compact"
                    else est if k == "tile_pair_distance" else 0 for k in grew}
    want = host.pairs()
    np.testing.assert_array_equal(got.pairs, want.pairs)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.stats == want.stats
    assert got.stats.overflow_retries > 0 and got.stats.num_results > len(d)
    if n == 20:
        assert card.count().stats.dim_blocks_skipped > 0


def _launches():
    return {**distance_tile.LAUNCHES, **dense_tile.LAUNCHES}


@pytest.mark.parametrize("n,dim_block,eps", [(16, 32, 0.15), (20, 8, 0.15), (384, 32, 0.9)])
def test_engine_count_launches_the_fused_kernel_once_per_chunk(cuda, n, dim_block, eps):
    """16 dims in one block (K1's fast path), 20 dims over three blocks of
    8 (n_pad 24) on clustered data where SHORTC skips blocks, and 384 dims
    at T = 64, too wide to stage whole (K1 stages them in slices)."""
    rng = np.random.default_rng(n)
    centers = rng.random((20, n))
    d = centers[rng.integers(0, 20, 3000)] + rng.normal(0, 0.03, (3000, n))
    d = (np.round(d.clip(0, 1) * 64) / 64).astype(np.float32)
    cfg = SelfJoinConfig(eps=eps, dim_block=dim_block, execution="indexed")
    eng = EngineConfig(count_chunk=256)
    card = SelfJoinEngine(d, cfg, eng, device=cuda)
    host = SelfJoinEngine(d, cfg, eng, device="cpu")
    assert isinstance(engine.count_step(
        torch.zeros(1, dtype=torch.int32, device=cuda), torch.zeros((), dtype=torch.int32, device=cuda),
        card.snapshot.tiles, card.snapshot.tile_len, card.snapshot.tile_start, eps,
        dim_block=dim_block, shortc=True, backend="pallas"), distance_tile.CountScatter)
    assert distance_tile.k1_staging(card.snapshot.tiles.shape[1], n) == (distance_tile.K1_SLAB if n > 300 else 0)
    before = _launches()
    got = card.count()
    torch.cuda.synchronize()
    grew = {k: v - before[k] for k, v in _launches().items()}
    assert grew == {k: got.stats.num_chunks if k == "tile_pair_count_scatter" else 0 for k in grew}
    want = host.count()
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.stats == want.stats
    assert got.stats.num_chunks > 1
    if n != 16:
        assert got.stats.dim_blocks_skipped > 0


@pytest.mark.parametrize("eps_index", [0, 1])
@pytest.mark.parametrize("case", range(len(DENSE_CASES)))
def test_dense_epilogues_equal_plain_and_earlier_kernel(cuda, case, eps_index):
    t, n, db, order, c, real = DENSE_CASES[case]
    before = dict(dense_tile.LAUNCHES)
    dense_sweep_case(torch, np, dense_tile, t, n, db, order, c, real, eps_index, seed=5000 + case)
    grew = {k: dense_tile.LAUNCHES[k] - before[k] for k in before}
    # each epilogue on three grids (chip_smoke.k1_grids), the pairs step from
    # five states and in two launches, the earlier kernel once
    assert grew == {"dense_tile_distance": 3, "dense_tile_distance_mask": 3, "dense_count_scatter": 3,
                    "dense_pairs_compact": 30, "dense_tile_distance_tile_eval": 1}


@pytest.mark.parametrize("n,dim_block", [(16, 32), (20, 8), (64, 32), (384, 32)])
def test_engine_dense_launches_only_the_fused_kernels(cuda, n, dim_block):
    """16 dims in one block (the T=64 fast path), 20 over three blocks of 8,
    64 over two blocks of 32, and 384 at T = 64, too wide to stage whole: the
    dense count launches the fused count kernel once per chunk, the dense
    pairs the fused pairs kernel twice per chunk and K3 only for the
    result-size estimate; counts, stats and the pair arrays equal the CPU's
    row for row."""
    rng = np.random.default_rng(n)
    centers = rng.random((20, n))
    d = centers[rng.integers(0, 20, 2000)] + rng.normal(0, 0.03, (2000, n))
    d = (np.round(d.clip(0, 1) * 64) / 64).astype(np.float32)
    eps = float(np.sqrt(0.9 * n * 2 * (0.03 ** 2 + 1 / 64 ** 2 / 12)))  # 0.9 of a cluster's mean d2
    cfg = SelfJoinConfig(eps=eps, dim_block=dim_block, execution="dense")
    eng = EngineConfig(count_chunk=256, pairs_chunk=64)
    card = SelfJoinEngine(d, cfg, eng, device=cuda)
    host = SelfJoinEngine(d, cfg, eng, device="cpu")
    snap = card.snapshot
    dt = snap.dense_tables()
    assert dense_tile.dense_staging(dt.tiles.shape[1], n) == (dense_tile.K1_SLAB if n > 300 else 0)
    assert isinstance(engine.count_step(
        torch.zeros(1, dtype=torch.int32, device=cuda), torch.zeros((), dtype=torch.int32, device=cuda),
        dt.tiles, dt.tile_len, dt.tile_start, eps, dim_block=dim_block, shortc=False, backend="dense"),
        dense_tile.DenseCountScatter)
    buf = torch.zeros((10, 2), dtype=torch.int32, device=cuda)
    scalars = [torch.zeros((), dtype=torch.int32, device=cuda) for _ in range(2)]
    assert isinstance(engine.pairs_step(buf, *scalars, dt.tiles, dt.tile_len, dt.tile_start, snap.point_order, eps,
                                        hit_cap=4, dim_block=dim_block, backend="dense", chunk=64),
                      dense_tile.DensePairsCompact)
    before = _launches()
    got = card.count()
    torch.cuda.synchronize()
    grew = {k: v - before[k] for k, v in _launches().items()}
    assert grew == {k: got.stats.num_chunks if k == "dense_count_scatter" else 0 for k in grew}
    want = host.count()
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.stats == want.stats and got.stats.num_chunks > 1 and got.stats.num_results > len(d)
    before = _launches()
    got = card.pairs()
    torch.cuda.synchronize()
    grew = {k: v - before[k] for k, v in _launches().items()}
    est = grew["dense_tile_distance"]
    assert est > 0
    assert grew == {k: 2 * got.stats.num_device_dispatches if k == "dense_pairs_compact"
                    else est if k == "dense_tile_distance" else 0 for k in grew}
    want = host.pairs()
    np.testing.assert_array_equal(got.pairs, want.pairs)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.stats == want.stats


SERVICE_STEPS = {"indexed": ("tile_pair_count_scatter", "tile_pair_pairs_compact"),
                 "dense": ("dense_count_scatter", "dense_pairs_compact")}


@pytest.mark.parametrize("mode", ["indexed", "dense"])
@pytest.mark.parametrize("n,dims,eps,tile_size,dim_block", [
    (500, 16, 0.3, 16, 8), (1200, 16, 0.35, 64, 32), (400, 40, 0.7, 32, 16)])
def test_service_on_the_card_equals_the_cpu(cuda, mode, n, dims, eps, tile_size, dim_block):
    """One request stream -- range counts in two buckets, range pairs, kNN
    (growing past the build radius), inserts, deletes, a compaction -- to a
    service over a card index and one over a CPU index: equal answers and
    ``ServiceStats`` (``num_traces`` included) request for request; on the
    card the chunk loops launch the tier's fused count kernel once per count
    chunk and its fused pairs kernel twice per pairs chunk, nothing else.
    ``count_query`` on the card equals the CPU's too."""
    rng = np.random.default_rng(n + dims)
    centers = rng.random((12, dims))
    d = centers[rng.integers(0, 12, n)] + rng.normal(0, 0.05, (n, dims))
    d = (np.round(d.clip(0, 1) * 64) / 64).astype(np.float32)
    cfg = SelfJoinConfig(eps=eps, k=4, tile_size=tile_size, dim_block=dim_block, execution=mode)
    eng = EngineConfig(count_chunk=64, pairs_chunk=16)
    card = QueryService(SimilarityIndex(d[:-40], cfg, eng, device=cuda))
    host = QueryService(SimilarityIndex(d[:-40], cfg, eng, device="cpu"))
    q = np.concatenate([d[:30], (np.round(rng.random((20, dims)) * 64) / 64).astype(np.float32)])

    chunks = {"service.count.chunk": 0, "service.pairs.chunk": 0}  # the card service's chunk loops

    def both(kind, *args):
        with obs.capture() as cap:
            got = getattr(card, kind)(*args)
        for name in chunks:
            chunks[name] += cap.span_count(name, "dispatch")
        want = getattr(host, kind)(*args)
        for name in ("counts", "pairs", "indices", "distances"):
            if hasattr(want, name):
                np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
        assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
        return got

    before = _launches()
    both("range_count", q, eps)
    both("range_count", q[:9], eps / 2)
    assert both("range_pairs", q, eps).pairs.shape[0] > len(q)
    both("knn", q, 5)
    for index in (card.index, host.index):
        index.insert(d[-40:])
        index.delete(np.arange(0, 60, 4))
    both("range_count", q, eps)
    both("range_pairs", q, eps)
    both("knn", q[:7], 3)
    card.index.compact()
    host.index.compact()
    both("range_count", q, eps)
    both("range_pairs", q, eps)
    torch.cuda.synchronize()
    grew = {k: v - before[k] for k, v in _launches().items()}
    count_kernel, pairs_kernel = SERVICE_STEPS[mode]
    assert grew == {k: chunks["service.count.chunk"] if k == count_kernel
                    else 2 * chunks["service.pairs.chunk"] if k == pairs_kernel else 0 for k in grew}
    assert grew[count_kernel] > 0 and grew[pairs_kernel] > 0
    assert dataclasses.asdict(card.total) == dataclasses.asdict(host.total)
    assert card.total.execution == mode and card.total.num_traces > 0
    # the engine's own bipartite entry over the same combined tables
    got, want = card.index.engine.count_query(q, eps), host.index.engine.count_query(q, eps)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.stats == want.stats


def test_aux_pass_at_a_large_table_stays_bounded(cuda):
    """The churn aux pass at a 1024-query bucket against 262,144 aux rows of
    16 dims (a churned index without auto-compaction): its temporaries stay
    within a few (bucket, block) arrays, not the (bucket, rows, dims)
    difference tensor of 17 GB, and its columns equal the CPU's."""
    from repro_torch.join.service import _AUX_BLOCK, aux_membership

    rng = np.random.default_rng(7)
    q = rng.random((1024, 16), dtype=np.float32)
    pts = rng.random((1 << 18, 16), dtype=np.float32)
    real, eps = (1 << 18) - 1000, 1.5
    qd, pd = torch.from_numpy(q).to(cuda), torch.from_numpy(pts).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = aux_membership(qd, pd, real, eps)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base - got.numel() <= 4 * _AUX_BLOCK * 4
    assert got.shape == (1024, 1 << 18) and not got[:, real:].any()
    cols = np.r_[0:4096, real - 4096:real]
    want = aux_membership(torch.from_numpy(q), torch.from_numpy(pts[cols]), cols.size, eps)
    assert want.any() and not want.all()
    np.testing.assert_array_equal(got[:, torch.from_numpy(cols).to(cuda)].cpu().numpy(), want.numpy())


@pytest.mark.parametrize("mode", ["indexed", "dense"])
@pytest.mark.parametrize("n,eps,tile_size,dim_block,workers,assignment", [
    (1003, 0.3, 16, 8, 4, "round_robin"), (1500, 0.35, 64, 32, 3, "dynamic")])
def test_distributed_on_the_card_equals_the_cpu(cuda, mode, n, eps, tile_size, dim_block, workers, assignment):
    """The host-driven distributed engine on the card against the same
    engine on the CPU: ``count()``, ``self_join_pairs()`` (pair arrays row
    for row) and ``knn`` equal, every ``SelfJoinStats`` field too; the
    blocks' chunk loops launch the tier's fused count kernel once per count
    chunk and its fused pairs kernel twice per pairs chunk, nothing else."""
    from repro_torch.core import DistributedSelfJoinEngine

    rng = np.random.default_rng(n)
    centers = rng.random((12, 16))
    d = centers[rng.integers(0, 12, n)] + rng.normal(0, 0.05, (n, 16))
    d = (np.round(d.clip(0, 1) * 64) / 64).astype(np.float32)
    cfg = SelfJoinConfig(eps=eps, k=4, tile_size=tile_size, dim_block=dim_block, execution=mode)
    eng = EngineConfig(count_chunk=64, pairs_chunk=16)
    kw = dict(num_workers=workers, assignment=assignment, engine_config=eng)
    card = DistributedSelfJoinEngine(d, cfg, device=cuda, **kw)
    host = DistributedSelfJoinEngine(d, cfg, device="cpu", **kw)
    assert all(e.device.type == "cuda" for e in card.shards)
    count_kernel, pairs_kernel = SERVICE_STEPS[mode]

    before = _launches()
    got = card.count()
    torch.cuda.synchronize()
    grew = {k: v - before[k] for k, v in _launches().items()}
    assert grew == {k: got.stats.num_chunks if k == count_kernel else 0 for k in grew}
    want = host.count()
    np.testing.assert_array_equal(got.counts, want.counts)
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    assert got.stats.num_chunks > workers and got.stats.num_results > n

    before = _launches()
    with obs.capture() as cap:
        got = card.self_join_pairs()
        kn = card.knn(5, eps0=eps / 4)
    torch.cuda.synchronize()
    grew = {k: v - before[k] for k, v in _launches().items()}
    n_count = cap.span_count("ring.block.count.chunk", "dispatch")
    n_pairs = cap.span_count("ring.block.pairs.chunk", "dispatch")
    assert grew == {k: n_count if k == count_kernel else 2 * n_pairs if k == pairs_kernel else 0 for k in grew}
    assert n_pairs > got.stats.num_chunks > 0 and kn.eps_rounds > 1
    want = host.self_join_pairs()
    np.testing.assert_array_equal(got.pairs, want.pairs)  # in order
    np.testing.assert_array_equal(got.counts, want.counts)
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    want = host.knn(5, eps0=eps / 4)
    for name in ("indices", "distances", "counts"):
        np.testing.assert_array_equal(getattr(kn, name), getattr(want, name), err_msg=name)
    assert (kn.eps_used, kn.eps_rounds) == (want.eps_used, want.eps_rounds)
    assert dataclasses.asdict(kn.stats) == dataclasses.asdict(want.stats)


def test_ring_counts_on_a_one_rank_nccl_group(cuda, tmp_path):
    """``ring_self_join_counts`` over a one-rank NCCL group (the identity
    ring: no point-to-point op, one all-gather) equals the float64 brute
    force on 1/64-quantized points, and so does a ring over a one-rank
    ``DeviceMesh`` with ``overlap=True``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core.brute import brute_counts
    from repro_torch.core.distributed import ring_self_join_counts

    rng = np.random.default_rng(3)
    d = (np.round(rng.exponential(1 / 40, size=(3001, 16)).clip(0, 1) * 64) / 64).astype(np.float32)
    want = brute_counts(d, 0.06)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        got = ring_self_join_counts(d, 0.06, dist.group.WORLD, row_block=512, device=cuda)
        mesh = DeviceMesh("cuda", torch.arange(1).reshape(1, 1), mesh_dim_names=("pod", "data"))
        got_mesh = ring_self_join_counts(d, 0.06, mesh, ("pod", "data"), device=cuda, overlap=True)
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_mesh, want)


@pytest.mark.parametrize("n,eps,tile_size,dim_block", [(1003, 0.3, 16, 8), (1500, 0.35, 64, 32)])
def test_fused_ring_on_one_rank_groups(cuda, tmp_path, n, eps, tile_size, dim_block):
    """The fused ring on a one-rank NCCL group (the payload on the card)
    equals the host-driven engine: ``count()``, and ``self_join_pairs()``'s
    pair set with the cursors accounting for every pair; it launches K1's
    fused count step once per count chunk with work, K2's fused pairs step
    twice per pairs chunk with work and the pack's hit-rate sample (K1 per
    pair, one launch), nothing else.  The same engine over a one-rank gloo
    group on the card (the payload in host memory, copied into the combined
    table each round) gives the same results, the pairs in the same order."""
    import torch.distributed as dist

    from repro_torch.core import DistributedSelfJoinEngine

    rng = np.random.default_rng(n)
    centers = rng.random((12, 16))
    d = centers[rng.integers(0, 12, n)] + rng.normal(0, 0.05, (n, 16))
    d = (np.round(d.clip(0, 1) * 64) / 64).astype(np.float32)
    cfg = SelfJoinConfig(eps=eps, k=4, tile_size=tile_size, dim_block=dim_block)
    eng = EngineConfig(count_chunk=64, pairs_chunk=16)
    host = DistributedSelfJoinEngine(d, cfg, num_workers=1, engine_config=eng, device=cuda)
    want_count, want_pairs = host.count(), host.self_join_pairs()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    got = {}
    try:
        for backend in ("nccl", "gloo"):
            group = dist.group.WORLD if backend == "nccl" else dist.new_group(backend="gloo")
            de = DistributedSelfJoinEngine(d, cfg, mesh=group, engine_config=eng, fused=True, device=cuda)
            before = _launches()
            count, pairs = de.count(), de.self_join_pairs()
            torch.cuda.synchronize()
            grew = {k: v - before[k] for k, v in _launches().items()}
            pack = de._fused_pack
            want = {"tile_pair_count_scatter": int((pack["args"][6] > 0).sum()),
                    "tile_pair_pairs_compact": 2 * int((pack["pairs_args"][6] > 0).sum())
                    * pairs.stats.num_device_dispatches,
                    "tile_pair_distance": 1}
            assert grew == {k: want.get(k, 0) for k in grew}
            assert want["tile_pair_count_scatter"] > 1 and want["tile_pair_pairs_compact"] > 2
            assert pack["args"][0].device.type == "cuda"
            assert pack["args"][7].device.type == ("cuda" if backend == "nccl" else "cpu")
            got[backend] = (count, pairs)
    finally:
        dist.destroy_process_group()
    want_set = set(map(tuple, want_pairs.pairs.tolist()))
    for count, pairs in got.values():
        np.testing.assert_array_equal(count.counts, want_count.counts)
        np.testing.assert_array_equal(pairs.counts, want_count.counts)
        assert set(map(tuple, pairs.pairs.tolist())) == want_set and len(pairs.pairs) == len(want_set)
        assert sum(pairs.stats.worker_pair_cursors) == pairs.stats.num_results
    np.testing.assert_array_equal(got["nccl"][1].pairs, got["gloo"][1].pairs)


ATTN_DIMS = [(16, 16), (32, 32), (48, 16), (64, 64), (128, 128), (192, 128), (256, 256),
             (20, 12), (12, 40), (264, 64)]  # not multiples of 8 up to 256: bf16 stays on the CUDA cores
ATTN_LENS = [(128, 128), (96, 160), (160, 96)]     # ragged against the kernels' 64- and 128-row tiles
ATTN_CHUNKS = [(32, 32), (16, 32), (512, 512)]
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("n,dim_block,eps,batch_size", [(16, 32, 0.15, 10 ** 8), (20, 8, 0.15, 20000),
                                                        (384, 32, 0.9, 50000)])
def test_hostloop_on_the_card_equals_the_cpu(cuda, monkeypatch, n, dim_block, eps, batch_size):
    """``self_join_hostloop`` on the card against the same call on the CPU:
    counts, the pair array row for row and every stats field; counts mode
    launches K1 per pair once per ``ops.tile_counts`` chunk, pairs mode K2
    per pair once per ``ops.tile_mask`` chunk of each batch (small
    ``batch_size`` values force more batches) plus the estimate's K1."""
    from repro_torch.core import batching, self_join_hostloop

    rng = np.random.default_rng(n + 7)
    centers = rng.random((20, n))
    d = centers[rng.integers(0, 20, 3000)] + rng.normal(0, 0.03, (3000, n))
    d = (np.round(d.clip(0, 1) * 64) / 64).astype(np.float32)
    cfg = SelfJoinConfig(eps=eps, dim_block=dim_block, batch_size=batch_size)
    before = _launches()
    got = self_join_hostloop(d, cfg, device=cuda)
    torch.cuda.synchronize()
    grew = {k: v - before[k] for k, v in _launches().items()}
    p = got.stats.num_tile_pairs_evaluated
    assert grew == {k: -(-p // 4096) if k == "tile_pair_distance" else 0 for k in grew}
    want = self_join_hostloop(d, cfg, device="cpu")
    np.testing.assert_array_equal(got.counts, want.counts)
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    if n != 16:
        assert got.stats.dim_blocks_skipped > 0

    ranges = []
    batch_ranges = batching.batch_ranges

    def spy(num_pairs, num_batches):
        ranges.extend(batch_ranges(num_pairs, num_batches))
        return batch_ranges(num_pairs, num_batches)

    monkeypatch.setattr(batching, "batch_ranges", spy)
    before = _launches()
    got = self_join_hostloop(d, cfg, return_pairs=True, device=cuda)
    torch.cuda.synchronize()
    grew = {k: v - before[k] for k, v in _launches().items()}
    masks = sum(-(-(hi - lo) // 512) for lo, hi in ranges)
    assert len(ranges) >= 3 and ranges[-1][1] == p
    assert grew == {k: masks if k == "tile_pair_distance_mask" else 1 if k == "tile_pair_distance" else 0
                    for k in grew}
    want = self_join_hostloop(d, cfg, return_pairs=True, device="cpu")
    np.testing.assert_array_equal(got.pairs, want.pairs)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)


def test_dedup_on_the_card_equals_the_cpu(cuda):
    """Near-duplicate dedup (``find_near_duplicates`` over ``self_join`` at
    T = 32) on the card against the CPU on 1/64-quantized embeddings, with
    planted copies; the join launches only the estimate's K1 and K2's fused
    pairs step (twice per chunk)."""
    from repro_torch.data import dedup

    rng = np.random.default_rng(11)
    base = rng.integers(0, 1000, (1800, 64))
    dups = base[:200].copy()
    dups[:, ::17] += 1
    ex = np.concatenate([base, dups, base[:20]])
    emb = (np.round(dedup.hashed_ngram_embed(ex, dim=16) * 64) / 64).astype(np.float32)
    before = _launches()
    got = dedup.find_near_duplicates(emb, 0.2, device=cuda)
    torch.cuda.synchronize()
    grew = {k: v - before[k] for k, v in _launches().items()}
    est = grew["tile_pair_distance"]
    assert est > 0
    assert grew == {k: 2 * got.stats.num_device_dispatches if k == "tile_pair_pairs_compact"
                    else est if k == "tile_pair_distance" else 0 for k in grew}
    want = dedup.find_near_duplicates(emb, 0.2, device="cpu")
    np.testing.assert_array_equal(got.keep, want.keep)
    np.testing.assert_array_equal(got.group_of, want.group_of)
    assert got.num_duplicate_pairs == want.num_duplicate_pairs >= 20
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)


def test_bridge_ranges_surround_the_fused_count_kernel(cuda):
    """The torch.profiler bridge on the card (``chip_smoke.phase_bridge``):
    one ``engine.count.chunk`` range per chunk, the kernel records inside
    them all K1's fused count kernel, no obs range with the bridge off."""
    rng = np.random.default_rng(3)
    d = (np.round(rng.random((4000, 16)) * 64) / 64).astype(np.float32)
    eng = SelfJoinEngine(d, SelfJoinConfig(eps=0.2), EngineConfig(count_chunk=256), device=cuda)
    out = phase_bridge(torch, eng)["bridge"]
    assert out["chunk_ranges"] == out["chunks"] > 1
    assert 0 < out["kernel_records"] <= out["chunks"]
    assert out["ranges_without_bridge"] == 0


def _qkv(bh, sq, sk, dh, dv, dtype, seed, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device=device, dtype=dtype)
            for shape in ((bh, sq, dh), (bh, sk, dh), (bh, sk, dv))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dh,dv", ATTN_DIMS)
def test_flash_attention_equals_plain_version(cuda, dh, dv, causal, dtype):
    for i, (sq, sk) in enumerate(ATTN_LENS):
        qc, kc = ATTN_CHUNKS[(i + dh) % len(ATTN_CHUNKS)]
        for scale in (None, 0.125):
            q, k, v = _qkv(3, sq, sk, dh, dv, dtype, seed=dh * 31 + dv + i, device=cuda)
            route = flash_attention._route(q, v)
            wgmma = dtype == torch.bfloat16 and dh % 8 == 0 and dv % 8 == 0 and dh <= 256
            assert route == ("wgmma" if wgmma else "cuda_core")
            key = flash_attention.ROUTE_KERNEL[route]
            before = dict(flash_attention.LAUNCHES)
            got = flash_attention.flash_attention(q, k, v, causal=causal, q_chunk=qc, k_chunk=kc, scale=scale)
            torch.cuda.synchronize()
            assert flash_attention.LAUNCHES == {n: c + (n == key) for n, c in before.items()}
            want = flash_attention.flash_attention_plain(q, k, v, causal=causal, q_chunk=qc, k_chunk=kc,
                                                         scale=scale)
            assert got.device.type == "cuda" and got.dtype == dtype and got.shape == (3, sq, dv)
            tol = ATTN_TOL[dtype]
            torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("s,dh,dv", [(1024, 128, 128), (1024, 192, 128), (2048, 64, 64)])
def test_flash_attention_wgmma_few_key_rows_within_one_bf16_step(cuda, s, dh, dv):
    # causal: the first rows see a few keys, where p's rounding shows most
    q, k, v = _qkv(2, s, s, dh, dv, torch.bfloat16, seed=s + dh, device=cuda)
    before = flash_attention.LAUNCHES["flash_attention_wgmma"]
    got = flash_attention.flash_attention(q, k, v, causal=True)
    assert flash_attention.LAUNCHES["flash_attention_wgmma"] == before + 1
    want = flash_attention.flash_attention_plain(q, k, v, causal=True)
    g, w = got.float(), want.float()
    rtol, atol = ATTN_FULL_TOL
    assert bool(torch.isfinite(g).all())
    assert bool(((g - w).abs() <= rtol * w.abs() + atol).all())


def test_flash_attention_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(2, 64, 64, 32, 32, torch.float32, seed=0, device=cuda)
    before = dict(flash_attention.LAUNCHES)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention.flash_attention(q, k.bfloat16(), v)
    wide = torch.zeros((2, 64, 320), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="value widths 1..256"):
        flash_attention.flash_attention(q, k, wide)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="must divide chunks"):
        flash_attention.flash_attention(q, k, v, q_chunk=48)
    assert flash_attention.LAUNCHES == before


def _reduced_card_vs_cpu(cuda, arch, dtype):
    """``arch``'s reduced config on the card against the same parameters on
    the CPU: prefill logits and caches or states, 8 teacher-forced decode
    steps' logits, the caches or states after them, greedy tokens (chip_smoke
    phase 11 (a), ``MODEL_TOL``); no kernel of ``repro_torch.kernels``
    launches.  Returns the card's run."""
    from chip_smoke import MODEL_TOL, model_twin, rel_err, tree_err
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    cfg = dataclasses.replace(configs.get_reduced_config(arch), activation_dtype=dtype)
    params = M.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    before = {**distance_tile.LAUNCHES, **dense_tile.LAUNCHES, **flash_attention.LAUNCHES}
    with torch.no_grad():
        want = model_twin(torch, serve, M, cfg, params, torch.device("cpu"), 3)
        got = model_twin(torch, serve, M, cfg, M.tree_map(lambda t: t.to(cuda), params), cuda, 3,
                         forced=want["tokens"])
    assert before == {**distance_tile.LAUNCHES, **dense_tile.LAUNCHES, **flash_attention.LAUNCHES}
    tol = MODEL_TOL[dtype]
    for g, w in zip(got["logits"], want["logits"]):
        assert rel_err(g, w) <= tol
    assert tree_err(M, got["caches"], want["caches"]) <= tol
    assert tree_err(M, got["decoded_caches"], want["decoded_caches"]) <= tol
    for lg, g, w in zip(want["logits"], got["tokens"], want["tokens"]):
        for b in torch.nonzero(g != w).flatten().tolist():   # only on a near-tie of the CPU's top 2
            top2 = torch.topk(lg[b], 2).values
            assert float(top2[0] - top2[1]) <= tol * float(lg[b].abs().max())
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_model_on_the_card_equals_the_cpu(cuda, dtype):
    """Reduced gemma3 (window 8, so the ring wraps in prefill and decode)."""
    got = _reduced_card_vs_cpu(cuda, "gemma3_12b", dtype)
    assert sorted(got["decoded_caches"][0][0]["pos"][0].tolist()) == list(range(12, 20))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "xlstm_125m", "deepseek_v2_236b", "arctic_480b"])
def test_reduced_recurrent_mla_moe_models_on_the_card_equal_the_cpu(cuda, arch, dtype):
    """The four archs of MLA, MoE and the recurrent mixers: their recurrent
    states and MLA caches after 8 chained decode steps too."""
    _reduced_card_vs_cpu(cuda, arch, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["gemma3_12b", "seamless_m4t_medium", "recurrentgemma_2b", "xlstm_125m",
                                  "deepseek_v2_236b", "arctic_480b"])
def test_reduced_train_step_on_the_card_equals_the_cpu(cuda, arch, dtype):
    """One ``make_train_step`` step of a reduced config on the card against
    the CPU (chip_smoke phase 12 (a)): loss, grad_norm, lr, the gradients
    and the updated params (``train_card_vs_cpu``); no kernel of
    ``repro_torch.kernels`` launches."""
    from chip_smoke import train_card_vs_cpu
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.train import steps

    before = {**distance_tile.LAUNCHES, **dense_tile.LAUNCHES, **flash_attention.LAUNCHES}
    train_card_vs_cpu(torch, M, configs, steps, arch, dtype, 3)
    assert before == {**distance_tile.LAUNCHES, **dense_tile.LAUNCHES, **flash_attention.LAUNCHES}
