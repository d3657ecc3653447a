"""K1's redesign in the PyTorch port against the JAX package, on the CPU.

``distance_tile.tile_pair_count_scatter`` is the indexed tier's count chunk
step; on the card it is one launch of ``csrc/distance_tile_counts.cu``
(held against its plain version by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``), here its plain version.  It is compared with
``repro.core.engine.count_chunk_step`` (jnp backend, and the Pallas kernel
in interpret mode) on padded chunks with ``real < C``, ragged tile lengths,
``num_dims < n_pad``, several dim blocks (SHORTC breaking after the first
and after a later one) and ``shortc`` on and off.  Coordinates are
1/64-quantized, so everything compares with ``==``.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracles import make_dataset
import repro.core as ref_core
from repro.core import engine as ref_engine
from repro_torch.core import EngineConfig, SelfJoinConfig, SelfJoinEngine
from repro_torch.core import engine
from repro_torch.kernels import distance_tile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import k1_case  # noqa: E402

# (T, n, dim_block, pair order, C, real): n < n_pad, n = 1 and dim_block + 1,
# up to 5 dim blocks, dim blocks that are not multiples of 4, and rows as
# wide as those the card's kernel stages in slices (150 dims)
CASES = [
    (8, 9, 8, "sorted", 40, 33),
    (16, 1, 8, "random", 40, 40),
    (16, 20, 4, "sorted", 40, 29),
    (33, 17, 16, "random", 40, 35),
    (12, 6, 3, "sorted", 40, 40),
    (8, 150, 40, "sorted", 40, 37),
]


def _case(t, n, db, order, c, seed):
    x = k1_case(torch, np, t, n, db, order, c, seed, device="cpu")
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in x.items()}


def _port_step(x, real, eps, db, shortc, num_dims):
    cs = torch.from_numpy(x["state"].copy())
    sk = torch.full((), 7, dtype=torch.int32)
    engine.count_chunk_step(
        cs, sk, *(torch.from_numpy(x[k]) for k in ("tiles", "lens", "starts", "pa", "pb")), real, eps,
        dim_block=db, shortc=shortc, backend="pallas", num_dims=num_dims,
    )
    return cs.numpy(), int(sk)


@pytest.mark.parametrize("shortc", [True, False])
@pytest.mark.parametrize("t,n,db,order,c,real", CASES)
def test_fused_step_equals_reference_count_chunk_step(t, n, db, order, c, real, shortc):
    x = _case(t, n, db, order, c, seed=t * 31 + n)
    for eps in (0.3, 0.05):
        got_cs, got_sk = _port_step(x, real, eps, db, shortc, num_dims=n)
        # the reference's counts vector has no sink row; rows past N drop
        for backend in ("jnp", "pallas"):
            want_cs, want_sk = ref_engine.count_chunk_step(
                jnp.asarray(x["state"][:-1]), jnp.asarray(7, jnp.int32),
                *(jnp.asarray(x[k]) for k in ("tiles", "lens", "starts", "pa", "pb")),
                jnp.asarray(real, jnp.int32), jnp.asarray(eps, jnp.float32),
                dim_block=db, shortc=shortc, backend=backend, interpret=True,
            )
            np.testing.assert_array_equal(got_cs[:-1], np.asarray(want_cs))
            assert got_sk == int(want_sk)
        assert got_cs[-1] == x["state"][-1]  # the sink row takes nothing here


def test_sweep_breaks_after_first_and_later_blocks():
    """The cases above reach both kinds of SHORTC break (else they test less)."""
    kinds = set()
    for t, n, db, order, c, _ in CASES:
        x = _case(t, n, db, order, c, seed=t * 31 + n)
        blocks = x["tiles"].shape[2] // db
        _, skipped = distance_tile.tile_pair_distance(
            *(torch.from_numpy(x[k]) for k in ("tiles", "lens", "pa", "pb")), eps=0.05, dim_block=db, num_dims=n)
        kinds |= {"first" if s == blocks - 1 else "later" for s in skipped.tolist() if s}
    assert kinds == {"first", "later"}


@pytest.mark.parametrize("t,n,db,order,c,real", CASES)
def test_plain_over_real_dims_equals_full_n_pad(t, n, db, order, c, real):
    x = _case(t, n, db, order, c, seed=t * 7 + n)
    args = [torch.from_numpy(x[k]) for k in ("tiles", "lens", "pa", "pb")]
    for eps in (0.3, 0.05):
        full = distance_tile.tile_pair_distance_plain(*args, eps=eps, dim_block=db)
        real_dims = distance_tile.tile_pair_distance_plain(*args, eps=eps, dim_block=db, num_dims=n)
        for f, r in zip(full, real_dims):
            assert torch.equal(f, r)


def emulate_kernel_split(x, real, eps, db, shortc, num_dims, grid):
    """The fused kernel's accumulation, in plain torch: CTA b of ``grid``
    walks pairs [real b / grid, real (b + 1) / grid), sums its pairs' row
    counts over each run of equal pair_a, and flushes a run (rows < len,
    nonzero, below N) when pair_a changes or its range ends; skipped sums
    per CTA."""
    cs = torch.from_numpy(x["state"].copy())
    sk = 7
    counts, skipped = distance_tile.tile_pair_distance_plain(
        *(torch.from_numpy(x[k]) for k in ("tiles", "lens", "pa", "pb")),
        eps=eps, dim_block=db, num_dims=num_dims)
    n_sorted = cs.shape[0] - 1
    t = counts.shape[1]

    def flush(ta, run):
        for r in range(min(int(x["lens"][ta]), t)):
            idx = int(x["starts"][ta]) + r
            if run[r] and idx < n_sorted:
                cs[idx] += run[r]

    for b in range(grid):
        beg, end = real * b // grid, real * (b + 1) // grid
        cur, run = -1, None
        for p in range(beg, end):
            ta = int(x["pa"][p])
            if ta != cur:
                if cur >= 0:
                    flush(cur, run)
                cur, run = ta, torch.zeros(t, dtype=torch.int32)
            run += counts[p]
            sk += int(skipped[p]) if shortc else 0
        if cur >= 0:
            flush(cur, run)
    return cs.numpy(), sk


@pytest.mark.parametrize("grid", [1, 3, 7, 64, 300])
def test_kernel_split_into_runs_equals_plain_step(grid):
    t, n, db, order, c, real = 16, 20, 4, "sorted", 200, 187
    x = _case(t, n, db, order, c, seed=grid)
    for shortc in (True, False):
        want = _port_step(x, real, 0.3, db, shortc, num_dims=n)
        got = emulate_kernel_split(x, real, 0.3, db, shortc, n, grid)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


@pytest.mark.parametrize(
    "device,mask,route",
    [("cpu", False, "plain"), ("cpu", True, "plain"), ("cuda", False, "counts"), ("cuda", True, "counts")],
)
def test_route_reads_device_and_mode(device, mask, route):
    # a device object stands in for a card here: _route reads no tensor.  On
    # CUDA, K1's counts and K2's mask both run csrc/distance_tile_counts.cu
    assert distance_tile._route(torch.device(device), mask) == route
    with pytest.raises(ValueError, match="cpu or cuda"):
        distance_tile._route(torch.device("meta"), mask)


@pytest.mark.parametrize("backend", ["pallas", "jnp", "dense", "dense_jnp"])
def test_count_step_off_the_card_is_count_chunk_step(backend):
    """Off the card ``count_step`` binds ``count_chunk_step`` (on the card
    the indexed tier binds a ``CountScatter``, tests/test_torch_cuda.py)."""
    t, n, db, order, c, real = CASES[2]
    x = _case(t, n, db, order, c, seed=5)
    tabs = [torch.from_numpy(x[k]) for k in ("tiles", "lens", "starts")]
    outs = []
    for bound in (True, False):
        cs, sk = torch.from_numpy(x["state"].copy()), torch.zeros((), dtype=torch.int32)
        pa, pb = torch.from_numpy(x["pa"]), torch.from_numpy(x["pb"])
        if bound:
            step = engine.count_step(cs, sk, *tabs, 0.3, dim_block=db, shortc=True, backend=backend, num_dims=n)
            assert not isinstance(step, distance_tile.CountScatter)
            step(pa, pb, real)
        else:
            engine.count_chunk_step(cs, sk, *tabs, pa, pb, real, 0.3, dim_block=db, shortc=True, backend=backend,
                                    num_dims=n)
        outs.append((cs, sk))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


# (T, num_dims, slab): whole rows up to the 227 KB of a block's shared
# memory, 32-dim slices past it
STAGING = [(64, 16, 0), (64, 300, 0), (64, 301, 32), (64, 384, 32), (128, 90, 0), (128, 148, 0),
           (128, 149, 32), (16, 1204, 0), (16, 1205, 32), (32, 604, 0), (32, 605, 32), (100, 150, 32)]


@pytest.mark.parametrize("t,num_dims,slab", STAGING)
def test_k1_staging_is_chosen_by_shape(t, num_dims, slab):
    assert distance_tile.k1_staging(t, num_dims) == slab


def test_k1_refuses_num_dims_past_n_pad():
    tiles = torch.zeros((2, 128, 160))
    with pytest.raises(ValueError, match="num_dims"):
        distance_tile.tile_pair_distance(tiles, torch.zeros(2, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
                                         torch.zeros(1, dtype=torch.int32), eps=0.1, num_dims=161)


def test_engine_with_ragged_dims_and_shortc_skips_matches_reference():
    """n = 20 over dim_block 8 (n_pad 24, three blocks), clustered data on
    which SHORTC skips blocks: counts and stats equal the JAX engine's."""
    d = make_dataset("clustered", 600, 20, seed=11)  # 1/64-quantized
    kw = dict(eps=0.15, k=3, tile_size=16, dim_block=8)
    eng = dict(count_chunk=32)
    ref = ref_core.SelfJoinEngine(d, ref_core.SelfJoinConfig(**kw), ref_core.EngineConfig(**eng))
    port = SelfJoinEngine(d, SelfJoinConfig(**kw), EngineConfig(**eng), device="cpu")
    want, got = ref.count(), port.count()
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.stats.dim_blocks_skipped == want.stats.dim_blocks_skipped > 0
    assert got.stats.num_chunks == want.stats.num_chunks > 1
    assert got.stats.num_device_dispatches == want.stats.num_device_dispatches
