"""The dense tier's fused chunk steps in the PyTorch port against the JAX package, on the CPU.

On the card ``dense_tile.DenseCountScatter`` and ``dense_tile.DensePairsCompact``
are launches of ``csrc/dense_tile_fused.cu`` (held against their plain
versions by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``).  Here their
plain versions, ``dense_count_scatter_plain`` and ``dense_pairs_compact_plain``
(per-pair totals, an exclusive scan and an ordered write: the kernel's
algorithm), are compared with ``repro.core.engine.count_chunk_step`` and
``pairs_chunk_step`` with the dense backends (``"dense_jnp"``, and
``"dense"``: the Pallas kernel in interpret mode), on padded chunks with
``real < C``, ragged tile lengths, ``num_dims < n_pad`` and several dim
blocks; the pairs step also with more hits than ``hit_cap``, a chunk that
straddles ``cap`` and ``offset`` past ``cap`` before the chunk.  The pairs
buffer compares row for row, order included, on every row the reference
defines (``chip_smoke.landed_rows``).  Coordinates are 1/64-quantized, so
everything compares with ``==``.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
from oracles import make_dataset
from repro.core import engine as ref_engine
from repro_torch.core import EngineConfig, SelfJoinConfig, SelfJoinEngine
from repro_torch.core import engine
from repro_torch.kernels import dense_tile, distance_tile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import dense_case, landed_rows, pairs_state, pairs_states  # noqa: E402

# (T, n, dim_block, pair order, C, real): n < n_pad, one and several dim
# blocks (up to 5), dim blocks that are not multiples of 4, a ragged last
# tile, the dense plan's A-major order, sorted and random pairs
CASES = [
    (16, 9, 8, "dense", 40, 33),
    (16, 16, 16, "dense", 40, 40),
    (8, 20, 4, "sorted", 40, 29),
    (33, 17, 16, "random", 40, 35),
    (12, 6, 3, "dense", 40, 40),
    (8, 150, 40, "dense", 40, 37),
]
BACKENDS = ["dense_jnp", "dense"]


def _case(t, n, db, order, c, seed):
    x = dense_case(torch, np, t, n, db, order, c, seed, device="cpu")
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in x.items()}


def _tensors(x, *keys):
    return [torch.from_numpy(x[k].copy()) for k in keys]


def _ref(x, *keys):
    return [jnp.asarray(x[k]) for k in keys]


def _hits(x, real, eps, db, n):
    (counts,) = dense_tile.dense_tile_distance_plain(*_tensors(x, "tiles", "lens", "pa", "pb"), eps=eps,
                                                     dim_block=db, num_dims=n)
    return int(counts[:real].sum())


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("t,n,db,order,c,real", CASES)
def test_dense_count_step_equals_reference(t, n, db, order, c, real, backend):
    x = _case(t, n, db, order, c, seed=t * 31 + n)
    for eps in x["eps"]:
        cs = torch.from_numpy(x["state"].copy())
        dense_tile.dense_count_scatter_plain(cs, *_tensors(x, "tiles", "lens", "starts", "pa", "pb"), real, eps,
                                             dim_block=db, num_dims=n)
        # the reference's counts vector has no sink row; rows past N drop
        want, want_sk = ref_engine.count_chunk_step(
            jnp.asarray(x["state"][:-1]), jnp.asarray(7, jnp.int32), *_ref(x, "tiles", "lens", "starts", "pa", "pb"),
            jnp.asarray(real, jnp.int32), jnp.asarray(eps, jnp.float32),
            dim_block=db, shortc=False, backend=backend, interpret=True,
        )
        np.testing.assert_array_equal(cs.numpy()[:-1], np.asarray(want))
        assert int(want_sk) == 7  # the dense tier adds no skipped blocks
        assert cs[-1] == x["state"][-1]
        assert not np.array_equal(cs.numpy(), x["state"]) or eps == x["eps"][1]


def _port_pairs(x, real, eps, db, n, offset0, cap, hit_cap):
    buf, offset, mch = pairs_state(torch, offset0, cap, hit_cap, device="cpu")
    dense_tile.dense_pairs_compact_plain(buf, offset, mch, *_tensors(x, "tiles", "lens", "starts", "point_order",
                                                                     "pa", "pb"),
                                         real, eps, hit_cap=hit_cap, dim_block=db, num_dims=n)
    return buf.numpy(), int(offset), int(mch)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("t,n,db,order,c,real", CASES)
def test_dense_pairs_step_equals_reference(t, n, db, order, c, real, backend):
    x = _case(t, n, db, order, c, seed=t * 17 + n)
    seen = set()
    for eps in x["eps"]:
        nh = _hits(x, real, eps, db, n)
        for name, offset0, cap, hit_cap in pairs_states(nh):
            got, off, mch = _port_pairs(x, real, eps, db, n, offset0, cap, hit_cap)
            buf0, _, _ = pairs_state(torch, offset0, cap, hit_cap, device="cpu")
            want, want_off, want_mch = ref_engine.pairs_chunk_step(
                jnp.asarray(buf0.numpy()), jnp.asarray(offset0, jnp.int32), jnp.asarray(3, jnp.int32),
                *_ref(x, "tiles", "lens", "starts", "point_order", "pa", "pb"),
                jnp.asarray(real, jnp.int32), jnp.asarray(eps, jnp.float32),
                hit_cap=hit_cap, dim_block=db, backend=backend, interpret=True,
            )
            assert (off, mch) == (int(want_off), int(want_mch)) == (offset0 + nh, max(3, nh)), name
            rows = landed_rows(offset0, nh, cap, hit_cap)
            np.testing.assert_array_equal(got[:rows], np.asarray(want)[:rows], err_msg=name)
            assert (got[rows:] == -1).all(), name  # the fused step writes no row past its hits
            seen.add(name if nh > 1 else "few hits")
    assert {"fits", "hits_past_hit_cap", "straddles_cap", "past_cap"} <= seen


@pytest.mark.parametrize("backend", BACKENDS)
def test_dense_pairs_pass_equals_reference_in_order(backend):
    """A pass of chunks (the last one short) from offset 0: the port's plain
    fused step and the reference's step leave the same ``buf[:offset]``."""
    t, n, db = 16, 20, 8
    x = _case(t, n, db, "dense", 144, seed=3)
    chunk, hit_cap, cap = 40, 2048, 6000
    buf, offset, mch = pairs_state(torch, 0, cap, hit_cap, device="cpu")
    rbuf, roff, rmch = jnp.asarray(buf.numpy()), jnp.asarray(0, jnp.int32), jnp.asarray(3, jnp.int32)
    tabs = _tensors(x, "tiles", "lens", "starts", "point_order")
    eps = x["eps"][0]
    for s in range(0, 144, chunk):
        pa = np.zeros(chunk, np.int32)
        pb = np.zeros(chunk, np.int32)
        real = min(chunk, 144 - s)
        pa[:real], pb[:real] = x["pa"][s:s + real], x["pb"][s:s + real]
        dense_tile.dense_pairs_compact_plain(buf, offset, mch, *tabs, torch.from_numpy(pa), torch.from_numpy(pb),
                                             real, eps, hit_cap=hit_cap, dim_block=db, num_dims=n)
        rbuf, roff, rmch = ref_engine.pairs_chunk_step(
            rbuf, roff, rmch, *_ref(x, "tiles", "lens", "starts", "point_order"), jnp.asarray(pa), jnp.asarray(pb),
            jnp.asarray(real, jnp.int32), jnp.asarray(eps, jnp.float32),
            hit_cap=hit_cap, dim_block=db, backend=backend, interpret=True,
        )
    num = int(offset)
    assert num == int(roff) > 0 and int(mch) == int(rmch)
    np.testing.assert_array_equal(buf.numpy()[:num], np.asarray(rbuf)[:num])


@pytest.mark.parametrize("t,n,db,order,c,real", CASES)
def test_plain_over_real_dims_equals_full_n_pad(t, n, db, order, c, real):
    x = _case(t, n, db, order, c, seed=t * 7 + n)
    args = _tensors(x, "tiles", "lens", "pa", "pb")
    for eps in x["eps"]:
        full = dense_tile.dense_tile_distance_plain(*args, eps=eps, dim_block=db, return_mask=True)
        real_dims = dense_tile.dense_tile_distance(*args, eps=eps, dim_block=db, return_mask=True, num_dims=n)
        for f, r in zip(full, real_dims):
            assert torch.equal(f, r)


def emulate_count_split(x, real, eps, db, n, grid):
    """Epilogue (b)'s accumulation, in plain torch: CTA b of ``grid`` walks
    pairs [real b / grid, real (b + 1) / grid), sums its pairs' row counts
    over each run of equal pair_a, and flushes a run (rows < len, nonzero,
    below N) when pair_a changes or its range ends."""
    cs = torch.from_numpy(x["state"].copy())
    (counts,) = dense_tile.dense_tile_distance_plain(*_tensors(x, "tiles", "lens", "pa", "pb"), eps=eps,
                                                     dim_block=db, num_dims=n)
    n_sorted, t = cs.shape[0] - 1, counts.shape[1]

    def flush(ta, run):
        for r in range(min(int(x["lens"][ta]), t)):
            idx = int(x["starts"][ta]) + r
            if run[r] and idx < n_sorted:
                cs[idx] += run[r]

    for b in range(grid):
        cur, run = -1, None
        for p in range(real * b // grid, real * (b + 1) // grid):
            ta = int(x["pa"][p])
            if ta != cur:
                if cur >= 0:
                    flush(cur, run)
                cur, run = ta, torch.zeros(t, dtype=torch.int32)
            run += counts[p]
        if cur >= 0:
            flush(cur, run)
    return cs.numpy()


def emulate_pairs_split(x, real, eps, db, n, offset0, cap, hit_cap, grid):
    """Epilogue (c) as the kernel runs it, in plain Python: pass 1's row
    counts and per-pair totals; then per CTA of ``grid`` the hits of the
    pairs before its range (CTA 0: the chunk's total, which moves offset and
    max_chunk_hits), the walk over its pairs that skips those without hits
    and stops once a pair's first rank reaches hit_cap, and per pair the
    exclusive scan of its row counts and each row's hits in column order."""
    counts, mask = dense_tile.dense_tile_distance_plain(*_tensors(x, "tiles", "lens", "pa", "pb"), eps=eps,
                                                        dim_block=db, return_mask=True, num_dims=n)
    buf, _, _ = pairs_state(torch, offset0, cap, hit_cap, device="cpu")
    buf = buf.numpy()
    rowcnt = counts[:real].numpy()
    pair_hits = rowcnt.sum(1)
    woff = min(offset0, cap)
    offset, mch = offset0, 3
    grid = min(grid, real)  # the kernel never runs more CTAs than pairs

    def landing(q, end, base):
        if base >= hit_cap:
            return end
        while q < end and pair_hits[q] == 0:
            q += 1
        return q

    for b in range(grid):
        beg, end = real * b // grid, real * (b + 1) // grid
        s = int(pair_hits[:real if b == 0 else beg].sum())
        base = 0 if b == 0 else s
        if b == 0:
            offset, mch = offset0 + s, max(mch, s)
        p = landing(beg, end, base)
        while p < end:
            next_base = base + int(pair_hits[p])
            nxt = landing(p + 1, end, next_base)
            ex = np.cumsum(rowcnt[p]) - rowcnt[p]
            sa, sb = int(x["starts"][x["pa"][p]]), int(x["starts"][x["pb"][p]])
            for i in range(mask.shape[1]):
                rank = base + int(ex[i])
                for j in np.nonzero(mask[p, i].numpy())[0]:
                    if rank < hit_cap:
                        buf[woff + rank] = (x["point_order"][sa + i], x["point_order"][sb + j])
                    rank += 1
            p, base = nxt, next_base
    return buf, offset, mch


@pytest.mark.parametrize("grid", [1, 3, 7, 64, 300])
def test_kernel_split_into_ranges_equals_plain_steps(grid):
    t, n, db, order, c, real = 16, 20, 4, "dense", 200, 187
    x = _case(t, n, db, order, c, seed=grid)
    for eps in x["eps"]:
        cs = torch.from_numpy(x["state"].copy())
        dense_tile.dense_count_scatter_plain(cs, *_tensors(x, "tiles", "lens", "starts", "pa", "pb"), real, eps,
                                             dim_block=db, num_dims=n)
        np.testing.assert_array_equal(emulate_count_split(x, real, eps, db, n, grid), cs.numpy())
        nh = _hits(x, real, eps, db, n)
        for name, offset0, cap, hit_cap in pairs_states(nh):
            want = _port_pairs(x, real, eps, db, n, offset0, cap, hit_cap)
            got = emulate_pairs_split(x, real, eps, db, n, offset0, cap, hit_cap, grid)
            np.testing.assert_array_equal(got[0], want[0], err_msg=name)
            assert got[1:] == want[1:], name


@pytest.mark.parametrize("backend", ["pallas", "jnp", "dense", "dense_jnp"])
def test_pairs_step_off_the_card_is_pairs_chunk_step(backend):
    """Off the card ``pairs_step`` binds ``pairs_chunk_step`` (on the card
    the dense tier binds a ``DensePairsCompact``, tests/test_torch_cuda.py)."""
    t, n, db, order, c, real = CASES[2]
    x = _case(t, n, db, order, c, seed=5)
    tabs = _tensors(x, "tiles", "lens", "starts", "point_order")
    pa, pb = _tensors(x, "pa", "pb")
    eps = x["eps"][0]
    outs = []
    for bound in (True, False):
        buf, offset, mch = pairs_state(torch, 3, 4000, 512, device="cpu")
        if bound:
            step = engine.pairs_step(buf, offset, mch, *tabs, eps, hit_cap=512, dim_block=db, backend=backend,
                                     chunk=c, num_dims=n)
            assert not isinstance(step, dense_tile.DensePairsCompact)
            step(pa, pb, real)
        else:
            engine.pairs_chunk_step(buf, offset, mch, *tabs, pa, pb, real, eps, hit_cap=512, dim_block=db,
                                    backend=backend)
        outs.append((buf, offset, mch))
    for got, want in zip(*outs):
        assert torch.equal(got, want)
    assert int(outs[0][1]) > 3


# (T, num_dims, slab): whole rows up to the 227 KB of a block's shared
# memory, 32-dim slices past it
STAGING = [(64, 16, 0), (64, 300, 0), (64, 301, 32), (128, 148, 0), (128, 149, 32), (16, 1204, 0),
           (16, 1205, 32), (100, 150, 32)]


@pytest.mark.parametrize("t,num_dims,slab", STAGING)
def test_dense_staging_is_chosen_by_shape(t, num_dims, slab):
    assert dense_tile.dense_staging(t, num_dims) == slab


def test_dense_steps_refuse_cpu_tables_and_wrong_state():
    x = _case(16, 9, 8, "dense", 40, 33)
    tiles, lens, starts, order = _tensors(x, "tiles", "lens", "starts", "point_order")
    buf, offset, mch = pairs_state(torch, 0, 100, 64, device="cpu")
    with pytest.raises(ValueError, match="cuda"):
        dense_tile.DenseCountScatter(torch.zeros(10, dtype=torch.int32), tiles, lens, starts, 0.1, dim_block=8)
    with pytest.raises(ValueError, match="cuda"):
        dense_tile.DensePairsCompact(buf, offset, mch, tiles, lens, starts, order, 0.1, hit_cap=64, chunk=40,
                                     dim_block=8)
    with pytest.raises(ValueError, match="multiple of dim_block"):
        dense_tile.DenseCountScatter(torch.zeros(10, dtype=torch.int32), tiles, lens, starts, 0.1, dim_block=5)
    with pytest.raises(ValueError, match="outside"):
        distance_tile.check_chunk(*_tensors(x, "pa", "pb"), 41, torch.device("cpu"))


@pytest.mark.parametrize("n,dim_block", [(16, 32), (20, 8)])
def test_engine_dense_pairs_equal_reference_in_order(n, dim_block):
    """The dense tier end to end on the CPU, small chunks firing both
    retries: pair arrays equal the JAX engine's row for row."""
    d = make_dataset("clustered", 500, n, seed=n)  # 1/64-quantized
    kw = dict(eps=0.25, k=3, tile_size=16, dim_block=dim_block, execution="dense")
    eng = dict(count_chunk=32, pairs_chunk=24)
    ref = ref_core.SelfJoinEngine(d, ref_core.SelfJoinConfig(**kw), ref_core.EngineConfig(**eng))
    port = SelfJoinEngine(d, SelfJoinConfig(**kw), EngineConfig(**eng), device="cpu")
    for cap in (None, 1000):
        want, got = ref.pairs(_cap_hint=cap), port.pairs(_cap_hint=cap)
        np.testing.assert_array_equal(got.pairs, want.pairs)
        assert got.stats.overflow_retries == want.stats.overflow_retries
        assert got.stats.num_device_dispatches == want.stats.num_device_dispatches
    assert got.stats.overflow_retries > 0
    np.testing.assert_array_equal(port.count().counts, ref.count().counts)
