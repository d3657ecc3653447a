"""K2's redesign in the PyTorch port against the JAX package, on the CPU.

On the card the indexed tier's pairs chunk step is ``distance_tile.PairsCompact``:
two launches of ``csrc/distance_tile_counts.cu`` epilogue (c), held against
its plain version by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
Here that plain version, ``tile_pair_pairs_compact_plain`` (per-pair hit
totals, an exclusive scan and an ordered write: the kernel's algorithm), is
compared with ``repro.core.engine.pairs_chunk_step`` (the reference's
rank-select) with backends ``"jnp"`` and ``"pallas"`` (the Pallas kernel in
interpret mode), on padded chunks with ``real < C``, ragged tile lengths,
``num_dims < n_pad``, one to five dim blocks with pairs that break SHORTC
after the first block, and five starting states of the pair buffer (more
hits than ``hit_cap``, a chunk that straddles ``cap``, ``offset`` past
``cap``).  The buffer compares row for row, order included, on every row the
reference defines (``chip_smoke.landed_rows``).  Coordinates are
1/64-quantized, so everything compares with ``==``.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
from oracles import make_dataset
from repro.core import batching as ref_batching
from repro.core import engine as ref_engine
from repro_torch.core import EngineConfig, SelfJoinConfig, SelfJoinEngine
from repro_torch.core import batching, engine
from repro_torch.kernels import dense_tile, distance_tile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import k1_case, landed_rows, pairs_state, pairs_states  # noqa: E402

# (T, n, dim_block, pair order, C, real): n < n_pad, n = 1, one to five dim
# blocks (dim blocks of 1 and 3: not multiples of 4), a ragged last tile,
# sorted and random pairs; k1_case's far tiles 0 / 1 break SHORTC after the
# first block wherever there are two or more
CASES = [
    (8, 9, 8, "sorted", 40, 33),
    (16, 1, 8, "random", 40, 40),
    (16, 20, 4, "sorted", 40, 29),
    (33, 17, 16, "random", 40, 35),
    (12, 6, 3, "sorted", 40, 40),
    (8, 3, 1, "sorted", 40, 37),
]
BACKENDS = ["jnp", "pallas"]
EPS = (0.3, 0.05)


def _case(t, n, db, order, c, seed):
    x = k1_case(torch, np, t, n, db, order, c, seed, device="cpu")
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in x.items()}


def _tensors(x, *keys):
    return [torch.from_numpy(x[k].copy()) for k in keys]


def _ref(x, *keys):
    return [jnp.asarray(x[k]) for k in keys]


def _hits(x, real, eps, db, n):
    counts, _ = distance_tile.tile_pair_distance_plain(*_tensors(x, "tiles", "lens", "pa", "pb"), eps=eps,
                                                       dim_block=db, num_dims=n)
    return int(counts[:real].sum())


def _port_pairs(x, real, eps, db, n, offset0, cap, hit_cap):
    buf, offset, mch = pairs_state(torch, offset0, cap, hit_cap, device="cpu")
    distance_tile.tile_pair_pairs_compact_plain(
        buf, offset, mch, *_tensors(x, "tiles", "lens", "starts", "point_order", "pa", "pb"), real, eps,
        hit_cap=hit_cap, dim_block=db, num_dims=n)
    return buf.numpy(), int(offset), int(mch)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("t,n,db,order,c,real", CASES)
def test_pairs_step_equals_reference(t, n, db, order, c, real, backend):
    x = _case(t, n, db, order, c, seed=t * 13 + n)
    seen = set()
    for eps in EPS:
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


def test_cases_break_shortc_after_the_first_block():
    """Every case with two or more dim blocks has a pair that SHORTC stops
    after its first block (so the pairs step's pass 1 must skip it)."""
    for t, n, db, order, c, real in CASES:
        x = _case(t, n, db, order, c, seed=t * 13 + n)
        blocks = x["tiles"].shape[2] // db
        _, skipped = distance_tile.tile_pair_distance_plain(*_tensors(x, "tiles", "lens", "pa", "pb"), eps=0.05,
                                                            dim_block=db, num_dims=n)
        assert blocks == 1 or (skipped[:real] == blocks - 1).any(), (t, n, db)


@pytest.mark.parametrize("t,n,db,order,c,real", CASES)
def test_plain_over_real_dims_equals_full_n_pad(t, n, db, order, c, real):
    x = _case(t, n, db, order, c, seed=t * 7 + n)
    args = _tensors(x, "tiles", "lens", "pa", "pb")
    tables = _tensors(x, "tiles", "lens", "starts", "point_order", "pa", "pb")
    for eps in EPS:
        full = distance_tile.tile_pair_distance_plain(*args, eps=eps, dim_block=db, return_mask=True)
        real_dims = distance_tile.tile_pair_distance(*args, eps=eps, dim_block=db, return_mask=True, num_dims=n)
        for f, r in zip(full, real_dims):
            assert torch.equal(f, r)
        bufs = []
        for num_dims in (None, n):
            st = pairs_state(torch, 5, 2000, 700, device="cpu")
            distance_tile.tile_pair_pairs_compact_plain(*st, *tables, real, eps, hit_cap=700, dim_block=db,
                                                        num_dims=num_dims)
            bufs.append(st)
        for f, r in zip(*bufs):
            assert torch.equal(f, r)


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
def test_pairs_step_off_the_card_is_pairs_chunk_step(backend):
    """Off the card ``pairs_step`` binds ``pairs_chunk_step`` for the indexed
    backends (on the card a ``PairsCompact``, tests/test_torch_cuda.py)."""
    t, n, db, order, c, real = CASES[2]
    x = _case(t, n, db, order, c, seed=5)
    tabs = _tensors(x, "tiles", "lens", "starts", "point_order")
    pa, pb = _tensors(x, "pa", "pb")
    eps = 0.3
    outs = []
    for bound in (True, False):
        buf, offset, mch = pairs_state(torch, 3, 4000, 512, device="cpu")
        if bound:
            step = engine.pairs_step(buf, offset, mch, *tabs, eps, hit_cap=512, dim_block=db, backend=backend,
                                     chunk=c, num_dims=n)
            assert not isinstance(step, distance_tile.PairsCompact)
            step(pa, pb, real)
        else:
            engine.pairs_chunk_step(buf, offset, mch, *tabs, pa, pb, real, eps, hit_cap=512, dim_block=db,
                                    backend=backend)
        outs.append((buf, offset, mch))
    for got, want in zip(*outs):
        assert torch.equal(got, want)
    assert int(outs[0][1]) > 3


def test_pairs_compact_refuses_cpu_tables_and_wrong_state():
    x = _case(16, 9, 8, "sorted", 40, 33)
    tiles, lens, starts, order = _tensors(x, "tiles", "lens", "starts", "point_order")
    buf, offset, mch = pairs_state(torch, 0, 100, 64, device="cpu")
    kw = dict(hit_cap=64, chunk=40, dim_block=8)
    for cls in (distance_tile.PairsCompact, dense_tile.DensePairsCompact):
        with pytest.raises(ValueError, match="runs on cuda"):
            cls(buf, offset, mch, tiles, lens, starts, order, 0.1, **kw)
        with pytest.raises(ValueError, match="float32"):
            cls(buf, offset, mch, tiles.double(), lens, starts, order, 0.1, **kw)
        with pytest.raises(ValueError, match="tile_len"):
            cls(buf, offset, mch, tiles, lens.long(), starts, order, 0.1, **kw)
        with pytest.raises(ValueError, match="point_order"):
            cls(buf, offset, mch, tiles, lens, starts, order.long(), 0.1, **kw)
        with pytest.raises(ValueError, match="tile_start must match"):
            cls(buf, offset, mch, tiles, lens, starts[:-1], order, 0.1, **kw)
        with pytest.raises(ValueError, match="buf must be"):
            cls(torch.zeros((164, 3), dtype=torch.int32), offset, mch, tiles, lens, starts, order, 0.1, **kw)
        with pytest.raises(ValueError, match="buf must be"):
            cls(buf, offset, mch, tiles, lens, starts, order, 0.1, hit_cap=0, chunk=40, dim_block=8)
        with pytest.raises(ValueError, match="offset must hold one value"):
            cls(buf, torch.zeros(2, dtype=torch.int32), mch, tiles, lens, starts, order, 0.1, **kw)
        with pytest.raises(ValueError, match="chunk must be positive"):
            cls(buf, offset, mch, tiles, lens, starts, order, 0.1, hit_cap=64, chunk=0, dim_block=8)
        with pytest.raises(ValueError, match="multiple of dim_block"):
            cls(buf, offset, mch, tiles, lens, starts, order, 0.1, hit_cap=64, chunk=40, dim_block=5)
    pa, pb = _tensors(x, "pa", "pb")
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="exceeds the bound chunk length 32"):
        distance_tile.check_chunk(pa, pb, 33, cpu, 32)
    with pytest.raises(ValueError, match="contiguous int32"):
        distance_tile.check_chunk(pa.long(), pb, 33, cpu, 40)
    distance_tile.check_chunk(pa, pb, 32, cpu, 32)


def _plain_pairs_step(buf, offset, max_chunk_hits, tiles, tile_len, tile_start, point_order, eps, *, hit_cap,
                      dim_block, backend, chunk, num_dims=None):
    """``engine.pairs_step`` as the card binds it for the indexed tier, with
    the fused step's plain version in place of its kernel."""
    assert backend in ("pallas", "jnp")

    def step(pa, pb, real):
        assert real <= chunk
        distance_tile.tile_pair_pairs_compact_plain(buf, offset, max_chunk_hits, tiles, tile_len, tile_start,
                                                    point_order, pa, pb, real, eps, hit_cap=hit_cap,
                                                    dim_block=dim_block, num_dims=num_dims)

    return step


@pytest.mark.parametrize("n,dim_block,retries", [(4, 4, 2), (6, 2, 1)])
def test_engine_pairs_through_the_fused_step_equal_reference_in_order(monkeypatch, n, dim_block, retries):
    """A whole indexed ``pairs()`` pass run chunk by chunk through the plain
    fused step: tiny chunks and a result-size estimate of 1 fire both
    retries at 4 dims (hit_cap, then capacity) and the capacity retry at 6
    dims in blocks of 2, where SHORTC breaks pairs; the pair array equals
    the JAX engine's row for row."""
    d = make_dataset("uniform", 400, n, seed=29 + n)  # 1/64-quantized
    monkeypatch.setattr(ref_batching, "estimate_result_size", lambda *a, **k: 1)
    monkeypatch.setattr(batching, "estimate_result_size", lambda *a, **k: 1)
    monkeypatch.setattr(engine, "pairs_step", _plain_pairs_step)
    kw = dict(eps=0.6, k=2, tile_size=16, dim_block=dim_block, execution="indexed")
    eng = dict(count_chunk=7, pairs_chunk=40)  # hit_cap = min(40 * 16^2, 4096)
    ref = ref_core.SelfJoinEngine(d, ref_core.SelfJoinConfig(**kw), ref_core.EngineConfig(**eng))
    port = SelfJoinEngine(d, SelfJoinConfig(**kw), EngineConfig(**eng), device="cpu")
    want, got = ref.pairs(), port.pairs()
    np.testing.assert_array_equal(got.pairs, want.pairs)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.stats.overflow_retries == want.stats.overflow_retries == retries
    assert got.stats.num_device_dispatches == want.stats.num_device_dispatches
    assert got.stats.num_results > 4096
    if n == 6:
        assert port.count().stats.dim_blocks_skipped > 0
