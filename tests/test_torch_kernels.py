"""PyTorch port vs the JAX package: the plain versions of the four tile kernels.

On the CPU each kernel wrapper runs its plain PyTorch version (the CUDA
kernels themselves are held against these on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``).  Here every backend
string of ``repro.kernels.ops.eval_tile_pairs`` -- the Pallas kernels in
interpret mode (``"pallas"``, ``"dense"``) and their jnp twins (``"jnp"``,
``"dense_jnp"``) -- is compared with the port on the same numpy inputs over
the ``tests/test_kernels.py`` sweep.  Coordinates are 1/64-quantized, so
counts, skipped blocks and masks compare with ``==``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.kernels import dense_tile, distance_tile, ops
from repro_torch.kernels import ref as port_ref

SWEEP = [(t, n, db) for t in (8, 16, 32) for n, db in ((8, 8), (16, 8), (32, 16), (64, 32))]
# (port wrapper, its plain version, the JAX backends it must equal)
KERNELS = {
    "K1/K2": (distance_tile.tile_pair_distance, distance_tile.tile_pair_distance_plain, ("pallas", "jnp")),
    "K3/K4": (dense_tile.dense_tile_distance, dense_tile.dense_tile_distance_plain, ("dense", "dense_jnp")),
}


def _mk(num_tiles, t, n, seed, quantize=True):
    """The tests/test_kernels.py inputs: random tiles, lengths 1..T, 24 pairs."""
    rng = np.random.default_rng(seed)
    pts = rng.random((num_tiles, t, n), dtype=np.float32)
    if quantize:
        pts = np.round(pts * 64) / 64.0
    lens = rng.integers(1, t + 1, size=num_tiles).astype(np.int32)
    for i in range(num_tiles):
        pts[i, lens[i]:] = 0.0
    p = rng.integers(0, num_tiles, size=(24, 2)).astype(np.int32)
    return pts.astype(np.float32), lens, p[:, 0].copy(), p[:, 1].copy()


def _ref(backend, pts, lens, pa, pb, eps, db, return_mask):
    res = ref_ops.eval_tile_pairs(
        jnp.asarray(pts), jnp.asarray(lens), jnp.asarray(pa), jnp.asarray(pb), eps,
        dim_block=db, backend=backend, return_mask=return_mask, interpret=True,
    )
    return [np.asarray(r) for r in res]


def _port(fn, pts, lens, pa, pb, eps, db, return_mask):
    return [r.numpy() for r in fn(
        torch.from_numpy(pts), torch.from_numpy(lens), torch.from_numpy(pa), torch.from_numpy(pb),
        eps=eps, dim_block=db, return_mask=return_mask,
    )]


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("t,n,db", SWEEP)
def test_plain_kernels_match_every_reference_backend(kernel, t, n, db):
    wrapper, plain, backends = KERNELS[kernel]
    pts, lens, pa, pb = _mk(6, t, n, seed=t * 100 + n)
    eps = 0.31
    for return_mask in (False, True):
        got = _port(wrapper, pts, lens, pa, pb, eps, db, return_mask)
        # on CPU tensors the wrapper IS the plain version
        for g, w in zip(got, _port(plain, pts, lens, pa, pb, eps, db, return_mask)):
            np.testing.assert_array_equal(g, w)
        for backend in backends:
            want = _ref(backend, pts, lens, pa, pb, eps, db, return_mask)
            np.testing.assert_array_equal(got[0], want[0])          # counts (P, T)
            if kernel == "K1/K2":
                np.testing.assert_array_equal(got[1], want[1])      # skipped (P,)
            if return_mask:
                np.testing.assert_array_equal(got[-1], want[-1])    # mask (P, T, T)
                assert got[-1].dtype == np.int8


@pytest.mark.parametrize("backend", ref_ops.BACKENDS)
@pytest.mark.parametrize("shortc", [True, False])
def test_eval_tile_pairs_matches_reference(backend, shortc):
    """The backend strings dispatch alike, and ``shortc=False`` zeroes the stat."""
    pts, lens, pa, pb = _mk(8, 16, 24, seed=42)
    tiles, lens32 = ops.make_tiles(
        pts.reshape(-1, 24), np.arange(0, 8 * 16, 16, dtype=np.int64),
        np.asarray(lens, np.int64), 16, 8,
    )
    for return_mask in (False, True):
        want = ref_ops.eval_tile_pairs(
            jnp.asarray(tiles), jnp.asarray(lens32), jnp.asarray(pa), jnp.asarray(pb), 0.25,
            dim_block=8, shortc=shortc, backend=backend, return_mask=return_mask,
        )
        got = ops.eval_tile_pairs(
            torch.from_numpy(tiles), torch.from_numpy(lens32), torch.from_numpy(pa),
            torch.from_numpy(pb), 0.25,
            dim_block=8, shortc=shortc, backend=backend, return_mask=return_mask,
        )
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="unknown backend"):
        ops.eval_tile_pairs(
            torch.from_numpy(tiles), torch.from_numpy(lens32), torch.from_numpy(pa),
            torch.from_numpy(pb), 0.25, dim_block=8, backend="gpu",
        )


def test_shortcircuit_skips_far_tiles_like_reference():
    """Two clusters far apart: cross pairs stop after the first of 4 blocks,
    and padding pairs (empty tiles) stop there too, as in the reference."""
    t, n = 8, 32
    pts = np.zeros((3, t, n), np.float32)
    pts[1] = 0.90625
    lens = np.array([t, t, 0], np.int32)
    pa = np.array([0, 0, 1, 2], np.int32)
    pb = np.array([0, 1, 1, 0], np.int32)
    c, s = _port(distance_tile.tile_pair_distance, pts, lens, pa, pb, 0.05, 8, False)
    assert c[0].sum() == t * t and c[1].sum() == 0
    np.testing.assert_array_equal(s, [0, 3, 0, 3])
    for backend in ("pallas", "jnp"):
        want = _ref(backend, pts, lens, pa, pb, 0.05, 8, False)
        np.testing.assert_array_equal(c, want[0])
        np.testing.assert_array_equal(s, want[1])


@pytest.mark.parametrize("eps", [0.0, 0.37])
def test_eps_squared_rounds_like_reference(eps):
    """eps is rounded to f32 and squared in f32, as jnp.asarray(eps, f32) ** 2."""
    assert distance_tile.eps_squared(eps) == float(np.asarray(jnp.asarray(eps, jnp.float32) ** 2))
    assert distance_tile.eps_squared(0.1) != 0.1 * 0.1


def test_oracles_and_host_entry_points_match_reference():
    pts, lens, pa, pb = _mk(6, 16, 24, seed=7)
    eps = 0.4
    tp, lp, ap, bp = map(torch.from_numpy, (pts, lens, pa, pb))
    tj, lj, aj, bj = map(jnp.asarray, (pts, lens, pa, pb))
    np.testing.assert_array_equal(
        port_ref.ref_tile_mask(tp, lp, ap, bp, eps).numpy(),
        np.asarray(ref_ref.ref_tile_mask(tj, lj, aj, bj, eps)),
    )
    np.testing.assert_array_equal(
        port_ref.ref_tile_counts(tp, lp, ap, bp, eps).numpy(),
        np.asarray(ref_ref.ref_tile_counts(tj, lj, aj, bj, eps)),
    )
    np.testing.assert_array_equal(
        port_ref.matmul_sqdist(tp, tp).numpy(), np.asarray(ref_ref.matmul_sqdist(tj, tj))
    )
    np.testing.assert_array_equal(
        port_ref.direct_sqdist(tp, tp).numpy(), np.asarray(ref_ref.direct_sqdist(tj, tj))
    )
    # chunked host entry points, with a chunk that does not divide P
    for backend in ref_ops.BACKENDS:
        want = ref_ops.tile_counts(pts, lens, pa, pb, eps=eps, dim_block=8, backend=backend, chunk=5)
        got = ops.tile_counts(pts, lens, pa, pb, eps=eps, dim_block=8, backend=backend, chunk=5)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    want = list(ref_ops.tile_mask(pts, lens, pa, pb, eps=eps, dim_block=8, chunk=7))
    got = list(ops.tile_mask(pts, lens, pa, pb, eps=eps, dim_block=8, chunk=7))
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_wrappers_reject_what_the_kernels_cannot_take():
    pts, lens, pa, pb = _mk(3, 8, 12, seed=1)
    args = [torch.from_numpy(x) for x in (pts, lens, pa, pb)]
    for fn in (distance_tile.tile_pair_distance, dense_tile.dense_tile_distance):
        with pytest.raises(ValueError, match="multiple of dim_block"):
            fn(*args, eps=0.2, dim_block=8)
        with pytest.raises(ValueError, match="cpu or cuda"):
            fn(*[a.to("meta") for a in args], eps=0.2, dim_block=4)
