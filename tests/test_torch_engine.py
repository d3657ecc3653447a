"""PyTorch port vs the JAX package: ``self_join`` and ``SelfJoinEngine``
``count`` / ``pairs`` / ``query`` on the CPU, for every execution tier.

Both engines get the same numpy points; the port runs with
``device="cpu"`` (every kernel through its plain PyTorch version), the
reference with its default jnp backend.  Coordinates are 1/64-quantized,
so counts and pair sets compare with ``==``, and so do the work counters
of ``SelfJoinStats`` listed in ``STATS``.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro import obs as ref_obs
from oracles import brute_counts, brute_pairs, make_dataset, pair_set
from repro.core import batching as ref_batching
from repro.core.snapshot import GridSnapshot as RefSnapshot
from repro_torch import obs
from repro_torch.core import (
    EngineConfig,
    GridSnapshot,
    SelfJoinConfig,
    SelfJoinEngine,
    self_join,
    snapshot_from_numpy,
)
from repro_torch.core import batching

MODES = ("indexed", "dense", "auto")
STATS = (
    "num_points", "num_dims", "k", "num_nonempty_cells", "num_tiles",
    "num_tile_pairs_total", "num_tile_pairs_evaluated", "num_candidates",
    "num_candidates_dense", "num_results", "dim_blocks_skipped",
    "dim_blocks_total", "num_chunks", "num_device_dispatches",
    "pairs_capacity", "overflow_retries", "execution", "cost_indexed",
    "cost_dense",
)
SRC = Path(__file__).resolve().parents[1] / "src"


def _kw(eps, **kw):
    kw.setdefault("k", 6)
    kw.setdefault("tile_size", 16)
    kw.setdefault("dim_block", 8)
    return dict(eps=eps, **kw)


def _engines(d, kw, eng=None):
    ref = ref_core.SelfJoinEngine(
        d, ref_core.SelfJoinConfig(**kw), None if eng is None else ref_core.EngineConfig(**eng)
    )
    port = SelfJoinEngine(
        d, SelfJoinConfig(**kw), None if eng is None else EngineConfig(**eng), device="cpu"
    )
    return ref, port


def assert_same_result(want, got, pairs=False):
    assert got.counts.dtype == np.int64
    np.testing.assert_array_equal(got.counts, want.counts)
    for name in STATS:
        assert getattr(got.stats, name) == getattr(want.stats, name), name
    if pairs:
        assert got.pairs.dtype == np.int32 and got.pairs.shape == want.pairs.shape
        assert pair_set(got.pairs) == pair_set(want.pairs)


@pytest.mark.parametrize("mode", MODES)
def test_count_pairs_query_match_reference(dataset_case, mode):
    _, d, eps = dataset_case
    ref, port = _engines(d, _kw(eps, execution=mode))
    assert_same_result(ref.count(), port.count())
    got_p = port.pairs()
    assert_same_result(ref.pairs(), got_p, pairs=True)
    np.testing.assert_array_equal(got_p.counts, brute_counts(d, eps))
    sweep = [eps / 2, eps]
    for w, g in zip(ref.query(sweep, return_pairs=True), port.query(sweep, return_pairs=True)):
        assert_same_result(w, g, pairs=True)
    for w, g in zip(ref.query(sweep), port.query(sweep)):
        assert_same_result(w, g)


def test_self_join_wrapper_and_eps_growth_match_reference():
    d = make_dataset("exponential", 300, 16, seed=30)
    kw = _kw(0.06, k=4)
    for return_pairs in (False, True):
        want = ref_core.self_join(d, ref_core.SelfJoinConfig(**kw), return_pairs=return_pairs)
        got = self_join(d, SelfJoinConfig(**kw), return_pairs=return_pairs, device="cpu")
        assert_same_result(want, got, pairs=return_pairs)
    # a larger eps than the snapshot was built for rebuilds it, in both packages
    ref, port = _engines(d, kw)
    assert_same_result(ref.count(0.12), port.count(0.12))
    assert port.snapshot.index_eps == ref.snapshot.index_eps == 0.12
    assert port.snapshot.tile_rows == ref.snapshot.tile_rows


def test_small_chunks_fire_both_retries_like_reference(monkeypatch):
    """Tiny chunks plus a result-size estimate of 1: the rank window (hit_cap)
    and the buffer capacity both overflow, and both ladders retry alike."""
    d = make_dataset("uniform", 400, 4, seed=29)
    monkeypatch.setattr(ref_batching, "estimate_result_size", lambda *a, **k: 1)
    monkeypatch.setattr(batching, "estimate_result_size", lambda *a, **k: 1)
    eng = dict(count_chunk=7, pairs_chunk=40)  # hit_cap = min(40 * 16^2, 4096)
    ref, port = _engines(d, _kw(1.0, k=2), eng)
    with ref_obs.capture() as ref_cap, obs.capture() as cap:
        want = ref.pairs()
        got = port.pairs()
    assert_same_result(want, got, pairs=True)
    kinds = [e.attrs["kind"] for e in cap.spans(name="engine.pairs.retry")]
    assert kinds == [e.attrs["kind"] for e in ref_cap.spans(name="engine.pairs.retry")]
    assert "hit_cap" in kinds and "capacity" in kinds
    assert cap.span_count(cat="dispatch") == got.stats.num_device_dispatches
    assert got.stats.num_results > 4096
    assert_same_result(ref.count(), port.count())


def test_explicit_max_pairs_overflow_raises_like_reference():
    d = make_dataset("exponential", 300, 8, seed=28)
    ref, port = _engines(d, _kw(0.2, k=3))
    total = port.count().stats.num_results
    with pytest.raises(RuntimeError) as want:
        ref.pairs(max_pairs=total - 1)
    with pytest.raises(RuntimeError) as got:
        port.pairs(max_pairs=total - 1)
    assert str(got.value) == str(want.value)
    assert "max_pairs" in str(got.value)
    # the engine stays usable, and an exact cap suffices
    assert_same_result(ref.pairs(max_pairs=total), port.pairs(max_pairs=total), pairs=True)


@pytest.mark.parametrize("mode", MODES)
def test_eps_zero_duplicates_match_reference(mode):
    rng = np.random.default_rng(25)
    base = (np.round(rng.random((60, 6)) * 64) / 64).astype(np.float32)
    d = np.concatenate([base, base[:20], base[:5]])
    ref, port = _engines(d, _kw(0.0, k=3, tile_size=8, execution=mode))
    assert_same_result(ref.count(), port.count())
    got = port.pairs()
    assert_same_result(ref.pairs(), got, pairs=True)
    assert pair_set(got.pairs) == pair_set(brute_pairs(d, 0.0))


@pytest.mark.parametrize("n", [0, 1])
def test_empty_and_single_point_match_reference(n):
    d = make_dataset("uniform", 8, 8, seed=3)[:n]
    ref, port = _engines(d, dict(eps=0.1, k=2))
    assert_same_result(ref.count(), port.count())
    assert_same_result(ref.pairs(), port.pairs(), pairs=True)
    assert port.pairs().pairs.shape == (n, 2)


def test_dims_smaller_than_dim_block_match_reference():
    d = make_dataset("uniform", 300, 3, seed=27)  # n=3 pads to dim_block=32
    ref, port = _engines(d, dict(eps=0.2, k=2))   # default tile_size/dim_block
    assert_same_result(ref.count(), port.count())
    assert_same_result(ref.pairs(), port.pairs(), pairs=True)


def test_snapshot_carried_from_reference_gives_same_answers(dataset_case):
    """A snapshot built by the JAX package, carried over as numpy arrays."""
    _, d, eps = dataset_case
    kw = _kw(eps)
    ref_snap = RefSnapshot.build(d, ref_core.SelfJoinConfig(**kw))
    fields = {
        "pts": ref_snap.pts,
        "perm": ref_snap.perm,
        "index_eps": ref_snap.index_eps,
        "grid": dataclasses.asdict(ref_snap.grid),
        "plan": dataclasses.asdict(ref_snap.plan),
    }
    snap = snapshot_from_numpy(fields, SelfJoinConfig(**kw), device="cpu")
    assert snap.tile_rows == ref_snap.tile_rows
    np.testing.assert_array_equal(snap.tiles.numpy(), np.asarray(ref_snap.tiles))
    ref = ref_core.SelfJoinEngine.from_snapshot(ref_snap)
    port = SelfJoinEngine.from_snapshot(snap)
    assert_same_result(ref.count(), port.count())
    assert_same_result(ref.pairs(), port.pairs(), pairs=True)
    with pytest.raises(ValueError, match="different SelfJoinConfig"):
        port.swap_snapshot(snapshot_from_numpy(fields, SelfJoinConfig(**_kw(eps, k=2)), device="cpu"))


ALIASES = ("_pts", "_perm", "_index_eps", "_tiles", "_tile_len", "_tile_start", "_point_order",
           "_num_dim_blocks")


@pytest.mark.parametrize("mode", ["indexed", "dense"])
def test_engine_aliases_and_packed_tile_table_match_reference(dataset_case, mode):
    """The engine's read-only snapshot aliases and ``packed_tile_table``
    (padded past the real tiles) are ``==`` the reference's."""
    _, d, eps = dataset_case
    ref, port = _engines(d, _kw(eps, execution=mode))
    for name in ALIASES:
        want, got = getattr(ref, name), getattr(port, name)
        if want is None or isinstance(want, (int, float)):
            assert got == want, name
        else:
            got = got.numpy() if isinstance(got, torch.Tensor) else got
            assert got.dtype == np.asarray(want).dtype, name
            np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)
    rows = (port.plan.num_tiles if port.plan is not None else 0) + 3
    for want, got in zip(ref.packed_tile_table(rows), port.packed_tile_table(rows)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_entry_points_need_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    d = make_dataset("uniform", 20, 4, seed=1)
    cfg = SelfJoinConfig(eps=0.1, k=2)
    for call in (
        lambda: SelfJoinEngine(d, cfg),
        lambda: self_join(d, cfg),
        lambda: GridSnapshot.build(d, cfg),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert SelfJoinEngine(d, cfg, device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        SelfJoinEngine(d, cfg, device="meta")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.core.engine' in sys.modules\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
