"""PyTorch port vs the JAX package: the device-fused ring (``fused=True``).

Every rank of a ``torch.distributed`` group runs one worker's program.
Here the ranks are gloo processes on the CPU (``device="cpu"``: every
kernel through its plain PyTorch version), each spawned as its own Python
process with a ``file://`` init method; the launches run side by side and
share one deadline, past which every rank is killed and the tests fail.
The fused ring is held to account three ways, all with ``==``:

  * against the reference's pack: ``repro``'s
    ``DistributedSelfJoinEngine(..., fused=True)._pack_fused`` on a 1- and
    a 4-device mesh (its own subprocess, 4 simulated host devices).  Rank
    k's packed tables equal the reference's at index k, array for array,
    and the capacity seeds, chunk counts and stats equal its scalars;
  * against the reference's program run by hand: for each worker and
    round, ``repro.core.engine``'s count and pairs chunk programs
    (``backend="jnp"``, outside ``shard_map``, where they work on this
    tree) over the reference's packed tables: counts, each worker's
    buffer rows up to its cursor in order, the cursors and the max chunk
    hits;
  * against the port's host-driven engine and the brute force, on the
    ``oracles.DATASET_CASES`` matrix spread over 1, 4 and 8 ranks (a 2 x 4
    ``DeviceMesh`` over ("pod", "data") among them), both assignments,
    eps 0 on duplicated points and |D| < |p|; then the eps sweep, the
    forced capacity retry and its warm rejoin, the explicit ``max_pairs``
    text on both paths, the constructor's errors, ``knn`` and the spans.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from oracles import DATASET_CASES, brute_counts, brute_pairs, brute_topk, make_dataset, pair_set
from repro_torch.core import DistributedSelfJoinEngine, SelfJoinConfig

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
DEADLINE_S = 300.0
DATA = {name: (d, eps) for name, d, eps in DATASET_CASES}


def _cfg(**kw):
    kw.setdefault("k", 4)
    kw.setdefault("tile_size", 16)
    kw.setdefault("dim_block", 8)
    return kw


# name: (data, eps, config, workers, assignment, mesh, steps).  The matrix
# spreads ranks, assignments and cases over the datasets instead of
# crossing them; the launches are one per ring size.
JOBS = {
    "exp16_p1": ("exp16", 0.06, _cfg(), 1, "round_robin", "group", ("pack", "sweep", "knn")),
    "duplicated6_p1": ("duplicated6", 0.1, _cfg(), 1, "dynamic", "group", ()),
    "eps0_duplicated_p1": (("duplicated", 90, 6, 3), 0.0, _cfg(k=3, tile_size=8), 1, "round_robin", "group", ()),
    "single_point_p1": (("uniform", 1, 5, 3), 0.1, _cfg(k=3, tile_size=8), 1, "round_robin", "group", ()),
    "exp16_p4": ("exp16", 0.06, _cfg(), 4, "round_robin", "group",
                 ("pack", "sweep", "retry", "max_pairs", "knn", "errors", "empty")),
    "exp16_dynamic_p4": ("exp16", 0.06, _cfg(), 4, "dynamic", "group", ("pack",)),
    "uniform8_p4": ("uniform8", 0.3, _cfg(), 4, "round_robin", "group", ("max_pairs",)),
    "clustered32_mesh_p8": ("clustered32", 0.25, _cfg(), 8, "round_robin", "pod_data", ("knn",)),
    "constantdims8_p8": ("constantdims8", 0.2, _cfg(), 8, "dynamic", "group", ()),
    "tiny_p8": (("exponential", 5, 16, 4), 0.3, _cfg(), 8, "round_robin", "group", ()),
}
REF_JOBS = ("exp16_p1", "exp16_p4", "exp16_dynamic_p4")


def _data(job):
    spec, eps = JOBS[job][0], JOBS[job][1]
    return (DATA[spec][0] if isinstance(spec, str) else make_dataset(*spec)), eps


WORKER = textwrap.dedent(
    """
    import dataclasses, pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import obs
    from repro_torch.core import DistributedSelfJoinEngine, EngineConfig, SelfJoinConfig

    rank, world, init, jobs, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)


    def result(res):
        return {"counts": res.counts, "pairs": res.pairs, "stats": dataclasses.asdict(res.stats)}


    def error(fn):
        try:
            fn()
        except (RuntimeError, ValueError) as exc:
            return f"{type(exc).__name__}: {exc}"
        return None


    def numpy(tables):
        return [a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a) for a in tables]


    try:
        got = {}
        for job in pickle.load(open(jobs, "rb")):
            d, eps, steps = np.load(job["data"]), job["eps"], job["steps"]
            if job["mesh"] == "pod_data":
                mesh = DeviceMesh("cpu", torch.arange(world).reshape(2, world // 2), mesh_dim_names=("pod", "data"))
                axes = ("pod", "data")
            else:
                mesh, axes = dist.group.WORLD, "data"
            cfg = SelfJoinConfig(**job["cfg"])
            kw = dict(mesh=mesh, axes=axes, assignment=job["assignment"], device="cpu")
            de = DistributedSelfJoinEngine(d, cfg, fused=True, **kw)
            r = {"position": de._ring.position}
            with obs.capture() as cap:
                r["count"] = result(de.count())
                r["pairs"] = result(de.self_join_pairs())
            r["obs"] = {
                "dispatch_spans": cap.span_count(cat="dispatch"),
                "metric": cap.metric("selfjoin_device_dispatches_total", path="ring_fused"),
                "pack": cap.span_count("ring.pack", "plan"),
                "pack_plan": [(e.attrs["worker"], e.attrs["round"]) for e in cap.spans("ring.pack.plan", "ring")],
                "programs": sorted({e.attrs["program"] for e in cap.spans("ring.trace", "compile")}),
            }
            if "pack" in steps:
                pack = de._fused_pack
                r["pack"] = {"args": numpy(pack["args"]), "pairs_args": numpy(pack["pairs_args"]),
                             **{k: pack[k] for k in ("pairs_cap", "pairs_est", "n_chunks", "n_chunks_p", "stats",
                                                     "pairs_hit_est", "pairs_flat_per_chunk")}}
            if "sweep" in steps:
                r["sweep"] = {"count": result(de.count(eps / 2)), "pairs": result(de.self_join_pairs(eps=eps / 2)),
                              "again": result(de.self_join_pairs()),
                              "traces": (de.fused_traces, de.fused_pairs_traces),
                              "executions": (de.fused_executions, de.fused_pairs_executions)}
            if "retry" in steps:
                de._fused_pack["pairs_cap"] = 64
                de._fused_pack.pop("pairs_warm", None)
                r["retry"] = {"forced": result(de.self_join_pairs()), "warm": result(de.self_join_pairs())}
            if "max_pairs" in steps:
                r["max_pairs"] = {"fused": error(lambda: de.self_join_pairs(max_pairs=8)),
                                  "host": error(lambda: de.self_join_pairs(max_pairs=8, fused=False))}
            if "knn" in steps:
                kn = de.knn(5)
                r["knn"] = {"indices": kn.indices, "distances": kn.distances, "eps_rounds": kn.eps_rounds}
            if "empty" in steps:
                de0 = DistributedSelfJoinEngine(np.zeros((0, d.shape[1]), np.float32), cfg, fused=True, **kw)
                c0, p0 = de0.count(), de0.self_join_pairs()
                r["empty"] = {"counts": c0.counts.shape, "pairs": p0.pairs.shape,
                              "dispatches": (c0.stats.num_device_dispatches, p0.stats.num_device_dispatches),
                              "traces": (de0.fused_traces, de0.fused_pairs_traces)}
            if "errors" in steps:
                r["errors"] = {"workers": error(lambda: DistributedSelfJoinEngine(
                    d, cfg, fused=True, num_workers=world + 1, **kw))}
            got[job["name"]] = r
        with open(f"{out}/{rank}.pkl", "wb") as fh:
            pickle.dump(got, fh)
    finally:
        dist.destroy_process_group()
    """
)

REFERENCE = textwrap.dedent(
    """
    import pickle, sys
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from repro.core import DistributedSelfJoinEngine, SelfJoinConfig
    from repro.core.engine import _count_chunk_program, _pairs_chunk_program

    out = {}
    for job in pickle.load(open(sys.argv[1], "rb")):
        d, eps, p = np.load(job["data"]), job["eps"], job["workers"]
        cfg = SelfJoinConfig(**job["cfg"])
        de = DistributedSelfJoinEngine(d, cfg, mesh=Mesh(np.array(jax.devices()[:p]), ("data",)), fused=True,
                                       assignment=job["assignment"])
        pack = de._pack_fused(eps)
        args = [np.asarray(a) for a in pack["args"]]
        pairs_args = [np.asarray(a) for a in pack["pairs_args"]]
        qt, qstart, qlen, qord, pq, pd, real, dt, dlen = args
        qog, pqp, pdp, realp, dstart, dord = (pairs_args[i] for i in (3, 4, 5, 6, 9, 10))
        max_nq = qord.shape[-1]
        # the reference's rank program by hand, worker by worker, round by
        # round: the chunk programs it runs, outside shard_map
        hit_cap = pack["pairs_flat_per_chunk"]
        cap = d.shape[0] * d.shape[0]
        counts = np.zeros(d.shape[0], np.int64)
        bufs, cursors, max_hits = [], [], []
        for k in range(p):
            local = jnp.zeros(max_nq, jnp.int32)
            buf = jnp.zeros((cap + hit_cap, 2), jnp.int32)
            off = mh = jnp.zeros((), jnp.int32)
            for r in range(p):
                j = (k - r) % p
                tiles = jnp.concatenate([qt[k, r], dt[j]])
                tlen = jnp.concatenate([qlen[k, r], dlen[j]])
                tstart = jnp.concatenate([qstart[k, r], np.zeros_like(dlen[j])])
                cs, sk = jnp.zeros(max_nq, jnp.int32), jnp.zeros((), jnp.int32)
                for c in range(pq.shape[2]):
                    cs, sk = _count_chunk_program(
                        cs, sk, tiles, tlen, tstart, pq[k, r, c], pd[k, r, c], real[k, r, c], jnp.float32(eps),
                        dim_block=cfg.dim_block, shortc=cfg.shortc, backend="jnp", interpret=True)
                local = local.at[qord[k, r]].add(cs, mode="drop")
                tstart = jnp.concatenate([qstart[k, r], dstart[j] + max_nq])
                order = jnp.concatenate([qog[k, r], dord[j]])
                for c in range(pqp.shape[2]):
                    buf, off, mh = _pairs_chunk_program(
                        buf, off, mh, tiles, tlen, tstart, order, pqp[k, r, c], pdp[k, r, c], realp[k, r, c],
                        jnp.float32(eps), hit_cap=hit_cap, dim_block=cfg.dim_block, backend="jnp", interpret=True)
            idx = de.worker_query_index(k)
            counts[idx] = np.asarray(local)[: idx.size]
            bufs.append(np.asarray(buf)[: int(off)])
            cursors.append(int(off))
            max_hits.append(int(mh))
        out[job["name"]] = {
            "args": args, "pairs_args": pairs_args, "counts": counts, "bufs": bufs, "cursors": cursors,
            "max_hits": max_hits,
            **{k: pack[k] for k in ("pairs_cap", "pairs_est", "n_chunks", "n_chunks_p", "stats", "pairs_hit_est",
                                    "pairs_flat_per_chunk")},
        }
    with open(sys.argv[2], "wb") as fh:
        pickle.dump(out, fh)
    """
)


def _spawn(script, argv, env):
    return subprocess.Popen([sys.executable, "-c", script, *argv], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, env=env)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every launch side by side: one gloo ring per ring size, and the
    reference's packs and hand-run programs.  Returns ``(port, ref)``:
    ``port[job][rank]`` is what that rank saved, ``ref[job]`` the
    reference's."""
    tmp = tmp_path_factory.mktemp("fused_ring")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=SRC, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    launches = {}
    for name, (_, eps, cfg, workers, assignment, mesh, steps) in JOBS.items():
        path = tmp / f"{name}.npy"
        np.save(path, _data(name)[0])
        launches.setdefault(workers, []).append(dict(
            name=name, data=str(path), eps=eps, cfg=dict(cfg, eps=eps), workers=workers, assignment=assignment, mesh=mesh,
            steps=steps))
    procs = []
    for world, jobs in launches.items():
        out = tmp / f"ring{world}"
        out.mkdir()
        (out / "jobs.pkl").write_bytes(pickle.dumps(jobs))
        init = f"file://{out / 'rendezvous'}"
        procs += [(f"rank {r} of {world}", _spawn(WORKER, [str(r), str(world), init, str(out / "jobs.pkl"), str(out)],
                                                    env))
                  for r in range(world)]
    (tmp / "ref_jobs.pkl").write_bytes(pickle.dumps([j for js in launches.values() for j in js if j["name"] in REF_JOBS]))
    procs.append(("the reference", _spawn(REFERENCE, [str(tmp / "ref_jobs.pkl"), str(tmp / "ref.pkl")], dict(
        env, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu"))))
    deadline = time.monotonic() + DEADLINE_S
    try:
        for _, p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pytest.fail(f"the fused-ring launches passed their {DEADLINE_S:.0f} s deadline")
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for what, p in procs:
        assert p.returncode == 0, f"{what}: {p.stdout.read().decode()[-3000:]}"
    port = {}
    for world, jobs in launches.items():
        ranks = [pickle.loads((tmp / f"ring{world}" / f"{r}.pkl").read_bytes()) for r in range(world)]
        for job in jobs:
            port[job["name"]] = [got[job["name"]] for got in ranks]
    return port, pickle.loads((tmp / "ref.pkl").read_bytes())


def _host(job):
    """The port's host-driven engine on the job's data (one process)."""
    _, eps, cfg, workers, assignment, _, _ = JOBS[job]
    d, _ = _data(job)
    return DistributedSelfJoinEngine(d, SelfJoinConfig(eps=eps, **cfg), num_workers=workers, assignment=assignment,
                                     device="cpu")


def _by_rank(port, job):
    """The job's per-rank results, each rank's ring position its worker."""
    got = port[job]
    assert [g["position"] for g in got] == list(range(len(got)))
    return got


# -- against the reference's pack ------------------------------------------------


@pytest.mark.parametrize("job", REF_JOBS)
def test_pack_equals_reference_array_for_array(runs, job):
    port, ref = runs
    want = ref[job]
    for k, got in enumerate(_by_rank(port, job)):
        pack = got["pack"]
        for what in ("args", "pairs_args"):
            assert len(pack[what]) == len(want[what])
            for i, (g, w) in enumerate(zip(pack[what], want[what])):
                assert g.dtype == w[k].dtype and g.shape == w[k].shape, (what, i)
                np.testing.assert_array_equal(g, w[k], err_msg=f"rank {k} {what}[{i}]")
        for name in ("pairs_cap", "pairs_est", "n_chunks", "n_chunks_p", "stats", "pairs_hit_est",
                     "pairs_flat_per_chunk"):
            assert tuple(np.atleast_1d(pack[name])) == tuple(np.atleast_1d(want[name])), name


@pytest.mark.parametrize("job", REF_JOBS)
def test_program_equals_reference_run_by_hand(runs, job):
    port, ref = runs
    want = ref[job]
    for got in _by_rank(port, job):
        np.testing.assert_array_equal(got["count"]["counts"], want["counts"])
        st = got["pairs"]["stats"]
        assert list(st["worker_pair_cursors"]) == want["cursors"]
        assert list(st["worker_max_chunk_hits"]) == want["max_hits"]
        # each worker's buffer up to its cursor, in order, in worker order
        np.testing.assert_array_equal(got["pairs"]["pairs"], np.concatenate(want["bufs"]))


@pytest.mark.parametrize("job", REF_JOBS)
def test_stats_take_the_reference_fused_values(runs, job):
    port, ref = runs
    want, host = ref[job], _host(job)
    p = JOBS[job][3]
    pairs_total, pairs_eval, candidates = want["stats"]
    for got in _by_rank(port, job):
        c, s = got["count"]["stats"], got["pairs"]["stats"]
        for st, n_chunks in ((c, want["n_chunks"]), (s, want["n_chunks_p"])):
            assert (st["num_tile_pairs_total"], st["num_tile_pairs_evaluated"], st["num_candidates"]) == (
                pairs_total, pairs_eval, candidates)
            assert st["num_chunks"] == p * n_chunks
            assert st["num_rounds"] == st["num_workers"] == p
            assert st["num_tiles"] == sum(e.snapshot.plan.num_tiles for e in host.shards if e.snapshot.plan)
            assert st["num_nonempty_cells"] == sum(e.snapshot.grid.num_cells for e in host.shards if e.snapshot.grid)
        assert c["num_device_dispatches"] == 1
        assert s["num_device_dispatches"] == 1 + s["overflow_retries"]
        assert s["pairs_capacity"] >= max(s["worker_pair_cursors"])


# -- against the host-driven engine and the brute force --------------------------


@pytest.mark.parametrize("job", list(JOBS))
def test_fused_equals_host_driven_and_brute_force(runs, job):
    port, _ = runs
    d, eps = _data(job)
    host = _host(job)
    want_count, want_pairs = host.count(), host.self_join_pairs()
    truth = pair_set(brute_pairs(d, eps))
    np.testing.assert_array_equal(want_count.counts, brute_counts(d, eps))
    assert pair_set(want_pairs.pairs) == truth
    for got in _by_rank(port, job):  # the same result on every rank
        c, s = got["count"], got["pairs"]
        assert c["counts"].dtype == np.int64 and s["pairs"].dtype == np.int32
        np.testing.assert_array_equal(c["counts"], want_count.counts)
        np.testing.assert_array_equal(s["counts"], want_count.counts)
        assert pair_set(s["pairs"]) == truth and len(s["pairs"]) == len(truth)
        for st, want in ((c["stats"], want_count.stats), (s["stats"], want_pairs.stats)):
            for name in ("num_points", "num_dims", "k", "num_workers", "num_rounds", "comm_elements",
                         "num_candidates_dense", "num_results", "num_tiles", "num_nonempty_cells"):
                assert st[name] == getattr(want, name), name
        assert sum(s["stats"]["worker_pair_cursors"]) == s["stats"]["num_results"]
        assert s["stats"]["overflow_retries"] == 0 and s["stats"]["num_device_dispatches"] == 1


def test_eps_sweep_reruns_the_same_programs(runs):
    port, _ = runs
    for job in ("exp16_p1", "exp16_p4"):
        d, eps = _data(job)
        for got in _by_rank(port, job):
            sw = got["sweep"]
            np.testing.assert_array_equal(sw["count"]["counts"], brute_counts(d, eps / 2))
            assert pair_set(sw["pairs"]["pairs"]) == pair_set(brute_pairs(d, eps / 2))
            np.testing.assert_array_equal(sw["again"]["pairs"], got["pairs"]["pairs"])
            # one build per program, every join one more execution
            assert sw["traces"] == (1, 1)
            assert sw["executions"] == (2, 3)
            assert sw["count"]["stats"]["num_device_dispatches"] == 1
            assert sw["pairs"]["stats"]["num_device_dispatches"] == 1


def test_forced_capacity_retry_and_warm_rejoin(runs):
    port, _ = runs
    got = _by_rank(port, "exp16_p4")
    for g in got:
        forced, warm = g["retry"]["forced"], g["retry"]["warm"]
        st = forced["stats"]
        assert max(st["worker_pair_cursors"]) > 64
        assert st["overflow_retries"] >= 1
        assert st["num_device_dispatches"] == 1 + st["overflow_retries"]
        assert st["pairs_capacity"] >= max(st["worker_pair_cursors"])
        np.testing.assert_array_equal(forced["pairs"], g["pairs"]["pairs"])
        # the converged (cap, hit_cap) is remembered: the next join is clean
        assert warm["stats"]["overflow_retries"] == 0 and warm["stats"]["num_device_dispatches"] == 1
        np.testing.assert_array_equal(warm["pairs"], g["pairs"]["pairs"])


@pytest.mark.parametrize("job", ["exp16_p4", "uniform8_p4"])
def test_explicit_max_pairs_raises_on_both_paths(runs, job):
    port, _ = runs
    for g in _by_rank(port, job):
        assert "RuntimeError" in g["max_pairs"]["fused"] and "max_pairs=8" in g["max_pairs"]["fused"]
        assert g["max_pairs"]["fused"].startswith("RuntimeError: fused ring worker found")
        assert g["max_pairs"]["host"] == "RuntimeError: result exceeded max_pairs=8; raise the cap or lower eps"


def test_constructor_and_routing_errors(runs):
    port, _ = runs
    d, eps = _data("exp16_p1")
    cfg = SelfJoinConfig(**_cfg(eps=eps))
    with pytest.raises(ValueError, match=r"fused=True needs a mesh \(one ring position per device\)"):
        DistributedSelfJoinEngine(d, cfg, num_workers=2, fused=True, device="cpu")
    host = DistributedSelfJoinEngine(d, cfg, num_workers=2, device="cpu")
    with pytest.raises(ValueError, match="fused=True requires an engine constructed with fused=True"):
        host.self_join_pairs(fused=True)
    for g in _by_rank(port, "exp16_p4"):
        assert g["errors"]["workers"] == "ValueError: fused=True requires num_workers == mesh ring size (5 != 4)"


def test_empty_engine_takes_the_host_path(runs):
    port, _ = runs
    for g in _by_rank(port, "exp16_p4"):
        assert g["empty"] == {"counts": (0,), "pairs": (0, 2), "dispatches": (0, 0), "traces": (0, 0)}


@pytest.mark.parametrize("job", ["exp16_p1", "exp16_p4", "clustered32_mesh_p8"])
def test_knn_matches_brute_topk(runs, job):
    port, _ = runs
    d, _ = _data(job)
    want_idx, want_dist = brute_topk(d, d, 5)
    for g in _by_rank(port, job):
        np.testing.assert_array_equal(g["knn"]["indices"], want_idx)
        np.testing.assert_array_equal(g["knn"]["distances"], want_dist)


@pytest.mark.parametrize("job", ["exp16_p1", "exp16_p4", "clustered32_mesh_p8"])
def test_spans_and_metrics(runs, job):
    port, _ = runs
    p = JOBS[job][3]
    for k, g in enumerate(_by_rank(port, job)):
        o = g["obs"]
        expect = g["count"]["stats"]["num_device_dispatches"] + g["pairs"]["stats"]["num_device_dispatches"]
        assert o["dispatch_spans"] == expect == o["metric"]
        # each rank records its own spans: one pack, its row of block plans
        assert o["pack"] == 1
        assert o["pack_plan"] == [(k, r) for r in range(p)]
        assert o["programs"] == ["fused_count", "fused_pairs"]
