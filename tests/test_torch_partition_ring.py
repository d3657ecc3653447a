"""PyTorch port vs the JAX package: entity partition and the ring transport.

``make_partition``, ``assign_dynamic`` and ``simulate_scaling`` equal
``repro.core.partition`` with ``==``; ``_local_counts`` equals the
reference's on one CPU device.  ``ring_self_join_counts`` runs on 8 gloo
processes (and on a one-rank group), each spawned as its own Python
process with a ``file://`` init method, and must equal the float64 brute
force on a 1003 x 16 exponential set at eps 0.06 with ``row_block=128``
(1003 rows over 8 ranks: the sentinel padding path).  Every multi-process
test has its own deadline: past it every rank is killed and the test fails.
"""
import json
import os
import subprocess
import sys
import textwrap
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracles import brute_counts, make_dataset
from repro.core import partition as ref_partition
from repro.core.distributed import _local_counts as ref_local_counts
from repro.core.distributed import ring_comm_elements as ref_ring_comm_elements
from repro_torch.core import assign_dynamic, make_partition, simulate_scaling
from repro_torch.core.distributed import _local_counts, _ring_perm, ring_comm_elements
from repro_torch.data import exponential_dataset

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RING_DEADLINE_S = 120.0


@pytest.mark.parametrize("num_points,num_workers,num_batches", [
    (10_000, 8, 32), (1_000, 4, 32), (1_000, 7, 30), (5, 8, 8), (0, 3, 4), (1003, 3, 1), (1, 1, 1),
])
def test_make_partition_equals_reference(num_points, num_workers, num_batches):
    want = ref_partition.make_partition(num_points, num_workers, num_batches)
    got = make_partition(num_points, num_workers, num_batches)
    assert (got.num_batches, got.num_workers) == (want.num_batches, want.num_workers)
    for name in ("batch_bounds", "assignment"):
        w, g = getattr(want, name), getattr(got, name)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w, err_msg=name)
    for w in range(num_workers):
        assert got.batches_of(w) == want.batches_of(w)
    assert [got.query_range(b) for b in range(got.num_batches)] == [
        want.query_range(b) for b in range(want.num_batches)]


def test_make_partition_rejects_no_workers():
    with pytest.raises(ValueError, match="num_workers must be >= 1"):
        make_partition(10, 0, 4)


@pytest.mark.parametrize("workers", [1, 2, 3, 8])
def test_assign_dynamic_equals_reference(workers):
    rng = np.random.default_rng(workers)
    costs = np.concatenate([rng.exponential(1.0, 61), np.full(3, 2.5)])  # ties included
    want = ref_partition.assign_dynamic(costs, workers)
    got = assign_dynamic(costs, workers)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("assignment", ["round_robin", "dynamic"])
def test_simulate_scaling_equals_reference(assignment):
    rng = np.random.default_rng(7)
    costs = rng.exponential(14.0, 128)
    workers = [1, 2, 4, 8, 16, 32]
    assert simulate_scaling(costs, workers, assignment) == ref_partition.simulate_scaling(
        costs, workers, assignment)


def test_ring_comm_elements_and_perm():
    assert ring_comm_elements(1000, 8) == ref_ring_comm_elements(1000, 8) == 7000
    assert list(_ring_perm(4)) == [(0, 1), (1, 2), (2, 3), (3, 0)]
    assert list(_ring_perm(1)) == [(0, 0)]


@pytest.mark.parametrize("row_block", [1, 64, 128, 1024])
@pytest.mark.parametrize("nq,ne", [(301, 257), (128, 1), (0, 40)])
def test_local_counts_equal_reference(nq, ne, row_block):
    q = make_dataset("exponential", max(nq, 1), 16, seed=3)[:nq]
    e = make_dataset("exponential", ne, 16, seed=4)
    eps2 = 0.1 ** 2
    want = np.asarray(ref_local_counts(jnp.asarray(q), jnp.asarray(e), eps2, row_block))
    got = _local_counts(torch.from_numpy(q), torch.from_numpy(e), eps2, row_block)
    assert got.dtype == torch.int32 and got.shape == (nq,)
    np.testing.assert_array_equal(got.numpy(), want)


# -- ring_self_join_counts on gloo processes ---------------------------------

WORKER = textwrap.dedent(
    """
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core import DistributedSelfJoinEngine, SelfJoinConfig
    from repro_torch.core.distributed import ring_of, ring_scan, ring_self_join_counts
    from repro_torch.data import exponential_dataset

    rank, world, init, case, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        D = exponential_dataset(1003, 16, seed=5)
        extra = {}
        if case.startswith("mesh"):
            mesh = DeviceMesh("cpu", torch.arange(world).reshape(2, world // 2), mesh_dim_names=("pod", "data"))
            axes = ("pod", "data") if case == "mesh" else "data"
            counts = ring_self_join_counts(D, 0.06, mesh, axes, row_block=128, device="cpu")
            ring = ring_of(mesh, axes)
            eng = DistributedSelfJoinEngine(D[:40], SelfJoinConfig(eps=0.06, k=4), mesh=mesh, axes=axes, device="cpu")
            extra["engine_workers"] = eng.num_workers
        else:
            group = dist.group.WORLD
            counts = ring_self_join_counts(D, 0.06, group, row_block=128, device="cpu",
                                           overlap=case == "overlap")
            ring = ring_of(group)
        # the schedule: in round r position j holds the payload of (j - r) mod p;
        # a dict payload of two tensors moves as one
        def body(r, seen, payload):
            return seen + [(r, int(payload["pos"][0]), float(payload["x"].sum()))]

        payload = {"pos": torch.tensor([ring.position]), "x": torch.full((3, 2), float(ring.position))}
        extra["seen"] = ring_scan(ring, body, [], payload, overlap=case == "overlap")
        extra["ring"] = list(ring.ranks)
        extra["position"] = ring.position
        np.save(f"{out}/{rank}.npy", counts)
        with open(f"{out}/{rank}.json", "w") as fh:
            json.dump(extra, fh)
    finally:
        dist.destroy_process_group()
    """
)


def _run_ring(tmp_path, world, case):
    """Spawn ``world`` ranks of WORKER; kill them all past the deadline."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=SRC, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(r), str(world), init, case, str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        )
        for r in range(world)
    ]
    deadline = time.monotonic() + RING_DEADLINE_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"{world}-rank ring ({case}) passed its {RING_DEADLINE_S:.0f} s deadline")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}: {p.stdout.read().decode()[-3000:]}"
    return [
        (np.load(tmp_path / f"{r}.npy"), json.loads((tmp_path / f"{r}.json").read_text()))
        for r in range(world)
    ]


@pytest.fixture(scope="module")
def ring_truth():
    return brute_counts(exponential_dataset(1003, 16, seed=5), 0.06)


@pytest.mark.parametrize("world,case", [
    (8, "group"),      # 1-D: the default group, ring in rank order
    (8, "overlap"),    # the same, each exchange issued before the round's body
    (8, "mesh"),       # 2 x 4 DeviceMesh, the ring over ("pod", "data"): 8 positions
    (8, "mesh_data"),  # the same mesh, a ring over "data" alone in each pod
    (1, "group"),      # one rank: the identity ring, no point-to-point op
])
def test_ring_self_join_counts_on_gloo(tmp_path, ring_truth, world, case):
    results = _run_ring(tmp_path, world, case)
    for rank, (counts, extra) in enumerate(results):
        assert counts.dtype == np.int64
        np.testing.assert_array_equal(counts, ring_truth, err_msg=f"rank {rank}")
        p = len(extra["ring"])
        j = extra["position"]
        assert extra["ring"][j] == rank
        # round r holds position (j - r) mod p's payload, both tensors of it
        assert extra["seen"] == [[r, (j - r) % p, 6.0 * ((j - r) % p)] for r in range(p)]
    rings = {tuple(extra["ring"]) for _, extra in results}
    if case == "mesh_data":
        assert rings == {(0, 1, 2, 3), (4, 5, 6, 7)}
        assert {extra["engine_workers"] for _, extra in results} == {4}
    else:
        assert rings == {tuple(range(world))}
    if case == "mesh":
        assert {extra["engine_workers"] for _, extra in results} == {8}
