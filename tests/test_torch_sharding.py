"""PyTorch port vs the JAX package: the sharding rules, the meshes and the
cell specs (``repro_torch.sharding``, ``repro_torch.launch.{mesh,specs}``).

* ``param_specs`` (both ``fsdp`` values), ``cache_specs`` and ``batch_spec``
  equal the reference's leaf for leaf, for all ten archs at full config on
  both production meshes: the reference on ``jax.sharding.AbstractMesh``,
  the port on its ``ShapeMesh``, on abstract params (meta / fake tensors).
* ``to_placements`` gives, on every rank of a fake process group, the shard
  that ``NamedSharding.devices_indices_map`` gives the device at the same
  mesh coordinate.  The fake group runs in a subprocess: one default group
  per process, and xdist workers run several files.
* On a 2 x 2 ("data", "model") mesh of four gloo CPU processes, every
  arch's reduced config at fp32 has a sharded forward loss, and one sharded
  decode step's logits, within 1e-5 (relative to the largest) of the
  port's unsharded ones.  Each multi-process run has its own deadline.
"""
import json
import os
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

import repro.configs as ref_configs
import repro.models as ref_models
from repro.launch import specs as ref_specs
from repro.sharding import batch_spec as ref_batch_spec
from repro.sharding import cache_specs as ref_cache_specs
from repro.sharding import param_specs as ref_param_specs
from repro_torch import configs, models
from repro_torch.launch import specs
from repro_torch.sharding import ShapeMesh, batch_spec, cache_specs, param_specs
from repro_torch.sharding.rules import map_with_path

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
DEADLINE_S = 300.0
MESHES = {
    "pod1": ((16, 16), ("data", "model")),
    "pod2": ((2, 16, 16), ("pod", "data", "model")),
}


def _flat_ref(tree):
    out = {}
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    for path, spec in leaves:
        out[tuple(p.key if hasattr(p, "key") else p.idx for p in path)] = tuple(spec)
    return out


def _flat_port(tree):
    out = {}
    map_with_path(lambda path, spec: out.__setitem__(path, tuple(spec)), tree)
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_specs_equal_reference(arch, mesh_name):
    from torch._subclasses.fake_tensor import FakeTensorMode

    sizes, names = MESHES[mesh_name]
    ref_mesh, mesh = AbstractMesh(sizes, names), ShapeMesh(sizes, names)
    ref_cfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    ref_params, params = ref_models.abstract_params(ref_cfg), models.abstract_params(cfg)
    for fsdp in (False, True):
        want = _flat_ref(ref_param_specs(ref_params, ref_mesh, fsdp=fsdp))
        got = _flat_port(param_specs(params, mesh, fsdp=fsdp))
        assert got == want, f"fsdp={fsdp}"
    ref_caches = jax.eval_shape(lambda: ref_models.init_caches(ref_cfg, 128, 32_768))
    with FakeTensorMode():
        caches = models.init_caches(cfg, 128, 32_768, device="cpu")
    assert _flat_port(cache_specs(caches, mesh)) == _flat_ref(ref_cache_specs(ref_caches, ref_mesh))
    for shape in specs.SHAPES:
        got = _flat_port(batch_spec(specs.input_specs(cfg, shape).batch, mesh))
        want = _flat_ref(ref_batch_spec(ref_specs.input_specs(ref_cfg, shape).batch, ref_mesh))
        assert got == want, shape


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cell_specs_equal_reference(arch):
    assert specs.SHAPES == ref_specs.SHAPES and specs.AUDIO_FRAMES == ref_specs.AUDIO_FRAMES
    ref_cfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    for shape in specs.SHAPES:
        want, got = ref_specs.input_specs(ref_cfg, shape), specs.input_specs(cfg, shape)
        assert (got.arch, got.shape, got.kind, got.seq, got.global_batch, got.skip_reason) == (
            want.arch, want.shape, want.kind, want.seq, want.global_batch, want.skip_reason)
        assert got.skip_reason == ref_specs.applicable(ref_cfg, shape)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in got.batch.items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in want.batch.items()}
        assert all(v.device.type == "meta" for v in got.batch.values())
    want_mem, got_mem = ref_specs.memory_spec(ref_cfg, 8), specs.memory_spec(cfg, 8)
    if want_mem is None:
        assert got_mem is None
    else:
        assert (tuple(got_mem.shape), str(got_mem.dtype).split(".")[-1]) == (
            tuple(want_mem.shape), str(want_mem.dtype))


# -- to_placements on a fake group, beside NamedSharding ---------------------

PLACEMENT_CASES = {
    "pod2": ((2, 2, 2), ("pod", "data", "model")),
    "pod1": ((2, 4), ("data", "model")),
}

FAKE_WORKER = textwrap.dedent(
    """
    import json, sys
    import jax
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.testing._internal.distributed.fake_pg  # registers the "fake" backend
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP

    from repro_torch import configs, models
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh, mesh_desc
    from repro_torch.sharding import batch_spec, cache_specs, param_specs, to_placements
    from repro_torch.sharding.rules import map_with_path
    from torch.distributed.tensor import distribute_tensor

    cases = json.loads(sys.argv[1])
    out = {}
    for name, (sizes, names) in cases.items():
        sizes, names = tuple(sizes), tuple(names)
        world = int(np.prod(sizes))
        # the specs to check: the rules on reduced configs, and hand-made ones
        pairs = [((2 * world, 3 * world), (names[:-1], names[-1])),
                 ((world, 4, world), (names[-1], None, names[:-1]))]
        for arch in ("deepseek_v2_236b", "qwen3_32b"):
            cfg = configs.get_reduced_config(arch)
            params = models.init_params(cfg, device="cpu")
            caches = models.init_caches(cfg, 4, 16, device="cpu")
            batch = {"tokens": torch.zeros((8, 12), dtype=torch.int32)}
            dist.init_process_group("fake", store=dist.HashStore(), rank=0, world_size=world)
            mesh = torch.distributed.device_mesh.init_device_mesh("cpu", sizes, mesh_dim_names=names)
            for tree, tspecs in ((params, param_specs(params, mesh, fsdp=True)),
                                 (caches, cache_specs(caches, mesh)),
                                 (batch, batch_spec(batch, mesh))):
                flat = {}
                map_with_path(lambda p, s: flat.__setitem__(p, s), tspecs)
                map_with_path(lambda p, t: pairs.append((tuple(t.shape), tuple(flat[p]))), tree)
            dist.destroy_process_group()
        jmesh = Mesh(np.array(jax.devices()[:world]).reshape(sizes), names)
        bad = []
        for rank in range(world):
            dist.init_process_group("fake", store=dist.HashStore(), rank=rank, world_size=world)
            mesh = torch.distributed.device_mesh.init_device_mesh("cpu", sizes, mesh_dim_names=names)
            for shape, spec in pairs:
                glob = np.arange(int(np.prod(shape)), dtype=np.float64).reshape(shape)
                idx = NamedSharding(jmesh, JP(*spec)).devices_indices_map(shape)
                local = distribute_tensor(torch.from_numpy(glob), mesh, to_placements(spec, mesh),
                                          src_data_rank=None).to_local().numpy()
                want = glob[idx[jax.devices()[rank]]]
                if local.shape != want.shape or not np.array_equal(local, want):
                    bad.append([list(shape), repr(spec), rank, list(local.shape), list(want.shape)])
            dist.destroy_process_group()
        dist.init_process_group("fake", store=dist.HashStore(), rank=0, world_size=world)
        errors = []
        try:
            make_production_mesh(device_type="cpu")
        except RuntimeError as e:
            errors.append(str(e))
        test_mesh = make_test_mesh(world, device_type="cpu")
        out[name] = {"pairs": len(pairs), "bad": bad, "errors": errors,
                     "test_mesh": [list(test_mesh.shape), list(test_mesh.mesh_dim_names)],
                     "desc": mesh_desc(test_mesh)}
        dist.destroy_process_group()
    print("RESULT " + json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def placements_run():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=SRC, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run([sys.executable, "-c", FAKE_WORKER, json.dumps(PLACEMENT_CASES)],
                         capture_output=True, text=True, timeout=DEADLINE_S, env=env)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    line = [x for x in res.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("name", list(PLACEMENT_CASES))
def test_to_placements_match_named_sharding(placements_run, name):
    got = placements_run[name]
    assert got["pairs"] > 40
    assert got["bad"] == []


@pytest.mark.parametrize("name", list(PLACEMENT_CASES))
def test_meshes_on_fake_group(placements_run, name):
    got = placements_run[name]
    world = int(np.prod(PLACEMENT_CASES[name][0]))
    assert got["errors"] == [
        f"a 16x16 mesh needs a default process group of 256 ranks; the world size is {world}"]
    assert got["test_mesh"] == [[2, world // 2], ["data", "model"]]
    assert got["desc"] == f"data=2xmodel={world // 2}"


# -- sharded forward and decode on a 2 x 2 gloo mesh -------------------------

GLOO_WORKER = textwrap.dedent(
    """
    import dataclasses, json, sys
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import configs, models
    from repro_torch.launch import serve
    from repro_torch.models.model import tree_map
    from repro_torch.sharding import batch_spec, cache_specs, distribute, param_specs

    rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    torch.set_num_threads(1)

    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max())

    def seams(mesh):
        # the readout's placement, recurrentgemma at batch 1 and the sLSTM's
        # prefill, sharded against plain
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor
        from repro_torch.models import blocks as B, layers as L, recurrent as R
        from repro_torch.roofline import count_ops
        from repro_torch.train import make_serve_step

        def place(t, *pls):
            return distribute_tensor(t, mesh, list(pls), src_data_rank=None)

        def pls(t):
            return [repr(pl) for pl in t.placements]

        res = {}
        gen = torch.Generator().manual_seed(1)
        cfg = dataclasses.replace(configs.get_reduced_config("recurrentgemma_2b"), activation_dtype="float32")
        params = models.init_params(cfg, gen, "cpu")
        sp = distribute(params, param_specs(params, mesh), mesh, src_data_rank=None)
        # the tied readout: x whole but for its batch shards, the logits sharded as the table
        for name, x, xpl in (("batch", torch.randn(4, cfg.d_model, generator=gen), (Shard(0), Replicate())),
                             ("features", torch.randn(4, cfg.d_model, generator=gen), (Shard(1), Replicate())),
                             ("one", torch.randn(1, cfg.d_model, generator=gen), (Replicate(), Replicate()))):
            with torch.no_grad():
                want = L.unembed(params["embed"], x)
                got = L.unembed(sp["embed"], place(x, *xpl))
            res["unembed_" + name] = {"placements": pls(got), "rel": rel(got.full_tensor(), want)}
        # batch 1: the products split over "data" too, greedy tokens as plain
        batch = serve.make_batch(cfg, 1, 12, "cpu")
        sb = distribute(batch, batch_spec(batch, mesh), mesh, src_data_rank=None)
        step = make_serve_step(cfg)
        with torch.no_grad():
            _, caches, _ = models.prefill(params, batch, cfg, 20)
            with implicit_replication():
                _, scaches, _ = models.prefill(sp, sb, cfg, 20)
            tok = stok = batch["tokens"][:, -1].contiguous()
            toks, stoks = [], []
            for i in range(4):
                tok, logits, caches = step(params, caches, tok, 12 + i)
                with implicit_replication():
                    stok, slogits, scaches = step(sp, scaches, stok, 12 + i)
                stok = stok.full_tensor() if hasattr(stok, "full_tensor") else stok
                toks.append(tok.tolist())
                stoks.append(stok.tolist())
            res["rg_batch1"] = {"tokens": [toks, stoks], "logits_rel": rel(slogits.full_tensor(), logits)}
            blk = tree_map(lambda a: a[0], params["groups"][0][0])
            sblk = tree_map(lambda a: a[0], sp["groups"][0][0])
            h = torch.randn(1, 1, cfg.d_model, generator=gen)

            def products(p, h):
                rec = p["rec"]
                return [L.dense(rec["win1"], h), L.dense(rec["win2"], h), R._rglru_gates(rec["rglru"], h)[0],
                        L.dense(rec["wout"], h), L.swiglu(p["ffn"], h)]

            with count_ops() as plain:
                products(blk, h)
            with implicit_replication(), count_ops() as shard:
                outs = products(sblk, place(h, Replicate(), Replicate()))
            res["rg_batch1"].update(flops=[plain.costs.dot_flops, shard.costs.dot_flops],
                                    out_placements=[pls(t) for t in outs])
        # the sLSTM's prefill on local shards (4 pairs per rank of the model dim), batch 4 and 1
        cfg = dataclasses.replace(configs.get_reduced_config("xlstm_125m"), activation_dtype="float32")
        params = models.init_params(cfg, gen, "cpu")
        sp = distribute(params, param_specs(params, mesh), mesh, src_data_rank=None)
        cell = tree_map(lambda a: a[0], params["groups"][0][1])["cell"]
        scell = tree_map(lambda a: a[0], sp["groups"][0][1])["cell"]
        for b, xpl in ((4, Shard(0)), (1, Replicate())):
            x = torch.randn(b, 16, cfg.d_model, generator=gen)
            with torch.no_grad():
                y, st = R.slstm_seq(cell, x, cfg.num_heads)
                with implicit_replication():
                    sy, sst = R.slstm_seq(scell, place(x, xpl, Replicate()), cfg.num_heads)
            res[f"slstm_b{b}"] = {"y_rel": rel(sy.full_tensor(), y),
                                  "state_rel": max(rel(sst[k].full_tensor(), st[k]) for k in ("c", "n", "m", "h"))}
        return res

    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        res = {}
        # every rank draws the same weights and inputs, so each keeps its own
        # shards (src_data_rank=None) and nothing is scattered
        for arch in configs.ARCH_IDS:
            cfg = dataclasses.replace(configs.get_reduced_config(arch), activation_dtype="float32")
            params = models.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
            batch = serve.make_batch(cfg, 2, 12, "cpu")
            sp = distribute(params, param_specs(params, mesh), mesh, src_data_rank=None)
            sb = distribute(batch, batch_spec(batch, mesh), mesh, src_data_rank=None)
            with torch.no_grad():
                want = models.forward_loss(params, batch, cfg)
                with implicit_replication():
                    got = models.forward_loss(sp, sb, cfg).full_tensor()
                _, caches, memory = models.prefill(params, batch, cfg, 16)
                token = batch["tokens"][:, -1].contiguous()
                sc = distribute(caches, cache_specs(caches, mesh), mesh, src_data_rank=None)
                smem = None if memory is None else distribute(memory, batch_spec(memory, mesh), mesh, src_data_rank=None)
                stok = distribute(token, batch_spec(token, mesh), mesh, src_data_rank=None)
                want_logits, _ = models.decode_step(params, tree_map(torch.clone, caches), token, 12, cfg, memory=memory)
                with implicit_replication():
                    got_logits, _ = models.decode_step(sp, sc, stok, 12, cfg, memory=smem)
                got_logits = got_logits.full_tensor()
            res[arch] = {"loss": [float(got), float(want)], "loss_rel": rel(got, want),
                         "logits_rel": rel(got_logits, want_logits),
                         "shape": [list(got_logits.shape), list(want_logits.shape)]}
        res.update(seams(mesh))
        if rank == 0:
            with open(f"{out}/result.json", "w") as fh:
                json.dump(res, fh)
    finally:
        dist.destroy_process_group()
    """
)


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo")
    world = 4
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=SRC, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    init = f"file://{tmp / 'rendezvous'}"
    procs = [
        subprocess.Popen([sys.executable, "-c", GLOO_WORKER, str(r), str(world), init, str(tmp)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in range(world)
    ]
    deadline = time.monotonic() + DEADLINE_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"the 2 x 2 gloo mesh passed its {DEADLINE_S:.0f} s deadline")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}: {p.stdout.read().decode()[-3000:]}"
    return json.loads((tmp / "result.json").read_text())


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_sharded_forward_loss_on_gloo(gloo_run, arch):
    got = gloo_run[arch]
    assert got["loss_rel"] <= 1e-5, got["loss"]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_sharded_decode_logits_on_gloo(gloo_run, arch):
    got = gloo_run[arch]
    assert got["shape"][0] == got["shape"][1]
    assert got["logits_rel"] <= 1e-5


@pytest.mark.parametrize("case,placements", [
    ("batch", ["Shard(dim=0)", "Shard(dim=1)"]),         # batch shards kept, the vocab sharded as the table
    ("features", ["Replicate()", "Shard(dim=1)"]),       # a feature-sharded x is gathered, not contracted in parts
    ("one", ["Replicate()", "Shard(dim=1)"]),            # batch 1: the data axis holds the logits whole
])
def test_tied_unembed_placed_by_port(gloo_run, case, placements):
    got = gloo_run["unembed_" + case]
    assert got["placements"] == placements
    assert got["rel"] <= 1e-6


def test_batch1_products_split_over_data(gloo_run):
    got = gloo_run["rg_batch1"]
    assert got["tokens"][0] == got["tokens"][1]
    assert got["logits_rel"] <= 1e-5
    plain, shard = got["flops"]
    # the model axis splits each product in two, the idle data axis in two again
    assert shard * 4 == plain, got["flops"]
    # each made whole again on the data axis
    assert all(pl[0] == "Replicate()" for pl in got["out_placements"]), got["out_placements"]


@pytest.mark.parametrize("batch", [4, 1])
def test_sharded_slstm_prefill_on_local_shards(gloo_run, batch):
    got = gloo_run[f"slstm_b{batch}"]
    assert got["y_rel"] <= 1e-5
    assert got["state_rel"] <= 1e-5
