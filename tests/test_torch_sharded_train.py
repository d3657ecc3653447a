"""The port's sharded train step and sharded checkpoints on a 2 x 2
("data", "model") mesh of four gloo CPU processes (one thread each,
``file://`` init, one deadline after which every rank is killed):

* for each of the ten archs' reduced configs at fp32, with remat on (each
  ``remat_mode`` in turn) and FSDP where the dry-run uses it, one
  ``make_train_step`` step on DTensor params, AdamW state and batch (under
  ``implicit_replication()``) against the plain step from the same
  weights: the loss, the gradient norm and every updated param, m and v
  leaf within 1e-5 of the plain one (relative to the leaf's largest).  The
  reduced configs' heads and experts are divided by the model axis, so the
  flash attention, the vocab-parallel CE and the experts run on real
  shards; qwen3 once more with a vocab of 509, which the model axis does
  not divide (the CE's weight is then whole there and each rank slices
  its vocab range), and qwen2.5 with 3 heads and 1 KV head (attention
  then shards the queries); xlstm's sLSTM runs its time loop on local
  shards, 4 of its 8 (gate, head) pairs on each rank of "model";
* ``save_checkpoint`` of the sharded state after that step writes each
  leaf's global array; ``restore_checkpoint(..., shardings=)`` puts it back
  ``==`` onto (4, 1) and (1, 4) meshes, with the placements asked for, and
  without ``shardings`` as plain tensors;
* the reference's ``restore_checkpoint`` reads that save ``==``.
"""
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from repro_torch import configs

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
DEADLINE_S = 300
CKPT_ARCH = "deepseek_v2_236b"      # FSDP, MLA and the experts in one tree
# (arch, suffix, config overrides) run once more: a vocab the model axis does not
# divide (the CE's weight is then whole there), and head counts it does not divide
# (attention then shards the queries)
EXTRA = [("qwen3_32b", "_vocab509", '{"vocab": 509}'),
         ("qwen2p5_32b", "_heads3", '{"num_heads": 3, "num_kv_heads": 1, "head_dim": 16}')]

WORKER = textwrap.dedent(
    """
    import dataclasses, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import configs, models
    from repro_torch.launch import serve
    from repro_torch.launch.dryrun import FSDP_ARCHS
    from repro_torch.models.model import tree_map
    from repro_torch.sharding import batch_spec, distribute, named_shardings, param_specs, to_placements
    from repro_torch.sharding.rules import map_with_path
    from repro_torch.train import OptHParams, adamw_init, make_train_step, restore_checkpoint, save_checkpoint
    from repro_torch.train.checkpoint import _flatten

    rank, world, init, out, ckpt_arch = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    torch.set_num_threads(1)
    MODES = ("block", "pattern", "double")

    def rel(got, want):
        return float((got - want).abs().max() / max(float(want.abs().max()), 1e-30))

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        hp = OptHParams(warmup_steps=1, eps=1e-3)
        res = {}
        cases = [(a, "", {}) for a in configs.ARCH_IDS] + [
            (a, suffix, json.loads(over)) for a, suffix, over in json.loads(sys.argv[6])]
        for n, (arch, suffix, over) in enumerate(cases):
            cfg = dataclasses.replace(configs.get_reduced_config(arch), activation_dtype="float32",
                                      remat=True, remat_mode=MODES[n % 3], **over)
            fsdp = arch in FSDP_ARCHS
            params = models.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
            batch = serve.make_batch(cfg, 4, 32, "cpu")
            batch["labels"] = batch["tokens"].clone()
            batch["labels"][:, :3] = -1
            # every rank draws the same weights and inputs and keeps its own shards
            sp = distribute(tree_map(torch.clone, params), param_specs(params, mesh, fsdp=fsdp), mesh,
                            src_data_rank=None)
            sb = distribute(batch, batch_spec(batch, mesh), mesh, src_data_rank=None)
            sopt = adamw_init(sp, state_dtype=cfg.opt_state_dtype)
            step = make_train_step(cfg, hp)
            want_p, want_o, want_m = step(params, adamw_init(params, state_dtype=cfg.opt_state_dtype), batch)
            with implicit_replication():
                got_p, got_o, got_m = step(sp, sopt, sb)
            worst = {}
            for tree, name in ((got_p, "params"), (got_o["m"], "m"), (got_o["v"], "v")):
                want_tree = {"params": want_p, "m": want_o["m"], "v": want_o["v"]}[name]
                wl = dict(_flatten(want_tree))
                errs = {"/".join(k): rel(whole(t), wl[k]) for k, t in _flatten(tree)}
                key = max(errs, key=errs.get)
                worst[name] = [key, errs[key], len(errs)]
            res[arch + suffix] = {
                "loss": [float(whole(got_m["loss"])), float(want_m["loss"])],
                "loss_rel": rel(whole(got_m["loss"]), want_m["loss"]),
                "gnorm_rel": rel(whole(got_m["grad_norm"]), want_m["grad_norm"]),
                "worst": worst,
                "sharded_leaves": sum(1 for _, t in _flatten(sp)
                                      if any(not pl.is_replicate() for pl in t.placements)),
            }
            if arch != ckpt_arch or suffix:
                continue
            state = {"params": got_p, "opt": got_o}
            full = {"/".join(k): whole(t).clone() for k, t in _flatten(state)}
            save_checkpoint(out + "/ckpt", 1, state, extra={"arch": arch})
            like = {"params": params, "opt": want_o}
            ck = {}
            for shape in ((4, 1), (1, 4)):
                m2 = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
                ps = param_specs(params, m2, fsdp=fsdp)
                sh = {"params": named_shardings(ps, m2),
                      "opt": {"m": named_shardings(ps, m2), "v": named_shardings(ps, m2), "step": None}}
                tree, st, extra = restore_checkpoint(out + "/ckpt", like, device="cpu", shardings=sh)
                want_pl = {}
                for part in ("params", "opt/m", "opt/v"):
                    map_with_path(lambda path, s, part=part: want_pl.__setitem__(
                        part + "/" + "/".join(map(str, path)), tuple(to_placements(s, m2))), ps)
                named = [("/".join(k), t) for k, t in _flatten(tree)]
                bad = [n for n, t in named if not torch.equal(whole(t), full[n])]
                wrong = [n for n, t in named if n in want_pl and tuple(t.placements) != want_pl[n]]
                placed = sum(1 for _, t in named if hasattr(t, "placements"))
                ck["x".join(map(str, shape))] = {"bad": bad, "placed": placed, "leaves": len(full),
                                                "wrong_placements": wrong, "step": st, "extra": extra}
            tree, st, extra = restore_checkpoint(out + "/ckpt", like, device="cpu")
            named = [("/".join(k), t) for k, t in _flatten(tree)]
            ck["plain"] = {"bad": [n for n, t in named if not torch.equal(t, full[n])],
                           "placed": sum(1 for _, t in named if hasattr(t, "placements")),
                           "leaves": len(full), "wrong_placements": [], "step": st, "extra": extra}
            res["checkpoint"] = ck
            if rank == 0:
                np.savez(out + "/ckpt_full.npz", **{k: v.numpy() for k, v in full.items()})
        if rank == 0:
            with open(out + "/result.json", "w") as fh:
                json.dump(res, fh)
    finally:
        dist.destroy_process_group()
    """
)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_train")
    world = 4
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=SRC, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    init = f"file://{tmp / 'rendezvous'}"
    procs = [
        subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(world), init, str(tmp), CKPT_ARCH, json.dumps(EXTRA)],
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
    res = json.loads((tmp / "result.json").read_text())
    res["dir"] = tmp
    return res


@pytest.mark.parametrize("arch", configs.ARCH_IDS + [a + suffix for a, suffix, _ in EXTRA])
def test_sharded_train_step_matches_plain(run, arch):
    got = run[arch]
    assert got["sharded_leaves"] > 0
    assert got["loss_rel"] <= 1e-5, got["loss"]
    assert got["gnorm_rel"] <= 1e-5
    for name in ("params", "m", "v"):
        leaf, err, count = got["worst"][name]
        assert count > 0
        assert err <= 1e-5, (name, leaf, err)


@pytest.mark.parametrize("target", ["4x1", "1x4", "plain"])
def test_sharded_checkpoint_restores_on_other_meshes(run, target):
    got = run["checkpoint"][target]
    assert got["step"] == 1 and got["extra"] == {"arch": CKPT_ARCH}
    assert got["bad"] == []
    assert got["wrong_placements"] == []
    # every params, m and v leaf placed on the new mesh (the step stays plain)
    assert got["placed"] == (0 if target == "plain" else got["leaves"] - 1)


def test_reference_restores_sharded_save(run):
    import jax.numpy as jnp

    from repro.train.checkpoint import restore_checkpoint as ref_restore

    full = np.load(run["dir"] / "ckpt_full.npz")
    manifest = json.loads((run["dir"] / "ckpt" / "step_00000001" / "manifest.json").read_text())
    assert sorted(manifest["leaves"]) == sorted(full.files)

    # the reference's `like`: the same tree of names, as nested dicts / lists
    def insert(tree, parts, leaf):
        head, rest = parts[0], parts[1:]
        if not rest:
            tree[head] = leaf
            return
        insert(tree.setdefault(head, {}), rest, leaf)

    def listify(tree):
        if not isinstance(tree, dict):
            return tree
        if all(k.isdigit() for k in tree):
            return [listify(tree[str(i)]) for i in range(len(tree))]
        return {k: listify(v) for k, v in tree.items()}

    nested = {}
    for name in full.files:
        insert(nested, name.split("/"), jnp.zeros(full[name].shape, full[name].dtype))
    tree, step, extra = ref_restore(str(run["dir"] / "ckpt"), listify(nested))
    assert step == 1 and extra == {"arch": CKPT_ARCH}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from walk(v, path + [k])
        elif isinstance(t, list):
            for i, v in enumerate(t):
                yield from walk(v, path + [str(i)])
        else:
            yield "/".join(path), t

    seen = 0
    for name, arr in walk(tree, []):
        assert np.array_equal(np.asarray(arr), full[name]), name
        seen += 1
    assert seen == len(full.files)
