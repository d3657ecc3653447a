"""Multi-pod dry-run, PyTorch port of ``repro.launch.dryrun``: run every
(architecture x shape x mesh) cell once on fake tensors and count one
chip's costs.

``main()`` starts a fake process group of 256 or 512 ranks in this process
(torch.distributed's "fake" backend: every collective completes and moves
nothing), the counterpart of the reference's
``--xla_force_host_platform_device_count=512``; importing this module
starts nothing.  For each cell ``lower_cell``:
  1. builds the params, AdamW state, caches and batch as fake tensors
     (``FakeTensorMode``: shapes and dtypes, no memory) on ``--device``;
  2. places them as DTensors on the production mesh by ``param_specs`` /
     ``cache_specs`` / ``batch_spec``, FSDP for ``FSDP_ARCHS``;
  3. runs the train step, the prefill or one serve step once under
     ``roofline.count_ops()`` and ``implicit_replication()`` (the plain
     tensors that the model makes itself count as replicated);
  4. writes the roofline terms of rank 0's costs, with the reference's
     keys, to experiments/dryrun_torch/<cell>.json.

Nothing is compiled: ``lower_s`` is the time of the counted run and
``compile_s`` is 0.  ``temp_bytes_per_chip`` is the counter's peak of live
result bytes, ``arg_bytes_per_chip`` the local bytes of the placed inputs
and ``output_bytes_per_chip`` those of the step's outputs.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k [--device cpu]
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--skip-done]
  python -m repro_torch.launch.dryrun --arch phi3-mini-3.8b --shape prefill_32k --cut-depth --seq 2048

Each cell lowers in seconds (decode) to minutes on one CPU core
(train_4k: 0.5-3 min, xlstm's 10-18; prefill_32k, whose flash loop runs
64 x 32 blocks per layer on each rank where the heads shard: 1-22 min),
so run the whole sweep a few processes at a time, one ``--arch`` each.  ``--cut-depth`` and ``--seq`` cut a cell to one block
of each kind and a shorter sequence, a quick check of the sharded path.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, canonical, get_config
from repro_torch.core.snapshot import resolve_device
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh, mesh_desc
from repro_torch.models import abstract_params, init_caches, prefill
from repro_torch.models.model import tree_leaves, tree_map
from repro_torch.roofline import count_ops, roofline_terms
from repro_torch.roofline.analysis import (
    model_flops_decode, model_flops_prefill, model_flops_train,
)
from repro_torch.sharding import batch_spec, cache_specs, distribute, param_specs
from repro_torch.sharding.rules import P
from repro_torch.train import OptHParams, adamw_init, make_serve_step, make_train_step

FSDP_ARCHS = {"arctic_480b", "deepseek_v2_236b"}
OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments", "dryrun_torch")


def fake_world(world: int) -> None:
    """Make the default process group a fake one of ``world`` ranks (this
    process is rank 0), replacing a fake group of another size."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401  registers "fake"

    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        if dist.get_backend() != "fake":
            raise RuntimeError("a process group that is not fake is already running")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=dist.HashStore(), rank=0, world_size=world)


def _local_bytes(tree) -> int:
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if hasattr(t, "to_local") else t
            total += t.numel() * t.element_size()
    return total


def _fake(meta_tree, device):
    return tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype, device=device), meta_tree)


def cut_depth(cfg):
    """``cfg`` with every layer group (the encoder's too) repeated once:
    one block of each kind at full width."""
    over = {"groups": tuple((pattern, 1) for pattern, _ in cfg.groups)}
    if cfg.encoder_groups is not None:
        over["encoder_groups"] = tuple((pattern, 1) for pattern, _ in cfg.encoder_groups)
    return dataclasses.replace(cfg, **over)


def lower_cell(arch: str, shape: str, multi_pod: bool, device="cuda", *, cfg=None, seq=None):
    """Run one cell under the counter on the production mesh (the default
    group must be a fake one of its size); returns (report dict, OpCosts).
    ``cfg`` replaces ``arch``'s config (``cut_depth``) and ``seq`` the
    shape's sequence length (``--cut-depth``, ``--seq``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = cfg or get_config(arch)
    cell = S.input_specs(cfg, shape, seq=seq)
    if cell.skip_reason:
        return {"arch": arch, "shape": shape, "skipped": cell.skip_reason}, None
    dev = resolve_device(device)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=dev.type)
    chips = mesh.size()
    fsdp = canonical(arch) in FSDP_ARCHS

    def place(tree, specs):
        return distribute(tree, specs, mesh, src_data_rank=None)

    params_meta = abstract_params(cfg)
    pspecs = param_specs(params_meta, mesh, fsdp=fsdp)

    with FakeTensorMode():
        params = place(_fake(params_meta, dev), pspecs)
        batch = _fake(cell.batch, dev)
        batch = place(batch, batch_spec(batch, mesh))
        if cell.kind == "train":
            opt = adamw_init(params, state_dtype=cfg.opt_state_dtype)
            args = (params, opt, batch)
            step_fn = make_train_step(cfg, OptHParams())
            model_flops = model_flops_train(cfg, cell.global_batch, cell.seq)
        elif cell.kind == "prefill":
            args = (params, batch)

            def step_fn(params, batch):
                return prefill(params, batch, cfg, cache_len=cell.seq)

            model_flops = model_flops_prefill(cfg, cell.global_batch, cell.seq)
        else:  # decode
            caches = init_caches(cfg, cell.global_batch, cell.seq, device=dev)
            caches = place(caches, cache_specs(caches, mesh))
            mem = S.memory_spec(cfg, cell.global_batch)
            if mem is not None:
                mem = place(_fake(mem, dev), P(None, None, None))
            serve = make_serve_step(cfg)
            args = (params, caches, batch["token"], cell.seq - 1)

            def step_fn(p, c, t, pos):
                return serve(p, c, t, pos, memory=mem)

            model_flops = model_flops_decode(cfg, cell.global_batch, cell.seq)
        arg_bytes = _local_bytes([a for a in args if not isinstance(a, int)])

        t0 = time.time()
        # prefill and decode keep nothing for a backward, as the reference's
        # jitted steps do
        grad = torch.enable_grad() if cell.kind == "train" else torch.no_grad()
        with implicit_replication(), grad, count_ops() as counter:
            out = step_fn(*args)
        t_lower = time.time() - t0
        out_bytes = _local_bytes(out)

    costs = counter.costs
    print(f"[{arch} x {shape} x {mesh_desc(mesh)}] temp={costs.temp_bytes} arg={arg_bytes} "
          f"flops={costs.dot_flops} bytes={costs.hbm_bytes}")
    report = roofline_terms(
        arch=arch, shape=shape, mesh_desc=mesh_desc(mesh), chips=chips,
        costs=costs, model_flops=model_flops, arg_bytes=arg_bytes,
    )
    d = report.as_dict()
    d.update(
        lower_s=t_lower, compile_s=0.0, kind=cell.kind,
        seq=cell.seq, global_batch=cell.global_batch, fsdp=fsdp,
        temp_bytes_per_chip=costs.temp_bytes,
        arg_bytes_per_chip=arg_bytes,
        output_bytes_per_chip=out_bytes,
        param_count=cfg.param_count(),
        active_param_count=cfg.active_param_count(),
    )
    return d, costs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cut-depth", action="store_true",
                    help="every layer group repeated once (cell tag <shape>-cut)")
    ap.add_argument("--seq", type=int, default=None, help="the sequence length in place of the shape's "
                    "(cell tag <shape>-s<seq>)")
    args = ap.parse_args(argv)

    resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(S.SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    for mp in meshes:
        fake_world(512 if mp else 256)
        for arch in archs:
            for shape in shapes:
                variant = ("-cut" if args.cut_depth else "") + (f"-s{args.seq}" if args.seq else "")
                tag = f"{canonical(arch)}__{shape}{variant}__{'pod2' if mp else 'pod1'}"
                path = os.path.join(args.out, tag + ".json")
                if args.skip_done and os.path.exists(path):
                    print("skip (done):", tag)
                    continue
                print("=== cell:", tag, flush=True)
                try:
                    cfg = cut_depth(get_config(arch)) if args.cut_depth else None
                    d, _ = lower_cell(arch, shape, mp, device=args.device, cfg=cfg, seq=args.seq)
                    with open(path, "w") as f:
                        json.dump(d, f, indent=1)
                    if "skipped" in d:
                        print("SKIPPED:", d["skipped"])
                    else:
                        print(
                            f"ok t_lower={d['lower_s']:.1f}s t_compile={d['compile_s']:.1f}s "
                            f"dominant={d['dominant']} step={d['step_time_s']*1e3:.2f}ms "
                            f"frac={d['roofline_fraction']:.3f} mfu={d['mfu']:.3f}",
                            flush=True,
                        )
                except Exception as e:  # record the failure, keep sweeping, exit 1
                    failures.append(tag)
                    with open(path + ".fail", "w") as f:
                        f.write(traceback.format_exc())
                    print("FAIL:", tag, type(e).__name__, str(e)[:200], flush=True)
    dist.destroy_process_group()
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print("all requested cells ran.")


if __name__ == "__main__":
    main()
