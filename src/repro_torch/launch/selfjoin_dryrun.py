"""Dry-run + roofline for the paper's technique at pod scale, PyTorch port
of ``repro.launch.selfjoin_dryrun``: the entity-partitioned ring self-join
(Sec. 6.3) on the production meshes.

Workload: |D| points x n dims sharded over all chips: the joint ring over
("pod", "data", "model") (``core.distributed.ring_of``) makes every chip a
ring node, as every GPU is a node in the paper.  ``main()`` starts a fake
process group of 256, then 512 ranks in this process, and each cell runs
``ring_scan`` once on a fake shard (``FakeTensorMode``) under
``roofline.count_ops()``: rank 0's costs, each rotation charged as a
collective-permute.  Variants are the reference's hillclimb levers:

  base        fp32 coordinates, compute-then-permute
  overlap     permute issued before compute (round i+1 transport overlaps
              round i compute -- paper Fig. 4's pipeline, at ring scale)
  bf16        bf16 coordinate transport, fp32 accumulation: each block is
              upcast to fp32 before its products, and a product of two
              bf16 values is exact in fp32, so the sums are the
              reference's bf16 x bf16 -> fp32 dots
              (``preferred_element_type=float32``); being fp32, they are
              charged at the card's fp32 peak, as it runs them

The port's ring rotates |p| - 1 times (no rotation after the last round,
``ring_scan``); the reference's ``ppermute`` scan rotates |p| times.

Usage: python -m repro_torch.launch.selfjoin_dryrun [--points 16777216] [--dims 32] [--device cpu]
           [--mesh pod1|pod2 ...] [--variant base|overlap|bf16 ...]

``--mesh`` and ``--variant`` pick cells (default: all six); the cells are
independent, so a caller may run them as processes of their own.
"""
from __future__ import annotations

import argparse
import json

import torch
import torch.distributed as dist

from repro_torch.core.distributed import ring_of, ring_scan
from repro_torch.core.snapshot import resolve_device
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_production_mesh, mesh_desc
from repro_torch.roofline import count_ops, roofline_terms


MESHES = ("pod1", "pod2")
VARIANTS = ("base", "overlap", "bf16")


def ring_fn(mesh, axes, eps, *, variant="base", row_block=2048):
    """``fn(d_block)``: this rank's neighbour counts (int32) of its shard
    ``d_block`` over the ring that spans ``axes`` of ``mesh``."""
    eps2 = float(eps) ** 2
    ring = ring_of(mesh, tuple(axes))

    def local_counts(q, e):
        if variant == "bf16":
            q, e = q.to(torch.bfloat16).float(), e.float()   # e travels as bf16
        ne = (e * e).sum(1)[None, :]
        et = e.T
        out = []
        for qb in q.reshape(-1, row_block, q.shape[1]).unbind(0):
            # |q|^2 + |e|^2 - 2 q e^T, the product and its scaled sum in one addmm
            d2 = torch.addmm((qb * qb).sum(1, keepdim=True) + ne, qb, et, alpha=-2.0)
            out.append((d2 <= eps2).sum(1, dtype=torch.int32))
        return torch.cat(out)

    def fn(d_block):
        q = d_block
        payload = d_block.to(torch.bfloat16) if variant == "bf16" else d_block

        def body(_, counts, e):
            return counts + local_counts(q, e)

        counts0 = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
        # overlap variant: ring_scan issues round r+1's exchange before round
        # r's body -- paper Fig. 4's pipeline, at ring scale
        return ring_scan(ring, body, counts0, payload, overlap=(variant == "overlap"))

    return fn


def run_cell(points, dims, eps, multi_pod, variant, device="cuda"):
    """One cell on a fake group of the mesh's size; returns its report dict."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    dev = resolve_device(device)
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=dev.type)
    axes = mesh.mesh_dim_names
    chips = mesh.size()
    fn = ring_fn(mesh, axes, eps, variant=variant)
    with FakeTensorMode():
        d_block = torch.empty((points // chips, dims), dtype=torch.float32, device=dev)
        arg_bytes = d_block.numel() * d_block.element_size()
        with count_ops() as counter:
            fn(d_block)
    # model flops: |D|^2 pair distances x 3n flops (paper Sec. 4.4), one pass
    model_flops = 3.0 * dims * float(points) ** 2
    rep = roofline_terms(
        arch=f"selfjoin-ring-{variant}", shape=f"D{points}xn{dims}",
        mesh_desc=mesh_desc(mesh), chips=chips, costs=counter.costs,
        model_flops=model_flops, arg_bytes=arg_bytes,
    )
    d = rep.as_dict()
    d["temp_bytes_per_chip"] = counter.costs.temp_bytes
    d["arg_bytes_per_chip"] = arg_bytes
    return d


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=16_777_216)  # 2^24, ~2GB fp32 @32d
    ap.add_argument("--dims", type=int, default=32)
    ap.add_argument("--eps", type=float, default=0.08)
    ap.add_argument("--out", default="experiments/selfjoin_ring_torch.json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", action="append", choices=MESHES, help="repeatable; default both")
    ap.add_argument("--variant", action="append", choices=VARIANTS, help="repeatable; default all")
    args = ap.parse_args(argv)

    out = {}
    for mesh in MESHES:
        if args.mesh and mesh not in args.mesh:
            continue
        multi_pod = mesh == "pod2"
        for variant in VARIANTS:
            if args.variant and variant not in args.variant:
                continue
            tag = f"{mesh}__{variant}"
            d = run_cell(args.points, args.dims, args.eps, multi_pod, variant, device=args.device)
            out[tag] = d
            print(
                f"{tag:16s} comp={d['compute_s']:.3f}s mem={d['memory_s']:.3f}s "
                f"coll={d['collective_s']:.3f}s dom={d['dominant']} "
                f"frac={d['roofline_fraction']:.3f} mfu={d['mfu']:.3f} "
                f"temp={d['temp_bytes_per_chip']/1e9:.2f}GB", flush=True,
            )
    dist.destroy_process_group()
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
