"""Render the roofline table from experiments/dryrun*/ JSONs, the port of
``repro.roofline.report`` (it reads either package's JSONs).

    PYTHONPATH=src python -m repro_torch.roofline.report experiments/dryrun_torch
    PYTHONPATH=src python -m repro_torch.roofline.report experiments/dryrun_torch --against experiments/dryrun

With ``--against`` it prints, per cell, the per-chip FLOPs beside the
other directory's same cell (the reference's dry-run) and their ratio,
both useful-FLOPs fractions, the dominant term, temp bytes and lowering
seconds; a cell that failed (``<cell>.json.fail``) or is missing shows so.
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load(dirpath: str):
    rows = []
    for f in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        d = json.load(open(f))
        d["_tag"] = os.path.basename(f)[:-5]
        rows.append(d)
    return rows


def fmt_s(x):
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    return f"{x*1e3:.2f}ms"


def markdown(rows, mesh_filter=None):
    out = []
    out.append(
        "| arch | shape | mesh | compute | memory | collective | dominant | "
        "step | frac | MODEL/HLO | MFU | HBM/chip |"
    )
    out.append("|---|---|---|---|---|---|---|---|---|---|---|---|")
    for d in rows:
        if "skipped" in d:
            arch, shape, mesh = d["_tag"].split("__")
            if mesh_filter and mesh != mesh_filter:
                continue
            out.append(
                f"| {arch} | {shape} | {mesh} | — | — | — | SKIPPED | — | — | — | — | — |"
            )
            continue
        arch, shape, mesh = d["_tag"].split("__")
        if mesh_filter and mesh != mesh_filter:
            continue
        hbm = (d.get("temp_bytes_per_chip") or 0) + (d.get("arg_bytes_per_chip") or 0)
        out.append(
            f"| {arch} | {shape} | {mesh} | {fmt_s(d['compute_s'])} | "
            f"{fmt_s(d['memory_s'])} | {fmt_s(d['collective_s'])} | "
            f"{d['dominant']} | {fmt_s(d['step_time_s'])} | "
            f"{d['roofline_fraction']:.3f} | {d['useful_flops_fraction']:.2f} | "
            f"{d['mfu']:.4f} | {hbm/1e9:.1f}GB |"
        )
    return "\n".join(out)


def against(rows, ref_dir, lo=0.5, hi=2.0):
    """(markdown lines, the tags outside [lo, hi] x the reference's FLOPs)."""
    ref = {d["_tag"]: d for d in load(ref_dir)}
    port = {d["_tag"]: d for d in rows}
    tags = sorted(set(port) | set(ref))
    out = ["| cell | flops/chip | reference | ratio | useful | reference useful | dominant | temp GB/chip | lower s |",
           "|---|---|---|---|---|---|---|---|---|"]
    outside = []
    for tag in tags:
        d, r = port.get(tag), ref.get(tag)
        if d is None or "skipped" in d or r is None or "skipped" in r:
            what = "skipped" if (d or r or {}).get("skipped") else ("missing" if d is None else "no reference")
            out.append(f"| {tag} | {what} | | | | | | | |")
            continue
        ratio = d["flops_per_chip"] / r["flops_per_chip"] if r["flops_per_chip"] else float("nan")
        if not lo <= ratio <= hi:
            outside.append(tag)
        out.append(
            f"| {tag} | {d['flops_per_chip']:.4g} | {r['flops_per_chip']:.4g} | {ratio:.3f} | "
            f"{d['useful_flops_fraction']:.3f} | {r['useful_flops_fraction']:.3f} | {d['dominant']} | "
            f"{d.get('temp_bytes_per_chip', 0) / 1e9:.2f} | {d.get('lower_s', 0):.1f} |")
    return out, outside


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dir", nargs="?", default="experiments/dryrun_torch")
    ap.add_argument("--against", default=None, help="another dry-run directory (the reference's)")
    args = ap.parse_args(argv)
    rows = load(args.dir)
    print(f"### {args.dir} ({len(rows)} cells)\n")
    if args.against is None:
        print(markdown(rows))
        return
    lines, outside = against(rows, args.against)
    print("\n".join(lines))
    fails = sorted(os.path.basename(f)[:-10] for f in glob.glob(os.path.join(args.dir, "*.json.fail")))
    print(f"\nfailed: {fails or 'none'}; outside 0.5-2x the reference's FLOPs per chip: {outside or 'none'}")


if __name__ == "__main__":
    main()
