"""Render the roofline table from experiments/dryrun*/ JSONs, the port of
``repro.roofline.report`` (it reads either package's JSONs).

    PYTHONPATH=src python -m repro_torch.roofline.report experiments/dryrun_torch
"""
from __future__ import annotations

import glob
import json
import os
import sys


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


def main():
    dirpath = sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun_torch"
    rows = load(dirpath)
    print(f"### {dirpath} ({len(rows)} cells)\n")
    print(markdown(rows))


if __name__ == "__main__":
    main()
