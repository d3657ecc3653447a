#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  -- card name and power limit (nvidia-smi), build of every CUDA
   source in src/repro_torch/csrc with nvcc (one process per source, in
   parallel), and the registers / shared memory / spills ptxas reports;
2. kernels -- each kernel (K1-K4) against its plain PyTorch version on the
   card: a sweep of tile sizes and dim blocks on 1/64-quantized tiles
   (counts, skipped and mask must be equal), then the main path's own
   chunks at full width (equal up to the stated eps-boundary tolerance),
   with torch.profiler device times of the kernel, the plain version and
   one PyTorch yardstick, and the bound the card could reach on the same
   work over the data's real dimensions;
3. count   -- ``SelfJoinEngine.count`` on Syn16D2M (2,000,000 x 16,
   exponential lambda=40; paper Table 1) at eps=0.03 with the default
   config, spot-checked against a float64 brute force on the card;
4. pairs   -- ``SelfJoinEngine.pairs`` and the dense tier (``self_join``
   with execution="dense", counts and pairs) on CoocTexture (68,040 x 16)
   at eps=0.1.

Kernel launch counters are set to 0 just before phase 3 and read just after
phase 4; a kernel that the main path never launched fails the run.  The
line before the last lists every kernel with its numbers; the last line is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero.  The script
imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_FP32_FLOPS = 67e12   # H100 SXM, fp32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
BOUNDARY_REL = 1e-5       # raw fp32 data: a count may differ only for pairs
                          # (a, b) whose float64 d2 lies within
                          # BOUNDARY_REL * (|a|^2 + |b|^2) of eps^2 -- the fp32
                          # rounding of |a|^2 + |b|^2 - 2 a.b scales with the
                          # norms, not with eps^2

SYN_N = 2_000_000         # Syn16D2M at full size (no cut)
SYN_EPS = 0.03
COOC_EPS = 0.1

KERNELS = {
    # name: (module attribute, CUDA source, TPU kernel replaced, mask mode)
    "tile_pair_distance": ("distance_tile", "src/repro_torch/csrc/distance_tile.cu",
                           "src/repro/kernels/distance_tile.py:111", False),
    "tile_pair_distance_mask": ("distance_tile", "src/repro_torch/csrc/distance_tile.cu",
                                "src/repro/kernels/distance_tile.py:98", True),
    "dense_tile_distance": ("dense_tile", "src/repro_torch/csrc/dense_tile.cu",
                            "src/repro/kernels/dense_tile.py:98", False),
    "dense_tile_distance_mask": ("dense_tile", "src/repro_torch/csrc/dense_tile.cu",
                                 "src/repro/kernels/dense_tile.py:85", True),
}


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# -- phase 1 -----------------------------------------------------------------


def ptxas_summary(text: str):
    """One line per compiled kernel: template args, registers, smem, spills."""
    out, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            args = re.search(r"ILi(\d+)ELb(\d)ELb(\d)ELb(\d)E", m.group(1))
            name = ("tile_pair_kernel<R=%s,SHORTC=%s,CLAMP=%s,MASK=%s>" % args.groups()
                    if args else m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out.append({"kernel": name, "spill_stores": int(m.group(1)), "spill_loads": int(m.group(2))})
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and name:
            rec = next((r for r in out if r["kernel"] == name), None)
            if rec is None:
                rec = {"kernel": name}
                out.append(rec)
            rec.update(registers=int(m.group(1)), smem_bytes=int(m.group(2)))
    return out


def phase_device(torch, _build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    emit({
        "phase": "device", "nvidia_smi": smi,
        "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s,
        "ptxas": {n: ptxas_summary(_build.ptxas_report(n)) for n in _build.SOURCES},
    })
    return smi


# -- phase 2 -----------------------------------------------------------------


def kernel_fns():
    from repro_torch.kernels import dense_tile, distance_tile

    def k(name):
        mod, _, _, mask = KERNELS[name]
        if mod == "distance_tile":
            return (lambda *a, **kw: distance_tile.tile_pair_distance(*a, return_mask=mask, **kw),
                    lambda *a, **kw: distance_tile.tile_pair_distance_plain(*a, return_mask=mask, **kw))
        return (lambda *a, **kw: dense_tile.dense_tile_distance(*a, return_mask=mask, **kw),
                lambda *a, **kw: dense_tile.dense_tile_distance_plain(*a, return_mask=mask, **kw))

    return {name: k(name) for name in KERNELS}


def sweep_case(torch, np, t, n, db, seed, far=False):
    rng = np.random.default_rng(seed)
    num_tiles = 7
    n_pad = -(-n // db) * db
    pts = np.zeros((num_tiles, t, n_pad), np.float32)
    pts[:, :, :n] = np.round(rng.random((num_tiles, t, n)) * 64) / 64
    lens = rng.integers(0, t + 1, size=num_tiles).astype(np.int32)
    lens[0] = t
    if far:  # tile 1 far from tile 0: SHORTC fires after the first block
        pts[0, :, :n] = 0.0
        pts[1, :, :n] = 0.90625
        lens[1] = t
    for i in range(num_tiles):
        pts[i, lens[i]:] = 0.0
    pairs = rng.integers(0, num_tiles, size=(40, 2)).astype(np.int32)
    pairs[:3] = [[0, 1], [1, 0], [0, 0]]
    dev = torch.device("cuda")
    return (torch.from_numpy(pts).to(dev), torch.from_numpy(lens).to(dev),
            torch.from_numpy(pairs[:, 0].copy()).to(dev), torch.from_numpy(pairs[:, 1].copy()).to(dev))


def phase_sweep(torch, np, fns):
    cases = 0
    fired = 0
    shapes = [(t, n, db) for t in (8, 16, 32, 64) for n, db in ((8, 8), (24, 8), (64, 32))]
    shapes += [(100, 40, 40), (128, 96, 48), (5, 3, 8)]  # odd T, two-slice blocks, T < 8
    for i, (t, n, db) in enumerate(shapes):
        for far in (False, True):
            tiles, lens, pa, pb = sweep_case(torch, np, t, n, db, seed=1000 + i, far=far)
            eps = 0.05 if far else 0.3
            for name, (kern, plain) in fns.items():
                got = kern(tiles, lens, pa, pb, eps=eps, dim_block=db)
                want = plain(tiles, lens, pa, pb, eps=eps, dim_block=db)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    check(torch.equal(g, w), f"{name} != plain at T={t} n={n} db={db} far={far}")
                if name == "tile_pair_distance" and int(got[1].sum()) > 0:
                    fired += 1
                cases += 1
    check(fired > 0, "SHORTC never fired in the sweep")
    return {"cases": cases, "shortc_fired_cases": fired, "shapes": len(shapes)}


def boundary_band(a, b):
    """float64 d2 between the rows of a (..., Ta, n) and b (..., Tb, n), and
    the band BOUNDARY_REL * (|a|^2 + |b|^2) around eps^2 inside which an fp32
    count may differ from the float64 one."""
    from repro_torch.core.brute import sqdist_f64

    a, b = a.double(), b.double()
    band = BOUNDARY_REL * ((a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :])
    return sqdist_f64(a, b), band


def boundary_slack(torch, tiles, lens, pa, pb, eps):
    """(P, T, T): valid lanes whose float64 d2 lies in the eps^2 boundary band."""
    d2, band = boundary_band(tiles[pa.long()], tiles[pb.long()])
    rows = torch.arange(tiles.shape[1], device=tiles.device)
    valid = (rows[None, :, None] < lens[pa.long()][:, None, None]) & (
        rows[None, None, :] < lens[pb.long()][:, None, None])
    return valid & ((d2 - float(eps) ** 2).abs() <= band)


def count_bounds(torch, pts, rows, eps):
    """(lo, hi): float64 neighbour counts of pts[rows] at eps^2 -/+ the band.

    A right count on raw fp32 data lies in [lo, hi]."""
    e2 = float(eps) ** 2
    lo, hi = [], []
    for s in range(0, len(rows), 32):
        sel = torch.as_tensor(rows[s:s + 32], device=pts.device)
        d2, band = boundary_band(pts[sel], pts)
        lo.append((d2 <= e2 - band).sum(1))
        hi.append((d2 <= e2 + band).sum(1))
    return torch.cat(lo).cpu().numpy(), torch.cat(hi).cpu().numpy()


def device_ms(torch, fn, iters=20):
    """Device time per call from torch.profiler, by kernel name.

    Unlike CUDA events around back-to-back calls, this excludes the host's
    gaps between launches.  Fails when the profiler records no device time:
    no other clock stands in for it.
    """
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = evt.cuda_time_total
        if us > 0:
            by_name[evt.key] = us / iters / 1e3
    check(by_name, "torch.profiler recorded no device time")
    return by_name


def smi_sample():
    """SM clock, power draw and temperature, as nvidia-smi reads them now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def yardstick(torch, tiles, lens, pa, pb, eps2):
    """One PyTorch formulation of the same function (clamped identity via
    baddbmm, then <= and a sum); timed as library_ms, never used by the port."""
    pal, pbl = pa.long(), pb.long()
    a, b = tiles[pal], tiles[pbl]
    t = tiles.shape[1]
    rows = torch.arange(t, device=tiles.device)
    valid = (rows[None, :, None] < lens[pal][:, None, None]) & (rows[None, None, :] < lens[pbl][:, None, None])
    na = (a * a).sum(-1)
    nb = (b * b).sum(-1)
    d2 = torch.baddbmm(na[:, :, None] + nb[:, None, :], a, b.transpose(1, 2), alpha=-2.0).clamp_min_(0.0)
    within = (d2 <= eps2) & valid
    return within.sum(2, dtype=torch.int32), within


def bound(torch, tiles, pa, pb, n, db, skipped, mask):
    """Least time on the card: max(bytes / HBM rate, flop / fp32 rate), ms.

    Only the n real dimensions count, not the zero padding up to n_pad, and
    of those only the ones in dim blocks this run's data computed (SHORTC
    skips trailing blocks; ``skipped`` is None for the kernels without it).
    Bytes: each referenced tile's real dimensions and length read once, the
    pair lists read once, counts (+ skipped, + the int8 mask) written once.
    Flop per pair: 2 T^2 per computed dimension for the products, 4 T for
    the norms, and 4 T^2 per computed block for the fold.
    """
    p = pa.shape[0]
    t, n_pad = tiles.shape[1], tiles.shape[2]
    uniq = int(torch.unique(torch.cat([pa, pb])).numel())
    nbytes = (uniq * t * n * 4 + uniq * 4 + p * 8 + p * t * 4
              + (p * 4 if skipped is not None else 0) + (p * t * t if mask else 0))
    blocks = torch.full((p,), -(-n_pad // db), dtype=torch.int64, device=pa.device)
    if skipped is not None:
        blocks -= skipped.reshape(-1).long()
    dims = torch.clamp(blocks * db, max=n)
    real_blocks = -(-dims // db)
    flop = int((2 * t * t + 4 * t) * dims.sum() + 4 * t * t * real_blocks.sum())
    by_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    by_ops = flop / PEAK_FP32_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes > by_ops else "operations"), nbytes, flop


def phase_real_width(torch, np, fns, inputs):
    """Each kernel on a main-path chunk: compare with plain, time all three."""
    from repro_torch.kernels.distance_tile import eps_squared

    rows = {}
    for name, (kern, plain) in fns.items():
        tiles, lens, pa, pb, n, eps, db, source = inputs[name]
        got = kern(tiles, lens, pa, pb, eps=eps, dim_block=db)
        want = plain(tiles, lens, pa, pb, eps=eps, dim_block=db)
        torch.cuda.synchronize()
        near = boundary_slack(torch, tiles, lens, pa, pb, eps)
        err = (got[0] - want[0]).abs()
        max_err = int(err.max()) if err.numel() else 0
        check(bool((err <= near.sum(2)).all()), f"{name}: counts differ beyond the eps boundary")
        mask = KERNELS[name][3]
        nb = tiles.shape[2] // db
        skipped = None
        if name.startswith("tile_pair_distance"):
            check(torch.equal(got[1], want[1]), f"{name}: skipped differs from plain")
            skipped = got[1]
        computed = pa.shape[0] * nb - (int(skipped.sum()) if skipped is not None else 0)
        if mask:
            m_err = (got[-1] != want[-1])
            check(bool((~m_err | near).all()), f"{name}: mask differs beyond the eps boundary")
            max_err = max(max_err, int(m_err.sum() > 0))
        eps2 = eps_squared(eps)
        run_k = lambda: kern(tiles, lens, pa, pb, eps=eps, dim_block=db)  # noqa: E731
        run_p = lambda: plain(tiles, lens, pa, pb, eps=eps, dim_block=db)  # noqa: E731
        run_l = lambda: yardstick(torch, tiles, lens, pa, pb, eps2)  # noqa: E731
        k_ms = sum(v for key, v in device_ms(torch, run_k).items() if "tile_pair_kernel" in key)
        check(k_ms > 0, f"{name}: torch.profiler saw no tile_pair_kernel time")
        p_ms = sum(device_ms(torch, run_p, iters=5).values())
        l_ms = sum(device_ms(torch, run_l, iters=5).values())
        b_ms, b_by, nbytes, flop = bound(torch, tiles, pa, pb, n, db, skipped, mask)
        rows[name] = {
            "inputs": source, "pairs": int(pa.shape[0]), "T": int(tiles.shape[1]), "n": n,
            "n_pad": int(tiles.shape[2]), "dim_block": db, "computed_blocks": computed,
            "max_abs_err": max_err, "boundary_lanes": int(near.sum()),
            "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flop": flop,
        }
    emit({"phase": "kernels_real_width", "timing": "torch.profiler device time per call",
          "kernels": rows, "smi": smi_sample()})
    return rows


# -- phases 3 and 4 ----------------------------------------------------------


def spot_check(torch, np, d, counts, eps, n_sample=256, seed=0):
    """Sampled points' counts against a float64 brute force on the card."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(d.shape[0], size=min(n_sample, d.shape[0]), replace=False)
    lo, hi = count_bounds(torch, torch.from_numpy(d).cuda(), idx, eps)
    got = counts[idx]
    return int(idx.shape[0]), int(((got < lo) | (got > hi)).sum())


def phase_count(torch, np, engine, d, host_s):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = engine.count()
    torch.cuda.synchronize()
    device_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()  # before the spot check's own buffers
    st = res.stats
    n_checked, bad = spot_check(torch, np, d, res.counts, SYN_EPS)
    check(bad == 0, f"Syn16D2M spot check: {bad} of {n_checked} sampled counts off")
    check(res.counts.shape == (d.shape[0],) and (res.counts >= 1).all(), "Syn16D2M counts malformed")
    rec = {
        "phase": "count", "dataset": "Syn16D2M", "points": int(d.shape[0]), "dims": int(d.shape[1]),
        "eps": SYN_EPS, "cut": None, "host_plan_s": host_s, "device_s": device_s,
        "results": st.num_results, "tile_pairs": st.num_tile_pairs_evaluated,
        "tile_pairs_total": st.num_tile_pairs_total, "candidates": st.num_candidates,
        "dim_blocks_skipped": st.dim_blocks_skipped, "dim_blocks_total": st.dim_blocks_total,
        "chunks": st.num_chunks, "peak_device_bytes": peak,
        "spot_checked": n_checked, "spot_bad": bad,
    }
    emit(rec)
    return rec


def phase_pairs(torch, np, engine, d, dense_cfg, self_join):
    t0 = time.perf_counter()
    rc = engine.count()
    count_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rp = engine.pairs()
    pairs_s = time.perf_counter() - t0
    check(rp.pairs.shape == (rc.stats.num_results, 2), "pairs count != count() sum")
    check(np.array_equal(rp.counts, rc.counts), "pairs() counts != count() counts")
    pr = torch.from_numpy(rp.pairs).cuda().long()
    n = d.shape[0]
    fwd = torch.sort(pr[:, 0] * n + pr[:, 1]).values
    rev = torch.sort(pr[:, 1] * n + pr[:, 0]).values
    check(torch.equal(fwd, rev), "pair set is not symmetric")
    check(int(torch.unique_consecutive(fwd).numel()) == fwd.numel(), "duplicate pairs")
    t0 = time.perf_counter()
    rd = self_join(d, dense_cfg)
    dense_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rdp = self_join(d, dense_cfg, return_pairs=True)
    dense_pairs_s = time.perf_counter() - t0
    check(np.array_equal(rdp.counts, rd.counts), "dense pairs() counts != dense count()")
    check(rdp.pairs.shape == (rd.stats.num_results, 2), "dense pairs count != dense count() sum")
    diff = np.nonzero(rd.counts != rc.counts)[0]
    if diff.size:  # allowed only at the eps boundary (raw fp32 data)
        lo, hi = count_bounds(torch, torch.from_numpy(d).cuda(), diff, COOC_EPS)
        for got in (rd.counts[diff], rc.counts[diff]):
            check(bool(((got >= lo) & (got <= hi)).all()),
                  "dense and indexed counts differ beyond the eps boundary")
    rec = {
        "phase": "pairs", "dataset": "CoocTexture", "points": int(n), "dims": int(d.shape[1]),
        "eps": COOC_EPS, "results": rc.stats.num_results, "tile_pairs": rc.stats.num_tile_pairs_evaluated,
        "count_s": count_s, "pairs_s": pairs_s, "dense_count_s": dense_s,
        "overflow_retries": rp.stats.overflow_retries, "pairs_capacity": rp.stats.pairs_capacity,
        "pairs_chunks": rp.stats.num_chunks, "pairs_dispatches": rp.stats.num_device_dispatches,
        "dense_pairs_s": dense_pairs_s, "dense_overflow_retries": rdp.stats.overflow_retries,
        "dense_tile_pairs": rd.stats.num_tile_pairs_evaluated, "dense_execution": rd.stats.execution,
        "dense_vs_indexed_boundary_diffs": int(diff.size),
    }
    emit(rec)
    return rec


def phase_profile(torch, engine, n_chunks=400):
    """Where a count chunk's time goes on the main path: a window of
    Syn16D2M count chunks, timed bare and then under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.engine import count_chunk_step
    from repro_torch.kernels import ops

    snap, cfg = engine.snapshot, engine.config
    chunks = snap.chunks(engine.engine.count_chunk)
    window = chunks[len(chunks) // 2: len(chunks) // 2 + n_chunks]
    counts = torch.zeros(snap.num_points + 1, dtype=torch.int32, device="cuda")
    skipped = torch.zeros((), dtype=torch.int32, device="cuda")

    def run():
        for pa, pb, real in window:
            count_chunk_step(counts, skipped, snap.tiles, snap.tile_len, snap.tile_start,
                             pa, pb, real, cfg.eps, dim_block=cfg.dim_block,
                             shortc=cfg.shortc, backend=ops.backend_name("indexed", cfg.use_pallas))
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / len(window)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    by_name = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = evt.cuda_time_total
        if us > 0:
            key = "K1 tile_pair_kernel" if "tile_pair_kernel" in evt.key else evt.key[:60]
            by_name[key] = by_name.get(key, 0.0) + us / len(window) / 1e3
    device = sum(by_name.values())
    rec = {
        "phase": "profile", "chunks": len(window), "wall_ms_per_chunk": wall_ms,
        "device_ms_per_chunk": device, "device_busy_share": device / wall_ms if wall_ms else None,
        "top_kernels_ms_per_chunk": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8]),
        "smi": smi_sample(),
    }
    emit(rec)
    return rec


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from repro_torch.core import SelfJoinConfig, SelfJoinEngine, self_join
        from repro_torch.data import paper_dataset
        from repro_torch.kernels import _build, dense_tile, distance_tile
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here ({exc})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # the exactness contract needs IEEE fp32
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    phase_device(torch, _build)
    fns = kernel_fns()
    emit({"phase": "kernels_sweep", **phase_sweep(torch, np, fns)})

    # main-path inputs: build the phase-3 and phase-4 engines (host plans)
    syn = paper_dataset("Syn16D2M", SYN_N / 2_000_000)
    syn_cfg = SelfJoinConfig(eps=SYN_EPS)
    t0 = time.perf_counter()
    syn_engine = SelfJoinEngine(syn, syn_cfg)
    syn_host_s = time.perf_counter() - t0
    cooc = paper_dataset("CoocTexture", 1.0)
    cooc_cfg = SelfJoinConfig(eps=COOC_EPS)
    cooc_engine = SelfJoinEngine(cooc, cooc_cfg)
    emit({"phase": "plans", "syn16d2m_host_plan_s": syn_host_s,
          "syn16d2m_tile_pairs": syn_engine.plan.num_pairs,
          "cooc_tile_pairs": cooc_engine.plan.num_pairs})

    def chunk_of(snap_tables, plan, size, d):
        mid = max(0, min(plan.num_pairs - size, plan.num_pairs // 2))
        pa = torch.from_numpy(plan.pair_a[mid:mid + size].copy()).cuda()
        pb = torch.from_numpy(plan.pair_b[mid:mid + size].copy()).cuda()
        return snap_tables.tiles, snap_tables.tile_len, pa, pb, int(d.shape[1])

    syn_snap = syn_engine.snapshot
    cooc_snap = cooc_engine.snapshot
    cooc_dense = cooc_snap.dense_tables()
    db = syn_cfg.dim_block
    eng_cfg = syn_engine.engine
    inputs = {
        "tile_pair_distance": (*chunk_of(syn_snap, syn_snap.plan, eng_cfg.count_chunk, syn), SYN_EPS, db,
                               "Syn16D2M indexed chunk"),
        "tile_pair_distance_mask": (*chunk_of(cooc_snap, cooc_snap.plan, eng_cfg.pairs_chunk, cooc), COOC_EPS, db,
                                    "CoocTexture indexed chunk"),
        "dense_tile_distance": (*chunk_of(cooc_dense, cooc_dense.plan, eng_cfg.count_chunk, cooc), COOC_EPS, db,
                                "CoocTexture dense chunk"),
        "dense_tile_distance_mask": (*chunk_of(cooc_dense, cooc_dense.plan, eng_cfg.pairs_chunk, cooc), COOC_EPS, db,
                                     "CoocTexture dense chunk"),
    }
    real = phase_real_width(torch, np, fns, inputs)

    # the main path: counters from 0, phases 3 and 4, counters read after
    for mod in (distance_tile, dense_tile):
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0
    phase_count(torch, np, syn_engine, syn, syn_host_s)
    k1_after_count = distance_tile.LAUNCHES["tile_pair_distance"]
    dense_cfg = dataclasses.replace(cooc_cfg, execution="dense")
    phase_pairs(torch, np, cooc_engine, cooc, dense_cfg, self_join)
    launches = {**distance_tile.LAUNCHES, **dense_tile.LAUNCHES}
    check(k1_after_count > 0, "phase 3 launched no counts kernel")
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched on the main path")
    phase_profile(torch, syn_engine)  # after the counters are read

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][1], "replaces": KERNELS[name][2],
         "launches": launches[name], "max_abs_err": real[name]["max_abs_err"],
         "ms": real[name]["ms"], "plain_ms": real[name]["plain_ms"],
         "bound_ms": real[name]["bound_ms"], "bound_by": real[name]["bound_by"],
         "library_ms": real[name]["library_ms"]}
        for name in KERNELS
    ], "wall_s": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
