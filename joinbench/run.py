"""Run one cell of ``BENCHMARK.json`` on the card this process finds.

    python3 joinbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device`` (and
``breakdown`` when traced), and last ``checks``: each number the check
compared beside its limit, which also close standard error.  Exits with
another code than 0, printing no result, where there is no card (or fewer
than the cell asks for), where the program is not beside the benchmark,
or where JAX or the JAX package was loaded.
"""
import time

_T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "joinbench"  # fixed, inside the checkout


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every cache of the program and its libraries inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(CACHE / sub)
    here = Path(__file__).resolve().parent  # not a top-level import path: its module names are plain words
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [q for q in sys.path if Path(q or ".").resolve() != here]
    if not (ROOT / "src" / "repro_torch").is_dir():
        _log(f"the program (src/repro_torch) is not beside the benchmark in {ROOT}")
        return 2

    from joinbench import check, spec

    bench = spec.load_benchmark(ROOT)
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload)
    if chips is None:
        _log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"the cell needs {chips} CUDA device(s); torch finds "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    from joinbench import harness

    result, numbers = harness.run(ROOT, args.workload, seed=args.seed, seconds=args.seconds,
                                  trace=bool(args.trace), device="cuda", t0=_T0, log=_log)
    loaded = harness.forbidden_modules()
    if loaded:
        _log(f"JAX or the JAX package was loaded in the process: {loaded}")
        return 3
    for line in check.lines(numbers):
        _log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
