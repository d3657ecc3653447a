"""The control of the check: the reference in a lower precision, put in the
program's place, must come out not correct.

    python3 joinbench/control.py --workload NAME --seeds 11,12,13 [--joins 1] [--precision tf32]

For each seed it makes the cell's points and its first ``--joins`` radii
as a run does, computes every answer with ``reference.brute_counts`` /
``brute_pairs`` in ``--precision`` (TF32: the step below the fp32 that the
configurations state, on the card's tensor cores), and runs the run's own
check over them.  Prints one JSON line per seed with the numbers; exits
with 1 where some seed's control passed the check.  The benchmark's own
runs never run this.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_numbers(root, workload, seed, joins, precision, device, here=None):
    """The check's numbers over the control's answers to the first ``joins``
    joins of a run of ``workload`` with ``seed``."""
    from types import SimpleNamespace

    import torch

    from joinbench import check, datagen, generator, reference, spec

    cell = spec.load_cell(root, workload, here=here or spec.HERE)
    points = datagen.make_points(cell.config, seed)
    eps_iter = generator.eps_sequence(cell.traffic, seed)
    x = torch.as_tensor(points, device=device)
    answers = []
    for _ in range(joins):
        eps = next(eps_iter)
        if cell.mode == "count":
            counts = reference.brute_counts(x, eps, precision).cpu().numpy()
            answers.append(SimpleNamespace(eps=eps, counts=counts, pairs=None))
        else:
            pairs = reference.brute_pairs(x, eps, precision)
            counts = torch.bincount(pairs[:, 0].long(), minlength=x.shape[0]).cpu().numpy()
            answers.append(SimpleNamespace(eps=eps, counts=counts, pairs=pairs.cpu().numpy()))
    del x
    return check.check_joins(points, answers, mode=cell.mode, check_rows=int(cell.traffic["check_rows"]),
                             seed=seed, device=device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--joins", type=int, default=1)
    p.add_argument("--precision", default="tf32", choices=("tf32", "bf16", "fp32"))
    args = p.parse_args(argv)
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [q for q in sys.path if Path(q or ".").resolve() != here]
    import time

    import torch

    from joinbench import check

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    passed = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        numbers = control_numbers(ROOT, args.workload, seed, args.joins, args.precision, "cuda")
        passed.append(check.passed(numbers))
        print(json.dumps({"workload": args.workload, "seed": seed, "precision": args.precision,
                          "joins": args.joins, "correct": passed[-1], "numbers": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 1 if any(passed) else 0


if __name__ == "__main__":
    sys.exit(main())
