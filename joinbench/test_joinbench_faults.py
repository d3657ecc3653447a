"""A run with the timed path broken underneath comes out not correct.

The harness runs as on the card but for the look for a card (the plain
PyTorch versions of the kernels on the CPU), on a tiny benchmark, with the
program's chunk step broken in each way the cells can be: a step that
leaves its state unchanged, half of the chunks left out, one answer
altered where it is produced.  (The cells run on one card: there is no
exchange between cards to leave out.)
"""
import json

import pytest

from joinbench import harness
from repro_torch.core import engine as engine_mod


def unchanged(make):
    def broken(*args, **kwargs):
        make(*args, **kwargs)
        return lambda pa, pb, real: None
    return broken


def half_left_out(make):
    def broken(*args, **kwargs):
        step = make(*args, **kwargs)
        seen = [0]

        def run(pa, pb, real):
            seen[0] += 1
            if seen[0] % 2:
                step(pa, pb, real)
        return run
    return broken


def altered(make):
    """After the real step, one answer is changed where it is produced: a
    count in the counts vector, or the partner of the last pair written."""
    def broken(*args, **kwargs):
        step = make(*args, **kwargs)
        state = args[0]

        def run(pa, pb, real):
            step(pa, pb, real)
            if state.dim() == 1:
                state[0] += 1
            else:
                offset = int(args[1])
                if offset:
                    state[offset - 1, 1] = (state[offset - 1, 1] + 1) % 400
        return run
    return broken


def run_tiny(root, here, workload):
    result, numbers = harness.run(root, workload, seed=2 ** 31 + 77, seconds=0.01, trace=False, device="cpu",
                                  here=here, log=lambda m: None)
    return result, numbers


@pytest.mark.parametrize("workload,factory", [("tiny.count", "count_step"), ("tiny.pairs", "pairs_step")])
@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered])
def test_a_broken_step_is_not_correct(tiny, monkeypatch, workload, factory, fault):
    root, here = tiny
    monkeypatch.setattr(engine_mod, factory, fault(getattr(engine_mod, factory)))
    result, numbers = run_tiny(root, here, workload)
    assert result["correct"] is False, numbers
    assert result["checks"] == {k: {"value": v, "limit": 0} for k, v in numbers.items()}


@pytest.mark.parametrize("workload", ["tiny.count", "tiny.pairs"])
def test_the_sound_program_is_correct(tiny, workload):
    root, here = tiny
    result, numbers = run_tiny(root, here, workload)
    assert result["correct"] is True and not any(numbers.values())
    assert list(result)[-1] == "checks" and result["attempted"] >= 1 and result["failed"] == 0
    e2e = "count_join_s" if workload == "tiny.count" else "pairs_join_s"
    assert set(result["metrics"]) == {"setup_s", e2e}


def test_an_altered_count_is_caught_where_the_cell_samples(tiny, monkeypatch):
    """A run checks every point of its first join and a sample in the
    others: one count altered in every join is caught in the first, however
    few rows the others sample."""
    root, here = tiny
    path = here / "traffic" / "tiny.count.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), check_rows=8)))
    monkeypatch.setattr(engine_mod, "count_step", altered(engine_mod.count_step))
    result, numbers = run_tiny(root, here, "tiny.count")
    assert result["correct"] is False and numbers["rows_outside_band"] >= 1, numbers
