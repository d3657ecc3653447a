import os
import sys

# Tests default to the single real CPU device -- the 512-device flag is ONLY
# for launch/dryrun.py (see its module docstring).  CI's multi-device leg
# sets REPRO_TEST_DEVICES=8 to run the whole in-process suite against 8
# simulated host devices instead; subprocess tests (test_distributed,
# test_dist_engine, test_fused_ring, test_dryrun) set their own flag and
# strip the inherited one, so they behave identically on both legs.
_devices = os.environ.get("REPRO_TEST_DEVICES")
if _devices and _devices != "1":
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={int(_devices)}"
    )
else:
    os.environ.pop("XLA_FLAGS", None)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))  # `import oracles` from any cwd

import pytest  # noqa: E402

from oracles import DATASET_CASES, DATASET_IDS  # noqa: E402


@pytest.fixture(params=DATASET_CASES, ids=DATASET_IDS)
def dataset_case(request):
    """(name, data, eps) from the shared correctness matrix (oracles.py)."""
    return request.param


# -- tier-1 duration budget --------------------------------------------------
# `--budget-seconds N` fails the session when the summed test call time
# exceeds N: the tripwire that keeps tier-1 fast (CI passes it explicitly,
# together with --durations, so the offenders are named in the same log).

_call_durations = []


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card (the port's CUDA kernels); skips without one",
    )


def pytest_addoption(parser):
    parser.addoption(
        "--budget-seconds",
        type=float,
        default=None,
        help="fail the session if summed test call durations exceed this",
    )


def pytest_runtest_logreport(report):
    if report.when == "call":
        _call_durations.append((report.duration, report.nodeid))


def pytest_sessionfinish(session, exitstatus):
    budget = session.config.getoption("--budget-seconds")
    if budget is None or exitstatus != 0:
        return
    total = sum(d for d, _ in _call_durations)
    if total > budget:
        worst = sorted(_call_durations, reverse=True)[:10]
        lines = "\n".join(f"  {d:8.2f}s  {nid}" for d, nid in worst)
        print(
            f"\nDURATION BUDGET EXCEEDED: {total:.1f}s > {budget:.1f}s "
            f"budget; slowest tests:\n{lines}",
            file=sys.stderr,
        )
        session.exitstatus = 1
