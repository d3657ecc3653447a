"""Fixtures of the benchmark's own tests: a tiny benchmark in a temporary
checkout, with configurations, traffic and readers as files of their own."""
import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))  # the program, as the harness finds it


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card (the port's CUDA kernels); skips without one",
    )


TINY_CONFIGS = {
    "tiny-indexed": {"num_points": 600, "num_dims": 16, "data": {"kind": "exponential", "lam": 40.0},
                     "self_join": {"eps": 0.1, "k": 6, "tile_size": 16, "dim_block": 8, "execution": "indexed"},
                     "engine": {"count_chunk": 64, "pairs_chunk": 32}},
    "tiny-dense": {"num_points": 500, "num_dims": 12, "data": {"kind": "clustered", "num_clusters": 8,
                                                               "cluster_std": 0.05},
                   "self_join": {"eps": 0.2, "k": 4, "tile_size": 16, "dim_block": 8, "execution": "dense"},
                   "engine": {"count_chunk": 64, "pairs_chunk": 32}},
}
TINY_TRAFFIC = {
    "tiny.count": {"config": "tiny-indexed", "mode": "count", "eps_range": [0.06, 0.1], "eps_steps": 4,
                   "trace_joins": 2, "check_rows": 10 ** 9},
    "tiny.pairs": {"config": "tiny-dense", "mode": "pairs", "eps_range": [0.1, 0.2], "eps_steps": 4,
                   "trace_joins": 2, "check_rows": 10 ** 9},
}


def write_tiny(root: Path) -> Path:
    """A checkout at ``root`` with a tiny ``BENCHMARK.json``, its own
    configurations and traffic, and a copy of the harness's readers; returns
    the harness folder (``here``)."""
    here = root / "bench"
    shutil.copytree(HERE / "metrics", here / "metrics", ignore=shutil.ignore_patterns("__pycache__"))
    (here / "configs").mkdir()
    (here / "traffic").mkdir()
    for name, cfg in TINY_CONFIGS.items():
        (here / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, trf in TINY_TRAFFIC.items():
        (here / "traffic" / f"{name}.json").write_text(json.dumps(trf))
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["paths"] = ["bench"]
    bench["configs"] = [{"name": n, "source": "a test", "file": f"bench/configs/{n}.json", "reduced": [],
                         "why": "a test"} for n in TINY_CONFIGS]
    bench["workloads"] = [{"name": n, "config": t["config"], "traffic": n, "chips": 1, "why": "a test"}
                          for n, t in TINY_TRAFFIC.items()]
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            if "workloads" in m:
                m["workloads"] = ["tiny.count"]  # the benchmark's cells are count cells
    bench["end_to_end"].append({"name": "pairs_join_s", "unit": "s", "better": "lower", "bound": 0.25,
                                "source": "host_clock", "workloads": ["tiny.pairs"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return here


@pytest.fixture
def tiny(tmp_path):
    """(root, here) of a tiny benchmark."""
    return tmp_path, write_tiny(tmp_path)
