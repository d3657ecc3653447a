"""BENCHMARK.json names files the harness finds, and a new configuration,
traffic mix or metric is taken as new files, with no file edited."""
import hashlib
import json
from pathlib import Path

import pytest

from joinbench import generator, harness, spec

ROOT = Path(__file__).resolve().parents[1]


def test_benchmark_json_keeps_the_rules():
    bench = spec.load_benchmark(ROOT)
    assert bench["paths"] == ["joinbench"] and bench["command"] == ["python3", "joinbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    for c in bench["configs"]:
        assert c["file"].startswith("joinbench/configs/") and (ROOT / c["file"]).is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.load_reader(m["name"]).read), m["name"]


def test_every_cell_loads_and_reuses_its_index():
    bench = spec.load_benchmark(ROOT)
    for w in bench["workloads"]:
        cell = spec.load_cell(ROOT, w["name"], bench=bench)
        assert cell.mode in generator.MODES
        assert generator.index_eps(cell.traffic) <= cell.config["self_join"]["eps"]
        assert [m["name"] for m in cell.end_to_end][0] == "setup_s" and cell.per_layer


def test_a_problem_is_named():
    bench = spec.load_benchmark(ROOT)
    with pytest.raises(KeyError, match="no workload 'no.such.cell'"):
        spec.load_cell(ROOT, "no.such.cell", bench=bench)
    bench["configs"].append(dict(bench["configs"][0], name="another-config"))
    bench["workloads"][0]["config"] = "another-config"  # its traffic names the first config
    with pytest.raises(ValueError, match="is for config"):
        spec.load_cell(ROOT, bench["workloads"][0]["name"], bench=bench)


def _digests(here: Path):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in sorted(here.rglob("*")) if p.is_file()}


def test_new_config_traffic_and_metric_are_new_files(tiny):
    root, here = tiny
    before = _digests(here)
    (here / "configs" / "tiny-uniform.json").write_text(json.dumps(
        {"num_points": 300, "num_dims": 8, "data": {"kind": "uniform"},
         "self_join": {"eps": 0.3, "k": 4, "tile_size": 16, "dim_block": 8, "execution": "indexed"}}))
    (here / "traffic" / "tiny-uniform.count.json").write_text(json.dumps(
        {"config": "tiny-uniform", "mode": "count", "eps_range": [0.2, 0.3], "eps_steps": 2,
         "trace_joins": 1, "check_rows": 100}))
    (here / "metrics" / "joins_in_window.py").write_text(
        "def read(ctx):\n    return float(len(ctx.joins)) if ctx.trace is None else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-uniform", "source": "a test", "file": "bench/configs/tiny-uniform.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-uniform.count", "config": "tiny-uniform",
                               "traffic": "tiny-uniform.count", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "joins_in_window", "unit": "joins", "better": "higher", "bound": 0.25,
                                "source": "host_clock", "workloads": ["tiny-uniform.count"]})
    bench["end_to_end"][1]["workloads"].append("tiny-uniform.count")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert all(_digests(here)[p] == d for p, d in before.items())  # nothing that was there changed
    result, _ = harness.run(root, "tiny-uniform.count", seed=5, seconds=0.01, trace=False, device="cpu",
                            here=here, log=lambda m: None)
    assert result["correct"]
    assert set(result["metrics"]) == {"setup_s", "count_join_s", "joins_in_window"}
    assert result["metrics"]["joins_in_window"]["value"] == result["attempted"]
