"""``BENCHMARK.json`` and the files it names, found by name.

- a cell (``workloads[]``) names a configuration and a traffic mix;
- a configuration's ``file`` holds its sizes and settings;
- a traffic mix ``T`` is ``traffic/T.json`` beside this file;
- a metric ``M`` is read by ``metrics/M.py``, whose ``read(ctx)`` returns
  its value or ``None`` where the run has nothing to read it from.

A new cell, configuration or metric is a new file and a new entry:
nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import List

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def mode(self) -> str:
        return self.traffic["mode"]


def load_benchmark(root: Path) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(root: Path, workload: str, *, bench: dict = None, here: Path = HERE) -> Cell:
    """The cell ``workload`` of the benchmark at ``root``, with its files."""
    bench = bench if bench is not None else load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(Path(root) / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(Path(here) / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    if traffic.get("config") != w["config"]:
        raise ValueError(f"traffic {w['traffic']!r} is for config {traffic.get('config')!r}, "
                         f"the cell names {w['config']!r}")
    return Cell(
        name=workload, config_name=w["config"], config=config, traffic_name=w["traffic"], traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if applies(m, workload)],
    )


def load_reader(name: str, here: Path = HERE):
    """The module ``metrics/<name>.py`` (a metric name may hold dots)."""
    path = Path(here) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("joinbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

