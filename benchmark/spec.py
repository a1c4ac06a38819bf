"""Everything a run needs, found by name from `BENCHMARK.json`.

A cell names a configuration and a traffic mix; the configuration's
`file` holds its sizes and names the modules of its data generator, its
query builders and its plain reference; the mix is
`benchmark/traffic/<traffic>.json`; a per-layer metric is read by
`benchmark/metrics/<metric>.py`. Adding any of them adds files and
entries and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(root: str, name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[w["config"]]["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic",
                           f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


def metric_reader(root: str, name: str) -> Callable:
    """`read(readings) -> Optional[float]` of `benchmark/metrics/<name>.py`."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclass
class Family:
    """A configuration's generator, builders, index definitions and
    oracles, merged from the modules its file names."""
    generate: Callable
    builders: Dict[str, Callable] = field(default_factory=dict)
    oracles: Dict[str, Callable] = field(default_factory=dict)
    index_defs: Dict[str, tuple] = field(default_factory=dict)


def load_family(config: dict, with_builders: bool = True) -> Family:
    fam = Family(generate=importlib.import_module(config["data"]).generate)
    if with_builders:
        for mod in map(importlib.import_module, config["queries"]):
            fam.builders.update(mod.BUILDERS)
            for name, table, cols, _used_by in getattr(mod, "_INDEX_DEFS", ()):
                fam.index_defs[name] = (table, cols)
    for mod in map(importlib.import_module, config["reference"]):
        fam.oracles.update(mod.ORACLES)
    return fam
