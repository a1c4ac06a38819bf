"""BENCHMARK.json keeps to the benchmark's contract, and every cell,
mix, configuration and metric is found by name."""

import json
import os
import re
import shutil

import pytest

from benchmark import spec
from benchmark.tests.cells import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}


def test_paths_and_command_stay_inside():
    assert BENCH["paths"] == ["benchmark"]
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert os.path.exists(os.path.join(ROOT, BENCH["command"][1]))
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_by_name(name):
    cell = spec.find_cell(ROOT, name)
    fam = spec.load_family(cell.config)
    assert cell.chips == 1
    for q in cell.traffic["queries"]:
        assert q in fam.builders and q in fam.oracles, q
    for index in cell.config["indexes"]:
        assert index in fam.index_defs, index
    assert cell.config["limits"]["max_rel_gap"] > 0
    for m in cell.per_layer:
        assert callable(spec.metric_reader(ROOT, m["name"]))


def test_config_files_state_their_cut():
    for c in BENCH["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            config = json.load(f)
        assert config["name"] == c["name"]
        assert config["reduced"] == c["reduced"]
        assert set(c["reduced"]) <= set(config["assumed"])


def test_a_new_mix_and_metric_are_found_by_name(tmp_path):
    """A later PR adds a mix, a cell and a metric as files and entries."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("_work", "_out", "_cache"))
    bench = json.loads(json.dumps(BENCH))
    (root / "benchmark" / "traffic" / "tpch-q6-only.json").write_text(
        json.dumps({"loop": "closed-rotation", "streams": 2,
                    "warmup_passes": 1, "queries": ["q6"]}))
    (root / "benchmark" / "metrics" / "window.length_s.py").write_text(
        "def read(r):\n    return r.window_s\n")
    bench["workloads"].append({"name": "tpch-sf1.q6-only", "config": "tpch-sf1",
                               "traffic": "tpch-q6-only", "chips": 1,
                               "why": "one query"})
    bench["per_layer"].append({"name": "window.length_s", "unit": "s",
                               "better": "lower", "source": "host_clock",
                               "layer": "benchmark", "moves": "qps",
                               "workloads": ["tpch-sf1.q6-only"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.find_cell(str(root), "tpch-sf1.q6-only")
    assert cell.traffic["queries"] == ["q6"] and cell.traffic["streams"] == 2
    assert [m["name"] for m in cell.per_layer][-1] == "window.length_s"
    old = spec.find_cell(str(root), CELLS[0])
    assert "window.length_s" not in [m["name"] for m in old.per_layer]

    class R:
        window_s = 3.5
    assert spec.metric_reader(str(root), "window.length_s")(R()) == 3.5
