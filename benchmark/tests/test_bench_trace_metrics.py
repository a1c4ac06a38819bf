"""The six readers of the port's span fold (`trace.*` counters) on a
synthetic window: each reads its window delta per query, and each reads
nothing where the program keeps no fold."""

import json

import pytest

from benchmark import harness, spec
from benchmark.tests.cells import ROOT

READERS = ("query.offcpu_share", "rules.ms_per_query",
           "engine.plan_ms_per_query", "engine.op_cpu_ms_per_query",
           "device.wait_ms_per_query", "telemetry.ms_per_query")

# 40 queries, 10 of them reading the CPU clock (their wall 1 s).
FOLD = {"trace.queries": 40.0,
        "trace.query.wall_s": 4.0,
        "trace.query.cpu_sampled": 10.0,
        "trace.query.cpu_sampled_wall_s": 1.0,
        "trace.query.thread_cpu_s": 0.75,
        "trace.rules.wall_s": 0.02,
        "trace.plan.wall_s": 0.08,
        "trace.operators.cpu_s": 0.3,
        "trace.operators.wall_s": 1.6,
        "trace.device_wait.wall_s": 0.6,
        "trace.telemetry.wall_s": 0.04}


def _readings(counters):
    return harness.Readings(
        completed=40, window_s=10.0, counters=counters, histograms={},
        window_trace=None, build_trace=None, build_s=0.0, index_keys={},
        device_kind="NVIDIA H100 80GB HBM3")


def read(name, r):
    return spec.metric_reader(ROOT, name)(r)


@pytest.mark.parametrize("name,want", [
    ("query.offcpu_share", 25.0),
    ("rules.ms_per_query", 0.5),
    ("engine.plan_ms_per_query", 2.0),
    ("engine.op_cpu_ms_per_query", 30.0),
    ("device.wait_ms_per_query", 15.0),
    ("telemetry.ms_per_query", 1.0),
])
def test_each_reader_divides_its_delta_by_the_queries(name, want):
    assert read(name, _readings(dict(FOLD))) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_no_fold_reads_nothing(name):
    """A program without the fold (the parent of the change that adds
    it) leaves the counters out: the reader returns None, never raises."""
    assert read(name, _readings({"link.h2d.bytes": 5e6})) is None
    assert read(name, _readings({**FOLD, "trace.queries": 0.0})) is None


@pytest.mark.parametrize("name", ["query.offcpu_share",
                                  "engine.op_cpu_ms_per_query"])
def test_no_cpu_sample_reads_nothing(name):
    """The CPU readers divide by the queries that read the CPU clock: a
    window with none reads nothing."""
    assert read(name, _readings({**FOLD, "trace.query.cpu_sampled": 0.0,
                                 "trace.query.cpu_sampled_wall_s": 0.0,
                                 "trace.query.thread_cpu_s": 0.0,
                                 "trace.operators.cpu_s": 0.0})) is None


def test_every_reader_has_its_entry():
    with open(f"{ROOT}/BENCHMARK.json") as f:
        entries = {m["name"]: m for m in json.load(f)["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert m["source"] == "program_counter" and m["better"] == "lower"
        assert m["workloads"] == ["tpch-sf1.unindexed-streams"]
