"""The comparison fails what it must: the control (the reference computed
in float32, the precision below the configurations' float64) and the
program with its timed path broken underneath."""

import threading

import pyarrow as pa
import pytest

from benchmark import control, harness
from benchmark.tests.cells import ROOT, SEED, run_tiny, tiny_cell
from benchmark.tests.test_bench_spec import CELLS


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(name):
    cell = tiny_cell(name)
    out = control.read_control(ROOT, cell, SEED)
    limit = cell.config["limits"]["max_rel_gap"]
    assert out["wrong_results"] > 0 or out["max_rel_gap"] > limit, out


def _altered(table):
    """The result with its first number changed where it is produced."""
    for i, f in enumerate(table.schema):
        if pa.types.is_floating(f.type) or pa.types.is_integer(f.type):
            values = table.column(i).to_pylist()
            if values and values[0] is not None:
                values[0] = values[0] * 1.001 + 1
                return table.set_column(i, f, pa.array(values, f.type))
    return table.slice(1)


def _fault_altered_answer(monkeypatch):
    from hyperspace_tpu_torch.engine.dataframe import DataFrame
    real = DataFrame.collect

    def collect(self, *a, **kw):
        return _altered(real(self, *a, **kw))
    monkeypatch.setattr(DataFrame, "collect", collect)


def _fault_half_the_rows(monkeypatch):
    from hyperspace_tpu_torch.io import parquet
    real = parquet._read_one

    def read_one(path, cols):
        table = real(path, cols)
        return table.slice(0, table.num_rows // 2)
    monkeypatch.setattr(parquet, "_read_one", read_one)


def _fault_stale_answer(monkeypatch):
    """Each collect returns what the stream's previous collect returned."""
    from hyperspace_tpu_torch.engine.dataframe import DataFrame
    real = DataFrame.collect
    last = threading.local()

    def collect(self, *a, **kw):
        fresh = real(self, *a, **kw)
        out = getattr(last, "table", fresh)
        last.table = fresh
        return out
    monkeypatch.setattr(DataFrame, "collect", collect)


FAULTS = {"altered_answer": _fault_altered_answer,
          "half_the_rows": _fault_half_the_rows,
          "stale_answer": _fault_stale_answer}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    """The fault goes in as the window opens, after an intact set-up."""
    from hyperspace_tpu_torch.io import parquet, segcache
    real_drive = harness.drive

    def drive(*args, **kwargs):
        parquet.clear_read_cache()
        segcache.clear()
        FAULTS[fault](monkeypatch)
        return real_drive(*args, **kwargs)
    monkeypatch.setattr(harness, "drive", drive)
    r = run_tiny("tpch-sf1.unindexed-streams", seconds=1.0)
    assert r["correct"] is False, r["compared"]


def test_the_judge_counts_a_failed_query():
    rec = harness.Record("q1", 0.0, 1.0, error="Traceback: boom")
    out = harness.judge([rec], {}, {}, {"max_rel_gap": 1e-9})
    assert out["compared"]["failed_queries"]["value"] == 1
