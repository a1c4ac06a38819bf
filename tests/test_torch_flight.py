"""Flight recorder of `hyperspace_tpu_torch` (`telemetry/flight.py`):
the ring and its cursor, the slow-query dump and its pruning, and the
dump format shared with the JAX package — a dump written by either
package loads in the other's `load_dump`, and both packages' differs
attribute the dumped tree against a live one identically.

Process state: every test starts and ends with both packages' process
flight rings empty (`get_recorder().clear()`) and their dump lanes
drained (`drain()`).
"""

import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401

import hyperspace_tpu as jhs
from hyperspace_tpu.telemetry import diff as jdiff
from hyperspace_tpu.telemetry import flight as jflight
import hyperspace_tpu_torch as ths
from hyperspace_tpu_torch import telemetry
from hyperspace_tpu_torch.telemetry import diff, flight


@pytest.fixture(autouse=True)
def empty_rings():
    for rec in (flight.get_recorder(), jflight.get_recorder()):
        rec.drain()
        rec.clear()
    yield
    for rec in (flight.get_recorder(), jflight.get_recorder()):
        rec.drain()
        rec.clear()


def _finished(tag, tenant=None):
    qm = telemetry.QueryMetrics(description=tag)
    op = qm.start_operator("Scan")
    qm.finish_operator(op, rows_out=5)
    qm.finish()
    qm.tenant = tenant
    return qm


@pytest.fixture
def source(tmp_path):
    rng = np.random.default_rng(3)
    data = tmp_path / "sales"
    data.mkdir()
    pq.write_table(pa.table({
        "key": rng.integers(0, 50, 2000).astype(np.int64),
        "qty": rng.integers(1, 10, 2000).astype(np.int64),
    }), str(data / "part-0.parquet"))
    return str(data)


def _session(pkg, tmp_path, **extra):
    conf = {"spark.hyperspace.warehouse.dir": str(tmp_path / "wh"),
            "spark.hyperspace.distribution.enabled": "false"}
    conf.update(extra)
    if pkg is ths:
        return ths.HyperspaceSession(ths.HyperspaceConf(conf), device="cpu")
    return jhs.HyperspaceSession(jhs.HyperspaceConf(conf))


def test_ring_is_bounded_and_keeps_newest():
    rec = flight.FlightRecorder(capacity=4)
    for i in range(10):
        rec.record(_finished(f"q{i}"))
    assert [m.description for m in rec.queries()] == \
        ["q6", "q7", "q8", "q9"]
    assert [m.description for m in rec.queries(2)] == ["q8", "q9"]
    assert flight.CAPACITY == jflight.CAPACITY


def test_snapshot_cursor_and_tenant_filter():
    rec = flight.FlightRecorder(capacity=8)
    for i in range(5):
        rec.record(_finished(f"q{i}", tenant="acme" if i % 2 else None))
    fresh, last = rec.snapshot(0)
    assert [m.flight_seq for m in fresh] == [1, 2, 3, 4, 5] and last == 5
    fresh, last = rec.snapshot(3)
    assert [m.description for m in fresh] == ["q3", "q4"]
    fresh, last = rec.snapshot(0, tenant="acme")
    assert [m.description for m in fresh] == ["q1", "q3"] and last == 5
    rec.clear()
    assert rec.snapshot(last) == ([], 5)
    rec.record(_finished("q5"))
    assert rec.last_seq == 6


def test_collect_feeds_the_ring(tmp_path, source):
    sess = _session(ths, tmp_path)
    df = sess.read_parquet(source).filter(ths.col("qty") > 5).select("key")
    df.collect()
    df.collect()
    queries = telemetry.get_recorder().queries()
    assert len(queries) == 2
    assert queries[-1] is sess.last_query_metrics()
    assert all(q.wall_s is not None and q.critical_path for q in queries)


def _slow_conf(tmp_path, name):
    return {"spark.hyperspace.telemetry.slowlog.seconds": "0.000001",
            "spark.hyperspace.telemetry.slowlog.dir": str(tmp_path / name),
            "spark.hyperspace.telemetry.slowlog.keep": "3"}


def _dumps(path):
    return sorted(os.path.join(path, f) for f in os.listdir(path)
                  if f.startswith("slow-") and f.endswith(".json"))


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_dumps_load_in_both_packages(tmp_path, source, writer):
    pkg = ths if writer == "torch" else jhs
    sess = _session(pkg, tmp_path, **_slow_conf(tmp_path, "slow"))
    df = sess.read_parquet(source).filter(pkg.col("qty") > 5).select("key")
    _table, live = df.collect(with_metrics=True)
    sess.close()
    (path,) = _dumps(str(tmp_path / "slow"))
    ours, theirs = flight.load_dump(path), jflight.load_dump(path)
    assert ours == theirs
    assert ours["kind"] == "hyperspace-slowlog"
    assert ours["wall_s"] == live.wall_s
    assert ours["critical_path"] == live.critical_path
    assert ours["metrics"]["critical_path"] == live.critical_path
    # Both differs attribute the dumped tree against the live one alike.
    live_tree = json.loads(json.dumps(live.to_dict(), default=str))
    got = diff.diff_trees(ours["metrics"], live_tree, "q").to_dict()
    want = jdiff.diff_trees(theirs["metrics"], live_tree, "q").to_dict()
    assert got == want
    assert abs(got["delta_s"] or 0.0) < 1e-6


def test_slow_dump_respects_threshold(tmp_path, source):
    sess = _session(ths, tmp_path, **{
        "spark.hyperspace.telemetry.slowlog.seconds": "3600",
        "spark.hyperspace.telemetry.slowlog.dir": str(tmp_path / "slow")})
    sess.read_parquet(source).collect()
    sess.close()
    assert not (tmp_path / "slow").exists()


def test_slow_dump_prunes_to_keep(tmp_path):
    conf = ths.HyperspaceConf({
        "spark.hyperspace.warehouse.dir": str(tmp_path / "wh"),
        **_slow_conf(tmp_path, "slow")})
    rec = flight.FlightRecorder()
    paths = [rec.record(_finished(f"q{i}"), conf=conf) for i in range(6)]
    rec.drain()
    assert all(paths)
    kept = _dumps(str(tmp_path / "slow"))
    assert len(kept) == 3
    assert [flight.load_dump(p)["description"] for p in kept] == \
        ["q3", "q4", "q5"]
    rec.shutdown()


def test_dump_failure_never_fails_the_query(tmp_path, source):
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("x")
    sess = _session(ths, tmp_path, **{
        "spark.hyperspace.telemetry.slowlog.seconds": "0.000001",
        "spark.hyperspace.telemetry.slowlog.dir": str(blocker / "slow")})
    before = telemetry.get_registry().counters_dict().get(
        "flight.dump_errors", 0)
    assert sess.read_parquet(source).collect().num_rows == 2000
    sess.close()
    assert telemetry.get_registry().counters_dict()[
        "flight.dump_errors"] == before + 1


def test_load_dump_rejects_non_dumps(tmp_path):
    path = tmp_path / "other.json"
    path.write_text(json.dumps({"kind": "something-else"}))
    with pytest.raises(ValueError):
        flight.load_dump(str(path))


def test_dump_carries_the_trace_slice(tmp_path):
    conf = ths.HyperspaceConf({
        "spark.hyperspace.warehouse.dir": str(tmp_path / "wh"),
        **_slow_conf(tmp_path, "slow")})
    telemetry.enable_tracing()
    try:
        qm = telemetry.QueryMetrics("traced")
        with telemetry.recording(qm):
            with telemetry.span("Scan", "operator"):
                pass
        qm.finish()
        rec = flight.FlightRecorder()
        rec.record(qm, conf=conf)
        rec.shutdown()
    finally:
        telemetry.disable_tracing()
    (path,) = _dumps(str(tmp_path / "slow"))
    events = flight.load_dump(path)["trace"]["traceEvents"]
    assert [e["name"] for e in events if e.get("ph") == "X"] == ["Scan"]
