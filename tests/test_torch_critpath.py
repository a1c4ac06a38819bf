"""Critical-path extraction in `hyperspace_tpu_torch` against the JAX
package: the same counter bags decompose to EQUAL dicts in both packages
(exact), the closed segment set and its sum-exact contract, counter
publication, span classification, and the stamp every port query gets
at finish.

Process state: each test starts from an empty port flight ring and a
fresh port sampler (`timeseries.reset_sampler`), and leaves them so.
"""

import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401

from hyperspace_tpu import telemetry as jtelemetry
from hyperspace_tpu.telemetry import critical_path as jcp
from hyperspace_tpu_torch import HyperspaceConf, HyperspaceSession, col
from hyperspace_tpu_torch import telemetry
from hyperspace_tpu_torch.telemetry import critical_path, flight, timeseries
from hyperspace_tpu_torch.telemetry.critical_path import (SEGMENT_SOURCES,
                                                          SEGMENTS,
                                                          SUM_EXACT_EPSILON_S)


@pytest.fixture(autouse=True)
def fresh_port_state():
    timeseries.reset_sampler()
    flight.get_recorder().clear()
    yield
    timeseries.reset_sampler()
    flight.get_recorder().clear()


def _counter(name):
    # Unrounded (`counters_dict()` rounds to 6 decimals).
    return telemetry.get_registry().series_snapshot()["counters"].get(
        name, 0)


def _bag(seed):
    """A seeded per-query counter bag over every segment source (some
    absent, some negative, some large enough to overlap the wall) plus
    counters no segment reads, and the query's wall."""
    rng = np.random.default_rng(seed)
    bag = {}
    for source in SEGMENT_SOURCES.values():
        pick = rng.random()
        if pick < 0.2:
            continue
        if pick < 0.3:
            bag[source] = -float(rng.random())
        else:
            bag[source] = float(rng.random() * 10.0 ** rng.integers(-6, 1))
    bag["plan_s"] = float(rng.random())
    bag["device.bytes_accessed"] = float(rng.integers(0, 1 << 40))
    return bag, float(rng.random() * 10.0 ** rng.integers(-4, 1))


def _finished(pkg, bag, wall, tag="q"):
    qm = pkg.QueryMetrics(description=tag)
    for source, s in bag.items():
        qm.add_seconds(source, s)
    qm.finish()
    qm.wall_s = wall
    return qm


def test_segment_set_and_sources_are_the_jax_packages():
    assert SEGMENTS == jcp.SEGMENTS
    assert SEGMENT_SOURCES == jcp.SEGMENT_SOURCES
    assert SUM_EXACT_EPSILON_S == jcp.SUM_EXACT_EPSILON_S


@pytest.mark.parametrize("seed", range(12))
def test_decompose_equals_jax_on_seeded_bags(seed):
    bag, wall = _bag(seed)
    got = critical_path.decompose(_finished(telemetry, bag, wall))
    want = jcp.decompose(_finished(jtelemetry, bag, wall))
    assert got == want
    assert set(got["segments"]) == set(SEGMENTS)
    assert abs(got["sum_s"] - got["wall_s"]) <= SUM_EXACT_EPSILON_S


def test_decompose_unfinished_is_none():
    qm = telemetry.QueryMetrics(description="unfinished")
    assert critical_path.decompose(qm) is None
    assert critical_path.stamp(qm) is None


def test_overlap_reported_and_sum_stays_exact():
    qm = _finished(telemetry, {"link.h2d_s": 5.0, "device.dispatch_s": 5.0},
                   0.5)
    cp = critical_path.decompose(qm)
    assert cp["segments"]["host_python"] == pytest.approx(-9.5)
    assert cp["overlap_s"] == pytest.approx(9.5)
    assert abs(cp["sum_s"] - cp["wall_s"]) <= SUM_EXACT_EPSILON_S


def test_stamp_attaches_and_publishes_monotonic_counters():
    before = {k: _counter(k) for k in (
        "critpath.queries", "critpath.wall.seconds",
        "critpath.device_dispatch.seconds", "critpath.overlap.seconds")}
    qm = _finished(telemetry, {"device.dispatch_s": 0.25}, 1.0)
    cp = critical_path.stamp(qm)
    assert qm.critical_path is cp
    assert qm.to_dict()["critical_path"] == cp
    assert qm.summary()["critical_path"]["wall_s"] == cp["wall_s"]
    assert _counter("critpath.queries") == before["critpath.queries"] + 1
    assert _counter("critpath.device_dispatch.seconds") == pytest.approx(
        before["critpath.device_dispatch.seconds"] + 0.25)
    over = _finished(telemetry, {"link.h2d_s": 2.0}, 1.0)
    critical_path.stamp(over)
    assert _counter("critpath.overlap.seconds") == pytest.approx(
        before["critpath.overlap.seconds"] + 1.0)


@pytest.mark.parametrize("cat,name", [
    ("compile", "compile hash_buckets"), ("compile.aot", "warmup"),
    ("link", "h2d 4,096B"), ("link", "d2h 8B"), ("cache", "segcache.fill"),
    ("serve.batch", "gather"), ("plan", "rewrite"), ("serving", "admit"),
    ("operator", "Scan"),
])
def test_span_classification_equals_jax(cat, name):
    assert critical_path._classify_span(cat, name) == \
        jcp._classify_span(cat, name)


def test_span_timeline_classifies_the_tracer_ring():
    qm = telemetry.QueryMetrics(description="timeline")
    telemetry.enable_tracing()
    try:
        with telemetry.recording(qm):
            with telemetry.span("Scan", "operator"):
                telemetry.record_link_transfer("h2d", 4096, 0.0)
        qm.finish()
        timeline = critical_path.span_timeline(qm)
    finally:
        telemetry.disable_tracing()
    segments = {s["name"].split()[0]: s["segment"]
                for s in timeline["spans"]}
    assert segments == {"Scan": "host_python", "h2d": "link_h2d"}
    assert critical_path.span_timeline(qm) is None  # tracing off


@pytest.fixture
def source(tmp_path):
    rng = np.random.default_rng(3)
    data = tmp_path / "data"
    data.mkdir()
    pq.write_table(pa.table({
        "a": rng.integers(0, 100, 4000).astype(np.int64),
        "v": rng.random(4000),
    }), str(data / "part-0.parquet"))
    return str(data)


def _session(tmp_path, **conf):
    settings = {"spark.hyperspace.warehouse.dir": str(tmp_path / "wh"),
                "spark.hyperspace.execution.min.device.rows": "0"}
    settings.update(conf)
    return HyperspaceSession(HyperspaceConf(settings), device="cpu")


def test_collect_stamps_every_query_and_sums_to_its_wall(tmp_path, source):
    sess = _session(tmp_path)
    df = sess.read_parquet(source).filter(col("a") > 50)
    seq0 = flight.get_recorder().last_seq
    _table, qm = df.collect(with_metrics=True)
    df.collect()
    fresh, _last = flight.get_recorder().snapshot(seq0)
    assert len(fresh) == 2 and fresh[0] is qm
    for m in fresh:
        cp = m.critical_path
        assert set(cp["segments"]) == set(SEGMENTS)
        assert abs(cp["sum_s"] - m.wall_s) <= SUM_EXACT_EPSILON_S
    # The filter's gather ran through the device seam (timed on the CPU).
    assert qm.critical_path["segments"]["device_dispatch"] == \
        pytest.approx(qm.counters["device.dispatch_s"], abs=1e-6)
    assert qm.critical_path["segments"]["device_dispatch"] > 0


def test_critpath_disabled_by_conf(tmp_path, source):
    sess = _session(tmp_path, **{
        "spark.hyperspace.telemetry.critpath.enabled": "false"})
    _table, qm = sess.read_parquet(source).filter(col("a") > 50).collect(
        with_metrics=True)
    assert qm.critical_path is None
    assert "critical_path" not in qm.to_dict()


def test_window_shares_from_scripted_ticks(tmp_path, source):
    sess = _session(tmp_path)
    sampler = timeseries.get_sampler()
    t0 = time.time()
    sampler.tick(t=t0)
    df = sess.read_parquet(source).filter(col("a") > 50)
    for _ in range(3):
        df.collect()
    sampler.tick(t=t0 + 1.0)
    shares = critical_path.window_shares(since_t=t0)
    assert shares["queries_per_s"] == pytest.approx(3.0)
    assert shares["dominant"] in SEGMENTS
    total = sum(shares["shares"].values())
    assert total == pytest.approx(1.0 + shares["overlap"], abs=0.02)
    gauges = telemetry.get_registry().series_snapshot()["gauges"]
    assert f"window.critpath.{shares['dominant']}.share" in gauges


def test_window_shares_empty_window_renders_shape():
    sampler = timeseries.get_sampler()
    sampler.tick()
    out = critical_path.window_shares(since_t=time.time() + 60)
    assert out["queries_per_s"] == 0.0
    assert set(out["shares"]) == set(SEGMENTS)
    assert out["dominant"] is None
