"""The port's one span system (`telemetry/trace.py`, the recorder):
one query id on every span of a query, pool threads included; parent
links and self wall / self CPU on a hand-built tree; the fold's identity
on a query whose spans run on one thread; the tracer's export on
`time.time_ns()` µs; a `torch.profiler` capture with the program's spans
merged onto its clock; and the slow-query slice cut by query id.

Process state: tracing is off at the start and the end of every test,
and the port's flight ring is empty.
"""

import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu_torch as ths
from hyperspace_tpu_torch import telemetry
from hyperspace_tpu_torch.telemetry import flight, profiler, trace


@pytest.fixture(autouse=True)
def clean_state():
    telemetry.disable_tracing()
    flight.get_recorder().clear()
    yield
    telemetry.disable_tracing()
    flight.get_recorder().drain()
    flight.get_recorder().clear()


@pytest.fixture
def source(tmp_path):
    rng = np.random.default_rng(17)
    data = tmp_path / "data"
    data.mkdir()
    pq.write_table(pa.table({
        "a": rng.integers(0, 50, 5000).astype(np.int64),
        "v": rng.random(5000),
    }), str(data / "part-0.parquet"))
    return str(data)


def _session(tmp_path, **conf):
    settings = {"spark.hyperspace.warehouse.dir": str(tmp_path / "wh"),
                "spark.hyperspace.execution.min.device.rows": "0"}
    settings.update(conf)
    return ths.HyperspaceSession(ths.HyperspaceConf(settings), device="cpu")


def _query(sess, source):
    return (sess.read_parquet(source).filter(ths.col("a") > 10)
            .group_by("a").agg(("sum", "v")))


def _span(name, layer, parent, start, end, tid=1, cpu=0):
    """A closed span with hand-set times (ns) and CPU ns."""
    sp = trace.Span(name, layer, parent, "q", tid)
    sp.start_ns, sp.end_ns = start, end
    sp.cpu_start_ns, sp.cpu_end_ns = 0, cpu
    return sp


def _counters():
    return telemetry.get_registry().series_snapshot()["counters"]


def test_one_query_id_on_every_span_pool_threads_included():
    qm = telemetry.QueryMetrics("pool", query_id="q-pool")
    main_tid = threading.get_native_id()

    def work(i):
        op = telemetry.current().start_operator(f"Child{i}")
        with telemetry.span("sync:child", "device_wait"):
            time.sleep(0.001)
        telemetry.current().finish_operator(op, rows_out=i)
        return threading.get_native_id()

    with telemetry.recording(qm):
        parent = qm.start_operator("Parent")
        with ThreadPoolExecutor(2) as pool:
            tids = list(pool.map(telemetry.propagating(work), range(4)))
        qm.finish_operator(parent)
    qm.finish()
    assert {sp.query_id for sp in qm.spans} == {"q-pool"}
    assert len(qm.spans) == 1 + 1 + 4 + 4
    children = [sp for sp in qm.spans if sp.name.startswith("Child")]
    assert {sp.parent_id for sp in children} == {parent.span_id}
    assert {sp.tid for sp in children} == set(tids) != {main_tid}
    for sync in (sp for sp in qm.spans if sp.name == "sync:child"):
        owner = next(c for c in children if c.span_id == sync.parent_id)
        assert owner.tid == sync.tid
    assert parent.parent_id == qm.root.span_id
    assert qm.root.parent_id is None
    assert len({sp.span_id for sp in qm.spans}) == len(qm.spans)
    # Children of another thread's span overlap: the fold takes their
    # union, so no self wall goes below 0.
    assert all(wall >= 0 for wall, _cpu in trace.self_times(qm.spans)
               .values())


def test_parent_links_self_wall_and_self_cpu_on_a_hand_built_tree():
    """root [0, 100] on tid 1 with CPU 90; a [10, 40] (tid 1, CPU 25)
    with child a1 [20, 30] (tid 1, CPU 8); b [35, 70] on tid 2 (CPU 30),
    overlapping a; c [60, 120] (tid 1, CPU 5) sticking out of the root."""
    root = _span("query", "serving", None, 0, 100, cpu=90)
    a = _span("a", "operators", root.span_id, 10, 40, cpu=25)
    a1 = _span("a1", "device_wait", a.span_id, 20, 30, cpu=8)
    b = _span("b", "operators", root.span_id, 35, 70, tid=2, cpu=30)
    c = _span("c", "link", root.span_id, 60, 120, cpu=5)
    st = trace.self_times([root, a, a1, b, c])
    # The root's children cover [10, 100] (c clipped at the root's end).
    assert st[root.span_id] == (10, 90 - 25 - 5)
    assert st[a.span_id] == (20, 25 - 8)
    assert st[a1.span_id] == (10, 8)
    assert st[b.span_id] == (35, 30)
    assert st[c.span_id] == (60, 5)
    totals = trace.layer_totals([root, a, a1, b, c])
    assert totals["operators"] == [pytest.approx(55e-9),
                                   pytest.approx(47e-9), 2]
    assert totals["serving"][2] == 1 and totals["link"][2] == 1


def test_fold_identity_on_a_one_thread_query(tmp_path, source, monkeypatch):
    monkeypatch.setattr(trace, "CPU_SAMPLE_EVERY", 1)
    sess = _session(tmp_path)
    df = _query(sess, source)
    df.collect()
    before = _counters()
    _table, qm = df.collect(with_metrics=True)
    after = _counters()
    assert {sp.tid for sp in qm.spans} == {qm.root.tid}
    assert {sp.query_id for sp in qm.spans} == {qm.query_id}
    assert qm.query_id.startswith("q-")
    layers = {sp.layer for sp in qm.spans}
    assert {"serving", "rules", "plan", "operators", "link",
            "device_wait"} <= layers
    names = {sp.name for sp in qm.spans}
    assert {"query", "serve:admit", "optimize", "plan:physical",
            "fusion:prepare", "fusion:dispatch", "fusion:sync",
            "fusion:finalize", "result:to_arrow", "Aggregate"} <= names
    totals = trace.layer_totals(qm.spans)
    assert set(totals) <= set(trace.LAYERS)
    assert sum(t[2] for t in totals.values()) == len(qm.spans)
    root_ns = qm.root.end_ns - qm.root.start_ns
    self_ns = sum(round(t[0] * 1e9) for t in totals.values())
    assert abs(self_ns - root_ns) <= 1000 * len(qm.spans)
    # The query's wall (monotonic clock) and the root span's (the
    # timeline's clock) time the same stretch.
    assert abs(qm.wall_s - qm.root.wall_s) < 1e-3

    def delta(name):
        return after.get(name, 0.0) - before.get(name, 0.0)

    assert delta("trace.queries") == 1
    assert delta("trace.query.wall_s") == pytest.approx(qm.wall_s)
    assert qm.cpu_sampled and delta("trace.query.cpu_sampled") == 1
    assert delta("trace.query.cpu_sampled_wall_s") == pytest.approx(
        qm.wall_s)
    # The root thread's CPU (a host's thread clock may step coarsely).
    assert qm.root.cpu_ns >= 0
    assert delta("trace.query.thread_cpu_s") == pytest.approx(qm.root.cpu_s)
    for layer, (wall, cpu, n) in totals.items():
        assert delta(f"trace.{layer}.wall_s") == pytest.approx(wall)
        assert delta(f"trace.{layer}.cpu_s") == pytest.approx(cpu)
        assert delta(f"trace.{layer}.spans") == n
    assert sum(delta(f"trace.{layer}.wall_s") for layer in totals) == \
        pytest.approx(qm.root.wall_s, abs=1e-6 * len(qm.spans))
    # The bookkeeping after the recorder finished: one span's worth.
    assert delta("trace.telemetry.spans") == 1
    assert delta("trace.telemetry.wall_s") > 0
    # The named per-query counters read the spans.
    by_name = {sp.name: sp for sp in qm.spans}
    assert qm.counters["plan_s"] == by_name["plan:physical"].wall_s
    assert qm.counters["fusion.dispatch_s"] == \
        by_name["fusion:dispatch"].wall_s
    assert qm.counters["fusion.sync_s"] == by_name["fusion:sync"].wall_s
    # Admission and its queue wait are timed on the monotonic clock
    # around the `serve:admit` span.
    admit_s = qm.counters["serve.admission_s"] + \
        qm.counters["serve.queue_wait_s"]
    assert qm.counters["serve.admission_s"] >= 0
    assert by_name["serve:admit"].wall_s - 1e-6 <= admit_s < qm.wall_s


def test_operator_reports_keep_the_operator_tree(tmp_path, source):
    """Spans between operators (a stage's dispatch, a device wait) do not
    change the operator tree that reports render."""
    sess = _session(tmp_path)
    _table, qm = _query(sess, source).collect(with_metrics=True)
    ops = qm.to_dict()["operators"]
    ids = {o["op_id"] for o in ops}
    roots = [o for o in ops if o["parent_id"] is None]
    assert [o["name"] for o in roots] == ["Aggregate"]
    assert all(o["parent_id"] in ids for o in ops if o not in roots)
    assert "Aggregate" in qm.format_tree()
    stage = next(o for o in qm.operators if o.name == "FusedStage")
    assert qm.rows_in(stage) == next(
        o.rows_out for o in qm.operators if o.name == "Scan")


def test_export_trace_on_time_ns_microseconds(tmp_path, source):
    sess = _session(tmp_path)
    df = _query(sess, source)
    df.collect()
    telemetry.enable_tracing()
    t0 = time.time_ns()
    _table, qm = df.collect(with_metrics=True)
    with telemetry.span("outside", "action") as outside:
        pass
    t1 = time.time_ns()
    out = telemetry.export_trace(str(tmp_path / "trace.json"))
    with open(out["path"]) as f:
        doc = json.load(f)
    xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert len(xs) == len(qm.spans) + 1
    for e in xs:
        assert t0 / 1e3 <= e["ts"] <= e["ts"] + e["dur"] <= t1 / 1e3
        assert {"span_id", "parent_id", "query_id"} <= set(e["args"])
        assert e["tid"] == threading.get_native_id()
    mine = {e["args"]["span_id"]: e for e in xs
            if e["args"]["query_id"] == qm.query_id}
    assert set(mine) == {sp.span_id for sp in qm.spans}
    root = mine[qm.root.span_id]
    assert root["ts"] == qm.root.start_ns / 1e3
    assert root["dur"] == pytest.approx(qm.root.wall_s * 1e6)
    (lone,) = [e for e in xs if e["args"]["query_id"] is None]
    assert lone["name"] == "outside"
    assert lone["args"]["span_id"] == outside.span_id
    assert doc["otherData"]["clock"] == "time.time_ns"


def test_device_trace_merges_the_spans_onto_the_profilers_clock(tmp_path):
    """A torch op run inside an operator span on the capturing thread
    falls inside that span in the merged trace."""
    qm = telemetry.QueryMetrics("capture", query_id="q-capture")
    target = tmp_path / "capture"
    with telemetry.recording(qm):
        with profiler.device_trace(str(target)):
            op = qm.start_operator("Scan")
            time.sleep(0.002)
            torch.ones(4096).cumsum(0)
            time.sleep(0.002)
            qm.finish_operator(op)
    qm.finish()
    assert not telemetry.tracing_enabled()  # left as it was
    with open(target / profiler.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    (scan,) = [e for e in events if e.get("name") == "Scan"]
    (cumsum,) = [e for e in events if e.get("name") == "aten::cumsum"]
    assert scan["args"]["query_id"] == "q-capture"
    assert scan["args"]["span_id"] == op.span_id
    assert scan["tid"] == cumsum["tid"] == threading.get_native_id()
    assert scan["pid"] == os.getpid()
    assert scan["ts"] <= cumsum["ts"]
    assert cumsum["ts"] + cumsum["dur"] <= scan["ts"] + scan["dur"]
    # The capturing query's root, still open at the capture's end.
    (root,) = [e for e in events if e.get("name") == "query"]
    assert root["ts"] <= scan["ts"]


def test_slow_query_slice_holds_only_its_own_spans(tmp_path, source):
    slow = str(tmp_path / "slow")
    sess = _session(tmp_path)
    df = _query(sess, source)
    df.collect()
    telemetry.enable_tracing()
    _t, other = df.collect(with_metrics=True)
    sess.conf.set("spark.hyperspace.telemetry.slowlog.seconds", "0.000001")
    sess.conf.set("spark.hyperspace.telemetry.slowlog.dir", slow)
    try:
        _t, qm = df.collect(with_metrics=True)
    finally:
        sess.conf.unset("spark.hyperspace.telemetry.slowlog.seconds")
        sess.conf.unset("spark.hyperspace.telemetry.slowlog.dir")
    flight.get_recorder().drain()
    (name,) = [f for f in os.listdir(slow) if f.startswith("slow-")]
    events = flight.load_dump(os.path.join(slow, name))["trace"][
        "traceEvents"]
    assert other.query_id != qm.query_id
    assert {e["args"]["query_id"] for e in events} == {qm.query_id}
    assert sorted(e["args"]["span_id"] for e in events) == \
        sorted(sp.span_id for sp in qm.spans)


def test_query_wall_stays_monotonic_when_the_wall_clock_steps(monkeypatch):
    """The spans' clock (`time.time_ns()`) places them on the timeline
    and may step; the query's wall, which the scheduler's latency
    counters read, is timed on the monotonic clock."""
    qm = telemetry.QueryMetrics(description="step")
    real = trace._time_ns
    monkeypatch.setattr(trace, "_time_ns", lambda: real() - 10 ** 9)
    qm.finish()
    assert qm.root.end_ns < qm.root.start_ns  # stepped back 1 s
    assert 0 <= qm.wall_s < 1.0
    reg = telemetry.MetricsRegistry()
    trace.fold(qm, reg)
    assert reg.counters_dict()["trace.query.wall_s"] == pytest.approx(
        qm.wall_s, abs=1e-6)


def test_one_query_in_cpu_sample_every_reads_the_cpu_clock(monkeypatch):
    """The thread-CPU clock is read on one query in `CPU_SAMPLE_EVERY`,
    at its spans' layer changes; the other queries never read it."""
    reads = []

    def clock():
        reads.append(1)
        return len(reads)

    monkeypatch.setattr(trace, "_thread_time_ns", clock)
    monkeypatch.setattr(telemetry, "_thread_time_ns", clock)
    sampled = []
    for _ in range(2 * trace.CPU_SAMPLE_EVERY):
        n0 = len(reads)
        qm = telemetry.QueryMetrics(description="sample")
        with telemetry.recording(qm):
            with telemetry.span("Scan", "operators"):
                with telemetry.span("sync:scan", "device_wait"):
                    pass
                with telemetry.span("Inner", "operators"):
                    pass
        qm.finish()
        sampled.append(qm.cpu_sampled)
        if qm.cpu_sampled:
            # The root, `Scan` and `sync:scan`; `Inner` shares its
            # parent's layer.
            assert len(reads) - n0 == 6
            assert qm.root.cpu_ns > 0
        else:
            assert len(reads) == n0
            assert all(sp.cpu_start_ns is None for sp in qm.spans)
    assert sum(sampled) == 2
