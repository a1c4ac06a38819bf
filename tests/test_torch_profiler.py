"""Profiler of `hyperspace_tpu_torch` (`telemetry/profiler.py`): the host
sampling profiler's aggregation against the JAX package's on the same
stacks (exact), its lifecycle, the `torch.profiler` device capture
(CPU activity here; `tests/test_torch_cuda.py` captures a kernel on the
card), the executor's per-query `spark.hyperspace.trace.dir` capture,
and triggered captures: disarmed by default, rate-limited, renamed
atomically and pruned to `capture.keep`.

Process state: each test starts and ends with no port sampling profiler
(`profiler.stop_profiler`, the singleton reset through `monkeypatch`),
the triggered-capture rate limit and history cleared, and the capture
lane shut down (`profiler._atexit_stop`), so no thread outlives a test.
"""

import json
import os
import threading
import time
from contextlib import contextmanager

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401
import torch

from hyperspace_tpu.telemetry import profiler as jprofiler
import hyperspace_tpu_torch as ths
from hyperspace_tpu_torch import telemetry
from hyperspace_tpu_torch.telemetry import flight, profiler


def _reset():
    profiler._atexit_stop()
    with profiler._capture_lock:
        profiler._last_capture_t = None
        profiler._recent_captures.clear()


@pytest.fixture(autouse=True)
def stopped_profiler(monkeypatch):
    _reset()
    monkeypatch.setattr(profiler, "_profiler", None)
    yield
    _reset()


def _counter(name):
    return telemetry.get_registry().counters_dict().get(name, 0)


STACKS = {
    ("a:main", "b:run", "c:leaf"): 5,
    ("a:main", "b:run", "d:other"): 3,
    ("a:main", "e:idle"): 2,
    ("x:thread", "c:leaf"): 1,
}


def test_aggregation_equals_jax_on_the_same_stacks():
    ours, theirs = profiler.SamplingProfiler(), jprofiler.SamplingProfiler()
    for p in (ours, theirs):
        p._stacks.update(STACKS)
        p.samples = sum(STACKS.values())
    assert ours.by_module() == theirs.by_module()
    assert ours.by_function() == theirs.by_function()
    assert ours.collapsed() == theirs.collapsed()
    assert ours.flamegraph() == theirs.flamegraph()
    assert ours.flamegraph()["value"] == 11
    assert ours.by_module()[0] == {"module": "c", "samples": 6,
                                   "share": round(6 / 11, 4)}


def test_frame_key_is_root_first_and_skips_the_profiler():
    import sys

    key = profiler._frame_key(sys._getframe())
    assert key[-1].endswith(
        "test_frame_key_is_root_first_and_skips_the_profiler")
    assert len(key) <= profiler.MAX_STACK_DEPTH
    assert profiler._frame_key(_profiler_frame()) is None


def _profiler_frame():
    """A frame whose globals are the profiler module's."""
    captured = {}
    exec("import sys\ncaptured['f'] = sys._getframe()",
         {"__name__": profiler.__name__, "captured": captured})
    return captured["f"]


def test_lifecycle_and_process_singleton():
    p = profiler.start_profiler(hz=50.0)
    try:
        assert p.running and profiler.get_profiler() is p
        assert profiler.start_profiler(hz=5.0) is p and p.hz == 50.0
    finally:
        profiler.stop_profiler()
    assert not p.running
    p2 = profiler.start_profiler(hz=7.0)
    assert p2 is p and p.hz == 7.0
    profiler.stop_profiler()
    doc = profiler.profile_doc()
    assert doc["enabled"] is False and "flamegraph" in doc


def test_configure_respects_the_enabled_knob():
    assert profiler.configure(ths.HyperspaceConf()) is None
    p = profiler.configure(ths.HyperspaceConf({
        "spark.hyperspace.telemetry.profiler.enabled": "true",
        "spark.hyperspace.telemetry.profiler.hz": "40"}))
    try:
        assert p.running and p.hz == 40.0
    finally:
        profiler.stop_profiler()


def test_device_trace_writes_a_chrome_trace(tmp_path):
    target = tmp_path / "capture"
    with profiler.device_trace(str(target)):
        torch.ones(64).cumsum(0)
    with open(target / profiler.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)


def test_device_trace_raises_through(tmp_path):
    with pytest.raises(ValueError):
        with profiler.device_trace(str(tmp_path / "c")):
            raise ValueError("inside the capture")
    assert not profiler._trace_lock.locked()


@pytest.fixture
def source(tmp_path):
    rng = np.random.default_rng(5)
    data = tmp_path / "data"
    data.mkdir()
    pq.write_table(pa.table({"a": rng.integers(0, 100, 3000),
                             "v": rng.random(3000)}),
                   str(data / "part-0.parquet"))
    return str(data)


def _conf(tmp_path, **extra):
    conf = {"spark.hyperspace.warehouse.dir": str(tmp_path / "wh"),
            "spark.hyperspace.execution.min.device.rows": "0",
            "spark.hyperspace.telemetry.slowlog.dir": str(tmp_path / "sl"),
            "spark.hyperspace.telemetry.profiler.capture.min.interval."
            "seconds": "0"}
    conf.update({k: str(v) for k, v in extra.items()})
    return ths.HyperspaceConf(conf)


def test_trace_dir_captures_each_query(tmp_path, source):
    traces = tmp_path / "traces"
    sess = ths.HyperspaceSession(_conf(
        tmp_path, **{"spark.hyperspace.trace.dir": str(traces)}),
        device="cpu")
    df = sess.read_parquet(source).filter(ths.col("a") > 50)
    _table, qm = df.collect(with_metrics=True)
    (event,) = qm.events_of("profiler", "capture")
    assert os.path.dirname(event["path"]) == str(traces)
    assert os.path.basename(event["path"]).startswith("query-")
    with open(os.path.join(event["path"], profiler.TRACE_FILE)) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)
    flight.get_recorder().clear()


@pytest.fixture
def stub_trace(monkeypatch):
    """The capture plumbing without torch.profiler: a marker file."""
    traced = []

    @contextmanager
    def fake_trace(path):
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "trace.marker"), "w") as f:
            f.write("x")
        traced.append(path)
        yield

    monkeypatch.setattr(profiler, "device_trace", fake_trace)
    return traced


def _settle(paths, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        states = {c["path"]: c["state"]
                  for c in profiler.recent_captures(32)}
        if all(states.get(p) in ("done", "error") for p in paths):
            return states
        time.sleep(0.01)
    raise AssertionError(f"captures never settled: {states}")


def test_capture_disarmed_by_default(tmp_path):
    conf = _conf(tmp_path)
    assert profiler.request_capture(conf) is None
    assert profiler.maybe_capture_on_burn(conf, 5.0) is None


def test_triggered_capture_atomic_and_pruned(tmp_path, stub_trace):
    conf = _conf(tmp_path, **{
        "spark.hyperspace.telemetry.profiler.capture.seconds": "0.001",
        "spark.hyperspace.telemetry.profiler.capture.keep": "2"})
    before = _counter("profiler.captures")
    paths = []
    for i in range(4):
        paths.append(profiler.request_capture(conf, reason=f"m{i}"))
        _settle(paths[-1:])
    assert all(s == "done" for s in _settle(paths).values())
    assert _counter("profiler.captures") == before + 4
    kept = sorted(os.path.join(conf.slowlog_dir, e)
                  for e in os.listdir(conf.slowlog_dir))
    assert kept == sorted(paths[-2:])
    assert profiler.maybe_capture_on_burn(conf, 0.5) is None
    assert profiler.maybe_capture_on_burn(conf, 2.0) is not None


def test_capture_rate_limited(tmp_path, stub_trace):
    conf = _conf(tmp_path, **{
        "spark.hyperspace.telemetry.profiler.capture.seconds": "0.001",
        "spark.hyperspace.telemetry.profiler.capture.min.interval."
        "seconds": "3600"})
    first = profiler.request_capture(conf)
    assert first is not None
    assert profiler.request_capture(conf) is None
    _settle([first])


def test_capture_error_counted_and_tmp_cleaned(tmp_path, monkeypatch):
    @contextmanager
    def broken(path):
        os.makedirs(path, exist_ok=True)
        raise RuntimeError("no profiler")
        yield

    monkeypatch.setattr(profiler, "device_trace", broken)
    conf = _conf(tmp_path, **{
        "spark.hyperspace.telemetry.profiler.capture.seconds": "0.001"})
    before = _counter("profiler.capture_errors")
    target = profiler.request_capture(conf)
    assert _settle([target])[target] == "error"
    profiler._atexit_stop()  # the lane's job removes its .tmp after
    assert _counter("profiler.capture_errors") == before + 1
    assert not os.path.exists(target + ".tmp")


def test_real_capture_and_the_slowlog_link(tmp_path, source):
    conf = _conf(tmp_path, **{
        "spark.hyperspace.telemetry.profiler.capture.seconds": "0.01",
        "spark.hyperspace.telemetry.slowlog.seconds": "0.000001"})
    sess = ths.HyperspaceSession(conf, device="cpu")
    sess.read_parquet(source).collect()
    sess.close()
    (dump,) = [f for f in os.listdir(conf.slowlog_dir)
               if f.startswith("slow-")]
    doc = flight.load_dump(os.path.join(conf.slowlog_dir, dump))
    capture = doc["device_profile"]
    assert _settle([capture])[capture] == "done"
    assert os.path.exists(os.path.join(capture, profiler.TRACE_FILE))
    flight.get_recorder().clear()


def test_no_thread_outlives_the_capture_lane(tmp_path, stub_trace):
    # The JAX package names its capture threads the same way, and its own
    # suite may leave one running in this worker: only threads started
    # here count.
    before = set(threading.enumerate())
    conf = _conf(tmp_path, **{
        "spark.hyperspace.telemetry.profiler.capture.seconds": "0.001"})
    _settle([profiler.request_capture(conf)])
    profiler._atexit_stop()
    assert not [t for t in threading.enumerate()
                if t.name.startswith("hs-profiler") and t.is_alive()
                and t not in before]
