"""The compile and launch seam of `hyperspace_tpu_torch`
(`telemetry/compilation.py`) and the recorder surface it feeds.

On the CPU the seam times each instrumented call with `perf_counter`;
the CUDA-event half runs in `tests/test_torch_cuda.py`. Checked here:
the modeled bytes of both kernels against the formulas of their bound
(exact), the per-query / process / tenant charges and their exactness,
the entry points' names (the JAX package's), the build counts and their
causes, a failing g++ build raising, and one query through both
packages giving the same `rules.served.*` counters, the same
`index_usage_report` rows and the same `compile` / `roofline` /
`critical_path` keys.

Process state: the tests that configure the build directory restore
`compilation`'s, `ops.cuda.build`'s and `native`'s module state through
`monkeypatch`; the query test empties both packages' flight rings
before and after (`get_recorder().clear()`).
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401
import torch

import hyperspace_tpu as jhs
from hyperspace_tpu import telemetry as jtelemetry
from hyperspace_tpu.telemetry import critical_path as jcp
import hyperspace_tpu_torch as ths
from hyperspace_tpu_torch import native, telemetry
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.io import columnar
from hyperspace_tpu_torch.ops import sketch, sort
from hyperspace_tpu_torch.ops.cuda import (build, hash_kernel,
                                           partition_kernel,
                                           run_bounds_kernel)
from hyperspace_tpu_torch.telemetry import compilation


def _counters():
    return telemetry.get_registry().counters_dict()


def _lanes(n_lanes, n, seed=0):
    rng = np.random.default_rng([seed, n_lanes, n])
    return torch.from_numpy(
        rng.integers(-2**31, 2**31, (n_lanes, n)).astype(np.int32))


@pytest.mark.parametrize("n", [1, 129, 4096])
@pytest.mark.parametrize("n_lanes", [1, 2, 3])
def test_hash_modeled_bytes_are_the_bound_formula(n, n_lanes):
    lanes = _lanes(n_lanes, n)
    qm = telemetry.QueryMetrics("hash")
    before = _counters().get("device.bytes_accessed", 0)
    with telemetry.recording(qm):
        hash_kernel.hash_lanes_to_buckets(lanes, 200)
    want = n * (4 * n_lanes + 4)
    assert qm.counters["device.bytes_accessed"] == want
    assert qm.counters[
        "device.cuda.hash_lanes_to_buckets.bytes_accessed"] == want
    assert _counters()["device.bytes_accessed"] - before == want
    assert compilation.entry_point_costs()[
        "cuda.hash_lanes_to_buckets"] == (20 * n_lanes * n, want)


@pytest.mark.parametrize("n", [1, 129, 4096])
@pytest.mark.parametrize("n_lanes,buckets", [(1, 8), (2, 200), (3, 1024)])
def test_partition_modeled_bytes_are_the_bound_formula(n, n_lanes, buckets):
    lanes = _lanes(n_lanes, n, seed=1)
    qm = telemetry.QueryMetrics("partition")
    with telemetry.recording(qm):
        partition_kernel.partition_ids_and_histogram(lanes, buckets)
    assert qm.counters["device.bytes_accessed"] == \
        n * (4 * n_lanes + 4) + 8 * buckets
    assert qm.counters[
        "device.cuda.partition_ids_and_histogram.dispatches"] == 1


def test_kernel_costs_at_the_main_paths_shapes():
    """The figures `PERF.md`'s bound column is computed from."""
    meta = torch.empty((2, 16_777_216), dtype=torch.int32, device="meta")
    assert hash_kernel.hash_cost(meta, 200)[1] == 201_326_592
    meta = torch.empty((2, 8_388_608), dtype=torch.int32, device="meta")
    assert partition_kernel.partition_cost(meta, 200)[1] == 100_664_896


def test_entry_points_carry_the_jax_packages_names():
    assert {"columnar.fused_take", "sort.topk_threshold", "sketch.zones",
            "sketch.bloom", "cuda.hash_lanes_to_buckets",
            "cuda.partition_ids_and_histogram"} <= set(compilation.REGISTRY)
    for fn in (hash_kernel.hash_lanes_to_buckets,
               partition_kernel.partition_ids_and_histogram,
               columnar.fused_take, sort._topk_threshold,
               sketch._device_zones, sketch._device_bloom_words):
        assert fn.__device_instrumented__


def test_each_entry_point_charges_device_seconds_and_bytes():
    x = torch.arange(1000, dtype=torch.int64)
    calls = {
        "columnar.fused_take": lambda: columnar.fused_take(
            [x, x.double()], torch.arange(0, 1000, 3)),
        "sort.topk_threshold": lambda: sort._topk_threshold(x, 10),
        "sketch.zones": lambda: sketch._device_zones(
            x, torch.ones(1000, dtype=torch.bool),
            torch.zeros(1000, dtype=torch.bool)),
        "sketch.bloom": lambda: sketch._device_bloom_words(
            x & 0xFFFF, x * 7 & 0xFFFF, 4096),
    }
    for name, call in calls.items():
        qm = telemetry.QueryMetrics(name)
        with telemetry.recording(qm):
            call()
        assert qm.counters[f"device.{name}.dispatches"] == 1, name
        assert qm.counters["device.dispatch_s"] > 0, name
        assert qm.counters["device.bytes_accessed"] == \
            compilation.entry_point_costs()[name][1] > 0, name
    qm = telemetry.QueryMetrics("take")
    with telemetry.recording(qm):
        columnar.fused_take([x, x.double()], torch.arange(0, 1000, 3))
    # 334 rows: the int64 index read, each row of both arrays read and
    # written.
    assert qm.counters["device.bytes_accessed"] == 334 * 8 + 2 * 334 * 16


def test_tenant_charges_equal_the_global_counters():
    # Unrounded values: `counters_dict()` rounds to 6 decimals, so two
    # equal deltas of seconds could read 1e-6 apart.
    lanes = _lanes(2, 512)
    reg = telemetry.get_registry()
    before = reg.series_snapshot()["counters"]
    with telemetry.tenant_scope("acme"):
        hash_kernel.hash_lanes_to_buckets(lanes, 64)
    after = reg.series_snapshot()["counters"]
    for name in ("device.dispatch.seconds", "device.bytes_accessed",
                 "device.flops"):
        assert after[f"tenant.acme.{name}"] - before.get(
            f"tenant.acme.{name}", 0) == pytest.approx(
            after[name] - before.get(name, 0), rel=1e-12)
    assert "acme" in telemetry.known_tenants()
    digest = telemetry.tenant_digest()
    assert set(digest["acme"]) == set(telemetry.TENANT_CHARGE_COUNTERS)
    assert telemetry.TENANT_CHARGE_COUNTERS == \
        jtelemetry.TENANT_CHARGE_COUNTERS


def test_nested_entry_points_are_charged_once():
    inner = compilation.instrumented_device(
        "test.inner", lambda t: t + 1, cost=lambda t: (1, 10))
    outer = compilation.instrumented_device(
        "test.outer", lambda t: inner(t) * 2, cost=lambda t: (2, 20))
    qm = telemetry.QueryMetrics("nested")
    with telemetry.recording(qm):
        assert outer(torch.ones(3)).tolist() == [4.0, 4.0, 4.0]
    assert qm.counters["device.dispatches"] == 1
    assert qm.counters["device.bytes_accessed"] == 20
    assert "device.test.inner.dispatches" not in qm.counters


def test_the_seam_catches_nothing():
    before = _counters().get("device.dispatches", 0)
    lanes = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(HyperspaceException):
        hash_kernel.hash_lanes_to_buckets(lanes, 8)

    def broken(t):
        raise RuntimeError("kernel fault")

    wrapped = compilation.instrumented_device("test.broken", broken)
    with pytest.raises(RuntimeError, match="kernel fault"):
        wrapped(torch.ones(2))
    assert _counters().get("device.dispatches", 0) == before
    # The guard against nesting is released after a raise.
    qm = telemetry.QueryMetrics("after")
    with telemetry.recording(qm):
        hash_kernel.hash_lanes_to_buckets(_lanes(1, 8), 8)
    assert qm.counters["device.dispatches"] == 1


def test_launch_counts_stay_on_the_wrappers():
    """`chip_smoke.py` zeroes and reads `.launches` on the public
    wrappers; on the CPU no kernel launches."""
    hash_kernel.hash_lanes_to_buckets.launches = 0
    hash_kernel.hash_lanes_to_buckets(_lanes(2, 64), 8)
    partition_kernel.partition_ids_and_histogram(_lanes(2, 64), 8)
    run_bounds_kernel.run_bounds.launches = 0
    run_bounds_kernel.run_bounds(torch.zeros(63, dtype=torch.bool))
    assert hash_kernel.hash_lanes_to_buckets.launches == 0
    assert partition_kernel.partition_ids_and_histogram.launches == 0
    assert run_bounds_kernel.run_bounds.launches == 0


def test_record_build_counts_a_trace_and_its_cause():
    before = _counters()
    qm = telemetry.QueryMetrics("build")
    telemetry.enable_tracing()
    try:
        with telemetry.recording(qm):
            compilation.record_build("test_lib", 0.25)
            compilation.record_build(
                "test_lib", 0.5, "source changed: csrc/test_lib.cu")
            compilation.record_cache_hit("test_lib")
        spans = [e for e in telemetry.tracer().events
                 if e.get("cat") == "compile"]
    finally:
        telemetry.disable_tracing()
    after = _counters()
    assert after["compile.traces"] - before.get("compile.traces", 0) == 2
    assert after["compile.test_lib.traces"] - before.get(
        "compile.test_lib.traces", 0) == 2
    assert after["compile.cache_hits"] - before.get(
        "compile.cache_hits", 0) == 1
    assert qm.compile == {"traces": 2, "cache_hits": 1, "seconds": 0.75}
    assert [(e["name"], e["cause"]) for e in qm.events_of("compile")] == [
        ("trace", "first build"),
        ("retrace", "source changed: csrc/test_lib.cu")]
    assert [s["name"] for s in spans] == ["compile test_lib"] * 2
    assert "Compile: 2 traces, 1 cache hits" in qm.format_tree()


def test_build_cause_names_a_changed_source(tmp_path):
    assert compilation.build_cause(
        str(tmp_path), "libhash_buckets-", "csrc/hash_buckets.cu") == \
        "first build"
    (tmp_path / "libhash_buckets-000000000000.so").write_bytes(b"")
    assert compilation.build_cause(
        str(tmp_path), "libhash_buckets-", "csrc/hash_buckets.cu") == \
        "source changed: csrc/hash_buckets.cu"
    assert compilation.build_cause(
        str(tmp_path / "missing"), "libx-", "x.cu") == "first build"


def test_nvcc_build_of_a_built_library_is_a_cache_hit(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    for name in build.SOURCES:
        path = build.library_path(name)
        open(path, "wb").close()
    before = _counters()
    assert build.build_all() == {name: 0.0 for name in build.SOURCES}
    after = _counters()
    for name in build.SOURCES:
        assert after[f"compile.{name}.cache_hits"] - before.get(
            f"compile.{name}.cache_hits", 0) == 1


@pytest.fixture
def fresh_native(tmp_path, monkeypatch):
    """The native loader as if no library was ever loaded, building into
    `tmp_path` (restored after the test)."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_attempted", False)
    return tmp_path


def test_failed_gxx_build_raises_every_time(fresh_native, monkeypatch):
    broken = fresh_native / "broken.cpp"
    broken.write_text("int main( { return 0; }\n")
    monkeypatch.setattr(native, "SOURCE", str(broken))
    for _ in range(2):
        with pytest.raises(HyperspaceException, match="g\\+\\+ failed"):
            native.get_lib()
    assert not [f for f in os.listdir(fresh_native) if f.endswith(".so")]


def test_gxx_build_is_a_counted_trace(fresh_native, monkeypatch):
    small = fresh_native / "small.cpp"
    small.write_text('extern "C" int hs_probe() { return 7; }\n')
    monkeypatch.setattr(native, "SOURCE", str(small))
    monkeypatch.setattr(native, "_declare", lambda lib: None)
    (fresh_native / "libhyperspace_host-000000000000.so").write_bytes(b"")
    before = _counters()
    qm = telemetry.QueryMetrics("native")
    with telemetry.recording(qm):
        lib = native.get_lib()
    assert lib.hs_probe() == 7
    after = _counters()
    assert after["compile.hyperspace_host.traces"] - before.get(
        "compile.hyperspace_host.traces", 0) == 1
    (event,) = qm.events_of("compile")
    assert event["name"] == "retrace"
    assert event["cause"] == "source changed: native/hyperspace_host.cpp"


def test_missing_gxx_takes_the_numpy_lane(fresh_native, monkeypatch):
    import subprocess

    def no_compiler(*args, **kwargs):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(subprocess, "run", no_compiler)
    assert native.get_lib() is None


def test_persistent_cache_dir_moves_both_build_dirs(tmp_path, monkeypatch):
    monkeypatch.setattr(compilation, "_persistent_dir", None)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    conf = ths.HyperspaceConf({
        "spark.hyperspace.compile.cache.dir": str(tmp_path)})
    assert not compilation.configure_persistent_cache(ths.HyperspaceConf())
    assert compilation.configure_persistent_cache(conf)
    assert compilation.persistent_cache_dir() == str(tmp_path)
    assert build.BUILD_DIR == native.BUILD_DIR == str(tmp_path)
    assert os.path.dirname(build.library_path("hash_buckets")) == \
        str(tmp_path)


def test_recorder_surface_keys_equal_the_jax_packages():
    tq = telemetry.QueryMetrics("t").finish()
    jq = jtelemetry.QueryMetrics("t").finish()
    assert set(tq.compile) == set(jq.compile)
    assert set(tq.roofline) == set(jq.roofline)
    assert tq.roofline == jq.roofline
    assert set(tq.to_dict()) == set(jq.to_dict())
    assert set(tq.summary()) == set(jq.summary())
    assert tq.rows_in(tq.start_operator("Scan")) is None


def test_propagating_carries_recorder_tenant_and_parent():
    import threading

    qm = telemetry.QueryMetrics("pool")
    seen = {}

    def work():
        seen["tenant"] = telemetry.current_tenant()
        op = telemetry.current().start_operator("Child")
        telemetry.current().finish_operator(op)

    with telemetry.recording(qm), telemetry.tenant_scope("t1"):
        parent = qm.start_operator("Parent")
        t = threading.Thread(target=telemetry.propagating(work))
        t.start()
        t.join()
        qm.finish_operator(parent)
    child = [o for o in qm.operators if o.name == "Child"][0]
    assert child.parent_id == parent.op_id
    assert seen["tenant"] == "t1"
    assert telemetry.current_tenant() == telemetry.DEFAULT_TENANT


# ---------------------------------------------------------------------------
# One query through both packages
# ---------------------------------------------------------------------------


@pytest.fixture
def lake(tmp_path):
    rng = np.random.default_rng(11)
    src = tmp_path / "src"
    src.mkdir()
    n = 6000
    pq.write_table(pa.table({
        "k": rng.integers(0, 500, n).astype(np.int64),
        "v": rng.random(n),
        "s": pa.array([f"s{i % 37}" for i in range(n)]),
    }), str(src / "part-0.parquet"))
    return tmp_path


def _run(pkg, lake, tag, device=None):
    conf = pkg.HyperspaceConf({
        "spark.hyperspace.warehouse.dir": str(lake / f"wh_{tag}"),
        "spark.hyperspace.execution.min.device.rows": "0",
        "spark.hyperspace.distribution.enabled": "false",
    })
    sess = (pkg.HyperspaceSession(conf, device=device) if device
            else pkg.HyperspaceSession(conf))
    hs = pkg.Hyperspace(sess)
    df = sess.read_parquet(str(lake / "src"))
    hs.create_index(df, pkg.IndexConfig("kIdx", ["k"], ["v"]))
    hs.create_index(df, pkg.IndexConfig("sIdx", ["s"], ["k"]))
    sess.enable_hyperspace()
    reg = pkg.telemetry.get_registry()
    before = reg.counters_dict()
    _t, qm = df.filter(pkg.col("k") < 50).select("k", "v").collect(
        with_metrics=True)
    df.filter(pkg.col("s") == "s3").select("s", "k").collect()
    after = reg.counters_dict()
    served = {k: after[k] - before.get(k, 0) for k in after
              if k.startswith("rules.served.")
              and after[k] != before.get(k, 0)}
    queries = {k: after[k] - before.get(k, 0)
               for k in ("queries.total",)}
    usage = pkg.facade.index_usage_report(hs._manager)
    return qm, served, queries, usage


def test_a_query_through_both_packages(lake):
    jtelemetry.get_recorder().clear()
    telemetry.get_recorder().clear()
    try:
        jq, jserved, jqueries, jusage = _run(jhs, lake, "jax")
        tq, tserved, tqueries, tusage = _run(ths, lake, "torch",
                                             device="cpu")
    finally:
        jtelemetry.get_recorder().clear()
        telemetry.get_recorder().clear()
    assert tserved == jserved == {"rules.served.kIdx": 1,
                                  "rules.served.sIdx": 1}
    assert tqueries == jqueries == {"queries.total": 2}
    assert tusage == jusage
    assert set(tq.compile) == set(jq.compile)
    assert set(tq.roofline) == set(jq.roofline)
    assert set(tq.critical_path) == set(jq.critical_path)
    assert set(tq.critical_path["segments"]) == set(jcp.SEGMENTS)
    assert tq.roofline["device_share"] > 0
    assert [(u["name"], u["rule"]) for u in tq.index_usage()] == \
        [(u["name"], u["rule"]) for u in jq.index_usage()]


class _FakeEvent:
    """A timing event that has finished: `elapsed_time` in ms."""

    def __init__(self):
        self.waited = 0

    def synchronize(self):
        self.waited += 1

    def elapsed_time(self, end):
        return 2.0


def test_a_failed_query_settles_its_queued_calls(lake, monkeypatch):
    """A query that raises after a device call queued its event pair:
    the call is charged to the process counters and its events go back
    to the pool, as `finish()` would have done."""
    sess = ths.HyperspaceSession(ths.HyperspaceConf({
        "spark.hyperspace.warehouse.dir": str(lake / "wh_fail")}),
        device="cpu")
    df = sess.read_parquet(str(lake / "src"))
    pair = (_FakeEvent(), _FakeEvent())

    def failing(plan, conf=None):
        telemetry.current()._device_events.append(
            ("test.failing", pair, telemetry.current_tenant(), (0, 64)))
        raise RuntimeError("boom")

    monkeypatch.setattr("hyperspace_tpu_torch.engine.executor.execute_plan",
                        failing)
    reg = telemetry.get_registry()
    before = reg.series_snapshot()["counters"]
    with pytest.raises(RuntimeError, match="boom"):
        df.select("k").collect()
    after = reg.series_snapshot()["counters"]
    assert pair[1].waited == 1 and pair in compilation._free_events
    compilation._free_events.remove(pair)
    assert after["device.test.failing.dispatches"] - before.get(
        "device.test.failing.dispatches", 0) == 1
    assert after["device.dispatch.seconds"] - before.get(
        "device.dispatch.seconds", 0) == pytest.approx(0.002)
    assert after["device.bytes_accessed"] - before.get(
        "device.bytes_accessed", 0) == 64


def _scan_bytes(pkg, lake, tag, rules, device=None):
    conf = pkg.HyperspaceConf({
        "spark.hyperspace.warehouse.dir": str(lake / f"wh_{tag}"),
        "spark.hyperspace.distribution.enabled": "false",
    })
    sess = (pkg.HyperspaceSession(conf, device=device) if device
            else pkg.HyperspaceSession(conf))
    df = sess.read_parquet(str(lake / "src"))
    pkg.Hyperspace(sess).create_index(
        df, pkg.IndexConfig("bIdx", ["k"], ["v"]))
    if rules:
        sess.enable_hyperspace()
    _t, qm = df.filter(pkg.col("k") < 50).select("k", "v").collect(
        with_metrics=True)
    return sorted((o.detail["files_scanned"], o.detail["bytes_scanned"])
                  for o in qm.operators if o.name == "Scan")


@pytest.mark.parametrize("stamped", [True, False],
                         ids=["stamped", "unstampable"])
@pytest.mark.parametrize("rules", [True, False], ids=["index", "source"])
def test_scan_bytes_scanned_equals_the_jax_packages(lake, monkeypatch,
                                                     rules, stamped):
    """A Scan's `bytes_scanned` is the JAX package's: the files' on-disk
    bytes, and 0 for a file with no (size, mtime) stamp (e.g. an object
    store that reports no modification time)."""
    import hyperspace_tpu.io.parquet as jparquet
    from hyperspace_tpu_torch.io import parquet as tparquet

    if not stamped:
        for mod in (jparquet, tparquet):
            monkeypatch.setattr(mod, "_file_stamp", lambda path: None)
    tag = f"{int(rules)}{int(stamped)}"
    want = _scan_bytes(jhs, lake, f"jax{tag}", rules)
    got = _scan_bytes(ths, lake, f"torch{tag}", rules, device="cpu")
    assert got == want
    assert all((b > 0) == stamped for _f, b in got)
