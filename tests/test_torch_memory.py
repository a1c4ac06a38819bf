"""The port's device-memory accountant and cache series
(`hyperspace_tpu_torch/telemetry/memory.py`), on the CPU.

Replays the cache-counter parts of `tests/test_telemetry_memory.py`: the
segment cache's `cache.segments.*` series under repeat device scans, the
index metadata cache's series on the monotonic clock, the artifact
section's per-cache shape, the accountant's per-device attribution (on
the CPU, the live-tensor fallback; `torch.cuda.memory_stats` on a card)
and the no-consumer no-op, and a repeat-query leak sentinel. The same
queries run through the JAX package, whose series move the same way.
"""

import gc
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401
import torch

import hyperspace_tpu as jhs
from hyperspace_tpu import telemetry as jtelemetry
from hyperspace_tpu.engine.session import HyperspaceSession as JSession
from hyperspace_tpu_torch import HyperspaceConf, HyperspaceSession, telemetry
from hyperspace_tpu_torch.io import parquet, segcache
from hyperspace_tpu_torch.io.segcache import SegmentCache
from hyperspace_tpu_torch.plan.expr import col, lit


@pytest.fixture(autouse=True)
def fresh_cache():
    segcache.set_cache(SegmentCache())
    parquet.clear_read_cache()
    yield
    segcache.set_cache(SegmentCache())
    parquet.clear_read_cache()


@pytest.fixture
def sales_env(tmp_path):
    """One fact table + session factories for both packages (device lane
    forced)."""
    rng = np.random.default_rng(7)
    n = 4000
    fact_dir = tmp_path / "fact"
    fact_dir.mkdir()
    pq.write_table(pa.table({
        "key": rng.integers(0, 100, n).astype(np.int64),
        "qty": rng.integers(1, 50, n).astype(np.int64),
        "price": rng.random(n) * 100,
    }), str(fact_dir / "part-0.parquet"))
    conf = {"hyperspace.warehouse.dir": str(tmp_path / "wh"),
            "spark.hyperspace.execution.min.device.rows": "0"}

    def session():
        return HyperspaceSession(HyperspaceConf(dict(conf)), device="cpu")

    def jax_session():
        return JSession(jhs.HyperspaceConf(
            {**conf, "spark.hyperspace.distribution.enabled": "false"}))

    return session, jax_session, str(fact_dir)


def _series(registry, name):
    return {s: registry.counter(f"cache.{name}.{s}").value
            for s in ("hits", "misses")}


def test_parquet_device_cache_series(sales_env):
    """The device read lane is the segment cache: repeat device scans hit
    it and report the `cache.segments.*` series — in both packages."""
    session, jax_session, fact_dir = sales_env
    for make, registry in ((session, telemetry.get_registry()),
                           (jax_session, jtelemetry.get_registry())):
        sess = make()
        before = _series(registry, "segments")
        q = lambda: sess.read_parquet(fact_dir).select("key")  # noqa: E731
        first = q().collect()
        again = q().collect()
        after = _series(registry, "segments")
        assert after["misses"] > before["misses"]
        assert after["hits"] > before["hits"]
        assert registry.gauge("cache.segments.bytes_held").value > 0
        assert registry.gauge("cache.segments.entries").value >= 1
        assert again.equals(first)
        if make is session:
            port_rows = first
    assert port_rows.equals(first)


def test_index_metadata_cache_monotonic(monkeypatch):
    from hyperspace_tpu_torch.index import cache as index_cache

    cache = index_cache.CreationTimeBasedCache(HyperspaceConf())  # 300 s
    reg = telemetry.get_registry()
    hits0 = reg.counter("cache.index_metadata.hits").value
    ev0 = reg.counter("cache.index_metadata.evictions").value
    cache.set("entry")
    # A wall-clock jump must NOT expire the entry: expiry is a duration,
    # measured on the monotonic clock.
    real_time = time.time
    monkeypatch.setattr(index_cache.time, "time",
                        lambda: real_time() + 10_000)
    assert cache.get() == "entry"
    assert reg.counter("cache.index_metadata.hits").value == hits0 + 1
    # Monotonic advance past the expiry DOES.
    real_mono = time.monotonic
    monkeypatch.setattr(index_cache.time, "monotonic",
                        lambda: real_mono() + 301)
    assert cache.get() is None
    assert reg.counter("cache.index_metadata.evictions").value == ev0 + 1
    assert reg.gauge("cache.index_metadata.entries").value == 0


def test_artifact_section_shape(sales_env):
    session, jax_session, fact_dir = sales_env
    sess = session()
    sess.read_parquet(fact_dir).filter(
        col("qty") > lit(1)).select("key").collect()
    telemetry.memory.sample()
    section = telemetry.memory.artifact_section()
    assert section["peak_hbm_bytes"] > 0
    assert section["devices"]
    assert "segments" in section["caches"]
    series = section["caches"]["segments"]
    assert {"hits", "misses", "evictions", "bytes_held",
            "entries"} <= set(series)
    # The same cache names and series shape as the JAX package's, over
    # the series the JAX query itself adds or moves: the JAX registry is
    # process-wide, and other suites sharing this process leave series
    # of their own in it (`cache.segments.host.*`, `.shared.*`).
    before = jtelemetry.memory.artifact_section()["caches"].get(
        "segments", {})
    jsess = jax_session()
    jsess.read_parquet(fact_dir).select("key").collect()
    jseries = jtelemetry.memory.artifact_section()["caches"]["segments"]
    touched = {s for s, v in jseries.items()
               if s not in before or before[s] != v}
    assert touched
    assert touched <= set(series) | {
        "coalesced", "fills", "pins", "rekeyed", "shared"}


def test_artifact_section_after_an_index_commit(sales_env):
    """An index commit sweeps the host caches and counts the sweep as
    `cache.invalidations`, a counter of no single cache: the artifact
    section still lists every cache by name, and no cache named after
    that counter."""
    from hyperspace_tpu_torch import Hyperspace, IndexConfig

    session, _jax_session, fact_dir = sales_env
    sess = session()
    Hyperspace(sess).create_index(sess.read_parquet(fact_dir),
                                  IndexConfig("mem", ["key"], ["qty"]))
    assert telemetry.get_registry().counter("cache.invalidations").value > 0
    section = telemetry.memory.artifact_section()
    assert "invalidations" not in section["caches"]
    assert "segments" in section["caches"]


def test_accountant_per_device_attribution():
    """The live-tensor fallback on the CPU: bytes placed on a device show
    up on that device's gauge and in the recording query's per-device
    watermark."""
    payload = torch.ones(1 << 16, dtype=torch.float64)  # 512 KiB
    label = "cpu"
    rec = telemetry.QueryMetrics("mem attribution")
    with telemetry.recording(rec):
        live = telemetry.memory.sample()
    assert live is not None and live.get(label, 0) >= payload.nbytes
    assert rec.peak_hbm_per_device[label] >= payload.nbytes
    assert rec.peak_hbm_bytes >= payload.nbytes
    reg = telemetry.get_registry()
    assert reg.gauge(f"memory.{label}.bytes_in_use").value \
        >= payload.nbytes
    assert reg.gauge(f"memory.{label}.peak_bytes").value >= payload.nbytes
    snap = telemetry.memory.snapshot()
    assert snap["backend"] == ("memory_stats" if torch.cuda.is_available()
                               else "live_tensors")
    assert snap["devices"][label]["peak_bytes"] >= payload.nbytes
    del payload


def test_maybe_sample_noop_without_consumers():
    acct = telemetry.get_accountant()
    before = acct.samples
    assert telemetry.current() is None and telemetry.tracer() is None
    telemetry.memory.maybe_sample()
    assert acct.samples == before


def test_no_tensor_leak_across_repeat_queries(sales_env):
    session, _jax_session, fact_dir = sales_env
    sess = session()
    q = lambda: sess.read_parquet(fact_dir).filter(  # noqa: E731
        col("qty") > lit(10)).select("key", "price")
    for _ in range(2):
        q().collect()  # warm: the segment cache fills

    def live():
        gc.collect()
        return sum(1 for o in gc.get_objects()
                   if issubclass(type(o), torch.Tensor))

    before = live()
    for _ in range(3):
        q().collect()
    assert live() - before <= 0


def test_live_tensor_walk_never_breaks_a_concurrent_tuple_build():
    """The CPU walk holds no list of every object past the C call that
    made it: threads building tuples from generators (which CPython
    resizes in place, refusing when another reference exists) never
    fail while two other threads sample, and the walk finds exactly the
    live tensors a plain collector scan finds."""
    import sys
    import threading

    from hyperspace_tpu_torch.telemetry import memory

    keep = [torch.zeros(16) for _ in range(8)]
    view = keep[0][:4]
    want = {id(o) for o in gc.get_objects()
            if issubclass(type(o), torch.Tensor)}
    assert {id(t) for t in memory._live_tensors()} == want
    assert id(view) in want

    stop = threading.Event()
    errors = []

    def build():
        while not stop.is_set():
            try:
                tuple(x for x in range(200))
            except SystemError as exc:  # pragma: no cover - the fault
                errors.append(exc)

    def walk():
        while not stop.is_set():
            memory._live_tensors_sample()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = ([threading.Thread(target=build) for _ in range(3)]
               + [threading.Thread(target=walk) for _ in range(2)])
    try:
        for t in threads:
            t.start()
        time.sleep(2.0)
    finally:
        stop.set()
        for t in threads:
            t.join(30)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:1]
    assert gc.isenabled()
