"""The port's read caches and device segment cache, on the CPU.

Replays the JAX package's cache scenarios on the port's CPU path:
`tests/test_columnar.py::test_read_cache_serves_and_invalidates` and every
test of `tests/test_segcache.py` except the three that need the
scheduler or fault injection (`test_cancellation_mid_fill_releases_
reservation`, `test_footprint_credit_for_resident_segments`,
`test_chaos_with_concurrent_refresh`; `ROADMAP.md`, serving). Queries
served from the caches return what the JAX package returns over the same
seeded lake.

Then the cache-safety test: a cached batch is SHARED by every query that
hits it, and torch tensors can be written in place, so queries of every
operator family run over one cached segment, and the bytes of every
cached array must be unchanged after each, and every result equal to the
result with every cache budget at 0.
"""

import gc
import hashlib
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

import hyperspace_tpu as jhs
from hyperspace_tpu.engine.session import HyperspaceSession as JSession
from hyperspace_tpu.plan import expr as jexpr
from hyperspace_tpu_torch import (Hyperspace, HyperspaceConf,
                                  HyperspaceSession, IndexConfig, telemetry)
from hyperspace_tpu_torch.io import parquet, segcache
from hyperspace_tpu_torch.io.segcache import SegmentCache, SegmentRef
from hyperspace_tpu_torch.plan.expr import col, lit
from hyperspace_tpu_torch.plan.schema import Schema

CPU = torch.device("cpu")


def _counter(name):
    return telemetry.get_registry().counters_dict().get(name, 0)


@pytest.fixture(autouse=True)
def fresh_cache():
    """A fresh process segment cache and empty host caches per test (and
    after)."""
    segcache.set_cache(SegmentCache())
    parquet.clear_read_cache()
    yield
    segcache.set_cache(SegmentCache())
    parquet.clear_read_cache()


@pytest.fixture
def leak_sentinel():
    """Live-tensor leak sentinel: the count of live tensors is unchanged
    across the enclosed block (warm the caches FIRST)."""
    def live():
        gc.collect()
        return sum(1 for o in gc.get_objects()
                   if issubclass(type(o), torch.Tensor))

    @contextmanager
    def sentinel(tolerance: int = 0):
        before = live()
        yield
        after = live()
        assert after - before <= tolerance, (
            f"tensor leak: {after - before} new live tensors "
            f"(tolerance {tolerance}; {before} -> {after})")

    return sentinel


def _source(tmp_path):
    rng = np.random.default_rng(3)
    n = 20_000
    src = tmp_path / "src"
    src.mkdir()
    pq.write_table(pa.table({
        "key": rng.integers(0, 200, n).astype(np.int64),
        "val": rng.random(n).astype(np.float64),
    }), str(src / "part-0.parquet"))
    return str(src)


@pytest.fixture
def indexed_env(tmp_path):
    """A source dir + session/hs over it with an index created, device
    lane forced (the CPU)."""
    src = _source(tmp_path)

    def session(**extra):
        conf = {"hyperspace.warehouse.dir": str(tmp_path / "wh"),
                "spark.hyperspace.execution.min.device.rows": "0"}
        conf.update({k: str(v) for k, v in extra.items()})
        return HyperspaceSession(HyperspaceConf(conf), device="cpu")

    sess = session()
    hs = Hyperspace(sess)
    df = sess.read_parquet(src)
    hs.create_index(df, IndexConfig("seg_idx", ["key"], ["val"]))
    sess.enable_hyperspace()
    return sess, hs, df, src, session


def _jax_rows(tmp_path, src, build):
    """The JAX package's rules-on answer over the same source."""
    jsess = JSession(jhs.HyperspaceConf({
        "hyperspace.warehouse.dir": str(tmp_path / "jwh"),
        "spark.hyperspace.distribution.enabled": "false"}))
    jdf = jsess.read_parquet(src)
    jhs.Hyperspace(jsess).create_index(
        jdf, jhs.IndexConfig("seg_idx", ["key"], ["val"]))
    jsess.enable_hyperspace()
    return _rows(build(jdf, jexpr).collect())


def _rows(table):
    """The table's rows in one canonical order (nulls included)."""
    return sorted(zip(*[table.column(c).to_pylist()
                        for c in table.column_names]), key=repr)


@pytest.fixture
def plain_parquet(tmp_path):
    """One parquet file + its Schema, for direct SegmentCache units."""
    rng = np.random.default_rng(9)
    path = tmp_path / "plain.parquet"
    table = pa.table({
        "a": rng.integers(0, 1000, 5000).astype(np.int64),
        "b": rng.random(5000).astype(np.float64),
    })
    pq.write_table(table, str(path))
    return str(path), Schema.from_arrow(table.schema), table


def _ref(version=0, bucket="all", name="u", root="/idx/u"):
    return SegmentRef(index_name=name, index_root=root, version=version,
                      bucket=bucket)


# ---------------------------------------------------------------------------
# The host read cache (tests/test_columnar.py)
# ---------------------------------------------------------------------------


def test_read_cache_serves_and_invalidates(tmp_path):
    """The decoded-read cache serves unchanged files and MISSES when a
    file is rewritten in place (stamp mismatch)."""
    f = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"x": np.arange(5, dtype=np.int64)}), f)
    parquet.clear_read_cache()
    t1 = parquet.read_table([f])
    t2 = parquet.read_table([f])
    assert t2 is t1  # a hit returns the same decoded table
    time.sleep(0.01)
    pq.write_table(pa.table({"x": np.arange(9, dtype=np.int64)}), f)
    t3 = parquet.read_table([f])
    assert t3 is not t1 and t3.num_rows == 9  # stamp changed -> fresh
    # Column projection is part of the key.
    t4 = parquet.read_table([f], columns=["x"])
    assert t4.num_rows == 9
    assert t4.equals(jhs_read([f], ["x"]))
    parquet.clear_read_cache()


def jhs_read(paths, columns):
    from hyperspace_tpu.io import parquet as jparquet
    return jparquet.read_table(paths, columns=columns)


def test_host_lane_scan_hits_the_batch_cache(tmp_path):
    src = _source(tmp_path)
    sess = HyperspaceSession(HyperspaceConf(
        {"hyperspace.warehouse.dir": str(tmp_path / "wh")}), device="cpu")
    hs = Hyperspace(sess)
    df = sess.read_parquet(src)
    hs.create_index(df, IndexConfig("h_idx", ["key"], ["val"]))
    sess.enable_hyperspace()
    q = lambda: df.filter(col("key") == lit(7)).select("key", "val")  # noqa
    first = q().collect()
    hits0 = _counter("cache.host_batch.hits")
    _, metrics = q().collect(with_metrics=True)
    assert _counter("cache.host_batch.hits") > hits0
    assert metrics.counters.get("cache.host_batch.hits", 0) >= 1
    (scan,) = [o for o in metrics.operators if o.name == "Scan"]
    assert scan.detail["lane"] == "host"
    assert scan.detail["bytes_scanned"] > 0
    assert _rows(first) == _jax_rows(
        tmp_path, src, lambda d, E: d.filter(E.col("key") == E.lit(7))
        .select("key", "val"))


# ---------------------------------------------------------------------------
# The acceptance bar: warm repeat queries are link-free
# ---------------------------------------------------------------------------


def test_warm_repeat_query_is_link_free(indexed_env, tmp_path):
    sess, hs, df, src, _session = indexed_env
    q = lambda: df.filter(col("key") == lit(7)).select("val")  # noqa: E731
    plan = q()._optimized_plan()
    roots = [p for s in plan.collect_leaves() for p in s.root_paths]
    assert any("v__=" in p for p in roots), "not index-served"
    first = q().collect()
    q().collect()
    h0 = _counter("link.h2d.chunks")
    hits0 = _counter("cache.segments.hits")
    warm = q().collect()
    assert _counter("link.h2d.chunks") == h0, \
        "steady-state repeat query crossed the link"
    assert _counter("cache.segments.hits") > hits0
    assert _rows(warm) == _rows(first)
    assert _rows(warm) == _jax_rows(
        tmp_path, src,
        lambda d, E: d.filter(E.col("key") == E.lit(7)).select("val"))


def test_segment_ref_keys_on_committed_version(indexed_env):
    sess, hs, df, src, _session = indexed_env
    plan = df.filter(col("key") == lit(7)).select("val")._optimized_plan()
    scan = next(s for s in plan.collect_leaves() if s.index_name)
    ref = segcache.segment_ref_for_scan(scan)
    assert ref is not None
    assert ref.index_name == "seg_idx"
    assert ref.version == 0
    assert os.path.basename(ref.index_root) == "seg_idx"
    # Source scans (no index_name) are not version-addressable.
    src_scan = next(s for s in df.plan.collect_leaves())
    assert segcache.segment_ref_for_scan(src_scan) is None


# ---------------------------------------------------------------------------
# Version invalidation: refresh + optimize + vacuum (the index log FSM)
# ---------------------------------------------------------------------------


def _append(src, n=2000, seed=99):
    rng = np.random.default_rng(seed)
    pq.write_table(pa.table({
        "key": rng.integers(0, 200, n).astype(np.int64),
        "val": rng.random(n).astype(np.float64),
    }), os.path.join(src, f"part-extra{seed}.parquet"))


def test_refresh_invalidates_and_serves_new_version(indexed_env):
    sess, hs, df, src, _session = indexed_env
    before = df.filter(col("key") == lit(7)).select("key",
                                                    "val").collect()
    assert segcache.get_cache().bytes_held() > 0
    _append(src, seed=99)
    hs.refresh_index("seg_idx")
    # The commit hook dropped the old version's segments.
    snap = segcache.get_cache().snapshot()
    assert snap["entries"] == 0, snap
    df2 = sess.read_parquet(src)  # re-list: appended file included
    q2 = lambda: df2.filter(col("key") == lit(7)).select("key", "val")  # noqa: E731
    plan = q2()._optimized_plan()
    roots = [p for s in plan.collect_leaves() for p in s.root_paths]
    assert any("v__=1" in p for p in roots), f"not v1-served: {roots}"
    after = q2().collect()
    assert after.num_rows > before.num_rows
    sess.disable_hyperspace()
    assert _rows(after) == _rows(q2().collect())
    sess.enable_hyperspace()
    # And the new version's segments are resident + warm-hit now.
    hits0 = _counter("cache.segments.hits")
    q2().collect()
    assert _counter("cache.segments.hits") > hits0


def _index_entries(cache):
    """Count of version-keyed (index) entries resident — path-keyed
    source-scan entries are invalidated by stamps, not the FSM."""
    with cache._cv:
        return sum(1 for e in cache._entries.values()
                   if e.ref is not None)


def test_optimize_and_vacuum_invalidate(indexed_env):
    sess, hs, df, src, _session = indexed_env
    cache = segcache.get_cache()
    df.filter(col("key") == lit(7)).select("val").collect()
    assert _index_entries(cache) > 0  # v__=0 resident
    _append(src, seed=7)
    hs.refresh_index("seg_idx", mode="incremental")
    assert _index_entries(cache) == 0  # commit of v__=1 dropped v0
    df2 = sess.read_parquet(src)
    q2 = lambda: df2.filter(col("key") == lit(7)).select("val")  # noqa: E731
    q2().collect()
    assert _index_entries(cache) > 0  # v__=1 resident
    hs.optimize_index("seg_idx")
    assert _index_entries(cache) == 0  # commit of v__=2 dropped v1
    q2().collect()
    assert _index_entries(cache) > 0  # v__=2 resident
    # delete + vacuum: every segment of the index leaves the device.
    hs.delete_index("seg_idx")
    assert _index_entries(cache) == 0  # DELETED stable log drops all
    hs.vacuum_index("seg_idx")
    assert _index_entries(cache) == 0


def test_footprint_size_cache_stamp_invalidation(tmp_path):
    from hyperspace_tpu_torch.plan import footprint

    path = tmp_path / "f.parquet"
    t = pa.table({"a": np.arange(100, dtype=np.int64)})
    pq.write_table(t, str(path))
    size1 = footprint._file_size(str(path))
    assert size1 == os.path.getsize(str(path))
    # Rewrite in place with different content: the stamp changes, so a
    # reader must see the NEW size, not the cached one.
    t2 = pa.table({"a": np.arange(50_000, dtype=np.int64)})
    time.sleep(0.01)
    pq.write_table(t2, str(path))
    size2 = footprint._file_size(str(path))
    assert size2 == os.path.getsize(str(path))
    assert size2 != size1
    assert footprint.file_sizes_total([str(path)]) == size2
    footprint.invalidate_sizes(str(tmp_path))
    assert str(path) not in footprint._size_cache


def test_invalidate_paths_sweeps_host_caches(tmp_path):
    path = tmp_path / "h.parquet"
    pq.write_table(pa.table({"a": np.arange(64, dtype=np.int64)}),
                   str(path))
    parquet.read_table([str(path)])
    assert any(str(path) in k[0] for k in parquet._read_cache)
    parquet.file_row_counts([str(path)])
    assert str(path) in parquet._count_cache
    parquet.read_host_batch([str(path)], None, None)
    assert any(str(path) in k[0] for k in parquet._batch_cache)
    parquet.invalidate_paths(str(tmp_path))
    assert not any(str(path) in k[0] for k in parquet._read_cache)
    assert str(path) not in parquet._count_cache
    assert not any(str(path) in k[0] for k in parquet._batch_cache)


# ---------------------------------------------------------------------------
# Single-flight: one fill for K waiters, bit-identical results
# ---------------------------------------------------------------------------


def test_single_flight_one_fill_for_k_waiters(plain_parquet, monkeypatch):
    path, schema, _table = plain_parquet
    cache = segcache.set_cache(SegmentCache())
    reads = [0]
    real_read = parquet.read_table

    def slow_read(paths, columns=None):
        reads[0] += 1
        time.sleep(0.05)  # hold the fill open so waiters pile up
        return real_read(paths, columns=columns)

    monkeypatch.setattr(parquet, "read_table", slow_read)
    ref = _ref()
    results = [None] * 6
    errors = []

    def worker(i):
        try:
            results[i] = cache.read([path], ["a", "b"], schema, ref=ref,
                                    device=CPU)
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert reads[0] == 1, f"{reads[0]} fills for 6 concurrent readers"
    # Bit-identical by construction: every waiter got THE batch.
    assert all(r is results[0] for r in results)
    assert cache.snapshot()["fills_in_flight"] == 0


def test_failed_fill_does_not_wedge_waiters(plain_parquet, monkeypatch):
    path, schema, _table = plain_parquet
    cache = segcache.set_cache(SegmentCache())
    real_read = parquet.read_table
    calls = [0]

    def flaky_read(paths, columns=None):
        calls[0] += 1
        if calls[0] == 1:
            time.sleep(0.03)
            raise OSError("injected fill failure")
        return real_read(paths, columns=columns)

    monkeypatch.setattr(parquet, "read_table", flaky_read)
    ref = _ref()
    outcomes = []

    def worker():
        try:
            outcomes.append(cache.read([path], ["a", "b"], schema,
                                       ref=ref, device=CPU))
        except OSError as exc:
            outcomes.append(exc)

    threads = [threading.Thread(target=worker) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    # The filler got the error; the waiters retried with their own fill
    # and succeeded — nobody hung, and the cache is healthy.
    assert any(isinstance(o, OSError) for o in outcomes)
    assert any(not isinstance(o, OSError) for o in outcomes)
    assert cache.snapshot()["fills_in_flight"] == 0
    assert cache.read([path], ["a", "b"], schema, ref=ref,
                      device=CPU) is not None


# ---------------------------------------------------------------------------
# Byte budget: eviction order, leaks, pins
# ---------------------------------------------------------------------------


def _write_sized(tmp_path, name, rows):
    path = tmp_path / f"{name}.parquet"
    t = pa.table({"a": np.arange(rows, dtype=np.int64)})
    pq.write_table(t, str(path))
    return str(path), Schema.from_arrow(t.schema)


def test_byte_budget_eviction_order_under_concurrent_fills(tmp_path):
    # Each entry is ~8 KB of int64; budget fits two.
    paths = {name: _write_sized(tmp_path, name, 1000) for name in "abcd"}
    budget = 20_000
    cache = segcache.set_cache(SegmentCache(budget_bytes=budget))

    def fill(name, version):
        p, schema = paths[name]
        return cache.read([p], ["a"], schema, device=CPU,
                          ref=_ref(version=version, name=name,
                                   root=f"/idx/{name}"))

    threads = [threading.Thread(target=fill, args=(n, i))
               for i, n in enumerate("abc")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    snap = cache.snapshot()
    assert snap["bytes_held"] <= budget
    assert snap["reserved_bytes"] == 0
    assert _counter("cache.segments.evictions") >= 1
    # LRU order: touch the survivors deterministically, then overflow —
    # the LEAST recently used entry must be the victim.
    fill("a", 0)
    hits_a0 = _counter("cache.segments.hits")
    fill("a", 0)
    assert _counter("cache.segments.hits") > hits_a0  # a is resident
    fill("d", 3)  # evicts the LRU entry, which is NOT a
    hits_a1 = _counter("cache.segments.hits")
    fill("a", 0)
    assert _counter("cache.segments.hits") > hits_a1, \
        "eviction removed the most-recently-used entry"


def test_leak_sentinel_on_eviction(tmp_path, leak_sentinel):
    pa_, schema_a = _write_sized(tmp_path, "x", 2000)
    pb_, schema_b = _write_sized(tmp_path, "y", 2000)
    budget = 18_000  # fits ONE ~16 KB entry: every fill evicts the other
    cache = segcache.set_cache(SegmentCache(budget_bytes=budget))
    cache.read([pa_], ["a"], schema_a, ref=_ref(name="x", root="/i/x"),
               device=CPU)
    cache.read([pb_], ["a"], schema_b, ref=_ref(name="y", root="/i/y"),
               device=CPU)
    with leak_sentinel(tolerance=2):
        for _ in range(4):
            cache.read([pa_], ["a"], schema_a, device=CPU,
                       ref=_ref(name="x", root="/i/x"))
            cache.read([pb_], ["a"], schema_b, device=CPU,
                       ref=_ref(name="y", root="/i/y"))
    assert cache.snapshot()["bytes_held"] <= budget


def test_pinned_index_survives_byte_pressure(tmp_path):
    pa_, schema_a = _write_sized(tmp_path, "pinned", 1000)
    pb_, schema_b = _write_sized(tmp_path, "bulk", 1000)
    conf = HyperspaceConf({
        "spark.hyperspace.cache.segments.pin.indexes": "hot_idx",
        "spark.hyperspace.device": "cpu",
    })
    cache = segcache.set_cache(SegmentCache(budget_bytes=12_000))
    cache.read([pa_], ["a"], schema_a, conf=conf,
               ref=_ref(name="hot_idx", root="/i/hot"))
    assert telemetry.get_registry().gauge("cache.segments.pins").value \
        == 1
    for v in range(3):  # pressure: each fill wants the whole budget
        cache.read([pb_], ["a"], schema_b, conf=conf,
                   ref=_ref(version=v, name="bulk", root="/i/bulk"))
    hits0 = _counter("cache.segments.hits")
    cache.read([pa_], ["a"], schema_a, conf=conf,
               ref=_ref(name="hot_idx", root="/i/hot"))
    assert _counter("cache.segments.hits") > hits0, \
        "pinned segment was evicted by byte pressure"
    # Invalidation still drops pinned segments (refresh correctness
    # beats pinning).
    cache.invalidate_index("/i/hot")
    assert cache.snapshot()["pinned_entries"] == 0


def test_unversioned_scan_stamp_validation(tmp_path):
    path, schema = _write_sized(tmp_path, "plainsrc", 1000)
    cache = segcache.set_cache(SegmentCache())
    b1 = cache.read([path], ["a"], schema, device=CPU)  # stamp-keyed
    misses0 = _counter("cache.segments.misses")
    b2 = cache.read([path], ["a"], schema, device=CPU)
    assert b2 is b1  # stamped hit
    time.sleep(0.01)
    t = pa.table({"a": np.arange(500, dtype=np.int64) * 2})
    pq.write_table(t, path)
    b3 = cache.read([path], ["a"], schema, device=CPU)
    assert b3 is not b1
    assert b3.num_rows == 500
    assert _counter("cache.segments.misses") > misses0


def test_budget_zero_disables_caching(plain_parquet):
    path, schema, _table = plain_parquet
    cache = segcache.set_cache(SegmentCache(budget_bytes=0))
    b1 = cache.read([path], ["a", "b"], schema, ref=_ref(), device=CPU)
    b2 = cache.read([path], ["a", "b"], schema, ref=_ref(), device=CPU)
    assert b1 is not b2
    assert cache.snapshot()["entries"] == 0


# ---------------------------------------------------------------------------
# Tiered cache: host-RAM tier below the device tier
# ---------------------------------------------------------------------------


def _two_files(tmp_path):
    rng = np.random.default_rng(21)
    paths = []
    schema = None
    for i in (0, 1):
        t = pa.table({
            "a": rng.integers(0, 1000, 3000).astype(np.int64),
            "b": rng.random(3000).astype(np.float64),
        })
        p = tmp_path / f"tier{i}.parquet"
        pq.write_table(t, str(p))
        paths.append(str(p))
        schema = Schema.from_arrow(t.schema)
    return paths, schema


def _tier_conf(host_bytes):
    return HyperspaceConf({
        "spark.hyperspace.cache.segments.host.bytes": str(host_bytes),
        "spark.hyperspace.device": "cpu"})


def test_eviction_demotes_to_host_tier_and_promotes_without_decode(
        tmp_path, monkeypatch):
    """Device-tier eviction lands the victim in the host tier within its
    byte budget; a later read of the demoted key re-promotes through the
    TransferEngine fill lane with cache.segments.host.hits moving and NO
    host-side parquet re-decode."""
    from hyperspace_tpu_torch.io import columnar

    (p1, p2), schema = _two_files(tmp_path)
    conf = _tier_conf(1 << 20)
    # Budget fits exactly one decoded file on the device.
    cache = segcache.set_cache(SegmentCache(budget_bytes=60_000))

    before_demote = _counter("cache.segments.host.demotions")
    b1 = cache.read([p1], None, schema, conf=conf)
    cache.read([p2], None, schema, conf=conf)  # evicts+demotes p1
    snap = cache.snapshot()
    assert snap["host_entries"] == 1
    assert 0 < snap["host_bytes_held"] <= (1 << 20)
    assert _counter("cache.segments.host.demotions") == before_demote + 1

    fill_bytes = _counter("transfer.fill.bytes")
    host_hits = _counter("cache.segments.host.hits")

    def boom(*a, **k):
        raise AssertionError("host-side parquet decode on the promote "
                             "path")

    monkeypatch.setattr(parquet, "read_table", boom)
    b1_again = cache.read([p1], None, schema, conf=conf)
    monkeypatch.undo()

    assert _counter("cache.segments.host.hits") == host_hits + 1
    # The promotion crossed the link through the FILL lane.
    assert _counter("transfer.fill.bytes") > fill_bytes
    assert columnar.to_arrow(b1_again).equals(columnar.to_arrow(b1))
    # p1 is back on the device; p2 was demoted to make room.
    snap = cache.snapshot()
    assert snap["entries"] == 1 and snap["host_entries"] == 1


def test_host_tier_byte_accounting_and_budget(tmp_path):
    """The host-tier LRU honors its own byte budget (a tier smaller than
    one entry holds nothing), and the snapshot's byte accounting stays
    exact across demote/evict cycles."""
    (p1, p2), schema = _two_files(tmp_path)
    cache = segcache.set_cache(SegmentCache(budget_bytes=60_000))

    tiny = _tier_conf(1024)
    cache.read([p1], None, schema, conf=tiny)
    cache.read([p2], None, schema, conf=tiny)
    snap = cache.snapshot()
    assert snap["host_entries"] == 0 and snap["host_bytes_held"] == 0

    cache.clear()
    one = _tier_conf(50_000)
    evictions = _counter("cache.segments.host.evictions")
    cache.read([p1], None, schema, conf=one)
    cache.read([p2], None, schema, conf=one)   # p1 -> host
    cache.read([p1], None, schema, conf=one)   # p1 promoted, p2 -> host
    snap = cache.snapshot()
    assert snap["host_entries"] == 1
    assert snap["host_bytes_held"] <= 50_000
    assert _counter("cache.segments.host.evictions") >= evictions


def test_host_tier_demote_promote_leaks_nothing(tmp_path, leak_sentinel):
    (p1, p2), schema = _two_files(tmp_path)
    conf = _tier_conf(1 << 20)
    cache = segcache.set_cache(SegmentCache(budget_bytes=60_000))
    cache.read([p1], None, schema, conf=conf)
    cache.read([p2], None, schema, conf=conf)
    cache.read([p1], None, schema, conf=conf)
    with leak_sentinel(tolerance=2):
        for _ in range(3):
            cache.read([p2], None, schema, conf=conf)
            cache.read([p1], None, schema, conf=conf)
    snap = cache.snapshot()
    assert snap["entries"] == 1 and snap["host_entries"] == 1


def test_invalidation_sweeps_host_tier(tmp_path):
    (p1, p2), schema = _two_files(tmp_path)
    conf = _tier_conf(1 << 20)
    cache = segcache.set_cache(SegmentCache(budget_bytes=60_000))
    root = str(tmp_path / "idx")
    cache.read([p1], None, schema, ref=SegmentRef("t_idx", root, 0, 0),
               conf=conf)
    cache.read([p2], None, schema,
               ref=SegmentRef("t_idx", root, 0, 1), conf=conf)
    assert cache.snapshot()["host_entries"] == 1
    cache.invalidate_index(root, keep_version=7)
    snap = cache.snapshot()
    assert snap["entries"] == 0 and snap["host_entries"] == 0
    assert snap["host_bytes_held"] == 0 and snap["bytes_held"] == 0


# ---------------------------------------------------------------------------
# Bucket-scoped invalidation
# ---------------------------------------------------------------------------


def test_rekey_carried_keeps_untouched_buckets(tmp_path):
    (p1, p2), schema = _two_files(tmp_path)
    cache = segcache.set_cache(SegmentCache(budget_bytes=1 << 30))
    root = str(tmp_path / "idx")
    batch0 = cache.read([p1], None, schema, device=CPU,
                        ref=SegmentRef("t_idx", root, 0, 0))
    cache.read([p2], None, schema, device=CPU,
               ref=SegmentRef("t_idx", root, 0, 1))
    cache.read([p1], None, schema, device=CPU,
               ref=SegmentRef("t_idx", root, 0, "all"))
    assert cache.snapshot()["entries"] == 3
    rekeyed_before = _counter("cache.segments.rekeyed")

    segcache.on_version_committed(root, 1, touched_buckets={1},
                                  carried_from=0)

    # Bucket 0 survived under the NEW version — the same batch object,
    # zero fills; bucket 1 (touched) and "all" (unknowable) dropped.
    assert cache.snapshot()["entries"] == 1
    assert _counter("cache.segments.rekeyed") == rekeyed_before + 1
    fills = _counter("cache.segments.fills")
    again = cache.read([p1], None, schema, device=CPU,
                       ref=SegmentRef("t_idx", root, 1, 0))
    assert again is batch0
    assert _counter("cache.segments.fills") == fills


def test_incremental_refresh_commits_bucket_scoped(tmp_path, monkeypatch):
    """The incremental-refresh action reports the buckets it touched and
    hands them to the commit hook — the same buckets the JAX package's
    action reports."""
    rng = np.random.default_rng(5)
    src = tmp_path / "incsrc"
    src.mkdir()
    pq.write_table(pa.table({
        "key": rng.integers(0, 100, 4000).astype(np.int64),
        "val": rng.random(4000).astype(np.float64),
    }), str(src / "part-0.parquet"))
    conf = {"hyperspace.warehouse.dir": str(tmp_path / "wh"),
            "spark.hyperspace.index.num.buckets": "4"}
    sess = HyperspaceSession(HyperspaceConf(conf), device="cpu")
    hs = Hyperspace(sess)
    hs.create_index(sess.read_parquet(str(src)),
                    IndexConfig("inc_idx", ["key"], ["val"]))
    jsess = JSession(jhs.HyperspaceConf(
        {**conf, "hyperspace.warehouse.dir": str(tmp_path / "jwh"),
         "spark.hyperspace.distribution.enabled": "false"}))
    jhs_ = jhs.Hyperspace(jsess)
    jhs_.create_index(jsess.read_parquet(str(src)),
                      jhs.IndexConfig("inc_idx", ["key"], ["val"]))

    calls = []
    real = segcache.on_version_committed

    def capture(root, version, touched_buckets=None, carried_from=None):
        calls.append((version, touched_buckets, carried_from))
        return real(root, version, touched_buckets=touched_buckets,
                    carried_from=carried_from)

    monkeypatch.setattr(segcache, "on_version_committed", capture)
    # Appended rows: a handful of keys -> a strict subset of buckets.
    pq.write_table(pa.table({
        "key": np.asarray([3, 3, 3, 7], dtype=np.int64),
        "val": rng.random(4).astype(np.float64),
    }), str(src / "part-1.parquet"))
    hs.refresh_index("inc_idx", mode="incremental")
    jhs_.refresh_index("inc_idx", mode="incremental")

    assert calls, "incremental commit never reached the cache hook"
    version, touched, carried = calls[-1]
    assert carried == version - 1
    assert touched is not None and 0 < len(touched) < 4
    report = hs.metrics_registry().last_action_report()
    jreport = jhs_.metrics_registry().last_action_report()
    assert report["detail"]["touched_buckets"] == sorted(touched) \
        == jreport["detail"]["touched_buckets"]


# ---------------------------------------------------------------------------
# Cache safety: a cached batch is shared, and nothing writes into it
# ---------------------------------------------------------------------------


def _safety_source(tmp_path):
    rng = np.random.default_rng(17)
    n = 6000
    src = tmp_path / "safe_src"
    src.mkdir()
    pq.write_table(pa.table({
        "k": rng.integers(0, 300, n).astype(np.int64),
        "g": rng.integers(0, 12, n).astype(np.int64),
        "v": np.round(rng.random(n) * 100, 3),
        "s": pa.array([None if i % 23 == 0 else f"s{i % 37}"
                       for i in range(n)]),
    }), str(src / "part-0.parquet"))
    return str(src)


def _safety_queries(df, other):
    """Queries of every operator family over two cached segments: the
    index's (through a range filter, rules on) and the source's (no
    filter, so the operators read the cached arrays themselves). Within
    each group every query reads the same four columns — the same cached
    segment."""
    indexed = df.filter(col("k") >= lit(0)).select("k", "g", "v", "s")
    raw = df.select("k", "g", "v", "s")
    queries = []
    for tag, base in (("index", indexed), ("source", raw)):
        upper = base.filter(col("k") >= lit(150))
        queries += [(f"{tag} {name}", frame) for name, frame in [
            ("sort", base.sort("-s", "-v", "k", "g")),
            ("sort", base.sort("-s", "-v", "k", "g")),
            ("filter", base.filter(col("v") < lit(50.0))),
            ("aggregate", base.group_by("g", "s").agg(
                ("sum", "v", "sv"), ("count", "k", "ck"),
                ("max", "k", "mk"))),
            ("window", base.window(["g"], order_by=["k", "-v", "s"],
                                   rn=("row_number", "*"),
                                   tot=("sum", "v"))),
            ("distinct", base.distinct()),
            ("intersect", base.intersect(upper)),
            ("except", base.except_(upper)),
            ("topk", base.sort("-v", "k", "-s", "g").limit(25)),
            ("join", base.join(other, on=["k"])),
        ]]
    return queries


def _fingerprint(arrays):
    h = hashlib.sha256()
    for a in arrays:
        if a is None:
            h.update(b"-")
        elif isinstance(a, torch.Tensor):
            h.update(a.contiguous().numpy().tobytes())
        else:
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _cached_batches(lane):
    if lane == "device":
        cache = segcache.get_cache()
        with cache._cv:
            return [e.batch for e in cache._entries.values()]
    with parquet._batch_cache_lock:
        return [b for _, b, _ in parquet._batch_cache.values()]


def _batch_checksum(batch):
    arrays = []
    for _name, c in sorted(batch.columns.items()):
        arrays += [c.data, c.validity, *(c.dict_hashes or ()),
                   c.dictionary]
    return _fingerprint(arrays)


@pytest.mark.parametrize("lane", ["host", "device"])
def test_cached_segments_are_never_written(tmp_path, monkeypatch, lane):
    src = _safety_source(tmp_path)
    other_src = tmp_path / "other"
    other_src.mkdir()
    pq.write_table(pa.table({"k": np.arange(0, 300, 3, dtype=np.int64),
                             "w": np.arange(100, dtype=np.float64)}),
                   str(other_src / "part-0.parquet"))

    def run(tag, zero_budgets):
        conf = {"hyperspace.warehouse.dir": str(tmp_path / tag),
                "spark.hyperspace.broadcast.threshold": "-1"}
        if lane == "device":
            conf["spark.hyperspace.execution.min.device.rows"] = "0"
        if zero_budgets:
            conf["spark.hyperspace.cache.segments.bytes"] = "0"
            conf["spark.hyperspace.cache.read.bytes"] = "0"
        sess = HyperspaceSession(HyperspaceConf(conf), device="cpu")
        hs = Hyperspace(sess)
        df = sess.read_parquet(src)
        hs.create_index(df, IndexConfig("safe_idx", ["k"], ["g", "v", "s"]))
        sess.enable_hyperspace()
        other = sess.read_parquet(str(other_src))
        results = []
        tracked = {}  # id -> (batch, checksum when first cached)
        for name, frame in _safety_queries(df, other):
            results.append((name, _rows(frame.collect())))
            for batch, checksum in tracked.values():
                assert _batch_checksum(batch) == checksum, \
                    f"the {name} query wrote into a cached batch"
            for batch in _cached_batches(lane):
                tracked.setdefault(id(batch),
                                   (batch, _batch_checksum(batch)))
        return results, len(tracked)

    hit_counter = ("cache.segments.hits" if lane == "device"
                   else "cache.host_batch.hits")
    hits0 = _counter(hit_counter)
    cached, n_cached = run("cached", zero_budgets=False)
    assert n_cached, "nothing was cached"
    # Each group of ten queries shares one cached batch.
    assert _counter(hit_counter) - hits0 >= 18

    segcache.set_cache(SegmentCache())
    parquet.clear_read_cache()
    monkeypatch.setattr(parquet, "READ_CACHE_BYTES", 0)
    uncached, n_uncached = run("uncached", zero_budgets=True)
    assert n_uncached == 0
    assert cached == uncached
