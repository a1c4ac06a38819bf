"""The serving plane's reach into the I/O layer and data skipping, in
the port against the JAX package: the cases of `tests/test_segcache.py`
(a cancelled fill releases its reservation, the admission credit for
resident segments, a chaos run against a concurrent refresher),
`tests/test_transfer.py` (a transient `transfer.put` fault retried with
chunk order intact, a permanent one raised) and `tests/test_skipping.py`
(the skipping lifecycle through injected crashes, the footprint
re-projection credit, and the per-index breaker over a Z-order copy
whose data went bad) — through both packages on the same inputs.
"""

import os
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401

from torch_serving import (JAX, PKGS, TORCH, both, canonical,
                           jax_counters_restored, reset_lanes, same_rows, typed)


@pytest.fixture(autouse=True)
def _fresh():
    reset_lanes()
    saved = [(P, P.segcache.get_cache()) for P in PKGS]
    with jax_counters_restored():
        yield
    for P, cache in saved:
        P.segcache.set_cache(cache)
        P.transfer.reset_engine()
    reset_lanes()


# -- segment cache -------------------------------------------------------------


def _ref(P, version=0, bucket="all", name="u", root="/idx/u"):
    return P.segcache.SegmentRef(index_name=name, index_root=root,
                                 version=version, bucket=bucket)


def test_cancellation_mid_fill_releases_reservation(tmp_path):
    def scenario(P, d):
        rng = np.random.default_rng(9)
        path = str(d / "plain.parquet")
        table = pa.table({
            "a": rng.integers(0, 1000, 5000).astype(np.int64),
            "b": rng.random(5000).astype(np.float64)})
        pq.write_table(table, path)
        schema = P.schema.Schema.from_arrow(table.schema)
        cache = P.segcache.set_cache(P.segcache.SegmentCache())
        dl = P.sched.Deadline("q-cancel")
        dl.cancel()
        # The port's cache takes the session's device from a conf; the
        # CPU here. The JAX package places on its default device.
        kw = {"device": "cpu"} if P is TORCH else {}
        with P.telemetry.deadline_scope(dl):
            with pytest.raises(P.exc.QueryCancelledError) as ei:
                cache.read([path], ["a", "b"], schema, ref=_ref(P), **kw)
        snap = cache.snapshot()
        batch = cache.read([path], ["a", "b"], schema, ref=_ref(P), **kw)
        return (typed(ei.value), ei.value.phase, snap["reserved_bytes"],
                snap["fills_in_flight"], snap["entries"], batch.num_rows)

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"]
    assert got["torch"][2:] == (0, 0, 0, 5000)


def test_resident_bytes_by_root_match_the_entries(tmp_path):
    """The port's per-root tally of device-resident bytes (what the
    admission credit reads on every collect) equals a walk of the
    cache's entries through fills, a stale refill, LRU evictions, an
    index invalidation and a clear."""
    rng = np.random.default_rng(5)
    paths = []
    for i in range(6):
        path = str(tmp_path / f"f{i}.parquet")
        pq.write_table(pa.table({
            "a": rng.integers(0, 1000, 4000).astype(np.int64)}), path)
        paths.append(path)
    schema = TORCH.schema.Schema.from_arrow(
        pq.read_schema(paths[0]))
    roots = ("/idx/u", "/idx/w")
    cache = TORCH.segcache.set_cache(TORCH.segcache.SegmentCache(
        budget_bytes=4 * 4000 * 8, host_budget_bytes=0))

    def read(i, root):
        return cache.read([paths[i]], ["a"], schema, device="cpu",
                          ref=_ref(TORCH, bucket=i, name=root[-1],
                                   root=root))

    def walk(root):
        return sum(e.nbytes for e in cache._entries.values()
                   if e.ref is not None and e.ref.index_root == root)

    def agree():
        return all(cache.resident_bytes_for_roots({r}) == walk(r)
                   for r in roots) and \
            cache.resident_bytes_for_roots(set(roots)) \
            == cache.bytes_held()

    read(0, roots[0])
    read(1, roots[1])
    assert agree() and walk(roots[0]) > 0 and walk(roots[1]) > 0
    time.sleep(0.01)
    pq.write_table(pa.table({"a": np.arange(2000, dtype=np.int64)}),
                   paths[0])
    read(0, roots[0])  # stale: dropped and refilled
    assert agree()
    for i in range(2, 6):  # past the budget: the LRU entries leave
        read(i, roots[i % 2])
    assert agree() and cache.snapshot()["entries"] < 6
    cache.invalidate_index(roots[0])
    assert agree() and walk(roots[0]) == 0 and walk(roots[1]) > 0
    assert cache.resident_bytes_for_roots(set()) == 0
    cache.clear()
    assert agree() and cache.resident_bytes_for_roots(set(roots)) == 0


def _indexed_env(P, d):
    rng = np.random.default_rng(3)
    n = 20_000
    src = d / "src"
    src.mkdir()
    pq.write_table(pa.table({
        "key": rng.integers(0, 200, n).astype(np.int64),
        "val": rng.random(n).astype(np.float64),
    }), str(src / "part-0.parquet"))
    sess = P.session({
        "hyperspace.warehouse.dir": str(d / "wh"),
        "spark.hyperspace.execution.min.device.rows": "0",
        "spark.hyperspace.distribution.enabled": "false"})
    hs = P.Hyperspace(sess)
    df = sess.read_parquet(str(src))
    hs.create_index(df, P.IndexConfig("seg_idx", ["key"], ["val"]))
    sess.enable_hyperspace()
    return sess, hs, df


def test_footprint_credit_for_resident_segments(tmp_path, monkeypatch):
    def scenario(P, d):
        P.segcache.set_cache(P.segcache.SegmentCache())
        sess, hs, df = _indexed_env(P, d)
        # The cache's budget under `serve.hbm.budget.bytes` reads the
        # accountant's last live-bytes sample, which is process-wide and
        # throttled: without a fresh one it can be an earlier test's
        # (576,504,048 B once, above this test's 512 MiB budget, so the
        # first fill found no room).
        P.telemetry.memory.sample(force=True)
        monkeypatch.setattr(P.footprint, "MIN_FOOTPRINT_BYTES", 1024)
        try:
            sess.conf.set("spark.hyperspace.serve.hbm.budget.bytes",
                          str(512 * 1024 * 1024))
            q = lambda: df.filter(P.col("key") == P.lit(7))  # noqa: E731
            first = q().select("val").collect()
            held = P.segcache.get_cache().bytes_held() > 0
            c0 = P.counter("serve.footprint_credit_bytes")
            table, metrics = q().select("val").collect(with_metrics=True)
            return (held, P.counter("serve.footprint_credit_bytes") > c0,
                    bool(metrics.events_of("serve", "footprint_credit")),
                    first, table)
        finally:
            monkeypatch.undo()

    got = both(scenario, tmp_path)
    assert got["torch"][:3] == got["jax"][:3] == (True, True, True)
    assert same_rows(got["torch"][3], got["jax"][3])
    assert same_rows(got["torch"][4], got["torch"][3])


def test_chaos_with_concurrent_refresh(tmp_path):
    def scenario(P, d):
        P.segcache.set_cache(P.segcache.SegmentCache())
        sess, hs, df = _indexed_env(P, d)
        col, lit = P.col, P.lit
        workload = [
            ("filt", df.filter(col("key") == lit(7)).select("key", "val")),
            ("range", df.filter(col("key") < lit(20)).select("key",
                                                              "val"))]
        expected = {name: canonical(q.collect()) for name, q in workload}
        stop = threading.Event()

        def refresher():
            while not stop.is_set():
                try:
                    hs.refresh_index("seg_idx")
                except Exception:
                    pass  # OCC conflicts are fine
                time.sleep(0.01)

        th = threading.Thread(target=refresher, daemon=True)
        th.start()
        try:
            report = P.run_chaos(
                workload, expected, clients=6, total_queries=90,
                timeout_for=lambda i: 0.002 if i % 9 == 4 else None)
        finally:
            stop.set()
            th.join(timeout=30)
        snap = P.segcache.get_cache().snapshot()
        return {"report": report, "expected": expected,
                "reserved": snap["reserved_bytes"],
                "in_flight": snap["fills_in_flight"],
                "alive": th.is_alive()}

    got = both(scenario, tmp_path)
    for name, table in got["torch"]["expected"].items():
        assert same_rows(table, got["jax"]["expected"][name])
    for P in PKGS:
        r = got[P.name]
        report = r["report"]
        assert not report.stuck_threads, report.summary()
        assert not report.mismatches, report.mismatches[:3]
        assert report.outcomes["ok"] >= 1
        assert report.outcomes["error"] == 0, report.errors[:3]
        assert (r["reserved"], r["in_flight"], r["alive"]) == (0, 0, False)


# -- transfer engine -------------------------------------------------------------


def test_transient_put_retries_preserving_chunk_order(tmp_path):
    def scenario(P, d):
        eng = P.transfer.set_engine(P.transfer.TransferEngine(
            chunk_bytes=1024, inflight_bytes=8192, threads=2))
        inj = P.arm(P.rule("transfer.put", kind="transient", nth=3,
                           times=2))
        r0 = P.telemetry.get_registry().counter("io.retries").value
        arr = np.arange(4096, dtype=np.int16)
        kw = {"device": "cpu"} if P is TORCH else {}
        parts = eng.put_chunks(arr, **kw)
        got = np.concatenate([np.asarray(p) for p in parts])
        return (got.tolist() == arr.tolist(), inj.fired("transfer.put"),
                P.telemetry.get_registry().counter("io.retries").value - r0,
                len(parts))

    got = both(scenario, tmp_path)
    # Chunk planning is each engine's own (the JAX package's cuts this
    # array in 4, the port's in 8 chunk_bytes-sized pieces): compare
    # what the retries must preserve.
    assert got["torch"][:3] == got["jax"][:3] == (True, 2, 2)
    assert got["torch"][3] > 2


def test_permanent_put_raises(tmp_path):
    def scenario(P, d):
        eng = P.transfer.set_engine(P.transfer.TransferEngine(
            chunk_bytes=1 << 20, inflight_bytes=1 << 22))
        P.arm(P.rule("transfer.put", kind="permanent"))
        kw = {"device": "cpu"} if P is TORCH else {}
        with pytest.raises(P.faults.InjectedPermanentError) as ei:
            eng.put(np.arange(10), **kw)
        return typed(ei.value), str(ei.value), eng._window_bytes

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == "InjectedPermanentError"


# -- data skipping -----------------------------------------------------------------


def _skip_env(P, d):
    src = d / "src"
    src.mkdir()
    rng = np.random.default_rng(7)
    for i in range(8):
        pq.write_table(pa.table({
            "key": np.arange(i * 100, (i + 1) * 100, dtype=np.int64),
            "val": rng.random(100),
            "s": pa.array([f"s{i}_{j % 10}" for j in range(100)]),
        }), str(src / f"f{i}.parquet"))
    sess = P.session({"hyperspace.warehouse.dir": str(d / "wh")})
    return sess, P.Hyperspace(sess), sess.read_parquet(str(src))


def test_lifecycle_round_trip_with_crash_recovery(tmp_path):
    def scenario(P, d):
        sess, hs, df = _skip_env(P, d)
        cfg = lambda: P.DataSkippingIndexConfig("sk", ["key"])  # noqa
        inj = P.arm(P.rule("action.CreateSkippingIndexAction.op",
                           kind="crash"))
        with pytest.raises(P.faults.InjectedCrash):
            hs.create_index(df, cfg())
        out = [inj.fired("action.*")]
        P.faults.uninstall()
        out.append(hs.recover_index("sk"))
        hs.create_index(df, cfg())
        inj2 = P.arm(P.rule("action.RefreshAction.end", kind="crash"))
        with pytest.raises(P.faults.InjectedCrash):
            hs.refresh_index("sk")
        out.append(inj2.fired("action.*"))
        P.faults.uninstall()
        out.append(hs.recover_index("sk"))
        hs.refresh_index("sk")
        q = df.filter(P.col("key") == P.lit(5)).select("key")
        sess.enable_hyperspace()
        try:
            on, m = q.collect(with_metrics=True)
        finally:
            sess.disable_hyperspace()
        off = q.collect()
        assert same_rows(on, off)
        out.append(m.counters.get("skipping.files_pruned", 0) > 0)
        hs.delete_index("sk")
        hs.vacuum_index("sk")
        out.append(len(hs.indexes()))
        manager = P.Hyperspace.get_context(sess).index_collection_manager
        index_path = manager.path_resolver.get_index_path("sk")
        out.append(any(n.startswith("v__=") for n in os.listdir(index_path)))
        return out, on

    got = both(scenario, tmp_path)
    assert got["torch"][0] == got["jax"][0] == [1, True, 1, True, True, 0,
                                                False]
    assert same_rows(got["torch"][1], got["jax"][1])


def test_footprint_reprojection_credit(tmp_path, monkeypatch):
    def scenario(P, d):
        sess, hs, df = _skip_env(P, d)
        monkeypatch.setattr(P.footprint, "MIN_FOOTPRINT_BYTES", 1024)
        try:
            hs.create_index(df, P.DataSkippingIndexConfig("sk", ["key"]))
            sess.enable_hyperspace()
            try:
                c0 = P.counter("serve.footprint_credit_bytes")
                table, metrics = df.filter(P.col("key") == P.lit(250)) \
                    .select("key").collect(with_metrics=True)
            finally:
                sess.disable_hyperspace()
            return (P.counter("serve.footprint_credit_bytes") > c0,
                    bool(metrics.events_of("serve",
                                           "footprint_reprojected")),
                    table)
        finally:
            monkeypatch.undo()

    got = both(scenario, tmp_path)
    assert got["torch"][:2] == got["jax"][:2] == (True, True)
    assert same_rows(got["torch"][2], got["jax"][2])


def test_zorder_missing_data_degrades_and_trips_breaker(tmp_path):
    """The breaker half of `tests/test_skipping.py`'s case (its degrade
    half is in `tests/test_torch_skipping.py`): with
    `serve.breaker.failures=1`, the first failed scan of the corrupted
    Z-order copy opens the index's breaker and the next query goes
    straight to the source plan."""
    def scenario(P, d):
        src = d / "zsrc"
        src.mkdir()
        rng = np.random.default_rng(3)
        n, files = 4000, 4
        keys = rng.permutation(n).astype(np.int64)
        k2 = rng.integers(0, 50, n).astype(np.int64)
        per = n // files
        for i in range(files):
            sl = slice(i * per, (i + 1) * per)
            pq.write_table(pa.table({"key": keys[sl], "k2": k2[sl],
                                     "val": rng.random(per)}),
                           str(src / f"f{i}.parquet"))
        sess = P.session({
            "hyperspace.warehouse.dir": str(d / "zwh"),
            "spark.hyperspace.index.skipping.zorder.files": "8",
            "spark.hyperspace.serve.breaker.failures": "1"})
        hs = P.Hyperspace(sess)
        df = sess.read_parquet(str(src))
        hs.create_index(df, P.DataSkippingIndexConfig(
            "z", ["key"], zorder_by=["key"]))
        q = df.filter(P.col("key") < P.lit(50)).select("key", "val")
        baseline = q.collect()
        manager = P.Hyperspace.get_context(sess).index_collection_manager
        (entry,) = manager.get_indexes(["ACTIVE"])
        parquet = __import__(f"{P.root}.io.parquet", fromlist=["x"])
        sess.enable_hyperspace()
        try:
            q._optimized_plan()
            for name in os.listdir(entry.content.root):
                if name.endswith(".parquet"):
                    p = os.path.join(entry.content.root, name)
                    st = os.stat(p)
                    with open(p, "wb") as f:
                        f.write(b"\x00" * st.st_size)
                    os.utime(p, ns=(st.st_atime_ns, st.st_mtime_ns))
            parquet.clear_read_cache()
            fb0 = P.counter("resilience.fallbacks")
            t1 = q.collect()
            fb = P.counter("resilience.fallbacks") - fb0
            sc0 = P.counter("resilience.breaker.short_circuits")
            op0 = P.counter("resilience.breaker.opened")
            t2 = q.collect()
            sc = P.counter("resilience.breaker.short_circuits") - sc0
        finally:
            sess.disable_hyperspace()
        assert same_rows(t1, baseline) and same_rows(t2, baseline)
        return fb, sc, P.counter("resilience.breaker.opened") - op0, t2

    got = both(scenario, tmp_path)
    assert got["torch"][:3] == got["jax"][:3] == (1, 1, 0)
    assert same_rows(got["torch"][3], got["jax"][3])
    assert JAX is not TORCH
