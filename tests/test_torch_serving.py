"""The port's serving plane (`hyperspace_tpu_torch/engine/scheduler.py`)
against the JAX package's: every scenario of `tests/test_serving.py` —
the deadline primitive and its pool-thread propagation, admission
(FIFO, reject, queue deadline, the progress guarantee), backpressure
and cancellation through `collect`, deadlines mid-query with the flight
record, survivor isolation, the degradation circuit breaker, the
transfer engine's acquire timeout, reservation release and chunk-loop
deadline, the footprint projection, session close, and the chaos run
with faults — run through both packages on the same seeded lake.
Results compare row for row (`torch_serving.same_rows`); typed errors,
phases and counters compare by name.
"""

import os
import shutil
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401

from test_serving import fresh_scheduler  # noqa: F401  (JAX-side fixture)
from torch_serving import (JAX, MIB, PKGS, TORCH, both, canonical,
                           jax_counters_restored, reset_lanes, same_rows, typed)

PHASES = ("plan", "scan", "operator", "stage", "transfer", "write",
          "queue", "batch", "cache.fill", "transfer.fill")


@pytest.fixture(autouse=True)
def lanes(fresh_scheduler):  # noqa: F811
    reset_lanes()
    with jax_counters_restored():
        yield
    reset_lanes()


def _serving_lake(d):
    rng = np.random.default_rng(11)
    n, n_dims = 50_000, 500
    facts, dims = d / "facts", d / "dims"
    facts.mkdir(exist_ok=True)
    dims.mkdir(exist_ok=True)
    pq.write_table(pa.table({
        "k": rng.integers(0, n_dims, n).astype(np.int64),
        "g": rng.integers(0, 16, n).astype(np.int64),
        "v": rng.random(n).astype(np.float64),
    }), str(facts / "part-0.parquet"))
    pq.write_table(pa.table({
        "k": np.arange(n_dims, dtype=np.int64),
        "w": rng.random(n_dims).astype(np.float64),
    }), str(dims / "part-0.parquet"))
    return str(facts), str(dims)


def _session(P, d, **extra):
    conf = {"hyperspace.warehouse.dir": str(d / "wh")}
    conf.update(extra)
    return P.session(conf)


def _join_query(P, sess, facts, dims):
    f = sess.read_parquet(facts)
    w = sess.read_parquet(dims)
    return f.join(w, on="k").filter(P.col("w") > P.lit(0.25)) \
        .group_by("g").agg(("sum", "v", "total"), cnt=("count", "*"))


# ---------------------------------------------------------------------------
# Deadline primitive
# ---------------------------------------------------------------------------


def test_deadline_expiry_and_cancel_are_typed(tmp_path):
    def scenario(P, d):
        out = []
        dl = P.sched.Deadline("q-x", timeout_s=0.01)
        dl.check("scan")
        time.sleep(0.015)
        with pytest.raises(P.exc.QueryDeadlineExceededError) as ei:
            dl.check("transfer")
        out.append((typed(ei.value), ei.value.phase, ei.value.query_id))
        d2 = P.sched.Deadline("q-y")
        out.append(d2.remaining())
        d2.check("stage")
        d2.cancel()
        with pytest.raises(P.exc.QueryCancelledError) as ei:
            d2.check("write")
        out.append((typed(ei.value), ei.value.phase))
        out.append(issubclass(P.exc.QueryDeadlineExceededError,
                              P.exc.QueryCancelledError))
        out.append(ei.value.counter)
        return out

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == ("QueryDeadlineExceededError", "transfer",
                               "q-x")
    assert got["torch"][1:] == [None, ("QueryCancelledError", "write"),
                                True, "serve.cancelled"]


def test_deadline_propagates_to_pool_threads(tmp_path):
    def scenario(P, d):
        dl = P.sched.Deadline("q-z")
        dl.cancel()
        seen = []

        def probe():
            try:
                P.telemetry.check_deadline("operator")
                seen.append("no-raise")
            except P.exc.QueryCancelledError as exc:
                seen.append(exc.phase)

        with P.telemetry.deadline_scope(dl):
            wrapped = P.telemetry.propagating(probe)
        t = threading.Thread(target=wrapped)
        t.start()
        t.join(5)
        P.telemetry.check_deadline("operator")  # no scope: a no-op
        return seen

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == ["operator"]


# ---------------------------------------------------------------------------
# Admission control (unit level)
# ---------------------------------------------------------------------------


def test_admission_fifo_queue_and_reject(tmp_path):
    def scenario(P, d):
        sch = P.sched.get_scheduler()
        conf = P.conf({"spark.hyperspace.serve.hbm.budget.bytes": 100,
                       "spark.hyperspace.serve.queue.depth": 1})
        out = []
        e1 = P.entry("q1", 60)
        out.append(sch._admit(e1, conf))
        out.append(sch.admitted_bytes())
        admitted = threading.Event()

        def queued_worker():
            e2 = P.entry("q2", 60)
            sch._admit(e2, conf)
            admitted.set()
            sch._release(e2)

        t = threading.Thread(target=queued_worker)
        t.start()
        for _ in range(200):
            with sch._cv:
                if sch._waiters:
                    break
            time.sleep(0.005)
        out.append(admitted.is_set())
        with pytest.raises(P.exc.QueryRejectedError) as ei:
            sch._admit(P.entry("q3", 60), conf)
        out.append((typed(ei.value), ei.value.phase))
        sch._release(e1)
        out.append(admitted.wait(5.0))
        t.join(5)
        out.append(sch.admitted_bytes())
        e_hold = P.hold(sch, 100)
        try:
            with pytest.raises(P.exc.QueryDeadlineExceededError) as ei:
                sch._admit(P.entry("q4", 60, timeout_s=0.05), conf)
            out.append((typed(ei.value), ei.value.phase))
        finally:
            sch._release(e_hold)
        return out

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"]
    assert got["torch"] == [0.0, 60, False,
                            ("QueryRejectedError", "queue"), True, 0,
                            ("QueryDeadlineExceededError", "queue")]


def test_oversized_query_still_admits_when_idle(tmp_path):
    def scenario(P, d):
        sch = P.sched.get_scheduler()
        conf = P.conf({"spark.hyperspace.serve.hbm.budget.bytes": 100})
        big = P.entry("big", 10_000)
        waited = sch._admit(big, conf)
        sch._release(big)
        return waited, sch.admitted_bytes()

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == (0.0, 0)


# ---------------------------------------------------------------------------
# End-to-end: collect under budget pressure
# ---------------------------------------------------------------------------


def test_collect_backpressure_and_queue_deadline(tmp_path):
    def scenario(P, d):
        facts, _dims = _serving_lake(d)
        sess = _session(P, d, **{
            "spark.hyperspace.serve.hbm.budget.bytes": 2 * MIB,
            "spark.hyperspace.serve.queue.depth": 0})
        df = sess.read_parquet(facts).select("k")
        warm = df.collect()
        sch = P.sched.get_scheduler()
        holder = P.hold(sch, 2 * MIB)
        out = {}
        try:
            r0 = P.counter("serve.rejected")
            with pytest.raises(P.exc.QueryRejectedError) as ei:
                df.collect()
            out["reject"] = (typed(ei.value), ei.value.phase,
                             P.counter("serve.rejected") - r0)
            sess.conf.set("spark.hyperspace.serve.queue.depth", "4")
            x0 = P.counter("serve.deadline_exceeded")
            with pytest.raises(P.exc.QueryDeadlineExceededError) as ei:
                df.collect(timeout=0.05)
            out["deadline"] = (typed(ei.value), ei.value.phase,
                               P.counter("serve.deadline_exceeded") - x0,
                               P.counter("serve.interrupted.queue") >= 1)
        finally:
            sch._release(holder)
        out["resumed"] = df.collect()
        out["warm"] = warm
        return out

    got = both(scenario, tmp_path)
    j, t = got["jax"], got["torch"]
    assert t["reject"] == j["reject"] == ("QueryRejectedError", "queue", 1)
    assert t["deadline"] == j["deadline"] == (
        "QueryDeadlineExceededError", "queue", 1, True)
    assert t["resumed"].num_rows > 0
    assert same_rows(t["resumed"], j["resumed"])
    assert same_rows(t["warm"], j["warm"])


def test_cancel_queued_query_via_session(tmp_path):
    def scenario(P, d):
        facts, _dims = _serving_lake(d)
        sess = _session(P, d, **{
            "spark.hyperspace.serve.hbm.budget.bytes": 2 * MIB,
            "spark.hyperspace.serve.queue.depth": 4})
        df = sess.read_parquet(facts).select("k")
        df.collect()
        sch = P.sched.get_scheduler()
        holder = P.hold(sch, 2 * MIB)
        outcome = {}

        def worker():
            try:
                df.collect()
                outcome["result"] = "finished"
            except P.exc.QueryCancelledError as exc:
                outcome["result"] = exc

        t = threading.Thread(target=worker)
        try:
            t.start()
            target = None
            for _ in range(400):
                live = [q for q in sess.active_queries() if q != "blocker"]
                if live:
                    target = live[0]
                    break
                time.sleep(0.005)
            assert target is not None, "query never registered"
            first = sess.cancel(target)
            t.join(10)
            alive = t.is_alive()
            exc = outcome["result"]
            second = sess.cancel(target)
        finally:
            sch._release(holder)
        return first, alive, typed(exc), exc.phase, second

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == (
        True, False, "QueryCancelledError", "queue", False)


# ---------------------------------------------------------------------------
# Deadline mid-execution + telemetry isolation
# ---------------------------------------------------------------------------


def test_deadline_mid_query_is_typed_and_flight_recorded(tmp_path):
    def scenario(P, d):
        facts, dims = _serving_lake(d)
        sess = _session(P, d)
        df = _join_query(P, sess, facts, dims)
        result = df.collect()
        before = P.counter("serve.deadline_exceeded")
        with pytest.raises(P.exc.QueryDeadlineExceededError) as ei:
            df.collect(timeout=0.002)
        exc = ei.value
        ring = P.telemetry.get_recorder().queries(5)
        dumped = [m for m in ring
                  if getattr(m, "query_id", None) == exc.query_id]
        assert dumped, "cancelled query missing from the flight ring"
        ev = dumped[-1].events_of("serve", "deadline_exceeded")
        return {"result": result, "cls": typed(exc), "phase": exc.phase,
                "delta": P.counter("serve.deadline_exceeded") - before,
                "interrupted": P.counter(
                    f"serve.interrupted.{exc.phase}") >= 1,
                "event_phase": ev[-1]["phase"] if ev else None,
                "ring_count": dumped[-1].counters.get(
                    f"serve.interrupted.{exc.phase}")}

    got = both(scenario, tmp_path)
    j, t = got["jax"], got["torch"]
    assert same_rows(t["result"], j["result"])
    for r in (j, t):
        assert r["cls"] == "QueryDeadlineExceededError"
        assert r["phase"] in PHASES
        assert r["delta"] == 1 and r["interrupted"]
        assert r["event_phase"] == r["phase"] and r["ring_count"] == 1


def _live_tensors() -> int:
    """Live torch tensors (the port's counterpart of the JAX suite's
    `jax.live_arrays()` leak sentinel)."""
    import gc
    import warnings

    import torch
    gc.collect()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return sum(1 for o in gc.get_objects()
                   if isinstance(o, torch.Tensor))


def test_concurrent_deadline_and_survivor_isolation(tmp_path, leak_sentinel):
    def scenario(P, d):
        facts, dims = _serving_lake(d)
        sess = _session(P, d)
        victim_df = _join_query(P, sess, facts, dims)
        survivor_df = sess.read_parquet(facts) \
            .filter(P.col("v") > P.lit(0.5)).select("k", "v")
        victim_df.collect()
        expected = canonical(survivor_df.collect())
        results = {}

        def victim():
            try:
                victim_df.collect(timeout=0.002)
                results["victim"] = "finished"
            except P.exc.QueryDeadlineExceededError as exc:
                results["victim"] = exc

        def survivor():
            results["survivor"] = survivor_df.collect(with_metrics=True)

        def laps():
            for _ in range(3):
                t1 = threading.Thread(target=victim)
                t2 = threading.Thread(target=survivor)
                t1.start()
                t2.start()
                t1.join(30)
                t2.join(30)
                assert not t1.is_alive() and not t2.is_alive()

        if P is JAX:
            with leak_sentinel(tolerance=8):
                laps()
        else:
            before = _live_tensors()
            laps()
            assert _live_tensors() - before <= 8, "tensor leak"
        exc = results["victim"]
        table, m = results["survivor"]
        admitted = m.events_of("serve", "admitted")
        return {"victim": typed(exc) if isinstance(exc, Exception)
                else exc,
                "survivor": table, "expected": expected,
                "own_id": m.query_id != getattr(exc, "query_id", None),
                "clean": not any(k.startswith("serve.interrupted")
                                 for k in m.counters),
                "admitted": [a["query_id"] == m.query_id
                             for a in admitted],
                "no_deadline_ev": not m.events_of("serve",
                                                  "deadline_exceeded")}

    got = both(scenario, tmp_path)
    j, t = got["jax"], got["torch"]
    assert t["victim"] == j["victim"] == "QueryDeadlineExceededError"
    assert same_rows(t["survivor"], t["expected"])
    assert same_rows(t["survivor"], j["survivor"])
    for r in (j, t):
        assert r["own_id"] and r["clean"] and r["no_deadline_ev"]
        assert r["admitted"] == [True]


# ---------------------------------------------------------------------------
# Degradation circuit breaker
# ---------------------------------------------------------------------------


def _indexed_env(P, d, **conf_extra):
    rng = np.random.default_rng(5)
    src = d / "src"
    src.mkdir()
    pq.write_table(pa.table({
        "k": rng.integers(0, 40, 4000).astype(np.int64),
        "x": rng.random(4000).astype(np.float64),
    }), str(src / "part-0.parquet"))
    conf = {"hyperspace.warehouse.dir": str(d / "wh"),
            "hyperspace.index.num.buckets": "4"}
    conf.update(conf_extra)
    sess = P.session(conf)
    hs = P.Hyperspace(sess)
    df = sess.read_parquet(str(src))
    hs.create_index(df, P.IndexConfig("idx", ["k"], ["x"]))
    sess.enable_hyperspace()
    query = lambda: df.filter(P.col("k") == P.lit(7)).select("x")  # noqa
    idx_data = str(d / "wh" / "indexes" / "idx" / "v__=0")
    return sess, query, idx_data


BREAKER_SERIES = ("resilience.fallbacks", "resilience.breaker.opened",
                  "resilience.breaker.half_open",
                  "resilience.breaker.closed",
                  "resilience.breaker.short_circuits")


def test_breaker_opens_short_circuits_probes_and_closes(tmp_path):
    def scenario(P, d):
        sess, query, idx_data = _indexed_env(P, d, **{
            "spark.hyperspace.serve.breaker.failures": 2,
            "spark.hyperspace.serve.breaker.window.seconds": 60,
            "spark.hyperspace.serve.breaker.cooldown.seconds": 0.05})
        want = query().collect()
        backup = str(d / "backup_v0")
        shutil.copytree(idx_data, backup)
        shutil.rmtree(idx_data)
        c0 = P.counters(*BREAKER_SERIES)
        steps, tables = [], [want]

        def delta():
            c = P.counters(*BREAKER_SERIES)
            return tuple(c[k] - c0[k] for k in BREAKER_SERIES)

        for _ in range(2):
            tables.append(query().collect())
        steps.append(delta())
        table, m = query().collect(with_metrics=True)
        tables.append(table)
        degraded = m.events_of("resilience", "degraded")
        steps.append((m.counters.get("resilience.breaker.short_circuits"),
                      degraded[-1]["reason"] if degraded else None))
        steps.append(delta())
        time.sleep(0.06)
        tables.append(query().collect())
        steps.append(delta())
        shutil.copytree(backup, idx_data)
        time.sleep(0.06)
        table, m = query().collect(with_metrics=True)
        tables.append(table)
        steps.append(delta())
        steps.append((m.counters.get("resilience.fallbacks"),
                      bool(m.index_usage())))
        return steps, tables

    got = both(scenario, tmp_path)
    (jsteps, jtables), (tsteps, ttables) = got["jax"], got["torch"]
    assert tsteps == jsteps
    assert tsteps[0][:2] == (2, 1)             # two fallbacks, one open
    assert tsteps[1] == (1, "breaker open")    # short circuit
    assert tsteps[-1] == (None, True)          # closed, index serves
    for a, b in zip(ttables, jtables):
        assert same_rows(a, b)
    for a in ttables[1:]:
        assert same_rows(a, ttables[0])


# ---------------------------------------------------------------------------
# Transfer engine: acquire timeout, reservation release, chunk deadline
# ---------------------------------------------------------------------------


class _NeverReady:
    """A device array whose transfer never completes."""

    nbytes = 128

    def is_ready(self):
        return False


def test_transfer_acquire_timeout_is_typed_and_transient(tmp_path):
    def scenario(P, d):
        eng = P.transfer.TransferEngine(
            chunk_bytes=64, inflight_bytes=128,
            put_fn=lambda a, dev: np.asarray(a), acquire_timeout_s=0.05)
        dead = P.transfer._WindowEntry(_NeverReady(), 128, None)
        with eng._lock:
            eng._window.append(dead)
            eng._window_bytes = 128
        before = P.counter("io.transfer.acquire_timeouts")
        t0 = time.perf_counter()
        with pytest.raises(P.transfer.TransferAcquireTimeoutError) as ei:
            eng.put(np.zeros(64, dtype=np.uint8))
        return (time.perf_counter() - t0 < 5.0,
                P.counter("io.transfer.acquire_timeouts") - before,
                P.retry.is_transient(ei.value),
                eng._window_bytes, len(eng._window))

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == (True, 1, True, 128, 1)


def test_failed_put_releases_window_reservation(tmp_path):
    def scenario(P, d):
        def dying_put(arr, device):
            raise RuntimeError("link died mid-put")

        eng = P.transfer.TransferEngine(chunk_bytes=1024,
                                        inflight_bytes=4096,
                                        put_fn=dying_put,
                                        acquire_timeout_s=0.2)
        with pytest.raises(RuntimeError) as ei:
            eng.put(np.zeros(256, dtype=np.uint8))
        return str(ei.value), eng._window_bytes, len(eng._window)

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == ("link died mid-put", 0, 0)


def test_transfer_chunk_loop_honors_deadline(tmp_path):
    def scenario(P, d):
        eng = P.transfer.TransferEngine(
            chunk_bytes=1024, inflight_bytes=1 << 20,
            put_fn=lambda a, dev: np.asarray(a))
        dl = P.sched.Deadline("q-t")
        dl.cancel()
        with P.telemetry.deadline_scope(dl):
            with pytest.raises(P.exc.QueryCancelledError) as ei:
                eng.put(np.zeros(1 << 16, dtype=np.uint8))
        return typed(ei.value), ei.value.phase, eng._window_bytes

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == ("QueryCancelledError",
                                          "transfer", 0)


# ---------------------------------------------------------------------------
# Footprint estimation
# ---------------------------------------------------------------------------


def test_projected_footprint_scales_with_scan_bytes(tmp_path):
    def scenario(P, d):
        big = d / "big"
        big.mkdir()
        n = 400_000
        pq.write_table(pa.table({
            "a": np.arange(n, dtype=np.int64),
            "b": np.random.default_rng(0).random(n),
        }), str(big / "part-0.parquet"))
        sess = _session(P, d)
        df = sess.read_parquet(str(big))
        size = os.path.getsize(str(big / "part-0.parquet"))
        est = P.footprint.projected_bytes(df.plan)
        est_join = P.footprint.projected_bytes(df.join(df, on="a").plan)
        return (est >= size, est >= P.footprint.MIN_FOOTPRINT_BYTES,
                est_join >= 2 * size, est, est_join,
                P.footprint.scan_disk_bytes(df.plan) == size)

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"]
    assert got["torch"][:3] == (True, True, True) and got["torch"][5]


def test_source_footprint_restats_after_its_window(tmp_path, monkeypatch):
    """The port re-stats an unpinned scan's files at most every
    `SCAN_BYTES_REVALIDATE_S`: a file rewritten in place reaches the
    projection once the window has passed or its root was invalidated,
    and not before."""
    fp = TORCH.footprint
    src = tmp_path / "src"
    src.mkdir()
    path = str(src / "part-0.parquet")

    def write(n):
        pq.write_table(pa.table({"a": np.arange(n, dtype=np.int64)}), path)
        return os.path.getsize(path)

    first = write(100)
    df = _session(TORCH, tmp_path).read_parquet(str(src))
    monkeypatch.setattr(fp, "SCAN_BYTES_REVALIDATE_S", 3600.0)
    assert fp.scan_disk_bytes(df.plan) == first
    time.sleep(0.01)
    second = write(50_000)
    assert second != first
    assert fp.scan_disk_bytes(df.plan) == first  # inside the window
    fp.invalidate_sizes(str(src))
    assert fp.scan_disk_bytes(df.plan) == second  # swept
    time.sleep(0.01)
    third = write(10)
    assert fp.scan_disk_bytes(df.plan) == second
    monkeypatch.setattr(fp, "SCAN_BYTES_REVALIDATE_S", 0.0)
    assert fp.scan_disk_bytes(df.plan) == third  # the window passed
    assert fp.projected_bytes(df.plan) >= fp.MIN_FOOTPRINT_BYTES


def test_projected_footprint_degrades_never_raises(tmp_path):
    def scenario(P, d):
        schema = P.schema.Schema([P.schema.Field("a", "int64")])
        ghost = P.nodes.Scan(["/nonexistent/path/xyz"], schema)
        est = P.footprint.projected_bytes(ghost)
        return est, est >= P.footprint.MIN_FOOTPRINT_BYTES

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"]
    assert got["torch"][1]


# ---------------------------------------------------------------------------
# Session lifecycle
# ---------------------------------------------------------------------------


def test_session_close_is_idempotent_and_refuses_new_queries(tmp_path):
    def scenario(P, d):
        facts, _dims = _serving_lake(d)
        sess = _session(P, d)
        df = sess.read_parquet(facts).select("k")
        rows = df.collect().num_rows
        sess.close()
        sess.close()
        with pytest.raises(P.exc.HyperspaceException) as ei:
            df.collect()
        return rows, typed(ei.value), str(ei.value)

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == 50_000


# ---------------------------------------------------------------------------
# The chaos run: 8 clients x 240 mixed queries, faults on
# ---------------------------------------------------------------------------


def test_chaos_concurrent_serving_with_faults(tmp_path):
    def scenario(P, d):
        facts_dir, dims_dir = _serving_lake(d)
        budget = 64 * MIB
        sess = _session(P, d, **{
            "spark.hyperspace.serve.hbm.budget.bytes": budget,
            "spark.hyperspace.serve.queue.depth": 16,
            "spark.hyperspace.io.retry.base.ms": 1,
            "spark.hyperspace.io.retry.max.ms": 5})
        facts = sess.read_parquet(facts_dir)
        dims = sess.read_parquet(dims_dir)
        col, lit = P.col, P.lit
        workload = [
            ("filter", facts.filter(col("v") > lit(0.9)).select("k", "v")),
            ("agg", facts.group_by("g").agg(("sum", "v", "total"),
                                            cnt=("count", "*"))),
            ("join", facts.join(dims, on="k").filter(col("w") > lit(0.5))
             .group_by("g").agg(("avg", "v", "avg_v"))),
            ("topn", facts.sort("-v").limit(20).select("k", "v")),
            ("distinct", facts.select("g").distinct()),
        ]
        expected = {name: canonical(df.collect()) for name, df in workload}
        c0 = P.counters("serve.rejected", "serve.deadline_exceeded",
                        "serve.cancelled")
        P.arm(P.rule("parquet.read:*", kind="transient", nth=1, times=-1,
                     probability=0.05),
              P.rule("fusion.stage", kind="transient", nth=1, times=-1,
                     probability=0.02),
              P.rule("scheduler.admit", kind="transient", nth=1, times=-1,
                     probability=0.01),
              seed=1234)
        try:
            report = P.run_chaos(
                workload, expected, clients=8, total_queries=240,
                timeout_for=lambda i: 0.0015 if i % 9 == 0 else None,
                join_timeout_s=300.0)
        finally:
            P.faults.uninstall()
        c1 = P.counters("serve.rejected", "serve.deadline_exceeded",
                        "serve.cancelled")
        sch = P.sched.get_scheduler()
        return {"report": report, "expected": expected,
                "deltas": {k: c1[k] - c0[k] for k in c0},
                "peak": sch.peak_admitted_bytes,
                "admitted": sch.admitted_bytes(), "budget": budget}

    got = both(scenario, tmp_path)
    for name in got["jax"]["expected"]:
        assert same_rows(got["torch"]["expected"][name],
                         got["jax"]["expected"][name]), name
    for P in PKGS:
        r = got[P.name]
        report = r["report"]
        assert not report.stuck_threads, report.summary()
        assert report.total == 240
        assert report.outcomes["error"] == 0, report.errors[:5]
        assert not report.mismatches, report.mismatches[:5]
        assert report.outcomes["ok"] >= 120, report.summary()
        assert report.outcomes["deadline"] >= 1, report.summary()
        assert all(p in PHASES for p in report.typed_phases)
        assert r["peak"] <= r["budget"] and r["admitted"] == 0
        peak_hbm = max((m.peak_hbm_bytes for m in report.success_metrics),
                       default=0)
        assert peak_hbm <= r["budget"]
        assert r["deltas"]["serve.rejected"] == report.outcomes["rejected"]
        assert r["deltas"]["serve.deadline_exceeded"] \
            == report.outcomes["deadline"]
        assert r["deltas"]["serve.cancelled"] \
            == report.outcomes["cancelled"]
        ids = [m.query_id for m in report.success_metrics]
        assert len(ids) == len(set(ids))
        for m in report.success_metrics:
            admitted = m.events_of("serve", "admitted")
            assert len(admitted) == 1
            assert admitted[0]["query_id"] == m.query_id
            assert not any(k.startswith("serve.interrupted")
                           for k in m.counters)
            assert m.wall_s is not None and m.operators
    # The same typed outcome classes on both sides.
    assert {k for k, v in got["torch"]["report"].outcomes.items() if v} \
        <= {"ok", "rejected", "deadline", "cancelled", "injected"}


def test_scheduler_error_table_is_the_jax_packages():
    assert TORCH.sched.SERVING_ERROR_COUNTERS \
        == JAX.sched.SERVING_ERROR_COUNTERS
    for name, counter in TORCH.sched.SERVING_ERROR_COUNTERS.items():
        assert getattr(TORCH.exc, name).counter == counter
