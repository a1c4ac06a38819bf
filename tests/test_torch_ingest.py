"""The port's continuous-ingest plane (`engine/ingest.py`, the facade's
`ingest`) against the JAX package's: every scenario of
`tests/test_ingest.py` — the delta-sketch append path and its unit
semantics, the Z-order decline, the coordinator tick (appends, both
index kinds refreshed through the lease path, staleness drained), the
staleness gauge, the serve-pressure gate, producer failure, conflict
concession, the crash-point matrix of both incremental refresh actions
under concurrent serving, the segment-cache warm set under append,
vacuum behind a pin, the typed fallback after a lost version, and the
`ingest_staleness` default rule — through both packages on the same
seeded lake.
"""

import os
import shutil
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
    for P in PKGS:
        P.sketch.clear_sketch_cache()
    with jax_counters_restored():
        yield
    reset_lanes()
    for P in PKGS:
        P.sketch.clear_sketch_cache()


def _write_facts(directory, name, lo, n=80, g=None):
    k = np.arange(lo, lo + n, dtype=np.int64)
    gv = (k % 4) if g is None else np.full(n, g, dtype=np.int64)
    path = os.path.join(directory, name)
    pq.write_table(pa.table({"k": k, "g": gv,
                             "v": np.linspace(0.0, 1.0, n)}), path)
    return path


def _session(P, d, **extra):
    conf = {"hyperspace.warehouse.dir": str(d / "wh"),
            "spark.hyperspace.index.num.buckets": "4",
            "spark.hyperspace.index.hybridscan.enabled": "true",
            "spark.hyperspace.io.retry.base.ms": "1",
            "spark.hyperspace.io.retry.max.ms": "4"}
    conf.update(extra)
    return P.session(conf)


def _env(P, d, **extra):
    facts = d / "facts"
    facts.mkdir()
    for i in range(4):
        _write_facts(str(facts), f"f{i}.parquet", i * 80)
    sess = _session(P, d, **extra)
    return sess, P.Hyperspace(sess), str(facts)


def _managers(P, sess, name):
    mgr = P.Hyperspace.get_context(sess).index_collection_manager
    return mgr._managers(name)


def _latest_version_dir(P, sess, name):
    _, dm = _managers(P, sess, name)
    return dm.get_path(dm.get_latest_version_id())


def _rel(path, facts):
    return os.path.relpath(path, facts)


# -- delta-sketch append path ------------------------------------------------


def test_incremental_refresh_dispatches_sketch_append(tmp_path):
    def scenario(P, d):
        sess, hs, facts = _env(P, d)
        hs.create_index(sess.read_parquet(facts),
                        P.DataSkippingIndexConfig("sk", ["k"]))
        before = dict(P.sketch.load_sketches(
            _latest_version_dir(P, sess, "sk")).files)
        _write_facts(facts, "a0.parquet", 10_000)
        hs.refresh_index("sk", mode="incremental")
        after = dict(P.sketch.load_sketches(
            _latest_version_dir(P, sess, "sk")).files)
        carried = all(
            (after[p].size, after[p].stamp, after[p].rows)
            == (prev.size, prev.stamp, prev.rows)
            and all((after[p].columns[c].min, after[p].columns[c].max,
                     after[p].columns[c].ok)
                    == (pc.min, pc.max, pc.ok)
                    for c, pc in prev.columns.items())
            for p, prev in before.items())
        appended = sorted(_rel(p, facts) for p in after if p not in before)
        return len(before), len(after), carried, appended, sorted(
            (_rel(p, facts), s.rows, s.columns["k"].min, s.columns["k"].max)
            for p, s in after.items())

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"]
    assert got["torch"][:4] == (4, 5, True, ["a0.parquet"])


def test_sketch_append_unit_carry_resketch_drop(tmp_path):
    def scenario(P, d):
        sess, hs, facts = _env(P, d)
        df = sess.read_parquet(facts)
        hs.create_index(df, P.DataSkippingIndexConfig("sk", ["k"]))
        v0 = _latest_version_dir(P, sess, "sk")
        files = sorted(os.path.join(facts, f) for f in os.listdir(facts))
        out = []
        new = _write_facts(facts, "a0.parquet", 20_000)
        merged, detail = P.sketch.append_file_sketches(
            v0, files + [new], ["k"], df.schema, sess.conf)
        out.append((detail["files_carried"], detail["files_sketched"],
                    detail["files_dropped"], len(merged)))
        _write_facts(facts, "f0.parquet", 30_000)
        merged, detail = P.sketch.append_file_sketches(
            v0, files, ["k"], df.schema, sess.conf)
        out.append((detail["files_carried"], detail["files_sketched"],
                    detail["files_dropped"], len(merged)))
        merged, detail = P.sketch.append_file_sketches(
            v0, files[:2], ["k"], df.schema, sess.conf)
        out.append((detail["files_dropped"], len(merged)))
        return out

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"]
    assert got["torch"] == [(4, 1, 0, 5), (3, 1, 0, 4), (2, 2)]


def test_zorder_skipping_declines_incremental(tmp_path):
    def scenario(P, d):
        sess, hs, facts = _env(P, d)
        hs.create_index(sess.read_parquet(facts),
                        P.DataSkippingIndexConfig("zk", ["k"],
                                                  zorder_by=["k"]))
        _write_facts(facts, "a0.parquet", 10_000)
        with pytest.raises(P.exc.HyperspaceException,
                           match="mode='full'") as ei:
            hs.refresh_index("zk", mode="incremental")
        return typed(ei.value), str(ei.value)

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"]


# -- coordinator tick ----------------------------------------------------------


def test_tick_appends_refreshes_both_kinds_and_staleness_drains(tmp_path):
    def scenario(P, d):
        sess, hs, facts = _env(P, d)
        hs.create_index(sess.read_parquet(facts),
                        P.IndexConfig("cov", ["g"], ["k", "v"]))
        hs.create_index(sess.read_parquet(facts),
                        P.DataSkippingIndexConfig("sk", ["k"]))
        appended = []

        def producer():
            appended.append(_write_facts(
                facts, f"a{len(appended)}.parquet",
                10_000 + 100 * len(appended)))
            return appended[-1:]

        coord = hs.ingest(producer=producer, indexes=["cov", "sk"])
        names = ("ingest.ticks", "ingest.appends", "ingest.refreshes",
                 "ingest.failures")
        t0 = P.counters(*names)
        decision = coord.run_once()
        t1 = P.counters(*names)
        blob = set(P.sketch.load_sketches(
            _latest_version_dir(P, sess, "sk")).files)
        got = sess.read_parquet(facts).filter(
            P.col("k") >= P.lit(10_000)).collect()
        return (decision["action"], decision["appended"],
                [r["action"] for r in decision["refreshes"]],
                {n: t1[n] - t0[n] for n in names}, coord.staleness_s(),
                P.gauge("ingest.staleness.seconds"),
                appended[0] in blob, got)

    got = both(scenario, tmp_path)
    j, t = got["jax"], got["torch"]
    assert t[:7] == j[:7]
    assert t[:7] == ("refreshed", 1, ["refreshed", "refreshed"],
                     {"ingest.ticks": 1, "ingest.appends": 1,
                      "ingest.refreshes": 2, "ingest.failures": 0},
                     0.0, 0.0, True)
    assert t[7].num_rows == 80 and same_rows(t[7], j[7])


def test_staleness_tracks_uncovered_appends(tmp_path):
    def scenario(P, d):
        sess, hs, facts = _env(P, d)
        hs.create_index(sess.read_parquet(facts),
                        P.IndexConfig("cov", ["g"], ["k", "v"]))
        coord = hs.ingest(indexes=["cov"])
        path = _write_facts(facts, "a0.parquet", 10_000)
        coord.record_append([path], at=time.time() - 7.0)
        stale = coord.staleness_s()
        gauge = P.gauge("ingest.staleness.seconds")
        decision = coord.run_once()
        return (6.5 <= stale <= 30.0, gauge >= 6.5,
                decision["refreshes"][0]["action"], coord.staleness_s(),
                P.gauge("ingest.staleness.seconds"))

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == (True, True, "refreshed", 0.0, 0.0)


def test_serve_pressure_defers_refresh_not_appends(tmp_path):
    def scenario(P, d):
        sess, hs, facts = _env(P, d)
        hs.create_index(sess.read_parquet(facts),
                        P.IndexConfig("cov", ["g"], ["k", "v"]))

        class _Pressured:
            def pressure(self):
                return {"queue_depth": 3, "admitted_bytes": 0}

        coord = hs.ingest(
            producer=lambda: [_write_facts(facts, "a0.parquet", 10_000)],
            indexes=["cov"])
        c0 = P.counters("ingest.deferred", "ingest.refreshes")
        prev = P.sched.get_scheduler()
        P.sched.set_scheduler(_Pressured())
        try:
            decision = coord.run_once()
        finally:
            P.sched.set_scheduler(prev)
        c1 = P.counters("ingest.deferred", "ingest.refreshes")
        stale = coord.staleness_s() > 0.0
        nxt = coord.run_once()["refreshes"][0]["action"]
        return (decision["action"], decision["reason"],
                decision["appended"], {k: c1[k] - c0[k] for k in c0},
                stale, nxt, coord.staleness_s())

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == "deferred"
    assert "3 queries waiting" in got["torch"][1]


def test_producer_failure_is_contained(tmp_path):
    def scenario(P, d):
        sess, hs, facts = _env(P, d)
        hs.create_index(sess.read_parquet(facts),
                        P.IndexConfig("cov", ["g"], ["k", "v"]))

        def bad_producer():
            raise OSError("source landing zone unreachable")

        coord = hs.ingest(producer=bad_producer, indexes=["cov"])
        c0 = P.counters("ingest.failures", "ingest.refreshes")
        decision = coord.run_once()
        c1 = P.counters("ingest.failures", "ingest.refreshes")
        return (decision["action"], "landing zone" in decision["reason"],
                {k: c1[k] - c0[k] for k in c0})

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == (
        "failed", True, {"ingest.failures": 1, "ingest.refreshes": 0})


# -- conflict concession ---------------------------------------------------------


def test_conflict_concession_exactly_one_winner(tmp_path):
    def scenario(P, d):
        sess, hs, facts = _env(P, d)
        hs.create_index(sess.read_parquet(facts),
                        P.IndexConfig("cov", ["g"], ["k", "v"]))
        lm, _ = _managers(P, sess, "cov")
        base = lm.get_latest_log()
        rival = P.log_entry.IndexLogEntry.from_dict(base.to_dict())
        rival.state = P.States.REFRESHING
        assert lm.write_log(base.id + 1, rival)
        coord = hs.ingest(indexes=["cov"])
        c0 = P.counters("ingest.conflicts", "ingest.failures", "io.retries")
        decision = coord.run_once()
        c1 = P.counters("ingest.conflicts", "ingest.failures", "io.retries")
        winner = P.log_entry.IndexLogEntry.from_dict(base.to_dict())
        winner.state = P.States.ACTIVE
        assert lm.write_log(base.id + 2, winner)
        nxt = coord.run_once()["refreshes"][0]["action"]
        return (decision["refreshes"][0]["action"],
                c1["ingest.conflicts"] - c0["ingest.conflicts"],
                c1["ingest.failures"] - c0["ingest.failures"],
                c1["io.retries"] > c0["io.retries"], nxt,
                lm.get_latest_log().state)

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == (
        "conceded", 1, 0, True, "refreshed", "ACTIVE")


# -- crash-point matrix under concurrent serving ---------------------------------


@pytest.mark.parametrize("kind,phase", [
    ("covering", "begin"), ("covering", "op"), ("covering", "end"),
    ("skipping", "begin"), ("skipping", "op"), ("skipping", "end"),
])
def test_crash_matrix_refresh_recovers_next_tick(tmp_path, kind, phase):
    def scenario(P, d):
        facts = d / "facts"
        facts.mkdir()
        for i in range(4):
            _write_facts(str(facts), f"f{i}.parquet", i * 80)
        sess = _session(P, d, **{
            "spark.hyperspace.maintenance.lease.seconds": "0"})
        hs = P.Hyperspace(sess)
        if kind == "covering":
            hs.create_index(sess.read_parquet(str(facts)),
                            P.IndexConfig("cov", ["g"], ["k", "v"]))
            action, name = "RefreshIncrementalAction", "cov"
        else:
            hs.create_index(sess.read_parquet(str(facts)),
                            P.DataSkippingIndexConfig("sk", ["k"]))
            action, name = "RefreshSkippingAppendAction", "sk"
        _write_facts(str(facts), "a0.parquet", 10_000)
        coord = hs.ingest(indexes=[name])
        inj = P.arm(P.rule(f"action.{action}.{phase}", kind="crash",
                           times=1))
        with pytest.raises(P.faults.InjectedCrash):
            coord.run_once()
        fired = inj.fired("action.*")
        lm, _ = _managers(P, sess, name)
        torn_state = lm.get_latest_log().state
        sess.enable_hyperspace()
        try:
            workload, expected = [], {}
            for g in range(4):
                df = sess.read_parquet(str(facts)).filter(
                    P.col("g") == P.lit(g)).select("k", "g", "v")
                workload.append((f"g{g}", df))
                expected[f"g{g}"] = canonical(df.collect())
            report = P.run_chaos(workload, expected, clients=4,
                                 total_queries=16)
        finally:
            sess.disable_hyperspace()
        P.faults.uninstall()
        rec0 = P.counter("resilience.recoveries")
        decision = coord.run_once()
        got = sess.read_parquet(str(facts)).filter(
            P.col("k") >= P.lit(10_000)).collect()
        return {"fired": fired, "torn": torn_state,
                "chaos": (report.mismatches, report.stuck_threads,
                          report.outcomes["error"]),
                "expected": expected,
                "next": decision["refreshes"][0]["action"],
                "recovered": P.counter("resilience.recoveries") - rec0 >= 1,
                "final": lm.get_latest_log().state,
                "stale": coord.staleness_s(), "rows": got}

    got = both(scenario, tmp_path)
    j, t = got["jax"], got["torch"]
    for key in ("fired", "torn", "chaos", "next", "recovered", "final",
                "stale"):
        assert t[key] == j[key], key
    assert t["fired"] == 1 and t["chaos"] == ([], [], 0)
    assert (t["torn"] == "ACTIVE") == (phase == "begin")
    assert t["next"] == "refreshed" and t["final"] == "ACTIVE"
    if phase != "begin":
        assert t["recovered"]
    assert t["rows"].num_rows == 80 and same_rows(t["rows"], j["rows"])
    for g, table in t["expected"].items():
        assert same_rows(table, j["expected"][g])


# -- segment-cache warm set under sustained append -------------------------------


def test_warm_hit_rate_held_under_append(tmp_path):
    def scenario(P, d):
        facts = d / "facts"
        facts.mkdir()
        for i in range(4):
            _write_facts(str(facts), f"f{i}.parquet", i * 80)
        sess = _session(P, d, **{
            "spark.hyperspace.execution.min.device.rows": "0",
            "spark.hyperspace.distribution.enabled": "false"})
        hs = P.Hyperspace(sess)
        hs.create_index(sess.read_parquet(str(facts)),
                        P.IndexConfig("cov", ["g"], ["k", "v"]))

        def run_lap():
            return {g: canonical(sess.read_parquet(str(facts))
                                 .filter(P.col("g") == P.lit(g))
                                 .select("k", "g", "v").collect())
                    for g in range(4)}

        sess.enable_hyperspace()
        try:
            before = run_lap()
            run_lap()
            coord = hs.ingest(
                producer=lambda: [_write_facts(str(facts), "a0.parquet",
                                               10_000, g=7)],
                indexes=["cov"])
            rekeyed0 = P.counter("cache.segments.rekeyed")
            action = coord.run_once()["action"]
            rekeyed = P.counter("cache.segments.rekeyed") > rekeyed0
            h0 = P.counter("cache.segments.hits")
            m0 = P.counter("cache.segments.misses")
            after = run_lap()
            hits = P.counter("cache.segments.hits") - h0
            misses = P.counter("cache.segments.misses") - m0
        finally:
            sess.disable_hyperspace()
        assert all(after[g].equals(before[g]) for g in range(4))
        return action, rekeyed, hits + misses > 0, \
            hits / max(hits + misses, 1) >= 0.5, after

    got = both(scenario, tmp_path)
    assert got["torch"][:4] == got["jax"][:4] == ("refreshed", True, True,
                                                  True)
    for g in range(4):
        assert same_rows(got["torch"][4][g], got["jax"][4][g])


# -- vacuum vs pinned reads --------------------------------------------------------


def test_vacuum_defers_behind_pin_then_collects(tmp_path):
    def scenario(P, d):
        sess, hs, facts = _env(P, d)
        hs.create_index(sess.read_parquet(facts),
                        P.IndexConfig("cov", ["g"], ["k", "v"]))
        hs.create_index(sess.read_parquet(facts),
                        P.IndexConfig("cov2", ["g"], ["k"]))
        vdir = _latest_version_dir(P, sess, "cov")
        hs.delete_index("cov")
        d0 = P.counter("resilience.vacuum.deferred")
        with P.pins.pinned([vdir]):
            hs.vacuum_index("cov")
            kept = os.path.isdir(vdir)
        out = [kept, P.counter("resilience.vacuum.deferred") - d0,
               P.pins.is_pinned(vdir), os.path.isdir(vdir)]
        vdir2 = _latest_version_dir(P, sess, "cov2")
        hs.delete_index("cov2")
        hs.vacuum_index("cov2")
        out += [os.path.isdir(vdir2),
                P.counter("resilience.vacuum.deferred") - d0]
        return out

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == [True, 1, False, True, False, 1]


def test_lost_version_surfaces_typed_fallback_not_file_error(tmp_path):
    def scenario(P, d):
        sess, hs, facts = _env(P, d)
        hs.create_index(sess.read_parquet(facts),
                        P.IndexConfig("cov", ["g"], ["k", "v"]))
        query = lambda: sess.read_parquet(facts).filter(  # noqa: E731
            P.col("g") == P.lit(2)).select("k", "g", "v")
        truth = query().collect()
        shutil.rmtree(_latest_version_dir(P, sess, "cov"))
        f0 = P.counter("resilience.fallbacks")
        sess.enable_hyperspace()
        try:
            got = query().collect()
        finally:
            sess.disable_hyperspace()
        assert same_rows(got, truth)
        return got, P.counter("resilience.fallbacks") - f0

    got = both(scenario, tmp_path)
    assert got["torch"][1] == got["jax"][1] == 1
    assert same_rows(got["torch"][0], got["jax"][0])


# -- staleness alert rule ------------------------------------------------------------


def test_ingest_staleness_default_rule_fires_and_resolves(tmp_path):
    def scenario(P, d):
        rule = next(r for r in P.alerts.DEFAULT_RULES
                    if r.name == "ingest_staleness")
        g = P.telemetry.get_registry().gauge("ingest.staleness.seconds")
        m = P.alerts.AlertManager(rules=[rule])
        out = [rule.to_dict()]
        try:
            g.set(45.0)
            out.append(m.evaluate(now=100.0))
            fired = m.evaluate(now=105.1)
            out.append([(f["rule"], f["state"]) for f in fired])
            g.set(20.0)
            out.append(m.evaluate(now=106.0))
            out.append(m.active_count())
            g.set(0.0)
            resolved = m.evaluate(now=107.0)
            out.append([(f["rule"], f["state"]) for f in resolved])
            out.append(m.active_count())
        finally:
            g.set(0.0)
        return out

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"]
    assert got["torch"][1:] == [[], [("ingest_staleness", "firing")], [],
                                1, [("ingest_staleness", "resolved")], 0]
    assert JAX is not TORCH


# -- the catalog cache under a concurrent refresh (a port fault) -------------------


def test_catalog_cache_never_keeps_a_mid_refresh_listing(tmp_path,
                                                         monkeypatch):
    """A query planning while a refresh is mid-flight lists the index in
    its transient state; if that listing lands in the catalog cache
    after the refresh committed, the rules skip the refreshed index
    until the cache expires. The port's caching manager drops a listing
    that a clear overtook, and clears after every mutation too. (The
    JAX package clears before mutations only; its tests never race a
    listing against a commit.)"""
    sess, hs, facts = _env(TORCH, tmp_path)
    hs.create_index(sess.read_parquet(facts),
                    TORCH.IndexConfig("cov", ["g"], ["k", "v"]))
    mgr = TORCH.Hyperspace.get_context(sess).index_collection_manager
    base = type(mgr).__mro__[1]
    real = base.get_indexes

    def overtaken(self, states=None):
        listing = real(self, states)
        mgr.clear_cache()  # a refresh committed while we listed
        return listing

    monkeypatch.setattr(base, "get_indexes", overtaken)
    mgr.get_indexes()
    assert mgr._cache.get() is None
    monkeypatch.setattr(base, "get_indexes", real)
    entries = mgr.get_indexes()
    assert mgr._cache.get() is entries
    _write_facts(facts, "a0.parquet", 10_000)
    hs.refresh_index("cov", mode="incremental")
    assert mgr._cache.get() is None
    assert [e.state for e in mgr.get_indexes()] == ["ACTIVE"]
