"""The self-driving index advisor through both packages, on the CPU.

Every case of `tests/test_advisor.py` runs through `hyperspace_tpu` and
`hyperspace_tpu_torch` over ONE shared seeded source lake (its 6,000-row
facts and 750-row dims), each package with its own warehouse: end to
end (a recurring workload recommends, builds through the lease path and
is then served with fewer bytes and identical rows), the same ranked
recommendations twice, the miner, lease contention with a stranded
create, a concurrent manual create, serving-pressure deferral, the build
budget, the disabled knob, `compile.cache.dir` on the port's
`configure_persistent_cache`, and the measured prune fraction.

Checked across the packages: equal candidate names, kinds and scores;
the built covering index's files equal by SHA-256; and each package's
`_advisor_state.json` readable by the other's advisor.

Both packages keep a process-global flight ring and segment cache; each
test starts and ends with both emptied.
"""

import hashlib
import json
import os
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

torch.set_num_threads(1)

from torch_serving import JAX, PKGS, TORCH, canonical, same_table  # noqa: E402
from torch_suites import jax_counters_guard  # noqa: E402,F401

N = 6000


def _advisor_mod(P):
    import importlib
    return importlib.import_module(f"{P.root}.advisor")


def _miner_mod(P):
    import importlib
    return importlib.import_module(f"{P.root}.advisor.miner")


def _fresh_state():
    for P in PKGS:
        P.telemetry.get_recorder().clear()
        P.segcache.set_cache(P.segcache.SegmentCache())


MEASURED = "skipping.measured_prune_fraction"


@pytest.fixture(autouse=True)
def fresh_ring_and_cache(monkeypatch):
    """Advisor tests read the PROCESS flight ring: empty both packages'
    rings (and segment caches) so other suites' queries are not mined.
    The what-if scorer also reads the process registry's global measured
    prune fraction, which other suites' skipping queries leave in one
    package's registry and not the other's; it would reorder the
    candidates. Each test runs without it (the "assumed" fraction, as a
    fresh process has) and the registry gets it back afterwards."""
    _fresh_state()
    registries = [P.telemetry.get_registry() for P in PKGS]
    for reg in registries:
        monkeypatch.delitem(reg._metrics, MEASURED, raising=False)
    yield
    for reg in registries:
        reg._metrics.pop(MEASURED, None)
    _fresh_state()


@pytest.fixture
def lake(tmp_path):
    """Facts + dims source dirs shared by both packages."""
    rng = np.random.default_rng(11)
    facts_dir = tmp_path / "facts"
    facts_dir.mkdir()
    pq.write_table(pa.table({
        "k": rng.integers(0, N // 8, N).astype(np.int64),
        "v": rng.random(N),
        "tag": rng.integers(0, 40, N).astype(np.int32),
    }), str(facts_dir / "part-0.parquet"))
    dims_dir = tmp_path / "dims"
    dims_dir.mkdir()
    pq.write_table(pa.table({
        "k": np.arange(N // 8, dtype=np.int64),
        "label": rng.integers(0, 9, N // 8).astype(np.int64),
    }), str(dims_dir / "part-0.parquet"))
    return tmp_path, str(facts_dir), str(dims_dir)


def _session(P, root, **extra):
    """A rules-enabled session over `<root>/wh_<pkg>`, no indexes."""
    conf = {"hyperspace.warehouse.dir": str(root / f"wh_{P.name}"),
            "spark.hyperspace.index.num.buckets": "4",
            # One cycle may build every winner (filter covering,
            # skipping, and the join PAIR).
            "spark.hyperspace.advisor.max.builds": "6",
            "spark.hyperspace.distribution.enabled": "false"}
    conf.update(extra)
    return P.session(conf).enable_hyperspace()


def _counter(P, name):
    return P.telemetry.get_registry().counters_dict().get(name, 0)


def _scan_bytes(metrics) -> int:
    return sum(op.detail.get("bytes_scanned", 0)
               for op in metrics.operators if op.name == "Scan")


def _run_filter_workload(P, sess, facts, repeats=3):
    q = sess.read_parquet(facts).filter(P.col("tag") == 7) \
        .select("k", "v", "tag")
    table = None
    for _ in range(repeats):
        table = q.collect()
    return q, table


def _ranked(P, sess):
    adv = _advisor_mod(P)
    a = adv.IndexAdvisor(sess)
    a.observe()
    return [(c.name, c.kind, c.score, c.est_bytes_avoided_per_query)
            for c in adv.score_signatures(sess, a.miner.recurring(),
                                          sess.conf)]


def _index_files(sess, name):
    """{relative path: sha256} of an index's parquet data files."""
    root = os.path.join(sess.conf.system_path, name)
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith(".parquet"):
                path = os.path.join(d, f)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, root)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------


def test_e2e_recurring_workload_auto_builds_and_serves(lake):
    root, facts, dims = lake
    got = {}
    for P in PKGS:
        sess = _session(P, root)
        hs = P.Hyperspace(sess)
        df = sess.read_parquet(facts)
        d = sess.read_parquet(dims)
        filter_q = df.filter(P.col("tag") == 7).select("k", "v", "tag")
        join_q = df.join(d, on="k").select("k", "v", "label")
        before_tables = []
        before_bytes = 0
        for _ in range(3):
            before_tables = [filter_q.collect(), join_q.collect()]
        for q in (filter_q, join_q):
            q.collect()
            before_bytes += _scan_bytes(sess.last_query_metrics())

        advisor = hs.advisor()
        assert hs.advisor() is advisor
        builds_before = _counter(P, "advisor.builds")
        summary = advisor.run_once()
        built = [dec for dec in summary["decisions"]
                 if dec.get("action") == "built"]
        assert built, summary["decisions"]
        assert _counter(P, "advisor.builds") >= builds_before + 1
        catalog = hs.indexes()
        assert (catalog["state"] == "ACTIVE").all()
        assert any(name.startswith("adv_") for name in catalog["name"])

        after_bytes, applied, after_tables = 0, 0, []
        for q in (filter_q, join_q):
            after_tables.append(q.collect())
            m = sess.last_query_metrics()
            after_bytes += _scan_bytes(m)
            applied += sum(1 for e in m.events
                           if e.get("category") == "rule"
                           and e.get("action") == "applied")
        assert applied >= 1
        assert after_bytes < before_bytes
        for want, have in zip(before_tables, after_tables):
            assert canonical(have).equals(canonical(want))

        state = advisor.state()
        assert state["kind"] == "hyperspace-advisor-state"
        assert state["last_run"]["decisions"] == summary["decisions"]
        assert os.path.exists(os.path.join(
            sess.conf.system_path, _advisor_mod(P).STATE_FILE))
        second = advisor.run_once()
        assert not [dec for dec in second["decisions"]
                    if dec.get("action") == "built"]
        got[P.name] = {
            "sess": sess, "summary": summary, "tables": after_tables,
            "decisions": [(dec["name"], dec.get("kind"), dec["score"],
                           dec["action"], tuple(dec.get("indexes", ())))
                          for dec in summary["decisions"]],
            "recommendations": [(r["name"], r["kind"], r["score"])
                                for r in summary["recommendations"]]}

    t, j = got["torch"], got["jax"]
    assert t["recommendations"] == j["recommendations"]
    assert t["decisions"] == j["decisions"]
    for a, b in zip(t["tables"], j["tables"]):
        assert same_table(canonical(a), canonical(b))
    # The built covering indexes are the same bytes on disk.
    covering = [name for name, kind, _s, action, idx in t["decisions"]
                if action == "built" and kind in ("covering", "join")
                for name in idx]
    assert covering
    for name in covering:
        files = _index_files(t["sess"], name)
        assert files and files == _index_files(j["sess"], name), name


def test_advisor_state_reads_across_packages(lake):
    root, facts, _dims = lake
    sessions = {}
    for P in PKGS:
        sess = _session(P, root)
        _run_filter_workload(P, sess, facts)
        P.Hyperspace(sess).advisor().run_once()
        sessions[P.name] = sess
    for P, other in ((JAX, TORCH), (TORCH, JAX)):
        # The other package's advisor over this package's warehouse.
        reader = _advisor_mod(other).IndexAdvisor(
            _session(other, root, **{"hyperspace.warehouse.dir":
                                     sessions[P.name].conf.warehouse_dir}))
        mine = _advisor_mod(P).IndexAdvisor(sessions[P.name]).state()
        theirs = reader.state()
        assert theirs is not None and theirs == mine
        assert theirs["kind"] == "hyperspace-advisor-state"
        assert theirs["version"] == 1
        assert set(theirs) == {"kind", "version", "updated_at", "last_seq",
                               "last_run", "decision_history"}


# ---------------------------------------------------------------------------
# Determinism
# ---------------------------------------------------------------------------


def test_same_recorded_workload_same_ranked_recommendations(lake):
    """Two independent advisors polling the same ring mine the same
    signatures and rank the same candidates with the same scores — in
    each package, and across the packages."""
    root, facts, dims = lake
    ranked = {}
    for P in PKGS:
        sess = _session(P, root)
        _run_filter_workload(P, sess, facts)
        df = sess.read_parquet(facts)
        d = sess.read_parquet(dims)
        for _ in range(3):
            df.join(d, on="k").select("k", "v", "label").collect()
        first = _ranked(P, sess)
        assert first, "no candidates mined from a recurring workload"
        assert first == _ranked(P, sess)
        assert "covering" in {k for _n, k, _s, _b in first}
        assert "join" in {k for _n, k, _s, _b in first}
        ranked[P.name] = first
    assert ranked["torch"] == ranked["jax"]


def test_candidate_names_equal_the_jax_packages(lake):
    """`_candidate_name` is md5 over kind, root and columns: the same
    source root names the same candidates in both packages."""
    from hyperspace_tpu.advisor import whatif as jwhatif

    from hyperspace_tpu_torch.advisor import whatif as twhatif

    root, facts, _dims = lake
    for kind, indexed, included in (("cov", ["tag"], ["k", "v"]),
                                    ("skip", ["tag", "k"], []),
                                    ("cov", ["k"], ["label"])):
        assert twhatif._candidate_name(kind, facts, indexed, included) == \
            jwhatif._candidate_name(kind, facts, indexed, included)


def test_miner_counts_and_ignores_served_queries(lake):
    root, facts, _dims = lake
    out = {}
    for P in PKGS:
        sess = _session(P, root)
        _run_filter_workload(P, sess, facts, repeats=4)
        miner = _miner_mod(P).WorkloadMiner(min_repeats=2)
        assert miner.poll() == 4
        sigs = miner.recurring()
        assert len(sigs) == 1
        assert sigs[0].kind == "filter"
        assert sigs[0].count == 4
        assert sigs[0].filter_columns == ("tag",)
        assert "tag" in sigs[0].eq_columns
        assert sigs[0].total_scan_bytes > 0
        assert miner.poll() == 0
        assert miner.recurring()[0].count == 4
        d = sigs[0].to_dict()
        d.pop("last_seq")
        d["roots"] = [os.path.basename(r) for r in d["roots"]]
        out[P.name] = d
    assert out["torch"] == out["jax"]


# ---------------------------------------------------------------------------
# Lease contention: advisor vs manual create
# ---------------------------------------------------------------------------


def _covering_candidate(P, sess):
    adv = _advisor_mod(P)
    advisor = P.Hyperspace(sess).advisor()
    advisor.observe()
    return advisor, next(
        c for c in adv.score_signatures(sess, advisor.miner.recurring(),
                                        sess.conf)
        if c.kind == "covering")


def test_lease_contention_one_winner_clean_recovery(lake):
    root, facts, _dims = lake
    for P in PKGS:
        import importlib
        factories = importlib.import_module(f"{P.root}.index.factories")
        resolver = importlib.import_module(f"{P.root}.index.path_resolver")
        sess = _session(P, root)
        hs = P.Hyperspace(sess)
        _run_filter_workload(P, sess, facts)
        advisor, cov = _covering_candidate(P, sess)
        path = resolver.PathResolver(sess.conf).get_index_path(cov.name)
        log_manager = factories.IndexLogManagerFactory().create(
            path, conf=sess.conf)
        stranded = P.log_entry.IndexLogEntry.from_dict(json.loads(
            json.dumps({
                "version": "0.1", "id": 0, "state": "CREATING",
                # FRESH: the writer is presumed LIVE within the lease.
                "timestamp": int(time.time() * 1000),
                "name": cov.name,
                "derivedDataset": {"kind": "CoveringIndex", "properties": {
                    "columns": {"indexed": ["tag"], "included": []},
                    "schemaString": "{}", "numBuckets": 4}},
                "content": {"root": path, "directories": []},
                "source": {"plan": {"properties": {
                    "rawPlan": "{}",
                    "fingerprint": {"properties": {"signatures": []}}},
                    "kind": "Spark"}, "data": []},
                "extra": {}})))
        assert log_manager.write_log(0, stranded)

        conflicts_before = _counter(P, "advisor.build_conflicts")
        summary = advisor.run_once()
        decisions = {d["name"]: d for d in summary["decisions"]}
        assert decisions[cov.name]["action"] == "conflict", P
        assert _counter(P, "advisor.build_conflicts") == \
            conflicts_before + 1
        assert log_manager.get_latest_log().state == "CREATING"

        assert hs.recover_index(cov.name) is True
        summary2 = advisor.run_once()
        built = {name for d in summary2["decisions"]
                 if d.get("action") == "built"
                 for name in d.get("indexes", ())}
        assert cov.name in built
        states = dict(zip(hs.indexes()["name"], hs.indexes()["state"]))
        assert states[cov.name] == "ACTIVE"


def test_concurrent_manual_create_races_cleanly(lake):
    """A racing manual create of the advisor's candidate: one writer wins
    the op-log slot, the loser concedes, and the index ends ACTIVE."""
    root, facts, _dims = lake
    for P in PKGS:
        sess = _session(P, root)
        hs = P.Hyperspace(sess)
        _run_filter_workload(P, sess, facts)
        advisor, cov = _covering_candidate(P, sess)
        barrier = threading.Barrier(2)
        manual_error, summaries = [], []

        def manual():
            barrier.wait()
            try:
                hs.create_index(
                    sess.read_parquet(facts),
                    P.IndexConfig(cov.name,
                                  list(cov.configs[0].indexed_columns),
                                  list(cov.configs[0].included_columns)))
            except Exception as exc:  # noqa: BLE001 — the loser's concede
                manual_error.append(repr(exc))

        def advised():
            barrier.wait()
            summaries.append(advisor.run_once())

        threads = [threading.Thread(target=manual),
                   threading.Thread(target=advised)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        decisions = {d["name"]: d["action"]
                     for d in summaries[0]["decisions"]}
        assert decisions.get(cov.name) == "built" or not manual_error
        states = dict(zip(hs.indexes()["name"], hs.indexes()["state"]))
        assert states.get(cov.name) == "ACTIVE"
        _run_filter_workload(P, sess, facts, repeats=1)
        m = sess.last_query_metrics()
        assert any(e.get("action") == "applied" for e in m.events
                   if e.get("category") == "rule")


# ---------------------------------------------------------------------------
# Serving pressure, budgets, the knob
# ---------------------------------------------------------------------------


def test_advisor_defers_under_serving_pressure(lake):
    root, facts, _dims = lake
    for P in PKGS:
        class Pressured(P.sched.QueryScheduler):
            def __init__(self, pressure):
                super().__init__()
                self._fake_pressure = pressure

            def pressure(self):
                return dict(self._fake_pressure)

        sess = _session(P, root)
        hs = P.Hyperspace(sess)
        _run_filter_workload(P, sess, facts)
        advisor = hs.advisor()
        old = P.sched.get_scheduler()
        try:
            P.sched.set_scheduler(Pressured(
                {"queue_depth": 3, "admitted_bytes": 0, "inflight": 3}))
            deferred_before = _counter(P, "advisor.deferred")
            summary = advisor.run_once()
            assert summary["recommendations"], "nothing recommended"
            assert all(d["action"] == "deferred"
                       for d in summary["decisions"])
            assert _counter(P, "advisor.deferred") == deferred_before + 1
            assert len(hs.indexes()) == 0

            sess.conf.set("spark.hyperspace.serve.hbm.budget.bytes", 1000)
            P.sched.set_scheduler(Pressured(
                {"queue_depth": 0, "admitted_bytes": 900, "inflight": 1}))
            summary = advisor.run_once()
            assert all(d["action"] == "deferred"
                       for d in summary["decisions"])
            assert len(hs.indexes()) == 0

            P.sched.set_scheduler(Pressured(
                {"queue_depth": 0, "admitted_bytes": 0, "inflight": 0}))
            summary = advisor.run_once()
            assert any(d["action"] == "built"
                       for d in summary["decisions"])
        finally:
            P.sched.set_scheduler(old)
            sess.conf.unset("spark.hyperspace.serve.hbm.budget.bytes")


def test_build_budget_rejects_past_cap(lake):
    root, facts, _dims = lake
    for P in PKGS:
        sess = _session(P, root)
        hs = P.Hyperspace(sess)
        _run_filter_workload(P, sess, facts)
        sess.conf.set("spark.hyperspace.advisor.build.budget.bytes", 1)
        rejected_before = _counter(P, "advisor.rejected_budget")
        summary = hs.advisor().run_once()
        assert summary["recommendations"]
        assert all(d["action"] == "rejected_budget"
                   for d in summary["decisions"])
        assert _counter(P, "advisor.rejected_budget") > rejected_before
        assert len(hs.indexes()) == 0


def test_tenant_budget_rejects_past_the_tenants_cap(lake):
    """`advisor.tenant.<id>.budget.bytes` caps one tenant's builds per
    run, with the JAX package's counters and decisions."""
    root, facts, _dims = lake
    out = {}
    for P in PKGS:
        sess = _session(P, root, **{
            "spark.hyperspace.advisor.tenant.t1.budget.bytes": "1"})
        hs = P.Hyperspace(sess)
        q = sess.read_parquet(facts).filter(P.col("tag") == 7) \
            .select("k", "v", "tag")
        for _ in range(3):
            q.collect(tenant="t1")
        before = _counter(P, "advisor.tenant.t1.rejected_budget")
        summary = hs.advisor().run_once()
        assert summary["decisions"]
        assert all(d["action"] == "rejected_budget" and d["tenant"] == "t1"
                   for d in summary["decisions"])
        assert _counter(P, "advisor.tenant.t1.rejected_budget") > before
        out[P.name] = [(d["name"], d["action"]) for d in
                       summary["decisions"]]
    assert out["torch"] == out["jax"]


def test_advisor_disabled_knob(lake):
    root, facts, _dims = lake
    for P in PKGS:
        sess = _session(P, root)
        sess.conf.set("spark.hyperspace.advisor.enabled", "false")
        hs = P.Hyperspace(sess)
        _run_filter_workload(P, sess, facts)
        summary = hs.advisor().run_once()
        assert summary["recommendations"]
        assert all(d["action"] == "disabled" for d in summary["decisions"])
        assert len(hs.indexes()) == 0


def test_background_mode_starts_and_stops(lake):
    root, facts, _dims = lake
    for P in PKGS:
        sess = _session(P, root)
        _run_filter_workload(P, sess, facts)
        advisor = P.Hyperspace(sess).advisor()
        runs = _counter(P, "advisor.runs")
        advisor.start(interval_s=0.05)
        deadline = time.time() + 30
        while _counter(P, "advisor.runs") == runs and time.time() < deadline:
            time.sleep(0.05)
        advisor.stop()
        assert _counter(P, "advisor.runs") > runs
        assert advisor._daemon is None
        report = advisor.report()
        assert set(report) == {"generated_at", "recommendations",
                               "decisions", "skipping_drift",
                               "index_usage"}
        assert "error" not in report["index_usage"]


# ---------------------------------------------------------------------------
# compile.cache.dir (the port's counterpart of the JAX package's
# persistent compilation cache: where the nvcc and g++ builds go)
# ---------------------------------------------------------------------------


def test_compile_cache_dir_wires_persistent_cache(tmp_path, monkeypatch):
    from hyperspace_tpu_torch import native
    from hyperspace_tpu_torch.ops.cuda import build
    from hyperspace_tpu_torch.telemetry import compilation

    cache_dir = tmp_path / "buildcache"
    monkeypatch.setattr(compilation, "_persistent_dir", None)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    before = _counter(TORCH, "compile.persistent_cache.configured")
    sess = TORCH.session({
        "hyperspace.warehouse.dir": str(tmp_path / "wh"),
        "spark.hyperspace.compile.cache.dir": str(cache_dir)})
    assert compilation.persistent_cache_dir() == str(cache_dir)
    assert build.BUILD_DIR == native.BUILD_DIR == str(cache_dir)
    assert _counter(TORCH, "compile.persistent_cache.configured") == \
        before + 1
    # Unset knob: configure is a no-op, not a reset.
    TORCH.session({"hyperspace.warehouse.dir": str(tmp_path / "wh2")})
    assert compilation.persistent_cache_dir() == str(cache_dir)
    sess.close()


# ---------------------------------------------------------------------------
# Measured prune fraction closes the what-if loop
# ---------------------------------------------------------------------------


def test_measured_prune_fraction_drives_skipping_rank(lake):
    root, facts, _dims = lake
    for P in PKGS:
        adv = _advisor_mod(P)
        sess = _session(P, root)
        _run_filter_workload(P, sess, facts)
        a = adv.IndexAdvisor(sess)
        a.observe()
        sigs = a.miner.recurring()

        def ranked():
            cands = adv.score_signatures(sess, sigs, sess.conf)
            return cands, [c.name for c in cands]

        cands, _names = ranked()
        sk = next(c for c in cands if c.kind == "skipping")
        cov = next(c for c in cands if c.kind == "covering")
        assert sk.detail["prune_fraction_source"] in ("assumed",
                                                      "measured:global")
        gauge = P.telemetry.get_registry().gauge(
            f"skipping.{sk.name}.measured_prune_fraction")
        gauge.set(1.0)
        cands, names = ranked()
        sk_hi = next(c for c in cands if c.kind == "skipping")
        assert sk_hi.detail["prune_fraction_source"] == "measured:index"
        assert sk_hi.detail["prune_fraction"] == 1.0
        assert names.index(sk_hi.name) < names.index(cov.name)
        assert sk_hi.est_bytes_avoided_per_query > \
            cov.est_bytes_avoided_per_query

        gauge.set(0.001)
        cands, names = ranked()
        sk_lo = next(c for c in cands if c.kind == "skipping")
        assert sk_lo.detail["prune_fraction_source"] == "measured:index"
        assert names.index(sk_lo.name) > names.index(cov.name)
        assert sk_lo.score < cov.score
