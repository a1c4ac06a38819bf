"""The port's storage resilience and fault injection
(`utils/faults.py` and its seams in `file_utils`, `storage`, the
parquet read/write, the action phases) against the JAX package's: every
scenario of `tests/test_resilience.py` — the retry policy, the
injector's rules, log-manager resilience, atomic publish, the
action-report sidecar guard, OCC under concurrency, the crash-point
matrix of every action, a crashed create, lease-gated recovery, query
degradation to the source plan, vacuum over sparse versions and
transient storage faults on the retry seam — through both packages on
the same inputs. Outcomes compare by value; errors by class name.
"""

import json
import os
import shutil
import threading
import uuid

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401

import fakes
from torch_serving import (PKGS, TORCH, both, jax_counters_restored, reset_lanes,
                           same_rows, typed)


@pytest.fixture(autouse=True)
def _fresh():
    reset_lanes()
    with jax_counters_restored():
        yield
    reset_lanes()


def _noop_action(P):
    class NoOpAction(P.actions_base.Action):
        transient_state = P.States.CREATING
        final_state = P.States.ACTIVE

        def __init__(self, log_manager):
            super().__init__(log_manager)
            self.op_ran = False

        def log_entry(self):
            return P.make_entry(state="")

        def op(self):
            self.op_ran = True

    return NoOpAction


def _fake_managers(P):
    """`tests/fakes.py`'s recording fakes over this package's manager
    interfaces."""
    log = type("FakeLogManager", (P.log_manager.IndexLogManager,),
               {k: v for k, v in vars(fakes.FakeLogManager).items()
                if not k.startswith("__") or k == "__init__"})
    data = type("FakeDataManager", (P.data_manager.IndexDataManager,),
                {k: v for k, v in vars(fakes.FakeDataManager).items()
                 if not k.startswith("__") or k == "__init__"})
    return log, data


# -- retry policy --------------------------------------------------------------


def test_retry_succeeds_after_transient(tmp_path):
    def scenario(P, d):
        delays = []
        policy = P.retry.RetryPolicy(attempts=5, base_ms=10, max_ms=100,
                                     sleep=delays.append)
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise ConnectionResetError("transient")
            return "ok"

        out = P.retry.call(flaky, operation="t.flaky", policy=policy)
        return out, calls["n"], delays

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"]
    assert got["torch"][:2] == ("ok", 3) and len(got["torch"][2]) == 2
    assert got["torch"][2][1] > got["torch"][2][0]


def test_retry_permanent_fails_immediately(tmp_path):
    def scenario(P, d):
        delays = []
        policy = P.retry.RetryPolicy(attempts=5, sleep=delays.append)
        calls = {"n": 0}

        def broken():
            calls["n"] += 1
            raise FileNotFoundError("gone")

        with pytest.raises(FileNotFoundError):
            P.retry.call(broken, operation="t.broken", policy=policy)
        return calls["n"], delays

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == (1, [])


def test_retry_gives_up_after_attempts(tmp_path):
    def scenario(P, d):
        delays = []
        policy = P.retry.RetryPolicy(attempts=3, sleep=delays.append)

        def always():
            raise TimeoutError("still down")

        c0 = P.counters("io.retries", "io.giveups")
        with pytest.raises(TimeoutError):
            P.retry.call(always, operation="t.always", policy=policy)
        c1 = P.counters("io.retries", "io.giveups")
        return len(delays), {k: c1[k] - c0[k] for k in c0}

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == (2, {"io.retries": 2,
                                              "io.giveups": 1})


def test_retryable_extension_and_predicate(tmp_path):
    def scenario(P, d):
        policy = P.retry.RetryPolicy(attempts=3, sleep=lambda s: None)
        calls = {"n": 0}

        def torn_then_ok():
            calls["n"] += 1
            if calls["n"] == 1:
                raise ValueError("torn json")
            return 42

        with pytest.raises(ValueError):
            P.retry.call(lambda: (_ for _ in ()).throw(ValueError("x")),
                         operation="t.v", policy=policy)
        return P.retry.call(torn_then_ok, operation="t.torn",
                            policy=policy, retryable=(ValueError,))

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == 42


def test_classification_typed_and_status_based(tmp_path):
    class Http(Exception):
        def __init__(self, status):
            self.status = status

    def scenario(P, d):
        cases = [ConnectionResetError("x"), TimeoutError("x"),
                 P.faults.TornWriteError("x"), FileNotFoundError("x"),
                 PermissionError("x"), ValueError("x"), Http(503),
                 Http(429), Http(404)]
        return [P.retry.is_transient(c) for c in cases]

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == [True, True, True, False, False,
                                          False, True, True, False]


def test_backoff_deterministic_and_capped(tmp_path):
    def scenario(P, d):
        policy = P.retry.RetryPolicy(attempts=10, base_ms=20, max_ms=100)
        first = [policy.delay_s("op.a", i) for i in range(1, 8)]
        other = [policy.delay_s("op.b", i) for i in range(1, 8)]
        return first, other

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"]
    first, other = got["torch"]
    assert first != other and all(x <= 0.100 for x in first)


def test_policy_from_conf(tmp_path):
    def scenario(P, d):
        conf = P.conf({"spark.hyperspace.io.retry.attempts": "7",
                       "spark.hyperspace.io.retry.base.ms": "5",
                       "spark.hyperspace.io.retry.max.ms": "50"})
        policy = P.retry.policy_for(conf)
        return ((policy.attempts, policy.base_ms, policy.max_ms),
                P.retry.policy_for(None) is P.retry.DEFAULT_POLICY)

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == ((7, 5.0, 50.0), True)


# -- fault injector --------------------------------------------------------------


def test_injector_nth_and_times(tmp_path):
    def scenario(P, d):
        inj = P.arm(P.rule("seam.*", kind="transient", nth=2, times=2))
        out = [P.faults.fire("seam.x")]
        for _ in range(2):
            with pytest.raises(P.faults.InjectedTransientError) as ei:
                P.faults.fire("seam.x")
            out.append(typed(ei.value))
        out += [P.faults.fire("seam.x"), inj.fired("seam.*"),
                P.faults.fire("other.op")]
        return out

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == [
        None, "InjectedTransientError", "InjectedTransientError", None, 2,
        None]


def test_injector_path_filter_and_kinds(tmp_path):
    def scenario(P, d):
        P.arm(P.rule("file.create", kind="permanent", path="*report*",
                     times=-1))
        out = [P.faults.fire("file.create", "/x/data.parquet")]
        for path in ("/x/7.report.json", "/x/8.report.json"):
            with pytest.raises(P.faults.InjectedPermanentError) as ei:
                P.faults.fire("file.create", path)
            out.append(str(ei.value))
        return out

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"]


def test_injector_crash_is_baseexception(tmp_path):
    def scenario(P, d):
        P.arm(P.rule("boom", kind="crash"))
        with pytest.raises(P.faults.InjectedCrash):
            P.faults.fire("boom")
        return issubclass(P.faults.InjectedCrash, Exception)

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] is False


def test_injector_seeded_probability_replays(tmp_path):
    def scenario(P, d):
        def pattern(seed):
            inj = P.faults.FaultInjector(
                [P.rule("p.*", kind="transient", probability=0.5,
                        times=-1)], seed=seed)
            out = []
            for _ in range(32):
                try:
                    inj.check("p.op")
                    out.append(0)
                except P.faults.InjectedTransientError:
                    out.append(1)
            return out

        return pattern(7), pattern(7), pattern(8)

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"]
    a, b, c = got["torch"]
    assert a == b and a != c and 0 < sum(a) < 32


def test_uninstalled_fire_is_noop(tmp_path):
    def scenario(P, d):
        P.faults.uninstall()
        return P.faults.fire("anything", "/p"), P.faults.active()

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == (None, None)


# -- log manager resilience --------------------------------------------------------


def test_log_read_retries_transient_io(tmp_path):
    def scenario(P, d):
        mgr = P.log_manager.IndexLogManagerImpl(str(d / "idx"))
        assert mgr.write_log(0, P.make_entry(state=P.States.ACTIVE))
        inj = P.arm(P.rule("file.read", kind="transient", times=2,
                           path="*_hyperspace_log*"))
        return mgr.get_log(0).state, inj.fired("file.read")

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == ("ACTIVE", 2)


def test_log_read_retries_torn_json(tmp_path, monkeypatch):
    def scenario(P, d):
        mgr = P.log_manager.IndexLogManagerImpl(str(d / "idx"))
        assert mgr.write_log(0, P.make_entry(state=P.States.ACTIVE))
        real_read = P.file_utils.read_contents
        calls = {"n": 0}

        def torn_then_full(path):
            calls["n"] += 1
            contents = real_read(path)
            return (contents[: len(contents) // 2] if calls["n"] < 3
                    else contents)

        monkeypatch.setattr(P.log_manager.file_utils, "read_contents",
                            torn_then_full)
        try:
            return mgr.get_log(0).state, calls["n"]
        finally:
            monkeypatch.undo()

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == ("ACTIVE", 3)


def test_log_read_permanently_corrupt_raises(tmp_path):
    def scenario(P, d):
        log_dir = d / "idx" / "_hyperspace_log"
        log_dir.mkdir(parents=True)
        (log_dir / "0").write_text("{torn forever")
        mgr = P.log_manager.IndexLogManagerImpl(
            str(d / "idx"),
            conf=P.conf({"spark.hyperspace.io.retry.attempts": "2",
                         "spark.hyperspace.io.retry.base.ms": "1"}))
        with pytest.raises(P.exc.HyperspaceException,
                           match="Corrupt log entry") as ei:
            mgr.get_log(0)
        return typed(ei.value)

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == "HyperspaceException"


def test_atomic_publish_never_tears_target(tmp_path):
    def scenario(P, d):
        target = str(d / "latestStable")
        P.file_utils.atomic_publish(target, '{"state": "OLD"}')
        P.arm(P.rule("file.publish", kind="torn", times=-1))
        with pytest.raises(P.faults.TornWriteError):
            P.file_utils.atomic_publish(target, '{"state": "NEW-LONGER"}')
        return (json.loads(P.file_utils.read_contents(target)),
                [f for f in os.listdir(d) if f.startswith("latestStable.")])

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == ({"state": "OLD"}, [])


def test_latest_stable_copy_atomic_in_log_manager(tmp_path):
    def scenario(P, d):
        mgr = P.log_manager.IndexLogManagerImpl(
            str(d / "idx"),
            conf=P.conf({"spark.hyperspace.io.retry.attempts": "2",
                         "spark.hyperspace.io.retry.base.ms": "1"}))
        assert mgr.write_log(0, P.make_entry(state=P.States.ACTIVE))
        assert mgr.create_latest_stable_log(0)
        assert mgr.write_log(1, P.make_entry(state=P.States.DELETED))
        P.arm(P.rule("file.publish", kind="torn", times=-1))
        with pytest.raises(P.faults.TornWriteError):
            mgr.create_latest_stable_log(1)
        return mgr.get_latest_stable_log().state

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == "ACTIVE"


def test_action_report_write_failure_never_fails_action(tmp_path):
    def scenario(P, d):
        mgr = P.log_manager.IndexLogManagerImpl(str(d / "idx"))
        P.arm(P.rule("file.create", kind="permanent",
                     path="*report.json*", times=-1))
        _noop_action(P)(mgr).run()
        return mgr.get_latest_log().state, mgr.get_action_report(1)

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == ("ACTIVE", None)


# -- OCC under concurrency ---------------------------------------------------------


def test_occ_exactly_one_winner_per_log_id_on_memory(tmp_path):
    def scenario(P, d):
        root = f"memory://occ-{P.name}-{uuid.uuid4().hex}"
        mgr = P.log_manager.IndexLogManagerImpl(root + "/idx")
        out = []
        try:
            for log_id in range(3):
                barrier = threading.Barrier(8)
                results = []

                def attempt():
                    entry = P.make_entry(state=P.States.CREATING)
                    barrier.wait()
                    results.append(mgr.write_log(log_id, entry))

                threads = [threading.Thread(target=attempt)
                           for _ in range(8)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                out.append((sum(results), mgr.get_latest_id()))
        finally:
            P.file_utils.delete(root)
        return out

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == [(1, 0), (1, 1), (1, 2)]


def test_occ_concurrent_actions_one_winner(tmp_path):
    def scenario(P, d):
        noop = _noop_action(P)
        path = str(d / "idx")
        outcomes = []
        barrier = threading.Barrier(2)

        def run_action():
            action = noop(P.log_manager.IndexLogManagerImpl(path))
            _ = action.base_id
            barrier.wait()
            try:
                action.run()
                outcomes.append("won")
            except P.exc.HyperspaceException:
                outcomes.append("lost")

        threads = [threading.Thread(target=run_action) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return sorted(outcomes)

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == ["lost", "won"]


# -- crash-point matrix ------------------------------------------------------------


def _write_source(path, n=240, seed=3):
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    pq.write_table(pa.table({"k": rng.integers(0, 40, n).astype(np.int64),
                             "x": np.arange(n, dtype=np.int64)}),
                   os.path.join(path, f"part-{seed}.parquet"))


def _fresh_env(P, d):
    src = str(d / "src")
    _write_source(src)
    sess = P.session({"hyperspace.warehouse.dir": str(d / "wh"),
                      "hyperspace.index.num.buckets": "4"})
    return P.Hyperspace(sess), sess, sess.read_parquet(src), src


def _prepare(P, verb, hs, df, src):
    cfg = P.IndexConfig("idx", ["k"], ["x"])
    if verb == "create":
        return
    hs.create_index(df, cfg)
    if verb == "incremental":
        _write_source(src, n=60, seed=9)
    elif verb in ("restore", "vacuum"):
        hs.delete_index("idx")
    elif verb == "cancel":
        P.arm(P.rule("action.RefreshAction.end", kind="crash"))
        with pytest.raises(P.faults.InjectedCrash):
            hs.refresh_index("idx")
        P.faults.uninstall()


def _run_verb(P, verb, hs, df):
    cfg = P.IndexConfig("idx", ["k"], ["x"])
    {"create": lambda: hs.create_index(df, cfg),
     "refresh": lambda: hs.refresh_index("idx"),
     "incremental": lambda: hs.refresh_index("idx", mode="incremental"),
     "optimize": lambda: hs.optimize_index("idx"),
     "delete": lambda: hs.delete_index("idx"),
     "restore": lambda: hs.restore_index("idx"),
     "vacuum": lambda: hs.vacuum_index("idx"),
     "cancel": lambda: hs.cancel("idx")}[verb]()


_VERB_CLASS = {
    "create": "CreateAction", "refresh": "RefreshAction",
    "incremental": "RefreshIncrementalAction", "optimize": "OptimizeAction",
    "delete": "DeleteAction", "restore": "RestoreAction",
    "vacuum": "VacuumAction", "cancel": "CancelAction",
}


@pytest.mark.parametrize("phase", ["validate", "begin", "op", "end"])
@pytest.mark.parametrize("verb", sorted(_VERB_CLASS))
def test_crash_point_matrix(tmp_path, verb, phase):
    def scenario(P, d):
        hs, sess, df, src = _fresh_env(P, d)
        _prepare(P, verb, hs, df, src)
        P.arm(P.rule(f"action.{_VERB_CLASS[verb]}.{phase}", kind="crash"))
        with pytest.raises(P.faults.InjectedCrash):
            _run_verb(P, verb, hs, df)
        P.faults.uninstall()
        log_mgr = P.log_manager.IndexLogManagerImpl(
            str(d / "wh" / "indexes" / "idx"))
        try:
            recovered = hs.recover_index("idx")
        except P.exc.HyperspaceException as exc:
            recovered = typed(exc)
        latest = log_mgr.get_latest_log()
        after_recovery = latest.state if latest is not None else None
        final = None
        if verb != "cancel":
            _run_verb(P, verb, hs, df)
            final = log_mgr.get_latest_log().state
        return recovered, after_recovery, final

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"]
    recovered, after, final = got["torch"]
    if recovered == "HyperspaceException":
        assert verb == "create" and phase in ("validate", "begin")
    if after is not None:
        assert after in TORCH.STABLE_STATES


def test_crashed_create_then_query_and_rebuild(tmp_path):
    def scenario(P, d):
        hs, sess, df, src = _fresh_env(P, d)
        cfg = P.IndexConfig("idx", ["k"], ["x"])
        P.arm(P.rule("parquet.write", kind="crash", nth=3))
        with pytest.raises(P.faults.InjectedCrash):
            hs.create_index(df, cfg)
        P.faults.uninstall()
        dm = P.data_manager.IndexDataManagerImpl(
            str(d / "wh" / "indexes" / "idx"))
        out = [dm.all_version_ids(), dm.get_latest_version_id()]
        sess.enable_hyperspace()
        q = lambda: df.filter(P.col("k") == P.lit(5)).select("x")  # noqa
        want = q().collect()
        out.append(hs.recover_index("idx"))
        hs.create_index(df, cfg)
        out.append(dm.get_latest_version_id())
        got = q().collect()
        assert same_rows(got, want)
        hs.delete_index("idx")
        hs.vacuum_index("idx")
        out.append(dm.all_version_ids())
        return out, got

    got = both(scenario, tmp_path)
    assert got["torch"][0] == got["jax"][0] == [[0], None, True, 1, []]
    assert same_rows(got["torch"][1], got["jax"][1])


def test_lease_gated_auto_recovery(tmp_path):
    def scenario(P, d):
        hs, sess, df, src = _fresh_env(P, d)
        cfg = P.IndexConfig("idx", ["k"], ["x"])
        P.arm(P.rule("action.CreateAction.op", kind="crash"))
        with pytest.raises(P.faults.InjectedCrash):
            hs.create_index(df, cfg)
        P.faults.uninstall()
        sess.conf.set("spark.hyperspace.maintenance.lease.seconds", "3600")
        with pytest.raises(P.exc.HyperspaceException,
                           match="already exists") as ei:
            hs.create_index(df, cfg)
        r0 = P.counter("resilience.recoveries")
        sess.conf.set("spark.hyperspace.maintenance.lease.seconds", "0")
        hs.create_index(df, cfg)
        log_mgr = P.log_manager.IndexLogManagerImpl(
            str(d / "wh" / "indexes" / "idx"))
        return (typed(ei.value), log_mgr.get_latest_log().state,
                P.counter("resilience.recoveries") - r0 >= 1)

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == ("HyperspaceException", "ACTIVE",
                                          True)


# -- graceful query degradation ----------------------------------------------------


def _indexed_env(P, d):
    hs, sess, df, src = _fresh_env(P, d)
    hs.create_index(df, P.IndexConfig("idx", ["k"], ["x"]))
    sess.enable_hyperspace()
    query = lambda: df.filter(P.col("k") == P.lit(5)).select("x")  # noqa
    roots = [p for leaf in query()._optimized_plan().collect_leaves()
             for p in leaf.root_paths]
    assert any("v__=" in p for p in roots)
    return hs, sess, df, query, str(d / "wh" / "indexes" / "idx")


def test_degrades_to_source_when_index_data_deleted(tmp_path):
    def scenario(P, d):
        hs, sess, df, query, idx_root = _indexed_env(P, d)
        want = query().collect()
        shutil.rmtree(os.path.join(idx_root, "v__=0"))
        f0 = P.counter("resilience.fallbacks")
        table, metrics = query().collect(with_metrics=True)
        assert same_rows(table, want)
        degraded = metrics.events_of("resilience", "degraded")
        return (table, metrics.counters.get("resilience.fallbacks"),
                degraded[0]["index"] if degraded else None,
                P.counter("resilience.fallbacks") - f0)

    got = both(scenario, tmp_path)
    assert got["torch"][1:] == got["jax"][1:] == (1, "idx", 1)
    assert same_rows(got["torch"][0], got["jax"][0])


def test_degrades_to_source_when_index_file_corrupt(tmp_path):
    def scenario(P, d):
        hs, sess, df, query, idx_root = _indexed_env(P, d)
        want = query().collect()
        data_dir = os.path.join(idx_root, "v__=0")
        for name in os.listdir(data_dir):
            if name.endswith(".parquet"):
                with open(os.path.join(data_dir, name), "wb") as f:
                    f.write(b"these are not the bytes you indexed")
        table, metrics = query().collect(with_metrics=True)
        assert same_rows(table, want)
        return table, metrics.counters.get("resilience.fallbacks")

    got = both(scenario, tmp_path)
    assert got["torch"][1] == got["jax"][1] == 1
    assert same_rows(got["torch"][0], got["jax"][0])


def test_source_scan_errors_do_not_degrade(tmp_path):
    def scenario(P, d):
        hs, sess, df, query, idx_root = _indexed_env(P, d)
        sess.disable_hyperspace()
        shutil.rmtree(str(d / "src"))
        f0 = P.counter("resilience.fallbacks")
        with pytest.raises(Exception) as ei:
            df.filter(P.col("k") == P.lit(5)).select("x").collect()
        return (isinstance(ei.value, P.exc.IndexDataUnavailableError),
                P.counter("resilience.fallbacks") - f0)

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == (False, 0)


def test_join_query_degrades_too(tmp_path):
    def scenario(P, d):
        src_a, src_b = str(d / "a"), str(d / "b")
        _write_source(src_a, n=120, seed=1)
        _write_source(src_b, n=120, seed=2)
        sess = P.session({"hyperspace.warehouse.dir": str(d / "wh"),
                          "hyperspace.index.num.buckets": "4"})
        hs = P.Hyperspace(sess)
        dfa, dfb = sess.read_parquet(src_a), sess.read_parquet(src_b)
        hs.create_index(dfa, P.IndexConfig("ia", ["k"], ["x"]))
        hs.create_index(dfb, P.IndexConfig("ib", ["k"], ["x"]))
        sess.enable_hyperspace()
        q = lambda: dfa.join(dfb, on="k").select("k")  # noqa: E731
        want = q().collect().num_rows
        for name in ("ia", "ib"):
            shutil.rmtree(str(d / "wh" / "indexes" / name / "v__=0"))
        table, metrics = q().collect(with_metrics=True)
        return want, table.num_rows, metrics.counters.get(
            "resilience.fallbacks")

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == got["torch"][1] and got["torch"][2] == 1


# -- vacuum over sparse/partial layouts --------------------------------------------


def test_vacuum_handles_sparse_versions(tmp_path):
    def scenario(P, d):
        log_cls, data_cls = _fake_managers(P)
        mgr = log_cls()
        mgr.write_log(0, P.make_entry(state=P.States.DELETED))
        data = data_cls(versions=[0, 3, 7])
        P.vacuum.VacuumAction(mgr, data).run()
        return data.deleted, mgr.get_latest_log().state

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == ([7, 3, 0], "DOESNOTEXIST")


def test_storage_transient_faults_ride_the_retry_seam(tmp_path):
    def scenario(P, d):
        hs, sess, df, src = _fresh_env(P, d)
        r0 = P.counter("io.retries")
        inj = P.arm(P.rule("parquet.write", kind="transient", nth=2,
                           times=1),
                    P.rule("file.write_if_absent", kind="transient",
                           times=1))
        hs.create_index(df, P.IndexConfig("idx", ["k"], ["x"]))
        log_mgr = P.log_manager.IndexLogManagerImpl(
            str(d / "wh" / "indexes" / "idx"))
        return (log_mgr.get_latest_log().state,
                P.counter("io.retries") - r0 >= 2, inj.fired("*"))

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == ("ACTIVE", True, 2)


def test_port_fault_seams_are_the_jax_packages(tmp_path):
    """The same user actions cross the same named fault seams in both
    packages: an index build, a rules-on query through the scheduler,
    and a byte-array round trip, the fused-stage seam included."""
    def scenario(P, d):
        class Recorder(P.faults.FaultInjector):
            def check(self, operation, path=None):
                seen.add(operation)
                return None

        seen = set()
        P.faults.install(Recorder())
        try:
            hs, sess, df, src = _fresh_env(P, d)
            hs.create_index(df, P.IndexConfig("idx", ["k"], ["x"]))
            sess.enable_hyperspace()
            df.filter(P.col("k") == P.lit(5)).select("x").collect()
            P.file_utils.save_byte_array(str(d / "blob"), b"x")
            P.file_utils.load_byte_array(str(d / "blob"))
        finally:
            P.faults.uninstall()
        return seen

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"]
    assert {"scheduler.admit", "scheduler.run", "parquet.read",
            "parquet.write", "file.write", "file.read",
            "action.CreateAction.op", "fusion.stage"} <= got["torch"]
