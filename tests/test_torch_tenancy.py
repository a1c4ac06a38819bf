"""The port's multi-tenant serving against the JAX package's: every
scenario of `tests/test_tenancy.py` — the tenant contextvar seam and
its propagation, the digest, tenant resolution and stamping through
`collect`, the device seam's tenant charge, `tenant_report()`
exactness, the weighted-fair (DRR) wait queue and its pinned pick, the
per-tenant HBM and queue-depth quotas, shedding the burning tenant
first, the flight ring's `tenant=` filter, the `/healthz` tenant
section and its error isolation, Prometheus exposition of hostile
tenant ids, and `tenant_snapshot` — through both packages. (The JAX
package's flight filter also composes with `replica=`, which belongs
to multi-device serving and is not part of the port.)
"""

import re
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401

from test_tenancy import fresh_scheduler  # noqa: F401  (JAX-side fixture)
from torch_serving import (JAX, PKGS, TORCH, both, jax_counters_restored,
                           reset_lanes, same_rows)


@pytest.fixture(autouse=True)
def lanes(fresh_scheduler):  # noqa: F811
    reset_lanes()
    with jax_counters_restored():
        yield
    reset_lanes()


def _sales(P, d):
    rng = np.random.default_rng(7)
    n = 3000
    data = d / "sales"
    data.mkdir(exist_ok=True)
    pq.write_table(pa.table({
        "key": rng.integers(0, 50, n).astype(np.int64),
        "qty": rng.integers(1, 10, n).astype(np.int64),
    }), str(data / "part-0.parquet"))
    sess = P.session({"hyperspace.warehouse.dir": str(d / "wh")})
    return sess, str(data)


def _finished_metrics(P, tag, tenant=None, replica=None):
    qm = P.telemetry.QueryMetrics(description=tag)
    op = qm.start_operator("Scan")
    qm.finish_operator(op, rows_out=5)
    qm.tenant = tenant
    qm.replica = replica
    qm.finish()
    return qm


# ---------------------------------------------------------------------------
# The contextvar seam
# ---------------------------------------------------------------------------


def test_tenant_scope_and_charge_mirror(tmp_path):
    def scenario(P, d):
        T = P.telemetry
        out = [T.current_tenant()]
        reg = T.get_registry()
        before = P.counter("tenant.t-scope.device.flops")
        with T.tenant_scope("t-scope"):
            out.append(T.current_tenant())
            reg.counter("device.flops").inc(5)
            out.append(T.charge_tenant("device.flops", 5))
            with T.tenant_scope(None):
                out.append(T.current_tenant())
        out.append(P.counter("tenant.t-scope.device.flops") - before)
        out.append(T.current_tenant())
        d0 = P.counter("tenant.default.cache.segments.fills")
        reg.counter("cache.segments.fills").inc()
        T.charge_tenant("cache.segments.fills")
        out.append(P.counter("tenant.default.cache.segments.fills") - d0)
        out.append("t-scope" in T.known_tenants())
        seen = []
        with T.tenant_scope("t-pool"):
            wrapped = T.propagating(lambda: seen.append(T.current_tenant()))
        t = threading.Thread(target=wrapped)
        t.start()
        t.join(5)
        out.append(seen)
        return out

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == [
        "default", "t-scope", "t-scope", "t-scope", 5, "default", 1, True,
        ["t-pool"]]


def test_tenant_digest_covers_every_charge_family(tmp_path):
    def scenario(P, d):
        T = P.telemetry
        with T.tenant_scope("t-digest"):
            for name in T.TENANT_CHARGE_COUNTERS:
                T.get_registry().counter(name).inc(2)
                T.charge_tenant(name, 2)
        digest = T.tenant_digest()
        return (sorted(digest["t-digest"]),
                all(v >= 2 for v in digest["t-digest"].values()),
                T.DEFAULT_TENANT in digest)

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"]
    assert got["torch"][1:] == (True, True)
    assert TORCH.telemetry.TENANT_CHARGE_COUNTERS \
        == JAX.telemetry.TENANT_CHARGE_COUNTERS


# ---------------------------------------------------------------------------
# Tenant resolution + stamping through collect
# ---------------------------------------------------------------------------


def test_collect_tenant_resolution_and_stamping(tmp_path):
    def scenario(P, d):
        sess, data = _sales(P, d)
        df = sess.read_parquet(data).select("key")
        out = []
        _t, qm = df.collect(with_metrics=True)
        out.append(qm.tenant)
        sess.tenant("sticky")
        a0 = P.counter("serve.tenant.sticky.admitted")
        table, qm = df.collect(with_metrics=True)
        out += [qm.tenant, P.counter("serve.tenant.sticky.admitted") - a0]
        e0 = P.counter("serve.tenant.explicit.admitted")
        _t, qm = df.collect(with_metrics=True, tenant="explicit")
        out += [qm.tenant, P.counter("serve.tenant.explicit.admitted") - e0]
        sess.tenant(None)
        _t, qm = df.collect(with_metrics=True)
        out.append(qm.tenant)
        hists = P.telemetry.get_registry().to_dict()["histograms"]
        out += [hists["tenant.sticky.query_wall_s"]["count"] >= 1,
                hists["tenant.explicit.query_wall_s"]["count"] >= 1]
        return out, table

    got = both(scenario, tmp_path)
    assert got["torch"][0] == got["jax"][0] == [
        "default", "sticky", 1, "explicit", 1, "default", True, True]
    assert same_rows(got["torch"][1], got["jax"][1])


def test_instrumented_jit_charges_active_tenant(tmp_path):
    """The JAX package bills `instrumented_jit` dispatches; the port's
    device seam (`instrumented_device`) bills the same way: the active
    tenant's `tenant.<id>.device.*` deltas equal the global ones."""
    def scenario(P, d):
        T = P.telemetry
        if P is JAX:
            import jax.numpy as jnp
            fn = T.instrumented_jit("test.tenancy_kernel",
                                    lambda x: x * 2 + 1)
            x = jnp.arange(64)
        else:
            import torch
            fn = P.compilation.instrumented_device(
                "test.tenancy_kernel", lambda x: x * 2 + 1,
                cost=lambda x: (2 * x.numel(), 16 * x.numel()))
            x = torch.arange(64)
        fn(x)
        # Unrounded counters: a 6-decimal rounded seconds delta can
        # differ from its mirror's by one unit in the last place.
        names = T.TENANT_CHARGE_COUNTERS
        t0 = {n: P.raw_counter(f"tenant.t-bill.{n}") for n in names}
        g0 = {n: P.raw_counter(n) for n in names}
        with T.tenant_scope("t-bill"):
            fn(x)
        t1 = {n: P.raw_counter(f"tenant.t-bill.{n}") for n in names}
        g1 = {n: P.raw_counter(n) for n in names}
        return (t1["device.dispatch.seconds"] > t0["device.dispatch.seconds"],
                all(t1[n] - t0[n] == pytest.approx(g1[n] - g0[n],
                                                   rel=1e-9)
                    for n in names))

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == (True, True)


def test_tenant_report_exactness(tmp_path):
    def scenario(P, d):
        sess, data = _sales(P, d)
        hs = P.Hyperspace(sess)
        df = sess.read_parquet(data).select("key")
        df.collect(tenant="rep-a")
        df.collect(tenant="rep-b")
        df.collect()
        rep = hs.tenant_report()
        names = P.telemetry.TENANT_CHARGE_COUNTERS
        # The port reads the counters unrounded, so its report is exact
        # in any process state; the JAX package's reads them rounded to
        # 6 decimals and is exact whenever its seconds counter is.
        return (rep["exact"] or P is JAX,
                all(rep["totals"][n] == pytest.approx(rep["global"][n],
                                                      rel=1e-9)
                    for n in names) or P is JAX,
                all(t in rep["tenants"]
                    and set(rep["tenants"][t]["usage"]) == set(names)
                    for t in ("rep-a", "rep-b", "default")),
                sorted(rep))

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"]
    assert got["torch"][:3] == (True, True, True)


# ---------------------------------------------------------------------------
# Weighted-fair admission (unit level: deterministic DRR semantics)
# ---------------------------------------------------------------------------


def _drain_order(sch, conf, n):
    order = []
    with sch._cv:
        for _ in range(n):
            ent = sch._drr_select(conf)
            if ent is None:
                break
            order.append(ent.tenant)
            sch._remove_waiter(ent)
    return order


def test_drr_weighted_fairness_and_no_starvation(tmp_path):
    def scenario(P, d):
        sch = P.sched.get_scheduler()
        conf = P.conf({"spark.hyperspace.serve.tenant.heavy.weight": "2",
                       "spark.hyperspace.serve.tenant.light.weight": "0.5"})
        with sch._cv:
            for i in range(8):
                sch._enqueue_waiter(P.entry(f"h{i}", 1, "heavy"))
            for i in range(4):
                sch._enqueue_waiter(P.entry(f"n{i}", 1, "normal"))
            for i in range(2):
                sch._enqueue_waiter(P.entry(f"l{i}", 1, "light"))
        order = _drain_order(sch, conf, 14)
        with sch._cv:
            empty = not sch._waiters
        return order, empty

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"]
    order, empty = got["torch"]
    assert len(order) == 14 and empty
    first = order[:7]
    assert (first.count("heavy"), first.count("normal"),
            first.count("light")) == (4, 2, 1)
    assert set(order[:4]) >= {"heavy", "normal"}


def test_drr_selection_is_pinned_across_wakeups(tmp_path):
    def scenario(P, d):
        sch = P.sched.get_scheduler()
        conf = P.conf({})
        with sch._cv:
            sch._enqueue_waiter(P.entry("a1", 1, "a"))
            sch._enqueue_waiter(P.entry("b1", 1, "b"))
            first = sch._drr_select(conf)
            pinned = (sch._drr_select(conf) is first
                      and sch._drr_select(conf) is first)
            sch._remove_waiter(first)
            second = sch._drr_select(conf)
            sch._remove_waiter(second)
            return (first.query_id, pinned, second.query_id,
                    sch._drr_select(conf))

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"]
    assert got["torch"][1] and got["torch"][0] != got["torch"][2]
    assert got["torch"][3] is None


def test_tenant_hbm_fraction_quota_with_progress(tmp_path, monkeypatch):
    def scenario(P, d):
        sch = P.sched.get_scheduler()
        monkeypatch.setattr(sch, "_live_device_bytes", lambda: 0)
        conf = P.conf({
            "spark.hyperspace.serve.hbm.budget.bytes": "1000",
            "spark.hyperspace.serve.tenant.capped.hbm.fraction": "0.2"})
        other = P.hold(sch, 10, qid="other", tenant="other")
        out = []
        try:
            with sch._cv:
                out.append(sch._fits(P.entry("big", 500, "capped"), 1000,
                                     conf))
            big = P.hold(sch, 500, qid="big", tenant="capped")
            with sch._cv:
                out.append(sch._fits(P.entry("more", 100, "capped"), 1000,
                                     conf))
                out.append(sch._fits(P.entry("free", 100, "other"), 1000,
                                     conf))
            sch._release(big)
            with sch._cv:
                out.append(sch._fits(P.entry("more", 100, "capped"), 1000,
                                     conf))
        finally:
            sch._release(other)
        return out

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == [True, False, True, True]


def test_tenant_queue_depth_rejects_only_that_tenant(tmp_path):
    def scenario(P, d):
        sch = P.sched.get_scheduler()
        conf = P.conf({
            "spark.hyperspace.serve.hbm.budget.bytes": "100",
            "spark.hyperspace.serve.queue.depth": "10",
            "spark.hyperspace.serve.tenant.noisy.queue.depth": "1"})
        holder = P.hold(sch, 100)
        results = []

        def waiter(qid, tenant):
            ent = P.entry(qid, 60, tenant)
            try:
                sch._admit(ent, conf)
                results.append((qid, "admitted"))
                sch._release(ent)
            except P.exc.QueryRejectedError:
                results.append((qid, "rejected"))

        threads = [threading.Thread(target=waiter, args=("n1", "noisy")),
                   threading.Thread(target=waiter, args=("q1", "quiet"))]
        for t in threads:
            t.start()
        for _ in range(400):
            with sch._cv:
                if len(sch._waiters) == 2:
                    break
            time.sleep(0.005)
        with sch._cv:
            queued = len(sch._waiters)
        r0 = P.counter("serve.tenant.noisy.rejected")
        with pytest.raises(P.exc.QueryRejectedError) as ei:
            sch._admit(P.entry("n2", 60, "noisy"), conf)
        rejected = P.counter("serve.tenant.noisy.rejected") - r0
        sch._release(holder)
        for t in threads:
            t.join(5)
        return queued, ei.value.phase, rejected, sorted(results)

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == (
        2, "queue", 1, [("n1", "admitted"), ("q1", "admitted")])


def test_shed_evicts_burning_tenants_queue_first(tmp_path):
    def scenario(P, d):
        sch = P.sched.get_scheduler()
        conf = P.conf({
            "spark.hyperspace.serve.hbm.budget.bytes": "100",
            "spark.hyperspace.serve.queue.depth": "2",
            "spark.hyperspace.serve.slo.p99.seconds": "0.001",
            "spark.hyperspace.serve.slo.window.seconds": "60",
            "spark.hyperspace.serve.slo.shed.enabled": "true"})
        for _ in range(20):
            sch.slo.record(1.0, conf)
            sch._tenant_slo_for("burny").record(1.0, conf)
        burning = sch.slo.burn_rate(conf) > P.sched.SLO_SHED_BURN_THRESHOLD
        holder = P.hold(sch, 100)
        outcomes = {}

        def waiter(qid, tenant):
            ent = P.entry(qid, 60, tenant)
            try:
                sch._admit(ent, conf)
                outcomes[qid] = "admitted"
                sch._release(ent)
            except P.exc.QueryRejectedError as exc:
                outcomes[qid] = f"rejected:{exc.phase}"

        burny = threading.Thread(target=waiter, args=("b1", "burny"))
        burny.start()
        for _ in range(400):
            with sch._cv:
                if sch._waiters:
                    break
            time.sleep(0.005)
        c0 = P.counters("serve.slo.shed", "serve.tenant.burny.rejected")
        calm = threading.Thread(target=waiter, args=("c1", "calm"))
        calm.start()
        burny.join(5)
        b1 = outcomes.get("b1")
        c1 = P.counters("serve.slo.shed", "serve.tenant.burny.rejected")
        sch._release(holder)
        calm.join(5)
        return (burning, b1, {k: c1[k] - c0[k] for k in c0},
                outcomes.get("c1"))

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == (
        True, "rejected:queue",
        {"serve.slo.shed": 1, "serve.tenant.burny.rejected": 1},
        "admitted")


# ---------------------------------------------------------------------------
# Flight ring: tenant filter + cursor stability
# ---------------------------------------------------------------------------


def test_snapshot_tenant_filter_cursor_stable_across_rotation(tmp_path):
    def scenario(P, d):
        rec = P.flight.FlightRecorder(capacity=4)
        for i in range(3):
            rec.record(_finished_metrics(
                P, f"q{i}", tenant=("acme" if i % 2 == 0 else "zen")))
        fresh, cursor = rec.snapshot(0, tenant="acme")
        out = [[m.description for m in fresh], cursor == rec.last_seq]
        again, cursor2 = rec.snapshot(cursor, tenant="acme")
        out += [again, cursor2 == cursor]
        for i in range(3, 10):
            rec.record(_finished_metrics(
                P, f"q{i}", tenant=("acme" if i % 2 == 0 else "zen"),
                replica=i % 2))
        fresh, cursor3 = rec.snapshot(cursor, tenant="acme")
        out += [[m.description for m in fresh], cursor3 - cursor]
        # The filter composes with `replica=` (acme's entries all landed
        # on replica 0), and the cursor stays global under it.
        both_, bcur = rec.snapshot(cursor, tenant="acme", replica=0)
        none, _ = rec.snapshot(cursor, tenant="acme", replica=1)
        ones, _ = rec.snapshot(cursor, replica=1)
        out += [[m.description for m in both_], bcur == cursor3, none,
                [m.description for m in ones]]
        zen, zcur = rec.snapshot(cursor, tenant="zen")
        out += [[m.description for m in zen], zcur == cursor3]
        return out

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == [
        ["q0", "q2"], True, [], True, ["q6", "q8"], 7, ["q6", "q8"], True,
        [], ["q7", "q9"], ["q7", "q9"], True]


def test_flight_tenant_filter_e2e(tmp_path):
    def scenario(P, d):
        sess, data = _sales(P, d)
        rec = sess.flight_recorder()
        cursor = rec.last_seq
        df = sess.read_parquet(data).select("key")
        df.collect(tenant="flt-a")
        df.collect()
        df.collect(tenant="flt-a")
        mine, _ = rec.snapshot(cursor, tenant="flt-a")
        other, _ = rec.snapshot(cursor, tenant="default")
        return (len(mine), all(m.tenant == "flt-a" for m in mine),
                len(other))

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == (2, True, 1)


# ---------------------------------------------------------------------------
# /healthz tenant section
# ---------------------------------------------------------------------------


def test_healthz_tenant_section_error_isolated(tmp_path, monkeypatch):
    def scenario(P, d):
        doc = P.ops_server.healthz_doc()
        out = [doc["status"], "tenants" in doc,
               "error" not in doc["tenants"]]
        monkeypatch.setattr(
            P.sched.QueryScheduler, "tenant_snapshot",
            lambda self, conf=None: (_ for _ in ()).throw(
                RuntimeError("mid-teardown")))
        try:
            doc = P.ops_server.healthz_doc()
        finally:
            monkeypatch.undo()
        out += [doc["status"], "mid-teardown" in doc["tenants"]["error"],
                all("error" not in doc[s]
                    for s in ("scheduler", "breakers", "flight"))]
        return out

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == ["ok", True, True, "ok", True,
                                          True]


def test_healthz_groups_flight_by_tenant(tmp_path):
    def scenario(P, d):
        sess, data = _sales(P, d)
        df = sess.read_parquet(data).select("key")
        df.collect(tenant="hz-a")
        df.collect(tenant="hz-a")
        doc = P.ops_server.healthz_doc()
        return (doc["flight"]["by_tenant"].get("hz-a", 0) >= 2,
                "hz-a" in doc["tenants"],
                "usage" in doc["tenants"]["hz-a"],
                sorted(doc["tenants"]["hz-a"]))

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"]
    assert got["torch"][:3] == (True, True, True)


# ---------------------------------------------------------------------------
# Prometheus exposition under metric-hostile tenant ids
# ---------------------------------------------------------------------------


def test_prometheus_conformance_hostile_tenant_ids(tmp_path):
    def scenario(P, d):
        reg = P.registry.MetricsRegistry()
        hostile = ['acme corp/eu-1', 'acme"corp"eu 1', 'acme.corp.eu.1',
                   'über-mieter', '1st-tenant', 'tab\ttenant']
        for t in hostile:
            reg.counter(f"tenant.{t}.device.flops").inc(3)
            reg.counter(f"serve.tenant.{t}.admitted").inc()
        text = reg.to_text()
        name_re = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
        families = []
        ok = True
        for line in text.splitlines():
            ok = ok and line == line.strip()
            if line.startswith("# HELP "):
                families.append(line.split()[2])
                continue
            if line.startswith("# TYPE "):
                ok = ok and line.split()[2] == families[-1]
                continue
            ok = ok and bool(name_re.match(line.split("{")[0].split()[0]))
        return (ok, all(name_re.match(f) for f in families),
                len(families) == len(set(families)),
                len(families) == 2 * len(hostile),
                'acme"corp"eu 1' in text, text)

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"]
    assert got["torch"][:5] == (True, True, True, True, True)


# ---------------------------------------------------------------------------
# tenant_snapshot: the serving-side view
# ---------------------------------------------------------------------------


def test_tenant_snapshot_reports_knobs_and_slo(tmp_path):
    def scenario(P, d):
        sch = P.sched.get_scheduler()
        conf = P.conf({
            "spark.hyperspace.serve.slo.p99.seconds": "10",
            "spark.hyperspace.serve.slo.window.seconds": "60",
            "spark.hyperspace.serve.tenant.snap.weight": "3",
            "spark.hyperspace.serve.tenant.snap.hbm.fraction": "0.5",
            "spark.hyperspace.serve.tenant.snap.queue.depth": "4"})
        ent = P.hold(sch, 128, qid="s1", tenant="snap")
        try:
            sch._tenant_slo_for("snap").record(0.5, conf)
            return sch.tenant_snapshot(conf)["snap"]
        finally:
            sch._release(ent)

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"]
    snap = got["torch"]
    assert (snap["admitted_bytes"], snap["inflight"], snap["queued"],
            snap["weight"], snap["hbm_fraction"], snap["queue_depth"]) \
        == (128, 1, 0, 3.0, 0.5, 4)
    assert snap["slo"]["window_queries"] == 1
    assert snap["slo"]["burn_rate"] == 0.0
    assert {P.name for P in PKGS} == {"jax", "torch"}
