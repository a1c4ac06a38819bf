"""The port's inter-query batch lane (`engine/batcher.py`,
`parallel/spmd.batched_predicate_masks`) against the JAX package's:
every scenario of `tests/test_batcher.py` — signature grouping and
declines, snapshot-pin safety, batched vs solo bit-identity for every
supported shape, member metrics, per-member deadlines, the per-query
fallback on a batch-lane failure, a concurrent refresher, the warm-up,
and the chaos run with batching on — through both packages on the same
seeded lake; plus `batched_predicate_masks` against the JAX function
bit for bit on random shapes (hypothesis).

Tests that need a cohort to form deterministically park a pad entry in
the scheduler so the lane's "anything else in flight?" check passes,
and use a wide gather window so staggered threads land in one cohort.
"""

import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401
from hypothesis import given, settings
from hypothesis import strategies as st

from test_batcher import fresh_lane  # noqa: F401  (JAX-side fixture)
from torch_serving import (JAX, PKGS, TORCH, both, canonical,
                           jax_counters_restored, reset_lanes, same_rows, typed)


@pytest.fixture(autouse=True)
def lanes(fresh_lane):  # noqa: F811
    reset_lanes()
    with jax_counters_restored():
        yield
    reset_lanes()


def _batch_lake(d):
    """A fact table with a NULLABLE float column and a nullable string
    column (`tests/test_batcher.py`'s)."""
    rng = np.random.default_rng(3)
    n = 20_000
    facts = d / "facts"
    facts.mkdir(exist_ok=True)
    w = rng.random(n)
    w_valid = rng.random(n) > 0.1
    pq.write_table(pa.table({
        "k": rng.integers(0, 500, n).astype(np.int64),
        "g": rng.integers(0, 32, n).astype(np.int64),
        "v": rng.random(n).astype(np.float64),
        "w": pa.array([float(x) if ok else None
                       for x, ok in zip(w, w_valid)], type=pa.float64()),
        "s": pa.array([f"cat{int(x):02d}" if x < 30 else None
                       for x in rng.integers(0, 33, n)]),
    }), str(facts / "part-0.parquet"))
    return str(facts)


def _session(P, d, **extra):
    conf = {"hyperspace.warehouse.dir": str(d / "wh")}
    conf.update(extra)
    return P.session(conf)


def _run_concurrent(dfs, timeout_for=None):
    results = [None] * len(dfs)
    errors = [None] * len(dfs)

    def run(i):
        try:
            t = timeout_for(i) if timeout_for is not None else None
            results[i] = dfs[i].collect(timeout=t)
        except Exception as exc:
            errors[i] = exc

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(dfs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    assert not any(th.is_alive() for th in threads), "batch lane hung"
    return results, errors


# ---------------------------------------------------------------------------
# Signature parsing
# ---------------------------------------------------------------------------


def _scan(P, root="/tmp/x", pinned=None, index=None):
    S = P.schema
    schema = S.Schema([S.Field("a", "int64"), S.Field("s", "string"),
                       S.Field("f", "float64")])
    return P.nodes.Scan([root], schema, pinned_version=pinned,
                        index_name=index)


def test_signature_shapes_and_declines(tmp_path):
    def scenario(P, d):
        col, lit, N = P.col, P.lit, P.nodes
        sig_of = P.batcher.plan_signature
        s = _scan(P)
        sig = sig_of(N.Project(["a"], N.Filter(
            (col("a") == lit(3)) & (col("f") > lit(0.5)), s)), 1)
        sig2 = sig_of(N.Project(["a"], N.Filter(
            (col("a") == lit(9)) & (col("f") > lit(0.25)), s)), 1)
        sig_in = sig_of(N.Filter(col("a").isin(1, 2, 3), s), 1)
        sig_s = sig_of(N.Filter(col("s") == lit("x"), s), 1)
        sig_sin = sig_of(N.Filter(col("s").isin("x", "y", "z"), s), 1)
        sig_sy = sig_of(N.Filter(col("s") == lit("y"), s), 1)
        declines = [
            sig_of(N.Filter((col("a") == lit(1)) | (col("a") == lit(2)),
                            s), 1),
            sig_of(N.Project([(col("a") + lit(1)).alias("b")],
                             N.Filter(col("a") == lit(1), s)), 1),
            sig_of(s, 1)]
        return [(sig.shape, sig.ints, sig.floats, sig.projection,
                 sig.needed, sig.columns),
                sig2.key == sig.key, sig2.ints,
                (sig_in.shape, sig_in.ints),
                (sig_s.shape, sig_s.ints, sig_s.strs),
                (sig_sin.shape, sig_sin.strs),
                sig_sy.key == sig_s.key,
                declines]

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"]
    t = got["torch"]
    assert t[0][0] == (("cmp", "eq", 0, "i"), ("cmp", "gt", 1, "f"))
    assert t[1] is True and t[3] == ((("in", 0, 4),), [1, 2, 3, 3])
    assert t[7] == [None, None, None]


def test_signature_never_mixes_index_versions(tmp_path):
    def scenario(P, d):
        col, lit, N = P.col, P.lit, P.nodes
        sig_of = P.batcher.plan_signature
        base = N.Filter(col("a") == lit(1),
                        _scan(P, "/w/idx/v__=0", 0, "idx"))
        newer = N.Filter(col("a") == lit(1),
                         _scan(P, "/w/idx/v__=1", 1, "idx"))
        k0 = sig_of(base, 1).key
        return (k0 != sig_of(newer, 1).key, sig_of(base, 2).key != k0)

    got = both(scenario, tmp_path)
    assert got["torch"] == got["jax"] == (True, True)


# ---------------------------------------------------------------------------
# Bit-identity: batched vs solo, for every supported shape
# ---------------------------------------------------------------------------


def _shape_mix(P, facts):
    col, lit = P.col, P.lit
    return (
        [facts.filter(col("g") == lit(i)).select("k", "g", "v")
         for i in range(6)]
        + [facts.filter((col("v") > lit(lo)) & (col("v") <= lit(lo + .2)))
           .select("k", "v") for lo in (0.1, 0.6)]
        + [facts.filter(col("g").isin(2, 12, 22)).select("k", "g"),
           facts.filter(col("g").isin(5, 15, 25)).select("k", "g")]
        + [facts.filter((col("w") > lit(0.5)) & col("w").is_not_null())
           .select("k", "w"),
           facts.filter((col("w") > lit(0.2)) & col("w").is_not_null())
           .select("k", "w")]
        + [facts.filter(col("s") == lit(v)).select("k", "s")
           for v in ("cat03", "cat11", "no-such-value")]
        + [facts.filter(col("s").isin("cat01", "cat02", "cat29"))
           .select("k", "s"),
           facts.filter(col("s").isin("cat05", "zzz")).select("k", "s")])


@pytest.mark.parametrize("lane", ["host", "device"])
def test_batched_results_bit_identical_to_solo(tmp_path, lane):
    """Both lanes of the port: the host lane (numpy columns, masks
    evaluated with torch on the CPU) and the torch lane
    (`min.device.rows=0`: columns are tensors and every member's
    `nonzero` and gather run on the tensors' device)."""
    def scenario(P, d):
        extra = {"spark.hyperspace.serve.batch.window.ms": 250}
        if lane == "device" and P is TORCH:
            extra["spark.hyperspace.execution.min.device.rows"] = 0
        sess = _session(P, d, **extra)
        facts = sess.read_parquet(_batch_lake(d))
        dfs = _shape_mix(P, facts)
        expected = [df.collect() for df in dfs]
        inv0 = P.counter("serve.batch.invocations")
        m0 = P.counter("serve.batch.members")
        sch = P.sched.get_scheduler()
        pad = P.hold(sch, 0, qid="pad")
        try:
            results, errors = _run_concurrent(dfs)
        finally:
            sch._release(pad)
        assert not any(errors), [repr(e) for e in errors if e]
        for r, e in zip(results, expected):
            assert same_rows(r, e)
        return {"results": results,
                "invocations": P.counter("serve.batch.invocations") - inv0,
                "members": P.counter("serve.batch.members") - m0}

    got = both(scenario, tmp_path)
    for a, b in zip(got["torch"]["results"], got["jax"]["results"]):
        assert same_rows(a, b)
    for P in PKGS:
        assert got[P.name]["invocations"] > 0
        assert got[P.name]["members"] >= 2


def test_member_metrics_carry_cohort_and_operator(tmp_path):
    def scenario(P, d):
        sess = _session(P, d, **{
            "spark.hyperspace.serve.batch.window.ms": 250})
        facts = sess.read_parquet(_batch_lake(d))
        dfs = [facts.filter(P.col("g") == P.lit(i)).select("k", "v")
               for i in range(4)]
        for df in dfs:
            df.collect()
        collected = {}
        lock = threading.Lock()

        def run(i):
            table, m = dfs[i].collect(with_metrics=True)
            with lock:
                collected[i] = (table, m)

        sch = P.sched.get_scheduler()
        pad = P.hold(sch, 0, qid="pad")
        try:
            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(60)
        finally:
            sch._release(pad)
        batched = [m for _t, m in collected.values()
                   if m.events_of("serve", "batched")]
        checks = []
        for m in batched:
            ev = m.events_of("serve", "batched")[-1]
            ok = ev["cohort"] >= 2 and m.cohort["size"] == ev["cohort"]
            if not ev["leader"]:
                ops = [o for o in m.operators if o.name == "BatchedQuery"]
                ok = ok and bool(ops) and ops[-1].rows_out is not None \
                    and ops[-1].detail["cohort"] == ev["cohort"]
            checks.append(ok)
        return ([collected[i][0] for i in range(4)], bool(batched),
                all(checks))

    got = both(scenario, tmp_path)
    for a, b in zip(got["torch"][0], got["jax"][0]):
        assert same_rows(a, b)
    assert got["torch"][1:] == got["jax"][1:] == (True, True)


# ---------------------------------------------------------------------------
# Per-member deadline: a cancelled member drops its slice, not the batch
# ---------------------------------------------------------------------------


def test_member_deadline_cancels_only_its_slice(tmp_path):
    def scenario(P, d):
        sess = _session(P, d, **{
            "spark.hyperspace.serve.batch.window.ms": 700})
        facts = sess.read_parquet(_batch_lake(d))
        col, lit = P.col, P.lit
        dfs = {tag: facts.filter(col("g") == lit(i)).select("k", "v")
               for tag, i in (("leader", 1), ("doomed", 2), ("other", 3))}
        oracles = {tag: df.collect() for tag, df in dfs.items()}
        outcome = {}
        lock = threading.Lock()

        def run(tag, timeout=None, delay=0.0):
            time.sleep(delay)
            try:
                table = dfs[tag].collect(timeout=timeout)
            except Exception as exc:
                table = exc
            with lock:
                outcome[tag] = table

        sch = P.sched.get_scheduler()
        pad = P.hold(sch, 0, qid="pad")
        try:
            threads = [
                threading.Thread(target=run, args=("leader",)),
                threading.Thread(target=run, args=("doomed", 0.15, 0.1)),
                threading.Thread(target=run, args=("other", None, 0.2))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(60)
            assert not any(th.is_alive() for th in threads)
        finally:
            sch._release(pad)
        doomed = outcome["doomed"]
        assert same_rows(outcome["leader"], oracles["leader"])
        assert same_rows(outcome["other"], oracles["other"])
        return (typed(doomed), getattr(doomed, "phase", None),
                outcome["leader"], outcome["other"])

    got = both(scenario, tmp_path)
    j, t = got["jax"], got["torch"]
    assert t[:2] == j[:2] == ("QueryDeadlineExceededError", "batch")
    assert same_rows(t[2], j[2]) and same_rows(t[3], j[3])


# ---------------------------------------------------------------------------
# Batch-lane failure: per-query fallback, never a cohort failure
# ---------------------------------------------------------------------------


def test_batch_lane_failure_falls_back_per_query(tmp_path):
    def scenario(P, d):
        sess = _session(P, d, **{
            "spark.hyperspace.serve.batch.window.ms": 250})
        facts = sess.read_parquet(_batch_lake(d))
        dfs = [facts.filter(P.col("g") == P.lit(i)).select("k", "v")
               for i in range(4)]
        expected = [df.collect() for df in dfs]
        P.arm(P.rule("batch.execute", kind="transient", nth=1, times=-1))
        fb0 = P.counter("serve.batch.fallbacks")
        sch = P.sched.get_scheduler()
        pad = P.hold(sch, 0, qid="pad")
        try:
            results, errors = _run_concurrent(dfs)
        finally:
            sch._release(pad)
            P.faults.uninstall()
        assert not any(errors), [repr(e) for e in errors if e]
        for r, e in zip(results, expected):
            assert same_rows(r, e)
        return results, P.counter("serve.batch.fallbacks") - fb0 >= 2

    got = both(scenario, tmp_path)
    for a, b in zip(got["torch"][0], got["jax"][0]):
        assert same_rows(a, b)
    assert got["torch"][1] and got["jax"][1]


# ---------------------------------------------------------------------------
# Snapshot-pin safety, end to end, vs a concurrent refresher
# ---------------------------------------------------------------------------


def test_concurrent_refresher_never_breaks_batched_reads(tmp_path):
    def scenario(P, d):
        rng = np.random.default_rng(11)
        src = d / "src"
        src.mkdir()
        pq.write_table(pa.table({
            "k": rng.integers(0, 50, 6000).astype(np.int64),
            "x": rng.random(6000).astype(np.float64),
        }), str(src / "part-0.parquet"))
        sess = P.session({
            "hyperspace.warehouse.dir": str(d / "wh"),
            "hyperspace.index.num.buckets": "4",
            "spark.hyperspace.serve.batch.window.ms": 100})
        hs = P.Hyperspace(sess)
        df = sess.read_parquet(str(src))
        hs.create_index(df, P.IndexConfig("bidx", ["k"], ["x"]))
        sess.enable_hyperspace()
        queries = [df.filter(P.col("k") == P.lit(i)).select("x")
                   for i in range(8)]
        oracles = [canonical(q.collect()) for q in queries]
        sig = P.batcher.plan_signature(sess.optimize(queries[0].plan),
                                       id(sess))
        pinned = (sig is not None and sig.scan.index_name == "bidx"
                  and sig.scan.pinned_version is not None)
        stop = threading.Event()
        failures = []

        def serve_loop(qi):
            while not stop.is_set():
                try:
                    got = canonical(queries[qi].collect())
                    if not got.equals(oracles[qi]):
                        failures.append(f"q{qi}: mismatch")
                except Exception as exc:
                    failures.append(f"q{qi}: {exc!r}")

        threads = [threading.Thread(target=serve_loop, args=(i,))
                   for i in range(4)]
        for th in threads:
            th.start()
        try:
            hs.refresh_index("bidx", mode="full")
            time.sleep(0.3)
        finally:
            stop.set()
            for th in threads:
                th.join(60)
        return pinned, failures[:5], oracles

    got = both(scenario, tmp_path)
    assert got["torch"][:2] == got["jax"][:2] == (True, [])
    for a, b in zip(got["torch"][2], got["jax"][2]):
        assert same_rows(a, b)


# ---------------------------------------------------------------------------
# Warm-up
# ---------------------------------------------------------------------------


def test_aot_warmup_makes_first_cohorts_trace_free(tmp_path):
    """The JAX package primes jit executables; the port's warm-up is one
    real dispatch per cohort bucket (no executable to build). Both
    count `compile.aot.warmups` per bucket, a memo hit for the same
    signature, and no build during the warmed cohorts."""
    def scenario(P, d):
        rng = np.random.default_rng(7)
        src = d / "aotsrc"
        src.mkdir()
        pq.write_table(pa.table({
            "a": rng.integers(0, 9, 7777).astype(np.int64),
            "b": rng.integers(0, 99, 7777).astype(np.int64),
            "c": rng.random(7777).astype(np.float64),
        }), str(src / "part-0.parquet"))
        sess = P.session({"hyperspace.warehouse.dir": str(d / "wh"),
                          "spark.hyperspace.serve.batch.window.ms": 250})
        t = sess.read_parquet(str(src))
        col, lit = P.col, P.lit
        dfs = [t.filter((col("a") == lit(i)) & (col("b") >= lit(10))
                        & (col("c") < lit(0.9))).select("a", "c")
               for i in range(5)]
        w0 = P.counter("compile.aot.warmups")
        e0 = P.counter("compile.aot.errors")
        primed = P.batcher.warmup(dfs[0])
        again = P.batcher.warmup(dfs[1])
        warmups = P.counter("compile.aot.warmups") - w0
        expected = [df.collect() for df in dfs]
        traces0 = P.counter("compile.serve.batch.traces")
        builds0 = P.counter("compile.traces")
        inv0 = P.counter("serve.batch.invocations")
        sch = P.sched.get_scheduler()
        pad = P.hold(sch, 0, qid="pad")
        try:
            results, errors = _run_concurrent(dfs)
        finally:
            sch._release(pad)
        assert not any(errors), [repr(e) for e in errors if e]
        for r, e in zip(results, expected):
            assert same_rows(r, e)
        out = {"primed": primed, "again": again, "warmups": warmups,
               "invoked": P.counter("serve.batch.invocations") > inv0,
               "traces": P.counter("compile.serve.batch.traces")
               - traces0,
               "errors": P.counter("compile.aot.errors") - e0,
               "results": results}
        if P is TORCH:
            out["builds"] = P.counter("compile.traces") - builds0
        return out

    got = both(scenario, tmp_path)
    j, t = got["jax"], got["torch"]
    for k in ("primed", "again", "warmups", "invoked", "traces"):
        assert t[k] == j[k], k
    assert t["primed"] >= 2 and t["again"] == 0 and t["traces"] == 0
    assert t["builds"] == 0 and t["errors"] == 0
    for a, b in zip(t["results"], j["results"]):
        assert same_rows(a, b)


# ---------------------------------------------------------------------------
# The chaos harness, batching ON
# ---------------------------------------------------------------------------


def test_chaos_with_batching_on(tmp_path):
    def scenario(P, d):
        sess = _session(P, d, **{"spark.hyperspace.serve.queue.depth": 16})
        facts = sess.read_parquet(_batch_lake(d))
        col, lit = P.col, P.lit
        workload = (
            [(f"point{i}", facts.filter(col("g") == lit(i))
              .select("k", "g", "v")) for i in range(5)]
            + [("range", facts.filter((col("v") > lit(0.8))
                                      & (col("v") <= lit(0.9)))
                .select("k", "v")),
               ("inq", facts.filter(col("g").isin(7, 17, 27))
                .select("k", "g")),
               ("agg", facts.group_by("g").agg(("sum", "v", "total")))])
        expected = {name: canonical(df.collect()) for name, df in workload}
        names = ("serve.rejected", "serve.deadline_exceeded",
                 "serve.cancelled", "serve.batch.invocations",
                 "serve.batch.members")
        c0 = P.counters(*names)
        report = P.run_chaos(
            workload, expected, clients=8, total_queries=240,
            timeout_for=lambda i: 0.002 if i % 11 == 0 else None,
            join_timeout_s=300.0)
        c1 = P.counters(*names)
        return {"report": report, "expected": expected,
                "delta": {k: c1[k] - c0[k] for k in names},
                "admitted": P.sched.get_scheduler().admitted_bytes()}

    got = both(scenario, tmp_path)
    for name, table in got["torch"]["expected"].items():
        assert same_rows(table, got["jax"]["expected"][name]), name
    for P in PKGS:
        r = got[P.name]
        report, delta = r["report"], r["delta"]
        assert not report.stuck_threads, report.summary()
        assert report.total == 240
        assert report.outcomes["error"] == 0, report.errors[:5]
        assert not report.mismatches, report.mismatches[:5]
        assert report.outcomes["ok"] >= 120, report.summary()
        assert delta["serve.rejected"] == report.outcomes["rejected"]
        assert delta["serve.deadline_exceeded"] \
            == report.outcomes["deadline"]
        assert delta["serve.cancelled"] == report.outcomes["cancelled"]
        assert all(p in ("queue", "plan", "scan", "operator", "stage",
                         "transfer", "write", "batch", "cache.fill")
                   for p in report.typed_phases)
        assert delta["serve.batch.invocations"] > 0
        assert delta["serve.batch.members"] \
            >= 2 * delta["serve.batch.invocations"]
        assert r["admitted"] == 0


# ---------------------------------------------------------------------------
# batched_predicate_masks against the JAX function, bit for bit
# ---------------------------------------------------------------------------

_OPS = ("eq", "ne", "lt", "le", "gt", "ge")
_DTYPES = ("int32", "int64", "float32", "float64")


@st.composite
def _programs(draw):
    n = draw(st.integers(1, 64))
    kb = draw(st.sampled_from([1, 2, 4, 8]))
    n_cols = draw(st.integers(1, 3))
    seed = draw(st.integers(0, 2 ** 31 - 1))
    rng = np.random.default_rng(seed)
    dtypes = [draw(st.sampled_from(_DTYPES)) for _ in range(n_cols)]
    datas, valids = [], []
    for dt in dtypes:
        if dt.startswith("int"):
            data = rng.integers(-6, 6, n).astype(dt)
        else:
            data = (rng.integers(-6, 6, n) / 4.0).astype(dt)
            data[rng.random(n) < 0.1] = np.nan
        datas.append(data)
        valids.append(rng.random(n) > 0.2 if draw(st.booleans()) else None)
    shape, ints, floats = [], [], []
    for _ in range(draw(st.integers(1, 4))):
        ci = draw(st.integers(0, n_cols - 1))
        kind = draw(st.sampled_from(["cmp", "cmp", "in", "isnull",
                                     "notnull"]))
        if kind == "cmp":
            lane = draw(st.sampled_from(["i", "f"]))
            shape.append(("cmp", draw(st.sampled_from(_OPS)), ci, lane))
            if lane == "i":
                ints.append([int(x) for x in rng.integers(-6, 6, kb)])
            else:
                floats.append([float(x) for x in
                               rng.integers(-24, 24, kb) / 8.0 + 0.1])
        elif kind == "in":
            if dtypes[ci].startswith("float"):
                continue  # the batch lane's IN is integer-only
            padded = draw(st.sampled_from([1, 2, 4]))
            shape.append(("in", ci, padded))
            for _ in range(padded):
                ints.append([int(x) for x in rng.integers(-6, 6, kb)])
        else:
            shape.append((kind, ci))
    if not shape:
        shape.append(("isnull", 0))
    iconst = (np.array(ints, dtype=np.int64).T.copy() if ints
              else np.zeros((kb, 0), dtype=np.int64))
    fconst = (np.array(floats, dtype=np.float64).T.copy() if floats
              else np.zeros((kb, 0), dtype=np.float64))
    return tuple(shape), tuple(datas), tuple(valids), iconst, fconst


@settings(max_examples=60, deadline=None)
@given(_programs())
def test_batched_predicate_masks_equal_jax_bit_for_bit(program):
    from hyperspace_tpu.parallel import spmd as jspmd

    from hyperspace_tpu_torch.parallel import spmd

    shape, datas, valids, iconst, fconst = program
    want = np.asarray(jspmd.batched_predicate_masks(
        shape, datas, valids, iconst, fconst))
    got = spmd.batched_predicate_masks(shape, datas, valids, iconst,
                                       fconst).numpy()
    assert got.dtype == np.bool_ and got.shape == want.shape
    assert np.array_equal(got, want)


def test_batched_predicate_masks_on_tensors_equal_numpy_inputs():
    """The device lane hands the function tensors; the result equals
    the host lane's (numpy inputs) on the same values."""
    import torch

    from hyperspace_tpu_torch.parallel import spmd

    rng = np.random.default_rng(5)
    data = rng.random(100)
    valid = rng.random(100) > 0.3
    shape = (("cmp", "gt", 0, "f"), ("notnull", 0))
    fconst = np.array([[0.2], [0.5], [0.8], [0.9]])
    iconst = np.zeros((4, 0), dtype=np.int64)
    host = spmd.batched_predicate_masks(shape, (data,), (valid,), iconst,
                                        fconst)
    dev = spmd.batched_predicate_masks(
        shape, (torch.from_numpy(data),), (torch.from_numpy(valid),),
        iconst, fconst)
    assert torch.equal(host, dev)
    assert host.shape == (4, 100)
    assert typed(None) is None
