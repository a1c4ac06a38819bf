"""Whole-stage fusion through both packages, on the CPU.

Every case of `tests/test_fusion.py` runs through `hyperspace_tpu` and
`hyperspace_tpu_torch` on the same seeded lake (the port on torch CPU
tensors, `min.device.rows = 0` forcing the masked lane), and each
package's fused result must equal its own eager result and the other
package's:

- the broadcast hash join for inner, left_outer, left_semi, left_anti;
- the plan shows `FusedStage` (explain does not), and a rebuilt plan
  reuses the stage program (no new program-key miss);
- expression projection, CASE, IN and LIKE;
- the host lane (default `min.device.rows`) equal to eager;
- string join keys falling back to the eager graph;
- build-side columns deferred until after compaction.

Added for the port: seeded random Filter/Project/BHJ chains against the
JAX fused result and the port with fusion off; `fusion_lanes` equal to
the JAX package's for the same queries; the `fusion.stage` fault seam
and a deadline at the stage checkpoint; the module caches under
concurrent threads. Integers and strings compare exactly, float64 at
rtol 1e-9.
"""

import sys
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

# The suite runs in parallel worker processes; one torch thread per worker
# keeps torch's spinning OpenMP pool from starving the other workers.
torch.set_num_threads(1)

from torch_serving import JAX, PKGS, TORCH, canonical, same_table  # noqa: E402
from torch_suites import jax_counters_guard  # noqa: E402,F401

from hyperspace_tpu_torch.engine import fusion  # noqa: E402

RTOL = 1e-9
FUSION_OFF = {"spark.hyperspace.execution.fusion.enabled": "false"}


def _same(a, b) -> bool:
    return same_table(canonical(a), canonical(b), rtol=RTOL)


def _reset_program_caches():
    """Both packages' stage-program caches emptied the way the JAX
    package retires its own (metadata and executables together): the
    JAX package runs a program whose executable outlived its metadata
    eagerly (`metadata-evicted`), so a cleared `_OUT_META` alone would
    make its lanes depend on which tests ran before in the process."""
    from hyperspace_tpu.engine import fusion as jfusion

    jfusion._OUT_META.clear()
    if jfusion._run_stage_jit is not None:
        jfusion._run_stage_jit.clear_cache()
    with fusion._lock:
        fusion._OUT_META.clear()


@pytest.fixture(autouse=True)
def fresh_programs():
    _reset_program_caches()
    yield


@pytest.fixture
def env(tmp_path):
    """Two tables: a fact and a small dimension with nulls, strings, and
    keys the fact sometimes misses (`tests/test_fusion.py`'s lake)."""
    rng = np.random.default_rng(3)
    n = 5000
    fact_dir, dim_dir = tmp_path / "fact", tmp_path / "dim"
    fact_dir.mkdir()
    dim_dir.mkdir()
    pq.write_table(pa.table({
        "k": rng.integers(0, 60, n).astype(np.int64),  # dim has 0..49
        "v": rng.random(n),
        "grp": pa.array([f"g{int(x)}" for x in rng.integers(0, 7, n)]),
    }), str(fact_dir / "part-0.parquet"))
    pq.write_table(pa.table({
        "k": np.arange(50, dtype=np.int64),
        "name": pa.array([None if i % 13 == 0 else f"name_{i}"
                          for i in range(50)]),
        "w": np.arange(50, dtype=np.int64) * 10,
    }), str(dim_dir / "part-0.parquet"))

    def session(P, **extra):
        conf = {"hyperspace.warehouse.dir": str(tmp_path / f"wh_{P.name}"),
                "spark.hyperspace.execution.min.device.rows": "0",
                "spark.hyperspace.distribution.enabled": "false"}
        conf.update(extra)
        return P.session(conf)

    return session, str(fact_dir), str(dim_dir)


def run_query(P, sess, fact, dim, how):
    col, lit = P.col, P.lit
    fdf = sess.read_parquet(fact)
    ddf = sess.read_parquet(dim)
    q = (fdf.filter(col("k") > lit(5))
         .join(ddf.filter(col("w") < lit(400)), on=col("k") == col("k"),
               how=how))
    if how in ("left_semi", "left_anti"):
        q = q.select("k", "v")
    else:
        q = q.select("k", "v", "name", "w")
    return q.collect()


@pytest.mark.parametrize("how", ["inner", "left_outer", "left_semi",
                                 "left_anti"])
def test_fused_broadcast_join_matches_eager(env, how):
    session, fact, dim = env
    out = {}
    for P in PKGS:
        fused = run_query(P, session(P), fact, dim, how)
        eager = run_query(P, session(P, **FUSION_OFF), fact, dim, how)
        assert _same(fused, eager), P
        assert fused.num_rows > 0
        out[P.name] = fused
    assert _same(out["torch"], out["jax"])


def test_fused_plan_shows_stage_and_reuses_program(env):
    session, fact, dim = env
    sess = session(TORCH)
    col, lit = TORCH.col, TORCH.lit

    def q():
        fdf = sess.read_parquet(fact)
        ddf = sess.read_parquet(dim)
        return (fdf.filter(col("k") > lit(5))
                .join(ddf, on=col("k") == col("k"))
                .select("v", "name"))

    from hyperspace_tpu_torch.engine.executor import compile_plan
    text = compile_plan(q()._optimized_plan(), conf=sess.conf).tree_string()
    assert "FusedStage" in text and "BroadcastHashJoin" in text
    # explain stays at the operator level (display contract).
    assert "FusedStage" not in q().explain_plans()[2].tree_string()

    first = q().collect()
    misses = fusion.STATS["trace_misses"]
    execs = fusion.STATS["stage_execs"]
    # A REBUILT plan (fresh physical nodes) hits the same program: the
    # program key, not object identity, is the cache key.
    again = q().collect()
    assert fusion.STATS["trace_misses"] == misses
    assert fusion.STATS["stage_execs"] > execs
    assert _same(first, again)
    m = sess.last_query_metrics()
    assert m.counters.get("fusion.stage_execs", 0) >= 1
    assert "fusion.trace_misses" not in m.counters


def test_fused_expression_projection_and_case(env):
    """Computed projections + CASE + IN + LIKE through the fused lane."""
    session, fact, dim = env

    def build(P, sess):
        col, lit = P.col, P.lit
        fdf = sess.read_parquet(fact)
        q = (fdf.filter(col("grp").like("g%")
                        & col("k").isin(*range(4, 40)))
             .with_column("bonus", P.expr.CaseWhen(
                 [(col("k") > lit(30), col("v") * lit(2.0))],
                 col("v")))
             .select("k", "bonus"))
        return q.collect()

    out = {}
    for P in PKGS:
        fused = build(P, session(P))
        assert _same(fused, build(P, session(P, **FUSION_OFF))), P
        assert fused.num_rows > 0
        out[P.name] = fused
    assert _same(out["torch"], out["jax"])


def test_host_lane_matches_eager(env):
    """With sources on the host lane, stages route to the eager operator
    graph and must agree with fusion disabled."""
    session, fact, dim = env
    host = {"spark.hyperspace.execution.min.device.rows": str(1 << 30)}
    out = {}
    for P in PKGS:
        sess = session(P, **host)
        fused = run_query(P, sess, fact, dim, "inner")
        assert sess.last_query_metrics().summary()["fusion_lanes"] == {
            "eager-host": 2}
        eager = run_query(P, session(P, **host, **FUSION_OFF), fact, dim,
                          "inner")
        assert _same(fused, eager), P
        out[P.name] = fused
    assert _same(out["torch"], out["jax"])


def test_fusion_falls_back_on_string_join_keys(tmp_path):
    """String join keys are ineligible for the direct-address table; the
    fused stage falls back to the eager graph and is still right."""
    rng = np.random.default_rng(5)
    n = 2000
    a_dir, b_dir = tmp_path / "a", tmp_path / "b"
    a_dir.mkdir(), b_dir.mkdir()
    pq.write_table(pa.table({
        "s": pa.array([f"k{int(x)}" for x in rng.integers(0, 30, n)]),
        "v": rng.random(n)}), str(a_dir / "p.parquet"))
    pq.write_table(pa.table({
        "s": pa.array([f"k{i}" for i in range(30)]),
        "w": np.arange(30, dtype=np.int64)}), str(b_dir / "p.parquet"))

    def run(P, fusion_on):
        sess = P.session({
            "hyperspace.warehouse.dir": str(tmp_path / f"wh_{P.name}"),
            "spark.hyperspace.execution.min.device.rows": "0",
            "spark.hyperspace.distribution.enabled": "false",
            "spark.hyperspace.execution.fusion.enabled":
                "true" if fusion_on else "false",
            # Force the broadcast planner path despite string keys.
            "spark.hyperspace.broadcast.threshold": str(1 << 20)})
        adf = sess.read_parquet(str(a_dir))
        bdf = sess.read_parquet(str(b_dir))
        out = (adf.join(bdf, on=P.col("s") == P.col("s"))
               .select("v", "w").collect())
        return out, sess.last_query_metrics()

    out, lanes = {}, {}
    for P in PKGS:
        fused, m = run(P, True)
        assert _same(fused, run(P, False)[0]), P
        out[P.name] = fused
        lanes[P.name] = [(e.get("lane"), e.get("trigger"))
                         for e in m.events_of("fusion", "lane")]
    assert _same(out["torch"], out["jax"])
    # The same eligibility trigger sends both packages' stage eager.
    assert lanes["torch"] == lanes["jax"]
    assert ("eager", "broadcast-prep-declined") in lanes["torch"]


def test_build_columns_defer_to_post_compaction(env):
    """Carried build-side columns leave the stage DEFERRED (only their
    join's hit/matched pair) and still decode to the exact eager values —
    strings with nulls included — with the JAX package's lazy specs."""
    from hyperspace_tpu.engine import fusion as jfusion

    session, fact, dim = env
    out, lazy = {}, {}
    for P, mod in ((JAX, jfusion), (TORCH, fusion)):
        _reset_program_caches()
        out[P.name] = run_query(P, session(P), fact, dim, "left_outer")
        lazy[P.name] = {spec[0] for meta in mod._OUT_META.values()
                        for spec in meta[3]}
        assert {"name", "w"} <= lazy[P.name], (P, lazy[P.name])
        want = run_query(P, session(P, **FUSION_OFF), fact, dim,
                         "left_outer")
        assert _same(out[P.name], want), P
    assert lazy["torch"] == lazy["jax"]
    assert _same(out["torch"], out["jax"])


def test_deferred_gather_runs_at_selection_size(env, monkeypatch):
    """The deferred gather is composed with the compaction index: it
    gathers as many rows as the stage keeps, never the full probe."""
    session, fact, dim = env
    sizes = []
    gather = fusion._gather_build

    def spy(src_data, src_validity, hit, matched):
        sizes.append(int(hit.numel()))
        return gather(src_data, src_validity, hit, matched)

    monkeypatch.setattr(fusion, "_gather_build", spy)
    got = run_query(TORCH, session(TORCH), fact, dim, "inner")
    probe_rows = 5000
    # name and w, each gathered once, at the kept row count.
    assert sizes == [got.num_rows, got.num_rows]
    assert got.num_rows < probe_rows


# ---------------------------------------------------------------------------
# Seeded random Filter/Project/BHJ chains on the torch lane
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chain_lake(tmp_path_factory):
    root = tmp_path_factory.mktemp("chain")
    rng = np.random.default_rng(41)
    n = 6000
    fact_dir, dim_dir, dim2_dir = root / "f", root / "d", root / "d2"
    for d in (fact_dir, dim_dir, dim2_dir):
        d.mkdir()
    null = rng.random(n) < 0.1
    pq.write_table(pa.table({
        "k": rng.integers(0, 90, n).astype(np.int64),
        "j": rng.integers(0, 20, n).astype(np.int32),
        "a": pa.array(rng.integers(-50, 50, n).astype(np.int32), mask=null),
        "v": rng.normal(size=n),
        "g": pa.array([f"g{int(x)}" for x in rng.integers(0, 9, n)]),
    }), str(fact_dir / "part-0.parquet"))
    pq.write_table(pa.table({
        "k": np.arange(0, 80, dtype=np.int64),
        "w": pa.array(rng.normal(size=80), mask=np.arange(80) % 11 == 0),
        "name": pa.array([None if i % 7 == 0 else f"n{i % 13}"
                          for i in range(80)]),
    }), str(dim_dir / "part-0.parquet"))
    pq.write_table(pa.table({
        "j": np.arange(0, 15, dtype=np.int32),
        "z": rng.integers(0, 1000, 15).astype(np.int64),
    }), str(dim2_dir / "part-0.parquet"))
    return root, str(fact_dir), str(dim_dir), str(dim2_dir)


def _random_chain(P, sess, lake, seed):
    """One random Filter/Project/BHJ chain, the same for both packages."""
    root, fact, dim, dim2 = lake
    rng = np.random.default_rng(seed)
    col, lit = P.col, P.lit
    f = sess.read_parquet(fact)
    d = sess.read_parquet(dim)
    d2 = sess.read_parquet(dim2)
    preds = [col("k") > lit(int(rng.integers(0, 40))),
             col("a") < lit(int(rng.integers(-20, 40))),
             col("v") > lit(float(rng.normal())),
             col("g").isin("g1", "g3", "g5"),
             col("a").is_null() | (col("j") != lit(3))]
    picks = rng.choice(len(preds), size=int(rng.integers(1, 3)),
                       replace=False)
    q = f
    for i in picks:
        q = q.filter(preds[int(i)])
    q = q.with_column("ak", col("a") * lit(3) + col("k"))
    how = ["inner", "left_outer", "left_semi", "left_anti"][
        int(rng.integers(0, 4))]
    q = q.join(d.filter(col("k") < lit(int(rng.integers(40, 80)))),
               on=col("k") == col("k"), how=how)
    if how in ("left_semi", "left_anti"):
        q = q.select("k", "j", "ak", "v", "g")
        keep = ["k", "j", "ak", "v", "g"]
    else:
        q = q.filter(col("v") < lit(float(rng.normal() + 1.0)))
        q = q.with_column("vw", P.expr.CaseWhen(
            [(col("w") > lit(0.0), col("v") * col("w"))], col("v")))
        keep = ["k", "j", "ak", "vw", "name"]
        q = q.select(*keep)
    if rng.random() < 0.5:
        q = q.join(d2, on=col("j") == col("j"), how="inner")
        keep = keep + ["z"]
    return q.select(*keep).collect()


@pytest.mark.parametrize("seed", range(8))
def test_random_chain_equals_jax_and_unfused(chain_lake, seed):
    root = chain_lake[0]

    def sess(P, **extra):
        conf = {"hyperspace.warehouse.dir": str(root / f"wh_{P.name}"),
                "spark.hyperspace.execution.min.device.rows": "0",
                "spark.hyperspace.distribution.enabled": "false"}
        conf.update(extra)
        return P.session(conf)

    port_sess = sess(TORCH)
    fused = _random_chain(TORCH, port_sess, chain_lake, seed)
    lanes = port_sess.last_query_metrics().summary()["fusion_lanes"]
    assert lanes.get("masked-device", 0) >= 1, lanes
    unfused = _random_chain(TORCH, sess(TORCH, **FUSION_OFF), chain_lake,
                            seed)
    want = _random_chain(JAX, sess(JAX), chain_lake, seed)
    assert _same(fused, unfused)
    assert _same(fused, want)


# ---------------------------------------------------------------------------
# fusion_lanes parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["inner", "left_anti", "host", "project"])
def test_fusion_lanes_equal_the_jax_packages(env, case):
    session, fact, dim = env
    extra = ({"spark.hyperspace.execution.min.device.rows": str(1 << 30)}
             if case == "host" else {})
    lanes = {}
    for P in PKGS:
        sess = session(P, **extra)
        if case == "project":
            sess.read_parquet(fact).filter(P.col("v") > P.lit(0.5)) \
                .select("k").collect()
        else:
            run_query(P, sess, fact, dim,
                      "inner" if case == "host" else case)
        lanes[P.name] = sess.last_query_metrics().summary()["fusion_lanes"]
    assert lanes["torch"] == lanes["jax"]
    assert lanes["torch"]


# ---------------------------------------------------------------------------
# Fault seam and deadline checkpoint
# ---------------------------------------------------------------------------


def test_fusion_stage_fault_seam(env):
    session, fact, dim = env
    out = {}
    for P in PKGS:
        sess = session(P)
        injector = P.faults.FaultInjector([P.faults.FaultRule(
            "fusion.stage", kind="permanent")])
        P.faults.install(injector)
        try:
            with pytest.raises(P.faults.InjectedPermanentError):
                run_query(P, sess, fact, dim, "inner")
        finally:
            P.faults.uninstall()
        out[P.name] = injector.fired("fusion.stage")
        # The seam clears: the next run answers.
        assert run_query(P, sess, fact, dim, "inner").num_rows > 0
    assert out["torch"] == out["jax"] == 1


def test_deadline_at_the_stage_checkpoint(env):
    """A deadline that passes at stage entry interrupts the query at the
    `stage` checkpoint, typed, in both packages."""
    session, fact, dim = env
    phases = {}
    for P in PKGS:
        sess = session(P)

        class Sleeper(P.faults.FaultInjector):
            def check(self, operation, path=None):
                if operation == "fusion.stage":
                    time.sleep(0.3)
                return None

        df = sess.read_parquet(fact).filter(P.col("k") > P.lit(5)) \
            .select("k", "v")
        df.collect()  # warm: reads and plans cost nothing below
        P.faults.install(Sleeper())
        try:
            with pytest.raises(P.exc.QueryDeadlineExceededError) as info:
                df.collect(timeout=0.2)
        finally:
            P.faults.uninstall()
        phases[P.name] = info.value.phase
    assert phases["torch"] == phases["jax"] == "stage"


# ---------------------------------------------------------------------------
# The module caches under concurrent threads
# ---------------------------------------------------------------------------


def test_caches_evict_under_concurrent_threads(env, monkeypatch):
    """Eight threads insert into, evict from and look up the promotion
    and broadcast caches (tiny budgets force eviction on every insert)
    and reset the program cache, while fused queries run: nothing
    raises, results stay right, and held bytes stay within budget."""
    session, fact, dim = env
    monkeypatch.setattr(fusion, "_OUT_META_MAX", 2)
    sess = session(TORCH, **{
        "spark.hyperspace.fusion.cache.promote.bytes": "4096",
        "spark.hyperspace.fusion.cache.broadcast.bytes": "512"})
    want = run_query(TORCH, session(TORCH, **FUSION_OFF), fact, dim,
                     "inner")
    fusion._configure_cache_budgets(sess.conf)
    cpu = torch.device("cpu")
    errors = []
    held = []

    def churn(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(60):
                arr = rng.integers(0, 100, int(rng.integers(8, 400)))
                out = fusion._to_device(arr, cpu)
                assert torch.equal(out, torch.from_numpy(arr))
                fusion._token_of(arr)
                with fusion._lock:
                    held.append(sum(fusion._promote_nbytes(v)
                                    for v in fusion._promote_cache.values()))
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(repr(exc))

    def query():
        try:
            for _ in range(4):
                got = run_query(TORCH, sess, fact, dim, "inner")
                assert _same(got, want)
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(repr(exc))

    threads = ([threading.Thread(target=churn, args=(s,)) for s in range(6)]
               + [threading.Thread(target=query) for _ in range(2)])
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # interleave the threads' bytecode finely
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert held and max(held) <= 4096
    with fusion._lock:
        assert sum(fusion._bcast_nbytes(v)
                   for v in fusion._bcast_cache.values()) <= 512
