"""Data-skipping indexes through both packages, on the CPU.

The cases of the JAX package's `tests/test_skipping.py` — config, serde
through the log FSM, plan-time pruning (zones + blooms, conjunction-
aware), rule interplay with the covering index, degradation on corrupt
or missing sketch blobs, the Z-order build, snapshot-pinned reads, the
commit-time source-cache sweep and the no-false-negative property — run
step for step through `hyperspace_tpu` and `hyperspace_tpu_torch`, each
package on its own copy of one seeded lake (the same bytes, made with
numpy). Every assertion of a case holds in both packages, and each case
also records what its rules-on plans read — the leaves' roots, their
explicit file lists and the files pruned — with paths relative to the
run's lake: the port's record must equal the JAX package's.

Left out, because the port has none of what they test yet (ROADMAP.md,
PyTorch port Queue 1 item 10): `test_lifecycle_round_trip_with_crash_
recovery` (the fault injector), `test_footprint_reprojection_credit`
(admission's footprint) and the breaker half of `test_zorder_missing_
data_degrades_and_trips_breaker` (`spark.hyperspace.serve.breaker.*`);
its degrade half is here.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401
import torch

import hyperspace_tpu as jhs
import hyperspace_tpu_torch as ths

# The suite runs in parallel worker processes; one torch thread per worker
# keeps torch's spinning OpenMP pool from starving the other workers.
torch.set_num_threads(1)


class Kit:
    """One package's entry points and internals, under shared names."""

    def __init__(self, name):
        self.name = name
        self.is_jax = name == "jax"
        if self.is_jax:
            from hyperspace_tpu import telemetry
            from hyperspace_tpu.engine import compiler, executor
            from hyperspace_tpu.engine.session import HyperspaceSession
            from hyperspace_tpu.index import log_entry, sketch
            from hyperspace_tpu.io import columnar, parquet
            from hyperspace_tpu.plan import expr, footprint, nodes
            from hyperspace_tpu.plan.rules import skipping
            self.pkg = jhs
            self._session = HyperspaceSession
        else:
            from hyperspace_tpu_torch import telemetry
            from hyperspace_tpu_torch.engine import compiler, executor
            from hyperspace_tpu_torch.engine.session import HyperspaceSession
            from hyperspace_tpu_torch.index import log_entry, sketch
            from hyperspace_tpu_torch.io import columnar, parquet
            from hyperspace_tpu_torch.plan import expr, footprint, nodes
            from hyperspace_tpu_torch.plan.rules import skipping
            self.pkg = ths
            self._session = HyperspaceSession
        self.telemetry, self.compiler, self.executor = (telemetry, compiler,
                                                        executor)
        self.log_entry, self.sketch, self.columnar = (log_entry, sketch,
                                                      columnar)
        self.parquet, self.E, self.footprint = parquet, expr, footprint
        self.nodes, self.skipping = nodes, skipping
        self.Hyperspace = self.pkg.Hyperspace
        self.DSConfig = self.pkg.DataSkippingIndexConfig
        self.IndexConfig = self.pkg.IndexConfig
        self.HyperspaceException = self.pkg.HyperspaceException

    def session(self, root, **conf):
        conf = {"hyperspace.warehouse.dir": os.path.join(root, "wh"),
                **conf}
        if self.is_jax:
            conf["spark.hyperspace.distribution.enabled"] = "false"
            return self._session(self.pkg.HyperspaceConf(conf))
        return self._session(self.pkg.HyperspaceConf(conf), device="cpu")

    def reg(self, name):
        return self.telemetry.get_registry().counter(name).value

    def manager(self, sess):
        return self.Hyperspace.get_context(sess).index_collection_manager

    def populate_sizes(self, df):
        """Fill the footprint size cache for `df`'s source files."""
        if self.is_jax:
            self.footprint.projected_bytes(df.plan)
        else:
            self.footprint.file_sizes_total(df.plan.files())


KITS = {"jax": Kit("jax"), "torch": Kit("torch")}

# Forces the port's torch lanes on the CPU: the sketch build and the
# scans reduce on torch tensors instead of numpy.
TORCH_LANE = {"spark.hyperspace.execution.min.device.rows": "0"}


@pytest.fixture(autouse=True)
def _fresh_sketch_cache():
    for k in KITS.values():
        k.sketch.clear_sketch_cache()
    yield
    for k in KITS.values():
        k.sketch.clear_sketch_cache()


class Run:
    """One package over its own lake under `root`; `record` holds what
    its rules-on plans read, paths relative to `root`."""

    def __init__(self, kit, root):
        self.k, self.root = kit, str(root)
        os.makedirs(self.root, exist_ok=True)
        self.record = []

    def rel(self, path):
        return str(path).replace(self.root, "<root>")

    def plan(self, sess, q):
        sess.enable_hyperspace()
        try:
            return q._optimized_plan()
        finally:
            sess.disable_hyperspace()

    def note(self, label, plan, metrics=None):
        """Record the leaves of a rules-on plan (and the prune counters
        of its run)."""
        leaves = [(sorted(self.rel(r) for r in leaf.root_paths),
                   sorted(self.rel(f) for f in leaf.files())
                   if leaf._explicit_files else None,
                   leaf.index_name)
                  for leaf in plan.collect_leaves()]
        pruned = None
        if metrics is not None:
            pruned = metrics.counters.get("skipping.files_pruned")
        self.record.append((label, leaves, pruned))

    def both(self, sess, q, label):
        """(rules-on table, rules-off table, on-run metrics); records the
        rules-on plan."""
        sess.enable_hyperspace()
        try:
            plan = q._optimized_plan()
            on, metrics = q.collect(with_metrics=True)
        finally:
            sess.disable_hyperspace()
        off = q.collect()
        self.note(label, plan, metrics)
        return on, off, metrics


def run_both(tmp_path, scenario, **kwargs):
    """Run `scenario(run, **kwargs)` through each package on its own lake;
    the records must be equal."""
    records = {}
    for name, kit in KITS.items():
        run = Run(kit, tmp_path / name)
        scenario(run, **kwargs)
        records[name] = run.record
    assert records["torch"] == records["jax"]
    return records["torch"]


def _sorted(table):
    return table.sort_by([(n, "ascending") for n in table.column_names])


def make_env(run, **conf):
    """(session, hs, df, src_dir): an 8-file source whose files hold
    disjoint key ranges — zones are tight, so selective predicates can
    refute whole files."""
    src = os.path.join(run.root, "src")
    os.makedirs(src)
    rng = np.random.default_rng(7)
    for i in range(8):
        t = pa.table({
            "key": np.arange(i * 100, (i + 1) * 100, dtype=np.int64),
            "val": rng.random(100),
            "s": pa.array([f"s{i}_{j % 10}" for j in range(100)]),
        })
        pq.write_table(t, os.path.join(src, f"f{i}.parquet"))
    sess = run.k.session(run.root, **conf)
    return sess, run.k.Hyperspace(sess), sess.read_parquet(src), src


# -- config + serde --------------------------------------------------------


def test_config_validation():
    messages = {}
    for name, k in KITS.items():
        out = []
        for args, kwargs in ((("", ["a"]), {}), (("x", []), {}),
                             (("x", ["a", "A"]), {}),
                             (("x", ["a"]),
                              {"sketch_types": ["zonemap", "hll"]}),
                             (("x", ["a"]), {"zorder_by": ["b", "B"]})):
            with pytest.raises(k.HyperspaceException) as exc:
                k.DSConfig(*args, **kwargs)
            out.append(str(exc.value))
        cfg = (k.DSConfig.builder().index_name("x")
               .skip_by("a", "b").sketches("zonemap").zorder_by("a")
               .create())
        assert cfg == k.DSConfig("X", ["a", "b"], ["zonemap"], ["a"])
        assert cfg != k.DSConfig("X", ["a", "b"])
        out.append(repr(cfg))
        messages[name] = out
    assert messages["torch"] == messages["jax"]


def test_log_entry_serde_round_trip(tmp_path):
    """A DataSkippingIndex entry written through the real log manager
    reads back equal — the second index kind flows through the SAME
    LogEntry serde as the covering index."""
    def scenario(run):
        k = run.k
        sess, hs, df, _src = make_env(run)
        hs.create_index(df, k.DSConfig("skA", ["key", "s"],
                                       zorder_by=["key"]))
        (entry,) = k.manager(sess).get_indexes(["ACTIVE"])
        assert entry.kind == "DataSkippingIndex"
        back = k.log_entry.LogEntry.from_json(entry.to_json())
        assert isinstance(back, k.log_entry.IndexLogEntry)
        assert isinstance(back.derived_dataset, k.log_entry.DataSkippingIndex)
        assert back == entry
        assert back.derived_dataset.skipped_columns == ["key", "s"]
        assert back.derived_dataset.zorder_by == ["key"]
        # Catalog surface shared with the covering kind.
        cat = hs.indexes()
        assert list(cat["kind"]) == ["DataSkippingIndex"]
        assert list(cat["state"]) == ["ACTIVE"]
        run.record.append(("derived", back.derived_dataset.to_dict()))
        q = df.filter(k.E.col("key") == k.E.lit(250)).select("key", "val")
        run.both(sess, q, "key==250")

    run_both(tmp_path, scenario)


# -- pruning end to end ----------------------------------------------------


@pytest.mark.parametrize("lane", ["host", "torch"])
def test_prune_eq_bit_identical_with_counters(tmp_path, lane):
    def scenario(run):
        k = run.k
        conf = TORCH_LANE if lane == "torch" and not k.is_jax else {}
        sess, hs, df, src = make_env(run, **conf)
        hs.create_index(df, k.DSConfig("sk", ["key", "s"]))
        q = df.filter(k.E.col("key") == k.E.lit(250)).select("key", "val")
        pruned0 = k.reg("skipping.files_pruned")
        on, off, metrics = run.both(sess, q, "key==250")
        assert _sorted(on).equals(_sorted(off))
        assert on.num_rows == 1
        # 7 of 8 files refuted; the per-query counters and the process
        # counters agree; the usage record carries the prune detail.
        assert metrics.counters.get("skipping.files_pruned") == 7
        assert metrics.counters.get("skipping.bytes_pruned", 0) > 0
        assert k.reg("skipping.files_pruned") - pruned0 >= 7
        (use,) = [u for u in metrics.index_usage()
                  if u.get("side") == "skipping"]
        assert use["name"] == "sk" and use["files_pruned"] == 7
        assert use["files_considered"] == 8 and use["served"] == "source"
        assert use["files_scanned"] == 1
        run.record.append(("bytes", metrics.counters["skipping.bytes_pruned"]))

    run_both(tmp_path, scenario)


@pytest.mark.parametrize("lane", ["host", "torch"])
def test_prune_range_in_null_and_string(tmp_path, lane):
    def scenario(run):
        k = run.k
        conf = TORCH_LANE if lane == "torch" and not k.is_jax else {}
        sess, hs, df, _src = make_env(run, **conf)
        hs.create_index(df, k.DSConfig("sk", ["key", "s"]))
        col, lit = k.E.col, k.E.lit
        cases = [
            (col("key") > lit(699)) & (col("key") <= lit(750)),
            col("key").isin(5, 105, 710),
            col("s") == lit("s3_4"),          # bloom + string zones
            col("key").between(199, 202),
            col("s").is_null(),               # no nulls anywhere
        ]
        for i, cond in enumerate(cases):
            q = df.filter(cond).select("key", "val", "s")
            on, off, metrics = run.both(sess, q, f"case{i}")
            assert _sorted(on).equals(_sorted(off)), repr(cond)
            assert metrics.counters.get("skipping.files_pruned", 0) > 0, \
                repr(cond)

    run_both(tmp_path, scenario)


def test_conjunction_prunes_more_than_either(tmp_path):
    def scenario(run):
        k = run.k
        sess, hs, df, _src = make_env(run)
        hs.create_index(df, k.DSConfig("sk", ["key", "s"]))
        q = df.filter((k.E.col("key") < k.E.lit(100))
                      & (k.E.col("s") == k.E.lit("s3_0"))).select("key")
        sess.enable_hyperspace()
        try:
            plan = q._optimized_plan()
            _, m_and = q.collect(with_metrics=True)
        finally:
            sess.disable_hyperspace()
        run.note("and", plan, m_and)
        # key<100 alone refutes 7; s=='s3_0' alone refutes 7 (other
        # files' dictionaries miss it); together every file is refuted.
        assert m_and.counters.get("skipping.files_pruned") == 8

    run_both(tmp_path, scenario)


def test_covering_index_wins_when_both_apply(tmp_path):
    def scenario(run):
        k = run.k
        sess, hs, df, _src = make_env(run)
        hs.create_index(df, k.IndexConfig("cov", ["key"], ["val"]))
        hs.create_index(df, k.DSConfig("sk", ["key"]))
        plan = run.plan(sess, df.filter(k.E.col("key") == k.E.lit(250))
                        .select("key", "val"))
        (leaf,) = plan.collect_leaves()
        assert leaf.index_name == "cov"
        assert "cov" in leaf.root_paths[0] and "v__=" in leaf.root_paths[0]
        run.note("cov", plan)

    run_both(tmp_path, scenario)


def test_no_prune_no_rewrite(tmp_path):
    """A predicate the sketches cannot refute anywhere leaves the plan
    untouched (no churn rewrite to an identical explicit listing)."""
    def scenario(run):
        k = run.k
        sess, hs, df, src = make_env(run)
        hs.create_index(df, k.DSConfig("sk", ["key"]))
        plan = run.plan(sess, df.filter(k.E.col("val") < k.E.lit(2.0))
                        .select("key"))  # val is unsketched
        (leaf,) = plan.collect_leaves()
        assert not leaf._explicit_files
        assert leaf.root_paths == [src]
        run.note("val<2", plan)

    run_both(tmp_path, scenario)


def test_skipping_disabled_conf(tmp_path):
    def scenario(run):
        k = run.k
        sess, hs, df, _src = make_env(run)
        hs.create_index(df, k.DSConfig("sk", ["key"]))
        sess.conf.set("spark.hyperspace.index.skipping.enabled", "false")
        q = df.filter(k.E.col("key") == k.E.lit(3)).select("key")
        _, _, metrics = run.both(sess, q, "disabled")
        assert "skipping.files_pruned" not in metrics.counters

    run_both(tmp_path, scenario)


def test_corrupt_and_missing_blob_degrade_unpruned(tmp_path):
    def scenario(run):
        k = run.k
        sess, hs, df, _src = make_env(run)
        hs.create_index(df, k.DSConfig("sk", ["key"]))
        (entry,) = k.manager(sess).get_indexes(["ACTIVE"])
        blob = os.path.join(entry.content.root, k.sketch.SKETCH_BLOB)
        q = df.filter(k.E.col("key") == k.E.lit(250)).select("key", "val")
        baseline = _sorted(q.collect())

        with open(blob, "wb") as f:
            f.write(b"not parquet at all")
        k.sketch.clear_sketch_cache()
        on, off, metrics = run.both(sess, q, "corrupt")
        assert _sorted(on).equals(baseline)
        assert _sorted(off).equals(baseline)
        assert "skipping.files_pruned" not in metrics.counters

        os.remove(blob)
        k.sketch.clear_sketch_cache()
        on, _off, metrics = run.both(sess, q, "missing")
        assert _sorted(on).equals(baseline)
        assert "skipping.files_pruned" not in metrics.counters

    run_both(tmp_path, scenario)


def test_rewritten_source_file_not_pruned(tmp_path):
    """Stamp revalidation: a file rewritten after sketching is UNKNOWN
    — kept — so stale sketches can never drop fresh matching rows."""
    def scenario(run):
        k = run.k
        sess, hs, df, src = make_env(run)
        hs.create_index(df, k.DSConfig("sk", ["key"]))
        # Rewrite f0 (keys 0..99) to now hold key 777 — its OLD sketch
        # says max=99 and would refute key==777.
        t = pa.table({"key": np.array([777], dtype=np.int64),
                      "val": np.array([0.5]),
                      "s": pa.array(["zz"])})
        pq.write_table(t, os.path.join(src, "f0.parquet"))
        k.parquet.clear_read_cache()
        df2 = sess.read_parquet(src)
        q = df2.filter(k.E.col("key") == k.E.lit(777)).select("key", "val")
        on, off, _m = run.both(sess, q, "key==777")
        assert on.num_rows == off.num_rows == 2  # rewritten f0 + f7
        assert _sorted(on).equals(_sorted(off))

    run_both(tmp_path, scenario)


def test_hybrid_remainder_pruned_by_sketches(tmp_path):
    """The covering index's SOURCE-FILE REMAINDER: with hybrid scan on,
    appended files ride the union — unless a skipping index's sketches
    refute the predicate for them, in which case the appended branch
    thins (here: to nothing — no Union in the plan at all)."""
    def scenario(run):
        k = run.k
        sess, hs, df, src = make_env(run)
        hs.create_index(df, k.IndexConfig("cov", ["key"], ["val"]))
        # Append a file with a DISJOINT key range, then sketch the grown
        # source: the appended file has a sketch row that refutes
        # key==250.
        pq.write_table(pa.table({
            "key": np.arange(5000, 5100, dtype=np.int64),
            "val": np.zeros(100), "s": pa.array(["a"] * 100)}),
            os.path.join(src, "f_app.parquet"))
        df2 = sess.read_parquet(src)
        hs.create_index(df2, k.DSConfig("sk", ["key"]))
        sess.conf.set("hyperspace.index.hybridscan.enabled", "true")
        q = df2.filter(k.E.col("key") == k.E.lit(250)).select("key", "val")
        on, off, metrics = run.both(sess, q, "hybrid")
        plan = run.plan(sess, q)
        assert _sorted(on).equals(_sorted(off)) and on.num_rows == 1
        unions = []
        plan.transform_up(lambda n: (unions.append(n), n)[1]
                          if isinstance(n, k.nodes.Union) else n)
        assert not unions  # appended branch fully pruned away
        assert any(u.get("served") == "hybrid-remainder"
                   for e in metrics.events_of("rule", "FilterIndexRule")
                   if e.get("action") == "applied"
                   for u in e.get("indexes", []))
        # The index scan itself still serves the query.
        assert any(leaf.index_name == "cov"
                   for leaf in plan.collect_leaves())

    run_both(tmp_path, scenario)


# -- refresh / lifecycle ---------------------------------------------------


@pytest.mark.parametrize("lane", ["host", "torch"])
def test_refresh_resketches_appended_files(tmp_path, lane):
    def scenario(run):
        k = run.k
        conf = TORCH_LANE if lane == "torch" and not k.is_jax else {}
        sess, hs, df, src = make_env(run, **conf)
        hs.create_index(df, k.DSConfig("sk", ["key"]))
        pq.write_table(pa.table({
            "key": np.arange(800, 900, dtype=np.int64),
            "val": np.zeros(100), "s": pa.array(["n"] * 100)}),
            os.path.join(src, "f8.parquet"))
        df2 = sess.read_parquet(src)
        q = df2.filter(k.E.col("key") == k.E.lit(850)).select("key")
        _, _, m_before = run.both(sess, q, "before")
        # The appended file has no sketch row yet: kept, old files
        # pruned.
        assert m_before.counters.get("skipping.files_pruned") == 8
        hs.refresh_index("sk")
        (entry,) = k.manager(sess).get_indexes(["ACTIVE"])
        assert entry.content.root.endswith("v__=1")
        on, off, m_after = run.both(sess, q, "after")
        assert m_after.counters.get("skipping.files_pruned") == 8
        assert _sorted(on).equals(_sorted(off)) and on.num_rows == 1

    run_both(tmp_path, scenario)


def test_incremental_refresh_dispatches_and_optimize_declines(tmp_path):
    """mode='incremental' on a skipping index takes the sketch-append
    delta path; Z-ordered configs and optimize decline typed."""
    def scenario(run):
        k = run.k
        sess, hs, df, src = make_env(run)
        hs.create_index(df, k.DSConfig("sk", ["key"]))
        hs.refresh_index("sk", mode="incremental")  # no-op append
        report = k.telemetry.get_registry().last_action_report()
        assert report["detail"]["files_sketched"] == 0
        assert report["detail"]["files_carried"] == 8
        with pytest.raises(k.HyperspaceException, match="skipping"):
            hs.optimize_index("sk")
        hs.create_index(df, k.DSConfig("zk", ["key"], zorder_by=["key"]))
        with pytest.raises(k.HyperspaceException, match="full"):
            hs.refresh_index("zk", mode="incremental")
        assert sorted(hs.indexes()["state"]) == ["ACTIVE", "ACTIVE"]
        # An appended file is the only one sketched.
        pq.write_table(pa.table({
            "key": np.arange(800, 900, dtype=np.int64),
            "val": np.zeros(100), "s": pa.array(["n"] * 100)}),
            os.path.join(src, "f8.parquet"))
        hs.refresh_index("sk", mode="incremental")
        detail = k.telemetry.get_registry().last_action_report()["detail"]
        run.record.append(("detail", {
            key: detail[key] for key in ("files_carried", "files_sketched",
                                         "files_dropped", "source_files")}))
        assert detail["files_sketched"] == 1
        q = sess.read_parquet(src).filter(k.E.col("key") == k.E.lit(850)) \
            .select("key")
        on, off, m = run.both(sess, q, "key==850")
        assert on.num_rows == 1 and _sorted(on).equals(_sorted(off))
        assert m.counters.get("skipping.files_pruned") == 8

    run_both(tmp_path, scenario)


# -- Z-order ---------------------------------------------------------------


def _zorder_env(run, n=4000, files=4):
    """Source with SHUFFLED keys: per-file zones are full-width, so
    only the Z-order rewrite can prune."""
    src = os.path.join(run.root, "zsrc")
    os.makedirs(src)
    rng = np.random.default_rng(3)
    keys = rng.permutation(n).astype(np.int64)
    k2 = rng.integers(0, 50, n).astype(np.int64)
    per = n // files
    for i in range(files):
        sl = slice(i * per, (i + 1) * per)
        pq.write_table(pa.table({"key": keys[sl], "k2": k2[sl],
                                 "val": rng.random(per)}),
                       os.path.join(src, f"f{i}.parquet"))
    sess = run.k.session(run.root, **{
        "spark.hyperspace.index.skipping.zorder.files": "8"})
    return sess, run.k.Hyperspace(sess), sess.read_parquet(src)


def test_zorder_serves_pruned_copy(tmp_path):
    def scenario(run):
        k = run.k
        sess, hs, df = _zorder_env(run)
        hs.create_index(df, k.DSConfig("z", ["key", "k2"],
                                       zorder_by=["key", "k2"]))
        q = df.filter((k.E.col("key") < k.E.lit(400))
                      & (k.E.col("k2") < k.E.lit(8))) \
            .select("key", "k2", "val")
        on, off, metrics = run.both(sess, q, "zorder")
        plan = run.plan(sess, q)
        (leaf,) = plan.collect_leaves()
        assert leaf.index_name == "z" and "v__=0" in leaf.root_paths[0]
        assert leaf.pinned_version == 0
        assert leaf._explicit_files and 0 < len(leaf.files()) < 8
        assert _sorted(on).equals(_sorted(off))
        (use,) = [u for u in metrics.index_usage()
                  if u.get("side") == "skipping"]
        assert use["served"] == "zorder-copy" and use["files_pruned"] > 0

    run_both(tmp_path, scenario)


def test_zorder_requires_signature_match(tmp_path):
    """Source changed after the Z-order build: the copy no longer
    represents it — the entry must NOT serve."""
    def scenario(run):
        k = run.k
        sess, hs, df = _zorder_env(run)
        hs.create_index(df, k.DSConfig("z", ["key"], zorder_by=["key"]))
        src = df.plan.root_paths[0]
        pq.write_table(pa.table({"key": np.array([9999], dtype=np.int64),
                                 "k2": np.array([1], dtype=np.int64),
                                 "val": np.array([0.5])}),
                       os.path.join(src, "extra.parquet"))
        df2 = sess.read_parquet(src)
        q = df2.filter(k.E.col("key") == k.E.lit(9999)).select("key", "val")
        on, off, _m = run.both(sess, q, "key==9999")
        assert on.num_rows == 1
        assert _sorted(on).equals(_sorted(off))

    run_both(tmp_path, scenario)


def test_zorder_missing_data_degrades(tmp_path):
    """Copy data corrupted out-of-band: execution raises the typed
    IndexDataUnavailableError and the query falls back to the source
    plan bit-identically (the degrade half of the JAX package's
    `test_zorder_missing_data_degrades_and_trips_breaker`)."""
    def scenario(run):
        k = run.k
        sess, hs, df = _zorder_env(run)
        hs.create_index(df, k.DSConfig("z", ["key"], zorder_by=["key"]))
        q = df.filter(k.E.col("key") < k.E.lit(50)).select("key", "val")
        baseline = _sorted(q.collect())
        (entry,) = k.manager(sess).get_indexes(["ACTIVE"])
        # Corrupt the copy's row files PRESERVING (size, mtime) — the
        # stamps still validate, so the rule keeps serving the copy, and
        # the failure surfaces at SCAN time as the typed error.
        run.note("zorder", run.plan(sess, q))
        for name in os.listdir(entry.content.root):
            if name.endswith(".parquet"):
                p = os.path.join(entry.content.root, name)
                st = os.stat(p)
                with open(p, "wb") as f:
                    f.write(b"\x00" * st.st_size)
                os.utime(p, ns=(st.st_atime_ns, st.st_mtime_ns))
        k.parquet.clear_read_cache()
        if k.is_jax:
            from hyperspace_tpu.engine import scheduler as sched_mod
            sched_mod.set_scheduler(sched_mod.QueryScheduler())
        sess.enable_hyperspace()
        try:
            fb0 = k.reg("resilience.fallbacks")
            t1 = q.collect()
            assert k.reg("resilience.fallbacks") == fb0 + 1
        finally:
            sess.disable_hyperspace()
        assert _sorted(t1).equals(baseline)

    run_both(tmp_path, scenario)


# -- snapshot-pinned reads -------------------------------------------------


def test_snapshot_pin_freezes_listing_against_racing_writer(tmp_path):
    """The committed v__=N is resolved ONCE at plan time and the listing
    frozen — a file landing in the version dir between plan and
    execution (a racing/stale writer) is invisible to the already-
    planned query, and a refresh committing v__=N+1 cannot redirect
    it."""
    def scenario(run):
        k = run.k
        sess, hs, df, src = make_env(run)
        hs.create_index(df, k.IndexConfig("cov", ["key"], ["val"]))
        q = df.filter(k.E.col("key") > k.E.lit(750)).select("key", "val")
        plan = run.plan(sess, q)
        (leaf,) = plan.collect_leaves()
        assert leaf.index_name == "cov" and leaf.pinned_version == 0
        before = _sorted(k.columnar.to_arrow(
            k.executor.execute_plan(plan, conf=sess.conf)))

        # Concurrent refresher: source grows, refresh commits v__=1 ...
        pq.write_table(pa.table({
            "key": np.arange(900, 950, dtype=np.int64),
            "val": np.zeros(50), "s": pa.array(["r"] * 50)}),
            os.path.join(src, "f9.parquet"))
        hs.refresh_index("cov")
        # ... and a stale/racing writer drops a matching-keyed bucket
        # file INTO the pinned v__=0 dir.
        foreign = pa.table({"key": np.array([800] * 5, dtype=np.int64),
                            "val": np.zeros(5)})
        pq.write_table(foreign, os.path.join(
            os.path.dirname(leaf.root_paths[0]), "v__=0",
            "part-99999.parquet"))

        after = _sorted(k.columnar.to_arrow(
            k.executor.execute_plan(plan, conf=sess.conf)))
        assert after.equals(before)  # neither v__=1 nor the foreign file

        # A FRESH plan resolves (and pins) the new committed version.
        plan2 = run.plan(sess, sess.read_parquet(src).filter(
            k.E.col("key") > k.E.lit(750)).select("key", "val"))
        (leaf2,) = plan2.collect_leaves()
        assert leaf2.pinned_version == 1
        run.record.append(("rows", before.num_rows, after.num_rows))

    run_both(tmp_path, scenario)


# -- the source-cache sweep ------------------------------------------------


def test_commit_sweeps_source_root_caches(tmp_path):
    def scenario(run):
        k = run.k
        sess, hs, df, src = make_env(run)
        k.populate_sizes(df)  # populate the size cache
        assert any(p.startswith(src) for p in k.footprint._size_cache)
        hs.create_index(df, k.DSConfig("sk", ["key"]))
        # Skipping-index commit sweeps SOURCE roots, not just index
        # roots.
        assert not any(p.startswith(src) for p in k.footprint._size_cache)
        report = k.telemetry.get_registry().last_action_report()
        run.record.append(("swept", report["detail"]["source_roots_swept"]))

    run_both(tmp_path, scenario)


# -- kernels ---------------------------------------------------------------


def test_host_device_sketch_identity():
    """Host and device lanes must produce bit-identical blooms and equal
    zones — the blob a query probes must not depend on which lane built
    it — in each package, and the port's lanes equal the JAX
    package's."""
    from hyperspace_tpu.io import columnar as jcolumnar
    from hyperspace_tpu.ops import sketch as jsketch
    from hyperspace_tpu.plan.schema import Schema as JSchema
    from hyperspace_tpu_torch.io import columnar as tcolumnar
    from hyperspace_tpu_torch.ops import sketch as tsketch
    from hyperspace_tpu_torch.plan.schema import Schema as TSchema

    t = pa.table({
        "a": pa.array([1, 5, None, 7, 5, -3], type=pa.int64()),
        "s": pa.array(["x", "y", None, "zz", "x", ""]),
        "f": pa.array([1.5, float("nan"), None, -0.0, 2.5, -9.75],
                      type=pa.float64()),
        "g": pa.array(np.arange(6, dtype=np.float32)),
        "b": pa.array([True, False, None, True, True, False]),
    })
    jschema, tschema = (JSchema.from_arrow(t.schema),
                        TSchema.from_arrow(t.schema))
    batches = [
        (jsketch, jcolumnar.from_arrow(t, jschema, device=False)),
        (jsketch, jcolumnar.from_arrow(t, jschema, device=True)),
        (tsketch, tcolumnar.from_arrow(t, tschema, device=None)),
        (tsketch, tcolumnar.from_arrow(t, tschema,
                                       device=torch.device("cpu"))),
    ]
    for name in t.column_names:
        zs = [mod.zones(b.column(name)) for mod, b in batches]
        words = [mod.bloom_build(b.column(name), 512) for mod, b in batches]
        for z, w in zip(zs[1:], words[1:]):
            assert z == zs[0], (name, z, zs[0])
            assert w.dtype == np.uint32
            assert np.array_equal(w, words[0]), name


def test_bloom_membership_and_sizing():
    from hyperspace_tpu_torch.io import columnar
    from hyperspace_tpu_torch.ops.sketch import (bloom_build,
                                                 bloom_maybe_contains,
                                                 bloom_num_bits,
                                                 probe_hash_pair)
    from hyperspace_tpu_torch.plan.schema import Schema

    assert bloom_num_bits(1000, 0.01, 64 * 1024) % 256 == 0
    assert bloom_num_bits(10 ** 9, 0.01, 64 * 1024) == 64 * 1024 * 8
    values = np.arange(0, 5000, 7, dtype=np.int64)
    t = pa.table({"k": values})
    nbits = bloom_num_bits(len(values), 0.01, 64 * 1024)
    for device in (None, torch.device("cpu")):
        batch = columnar.from_arrow(t, Schema.from_arrow(t.schema),
                                    device=device)
        words = bloom_build(batch.column("k"), nbits)
        for v in values[::50]:  # members: NEVER a false negative
            assert bloom_maybe_contains(
                words, *probe_hash_pair(int(v), "int64"))
        misses = sum(
            bloom_maybe_contains(words, *probe_hash_pair(int(v), "int64"))
            for v in range(1, 5000, 7))  # all non-members
        assert misses / (5000 // 7) < 0.05  # ~fpp with headroom


def test_zorder_permutation_clusters():
    from hyperspace_tpu.io import columnar as jcolumnar
    from hyperspace_tpu.ops.sketch import zorder_permutation as jzorder
    from hyperspace_tpu.plan.schema import Schema as JSchema
    from hyperspace_tpu_torch.io import columnar
    from hyperspace_tpu_torch.ops.sketch import zorder_permutation
    from hyperspace_tpu_torch.plan.schema import Schema

    rng = np.random.default_rng(0)
    n = 4096
    t = pa.table({"x": rng.permutation(n).astype(np.int64),
                  "y": rng.permutation(n).astype(np.int64)})
    batch = columnar.from_arrow(t, Schema.from_arrow(t.schema), device=None)
    perm = zorder_permutation(batch, ["x", "y"])
    assert sorted(perm) == list(range(n))  # a permutation
    jbatch = jcolumnar.from_arrow(t, JSchema.from_arrow(t.schema),
                                  device=False)
    assert np.array_equal(perm, jzorder(jbatch, ["x", "y"]))
    x = t.column("x").to_numpy()[perm]
    y = t.column("y").to_numpy()[perm]
    # Z-order clustering: each quarter of the output spans far less
    # than the full range in BOTH dimensions on average.
    spans = []
    for i in range(4):
        sl = slice(i * n // 4, (i + 1) * n // 4)
        spans.append((x[sl].max() - x[sl].min())
                     * (y[sl].max() - y[sl].min()))
    assert np.mean(spans) < 0.5 * (n - 1) ** 2


# -- the property: pruning never drops a matching row ----------------------


def _property_lake(src):
    rng = np.random.default_rng(42)
    os.makedirs(src)
    n_files, per = 6, 60

    def maybe_null(arr, p=0.15):
        mask = rng.random(len(arr)) < p
        return pa.array([None if m else v
                         for v, m in zip(arr.tolist(), mask)])

    files = []
    for i in range(n_files):
        base = rng.integers(-50, 400)
        i64 = rng.integers(base, base + rng.integers(5, 120),
                           per).astype(np.int64)
        f64 = np.where(rng.random(per) < 0.1, np.nan,
                       rng.normal(base, 30, per))
        s = [f"v{int(v)}" for v in rng.integers(base, base + 40, per)]
        i32 = rng.integers(-5, 5, per).astype(np.int32)
        t = pa.table({
            "i64": maybe_null(i64),
            "f64": pa.array(f64, type=pa.float64()),  # NaN, no nulls
            "s": maybe_null(np.asarray(s, dtype=object), p=0.1),
            "i32": pa.array(i32, type=pa.int32()),
        }).cast(pa.schema([("i64", pa.int64()), ("f64", pa.float64()),
                           ("s", pa.string()), ("i32", pa.int32())]))
        path = os.path.join(src, f"f{i}.parquet")
        pq.write_table(t, path)
        files.append(path)
    return files


def _random_predicate(rng):
    """A random predicate as a tree of tuples, materialized per package
    by `_materialize`."""
    def leaf():
        name = str(rng.choice(["i64", "f64", "s", "i32"]))
        kind = str(rng.choice(["eq", "ne", "lt", "le", "gt", "ge", "in",
                               "null", "notnull"]))
        if name == "s":
            vals = [f"v{int(v)}" for v in rng.integers(-60, 460, 3)]
        elif name == "f64":
            vals = [float(v) for v in rng.normal(150, 120, 3)]
        elif name == "i32":
            vals = [int(v) for v in rng.integers(-6, 6, 3)]
        else:
            vals = [int(v) for v in rng.integers(-60, 520, 3)]
        return ("leaf", name, kind, vals)

    def tree(depth=2):
        if depth == 0 or rng.random() < 0.4:
            return leaf()
        a, b = tree(depth - 1), tree(depth - 1)
        return ("and" if rng.random() < 0.5 else "or", a, b)

    return tree()


def _materialize(E, node):
    if node[0] in ("and", "or"):
        a, b = _materialize(E, node[1]), _materialize(E, node[2])
        return (a & b) if node[0] == "and" else (a | b)
    _, name, kind, vals = node
    c, v = E.col(name), vals[0]
    return {"eq": lambda: c == E.lit(v), "ne": lambda: c != E.lit(v),
            "lt": lambda: c < E.lit(v), "le": lambda: c <= E.lit(v),
            "gt": lambda: c > E.lit(v), "ge": lambda: c >= E.lit(v),
            "in": lambda: c.isin(*vals), "null": lambda: c.is_null(),
            "notnull": lambda: c.is_not_null()}[kind]()


@pytest.mark.parametrize("lane", ["host", "torch"])
def test_property_no_false_negatives(tmp_path, lane):
    """Randomized predicates over files with nulls, NaNs, negatives,
    strings, and int32 — every file the port PRUNES holds ZERO rows the
    port's own predicate compiler marks true, and the port prunes
    exactly the files the JAX package prunes (each package over its own
    sketch blob of one lake)."""
    files = _property_lake(str(tmp_path / "prop"))
    src = str(tmp_path / "prop")
    sketches, batches = {}, {}
    for name, k in KITS.items():
        conf = TORCH_LANE if lane == "torch" and not k.is_jax else {}
        sess = k.session(str(tmp_path / name), **conf)
        df = sess.read_parquet(src)
        k.Hyperspace(sess).create_index(df, k.DSConfig(
            "prop", ["i64", "f64", "s", "i32"]))
        (entry,) = k.manager(sess).get_indexes(["ACTIVE"])
        sketches[name] = k.sketch.load_sketches(entry.content.root)
        if not k.is_jax:
            device = torch.device("cpu") if lane == "torch" else None
            batches = {f: k.columnar.from_arrow(
                k.parquet.read_table([f]), df.schema, device=device)
                for f in files}
    rng = np.random.default_rng(42)
    tk, jk = KITS["torch"], KITS["jax"]
    checked = 0
    for _trial in range(120):
        tree = _random_predicate(rng)
        cond = _materialize(tk.E, tree)
        survivors, pruned, nbytes = tk.skipping.prune_files(
            cond, files, sketches["torch"])
        assert sorted(survivors + pruned) == sorted(files)
        assert (survivors, pruned, nbytes) == jk.skipping.prune_files(
            _materialize(jk.E, tree), files, sketches["jax"])
        for f in pruned:
            mask = tk.compiler.compile_predicate(cond, batches[f])
            if isinstance(mask, torch.Tensor):
                mask = mask.cpu().numpy()
            mask = np.asarray(mask)
            assert not mask.any(), (
                f"false negative: {cond!r} pruned {os.path.basename(f)} "
                f"which holds {int(mask.sum())} matching row(s)")
            checked += 1
    assert checked > 50  # the trials actually pruned files


# -- the segment cache under explicit file lists ----------------------------


def test_segment_cache_keys_survivor_sets_apart(tmp_path):
    """Two Z-order queries with different survivor sets, then the
    unpruned scan, all on the port's device lane and all warm: the
    segment cache keys each explicit file list (and the unversioned
    source read) apart, so every warm result equals numpy."""
    from hyperspace_tpu_torch.io import segcache

    kit = KITS["torch"]
    run = Run(kit, tmp_path)
    src = os.path.join(run.root, "zsrc")
    os.makedirs(src)
    rng = np.random.default_rng(3)
    n, files = 4000, 4
    keys = rng.permutation(n).astype(np.int64)
    vals = rng.random(n)
    per = n // files
    for i in range(files):
        sl = slice(i * per, (i + 1) * per)
        pq.write_table(pa.table({"key": keys[sl], "val": vals[sl]}),
                       os.path.join(src, f"f{i}.parquet"))
    segcache.set_cache(segcache.SegmentCache())
    try:
        sess = kit.session(run.root, **TORCH_LANE, **{
            "spark.hyperspace.index.skipping.zorder.files": "8"})
        df = sess.read_parquet(src)
        kit.Hyperspace(sess).create_index(
            df, kit.DSConfig("z", ["key"], zorder_by=["key"]))
        col, lit = kit.E.col, kit.E.lit
        frames = [
            ("low", df.filter(col("key") < lit(400)).select("key", "val"),
             keys < 400, True),
            ("high", df.filter(col("key") >= lit(3600)).select("key", "val"),
             keys >= 3600, True),
            ("all", df.filter(col("key") >= lit(0)).select("key", "val"),
             keys >= 0, False),
        ]
        survivors = []
        hits0 = kit.reg("cache.segments.hits")
        for _rep in range(2):
            for label, frame, mask, rules in frames:
                if rules:
                    sess.enable_hyperspace()
                    (leaf,) = frame._optimized_plan().collect_leaves()
                    assert leaf.index_name == "z" and leaf._explicit_files
                    survivors.append(tuple(leaf.files()))
                try:
                    got = frame.collect()
                finally:
                    sess.disable_hyperspace()
                order = np.argsort(got.column("key").to_numpy())
                want = np.nonzero(mask)[0]
                want = want[np.argsort(keys[want])]
                assert np.array_equal(
                    got.column("key").to_numpy()[order], keys[want]), label
                assert np.array_equal(
                    got.column("val").to_numpy()[order], vals[want]), label
        assert survivors[0] != survivors[1]
        assert survivors[:2] == survivors[2:]
        # The second round is served from the cache, one entry each.
        assert kit.reg("cache.segments.hits") - hits0 >= 3
    finally:
        segcache.set_cache(segcache.SegmentCache())
