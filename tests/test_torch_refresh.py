"""Index maintenance through both packages, on the CPU.

Every scenario of the JAX package's incremental-refresh and lineage suites
(`tests/test_incremental.py`, `tests/test_lineage.py`) runs step for step
through `hyperspace_tpu` and `hyperspace_tpu_torch`, each package on its
own copy of one seeded lake (the same bytes, made with numpy). After every
step both runs record:

- the index directories: every `v__=N` dir's file names and the SHA-256
  of every data file's bytes (the on-disk layout must be byte-equal);
- the operation log: each log id's state, and the latest stable entry's
  content root, source files, lineage ids and columns;
- every refused operation's error type and message;
- every query's optimized plan (Union or not, which roots it reads) and
  its rows, in one canonical order, with Hyperspace on and off.

The two records must be equal; paths compare relative to each run's lake.
The port runs each scenario twice: on its default lanes, and with the
torch lanes forced on the CPU (`BUILD_MIN_DEVICE_ROWS = 0`,
`min.device.rows = 0`, the merge fast path and the native library
disabled). Integers, strings
and floats compare exactly: maintenance only moves rows.

Then the cross-package checks: an index one package refreshed
incrementally is optimized by the other and served by the first, both
ways.
"""

import glob
import hashlib
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401
import torch

import hyperspace_tpu as jhs
from hyperspace_tpu.engine.physical import plan_physical as jplan_physical
from hyperspace_tpu.engine.session import HyperspaceSession as JSession
from hyperspace_tpu.plan import expr as JE
from hyperspace_tpu.plan import nodes as jnodes

import hyperspace_tpu_torch as ths
# The suite runs in parallel worker processes; one torch thread per worker
# keeps torch's spinning OpenMP pool from starving the other workers.
torch.set_num_threads(1)

from hyperspace_tpu_torch.engine.physical import plan_physical
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.io import builder as tbuilder
from hyperspace_tpu_torch.plan import expr as TE
from hyperspace_tpu_torch.plan import nodes as tnodes


# -- one package's run over its own copy of the lake -------------------------


class Run:
    """One package driving one scenario. Every method records what it saw
    in `self.record`, with paths relative to the run's root."""

    def __init__(self, pkg, root, conf):
        self.pkg, self.root = pkg, str(root)
        self.is_jax = pkg is jhs
        self.E = JE if self.is_jax else TE
        self.nodes = jnodes if self.is_jax else tnodes
        conf = {"spark.hyperspace.warehouse.dir": str(root / "wh"),
                "spark.hyperspace.distribution.enabled": "false",
                "spark.hyperspace.broadcast.threshold": "-1", **conf}
        if self.is_jax:
            self.sess = JSession(jhs.HyperspaceConf(conf))
        else:
            self.sess = ths.HyperspaceSession(ths.HyperspaceConf(conf),
                                              device="cpu")
        self.hs = pkg.Hyperspace(self.sess)
        self.record = []

    def rel(self, path):
        return str(path).replace(self.root, "<root>")

    def path(self, *parts):
        return os.path.join(self.root, *parts)

    def df(self, source="src"):
        return self.sess.read_parquet(self.path(source))

    def set(self, key, value):
        self.sess.conf.set(key, value)

    # -- maintenance, each followed by a snapshot of the lake ---------------

    def op(self, label, fn):
        try:
            fn()
            outcome = "ok"
        except Exception as exc:
            outcome = (type(exc).__name__, self.rel(exc))
        self.record.append((label, outcome))
        self.snapshot(label)
        return outcome

    def create(self, name, indexed, included, source="src"):
        return self.op(f"create {name}", lambda: self.hs.create_index(
            self.df(source), self.pkg.IndexConfig(name, indexed, included)))

    def refresh(self, name, mode="full"):
        return self.op(f"refresh {name} {mode}",
                       lambda: self.hs.refresh_index(name, mode=mode))

    def optimize(self, name):
        return self.op(f"optimize {name}",
                       lambda: self.hs.optimize_index(name))

    def lifecycle(self, verb, name):
        return self.op(f"{verb} {name}",
                       lambda: getattr(self.hs, f"{verb}_index")(name))

    def snapshot(self, label):
        system = self.path("wh", "indexes")
        for index in sorted(os.listdir(system)) if os.path.isdir(system) \
                else []:
            data = {}
            for vdir in sorted(glob.glob(os.path.join(system, index,
                                                      "v__=*"))):
                files = sorted(f for f in os.listdir(vdir)
                               if f.endswith(".parquet"))
                data[os.path.basename(vdir)] = [
                    (f, hashlib.sha256(open(os.path.join(vdir, f), "rb")
                                       .read()).hexdigest())
                    for f in files]
            self.record.append((label, index, "data", data))
            self.record.append((label, index, "log", self.log(index)))

    def log(self, index):
        manager = self.pkg.Hyperspace.get_context(self.sess) \
            .index_collection_manager
        log_manager, _ = manager._managers(index)
        states = []
        latest = log_manager.get_latest_id()
        for i in range(0, (latest if latest is not None else -1) + 1):
            entry = log_manager.get_log(i)
            states.append(entry.state if entry is not None else None)
        stable = log_manager.get_latest_stable_log()
        if stable is None:
            return states, None
        infos = stable.source_file_infos()
        return states, {
            "root": self.rel(stable.content.root),
            "files": [self.rel(f) for f in stable.source_file_list()],
            "lineage": (sorted((self.rel(p), fi.id)
                               for p, fi in infos.items())
                        if infos is not None else None),
            "has_lineage": stable.has_lineage,
            "columns": (stable.indexed_columns, stable.included_columns,
                        stable.num_buckets)}

    # -- queries --------------------------------------------------------------

    def query(self, label, build):
        """Run `build(df_of, E)` with Hyperspace on and off: record the
        optimized plan's shape and the rows (canonical order)."""
        self.sess.enable_hyperspace()
        frame = build(self.df, self.E)
        plan = self.sess.optimize(frame.plan)
        unions = []
        plan.transform_up(lambda n: (unions.append(n), n)[1]
                          if isinstance(n, self.nodes.Union) else n)
        roots = sorted(self.rel(r) for leaf in plan.collect_leaves()
                       for r in leaf.root_paths)
        planner = jplan_physical if self.is_jax else plan_physical
        tree = planner(plan, conf=self.sess.conf).tree_string()
        on = _rows(frame.collect())
        self.sess.disable_hyperspace()
        off = _rows(build(self.df, self.E).collect())
        self.record.append((label, "plan", len(unions), roots,
                            "Exchange" in tree))
        self.record.append((label, "rows", on))
        assert on == off, f"{label}: rows differ with Hyperspace off"
        return {"unions": len(unions), "roots": roots, "rows": on,
                "exchange": "Exchange" in tree}


def _rows(table):
    cols = table.column_names
    ordered = table.sort_by([(c, "ascending") for c in cols])
    return cols, [ordered.column(c).to_pylist() for c in cols]


def _roots_under(result, marker):
    return [r for r in result["roots"] if marker in r]


# -- the lakes ----------------------------------------------------------------


def sample_lake(run):
    """The JAX suite's `sample_parquet`: 1000 rows in one file."""
    rng = np.random.default_rng(42)
    n = 1000
    os.makedirs(run.path("src"))
    pq.write_table(pa.table({
        "id": np.arange(n, dtype=np.int64),
        "clicks": rng.integers(0, 100, n).astype(np.int32),
        "score": rng.random(n).astype(np.float64),
        "imprs": rng.integers(0, 10, n).astype(np.int64),
        "query": pa.array([f"q{int(v)}" for v in rng.integers(0, 50, n)]),
    }), run.path("src", "part-0.parquet"))


def append_rows(run, clicks_value=200, n=50, id_start=10_000):
    rng = np.random.default_rng(11)
    pq.write_table(pa.table({
        "id": np.arange(id_start, id_start + n, dtype=np.int64),
        "clicks": np.full(n, clicks_value, dtype=np.int32),
        "score": rng.random(n),
        "imprs": rng.integers(0, 10, n),
        "query": pa.array(["qNEW"] * n),
    }), run.path("src", f"part-extra-{id_start}.parquet"))


def rewrite_half(run, name="part-0.parquet"):
    t = pq.read_table(run.path("src", name))
    pq.write_table(t.slice(0, t.num_rows // 2), run.path("src", name))


def lineage_part(run, i, n=100):
    """The JAX lineage suite's `_write_part`."""
    ids = np.arange(i * 1000, i * 1000 + n, dtype=np.int64)
    os.makedirs(run.path("src"), exist_ok=True)
    pq.write_table(pa.table({"k": (ids % 17).astype(np.int64), "id": ids,
                             "val": (ids * 2).astype(np.int64)}),
                   run.path("src", f"part-{i}.parquet"))


def kvid_rows(run, name, start, n, seed, key_range):
    r = np.random.default_rng(seed)
    os.makedirs(run.path("src"), exist_ok=True)
    pq.write_table(pa.table({
        "k": r.integers(0, key_range, n).astype(np.int64),
        "v": r.random(n),
        "id": np.arange(start, start + n, dtype=np.int64)}),
        run.path("src", name))


def remove(run, name):
    os.remove(run.path("src", name))


# -- the scenarios ------------------------------------------------------------
# Each takes a Run and drives it; assertions here hold on both packages.

SAMPLE_CONF = {"spark.hyperspace.index.num.buckets": "4"}
LINEAGE_CONF = {"spark.hyperspace.index.num.buckets": "4",
                "spark.hyperspace.index.lineage.enabled": "true",
                "spark.hyperspace.index.hybridscan.enabled": "true"}


def clicks_is(value, *cols):
    return lambda df, E: df().filter(E.col("clicks") == value).select(*cols)


def k_is(value, *cols):
    return lambda df, E: df().filter(E.col("k") == value).select(*cols)


def sc_incremental_links_and_deltas(run):
    sample_lake(run)
    run.create("inc", ["clicks"], ["id"])
    append_rows(run)
    run.refresh("inc", "incremental")
    v0 = set(os.listdir(run.path("wh", "indexes", "inc", "v__=0")))
    v1 = set(os.listdir(run.path("wh", "indexes", "inc", "v__=1")))
    assert v0 - {"_committed"} <= v1 and any("delta1" in f for f in v1)
    res = run.query("clicks==200", clicks_is(200, "id"))
    assert len(res["roots"]) == 1 and "v__=1" in res["roots"][0]
    assert len(res["rows"][1][0]) == 50


def sc_incremental_join_still_correct(run):
    sample_lake(run)
    run.create("ja", ["imprs"], ["id"])
    run.create("jb", ["imprs"], ["score"])
    append_rows(run, clicks_value=7)
    run.refresh("ja", "incremental")
    run.refresh("jb", "incremental")
    res = run.query("join", lambda df, E: df().select("imprs", "id").join(
        df().select("imprs", "score"), on="imprs"))
    assert not res["exchange"] and all("v__=1" in r for r in res["roots"])


def sc_incremental_rejects_deletion(run):
    sample_lake(run)
    run.create("del", ["clicks"], ["id"])
    remove(run, "part-0.parquet")
    outcome = run.refresh("del", "incremental")
    assert outcome[0] == "HyperspaceException" and "full refresh" in outcome[1]


def sc_optimize_compacts_delta_runs(run):
    sample_lake(run)
    run.create("opt", ["clicks"], ["id"])
    append_rows(run)
    run.refresh("opt", "incremental")
    run.optimize("opt")
    v2 = run.path("wh", "indexes", "opt", "v__=2")
    files = [f for f in os.listdir(v2) if f.endswith(".parquet")]
    assert files and not any("delta" in f for f in files)
    for f in files:
        clicks = pq.read_table(os.path.join(v2, f)).column("clicks")
        assert clicks.to_pylist() == sorted(clicks.to_pylist())
    res = run.query("clicks==200", clicks_is(200, "id"))
    assert "v__=2" in res["roots"][0]


def sc_hybrid_scan(run):
    sample_lake(run)
    run.create("hyb", ["clicks"], ["id"])
    append_rows(run, clicks_value=42, n=30, id_start=20_000)
    stale = run.query("stale", clicks_is(42, "id"))
    assert not _roots_under(stale, "v__=")
    run.set("hyperspace.index.hybridscan.enabled", "true")
    res = run.query("hybrid", clicks_is(42, "id"))
    assert res["unions"] == 1 and _roots_under(res, "v__=0")
    assert sum(i >= 20_000 for i in res["rows"][1][0]) == 30


def sc_refresh_unknown_mode(run):
    sample_lake(run)
    run.create("m", ["clicks"], [])
    outcome = run.refresh("m", "bogus")
    assert outcome[0] == "HyperspaceException" and "mode" in outcome[1]


def sc_hybrid_rejects_inplace_rewrite(run):
    sample_lake(run)
    run.create("hw", ["clicks"], ["id"])
    rewrite_half(run)
    append_rows(run, clicks_value=42, n=10, id_start=30_000)
    run.set("hyperspace.index.hybridscan.enabled", "true")
    res = run.query("rewritten", clicks_is(42, "id"))
    assert not _roots_under(res, "v__=")


def sc_incremental_rejects_inplace_rewrite(run):
    sample_lake(run)
    run.create("iw", ["clicks"], ["id"])
    rewrite_half(run)
    append_rows(run, clicks_value=7, n=10, id_start=40_000)
    outcome = run.refresh("iw", "incremental")
    assert "full refresh" in outcome[1]


def _byte_equal_dirs(run, a, b):
    a, b = run.path("wh", "indexes", *a), run.path("wh", "indexes", *b)
    names = sorted(f for f in os.listdir(a) if f.endswith(".parquet"))
    assert names == sorted(f for f in os.listdir(b) if f.endswith(".parquet"))
    for f in names:
        with open(os.path.join(a, f), "rb") as x, \
                open(os.path.join(b, f), "rb") as y:
            assert x.read() == y.read(), f


def sc_optimize_64_buckets_matches_rebuild(run):
    kvid_rows(run, "part-0-base.parquet", 0, 600, 1, 40)
    run.set("hyperspace.index.num.buckets", "64")
    run.create("opt64", ["k"], ["v", "id"])
    for i in range(4):
        kvid_rows(run, f"part-1-extra{i}.parquet", 1000 * (i + 1), 150,
                  10 + i, 40)
        run.refresh("opt64", "incremental")
    run.optimize("opt64")
    run.create("opt64_rebuild", ["k"], ["v", "id"])
    _byte_equal_dirs(run, ("opt64", "v__=5"), ("opt64_rebuild", "v__=0"))


def sc_optimize_merge_fast_path_matches_rebuild(run):
    kvid_rows(run, "part-0-base.parquet", 0, 500, 2, 30)
    run.set("hyperspace.index.num.buckets", "16")
    run.create("mf", ["k"], ["v", "id"])
    for i in range(3):
        kvid_rows(run, f"part-1-extra{i}.parquet", 1000 * (i + 1), 120,
                  20 + i, 30)
        run.refresh("mf", "incremental")
    run.optimize("mf")
    run.create("mf_rebuild", ["k"], ["v", "id"])
    _byte_equal_dirs(run, ("mf", "v__=4"), ("mf_rebuild", "v__=0"))


def sc_hybrid_scan_join(run):
    rng = np.random.default_rng(21)
    for side, n, col in (("hl", 800, "x"), ("hr", 300, "y")):
        os.makedirs(run.path(side))
        pq.write_table(pa.table({
            "k": rng.integers(0, 40, n).astype(np.int64),
            col: rng.random(n)}), run.path(side, "part-0.parquet"))
    run.create("hj_l", ["k"], ["x"], source="hl")
    run.create("hj_r", ["k"], ["y"], source="hr")
    pq.write_table(pa.table({
        "k": rng.integers(0, 40, 200).astype(np.int64),
        "x": rng.random(200)}), run.path("hl", "part-1.parquet"))
    run.set("hyperspace.index.hybridscan.enabled", "true")
    res = run.query("hybrid join", lambda df, E: df("hl").join(
        df("hr"), on=E.col("k") == E.col("k")).select("x", "y"))
    assert res["unions"] == 1 and _roots_under(res, "v__=0")


def sc_lineage_build_metadata_and_column(run):
    for i in range(3):
        lineage_part(run, i)
    run.create("lin", ["k"], ["id", "val"])
    entry, = run.pkg.Hyperspace.get_context(run.sess) \
        .index_collection_manager.get_indexes(["ACTIVE"])
    infos = entry.source_file_infos()
    assert sorted(fi.id for fi in infos.values()) == [0, 1, 2]
    assert entry.has_lineage
    res = run.query("k==3", lambda df, E: df().filter(E.col("k") == 3))
    assert res["rows"][0] == ["k", "id", "val"]


def sc_filter_hybrid_survives_delete(run):
    for i in range(3):
        lineage_part(run, i)
    run.create("lin", ["k"], ["id", "val"])
    remove(run, "part-1.parquet")
    res = run.query("k==3", k_is(3, "id", "val"))
    assert len(res["roots"]) == 1 and "v__=0" in res["roots"][0]
    assert all(i // 1000 != 1 for i in res["rows"][1][0])


def sc_filter_hybrid_delete_plus_append(run):
    for i in range(3):
        lineage_part(run, i)
    run.create("lin", ["k"], ["id", "val"])
    remove(run, "part-0.parquet")
    lineage_part(run, 7)
    res = run.query("k==5", k_is(5, "id"))
    assert _roots_under(res, "v__=0") and _roots_under(res, "<root>/src")


def sc_modified_file_declines_hybrid(run):
    for i in range(3):
        lineage_part(run, i)
    run.create("lin", ["k"], ["id", "val"])
    lineage_part(run, 1, n=50)
    res = run.query("k==3", k_is(3, "id"))
    assert not _roots_under(res, "v__=0")


def _join_kv(df, E):
    return df().select("k", "id").join(df().select("k", "val"), on="k")


def sc_join_hybrid_survives_delete(run):
    for i in range(3):
        lineage_part(run, i)
    run.create("jl", ["k"], ["id"])
    run.create("jr", ["k"], ["val"])
    remove(run, "part-2.parquet")
    res = run.query("join", _join_kv)
    assert _roots_under(res, "v__=0")


def sc_join_exact_match_lineage_not_leaked(run):
    for i in range(3):
        lineage_part(run, i)
    run.create("jl", ["k"], ["id"])
    run.create("jr", ["k"], ["val"])
    res = run.query("join", _join_kv)
    assert _roots_under(res, "v__=0")
    assert "_hs_file_id" not in res["rows"][0]


def sc_incremental_refresh_deletion(run):
    for i in range(3):
        lineage_part(run, i)
    run.create("lin", ["k"], ["id", "val"])
    remove(run, "part-1.parquet")
    run.refresh("lin", "incremental")
    v1 = run.path("wh", "indexes", "lin", "v__=1")
    ids = set()
    for f in glob.glob(os.path.join(v1, "*.parquet")):
        ids |= set(pq.read_table(f).column("_hs_file_id").to_pylist())
    assert ids == {0, 2}
    res = run.query("k==4", k_is(4, "id"))
    assert len(res["roots"]) == 1 and "v__=1" in res["roots"][0]


def sc_incremental_refresh_delete_and_append(run):
    for i in range(3):
        lineage_part(run, i)
    run.create("lin", ["k"], ["id", "val"])
    remove(run, "part-0.parquet")
    lineage_part(run, 9)
    run.refresh("lin", "incremental")
    entry, = run.pkg.Hyperspace.get_context(run.sess) \
        .index_collection_manager.get_indexes(["ACTIVE"])
    by_name = {os.path.basename(p): fi.id
               for p, fi in entry.source_file_infos().items()}
    assert by_name == {"part-1.parquet": 1, "part-2.parquet": 2,
                       "part-9.parquet": 3}
    res = run.query("k==2", k_is(2, "id", "val"))
    assert len(res["roots"]) == 1 and "v__=1" in res["roots"][0]


def sc_incremental_without_lineage_rejects_delete(run):
    for i in range(2):
        lineage_part(run, i)
    run.create("nolin", ["k"], ["id"])
    remove(run, "part-0.parquet")
    outcome = run.refresh("nolin", "incremental")
    assert "lineage" in outcome[1]


def sc_full_refresh_preserves_lineage(run):
    for i in range(3):
        lineage_part(run, i)
    run.create("lin", ["k"], ["id", "val"])
    run.set("spark.hyperspace.index.lineage.enabled", "false")
    remove(run, "part-1.parquet")
    run.refresh("lin")
    entry, = run.pkg.Hyperspace.get_context(run.sess) \
        .index_collection_manager.get_indexes(["ACTIVE"])
    assert entry.has_lineage and len(entry.source_file_infos()) == 2


def sc_delete_restore_vacuum(run):
    """The lifecycle state machine: refusals out of order, then
    delete -> restore -> delete -> vacuum leaves no version dir."""
    sample_lake(run)
    run.create("lc", ["clicks"], ["id"])
    append_rows(run)
    run.refresh("lc", "incremental")
    assert run.lifecycle("restore", "lc")[0] == "HyperspaceException"
    assert run.lifecycle("vacuum", "lc")[0] == "HyperspaceException"
    run.lifecycle("delete", "lc")
    assert run.refresh("lc", "full")[0] == "HyperspaceException"
    assert run.optimize("lc")[0] == "HyperspaceException"
    stale = run.query("deleted", clicks_is(200, "id"))
    assert not _roots_under(stale, "v__=")
    run.lifecycle("restore", "lc")
    assert _roots_under(run.query("restored", clicks_is(200, "id")),
                        "v__=1")
    run.lifecycle("delete", "lc")
    run.lifecycle("vacuum", "lc")
    assert not glob.glob(run.path("wh", "indexes", "lc", "v__=*"))
    assert len(run.hs.indexes()) == 0


SCENARIOS = {
    "incremental_links_and_deltas": (SAMPLE_CONF,
                                     sc_incremental_links_and_deltas),
    "incremental_join_still_correct": (SAMPLE_CONF,
                                       sc_incremental_join_still_correct),
    "incremental_rejects_deletion": (SAMPLE_CONF,
                                     sc_incremental_rejects_deletion),
    "optimize_compacts_delta_runs": (SAMPLE_CONF,
                                     sc_optimize_compacts_delta_runs),
    "hybrid_scan": (SAMPLE_CONF, sc_hybrid_scan),
    "refresh_unknown_mode": (SAMPLE_CONF, sc_refresh_unknown_mode),
    "hybrid_rejects_inplace_rewrite": (SAMPLE_CONF,
                                       sc_hybrid_rejects_inplace_rewrite),
    "incremental_rejects_inplace_rewrite": (
        SAMPLE_CONF, sc_incremental_rejects_inplace_rewrite),
    "optimize_64_buckets_matches_rebuild": (
        SAMPLE_CONF, sc_optimize_64_buckets_matches_rebuild),
    "optimize_merge_fast_path_matches_rebuild": (
        SAMPLE_CONF, sc_optimize_merge_fast_path_matches_rebuild),
    "hybrid_scan_join": (SAMPLE_CONF, sc_hybrid_scan_join),
    "lineage_build_metadata_and_column": (
        LINEAGE_CONF, sc_lineage_build_metadata_and_column),
    "filter_hybrid_survives_delete": (LINEAGE_CONF,
                                      sc_filter_hybrid_survives_delete),
    "filter_hybrid_delete_plus_append": (LINEAGE_CONF,
                                         sc_filter_hybrid_delete_plus_append),
    "modified_file_declines_hybrid": (LINEAGE_CONF,
                                      sc_modified_file_declines_hybrid),
    "join_hybrid_survives_delete": (LINEAGE_CONF,
                                    sc_join_hybrid_survives_delete),
    "join_exact_match_lineage_not_leaked": (
        LINEAGE_CONF, sc_join_exact_match_lineage_not_leaked),
    "incremental_refresh_deletion": (LINEAGE_CONF,
                                     sc_incremental_refresh_deletion),
    "incremental_refresh_delete_and_append": (
        LINEAGE_CONF, sc_incremental_refresh_delete_and_append),
    "incremental_without_lineage_rejects_delete": (
        SAMPLE_CONF, sc_incremental_without_lineage_rejects_delete),
    "full_refresh_preserves_lineage": (LINEAGE_CONF,
                                       sc_full_refresh_preserves_lineage),
    "delete_restore_vacuum": (SAMPLE_CONF, sc_delete_restore_vacuum),
}

_JAX_RECORDS = {}


def _jax_record(name, tmp_path_factory):
    """The JAX package's record of a scenario, made once per process."""
    if name not in _JAX_RECORDS:
        conf, scenario = SCENARIOS[name]
        run = Run(jhs, tmp_path_factory.mktemp(f"jax_{name}"), conf)
        scenario(run)
        _JAX_RECORDS[name] = run.record
    return _JAX_RECORDS[name]


def _force_torch_lanes(monkeypatch, conf):
    # A CPU session builds on the torch lanes when the native library is
    # absent (with it, the session takes the native radix sort).
    from hyperspace_tpu_torch import native as tnative
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    monkeypatch.setattr(tbuilder, "BUILD_MIN_DEVICE_ROWS", 0)
    monkeypatch.setattr(tbuilder, "_merge_path_permutation",
                        lambda *a, **k: None)
    return {**conf, "spark.hyperspace.execution.min.device.rows": "0"}


@pytest.mark.parametrize("lane", ["host", "torch"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_jax(name, lane, tmp_path, tmp_path_factory,
                             monkeypatch):
    expected = _jax_record(name, tmp_path_factory)
    conf, scenario = SCENARIOS[name]
    if lane == "torch":
        conf = _force_torch_lanes(monkeypatch, conf)
    run = Run(ths, tmp_path, conf)
    scenario(run)
    assert len(run.record) == len(expected)
    for got, want in zip(run.record, expected):
        assert got == want


def test_hybrid_plan_roundtrips_file_restriction(tmp_path):
    """Scan file restrictions and the Union survive plan serde, as in the
    JAX package (the hybrid plan depends on both)."""
    from hyperspace_tpu.plan.serde import plan_from_json as jfrom_json
    from hyperspace_tpu_torch.plan.schema import Field, Schema
    from hyperspace_tpu_torch.plan.serde import plan_from_json, plan_to_json

    files = [str(tmp_path / "part-1.parquet")]
    schema = Schema([Field("id", "int64")])
    scan = tnodes.Scan([str(tmp_path)], schema, files=files)
    assert plan_from_json(plan_to_json(scan)).files() == files
    union = tnodes.Union([tnodes.Project(["id"], tnodes.Scan(
        [str(tmp_path / "index")], schema)), tnodes.Project(["id"], scan)])
    text = plan_to_json(union)
    again = plan_from_json(text)
    assert isinstance(again, tnodes.Union)
    assert again.to_dict() == union.to_dict()
    assert again.children[1].child.files() == files
    assert jfrom_json(text).to_dict() == union.to_dict()


@pytest.mark.parametrize("lane", ["host", "torch"])
def test_refresh_of_a_jax_built_data_skipping_entry(tmp_path, lane):
    """Two data-skipping indexes the JAX package built over one lake: the
    port refreshes one, the JAX package the other, in each mode, after
    each change to the lake. Each refresh's `_hs_sketches` blob equals
    the JAX package's refresh of the same lake (same rows, same
    metadata), and the port's action report names the files it
    re-sketched."""
    from hyperspace_tpu.index.index_config import DataSkippingIndexConfig
    from hyperspace_tpu_torch import telemetry

    jrun = Run(jhs, tmp_path, SAMPLE_CONF)
    sample_lake(jrun)
    for name in ("skip_t", "skip_j"):
        jrun.hs.create_index(jrun.df(), DataSkippingIndexConfig(
            name, ["clicks", "query"]))
    conf = {"spark.hyperspace.warehouse.dir": str(tmp_path / "wh")}
    if lane == "torch":
        conf["spark.hyperspace.execution.min.device.rows"] = "0"
    tsess = ths.HyperspaceSession(ths.HyperspaceConf(conf), device="cpu")
    ths_hs = ths.Hyperspace(tsess)

    def blob(name, version):
        t = pq.read_table(jrun.path("wh", "indexes", name,
                                    f"v__={version}", "_hs_sketches"))
        return t.schema.metadata, t.to_pydict()

    steps = [("incremental", lambda: append_rows(jrun), 1),
             ("full", lambda: append_rows(jrun, id_start=20_000), 1),
             ("incremental", lambda: remove(jrun, "part-extra-10000.parquet"),
              0)]
    for version, (mode, change, sketched) in enumerate(steps, start=1):
        change()
        ths_hs.refresh_index("skip_t", mode=mode)
        detail = telemetry.get_registry().last_action_report()["detail"]
        if mode == "incremental":
            assert detail["files_sketched"] == sketched
        else:
            assert detail["files_sketched"] == detail["source_files"]
        jrun.hs.refresh_index("skip_j", mode=mode)
        assert blob("skip_t", version) == blob("skip_j", version)
    res = jrun.query("clicks==200", lambda df, E: df().filter(
        E.col("clicks") == 200).select("id", "clicks"))
    assert len(res["rows"][1][0]) == 50


# -- cross-package maintenance ------------------------------------------------


@pytest.mark.parametrize("lane", ["merge", "device"])
@pytest.mark.parametrize("refresher", ["jax", "torch"])
def test_each_package_optimizes_the_others_refresh(refresher, lane,
                                                   tmp_path, monkeypatch):
    """One package creates and incrementally refreshes an index; the other
    optimizes it; the first serves it. The optimized files equal a full
    rebuild's, byte for byte, and the query's rows equal the rules-off
    query's."""
    if lane == "device":
        _force_torch_lanes(monkeypatch, {})
    conf = dict(SAMPLE_CONF)
    jrun = Run(jhs, tmp_path, conf)
    trun = Run(ths, tmp_path, conf)
    first, second = (jrun, trun) if refresher == "jax" else (trun, jrun)
    kvid_rows(first, "part-0-base.parquet", 0, 700, 3, 30)
    first.create("x", ["k"], ["v", "id"])
    for i in range(2):
        kvid_rows(first, f"part-1-extra{i}.parquet", 1000 * (i + 1), 80,
                  30 + i, 30)
        first.refresh("x", "incremental")
    second.optimize("x")
    assert second.record[0] == ("optimize x", "ok")
    res = first.query("k==7", lambda df, E: df().filter(E.col("k") == 7)
                      .select("id", "v"))
    assert res["roots"] == ["<root>/wh/indexes/x/v__=3"]
    assert res["rows"][1][0]
    first.create("rebuild", ["k"], ["v", "id"])
    _byte_equal_dirs(first, ("x", "v__=3"), ("rebuild", "v__=0"))


# -- vacuum vs an in-flight read ----------------------------------------------


def test_vacuum_defers_behind_a_pinned_read(tmp_path):
    """A vacuum racing a pinned read backs off and skips the pinned
    version (counted as deferred); with no pin, vacuum deletes it."""
    from hyperspace_tpu_torch import telemetry
    from hyperspace_tpu_torch.index import pins

    run = Run(ths, tmp_path, {**SAMPLE_CONF,
                              "spark.hyperspace.io.retry.attempts": "2",
                              "spark.hyperspace.io.retry.base.ms": "1"})
    sample_lake(run)
    run.create("cov", ["clicks"], ["id"])
    run.create("cov2", ["clicks"], ["imprs"])
    counters = telemetry.get_registry().counters_dict
    before = counters().get("resilience.vacuum.deferred", 0)
    vdir = run.path("wh", "indexes", "cov", "v__=0")
    run.lifecycle("delete", "cov")
    with pins.pinned([vdir]):
        assert run.lifecycle("vacuum", "cov") == "ok"
        assert os.path.isdir(vdir)
    assert not pins.is_pinned(vdir)
    assert counters()["resilience.vacuum.deferred"] == before + 1
    run.lifecycle("delete", "cov2")
    run.lifecycle("vacuum", "cov2")
    assert not os.path.isdir(run.path("wh", "indexes", "cov2", "v__=0"))
    assert counters()["resilience.vacuum.deferred"] == before + 1


@pytest.mark.parametrize("lane", ["host", "torch"])
def test_index_scan_pins_its_version_while_reading(tmp_path, monkeypatch,
                                                   lane):
    from hyperspace_tpu_torch.index import pins
    from hyperspace_tpu_torch.io import parquet

    conf = dict(SAMPLE_CONF)
    if lane == "torch":
        conf = _force_torch_lanes(monkeypatch, conf)
    run = Run(ths, tmp_path, conf)
    sample_lake(run)
    run.create("cov", ["clicks"], ["id"])
    vdir = run.path("wh", "indexes", "cov", "v__=0")
    seen = []
    for name in ("read_host_batch", "read_table"):
        real = getattr(parquet, name)

        def reading(paths, *a, _real=real, **k):
            if any(str(p).startswith(vdir) for p in paths):
                seen.append(pins.is_pinned(vdir))
            return _real(paths, *a, **k)

        monkeypatch.setattr(parquet, name, reading)
    res = run.query("clicks==7", clicks_is(7, "id"))
    assert res["roots"] == ["<root>/wh/indexes/cov/v__=0"]
    assert seen and all(seen)
    assert not pins.is_pinned(vdir)


def test_lineage_metadata_roundtrip():
    """Per-file lineage stamps round-trip, and the wire shape is the JAX
    package's (stampless directories keep the reference shape)."""
    from hyperspace_tpu.index.log_entry import Directory as JDirectory
    from hyperspace_tpu_torch.index.log_entry import Directory, FileInfo

    d = Directory(path="/d", files=["a", "b"],
                  file_infos=[FileInfo("a", 10, "123", 0),
                              FileInfo("b", 20, "456", 1)])
    assert Directory.from_dict(d.to_dict()) == d
    assert JDirectory.from_dict(d.to_dict()).to_dict() == d.to_dict()
    bare = Directory(path="/d", files=["a"])
    assert "fileInfos" not in bare.to_dict()
