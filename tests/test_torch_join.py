"""The shuffle-free join through both packages, on the CPU.

The same inputs, made from a seed with numpy, go through `hyperspace_tpu`
and `hyperspace_tpu_torch`:

- the counting join's (left, right) row-index pairs, narrow (exact lane
  sort) and hashed (one u64 hash lane), must equal the JAX package's
  element for element;
- `sort_merge_join`, `bucketed_sort_merge_join` and `semi_anti_indices`
  for all six join types, with nullable and string keys, on the host lane
  and the torch lane, must give the JAX package's rows;
- end to end through `Hyperspace`/`DataFrame`: a left index at 16 buckets
  joined with a right index at 16 (no Exchange) or 8 buckets (the right
  side re-bucketed through an Exchange), rules on and off, must give the
  JAX package's rows, and numpy's for the inner join;
- each package serves the other's join indexes.

Rows compare in one canonical order; floats exactly, because a join only
gathers.
"""

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
from hyperspace_tpu.io import columnar as jcol
from hyperspace_tpu.ops import bucketed_join as jbj
from hyperspace_tpu.ops import join as jjoin

import hyperspace_tpu_torch as ths
# The suite runs in parallel worker processes; one torch thread per worker
# keeps torch's spinning OpenMP pool from starving the other workers.
torch.set_num_threads(1)

from hyperspace_tpu_torch.engine.physical import (ExchangeExec,
                                                  plan_physical)
from hyperspace_tpu_torch.io import columnar as tcol
from hyperspace_tpu_torch.ops import bucketed_join as tbj
from hyperspace_tpu_torch.ops import join as tjoin
from hyperspace_tpu_torch.ops.cuda import partition_kernel

CPU = torch.device("cpu")
N_LEFT, N_RIGHT, N_KEYS = 40_000, 20_000, 10_000
BUCKETS = 16
HOWS = ("inner", "left_outer", "right_outer", "full_outer", "left_semi",
        "left_anti")


def _side(rng, n, payload, null_every):
    key = rng.integers(0, N_KEYS, n).astype(np.int64)
    null = np.arange(n) % null_every == 0
    return pa.table({
        "key": key,
        # nullable int64 key and nullable string key over the same values
        "nk": pa.array(key, mask=null),
        "s": pa.array([None if z else f"k{v}" for v, z in zip(key, null)]),
        # a float64 key that is a function of `key`: (key, f) pairs match
        # exactly where keys do, and take the hashed path (5 lanes)
        "f": (key % 7).astype(np.float64) * 0.5,
        payload: rng.random(n),
        "x": rng.random(n),
    })


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(7)
    left = _side(rng, N_LEFT, "id", 29)
    left = left.set_column(left.schema.get_field_index("id"), "id",
                           pa.array(np.arange(N_LEFT, dtype=np.int64)))
    return left, _side(rng, N_RIGHT, "val", 31)


def _rows(table):
    """The table's rows in one canonical order (every column ascending,
    nulls last), as one Python list per column."""
    cols = table.column_names
    ordered = table.sort_by([(c, "ascending") for c in cols])
    return [ordered.column(c).to_pylist() for c in cols]


def _batches(table, lane):
    """The port's batch of `table` on `lane` ("host" or "torch")."""
    return (tcol.from_arrow(table) if lane == "host"
            else tcol.from_arrow(table, device=CPU))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# -- counting join: pairs element for element -------------------------------

PAIR_KEYS = (["key"], ["nk"], ["s"], ["key", "f"], ["nk", "s"])


@pytest.mark.parametrize("how", ["inner", "left_outer"])
@pytest.mark.parametrize("keys", PAIR_KEYS, ids="+".join)
def test_counting_pairs_equal_jax_element_for_element(tables, keys, how):
    left, right = tables
    jl, jr = (np.asarray(a) for a in jjoin.counting_join_batch_indices(
        jcol.from_arrow(left), jcol.from_arrow(right), keys, keys, how=how))
    tl, tr = _batches(left, "torch"), _batches(right, "torch")
    li, ri = tjoin.counting_join_batch_indices(tl, tr, keys, keys, how=how)
    n_lanes = len(tjoin._join_lane_operands(tl, tr, keys, keys)[0])
    assert (n_lanes >= tjoin.HASH_MATCH_MIN_LANES) == (len(keys) == 2)
    assert len(jl) > 0
    assert np.array_equal(li.numpy(), jl)
    assert np.array_equal(ri.numpy(), jr)


def test_hash_collision_reruns_the_exact_sort(tables, monkeypatch):
    """A hash that puts every row in one run reports a collision; the
    exact re-run gives the exact path's pairs."""
    from hyperspace_tpu_torch.ops import hash_partition

    left, right = (_batches(t.slice(0, 3000), "torch") for t in tables)
    keys = ["key", "f"]
    monkeypatch.setattr(tjoin, "HASH_MATCH_MIN_LANES", 99)
    exact = tjoin.counting_join_batch_indices(left, right, keys, keys)
    monkeypatch.setattr(tjoin, "HASH_MATCH_MIN_LANES", 4)
    monkeypatch.setattr(hash_partition, "dual_hash64",
                        lambda lanes: torch.zeros_like(lanes[0],
                                                       dtype=torch.int64))
    lanes_l, lanes_r = tjoin._join_lane_operands(left, right, keys, keys)
    assert bool(tjoin._match_lanes(lanes_l, lanes_r, False)[-1])
    got = tjoin.counting_join_batch_indices(left, right, keys, keys)
    assert all(torch.equal(a, b) for a, b in zip(got, exact))


# -- the run-bounds kernel's wrapper on the CPU ------------------------------

def _np_run_bounds(differs):
    """Numpy oracle: each element's run's first position (the running max
    of start positions) and last (the next start, from the right, less 1)."""
    T = len(differs) + 1
    start = np.r_[True, differs]
    pos = np.arange(T)
    first = np.maximum.accumulate(np.where(start, pos, 0))
    nxt = np.minimum.accumulate(np.where(start, pos, T)[::-1])[::-1]
    return first, np.r_[nxt[1:], T] - 1


def _flags_of_lengths(lengths):
    """The T-1 difference flags of a sorted sequence with runs `lengths`."""
    starts = np.zeros(int(np.sum(lengths)), dtype=bool)
    starts[np.cumsum(lengths)[:-1]] = True
    return starts[1:]


_TILE = 4096  # the kernel's tile (`csrc/run_bounds.cu`)
RUN_BOUNDS_CASES = {
    "T=1": np.zeros(0, dtype=bool),
    "T=2 one run": np.array([False]),
    "T=2 two runs": np.array([True]),
    "one run over all": np.zeros(3 * _TILE, dtype=bool),
    "all distinct": np.ones(2 * _TILE + 5, dtype=bool),
    "runs of 1-7": _flags_of_lengths(
        np.random.default_rng(1).integers(1, 8, 3000)),
    "run across a tile edge": _flags_of_lengths(
        [_TILE - 10, 25, _TILE, 7]),
    "run over three tiles": _flags_of_lengths([3, 3 * _TILE + 100, 2, 40]),
    "T not a tile multiple": np.random.default_rng(2).random(
        2 * _TILE + 999) < 0.5,
    "random": np.random.default_rng(3).random(20_000) < 0.1,
    "not bool": np.zeros(9, dtype=np.int64),
    "not contiguous": np.zeros(18, dtype=bool)[::2],
    "2-D": np.zeros((3, 3), dtype=bool),
}


@pytest.mark.parametrize("case", list(RUN_BOUNDS_CASES))
def test_run_bounds_wrapper_equals_numpy_oracle(case):
    """The wrapper on a CPU tensor (its plain version) against the numpy
    oracle, and its checks on the flags; the kernel is listed to build."""
    from hyperspace_tpu_torch.exceptions import HyperspaceException
    from hyperspace_tpu_torch.ops.cuda import build, run_bounds_kernel

    assert build.SOURCES["run_bounds"] == "run_bounds.cu"
    flags = RUN_BOUNDS_CASES[case]
    tensor = torch.from_numpy(flags)
    before = run_bounds_kernel.run_bounds.launches
    if flags.dtype != np.bool_ or flags.ndim != 1 or \
            not tensor.is_contiguous():
        with pytest.raises(HyperspaceException):
            run_bounds_kernel.run_bounds(tensor)
        return
    first, last = tjoin._run_bounds(tensor)
    want_first, want_last = _np_run_bounds(flags)
    assert first.dtype == last.dtype == torch.int64
    assert np.array_equal(first.numpy(), want_first)
    assert np.array_equal(last.numpy(), want_last)
    assert run_bounds_kernel.run_bounds.launches == before


# -- the join operators, six join types, both lanes --------------------------

OP_KEYS = (["nk"], ["s"], ["nk", "s"])


def _jax_join(left, right, keys, how):
    """The JAX package's rows (host lane) for one join."""
    jl = jcol.from_arrow(left, device=False)
    jr = jcol.from_arrow(right, device=False)
    if how in ("left_semi", "left_anti"):
        idx = jjoin.semi_anti_indices(jl, jr, keys, keys,
                                      anti=how == "left_anti")
        return sorted(np.asarray(idx).tolist())
    return _rows(jcol.to_arrow(jjoin.sort_merge_join(jl, jr, keys, keys,
                                                     how=how)))


@pytest.mark.parametrize("lane", ["host", "torch"])
@pytest.mark.parametrize("keys", OP_KEYS, ids="+".join)
@pytest.mark.parametrize("how", HOWS)
def test_sort_merge_join_equals_jax(tables, how, keys, lane):
    left, right = (t.slice(0, 8000) for t in tables)
    tl, tr = _batches(left, lane), _batches(right, lane)
    expected = _jax_join(left, right, keys, how)
    if how in ("left_semi", "left_anti"):
        idx = tjoin.semi_anti_indices(tl, tr, keys, keys,
                                      anti=how == "left_anti")
        assert sorted(_np(idx).tolist()) == expected
        return
    out = tjoin.sort_merge_join(tl, tr, keys, keys, how=how)
    assert out.is_host == (lane == "host")
    assert _rows(tcol.to_arrow(out)) == expected


def _bucket_order(table, keys):
    """`table` grouped by bucket the way an index or an Exchange lays it
    out, with its per-bucket lengths."""
    batch, lengths = ExchangeExec(keys, BUCKETS, None).partition(
        tcol.from_arrow(table))
    return tcol.to_arrow(batch), lengths


@pytest.mark.parametrize("lane", ["host", "torch"])
@pytest.mark.parametrize("keys", OP_KEYS, ids="+".join)
@pytest.mark.parametrize("how", HOWS[:4])
def test_bucketed_sort_merge_join_equals_jax(tables, how, keys, lane):
    (left, l_len), (right, r_len) = (_bucket_order(t.slice(0, 8000), keys)
                                     for t in tables)
    expected = _rows(jcol.to_arrow(jbj.bucketed_sort_merge_join(
        jcol.from_arrow(left, device=False),
        jcol.from_arrow(right, device=False), l_len, r_len, keys, keys,
        how=how)))
    out = tbj.bucketed_sort_merge_join(_batches(left, lane),
                                       _batches(right, lane), l_len, r_len,
                                       keys, keys, how=how)
    assert _rows(tcol.to_arrow(out)) == expected


def test_late_projection_and_suffix(tables):
    """`columns` gathers only the named outputs; the right side's
    colliding names carry `_r`."""
    left, right = (_batches(t.slice(0, 2000), "torch") for t in tables)
    out = tjoin.sort_merge_join(left, right, ["key"], ["key"],
                                how="inner", columns={"id", "x_r"})
    assert out.schema.names == ["id", "x_r"]
    full = tjoin.sort_merge_join(left, right, ["key"], ["key"])
    assert full.schema.names[:3] == ["key", "nk", "s"]
    assert "key_r" in full.schema.names and "x_r" in full.schema.names


def test_broadcast_join_equals_counting_join(tables):
    """The direct-address join gives the counting join's rows for
    eligible (unique integer) build keys and declines string keys."""
    from hyperspace_tpu_torch.ops import broadcast_join as tbc

    left, right = tables
    build = right.slice(0, 6000)
    _, first = np.unique(build.column("key").to_numpy(), return_index=True)
    build = build.take(pa.array(np.sort(first)))
    for lane in ("host", "torch"):
        probe, dim = _batches(left, lane), _batches(build, lane)
        for how in ("inner", "left_outer"):
            li, ri = tbc.broadcast_join_indices(probe, dim, ["key"], ["key"],
                                                how)
            got = tbj.assemble_join_output(probe, dim, li, ri, how=how)
            want = tjoin.sort_merge_join(probe, dim, ["key"], ["key"],
                                         how=how)
            assert _rows(tcol.to_arrow(got)) == _rows(tcol.to_arrow(want))
        for anti in (False, True):
            idx = tbc.broadcast_membership(probe, _batches(right, lane),
                                           ["nk"], ["nk"], anti)
            want = tjoin.semi_anti_indices(probe, _batches(right, lane),
                                           ["nk"], ["nk"], anti=anti)
            assert sorted(_np(idx).tolist()) == sorted(_np(want).tolist())
        assert tbc.broadcast_join_indices(probe, dim, ["s"], ["s"],
                                          "inner") is None


# -- end to end through both packages ----------------------------------------


def _conf(cls, warehouse, **extra):
    # One device for the JAX package (it would otherwise shard over the
    # test session's virtual CPU mesh); broadcast off so every join type
    # takes the sort-merge join, as the reference's E2E suite does.
    conf = {"spark.hyperspace.warehouse.dir": str(warehouse),
            "spark.hyperspace.distribution.enabled": "false",
            "spark.hyperspace.broadcast.threshold": "-1"}
    conf.update(extra)
    return cls(conf)


SOURCES = ("left", "right16", "right8")


def _build(pkg, sess, root, num_buckets_of):
    hs = pkg.Hyperspace(sess)
    for name, included in (("left", ["id", "x"]), ("right16", ["val", "x"]),
                           ("right8", ["val", "x"])):
        sess.conf.set("spark.hyperspace.index.num.buckets",
                      str(num_buckets_of[name]))
        hs.create_index(sess.read_parquet(str(root / name)),
                        pkg.IndexConfig(f"{name}Idx", ["key"], included))


def _frames(sess, root):
    return {name: sess.read_parquet(str(root / name)) for name in SOURCES}


@pytest.fixture(scope="module")
def lake(tables, tmp_path_factory):
    """Three sources (left; two copies of the right data) and both
    packages' indexes over them: left at 16 buckets, right16 at 16,
    right8 at 8."""
    root = tmp_path_factory.mktemp("join_lake")
    left, right = tables
    for name, table in (("left", left), ("right16", right),
                        ("right8", right)):
        os.makedirs(root / name)
        half = table.num_rows // 2
        pq.write_table(table.slice(0, half), str(root / name / "a.parquet"))
        pq.write_table(table.slice(half), str(root / name / "b.parquet"))
    buckets = {"left": 16, "right16": 16, "right8": 8}
    jsess = JSession(_conf(jhs.HyperspaceConf, root / "jwh"))
    _build(jhs, jsess, root, buckets)
    tsess = ths.HyperspaceSession(_conf(ths.HyperspaceConf, root / "twh"),
                                  device="cpu")
    _build(ths, tsess, root, buckets)
    return {"root": root, "left": left, "right": right, "jsess": jsess,
            "jdfs": _frames(jsess, root)}


def _port_session(lake, warehouse, lane):
    extra = ({"spark.hyperspace.execution.min.device.rows": "0"}
             if lane == "torch" else {})
    sess = ths.HyperspaceSession(
        _conf(ths.HyperspaceConf, lake["root"] / warehouse, **extra),
        device="cpu")
    return sess, _frames(sess, lake["root"])


def _query(dfs, right, how):
    left = dfs["left"].select("key", "id", "x")
    return left.join(dfs[right].select("key", "val", "x"), on="key", how=how)


def _roots(plan):
    return [p for leaf in plan.collect_leaves() for p in leaf.root_paths]


@pytest.mark.parametrize("right", ["right16", "right8"])
@pytest.mark.parametrize("how", HOWS)
def test_end_to_end_join_equals_jax(lake, how, right):
    jsess, jdfs = lake["jsess"], lake["jdfs"]
    jsess.enable_hyperspace()
    jframe = _query(jdfs, right, how)
    expected = _rows(jframe.collect())
    jphys = jplan_physical(jsess.optimize(jframe.plan),
                           conf=jsess.conf).tree_string()
    assert ("Exchange" in jphys) == (right == "right8")
    if how == "inner":
        oracle = lake["left"].to_pandas()[["key", "id", "x"]].merge(
            lake["right"].to_pandas()[["key", "val", "x"]], on="key",
            suffixes=("", "_r"))
        assert expected == _rows(pa.table({
            "key": oracle["key"], "id": oracle["id"], "x": oracle["x"],
            "key_r": oracle["key"], "val": oracle["val"],
            "x_r": oracle["x_r"]}))

    for lane in ("host", "torch"):
        sess, dfs = _port_session(lake, "twh", lane)
        sess.enable_hyperspace()
        frame = _query(dfs, right, how)
        plan = sess.optimize(frame.plan)
        assert all("v__=" in r for r in _roots(plan)), _roots(plan)
        phys = plan_physical(plan, conf=sess.conf).tree_string()
        assert ("Exchange" in phys) == (right == "right8")
        assert "bucketed(16)" in phys
        before = partition_kernel.partition_ids_and_histogram.launches
        table, metrics = frame.collect(with_metrics=True)
        # On the CPU the partition runs its plain version: no launch.
        assert partition_kernel.partition_ids_and_histogram.launches \
            == before
        assert _rows(table) == expected, lane
        (smj,) = [op for op in metrics.operators
                  if op.name == "SortMergeJoin"]
        assert smj.detail["lane"] == ("host" if lane == "host"
                                      else "device")
        assert [op.name for op in metrics.operators].count("Exchange") \
            == (right == "right8")

    sess.disable_hyperspace()
    frame = _query(dfs, right, how)
    assert not any("v__=" in r for r in _roots(sess.optimize(frame.plan)))
    assert _rows(frame.collect()) == expected


@pytest.mark.parametrize("how", HOWS)
def test_small_side_broadcasts_like_jax(lake, how):
    """Rules off, default broadcast threshold: the small right side
    broadcasts (outer joins only on their inner side), as in the JAX
    package, with the same rows."""
    warehouse = {"spark.hyperspace.warehouse.dir":
                 str(lake["root"] / "unused")}
    jsess = JSession(jhs.HyperspaceConf({
        **warehouse, "spark.hyperspace.distribution.enabled": "false"}))
    sess = ths.HyperspaceSession(ths.HyperspaceConf(warehouse),
                                 device="cpu")
    jframe = _query(_frames(jsess, lake["root"]), "right16", how)
    frame = _query(_frames(sess, lake["root"]), "right16", how)
    jplan = jplan_physical(jsess.optimize(jframe.plan),
                           conf=jsess.conf).tree_string()
    tplan = plan_physical(sess.optimize(frame.plan),
                          conf=sess.conf).tree_string()
    assert ("BroadcastHashJoin" in tplan) == ("BroadcastHashJoin" in jplan) \
        == (how != "full_outer")
    assert _rows(frame.collect()) == _rows(jframe.collect())


@pytest.mark.parametrize("right", ["right16", "right8"])
def test_each_package_serves_the_others_join_indexes(lake, right):
    """The on-lake index is the state: the port answers from the JAX
    package's indexes, and the JAX package from the port's."""
    root = lake["root"]
    sess, dfs = _port_session(lake, "jwh", "torch")
    sess.enable_hyperspace()
    frame = _query(dfs, right, "inner")
    roots = _roots(sess.optimize(frame.plan))
    assert roots and all(r.startswith(str(root / "jwh")) and "v__=" in r
                         for r in roots)
    got = _rows(frame.collect())

    jsess = JSession(_conf(jhs.HyperspaceConf, root / "twh"))
    jsess.enable_hyperspace()
    jframe = _query(_frames(jsess, root), right, "inner")
    jroots = _roots(jsess.optimize(jframe.plan))
    assert jroots and all(r.startswith(str(root / "twh")) and "v__=" in r
                          for r in jroots)
    assert got == _rows(jframe.collect())
    assert len(got[0]) > N_LEFT


def test_cross_join_raises_a_typed_error(lake):
    from hyperspace_tpu_torch.exceptions import HyperspaceException

    # 40,000 x 20,000 rows: over the cross join's row guard.
    _, dfs = _port_session(lake, "twh", "host")
    frame = dfs["left"].select("id").join(dfs["right16"].select("val"),
                                          how="cross")
    with pytest.raises(HyperspaceException, match="refusing"):
        frame.collect()


def test_join_plan_round_trips_through_serde(lake):
    from hyperspace_tpu_torch.plan.serde import plan_from_json, plan_to_json

    _, dfs = _port_session(lake, "twh", "host")
    plan = _query(dfs, "right8", "full_outer").plan
    again = plan_from_json(plan_to_json(plan))
    assert again.to_dict() == plan.to_dict()
    assert again.schema.names == ["key", "id", "x", "key_r", "val", "x_r"]


@pytest.mark.parametrize("lane", ["host", "torch"])
def test_filtered_and_coarser_left_sides_equal_jax(lake, lane):
    """A filter on a join side keeps the bucketed layout (rows stay in
    bucket order, lengths shrink per bucket); when the LEFT side is the
    coarser index, it is the side re-bucketed through the Exchange."""
    from hyperspace_tpu.plan import expr as JE
    from hyperspace_tpu_torch.plan import expr as TE

    def queries(E, dfs):
        left = (dfs["left"].filter((E.col("x") > E.lit(0.5))
                                   & (E.col("key") < E.lit(5000)))
                .select("key", "id", "x"))
        filtered = left.join(dfs["right16"].select("key", "val"), on="key",
                             how="left_outer")
        coarse_left = dfs["right8"].select("key", "val").join(
            dfs["left"].select("key", "id"), on="key")
        return filtered, coarse_left

    jsess = lake["jsess"]
    jsess.enable_hyperspace()
    sess, dfs = _port_session(lake, "twh", lane)
    sess.enable_hyperspace()
    for jframe, frame, exchange in zip(queries(JE, lake["jdfs"]),
                                       queries(TE, dfs), (False, True)):
        plan = sess.optimize(frame.plan)
        assert all("v__=" in r for r in _roots(plan))
        tree = plan_physical(plan, conf=sess.conf).tree_string()
        assert ("Exchange" in tree) == exchange, tree
        assert "bucketed(16)" in tree
        assert _rows(frame.collect()) == _rows(jframe.collect())


@pytest.mark.parametrize("lane", ["host", "torch"])
def test_general_path_sort_exec_equals_jax(lake, lane):
    """The general path's Sort(Exchange(...)) wrapper, executed on its
    own, gives the JAX package's rows in the JAX package's order: the
    Exchange groups stably by bucket, the sort is stable and puts nulls
    first."""
    from hyperspace_tpu_torch.engine.physical import SortExec

    sess, dfs = _port_session(lake, "twh", lane)
    frame = dfs["left"].select("key", "id").join(
        dfs["right16"].select("key", "val"), on="key")
    tree = plan_physical(sess.optimize(frame.plan), conf=sess.conf)
    (smj,) = [n for n in tree.collect() if n.name == "SortMergeJoin"]
    jsess = JSession(_conf(jhs.HyperspaceConf, lake["root"] / "jwh"))
    jframe = _frames(jsess, lake["root"])["left"].select("key", "id").join(
        _frames(jsess, lake["root"])["right16"].select("key", "val"),
        on="key")
    jtree = jplan_physical(jsess.optimize(jframe.plan), conf=jsess.conf)
    (jsmj,) = [n for n in jtree.collect() if n.name == "SortMergeJoin"]
    for node, jnode in zip(smj.children, jsmj.children):
        assert isinstance(node, SortExec)
        assert node.simple_string() == jnode.simple_string()
        got = tcol.to_arrow(node.execute())
        assert got.equals(jcol.to_arrow(jnode.execute()))
        assert got.num_rows in (N_LEFT, N_RIGHT)
