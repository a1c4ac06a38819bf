"""Set operations, scalar subqueries, temp views and `create_dataframe`
through the port, on the CPU, against the JAX package.

- INTERSECT / EXCEPT (SQL DISTINCT set semantics, NULL == NULL): the
  port's `set_op_indices` on its host and torch lanes gives the JAX
  package's host and device lanes' indices, in the same first-occurrence
  order, over nullable int, float and string keys (the two sides' string
  dictionaries differ) and empty sides; the DataFrame verbs give the JAX
  package's rows.
- Scalar subqueries, as in `tests/test_setops.py`: in a filter (both
  lanes), an empty subquery is SQL NULL, a multi-row one raises, the plan
  round-trips through JSON in both packages, and an int column compared
  with a float scalar compares in float64.
- Temp views expand to their plan (the rules see the relation) and
  `create_dataframe` spills an Arrow or pandas table to Parquet.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401
import torch

import hyperspace_tpu as jhs
from hyperspace_tpu.io import columnar as jcol
from hyperspace_tpu.ops import setops as jsetops
from hyperspace_tpu.plan import serde as jserde

import hyperspace_tpu_torch as ths
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.io import columnar as tcol
from hyperspace_tpu_torch.ops import setops as tsetops
from hyperspace_tpu_torch.plan import serde as tserde
from hyperspace_tpu_torch.plan.expr import col, lit

# The suite runs in parallel worker processes; one torch thread per worker
# keeps torch's spinning OpenMP pool from starving the other workers.
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _side(n: int, seed: int, words) -> pa.Table:
    rng = np.random.default_rng([seed, n])
    return pa.table({
        "k": pa.array(rng.integers(0, 6, n).astype(np.int64),
                      mask=rng.random(n) < 0.2),
        "f": rng.choice(np.array([-0.0, 0.0, 2.5]), n),
        "i": rng.integers(0, 3, n).astype(np.int32),
        "s": pa.array(rng.choice(np.array(words), n),
                      mask=rng.random(n) < 0.1),
    })


def _indices(left, right, names, anti, lane, pkg):
    if pkg == "jax":
        lb = jcol.from_arrow(left, device=lane == "device")
        rb = jcol.from_arrow(right, device=lane == "device")
        return np.asarray(jsetops.set_op_indices(lb, rb, names, anti))
    device = None if lane == "host" else CPU
    lb = tcol.from_arrow(left, device=device)
    rb = tcol.from_arrow(right, device=device)
    idx = tsetops.set_op_indices(lb, rb, names, anti)
    if lane == "torch" and len(idx):
        assert isinstance(idx, torch.Tensor)
    return np.asarray(idx)


@pytest.mark.parametrize("lane", ["host", "torch"])
@pytest.mark.parametrize("anti", [False, True], ids=["intersect", "except"])
@pytest.mark.parametrize("names", [["k"], ["s"], ["k", "s"], ["f", "i", "s"],
                                   ["k", "f", "i", "s"]], ids="-".join)
@pytest.mark.parametrize("sizes", [(1, 1), (127, 60), (4097, 2000), (0, 30),
                                   (40, 0)])
def test_set_op_indices_match_jax(sizes, names, anti, lane):
    n, m = sizes
    # Different vocabularies: each side's string dictionary holds words
    # the other lacks.
    left = _side(n, 1, ["ant", "bee", "cat", "dog"])
    right = _side(m, 2, ["bee", "cat", "dog", "elk", "fox"])
    got = _indices(left, right, names, anti, lane, "port")
    want = _indices(left, right, names, anti,
                    "host" if lane == "host" else "device", "jax")
    assert got.tolist() == want.tolist()


@pytest.fixture
def env(tmp_path):
    a_dir, b_dir = tmp_path / "a", tmp_path / "b"
    a_dir.mkdir(), b_dir.mkdir()
    pq.write_table(pa.table({
        "k": pa.array([1, 1, 2, 3, None, None, 7], type=pa.int64()),
        "s": pa.array(["x", "x", "y", "z", "n", "n", "q"]),
    }), str(a_dir / "p.parquet"))
    pq.write_table(pa.table({
        "k": pa.array([1, 2, None, 9], type=pa.int64()),
        "s": pa.array(["x", "OTHER", "n", "q"]),
    }), str(b_dir / "p.parquet"))

    def session(lane="host"):
        conf = {"spark.hyperspace.warehouse.dir": str(tmp_path / "wh")}
        if lane == "torch":
            conf["spark.hyperspace.execution.min.device.rows"] = "0"
        return ths.HyperspaceSession(ths.HyperspaceConf(conf), device="cpu")

    def jax_session():
        return jhs.HyperspaceSession(jhs.HyperspaceConf({
            "hyperspace.warehouse.dir": str(tmp_path / "jwh"),
            "spark.hyperspace.distribution.enabled": "false"}))

    return session, jax_session, str(a_dir), str(b_dir)


def _rows(df: pd.DataFrame):
    return list(map(tuple, df.fillna(-99).values))


@pytest.mark.parametrize("lane", ["host", "torch"])
def test_intersect_and_except(env, lane):
    session, jax_session, a, b = env
    sess, jsess = session(lane), jax_session()
    adf, bdf = sess.read_parquet(a), sess.read_parquet(b)
    jadf, jbdf = jsess.read_parquet(a), jsess.read_parquet(b)

    inter = adf.intersect(bdf).to_pandas()
    # DISTINCT rows of a present in b; (None,"n") == (None,"n") — SQL
    # set ops group NULLs, so the null row IS in the intersection.
    assert sorted(_rows(inter)) == sorted([(1, "x"), (-99, "n")])
    assert _rows(inter) == _rows(jadf.intersect(jbdf).to_pandas())

    exc = adf.except_(bdf).to_pandas()
    assert sorted(_rows(exc)) == sorted([(2, "y"), (3, "z"), (7, "q")])
    assert _rows(exc) == _rows(jadf.except_(jbdf).to_pandas())

    # An empty side.
    none = bdf.filter(col("k") == lit(-5))
    assert len(adf.intersect(none).to_pandas()) == 0
    assert sorted(_rows(adf.except_(none).to_pandas())) == sorted(
        [(1, "x"), (2, "y"), (3, "z"), (-99, "n"), (7, "q")])
    assert len(none.except_(adf).to_pandas()) == 0

    # UNION ALL keeps duplicates; .distinct() makes it a DISTINCT union.
    assert len(adf.union(bdf).to_pandas()) == 11
    assert len(adf.union(bdf).distinct().to_pandas()) == 7


def test_setop_serde_round_trip_across_packages(env):
    session, _, a, b = env
    sess = session()
    for plan in (sess.read_parquet(a).intersect(sess.read_parquet(b)).plan,
                 sess.read_parquet(a).except_(sess.read_parquet(b)).plan):
        text = tserde.plan_to_json(plan)
        assert tserde.plan_from_json(text).to_dict() == plan.to_dict()
        assert jserde.plan_from_json(text).to_dict() == plan.to_dict()


def test_setop_rejects_misaligned_columns(env):
    session, _, a, b = env
    sess = session()
    with pytest.raises(HyperspaceException, match="share column"):
        sess.read_parquet(a).select("k").intersect(
            sess.read_parquet(b).select("s"))


@pytest.mark.parametrize("lane", ["host", "torch"])
def test_scalar_subquery_in_filter(env, lane):
    session, _, a, b = env
    sess = session(lane)
    adf = sess.read_parquet(a)
    # k > avg(k of b where k not null) = (1+2+9)/3 = 4.0
    avg_b = (sess.read_parquet(b).agg(("avg", "k", "a"))).as_scalar()
    out = adf.filter(col("k") > avg_b).to_pandas()
    assert sorted(out["k"].tolist()) == [7]
    # Arithmetic over the scalar: k > 0.5 * avg = 2.0
    out2 = adf.filter(col("k") > lit(0.5) * avg_b).to_pandas()
    assert sorted(out2["k"].tolist()) == [3, 7]


@pytest.mark.parametrize("lane", ["host", "torch"])
def test_int_column_against_float_scalar(env, tmp_path, lane):
    """The resolved float compiles as a float64 literal: an int column
    compared with it must not see a float32-rounded value."""
    session, _, a, _ = env
    sess = session(lane)
    (tmp_path / "c").mkdir()
    pq.write_table(pa.table({"x": pa.array([0.2000000004],
                                           type=pa.float64())}),
                   str(tmp_path / "c" / "p.parquet"))
    pq.write_table(pa.table({"q": pa.array([5, 4, 6], type=pa.int64())}),
                   str(tmp_path / "c2.parquet"))
    scalar = (sess.read_parquet(str(tmp_path / "c"))
              .select((col("x") * lit(25.0)).alias("t")).as_scalar())
    qdf = sess.read_parquet(str(tmp_path / "c2.parquet"))
    # The scalar is 5.00000001 in float64; as a float32 it would read 5.0
    # and drop q = 5 from `q < scalar`.
    assert sorted(qdf.filter(col("q") < scalar).to_pandas()["q"]) == [4, 5]
    assert sorted(qdf.filter(col("q") > scalar).to_pandas()["q"]) == [6]


def test_scalar_subquery_empty_is_null(env):
    session, _, a, b = env
    sess = session()
    adf = sess.read_parquet(a)
    empty = (sess.read_parquet(b).filter(col("k") == lit(-1))
             .agg(("max", "k", "m")).filter(col("m").is_not_null())
             .select("m")).as_scalar()
    # NULL comparison is not-true for every row: empty result.
    assert len(adf.filter(col("k") > empty).to_pandas()) == 0


def test_scalar_subquery_multirow_raises(env):
    session, _, a, b = env
    sess = session()
    adf = sess.read_parquet(a)
    multi = sess.read_parquet(b).select("k").as_scalar()
    with pytest.raises(HyperspaceException, match="returned 4 rows"):
        adf.filter(col("k") > multi).to_pandas()
    with pytest.raises(HyperspaceException, match="exactly one column"):
        sess.read_parquet(b).as_scalar()


def test_scalar_subquery_serde_round_trip(env):
    session, _, a, b = env
    sess = session()
    adf = sess.read_parquet(a)
    avg_b = (sess.read_parquet(b).agg(("avg", "k", "a"))).as_scalar()
    plan = adf.filter(col("k") > avg_b).plan
    text = tserde.plan_to_json(plan)
    assert "scalar_subquery" in text
    # Unresolved round trip (values never serialize into fresh plans),
    # read back by both packages.
    again = tserde.plan_from_json(text)
    assert jserde.plan_from_json(text).to_dict() == plan.to_dict()
    assert again.to_dict() == plan.to_dict()
    # The deserialized plan executes and resolves independently.
    from hyperspace_tpu_torch.engine.executor import execute_plan
    out = tcol.to_arrow(execute_plan(again, conf=sess.conf)).to_pandas()
    assert sorted(out["k"].tolist()) == [7]


def test_temp_views_and_create_dataframe(env, tmp_path):
    session, _, a, b = env
    sess = session()
    hs = ths.Hyperspace(sess)
    adf = sess.read_parquet(a)
    hs.create_index(adf, ths.IndexConfig("vk", ["k"], ["s"]))
    adf.filter(col("k") > lit(1)).create_or_replace_temp_view("big")
    view = sess.table("BIG")
    assert sorted(view.to_pandas()["k"].tolist()) == [2, 3, 7]
    # The view expands to its plan, so the filter rule sees the relation.
    sess.enable_hyperspace()
    leaves = sess.optimize(sess.table("big").select("k", "s").plan) \
        .collect_leaves()
    assert [leaf.index_name for leaf in leaves] == ["vk"]
    sess.disable_hyperspace()
    with pytest.raises(HyperspaceException, match="already exists"):
        sess.create_temp_view("big", adf)
    sess.create_or_replace_temp_view("big", sess.read_parquet(b))
    assert len(sess.table("big").to_pandas()) == 4
    assert sess.drop_temp_view("big") is True
    assert sess.drop_temp_view("big") is False
    with pytest.raises(HyperspaceException, match="Unknown table or view"):
        sess.table("big")

    pdf = pd.DataFrame({"x": [3, 1, 2], "y": ["c", "a", "b"]})
    for source in (pdf, pa.Table.from_pandas(pdf, preserve_index=False)):
        df = sess.create_dataframe(source)
        assert df.columns == ["x", "y"]
        got = df.sort("x").to_pandas()
        assert got["x"].tolist() == [1, 2, 3]
        assert got["y"].tolist() == ["a", "b", "c"]
