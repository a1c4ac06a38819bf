"""Window functions through both packages, on the CPU.

The same seeded tables go through the JAX package's
`ops/window.window_compute` and the port's, for every function (rank,
dense_rank, row_number; sum, avg, min, max, count of values and of rows),
with and without ORDER BY (whole-partition and running RANGE frames),
over ascending and descending order keys with ties, nulls in partition
and order keys, string partition keys, and n in {1, 127, 4097}. The
port's host lane must give the JAX host lane's columns, its torch lane
(torch on the CPU) the JAX device lane's, element for element in the
input row order: integers, ranks, counts and validity exactly, float64
within rtol=1e-9 (the running float sums add along another tree than
XLA's associative scan). The float inputs are mostly positive, so no
partial sum cancels to near zero, where two orders of addition may
differ by more than that relative bound.
"""

import math

import numpy as np
import pyarrow as pa
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401
import torch

from hyperspace_tpu.io import columnar as jcol
from hyperspace_tpu.ops import window as jwin
from hyperspace_tpu.plan import nodes as jnodes

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.io import columnar as tcol
from hyperspace_tpu_torch.ops import window as twin
from hyperspace_tpu_torch.plan import nodes as tnodes

# The suite runs in parallel worker processes; one torch thread per worker
# keeps torch's spinning OpenMP pool from starving the other workers.
torch.set_num_threads(1)

CPU = torch.device("cpu")
RTOL = 1e-9


def _table(n: int, seed: int = 5) -> pa.Table:
    rng = np.random.default_rng([seed, n])
    words = np.array(["ant", "bee", "cat", "dog", "eel"])
    null = rng.random(n) < 0.2
    return pa.table({
        "k32": rng.integers(0, 5, n).astype(np.int32),
        "s": rng.choice(words, n),
        "ng": pa.array(rng.integers(0, 3, n).astype(np.int64),
                       mask=rng.random(n) < 0.15),
        "ns": pa.array(rng.choice(words[:3], n), mask=rng.random(n) < 0.1),
        "nk": pa.array(rng.integers(0, 4, n).astype(np.int64),
                       mask=rng.random(n) < 0.15),
        "fk": rng.choice(np.array([-0.0, 0.0, 1.5, -2.25]), n),
        "iv": rng.integers(-1000, 1000, n).astype(np.int64),
        "i32v": rng.integers(-50, 50, n).astype(np.int32),
        "fv": rng.random(n) * 1e3 - 10.0,
        "niv": pa.array(rng.integers(-9, 9, n).astype(np.int64), mask=null),
        "nfv": pa.array(rng.random(n) * 10.0 - 0.5, mask=null),
        "nsv": pa.array(rng.choice(words, n), mask=null),
    })


AGGS = [("count", "*", "n_rows"), ("count", "niv", "c_niv"),
        ("count", "nsv", "c_nsv"),
        ("sum", "iv", "s_iv"), ("sum", "i32v", "s_i32v"),
        ("sum", "fv", "s_fv"), ("sum", "niv", "s_niv"),
        ("sum", "nfv", "s_nfv"),
        ("avg", "iv", "a_iv"), ("avg", "nfv", "a_nfv"),
        ("min", "i32v", "mn_i32v"), ("min", "nfv", "mn_nfv"),
        ("max", "iv", "mx_iv"), ("max", "niv", "mx_niv")]
RANKS = [("rank", "*", "rk"), ("dense_rank", "*", "drk"),
         ("row_number", "*", "rn")]

PARTITIONS = ([], ["k32"], ["s"], ["ng"], ["k32", "ns"])
ORDERS = ([], ["fv"], ["-iv"], ["nk", "-fk"])


def _specs_for(order):
    if order:
        return RANKS + AGGS
    return [("row_number", "*", "rn")] + AGGS


def _schema_of(pkg_nodes, batch_schema, partition, order, specs):
    class _Child:
        schema = batch_schema
    parsed = [pkg_nodes.AggSpec(*s) for s in specs]
    return parsed, pkg_nodes.Window(partition, order, parsed,
                                    _Child()).schema


def _jax(table, partition, order, specs, lane):
    batch = jcol.from_arrow(table, device=lane == "device")
    parsed, schema = _schema_of(jnodes, batch.schema, partition, order,
                                specs)
    return jcol.to_arrow(jwin.window_compute(batch, partition, order,
                                             parsed, schema))


def _port(table, partition, order, specs, lane):
    batch = (tcol.from_arrow(table) if lane == "host"
             else tcol.from_arrow(table, device=CPU))
    parsed, schema = _schema_of(tnodes, batch.schema, partition, order,
                                specs)
    out = twin.window_compute(batch, partition, order, parsed, schema)
    assert out.is_host == (lane == "host")
    return tcol.to_arrow(out)


def _assert_same(got: pa.Table, want: pa.Table):
    assert got.column_names == want.column_names
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        g, w = got.column(name).to_pylist(), want.column(name).to_pylist()
        if pa.types.is_floating(want.schema.field(name).type):
            assert [v is None for v in g] == [v is None for v in w], name
            for a, b in zip(g, w):
                if a is not None:
                    assert math.isclose(a, b, rel_tol=RTOL, abs_tol=1e-12), \
                        (name, a, b)
        else:
            assert g == w, name


@pytest.mark.parametrize("lane", ["host", "torch"])
@pytest.mark.parametrize("order", ORDERS, ids=lambda o: "-".join(o) or "none")
@pytest.mark.parametrize("partition", PARTITIONS,
                         ids=lambda p: "-".join(p) or "none")
@pytest.mark.parametrize("n", [1, 127, 4097])
def test_window_matches_jax(n, partition, order, lane):
    table = _table(n)
    specs = _specs_for(order)
    got = _port(table, partition, order, specs, lane)
    want = _jax(table, partition, order, specs,
                "host" if lane == "host" else "device")
    _assert_same(got, want)


@pytest.mark.parametrize("lane", ["host", "torch"])
def test_empty_input(lane):
    table = _table(5).slice(0, 0)
    specs = RANKS + AGGS
    got = _port(table, ["k32"], ["fv"], specs, lane)
    want = _jax(table, ["k32"], ["fv"], specs,
                "host" if lane == "host" else "device")
    assert got.num_rows == 0
    assert got.schema.equals(want.schema)


@pytest.mark.parametrize("lane", ["host", "torch"])
def test_string_input_raises(lane):
    table = _table(8)
    with pytest.raises(HyperspaceException, match="over string column"):
        _port(table, ["k32"], [], [("max", "nsv", "m")], lane)


def test_window_node_validation_and_serde():
    """The node keeps the JAX package's checks and error texts, and its
    JSON reads back in the other package."""
    from hyperspace_tpu.plan import serde as jserde

    from hyperspace_tpu_torch.plan import serde as tserde

    class _Child:
        schema = tcol.from_arrow(_table(4)).schema

    def window(*specs, order=()):
        return tnodes.Window(["k32"], list(order),
                             [tnodes.AggSpec(*s) for s in specs], _Child())

    with pytest.raises(HyperspaceException, match="requires an ORDER BY"):
        window(("rank", "*", "r"))
    with pytest.raises(HyperspaceException, match="requires a column"):
        window(("sum", "*", "t"))
    with pytest.raises(HyperspaceException, match="collides"):
        window(("count", "*", "iv"))
    with pytest.raises(HyperspaceException, match="at least one spec"):
        tnodes.Window(["k32"], [], [], _Child())
    with pytest.raises(HyperspaceException, match="Unsupported aggregate"):
        tnodes.Aggregate(["k32"], [tnodes.AggSpec("rank", "*", "r")],
                         _Child())

    ths_table = _table(16)
    import pyarrow.parquet as pq
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        pq.write_table(ths_table, f"{tmp}/p.parquet")
        import hyperspace_tpu_torch as ths
        sess = ths.HyperspaceSession(ths.HyperspaceConf(
            {"spark.hyperspace.warehouse.dir": f"{tmp}/wh"}), device="cpu")
        df = sess.read_parquet(tmp).window(
            ["k32"], order_by=["-fv"], rk=("rank", "*"), t=("sum", "iv"))
        text = tserde.plan_to_json(df.plan)
        jplan = jserde.plan_from_json(text)
        assert jplan.to_dict() == df.plan.to_dict()
        back = tserde.plan_from_json(jserde.plan_to_json(jplan))
        assert back.to_dict() == df.plan.to_dict()
        got = df.to_pandas()
        assert len(got) == 16 and list(got.columns)[-2:] == ["rk", "t"]
