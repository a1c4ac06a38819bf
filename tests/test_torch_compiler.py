"""The PyTorch port's expression compiler against the JAX package's.

One table with nulls, strings, integers and floats (made from a seed with
numpy) is filtered and projected by both packages, on the host lane
(numpy) and on the device lane (torch on the CPU here; XLA on the CPU for
the JAX package). Integer and string results must be identical; float
columns are compared bit for bit too, since both evaluate the same IEEE
float64 operations elementwise.
"""

import numpy as np
import pyarrow as pa
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401
import torch

from hyperspace_tpu.engine import compiler as jcomp
from hyperspace_tpu.io import columnar as jcol
from hyperspace_tpu.plan import expr as JE

# The suite runs in parallel worker processes; one torch thread per worker
# keeps torch's spinning OpenMP pool from starving the other workers.
torch.set_num_threads(1)

from hyperspace_tpu_torch.engine import compiler as tcomp
from hyperspace_tpu_torch.io import columnar as tcol
from hyperspace_tpu_torch.plan import expr as TE

N = 3000


def _table():
    rng = np.random.default_rng(11)
    return pa.table({
        "i": pa.array(rng.integers(-50, 50, N).astype(np.int64),
                      mask=rng.random(N) < 0.1),
        "j": rng.integers(0, 7, N).astype(np.int32),
        "f": pa.array(rng.standard_normal(N), mask=rng.random(N) < 0.05),
        "s": pa.array([None if x == 0 else f"w{x:02d}"
                       for x in rng.integers(0, 40, N)]),
        "t": pa.array([f"v{x}" for x in rng.integers(0, 30, N)]),
    })


def _predicates(E):
    c, lit = E.col, E.lit
    return {
        "cmp_and": (c("i") > lit(10)) & (c("j") <= lit(3)),
        "or_with_nulls": (c("i") < lit(-40)) | (c("f") > lit(1.0)),
        "not_null_aware": ~(c("i") == lit(0)),
        "is_null": c("s").is_null() | c("f").is_null(),
        "is_not_null": c("i").is_not_null() & (c("j") != lit(2)),
        "int_in": c("i").isin(1, 2, 3, -7),
        "string_eq": c("s") == lit("w07"),
        "string_range": (c("s") >= lit("w10")) & (c("s") < lit("w2")),
        "string_absent": c("s") == lit("nope"),
        "string_lit_left": lit("w30") < c("s"),
        "string_in": c("t").isin("v1", "v29", "zz"),
        "string_col_col": c("s") > c("t"),
        "like": c("t").like("v1%"),
        "arith": (c("i") * lit(2) + c("j")) > lit(20),
        "division": (c("f") / c("j")) > lit(0.25),
        # 25j * 0.2 equals 5j in float64; a float literal rounded to
        # float32 first makes it larger (TPC-H q17's `avg * 0.2`)
        "float_literal": (c("j") * lit(5)) < (c("j") * lit(25) * lit(0.2)),
        # int64 values past 2^24 against a float literal: equal in float32
        "int_vs_float_literal": (c("i") + lit(16777217)) > lit(16777216.5),
        "literal_left": lit(5) > c("j"),
        "bool_literal": lit(True),
    }


def _values(E):
    c, lit = E.col, E.lit
    return {
        "sum": (c("i") + c("j"), "int64"),
        "ratio": (c("i") / c("j"), "float64"),
        "floor": (E.Floor(c("f") * lit(3)), "int64"),
        "case": (E.when(c("j") > lit(3), c("i")).otherwise(lit(-1)),
                 "int64"),
        "case_no_else": (E.when(c("s") == lit("w05"), c("f")), "float64"),
    }


def _torch_batch(table, lane):
    device = None if lane == "host" else torch.device("cpu")
    return tcol.from_arrow(table, device=device)


def _jax_batch(table, lane):
    return jcol.from_arrow(table, device=lane == "device")


@pytest.mark.parametrize("lane", ["host", "device"])
@pytest.mark.parametrize("name", sorted(_predicates(TE)))
def test_filter_matches_jax(lane, name):
    table = _table()
    got = tcomp.apply_filter(_torch_batch(table, lane), _predicates(TE)[name])
    want = jcomp.apply_filter(_jax_batch(table, lane), _predicates(JE)[name])
    assert got.is_host == (lane == "host")
    assert tcol.to_arrow(got).equals(jcol.to_arrow(want))


@pytest.mark.parametrize("lane", ["host", "device"])
@pytest.mark.parametrize("name", sorted(_values(TE)))
def test_value_column_matches_jax(lane, name):
    table = _table()
    texpr, dtype = _values(TE)[name]
    jexpr, _ = _values(JE)[name]
    tc = tcomp.ExpressionCompiler(_torch_batch(table, lane)).value_column(
        texpr, dtype)
    jc = jcomp.ExpressionCompiler(_jax_batch(table, lane)).value_column(
        jexpr, dtype)
    tdata = tcol._to_numpy(tc.data)
    jdata = np.asarray(jc.data)
    assert tdata.dtype == jdata.dtype
    tvalid = (np.ones(N, bool) if tc.validity is None
              else tcol._to_numpy(tc.validity))
    jvalid = (np.ones(N, bool) if jc.validity is None
              else np.asarray(jc.validity))
    assert (tvalid == jvalid).all()
    assert tdata[tvalid].tobytes() == jdata[jvalid].tobytes()
