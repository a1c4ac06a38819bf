"""The comparison that decides `correct`, and the port against the plain
reference on a tiny lake on the CPU, through a whole run of each cell."""

import datetime

import numpy as np
import pandas as pd
import pytest

from benchmark.reference.compare import compare, normalize
from benchmark.tests.cells import run_tiny
from benchmark.tests.test_bench_spec import CELLS


def _want():
    return pd.DataFrame({"k": ["a", "b", "c"], "n": [1, 2, 3],
                         "d": [datetime.date(1995, 1, i) for i in (1, 2, 3)],
                         "x": [1000.0, 0.05, np.nan]})


def test_equal_results_in_another_row_order_agree():
    want = _want()
    got = want.iloc[[2, 0, 1]].reset_index(drop=True)
    got["n"] = got["n"].astype("float64")
    v = compare(got, want, normalize(want))
    assert v.exact and v.gap == 0.0


def test_float_gap_is_relative_above_one_and_absolute_below():
    want = _want()
    got = want.copy()
    got.loc[0, "x"] = 1000.0 * (1 + 1e-7)
    got.loc[1, "x"] = 0.05 + 3e-9
    v = compare(got, want)
    assert v.exact and v.gap == pytest.approx(1e-7, rel=1e-3)


@pytest.mark.parametrize("change", ["key", "count", "date", "null", "row",
                                    "column"])
def test_exact_columns_shape_and_nulls_must_agree(change):
    want = _want()
    got = want.copy()
    if change == "key":
        got.loc[1, "k"] = "z"
    elif change == "count":
        got.loc[1, "n"] = 7
    elif change == "date":
        got.loc[1, "d"] = datetime.date(1996, 1, 2)
    elif change == "null":
        got.loc[2, "x"] = 0.0
    elif change == "row":
        got = got.iloc[:2]
    else:
        got = got.rename(columns={"x": "y"})
    assert not compare(got, want).exact


@pytest.mark.parametrize("name", CELLS)
def test_the_port_agrees_with_the_reference_on_a_tiny_lake(name):
    r = run_tiny(name, seconds=1.0)
    assert r["correct"], r["compared"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["compared"]["wrong_results"]["value"] == 0
    from benchmark.tests.cells import tiny_cell
    assert set(r["metrics"]) == {m["name"] for m in tiny_cell(name).end_to_end}
    assert list(r)[-1] == "compared"
