"""The comparison that decides `correct`: a served result against the
plain reference's result for the same query on the same lake.

Plain NumPy and pandas; nothing of the program is imported. The
reference's own column types decide how each column is compared:

- every column that is floating point in the reference is compared by
  its widest gap, |got - want| / max(|want|, 1): relative above 1 and
  absolute below, so sums of money and averages of discounts read alike;
- every other column (keys, counts, strings, dates) must be equal;
- the column names, their order and the row count must be equal, and a
  null must meet a null.

Rows are matched after both sides are sorted by the reference's exact
columns first and its floating columns after them, so that rounding in a
float cannot reorder rows whose keys differ.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import pandas as pd


@dataclass
class Verdict:
    exact: bool              # every exact column, shape and null agrees
    gap: float               # widest float gap (0.0 with no float cells)
    reason: str = ""


def _float_columns(want: pd.DataFrame) -> List[str]:
    return [c for c in want.columns if want[c].dtype.kind == "f"]


def _prepare(df: pd.DataFrame, floats: List[str]) -> pd.DataFrame:
    out = df.copy()
    for c in out.columns:
        if c in floats:
            out[c] = pd.to_numeric(out[c], errors="coerce").astype("float64")
        elif out[c].dtype == object:
            first = out[c].dropna()
            if len(first) and not isinstance(first.iloc[0], str):
                out[c] = out[c].map(lambda v: None if v is None else str(v))
        elif out[c].dtype.kind in "iub":
            out[c] = out[c].astype("float64")
    exact = [c for c in out.columns if c not in floats]
    if len(out):
        out = out.sort_values(exact + floats, kind="mergesort",
                              na_position="last")
    return out.reset_index(drop=True)


def normalize(want: pd.DataFrame) -> pd.DataFrame:
    """The reference's result as every comparison reads it."""
    return _prepare(want, _float_columns(want))


def compare(got: pd.DataFrame, want: pd.DataFrame,
            want_normalized: Optional[pd.DataFrame] = None) -> Verdict:
    if list(got.columns) != list(want.columns):
        return Verdict(False, 0.0, f"columns {list(got.columns)}")
    if len(got) != len(want):
        return Verdict(False, 0.0, f"{len(got)} rows, want {len(want)}")
    floats = _float_columns(want)
    g = _prepare(got, floats)
    w = want_normalized if want_normalized is not None else normalize(want)
    for c in w.columns:
        if c in floats:
            continue
        a, b = g[c], w[c]
        same = (a == b) | (a.isna() & b.isna())
        if not bool(same.all()):
            i = int(np.flatnonzero(~same.to_numpy())[0])
            return Verdict(False, 0.0,
                           f"column {c} row {i}: {a.iloc[i]!r} != {b.iloc[i]!r}")
    gap = 0.0
    for c in floats:
        a = g[c].to_numpy()
        b = w[c].to_numpy()
        na, nb = np.isnan(a), np.isnan(b)
        if not np.array_equal(na, nb):
            return Verdict(False, 0.0, f"column {c}: nulls differ")
        keep = ~nb
        if keep.any():
            d = np.abs(a[keep] - b[keep]) / np.maximum(np.abs(b[keep]), 1.0)
            gap = max(gap, float(d.max()))
    return Verdict(True, gap)


def lower_precision(tables: Dict[str, pd.DataFrame]) -> Dict[str, pd.DataFrame]:
    """The control's inputs: every float64 column of the lake as float32,
    the nearest precision below the float64 the configurations state."""
    return {name: df.astype({c: "float32" for c in df.columns
                             if df[c].dtype == np.float64})
            for name, df in tables.items()}
