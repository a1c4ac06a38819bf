"""Sketch consultation: which files can a predicate refute?

THE one home of data-skipping pruning decisions (`load_sketches` /
`prune_files` are called only from `plan/rules/` and the blob-IO module
`index/sketch.py`). `FilterIndexRule` calls `prune_files` at PLAN time
with the filter condition and a scan's file listing; every decision
here is a REFUTATION — a file is dropped only when no row in it can
make the predicate true — so pruning is bit-identical by construction,
and anything uncertain (unsketched column, unrepresentable literal,
rewritten file, unsupported operator) keeps the file.

Soundness notes (pinned by the no-false-negative property test in
`tests/test_torch_skipping.py`):

- Zone bounds exclude NULLs and NaNs. Comparison predicates cannot be
  satisfied by either (SQL null semantics; IEEE NaN compares false), so
  range refutation over the ok-rows' min/max is exact. `ne` is the one
  operator NaN CAN satisfy (`NaN != v` is true) — it consults
  `has_nan`.
- Literals canonicalize into the column's value space the same way the
  compiled engine does (float32 columns round the literal to float32;
  integer columns with a non-integral float literal never match
  anything, but canonicalization declines rather than guessing — the
  file is kept).
- Conjunctions refute conjunct-wise (a file failing ANY conjunct
  cannot satisfy the AND); disjunctions keep a file ANY disjunct might
  match. Both are over-approximations of satisfiability — sound, just
  not complete.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from hyperspace_tpu_torch.index.sketch import FileSketch, SketchSet
from hyperspace_tpu_torch.plan import expr as E

__all__ = ["prune_files", "predicate_possible"]

_INT_NP = {"int8": np.int8, "int16": np.int16, "int32": np.int32,
           "int64": np.int64, "date32": np.int32, "timestamp": np.int64,
           "bool": np.int64}


def _canon_exact(value, dtype: str):
    """The literal as an exact member of the column's value space, or
    None when it cannot be represented exactly (eq/bloom probes must
    then decline — keeping the file is always safe)."""
    if value is None:
        return None
    if dtype == "string":
        return value if isinstance(value, str) else None
    if isinstance(value, str):
        return None
    if isinstance(value, bool):
        value = int(value)
    if dtype in ("float32", "float64"):
        return (np.float32(value) if dtype == "float32"
                else np.float64(value)).item()
    np_dtype = _INT_NP.get(dtype)
    if np_dtype is None:
        return None
    if isinstance(value, float):
        if not value.is_integer():
            return None
        value = int(value)
    info = np.iinfo(np_dtype)
    if not (info.min <= value <= info.max):
        return None
    return int(value)


def _zone_value(value, dtype: str):
    """The literal in the comparison space the ENGINE evaluates ranges
    in: float32 columns round it (the compiled compare does), strings
    stay strings, other numerics compare raw (int-vs-float python
    comparison is exact). None = incomparable (keep the file)."""
    if value is None:
        return None
    if dtype == "string":
        return value if isinstance(value, str) else None
    if isinstance(value, str):
        return None
    if isinstance(value, bool):
        return int(value)
    if dtype == "float32":
        return np.float32(value).item()
    return value


def _column_literal(expr) -> Optional[Tuple[str, object, bool]]:
    """(column name, literal value, column_on_left) of a comparison's
    operands, or None when the shape is not column-vs-literal."""
    if isinstance(expr.left, E.Column) and isinstance(expr.right, E.Literal):
        return expr.left.name, expr.right.value, True
    if isinstance(expr.left, E.Literal) and isinstance(expr.right, E.Column):
        return expr.right.name, expr.left.value, False
    return None


def _eq_possible(cs, value) -> bool:
    v = _canon_exact(value, cs.dtype)
    if v is None:
        return True
    if cs.ok == 0:
        return False  # only NULL/NaN rows: nothing compares equal
    zv = _zone_value(value, cs.dtype)
    if cs.min is not None and zv is not None \
            and (zv < cs.min or zv > cs.max):
        return False
    if cs.bloom is not None and len(cs.bloom):
        from hyperspace_tpu_torch.exceptions import HyperspaceException
        from hyperspace_tpu_torch.ops.sketch import (bloom_maybe_contains,
                                               probe_hash_pair)
        try:
            h1, h2 = probe_hash_pair(v, cs.dtype)
        except HyperspaceException:
            return True
        return bloom_maybe_contains(cs.bloom, h1, h2)
    return True


def predicate_possible(cond: E.Expression, fsk: FileSketch) -> bool:
    """True when `fsk`'s file MAY contain a row satisfying `cond`;
    False only when the sketches REFUTE it. Unknown shapes answer
    True."""
    if fsk.rows == 0:
        return False
    if isinstance(cond, E.And):
        return (predicate_possible(cond.left, fsk)
                and predicate_possible(cond.right, fsk))
    if isinstance(cond, E.Or):
        return (predicate_possible(cond.left, fsk)
                or predicate_possible(cond.right, fsk))
    if isinstance(cond, E.IsNull) and isinstance(cond.child, E.Column):
        cs = fsk.columns.get(cond.child.name.lower())
        return True if cs is None else cs.nulls > 0
    if isinstance(cond, E.IsNotNull) and isinstance(cond.child, E.Column):
        cs = fsk.columns.get(cond.child.name.lower())
        return True if cs is None else (fsk.rows - cs.nulls) > 0
    if isinstance(cond, E.In) and isinstance(cond.child, E.Column):
        cs = fsk.columns.get(cond.child.name.lower())
        if cs is None:
            return True
        return any(_eq_possible(cs, v.value) for v in cond.values)
    if isinstance(cond, (E.EqualTo, E.NotEqualTo, E.LessThan,
                         E.LessThanOrEqual, E.GreaterThan,
                         E.GreaterThanOrEqual)):
        shape = _column_literal(cond)
        if shape is None:
            return True
        name, value, col_left = shape
        cs = fsk.columns.get(name.lower())
        if cs is None:
            return True
        if isinstance(cond, E.EqualTo):
            return _eq_possible(cs, value)
        if isinstance(cond, E.NotEqualTo):
            if cs.has_nan:
                return True  # NaN != v is TRUE (IEEE)
            v = _canon_exact(value, cs.dtype)
            if cs.ok == 0:
                return False  # only NULL rows: col != v is NULL
            if v is None:
                return True
            return not (cs.min is not None and cs.min == cs.max == v)
        # Range comparison; mirror literal-on-left (v < col  ==  col > v).
        zv = _zone_value(value, cs.dtype)
        if cs.ok == 0 or cs.min is None or zv is None:
            return cs.ok > 0 and (cs.min is None or zv is None)
        op = type(cond)
        if not col_left:
            op = {E.LessThan: E.GreaterThan,
                  E.GreaterThan: E.LessThan,
                  E.LessThanOrEqual: E.GreaterThanOrEqual,
                  E.GreaterThanOrEqual: E.LessThanOrEqual}[op]
        try:
            if op is E.LessThan:
                return cs.min < zv
            if op is E.LessThanOrEqual:
                return cs.min <= zv
            if op is E.GreaterThan:
                return cs.max > zv
            return cs.max >= zv
        except TypeError:
            return True  # incomparable stored/literal types
    return True  # unsupported shape: never refute


def prune_files(condition: E.Expression, files: Sequence[str],
                sketches: SketchSet
                ) -> Tuple[List[str], List[str], int]:
    """Split `files` into (survivors, pruned, bytes_pruned) under
    `condition`. A file is pruned only when it has a sketch row, its
    live (size, stamp) identity still matches the one captured at
    sketch time (a rewritten file is UNKNOWN — kept), and the sketches
    refute the predicate."""
    from hyperspace_tpu_torch.index.signature import file_stamp

    survivors: List[str] = []
    pruned: List[str] = []
    bytes_pruned = 0
    for f in files:
        fsk = sketches.sketch_for(f)
        if fsk is None:
            survivors.append(f)
            continue
        live = file_stamp(f)
        if live is None or int(live[0]) != fsk.size \
                or str(live[1]) != fsk.stamp:
            survivors.append(f)
            continue
        if predicate_possible(condition, fsk):
            survivors.append(f)
        else:
            pruned.append(f)
            bytes_pruned += fsk.size
    return survivors, pruned, bytes_pruned
