"""Expression -> array computation compiler.

Compiles IR expression trees (`plan/expr.py`) into vectorized array code
over a ColumnBatch: numpy on the host lane, torch on the batch's device on
the device lane. This replaces the reference's reliance on Spark's
WholeStageCodegen for predicate evaluation.

Null semantics follow SQL as the reference inherits them from Spark:
comparisons involving null are not-true (rows filtered out), IS [NOT] NULL
consults validity.

String comparisons against literals are translated to *code-space*
comparisons: because dictionaries are sorted (`io/columnar.py`), value
predicates become integer range tests on codes — `x > "m"` is
`code >= searchsorted(dict, "m", right)` — so string filters run at
integer scan speed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch import telemetry
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.io.columnar import ColumnBatch, DeviceColumn
from hyperspace_tpu_torch.plan import expr as E

_CMP = {"eq": "__eq__", "ne": "__ne__", "lt": "__lt__", "le": "__le__",
        "gt": "__gt__", "ge": "__ge__"}

_TORCH_DTYPES = {"bool": torch.bool, "int8": torch.int8,
                 "int16": torch.int16, "int32": torch.int32,
                 "int64": torch.int64, "float32": torch.float32,
                 "float64": torch.float64, "date32": torch.int32,
                 "timestamp": torch.int64, "string": torch.int32}


def _host_literal(v):
    """A Python literal as a numpy scalar array. A Python float is
    float64, as numpy makes it: torch's default float32 would round it
    (0.2 -> 0.20000000298) before any widening."""
    return np.asarray(v, dtype=np.float64 if isinstance(v, float) else None)


def _literal_value(v, dtype: str):
    """A Python literal cast to the logical dtype `dtype` on the host, as
    a Python scalar (what `full` broadcasts; no device round trip)."""
    from hyperspace_tpu_torch.io.columnar import HOST_NP_DTYPES
    return _host_literal(v).astype(HOST_NP_DTYPES[dtype]).item()


def _is_array(v) -> bool:
    return isinstance(v, (np.ndarray, torch.Tensor))


class _Arrays:
    """The few array operations the compiler needs, in the batch's
    residence: numpy for the host lane, torch on `device` otherwise.

    On a CUDA device, host constants (literals, IN lists, dictionary
    tables) cross through pinned memory without blocking the host: a
    pageable copy would synchronize the stream, and a fused stage
    (`engine/fusion.py`) waits on the device once, at its end."""

    def __init__(self, device: Optional[torch.device]):
        self.device = device

    @property
    def host(self) -> bool:
        return self.device is None

    def _upload(self, arr: np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def asarray(self, v):
        if self.host:
            return np.asarray(v)
        if isinstance(v, torch.Tensor):
            return v
        if isinstance(v, np.ndarray):
            return self._upload(v)
        if self.device.type == "cuda":
            return self._upload(_host_literal(v))
        return torch.as_tensor(v, device=self.device,
                               dtype=torch.float64 if isinstance(v, float)
                               else None)

    def cast(self, arr, dtype: str):
        """`arr` converted to the logical dtype `dtype`."""
        if self.host:
            from hyperspace_tpu_torch.io.columnar import HOST_NP_DTYPES
            return np.asarray(arr).astype(HOST_NP_DTYPES[dtype])
        return self.asarray(arr).to(_TORCH_DTYPES[dtype])

    def full(self, n: int, value, dtype: str = "bool"):
        if self.host:
            from hyperspace_tpu_torch.io.columnar import HOST_NP_DTYPES
            return np.full(n, value, dtype=HOST_NP_DTYPES[dtype])
        return torch.full((n,), value, dtype=_TORCH_DTYPES[dtype],
                          device=self.device)

    def is_float(self, arr) -> bool:
        if isinstance(arr, torch.Tensor):
            return arr.dtype.is_floating_point
        return np.asarray(arr).dtype.kind == "f"

    def where(self, cond, a, b):
        return (np.where(cond, a, b) if self.host
                else torch.where(cond, a, b))

    def isin(self, values, members: np.ndarray):
        if self.host:
            return np.isin(values, members)
        return torch.isin(values, self.asarray(members).to(values.dtype))

    def take(self, table: np.ndarray, codes):
        """`table[codes]` with a host table, in the codes' residence."""
        if self.host:
            return table[np.asarray(codes)]
        return self.asarray(table)[codes.long()]


def _string_literal_compare(op: str, col: DeviceColumn, value: str,
                            xp: _Arrays):
    d = col.dictionary
    left = int(np.searchsorted(d, value, side="left"))
    right = int(np.searchsorted(d, value, side="right"))
    present = left < right
    code = col.data
    n = len(col)
    if op == "eq":
        return (code == left) if present else xp.full(n, False)
    if op == "ne":
        return (code != left) if present else xp.full(n, True)
    if op == "lt":
        return code < left
    if op == "le":
        return code < right
    if op == "gt":
        return code >= right
    if op == "ge":
        return code >= left
    raise HyperspaceException(f"Unsupported string comparison: {op}")


class ExpressionCompiler:
    """Compiles expressions over a batch. The array module follows the
    batch's residence: host batches evaluate with numpy (the adaptive host
    lane for small reads), device batches with torch on their device."""

    def __init__(self, batch: ColumnBatch):
        self.batch = batch
        self.xp = _Arrays(None if batch.is_host else batch.device)

    # -- value expressions ------------------------------------------------

    def value(self, e: E.Expression) -> Tuple[object, Optional[object]]:
        """Compile to (array, validity|None). Strings yield their codes and
        may only feed comparisons handled in `predicate`."""
        xp = self.xp
        if isinstance(e, E.Alias):
            return self.value(e.child)
        if isinstance(e, E.Column):
            col = self.batch.column(e.name)
            return col.data, col.validity
        if isinstance(e, E.Literal):
            return e.value, None
        if isinstance(e, E.NullLiteral):
            n = self.batch.num_rows
            dtype = e.dtype if e.dtype in _TORCH_DTYPES else "int64"
            return xp.full(n, 0, dtype), xp.full(n, False)
        if isinstance(e, (E.Add, E.Sub, E.Mul, E.Div)):
            lv, lval = self.value(e.left)
            rv, rval = self.value(e.right)
            # Widen BEFORE computing (infer_dtype's rule: ints accumulate
            # as int64, any float promotes to float64, Div is float64) —
            # narrow int32/int16 operands must not wrap at their own
            # width.
            floats = (type(e).op == "div"
                      or xp.is_float(lv) or xp.is_float(rv))
            wide = "float64" if floats else "int64"
            lv, rv = xp.cast(lv, wide), xp.cast(rv, wide)
            out = {"add": lambda: lv + rv, "sub": lambda: lv - rv,
                   "mul": lambda: lv * rv, "div": lambda: lv / rv}[
                type(e).op]()
            return out, self._merge_validity(lval, rval)
        if isinstance(e, E.CaseWhen):
            return self._case_when(e)
        if isinstance(e, E.Floor):
            v, valid = self.value(e.child)
            arr = xp.cast(v, "float64")
            floored = np.floor(arr) if xp.host else torch.floor(arr)
            return xp.cast(floored, "int64"), valid
        if isinstance(e, E.ScalarSubquery):
            # Resolved by the executor's subquery phase; compiles as the
            # value it produced (NULL for an empty subquery).
            return self.value(e.literal())
        raise HyperspaceException(f"Unsupported value expression: {e!r}")

    def _case_when(self, e: "E.CaseWhen"):
        """Numeric/bool CASE: one chain of `where`s, evaluated last branch
        first so the FIRST matching WHEN wins (SQL). A condition that is
        NULL does not match (Kleene not-true). Rows no branch matches take
        the ELSE value, or NULL when there is none."""
        from hyperspace_tpu_torch.plan.expr import infer_dtype

        xp = self.xp
        n = self.batch.num_rows
        out_dtype = infer_dtype(e, self.batch.schema)
        if out_dtype == "string":
            raise HyperspaceException(
                "String-valued CASE is not supported yet.")

        def as_wide(v):
            if not _is_array(v):  # a literal branch value
                return xp.full(n, _literal_value(v, out_dtype), out_dtype)
            arr = xp.cast(v, out_dtype)
            return xp.full(n, arr.item(), out_dtype) if arr.ndim == 0 else arr

        def as_mask(v):
            if v is None:
                return xp.full(n, True)
            return as_wide_mask(v)

        def as_wide_mask(v):
            arr = xp.cast(v, "bool")
            return xp.full(n, bool(arr.item())) if arr.ndim == 0 else arr

        if e.otherwise_value is not None:
            data, validity = self.value(e.otherwise_value)
            data, validity = as_wide(data), as_mask(validity)
        else:
            data = xp.full(n, 0, out_dtype)
            validity = xp.full(n, False)
        for cond, val in reversed(e.branches):
            t, _known = self.predicate3(cond)
            v_data, v_valid = self.value(val)
            data = xp.where(t, as_wide(v_data), data)
            validity = xp.where(t, as_mask(v_valid), validity)
        # all-valid result -> drop the mask (the common no-null fast path)
        if (e.otherwise_value is not None and xp.host
                and bool(validity.all())):
            return data, None
        return data, validity

    def string_column(self, e: E.Expression) -> Optional[DeviceColumn]:
        """Evaluate a string-VALUED expression to a dict-encoded column
        (sorted dictionary, so code-space comparisons stay valid), or None
        when `e` is not string-valued. Substr transforms the DICTIONARY —
        O(dictionary), not O(rows) — then re-sorts and remaps codes."""
        if isinstance(e, E.Alias):
            return self.string_column(e.child)
        if isinstance(e, E.Column):
            col = self.batch.column(e.name)
            return col if col.is_string else None
        if isinstance(e, E.NullLiteral) and e.dtype == "string":
            return self._const_string_column("", valid=False)
        if isinstance(e, E.Literal) and isinstance(e.value, str):
            return self._const_string_column(e.value, valid=True)
        if isinstance(e, E.Substr):
            child = self.string_column(e.child)
            if child is None:
                raise HyperspaceException(
                    f"SUBSTR over non-string expression: {e.child!r}")
            return self._substr(child, e.start, e.length)
        return None

    def _const_string_column(self, value: str, valid: bool) -> DeviceColumn:
        """One-entry-dictionary string column: every row carries `value`
        (valid=True) or NULL (valid=False)."""
        from hyperspace_tpu_torch.io.columnar import (_split_hashes,
                                                      _string_hash64)

        d = np.array([value])
        n = self.batch.num_rows
        return DeviceColumn(
            self.xp.full(n, 0, "string"), "string",
            None if valid else self.xp.full(n, False), d,
            _split_hashes(_string_hash64(d), self.xp.device))

    def _substr(self, col: DeviceColumn, start: int,
                length: int) -> DeviceColumn:
        from hyperspace_tpu_torch.io.columnar import (_split_hashes,
                                                      _string_hash64)
        d = col.dictionary
        sliced = np.array([v[start - 1:start - 1 + length] for v in d])
        new_dict, inverse = np.unique(sliced, return_inverse=True)
        codes = self.xp.take(inverse.astype(np.int32), col.data)
        hashes = _split_hashes(_string_hash64(new_dict), self.xp.device)
        return DeviceColumn(codes, "string", col.validity, new_dict, hashes)

    def value_column(self, e: E.Expression, out_dtype: str) -> DeviceColumn:
        """Evaluate a value expression to a full DeviceColumn of the given
        logical dtype (the projection entry point)."""
        s = self.string_column(e)
        if s is not None:
            if out_dtype != "string":
                raise HyperspaceException(
                    f"Expression {e!r} is string-valued; expected "
                    f"{out_dtype}.")
            return s
        data, validity = self.value(e)
        n = self.batch.num_rows
        if not _is_array(data):  # literal broadcast
            data = self.xp.full(n, _literal_value(data, out_dtype), out_dtype)
        else:
            data = self.xp.cast(data, out_dtype)
            if data.ndim == 0:
                data = self.xp.full(n, data.item(), out_dtype)
        return DeviceColumn(data, out_dtype, validity=validity)

    @staticmethod
    def _merge_validity(a, b):
        if a is None:
            return b
        if b is None:
            return a
        return a & b

    def _column_of(self, e: E.Expression) -> Optional[DeviceColumn]:
        if isinstance(e, E.Column):
            return self.batch.column(e.name)
        return None

    # -- predicates -------------------------------------------------------
    #
    # SQL three-valued (Kleene) logic: each predicate compiles to a pair
    # (true_mask, known) where `true_mask` marks rows DEFINITELY true (so
    # true_mask implies known; `known & ~true_mask` is definitely false;
    # `~known` is NULL/unknown). `known is None` means all-known — the
    # common null-free fast path. NOT flips definite truth within the
    # known rows, so NULL stays NULL and a filter never passes it.

    def predicate(self, e: E.Expression):
        """Compile to a bool mask (True = row DEFINITELY passes; SQL's
        not-true rows, including NULLs, are False)."""
        mask, _known = self.predicate3(e)
        return mask

    def predicate3(self, e: E.Expression):
        """Compile to (true_mask, known); known=None means all rows known."""
        xp = self.xp
        n = self.batch.num_rows
        if isinstance(e, E.And):
            lt, lk = self.predicate3(e.left)
            rt, rk = self.predicate3(e.right)
            mask = lt & rt
            if lk is None and rk is None:
                return mask, None
            # Known iff both known, or either side is definitely false.
            lk_ = xp.full(n, True) if lk is None else lk
            rk_ = xp.full(n, True) if rk is None else rk
            return mask, (lk_ & rk_) | (lk_ & ~lt) | (rk_ & ~rt)
        if isinstance(e, E.Or):
            return self._or3(self.predicate3(e.left),
                             self.predicate3(e.right), n, xp)
        if isinstance(e, E.Not):
            t, k = self.predicate3(e.child)
            if k is None:
                return ~t, None
            return k & ~t, k
        if isinstance(e, E.IsNull):
            col = self._column_of(e.child)
            if col is None:
                raise HyperspaceException("IS NULL requires a column.")
            if col.validity is None:
                return xp.full(n, False), None
            return ~col.validity, None
        if isinstance(e, E.IsNotNull):
            col = self._column_of(e.child)
            if col is None:
                raise HyperspaceException("IS NOT NULL requires a column.")
            if col.validity is None:
                return xp.full(n, True), None
            return col.validity, None
        if isinstance(e, E.In):
            # Set-membership fast path: integer column IN (int literals...)
            # is ONE vectorized isin instead of an O(values) fold of
            # EqualTo masks. Kleene semantics match the fold exactly for
            # integers: a NULL row is unknown, everything else is known.
            col = self._column_of(e.child)
            int_vals = [v.value for v in e.values
                        if isinstance(v, E.Literal)
                        and type(v.value) is int]
            if (col is not None and e.values
                    and len(int_vals) == len(e.values)
                    and col.dtype in ("int8", "int16", "int32", "int64")):
                member = xp.isin(col.data, np.asarray(int_vals,
                                                      dtype=np.int64))
                if col.validity is None:
                    return member, None
                return member & col.validity, col.validity
            folded = None
            for v in e.values:
                term = self.predicate3(E.EqualTo(e.child, v))
                folded = term if folded is None else (
                    self._or3(folded, term, n, xp))
            if folded is None:
                return xp.full(n, False), None
            return folded
        if isinstance(e, E.Like):
            # LIKE in DICTIONARY space. Device lane: the per-dictionary
            # membership mask comes from the segment cache
            # (`parallel/spmd.string_like_mask`: the regex paid once per
            # dictionary and pattern, the mask resident on the device),
            # so the row test is one gather by code and a warm repeat
            # runs no regex. Host lane: numpy end to end.
            import re as _re
            s = self.string_column(e.child)
            if s is None:
                raise HyperspaceException(
                    f"LIKE requires a string operand: {e!r}")
            if not xp.host and len(s.dictionary):
                from hyperspace_tpu_torch.parallel.spmd import (
                    string_like_mask)
                codes = xp.asarray(s.data)
                mask = string_like_mask(s, e.regex(), device=xp.device)
                member = mask[torch.clamp(codes.to(torch.int64), 0,
                                          len(s.dictionary) - 1)]
            else:
                rx = _re.compile(e.regex(), _re.DOTALL)
                codes = np.nonzero([rx.fullmatch(str(v)) is not None
                                    for v in np.asarray(s.dictionary)])[0]
                member = xp.isin(s.data, codes.astype(np.int32))
            if s.validity is None:
                return member, None
            return member & s.validity, s.validity
        if isinstance(e, (E.EqualTo, E.NotEqualTo, E.LessThan,
                          E.LessThanOrEqual, E.GreaterThan,
                          E.GreaterThanOrEqual)):
            return self._comparison(e)
        if isinstance(e, E.Literal):
            if isinstance(e.value, bool):
                return xp.full(n, e.value), None
            raise HyperspaceException(f"Non-boolean literal predicate: {e!r}")
        raise HyperspaceException(f"Unsupported predicate: {e!r}")

    @staticmethod
    def _or3(a, b, n, xp):
        """Kleene OR over (true_mask, known) pairs: known iff both known,
        or either side is definitely true."""
        at, ak = a
        bt, bk = b
        mask = at | bt
        if ak is None and bk is None:
            return mask, None
        ak_ = xp.full(n, True) if ak is None else ak
        bk_ = xp.full(n, True) if bk is None else bk
        return mask, (ak_ & bk_) | mask

    def _comparison(self, e):
        # Resolved scalar subqueries compare as the literal they produced
        # (so the string code-space fast path still applies).
        left = (e.left.literal() if isinstance(e.left, E.ScalarSubquery)
                else e.left)
        right = (e.right.literal() if isinstance(e.right, E.ScalarSubquery)
                 else e.right)
        if left is not e.left or right is not e.right:
            e = type(e)(left, right)
        op = type(e).op
        ls = (None if isinstance(e.left, E.Literal)
              else self.string_column(e.left))
        rs = (None if isinstance(e.right, E.Literal)
              else self.string_column(e.right))
        # string expression vs string literal -> code-space range test
        if ls is not None and isinstance(e.right, E.Literal):
            mask = _string_literal_compare(op, ls, str(e.right.value),
                                           self.xp)
            return self._with_validity(mask, ls.validity, None)
        if rs is not None and isinstance(e.left, E.Literal):
            flipped = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le",
                       "eq": "eq", "ne": "ne"}[op]
            mask = _string_literal_compare(flipped, rs,
                                           str(e.left.value), self.xp)
            return self._with_validity(mask, rs.validity, None)
        if ls is not None and rs is not None:
            # String col-to-col compare: remap both onto one merged sorted
            # dictionary, then compare codes (order-preserving).
            lc, rc = self._unified_codes(ls, rs)
            mask = getattr(lc, _CMP[op])(rc)
            return self._with_validity(mask, ls.validity, rs.validity)
        if ls is not None or rs is not None:
            raise HyperspaceException(
                f"Cannot compare a string expression with a non-string "
                f"operand: {e!r}")
        lv, lval = self.value(e.left)
        rv, rval = self.value(e.right)
        if not isinstance(lv, (np.ndarray, torch.Tensor)):
            # literal on the left: flip so the array drives the compare
            flipped = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le",
                       "eq": "eq", "ne": "ne"}[op]
            lv, rv, op = rv, lv, flipped
        if isinstance(rv, float):
            # compare in float64 (torch would compare an int column with
            # a Python float in float32)
            rv = self.xp.asarray(rv)
        mask = getattr(self.xp.asarray(lv), _CMP[op])(rv)
        return self._with_validity(mask, lval, rval)

    def _unified_codes(self, a: DeviceColumn, b: DeviceColumn):
        from hyperspace_tpu_torch.io.columnar import _merged_dictionary
        _, (ra, rb), _ = _merged_dictionary([a.dictionary, b.dictionary],
                                            device=None)
        return self.xp.take(ra, a.data), self.xp.take(rb, b.data)

    @staticmethod
    def _with_validity(mask, lval, rval):
        """(raw compare, operand validity) -> (true_mask, known)."""
        validity = ExpressionCompiler._merge_validity(lval, rval)
        if validity is None:
            return mask, None
        return mask & validity, validity


def compile_predicate(expression: E.Expression, batch: ColumnBatch):
    return ExpressionCompiler(batch).predicate(expression)


def apply_filter(batch: ColumnBatch, expression: E.Expression) -> ColumnBatch:
    """Filter a batch: mask evaluation + one compaction gather. On the
    device lane the nonzero is the single host sync (it sizes the result);
    on the host lane everything is numpy — no device traffic."""
    mask = compile_predicate(expression, batch)
    if isinstance(mask, np.ndarray):
        return batch.take(np.nonzero(mask)[0].astype(np.int32))
    with telemetry.span("sync:filter.nonzero", "device_wait"):
        idx = torch.nonzero(mask).squeeze(1)
    return batch.take(idx)
