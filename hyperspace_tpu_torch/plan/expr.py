"""Expression trees for the relational IR.

The reference leans on Catalyst expressions; this framework owns a small
expression language sufficient for the covering-index workloads (filters and
equi-join conditions over scalar columns): column refs, literals,
comparisons, boolean algebra, arithmetic, IN, NULL tests. Expressions are
JSON-serializable (replacing the reference's Kryo serde of Catalyst trees,
`index/serde/LogicalPlanSerDeUtils.scala:40-67`) and are compiled to
numpy / torch array code by the engine (`engine/compiler.py`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Set

from hyperspace_tpu_torch.exceptions import HyperspaceException


class Expression:
    """Base expression node."""

    @property
    def children(self) -> List["Expression"]:
        return []

    def references(self) -> Set[str]:
        out: Set[str] = set()
        for c in self.children:
            out |= c.references()
        return out

    def to_dict(self) -> dict:
        raise NotImplementedError

    @staticmethod
    def from_dict(d: dict) -> "Expression":
        op = d["op"]
        cls = _REGISTRY.get(op)
        if cls is None:
            raise HyperspaceException(f"Unknown expression op: {op}")
        return cls._from_dict(d)

    # Operator sugar so users can write `col("a") == lit(1)` style predicates.
    def __eq__(self, other):  # type: ignore[override]
        return EqualTo(self, _wrap(other))

    def __ne__(self, other):  # type: ignore[override]
        return NotEqualTo(self, _wrap(other))

    def __lt__(self, other):
        return LessThan(self, _wrap(other))

    def __le__(self, other):
        return LessThanOrEqual(self, _wrap(other))

    def __gt__(self, other):
        return GreaterThan(self, _wrap(other))

    def __ge__(self, other):
        return GreaterThanOrEqual(self, _wrap(other))

    def __and__(self, other):
        return And(self, _wrap(other))

    def __or__(self, other):
        return Or(self, _wrap(other))

    def __invert__(self):
        return Not(self)

    def __add__(self, other):
        return Add(self, _wrap(other))

    def __sub__(self, other):
        return Sub(self, _wrap(other))

    def __mul__(self, other):
        return Mul(self, _wrap(other))

    def __truediv__(self, other):
        return Div(self, _wrap(other))

    def __hash__(self):
        return hash(repr(self))

    def isin(self, *values) -> "In":
        return In(self, [(_wrap(v)) for v in values])

    def is_null(self) -> "IsNull":
        return IsNull(self)

    def is_not_null(self) -> "IsNotNull":
        return IsNotNull(self)

    def alias(self, name: str) -> "Alias":
        """Name this expression as a projection output column:
        `df.select(col("a"), (col("x") * col("y")).alias("xy"))`."""
        return Alias(self, name)

    def substr(self, start: int, length: int) -> "Substr":
        """SQL SUBSTR(col, start, length) — 1-based start, on string
        expressions."""
        return Substr(self, start, length)

    def like(self, pattern: str) -> "Like":
        """SQL LIKE: `%` any run, `_` any single char, anchored."""
        return Like(self, pattern)

    def between(self, low, high) -> "Expression":
        """SQL BETWEEN: low <= self <= high (inclusive)."""
        return And(GreaterThanOrEqual(self, _wrap(low)),
                   LessThanOrEqual(self, _wrap(high)))


def _wrap(value) -> "Expression":
    if isinstance(value, Expression):
        return value
    return Literal(value)


class Column(Expression):
    def __init__(self, name: str):
        self.name = name

    def references(self) -> Set[str]:
        return {self.name}

    def to_dict(self) -> dict:
        return {"op": "column", "name": self.name}

    @staticmethod
    def _from_dict(d: dict) -> "Column":
        return Column(d["name"])

    def __repr__(self):
        return f"col({self.name})"


class Literal(Expression):
    def __init__(self, value: Any):
        if value is not None and not isinstance(value, (bool, int, float, str)):
            raise HyperspaceException(f"Unsupported literal: {value!r}")
        self.value = value

    def to_dict(self) -> dict:
        return {"op": "literal", "value": self.value}

    @staticmethod
    def _from_dict(d: dict) -> "Literal":
        return Literal(d["value"])

    def __repr__(self):
        return f"lit({self.value!r})"


class NullLiteral(Expression):
    """A typed SQL NULL (`lit(None)` needs a dtype to carry through the
    engine's static schemas). Exists for the grouping-set/ROLLUP idiom —
    coarser granularities union in with NULL-filled grouping columns —
    and anywhere else a query projects an explicit NULL."""

    op = "null"

    def __init__(self, dtype: str):
        from hyperspace_tpu_torch.plan.schema import Field
        Field("_", dtype)  # validates the dtype name
        self.dtype = dtype

    def to_dict(self) -> dict:
        return {"op": "null", "dtype": self.dtype}

    @staticmethod
    def _from_dict(d: dict) -> "NullLiteral":
        return NullLiteral(d["dtype"])

    def __repr__(self):
        return f"NULL::{self.dtype}"


def null(dtype: str) -> NullLiteral:
    return NullLiteral(dtype)


class _Binary(Expression):
    op: str = ""
    symbol: str = ""

    def __init__(self, left: Expression, right: Expression):
        self.left = left
        self.right = right

    @property
    def children(self) -> List[Expression]:
        return [self.left, self.right]

    def to_dict(self) -> dict:
        return {"op": self.op, "left": self.left.to_dict(),
                "right": self.right.to_dict()}

    @classmethod
    def _from_dict(cls, d: dict):
        return cls(Expression.from_dict(d["left"]), Expression.from_dict(d["right"]))

    def __repr__(self):
        return f"({self.left!r} {self.symbol} {self.right!r})"


class EqualTo(_Binary):
    op, symbol = "eq", "="


class NotEqualTo(_Binary):
    op, symbol = "ne", "!="


class LessThan(_Binary):
    op, symbol = "lt", "<"


class LessThanOrEqual(_Binary):
    op, symbol = "le", "<="


class GreaterThan(_Binary):
    op, symbol = "gt", ">"


class GreaterThanOrEqual(_Binary):
    op, symbol = "ge", ">="


class And(_Binary):
    op, symbol = "and", "AND"


class Or(_Binary):
    op, symbol = "or", "OR"


class Add(_Binary):
    op, symbol = "add", "+"


class Sub(_Binary):
    op, symbol = "sub", "-"


class Mul(_Binary):
    op, symbol = "mul", "*"


class Div(_Binary):
    op, symbol = "div", "/"


class _Unary(Expression):
    op: str = ""

    def __init__(self, child: Expression):
        self.child = child

    @property
    def children(self) -> List[Expression]:
        return [self.child]

    def to_dict(self) -> dict:
        return {"op": self.op, "child": self.child.to_dict()}

    @classmethod
    def _from_dict(cls, d: dict):
        return cls(Expression.from_dict(d["child"]))

    def __repr__(self):
        return f"{self.op}({self.child!r})"


class Not(_Unary):
    op = "not"


class IsNull(_Unary):
    op = "is_null"


class IsNotNull(_Unary):
    op = "is_not_null"


class Alias(Expression):
    """A named projection output (Spark's `Alias`). Only meaningful as a
    top-level entry of a Project/select list."""

    op = "alias"

    def __init__(self, child: Expression, name: str):
        if not isinstance(child, Expression):
            raise HyperspaceException("alias() wraps an Expression.")
        self.child = child
        self.name = name

    @property
    def children(self) -> List[Expression]:
        return [self.child]

    def to_dict(self) -> dict:
        return {"op": "alias", "name": self.name,
                "child": self.child.to_dict()}

    @staticmethod
    def _from_dict(d: dict) -> "Alias":
        return Alias(Expression.from_dict(d["child"]), d["name"])

    def __repr__(self):
        return f"({self.child!r} AS {self.name})"


class Substr(Expression):
    """SUBSTR(string expr, start, length); start is 1-based (SQL)."""

    op = "substr"

    def __init__(self, child: Expression, start: int, length: int):
        if start < 1 or length < 0:
            raise HyperspaceException(
                "SUBSTR start is 1-based and length must be >= 0.")
        self.child = child
        self.start = int(start)
        self.length = int(length)

    @property
    def children(self) -> List[Expression]:
        return [self.child]

    def to_dict(self) -> dict:
        return {"op": "substr", "start": self.start, "length": self.length,
                "child": self.child.to_dict()}

    @staticmethod
    def _from_dict(d: dict) -> "Substr":
        return Substr(Expression.from_dict(d["child"]), d["start"],
                      d["length"])

    def __repr__(self):
        return f"substr({self.child!r}, {self.start}, {self.length})"


class Like(Expression):
    """SQL LIKE over a string expression: `%` matches any run, `_` any
    single character, anchored at both ends. Compiled in DICTIONARY space
    (the pattern runs over the distinct values, O(dictionary) on the
    host; rows pay one code-membership test), so the predicate stays
    vectorized at any row count."""

    op = "like"

    def __init__(self, child: Expression, pattern: str):
        self.child = child
        self.pattern = str(pattern)

    @property
    def children(self) -> List[Expression]:
        return [self.child]

    def regex(self) -> str:
        """Anchored regex equivalent of the SQL pattern. Backslash is the
        escape character (Spark's LIKE default): `\\%` / `\\_` match the
        literal wildcard, `\\\\` a literal backslash."""
        import re
        out = []
        chars = iter(self.pattern)
        for ch in chars:
            if ch == "\\":
                nxt = next(chars, None)
                if nxt is None:
                    out.append(re.escape("\\"))
                else:
                    out.append(re.escape(nxt))
            elif ch == "%":
                out.append(".*")
            elif ch == "_":
                out.append(".")
            else:
                out.append(re.escape(ch))
        return "".join(out)

    def to_dict(self) -> dict:
        return {"op": "like", "pattern": self.pattern,
                "child": self.child.to_dict()}

    @staticmethod
    def _from_dict(d: dict) -> "Like":
        return Like(Expression.from_dict(d["child"]), d["pattern"])

    def __repr__(self):
        return f"{self.child!r} LIKE {self.pattern!r}"


class In(Expression):
    def __init__(self, child: Expression, values: Sequence[Expression]):
        self.child = child
        self.values = list(values)
        for v in self.values:
            if not isinstance(v, Literal):
                raise HyperspaceException("IN list must contain literals only.")

    @property
    def children(self) -> List[Expression]:
        return [self.child, *self.values]

    def to_dict(self) -> dict:
        return {"op": "in", "child": self.child.to_dict(),
                "values": [v.to_dict() for v in self.values]}

    @staticmethod
    def _from_dict(d: dict) -> "In":
        return In(Expression.from_dict(d["child"]),
                  [Expression.from_dict(v) for v in d["values"]])

    def __repr__(self):
        return f"{self.child!r} IN {[v.value for v in self.values]}"


class CaseWhen(Expression):
    """SQL `CASE WHEN cond THEN value [WHEN ...] [ELSE value] END`.
    First matching branch wins; no match and no ELSE yields NULL (the
    conditional-aggregation idiom most TPC-DS pivots use:
    `sum(CASE WHEN d_day_name = 'Sunday' THEN ss_sales_price END)` —
    sum/avg skip the NULLs)."""

    op = "case"

    def __init__(self, branches: Sequence[tuple],
                 otherwise: Optional[Expression] = None):
        if not branches:
            raise HyperspaceException("CASE needs at least one WHEN branch.")
        self.branches = [(c, v) for c, v in branches]
        for c, v in self.branches:
            if not isinstance(c, Expression) or not isinstance(v, Expression):
                raise HyperspaceException(
                    "CASE branches must pair (condition, value) expressions.")
        self.otherwise_value = otherwise

    def when(self, condition: "Expression", value) -> "CaseWhen":
        return CaseWhen(self.branches + [(condition, _wrap(value))],
                        self.otherwise_value)

    def otherwise(self, value) -> "CaseWhen":
        return CaseWhen(self.branches, _wrap(value))

    @property
    def children(self) -> List[Expression]:
        out: List[Expression] = []
        for c, v in self.branches:
            out.extend((c, v))
        if self.otherwise_value is not None:
            out.append(self.otherwise_value)
        return out

    def to_dict(self) -> dict:
        return {"op": "case",
                "branches": [[c.to_dict(), v.to_dict()]
                             for c, v in self.branches],
                "otherwise": (self.otherwise_value.to_dict()
                              if self.otherwise_value is not None else None)}

    @staticmethod
    def _from_dict(d: dict) -> "CaseWhen":
        other = d.get("otherwise")
        return CaseWhen(
            [(Expression.from_dict(c), Expression.from_dict(v))
             for c, v in d["branches"]],
            Expression.from_dict(other) if other is not None else None)

    def __repr__(self):
        parts = " ".join(f"WHEN {c!r} THEN {v!r}" for c, v in self.branches)
        tail = (f" ELSE {self.otherwise_value!r}"
                if self.otherwise_value is not None else "")
        return f"CASE {parts}{tail} END"


def when(condition: Expression, value) -> CaseWhen:
    """Start a CASE chain: `when(cond, v).when(cond2, v2).otherwise(v3)`
    (PySpark's `F.when` shape)."""
    return CaseWhen([(condition, _wrap(value))])


class Floor(Expression):
    """FLOOR(x) -> int64 (SQL's `cast(x/50 as int)` bucketing idiom for
    non-negative quotients; true floor semantics for negatives)."""

    op = "floor"

    def __init__(self, child: Expression):
        self.child = child

    @property
    def children(self) -> List["Expression"]:
        return [self.child]

    def to_dict(self) -> dict:
        return {"op": "floor", "child": self.child.to_dict()}

    @staticmethod
    def _from_dict(d: dict) -> "Floor":
        return Floor(Expression.from_dict(d["child"]))

    def __repr__(self):
        return f"floor({self.child!r})"


class ScalarSubquery(Expression):
    """A subquery used as a scalar value inside an expression — TPC-DS's
    `where x > (select 1.3 * avg(...) ...)` idiom. The reference
    serializes Catalyst's ScalarSubquery wrappers for exactly these
    queries (`index/serde/package.scala:64-167`); here the node embeds
    the subplan's own-IR JSON.

    Resolution: `engine/executor.execute_plan` executes the subplan
    (must yield one column; one row -> its value, zero rows -> SQL NULL,
    more -> error) ONCE per plan object and caches the value on the node
    (like `Scan.files()` — per-plan-object staleness semantics). The
    rewrite rules run inside the subplan too (`session.optimize`
    recurses into embedded subqueries)."""

    op = "scalar_subquery"

    def __init__(self, plan):
        self.plan = plan
        # The optimizer's rewritten view of the subplan, refreshed on
        # every session.optimize() — `plan` itself is never mutated, so
        # an expression the user holds stays valid across
        # enable/disable_hyperspace.
        self._opt_plan = None
        self._value = None
        self._resolved = False
        if len(plan.schema.fields) != 1:
            raise HyperspaceException(
                "Scalar subquery must produce exactly one column; got "
                f"{plan.schema.names}.")

    def execution_plan(self):
        return self._opt_plan if self._opt_plan is not None else self.plan

    @property
    def dtype(self) -> str:
        return self.plan.schema.fields[0].dtype

    def references(self) -> Set[str]:
        # No correlated references: the subplan reads its own sources.
        return set()

    def resolve(self, value) -> None:
        self._value = value
        self._resolved = True

    def literal(self) -> "Expression":
        """The resolved value as a Literal (NullLiteral for SQL NULL /
        empty subquery). Compilation reads ONLY this."""
        if not self._resolved:
            raise HyperspaceException(
                "Scalar subquery was not resolved before compilation.")
        if self._value is None:
            return NullLiteral(self.dtype)
        return Literal(self._value)

    def to_dict(self) -> dict:
        d = {"op": "scalar_subquery", "plan": self.plan.to_dict()}
        if self._resolved:
            # The resolved value participates in plan identity; serde
            # ignores it on load (fresh plans re-resolve).
            d["value"] = self._value
        return d

    @staticmethod
    def _from_dict(d: dict) -> "ScalarSubquery":
        from hyperspace_tpu_torch.plan.serde import plan_from_dict
        return ScalarSubquery(plan_from_dict(d["plan"]))

    def __repr__(self):
        return f"scalar_subquery({self.plan.simple_string()})"


_REGISTRY: Dict[str, Any] = {
    "column": Column, "literal": Literal,
    "eq": EqualTo, "ne": NotEqualTo, "lt": LessThan, "le": LessThanOrEqual,
    "gt": GreaterThan, "ge": GreaterThanOrEqual,
    "and": And, "or": Or, "not": Not,
    "add": Add, "sub": Sub, "mul": Mul, "div": Div,
    "is_null": IsNull, "is_not_null": IsNotNull, "in": In,
    "alias": Alias, "substr": Substr, "case": CaseWhen,
    "null": NullLiteral, "like": Like, "scalar_subquery": ScalarSubquery,
    "floor": Floor,
}


_BOOL_OPS = (EqualTo, NotEqualTo, LessThan, LessThanOrEqual, GreaterThan,
             GreaterThanOrEqual, And, Or, Not, IsNull, IsNotNull, In, Like)


def infer_dtype(expr: Expression, schema) -> str:
    """Logical output dtype of a value expression against a child schema
    (the typing rules the engine's compiler implements: ints accumulate as
    int64, any float operand promotes to float64, Div always yields
    float64)."""
    if isinstance(expr, Alias):
        return infer_dtype(expr.child, schema)
    if isinstance(expr, Column):
        return schema.field(expr.name).dtype
    if isinstance(expr, NullLiteral):
        return expr.dtype
    if isinstance(expr, Literal):
        v = expr.value
        if isinstance(v, bool):
            return "bool"
        if isinstance(v, int):
            return "int64"
        if isinstance(v, float):
            return "float64"
        if isinstance(v, str):
            return "string"
        raise HyperspaceException(f"Untyped literal: {v!r}")
    if isinstance(expr, Substr):
        if infer_dtype(expr.child, schema) != "string":
            raise HyperspaceException("SUBSTR requires a string operand.")
        return "string"
    if isinstance(expr, Div):
        return "float64"
    if isinstance(expr, (Add, Sub, Mul)):
        l = infer_dtype(expr.left, schema)
        r = infer_dtype(expr.right, schema)
        if "string" in (l, r):
            raise HyperspaceException(
                f"Arithmetic over string operands: {expr!r}")
        floats = {"float32", "float64"}
        if l in floats or r in floats:
            return "float64"
        return "int64"
    if isinstance(expr, CaseWhen):
        outs = [infer_dtype(v, schema) for _, v in expr.branches]
        if expr.otherwise_value is not None:
            outs.append(infer_dtype(expr.otherwise_value, schema))
        if all(o == "string" for o in outs):
            return "string"
        if "string" in outs:
            raise HyperspaceException(
                f"CASE branches mix string and numeric values: {expr!r}")
        if all(o == "bool" for o in outs):
            return "bool"
        floats = {"float32", "float64"}
        return "float64" if any(o in floats for o in outs) else "int64"
    if isinstance(expr, ScalarSubquery):
        return expr.dtype
    if isinstance(expr, Floor):
        if infer_dtype(expr.child, schema) == "string":
            raise HyperspaceException("FLOOR over a string operand.")
        return "int64"
    if isinstance(expr, _BOOL_OPS):
        return "bool"
    raise HyperspaceException(f"Cannot infer dtype of: {expr!r}")


def col(name: str) -> Column:
    return Column(name)


def lit(value) -> Literal:
    return Literal(value)


def split_conjunctive(expr: Expression) -> List[Expression]:
    """Flatten an AND tree into its conjuncts (bucket pruning and the
    filter rule's column check)."""
    if isinstance(expr, And):
        return split_conjunctive(expr.left) + split_conjunctive(expr.right)
    return [expr]
