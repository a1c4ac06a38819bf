"""User-facing DataFrame: a logical plan + session.

The equivalent of the Spark DataFrame surface the reference operates on:
`filter`/`select`/`with_column`/`join`/`sort`/`limit`/`group_by`/`agg`/
`distinct`/`window`/`union`/`intersect`/`except_` are lazy plan builders
and `as_scalar` makes a query a scalar subquery; `collect`/`to_pandas`/
`count` run the optimizer (rewrite rules, when enabled) and execute.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.plan import expr as E
from hyperspace_tpu_torch.plan.nodes import (Aggregate, AggSpec, Filter,
                                             Join, Limit, LogicalPlan,
                                             Project, Sort)
from hyperspace_tpu_torch.plan.schema import Schema


class DataFrame:
    def __init__(self, plan: LogicalPlan, session=None):
        self.plan = plan
        self.session = session

    @property
    def schema(self) -> Schema:
        return self.plan.schema

    @property
    def columns(self) -> List[str]:
        return self.schema.names

    # -- transformations (lazy) ------------------------------------------

    def filter(self, condition: E.Expression) -> "DataFrame":
        if not isinstance(condition, E.Expression):
            raise HyperspaceException("filter() takes an Expression predicate.")
        return DataFrame(Filter(condition, self.plan), self.session)

    where = filter
    # HAVING is a filter over an aggregate's output (SQL surface parity);
    # the engine plans it as FilterExec(AggregateExec(...)).
    having = filter

    def select(self, *columns) -> "DataFrame":
        """Projection. Entries are column names or named expressions:
        `df.select("a", (col("x") * col("y")).alias("xy"))`."""
        names = [c for col in columns
                 for c in (col if isinstance(col, (list, tuple)) else [col])]
        return DataFrame(Project(names, self.plan), self.session)

    def with_column(self, name: str, expression: E.Expression) -> "DataFrame":
        """Append a computed column; replacing an existing one keeps its
        position (Spark withColumn semantics)."""
        alias = E.Alias(expression, name)
        entries: list = []
        replaced = False
        for c in self.schema.names:
            if c.lower() == name.lower():
                entries.append(alias)
                replaced = True
            else:
                entries.append(c)
        if not replaced:
            entries.append(alias)
        return DataFrame(Project(entries, self.plan), self.session)

    def join(self, other: "DataFrame",
             on: Union[E.Expression, str, Sequence[str], None] = None,
             how: str = "inner") -> "DataFrame":
        """Equi-join on column names (`on="key"` or a list, each name on
        both sides) or an AND of column equalities. `how`: inner,
        left_outer/left, right_outer/right, full_outer/full/outer,
        left_semi/semi, left_anti/anti; cross (no `on`)."""
        how = {"semi": "left_semi", "anti": "left_anti",
               "left": "left_outer", "right": "right_outer",
               "full": "full_outer", "outer": "full_outer"}.get(how, how)
        if how == "cross" or on is None:
            if on is not None or how != "cross":
                raise HyperspaceException(
                    "join needs `on` keys unless how='cross'; cross joins "
                    "take none.")
            return DataFrame(Join(self.plan, other.plan, None, "cross"),
                             self.session)
        if isinstance(on, str):
            on = [on]
        if isinstance(on, (list, tuple)):
            condition: Optional[E.Expression] = None
            for name in on:
                term = E.EqualTo(E.Column(name), E.Column(name))
                condition = term if condition is None else E.And(condition,
                                                                 term)
            if condition is None:
                raise HyperspaceException("join requires at least one key.")
        else:
            condition = on
        return DataFrame(Join(self.plan, other.plan, condition, how),
                         self.session)

    def sort(self, *columns: str) -> "DataFrame":
        """ORDER BY. Plain names sort ascending (nulls first); prefix a
        name with "-" for descending (nulls last): df.sort("a", "-b")."""
        return DataFrame(Sort(list(columns), self.plan), self.session)

    order_by = sort

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(Limit(n, self.plan), self.session)

    def group_by(self, *columns: str) -> "GroupedData":
        return GroupedData(self, list(columns))

    def window(self, partition_by: Sequence[str],
               order_by: Optional[Sequence[str]] = None,
               **specs) -> "DataFrame":
        """Append window columns over partitions:
        `df.window(["k"], order_by=["-total"], rk=("rank", "*"),
        part_avg=("avg", "total"))`. Functions: rank, dense_rank,
        row_number (ORDER BY required; column "*"), and partition-wide
        sum/avg/min/max/count."""
        from hyperspace_tpu_torch.plan.nodes import Window
        parsed = [AggSpec(func, column, alias)
                  for alias, (func, column) in specs.items()]
        return DataFrame(Window(list(partition_by), list(order_by or []),
                                parsed, self.plan), self.session)

    def distinct(self) -> "DataFrame":
        """SELECT DISTINCT: deduplicate rows (an aggregation over all
        columns with no aggregate outputs)."""
        return DataFrame(Aggregate(self.columns, [], self.plan),
                         self.session)

    drop_duplicates = distinct

    def union(self, other: "DataFrame") -> "DataFrame":
        """UNION ALL (SQL): row-wise concatenation; column names must
        align. DISTINCT union = .union(o).distinct()."""
        from hyperspace_tpu_torch.plan.nodes import Union as UnionNode
        return DataFrame(UnionNode([self.plan, other.plan]), self.session)

    union_all = union

    def intersect(self, other: "DataFrame") -> "DataFrame":
        """SQL INTERSECT (DISTINCT set semantics; NULL rows compare
        equal, unlike joins)."""
        from hyperspace_tpu_torch.plan.nodes import Intersect
        return DataFrame(Intersect(self.plan, other.plan), self.session)

    def except_(self, other: "DataFrame") -> "DataFrame":
        """SQL EXCEPT (DISTINCT set semantics)."""
        from hyperspace_tpu_torch.plan.nodes import Except
        return DataFrame(Except(self.plan, other.plan), self.session)

    def create_or_replace_temp_view(self, name: str) -> None:
        """Register this query as a named temp view on the session
        (Spark `createOrReplaceTempView` parity)."""
        if self.session is None:
            raise HyperspaceException("DataFrame has no session.")
        self.session.create_or_replace_temp_view(name, self)

    def as_scalar(self) -> E.Expression:
        """This (one-column, at-most-one-row) query as a scalar value
        expression — SQL's scalar subquery: `col("x") >
        df.agg(("avg","x","a")).as_scalar()`."""
        return E.ScalarSubquery(self.plan)

    def agg(self, *specs, **named) -> "DataFrame":
        """Global aggregation (no grouping); see GroupedData.agg."""
        return GroupedData(self, []).agg(*specs, **named)

    # -- actions (execute) ------------------------------------------------

    def _optimized_plan(self) -> LogicalPlan:
        if self.session is not None:
            return self.session.optimize(self.plan)
        return self.plan

    def _conf(self):
        return self.session.conf if self.session is not None else None

    def collect(self, with_metrics: bool = False,
                timeout: Optional[float] = None,
                tenant: Optional[str] = None):
        """Execute and return an Arrow table. `with_metrics=True` returns
        `(table, telemetry.QueryMetrics)` instead — per-operator timings
        and row counts, optimizer-rule decision events, and index-usage
        records for THIS query; the last one is also kept as
        `session.last_query_metrics()`.

        Every collect routes through the process-wide serving plane
        (`engine/scheduler.py`): admission control against the device
        memory budget (typed `QueryRejectedError` backpressure when the
        wait queue is full), a per-query deadline — `timeout` (seconds)
        overrides `spark.hyperspace.serve.deadline.seconds`; expiry or
        `session.cancel(query_id)` raises typed
        `QueryDeadlineExceededError` / `QueryCancelledError` at the
        next cooperative checkpoint — the inter-query batch lane, and
        the per-index degradation circuit breaker around the
        index-fallback path.

        `tenant` names the billing identity this query charges
        (admission quotas, weighted-fair dequeue, per-tenant SLO
        window, and the `tenant.<id>.*` chargeback counters); default
        None uses the session's sticky `session.tenant(...)` choice,
        else the "default" tenant."""
        from hyperspace_tpu_torch.engine.scheduler import get_scheduler
        table, metrics = get_scheduler().collect(self, timeout=timeout,
                                                 tenant=tenant)
        return (table, metrics) if with_metrics else table

    def to_pandas(self):
        return self.collect().to_pandas()

    def count(self) -> int:
        return self.collect().num_rows

    def explain_plans(self):
        """(logical, optimized, physical) — used by plananalysis. The
        physical plan is the operator tree explain displays (the
        Exchange/Sort elision diff)."""
        from hyperspace_tpu_torch.engine.executor import compile_plan
        optimized = self._optimized_plan()
        return self.plan, optimized, compile_plan(optimized,
                                                  conf=self._conf(),
                                                  fuse=False)

    def __repr__(self):
        return f"DataFrame[{', '.join(self.schema.names)}]"


class GroupedData:
    """`df.group_by(cols).agg(...)` builder.

    Aggregations are given as tuples `(func, column[, alias])` or keyword
    form `alias=(func, column)`; funcs: sum, count, min, max, avg, stddev,
    count_distinct; column "*" with count counts rows; the column may be a
    value Expression (with an explicit alias).

        df.group_by("k").agg(("sum", "x", "total"), cnt=("count", "*"))
    """

    def __init__(self, df: DataFrame, group_columns: Sequence[str]):
        self._df = df
        self._group_columns = list(group_columns)

    def agg(self, *specs, **named) -> DataFrame:
        parsed = []
        for spec in specs:
            if not isinstance(spec, (tuple, list)) or len(spec) not in (2, 3):
                raise HyperspaceException(
                    "Aggregation spec must be (func, column[, alias]); the "
                    "column may be a name or a value Expression.")
            func, column = spec[0], spec[1]
            if len(spec) == 3:
                alias = spec[2]
            elif isinstance(column, E.Expression):
                raise HyperspaceException(
                    "Expression aggregations need an explicit alias: "
                    "(func, expr, alias).")
            else:
                alias = f"{func}_{column}" if column != "*" else func
            parsed.append(AggSpec(func, column, alias))
        for alias, spec in named.items():
            if not isinstance(spec, (tuple, list)) or len(spec) != 2:
                raise HyperspaceException(
                    "Keyword aggregation must be alias=(func, column).")
            parsed.append(AggSpec(spec[0], spec[1], alias))
        return DataFrame(Aggregate(self._group_columns, parsed,
                                   self._df.plan), self._df.session)

    # Convenience verbs.
    def count(self) -> DataFrame:
        return self.agg(("count", "*", "count"))

    def sum(self, *columns: str) -> DataFrame:
        return self.agg(*[("sum", c) for c in columns])

    def avg(self, *columns: str) -> DataFrame:
        return self.agg(*[("avg", c) for c in columns])

    def min(self, *columns: str) -> DataFrame:
        return self.agg(*[("min", c) for c in columns])

    def max(self, *columns: str) -> DataFrame:
        return self.agg(*[("max", c) for c in columns])
