"""Physical plan: executable operator tree.

This package executes the filter path of the Quick Start loop: Scan,
Filter and Project, with bucket pruning of equality literals over an
index's bucketed layout. Any other logical node raises a typed
HyperspaceException; joins (with their Exchange/Sort elision), aggregates,
sorts and the other operators are queued in ROADMAP.md (the PyTorch port's
queue).
"""

from __future__ import annotations

import functools
import itertools
from typing import List, Optional, Sequence, Set

import numpy as np

from hyperspace_tpu_torch import telemetry
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.io import columnar, parquet
from hyperspace_tpu_torch.plan import expr as E
from hyperspace_tpu_torch.plan.nodes import (Filter, LogicalPlan, Project,
                                             Scan)
from hyperspace_tpu_torch.plan.schema import Schema


def _instrument(fn):
    """Wrap an execute implementation with the telemetry operator hook: a
    per-query operator record (active recorder) and a trace span on the
    executing thread (active tracer). With neither, the cost is one
    ContextVar read + one global read + None checks. Applied automatically
    to every PhysicalNode subclass by `PhysicalNode.__init_subclass__`."""

    @functools.wraps(fn)
    def wrapper(self):
        rec = telemetry.current()
        tr = telemetry.tracer()
        if rec is None and tr is None:
            return fn(self)
        op = rec.start_operator(self.name, self) if rec is not None else None
        ts = tr.now_us() if tr is not None else 0.0
        try:
            out = fn(self)
        except BaseException as exc:
            if tr is not None:
                tr.complete(self.name, "operator", ts, tr.now_us() - ts,
                            args={"error": repr(exc)})
            if op is not None:
                rec.finish_operator(op, error=repr(exc))
            raise
        if tr is not None:
            tr.complete(self.name, "operator", ts, tr.now_us() - ts,
                        args={"rows": out.num_rows})
        if op is not None:
            rec.finish_operator(op, rows_out=out.num_rows)
        return out

    wrapper.__telemetry_instrumented__ = True
    return wrapper


class PhysicalNode:
    name: str = "Physical"

    def __init_subclass__(cls, **kwargs):
        # EVERY subclass's execute emits an operator metrics record.
        super().__init_subclass__(**kwargs)
        fn = cls.__dict__.get("execute")
        if fn is not None and not getattr(fn, "__telemetry_instrumented__",
                                          False):
            cls.execute = _instrument(fn)

    @property
    def children(self) -> List["PhysicalNode"]:
        return []

    def execute(self) -> columnar.ColumnBatch:
        raise NotImplementedError

    def simple_string(self) -> str:
        return self.name

    def tree_string(self, depth: int = 0) -> str:
        lines = [("  " * depth) + ("+- " if depth else "")
                 + self.simple_string()]
        for c in self.children:
            lines.append(c.tree_string(depth + 1))
        return "\n".join(lines)

    def collect(self) -> List["PhysicalNode"]:
        out = [self]
        for c in self.children:
            out.extend(c.collect())
        return out


def _empty_batch(schema: Schema) -> columnar.ColumnBatch:
    import pyarrow as pa
    return columnar.from_arrow(
        pa.table({f.name: pa.array([], type=t.type)
                  for f, t in zip(schema.fields, schema.to_arrow())}), schema)


class ScanExec(PhysicalNode):
    name = "Scan"

    def __init__(self, scan: Scan, columns: Sequence[str],
                 allowed_buckets: Optional[Set[int]] = None, conf=None):
        self.scan = scan
        self.columns = list(columns)
        self.out_schema = scan.schema.select(columns)
        self.conf = conf
        # Bucket pruning: when a filter above constrains every bucket
        # column to literal values, only these buckets can contain matches
        # (set by the planner, `_prune_buckets`). The index read then
        # touches 1/num_buckets of the files per point value.
        self.allowed_buckets = allowed_buckets

    def _annotate_read(self, files: List[str], host: bool,
                       files_total: Optional[int]) -> None:
        """Index-usage detail on this scan's operator record: lane, files
        scanned vs total, buckets scanned vs total."""
        if telemetry.current() is None:
            return
        detail = {"lane": "host" if host else "device",
                  "files_scanned": len(files),
                  "roots": list(self.scan.root_paths)}
        spec = self.scan.bucket_spec
        if spec is not None:
            detail["buckets_total"] = spec.num_buckets
            detail["buckets_scanned"] = (len(self.allowed_buckets)
                                         if self.allowed_buckets is not None
                                         else spec.num_buckets)
        if files_total is not None:
            detail["files_total"] = files_total
        telemetry.annotate(**detail)

    def simple_string(self) -> str:
        bucket = (f", buckets={self.scan.bucket_spec.num_buckets}"
                  if self.scan.bucket_spec else "")
        pruned = ""
        if self.allowed_buckets is not None and self.scan.bucket_spec:
            pruned = (f", prunedBuckets={len(self.allowed_buckets)}"
                      f"/{self.scan.bucket_spec.num_buckets}")
        return (f"Scan parquet [{', '.join(self.columns)}] "
                f"{self.scan.root_paths}{bucket}{pruned}")

    def _guard_index_read(self, fn):
        """Run the read with the graceful-degradation contract: for a
        RULE-SELECTED index scan (scan.index_name set), data that turns
        out missing or unreadable raises the typed
        IndexDataUnavailableError that `DataFrame.collect` converts into a
        fallback to the source plan. Source-data scans keep their raw
        errors: there is nothing to degrade to."""
        from hyperspace_tpu_torch.exceptions import IndexDataUnavailableError

        name = self.scan.index_name
        if name is None:
            return fn()
        from hyperspace_tpu_torch.utils import file_utils
        missing = [r for r in self.scan.root_paths
                   if not file_utils.is_dir(r)
                   and not file_utils.is_file(r)]
        if missing:
            raise IndexDataUnavailableError(
                f"Index {name!r} data root(s) missing: "
                f"{', '.join(missing)}", index_name=name)
        try:
            return fn()
        except HyperspaceException:
            raise
        except Exception as exc:
            raise IndexDataUnavailableError(
                f"Index {name!r} data unreadable: {exc!r}",
                index_name=name) from exc

    def execute(self) -> columnar.ColumnBatch:
        return self._guard_index_read(self._execute)

    def _per_bucket_files(self) -> dict:
        """{bucket id: files} for this scan. An explicit or plan-time
        pinned file listing is grouped as it stands (no re-listing at
        execution); otherwise each root is listed."""
        if self.scan.pinned_version is not None \
                or self.scan._explicit_files:
            return parquet.bucket_map(self.scan.files())
        out: dict = {}
        for root in self.scan.root_paths:
            for b, fs in parquet.bucket_files(root).items():
                out.setdefault(b, []).extend(fs)
        return out

    def _execute(self) -> columnar.ColumnBatch:
        if self.allowed_buckets is not None and self.scan.bucket_spec:
            per_bucket = self._per_bucket_files()
            files_total = sum(len(v) for v in per_bucket.values())
            files = [f for b in sorted(self.allowed_buckets)
                     for f in per_bucket.get(b, [])]
        else:
            files = self.scan.files()
            files_total = len(files)
        if not files:
            return _empty_batch(self.out_schema)
        # Adaptive lane: small reads (e.g. a pruned point-filter bucket)
        # stay in host memory — a device round-trip would dwarf the work.
        from hyperspace_tpu_torch.constants import MIN_DEVICE_ROWS_DEFAULT
        min_dev = (self.conf.min_device_rows if self.conf is not None
                   else MIN_DEVICE_ROWS_DEFAULT)
        host = sum(parquet.file_row_counts(files)) < min_dev
        self._annotate_read(files, host, files_total)
        if host:
            return parquet.read_host_batch(files, self.columns,
                                           self.out_schema)
        # Device lane: pyarrow decode on the host, one H2D copy per
        # column onto the session's device.
        from hyperspace_tpu_torch._torch_config import device_of
        table = parquet.read_table(files, columns=self.columns)
        return columnar.from_arrow(table, self.out_schema,
                                   device=device_of(self.conf))


class FilterExec(PhysicalNode):
    name = "Filter"

    def __init__(self, condition: E.Expression, child: PhysicalNode):
        self.condition = condition
        self.child = child

    @property
    def children(self):
        return [self.child]

    def simple_string(self) -> str:
        return f"Filter ({self.condition!r})"

    def execute(self) -> columnar.ColumnBatch:
        from hyperspace_tpu_torch.engine.compiler import apply_filter
        batch = self.child.execute()
        if batch.num_rows == 0:
            return batch
        return apply_filter(batch, self.condition)


class ProjectExec(PhysicalNode):
    """Projection over (out_name, source) entries, where source is a plain
    child column name (pass-through) or a value Expression compiled by the
    same compiler filters use."""

    name = "Project"

    def __init__(self, entries, child: PhysicalNode):
        # Accept bare name strings (pass-through) or (out_name, source)
        # pairs; `source` is a child column name or an Expression.
        self.entries = [(e, e) if isinstance(e, str) else (e[0], e[1])
                        for e in entries]
        self.child = child

    @property
    def columns(self) -> List[str]:
        """Output names (the view the plan display uses)."""
        return [name for name, _ in self.entries]

    @property
    def children(self):
        return [self.child]

    def simple_string(self) -> str:
        parts = [name if isinstance(src, str) and src == name
                 else f"{src!r} AS {name}" for name, src in self.entries]
        return f"Project [{', '.join(parts)}]"

    def execute(self) -> columnar.ColumnBatch:
        batch = self.child.execute()
        if all(isinstance(src, str) for _, src in self.entries):
            return batch.select([src for _, src in self.entries])
        from hyperspace_tpu_torch.engine.compiler import ExpressionCompiler
        from hyperspace_tpu_torch.plan.expr import infer_dtype
        from hyperspace_tpu_torch.plan.schema import Field
        compiler = ExpressionCompiler(batch)
        fields: List[Field] = []
        columns = {}
        for name, src in self.entries:
            if isinstance(src, str):
                f = batch.schema.field(src)
                columns[name] = batch.column(src)
                fields.append(Field(name, f.dtype, f.nullable))
            else:
                dtype = infer_dtype(src, batch.schema)
                columns[name] = compiler.value_column(src, dtype)
                fields.append(Field(name, dtype, True))
        return columnar.ColumnBatch(Schema(fields), columns)


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------


_PRUNE_MAX_COMBOS = 64


def _literal_values_for(column: str, conjuncts) -> Optional[List]:
    """Literal values `column` may take under the conjunction, from the
    narrowest `col = lit` / `col IN (lits)` constraint; None if
    unconstrained (or only constrained through nulls, where pruning is
    skipped — `x = NULL` is never true, so correctness never depends on
    pruning)."""
    best: Optional[List] = None
    for c in conjuncts:
        values = None
        if isinstance(c, E.EqualTo):
            a, b = c.left, c.right
            if isinstance(a, E.Column) and isinstance(b, E.Literal):
                values = [b.value] if a.name.lower() == column else None
            elif isinstance(b, E.Column) and isinstance(a, E.Literal):
                values = [a.value] if b.name.lower() == column else None
        elif (isinstance(c, E.In) and isinstance(c.child, E.Column)
              and c.child.name.lower() == column):
            values = [v.value for v in c.values]
        if values is None or any(v is None for v in values):
            continue
        if best is None or len(values) < len(best):
            best = values
    return best


def _prune_buckets(condition: E.Expression,
                   scan: Scan) -> Optional[Set[int]]:
    """Bucket ids that can contain rows satisfying `condition`, or None
    when pruning does not apply. Sound because every bucket column must be
    pinned to literals by top-level conjuncts: any matching row hashes to
    one of the returned buckets. The literal tuples are hashed with the
    host mirror of THE build hash (`ops/host_hash.host_bucket_ids`) so the
    computed ids match the on-disk layout exactly."""
    spec = scan.bucket_spec
    if spec is None:
        return None
    conjuncts = E.split_conjunctive(condition)
    per_column: List[List] = []
    for c in spec.bucket_columns:
        values = _literal_values_for(c.lower(), conjuncts)
        if values is None:
            return None
        per_column.append(values)
    combos = list(itertools.product(*per_column))
    if not combos or len(combos) > _PRUNE_MAX_COMBOS:
        return None

    from hyperspace_tpu_torch.ops.host_hash import host_bucket_ids

    key_schema = scan.schema.select(list(spec.bucket_columns))
    np_of = {"int64": np.int64, "int32": np.int32, "int16": np.int16,
             "int8": np.int8, "bool": np.bool_, "float64": np.float64,
             "float32": np.float32, "date32": np.int32,
             "timestamp": np.int64, "string": None}
    try:
        columns = []
        for i, f in enumerate(key_schema.fields):
            vals = [combo[i] for combo in combos]
            dt = np_of[f.dtype]
            columns.append(np.asarray(vals, dtype=str) if dt is None
                           else np.asarray(vals).astype(dt))
        ids = host_bucket_ids(columns, [f.dtype for f in key_schema.fields],
                              spec.num_buckets)
    except (ValueError, TypeError, OverflowError, HyperspaceException):
        return None  # literal not representable in the key type -> no prune
    return set(int(b) for b in ids)


def _apply_bucket_pruning(condition: E.Expression, child: PhysicalNode):
    """Descend the Project/Filter chain to its ScanExec and attach the
    allowed bucket set derived from the filter condition (no-op on
    unbucketed scans). Descending through an intermediate Filter is sound:
    pruning only drops buckets no row of which can satisfy the OUTER
    condition, and inner filters only remove more rows."""
    node = child
    while isinstance(node, (ProjectExec, FilterExec)):
        node = node.child
    if isinstance(node, ScanExec) and node.allowed_buckets is None:
        node.allowed_buckets = _prune_buckets(condition, node.scan)
    return child


def _required_for(plan: LogicalPlan, required: Set[str]) -> List[str]:
    """required column names resolved against plan schema, in schema order."""
    lowered = {r.lower() for r in required}
    return [f.name for f in plan.schema.fields if f.name.lower() in lowered]


def plan_physical(plan: LogicalPlan,
                  required: Optional[Set[str]] = None,
                  conf=None) -> PhysicalNode:
    """Logical -> physical with projection pushdown into scans. `conf`
    carries the session's lane thresholds and device to the scans."""
    if required is None:
        required = set(plan.schema.names)

    if isinstance(plan, Scan):
        return ScanExec(plan, _required_for(plan, required), conf=conf)

    if isinstance(plan, Filter):
        child_required = set(required) | plan.condition.references()
        child = _apply_bucket_pruning(
            plan.condition, plan_physical(plan.child, child_required, conf))
        return FilterExec(plan.condition, child)

    if isinstance(plan, Project):
        child = plan_physical(plan.child, plan.references(), conf)
        # Resolve names against the child schema but KEEP the declared
        # order; computed entries carry their expression.
        entries = []
        for c in plan.columns:
            if isinstance(c, str):
                f = plan.child.schema.field(c)
                entries.append((f.name, f.name))
            else:
                entries.append((c.name, c.child))
        return ProjectExec(entries, child)

    raise HyperspaceException(
        f"{type(plan).__name__} is not executable in hyperspace_tpu_torch "
        f"yet (this package runs Scan, Filter and Project); the operator "
        f"is queued in ROADMAP.md's PyTorch port queue.")
