"""Plan execution entry points."""

from __future__ import annotations

import itertools
import time
import uuid
from typing import Optional, Sequence

from hyperspace_tpu_torch.engine.physical import (PhysicalNode, ProjectExec,
                                                  plan_physical)
from hyperspace_tpu_torch.io.columnar import ColumnBatch
from hyperspace_tpu_torch.plan.nodes import LogicalPlan

# Per-query profiler captures (`spark.hyperspace.trace.dir`): a process
# run id + sequence names each capture directory uniquely; the capture
# itself serializes inside `telemetry.profiler.device_trace` (torch
# permits one active profiler per process).
_trace_seq = itertools.count()
_trace_run_id = uuid.uuid4().hex[:8]


def compile_plan(plan: LogicalPlan,
                 projection: Optional[Sequence[str]] = None,
                 conf=None, fuse: Optional[bool] = None) -> PhysicalNode:
    """Logical -> executable physical plan (output cut to `projection`
    when given). `fuse=None` follows the conf (whole-stage fusion on by
    default); explain/analysis paths pass fuse=False — the operator tree
    IS the display contract (the Exchange/Sort elision diff), and fusion
    groups operators without changing them."""
    required = set(projection) if projection is not None else None
    physical = plan_physical(plan, required, conf)
    if projection is not None:
        physical = ProjectExec(list(projection), physical)
    if fuse is None:
        fuse = conf is None or conf.fusion_enabled
    if fuse:
        from hyperspace_tpu_torch.engine.fusion import fuse_physical
        physical = fuse_physical(physical, conf=conf)
    return physical


def _scalar_subqueries(plan: LogicalPlan):
    """Every ScalarSubquery expression reachable from `plan` (conditions,
    projections, aggregate inputs) — subquery plans are NOT descended
    into here; resolution recurses through execute_plan instead."""
    from hyperspace_tpu_torch.plan import expr as E
    from hyperspace_tpu_torch.plan.nodes import (Aggregate, Filter, Join,
                                                 Project, Window)

    found = []

    def walk_expr(e):
        if isinstance(e, E.ScalarSubquery):
            found.append(e)
            return
        # children already includes In values and CaseWhen branches.
        for c in e.children:
            walk_expr(c)

    def visit(node):
        if isinstance(node, Filter):
            walk_expr(node.condition)
        elif isinstance(node, Project):
            for c in node.columns:
                if not isinstance(c, str):
                    walk_expr(c)
        elif isinstance(node, Join) and node.condition is not None:
            walk_expr(node.condition)
        elif isinstance(node, (Aggregate, Window)):
            for spec in (node.aggregates if isinstance(node, Aggregate)
                         else node.specs):
                if spec.is_expression:
                    walk_expr(spec.column)
        for c in node.children:
            visit(c)

    visit(plan)
    return found


def _resolve_scalar_subqueries(plan: LogicalPlan, conf) -> None:
    """Execute every unresolved scalar subquery in `plan` and cache its
    value on the node (the subquery-execution phase; Spark does the same
    before the main plan runs). One column required; one row -> value,
    zero rows -> SQL NULL, more -> error. Nested subqueries resolve
    through the recursive execute_plan call. The value crosses to the
    host here, once per subquery: it becomes a literal of the main plan."""
    import numpy as np

    from hyperspace_tpu_torch.io.columnar import batch_to_host

    for sub in _scalar_subqueries(plan):
        if sub._resolved:
            continue
        batch = execute_plan(sub.execution_plan(), conf=conf)
        if batch.num_rows > 1:
            from hyperspace_tpu_torch.exceptions import HyperspaceException
            raise HyperspaceException(
                f"Scalar subquery returned {batch.num_rows} rows.")
        if batch.num_rows == 0:
            sub.resolve(None)
            continue
        batch = batch_to_host(batch)
        (field,) = batch.schema.fields
        col = batch.columns[field.name]
        if col.validity is not None and not bool(col.validity[0]):
            sub.resolve(None)
            continue
        raw = np.asarray(col.data)[0]
        if col.is_string:
            sub.resolve(str(col.dictionary[int(raw)]))
        elif field.dtype == "bool":
            sub.resolve(bool(raw))
        elif field.dtype in ("float32", "float64"):
            sub.resolve(float(raw))
        else:
            sub.resolve(int(raw))


def execute_plan(plan: LogicalPlan,
                 projection: Optional[Sequence[str]] = None,
                 conf=None) -> ColumnBatch:
    """Resolve the plan's scalar subqueries, plan it physically and run
    it. With `spark.hyperspace.trace.dir` set, the execution is captured
    by `torch.profiler` into one directory per query under it
    (`<dir>/query-<run>-<seq>/trace.json`)."""
    from hyperspace_tpu_torch import telemetry

    _resolve_scalar_subqueries(plan, conf)
    t0 = time.perf_counter()
    physical = compile_plan(plan, projection, conf)
    telemetry.add_seconds("plan_s", time.perf_counter() - t0)
    trace_dir = conf.trace_dir if conf is not None else None
    if not trace_dir:
        return physical.execute()
    from hyperspace_tpu_torch.telemetry import profiler

    seq = next(_trace_seq)
    capture = f"{trace_dir.rstrip('/')}/query-{_trace_run_id}-{seq:05d}"
    telemetry.event("profiler", "capture", path=capture)
    with profiler.device_trace(capture):
        out = physical.execute()
        # All of the query's device work inside the capture window: the
        # kernels and copies queued asynchronously finish before it
        # closes (a host-lane result may still have used the card).
        import torch
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    return out
