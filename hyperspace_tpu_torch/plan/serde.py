"""Plan <-> JSON serde.

The reference Kryo-serializes Catalyst plans with a zoo of wrapper nodes for
non-serializable internals (`index/serde/LogicalPlanSerDeUtils.scala:40-217`,
`index/serde/package.scala:29-167`). Owning the IR makes serde trivial —
plans round-trip through plain JSON — while keeping the reference's
*unanalyzed-plan-logged, re-resolved-on-refresh* semantics: Scan nodes store
root paths only (like `InMemoryFileIndexWrapper` keeping rootPathStrings),
and the file listing is re-enumerated at deserialization time so refresh
picks up appended/changed data (reference `LogicalPlanSerDeUtils.scala:150-217`).
"""

from __future__ import annotations

import json

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.plan.expr import Expression
from hyperspace_tpu_torch.plan.nodes import (Aggregate, AggSpec,
                                             BucketSpec, Except, Filter,
                                             Intersect, Join, Limit,
                                             LogicalPlan, Project, Scan, Sort,
                                             Union, Window)
from hyperspace_tpu_torch.plan.schema import Field, Schema


def plan_to_json(plan: LogicalPlan) -> str:
    return json.dumps(plan.to_dict())


def plan_from_dict(d: dict) -> LogicalPlan:
    node = d.get("node")
    if node == "scan":
        # Root paths only by default; the file listing is re-resolved lazily
        # (fresh enumeration = refresh sees new data). An explicit "files"
        # restriction (hybrid scan / delta scans) is preserved verbatim.
        return Scan(root_paths=d["rootPaths"],
                    schema=Schema([Field.from_dict(f) for f in d["schema"]]),
                    file_format=d.get("format", "parquet"),
                    bucket_spec=BucketSpec.from_dict(d.get("bucketSpec")),
                    files=d.get("files"))
    if node == "filter":
        return Filter(Expression.from_dict(d["condition"]),
                      plan_from_dict(d["child"]))
    if node == "project":
        return Project([c if isinstance(c, str) else Expression.from_dict(c)
                        for c in d["columns"]], plan_from_dict(d["child"]))
    if node == "join":
        cond = d["condition"]
        return Join(plan_from_dict(d["left"]), plan_from_dict(d["right"]),
                    Expression.from_dict(cond) if cond is not None else None,
                    d.get("type", "inner"))
    if node == "union":
        return Union([plan_from_dict(c) for c in d["children"]])
    if node == "aggregate":
        return Aggregate(d["groupBy"],
                         [AggSpec.from_dict(a) for a in d["aggregates"]],
                         plan_from_dict(d["child"]))
    if node == "window":
        return Window(d["partitionBy"], d["orderBy"],
                      [AggSpec.from_dict(s) for s in d["specs"]],
                      plan_from_dict(d["child"]))
    if node == "sort":
        return Sort(d["columns"], plan_from_dict(d["child"]))
    if node == "limit":
        return Limit(d["n"], plan_from_dict(d["child"]))
    if node == "intersect":
        return Intersect(plan_from_dict(d["left"]),
                         plan_from_dict(d["right"]))
    if node == "except":
        return Except(plan_from_dict(d["left"]), plan_from_dict(d["right"]))
    raise HyperspaceException(f"Unknown plan node kind: {node}")


def plan_from_json(text: str) -> LogicalPlan:
    return plan_from_dict(json.loads(text))
