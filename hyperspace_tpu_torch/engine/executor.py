"""Plan execution entry point."""

from __future__ import annotations

import time
from typing import Optional, Sequence

from hyperspace_tpu_torch.engine.physical import ProjectExec, plan_physical
from hyperspace_tpu_torch.io.columnar import ColumnBatch
from hyperspace_tpu_torch.plan.nodes import LogicalPlan


def execute_plan(plan: LogicalPlan,
                 projection: Optional[Sequence[str]] = None,
                 conf=None) -> ColumnBatch:
    """Plan `plan` physically (output cut to `projection` when given) and
    run it."""
    from hyperspace_tpu_torch import telemetry

    t0 = time.perf_counter()
    required = set(projection) if projection is not None else None
    physical = plan_physical(plan, required, conf)
    if projection is not None:
        physical = ProjectExec(list(projection), physical)
    telemetry.add_seconds("plan_s", time.perf_counter() - t0)
    return physical.execute()
