"""Session: the user's entry point to the engine + optimizer hook.

Parity: the reference plugs its rules into Spark's
`sessionState.experimentalMethods.extraOptimizations` via
`enableHyperspace()` (`package.scala:46-51`); here the session owns its
optimizer rule list directly.
"""

from __future__ import annotations

import os
from typing import List, Optional

from hyperspace_tpu_torch._torch_config import (DeviceLike, device_of,
                                               resolve_device)
from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.constants import DEVICE
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.plan.nodes import LogicalPlan, Scan
from hyperspace_tpu_torch.plan.schema import Schema


class HyperspaceSession:
    """`device` names where the device lane runs: None (the default) means
    the CUDA card, "cpu" the CPU. It is recorded in the conf
    (`spark.hyperspace.device`), which every operator and the index build
    read; with no CUDA device and no explicit "cpu", construction raises
    (`_torch_config.resolve_device`)."""

    def __init__(self, conf: Optional[HyperspaceConf] = None,
                 device: DeviceLike = None):
        self.conf = conf or HyperspaceConf()
        if device is not None or not self.conf.contains(DEVICE):
            self.conf.set(DEVICE, str(resolve_device(device)))
        self.device = device_of(self.conf)
        # Session knobs -> the process-wide pipelined transfer engine
        # (io.transfer.{chunk,inflight,threads,acquire.timeout}).
        from hyperspace_tpu_torch.io import transfer
        transfer.configure(self.conf)
        # `spark.hyperspace.compile.cache.dir`: where the nvcc and g++
        # builds go and are loaded from (no-op when unset).
        from hyperspace_tpu_torch.telemetry import compilation
        compilation.configure_persistent_cache(self.conf)
        # Operations plane: the profiler, alert manager and history
        # writer read their knobs; `spark.hyperspace.telemetry.ops.port`
        # starts the timeseries sampler and the /metrics | /healthz |
        # /timeseries HTTP server (localhost; no-op when unset).
        from hyperspace_tpu_torch.telemetry import ops_server
        ops_server.configure(self.conf)
        self._rules: List = []
        self._hyperspace_enabled = False
        self._last_query_metrics = None
        self._views: dict = {}
        self._default_tenant = None
        self._closed = False

    # -- serving plane ----------------------------------------------------

    def scheduler(self):
        """The PROCESS-WIDE query scheduler every `collect` routes
        through (`engine/scheduler.py`): admission control against the
        serving HBM budget, the bounded wait queue, per-query deadlines
        + cancellation, and the per-index degradation circuit breakers.
        Sessions share it, same caveat as the transfer engine."""
        from hyperspace_tpu_torch.engine.scheduler import get_scheduler
        return get_scheduler()

    def tenant(self, tenant=None) -> "HyperspaceSession":
        """Set this session's STICKY billing tenant: every subsequent
        `collect` through this session charges `tenant` — admission
        quotas, weighted-fair dequeue weight, per-tenant SLO window,
        and the `tenant.<id>.*` chargeback counters all key on it.
        `collect(tenant=...)` overrides per call; `tenant(None)`
        reverts to the "default" tenant. Returns self for chaining: `session.tenant("acme").read_parquet(...)`."""
        self._default_tenant = str(tenant) if tenant else None
        if self._default_tenant is not None:
            from hyperspace_tpu_torch import telemetry
            telemetry._note_tenant(self._default_tenant)
        return self

    def active_queries(self) -> List[str]:
        """Ids of queries currently queued or running (process-wide) —
        the targets `cancel` accepts. A query learns its own id as
        `metrics.query_id` (`collect(with_metrics=True)`)."""
        return self.scheduler().active_queries()

    def cancel(self, query_id: str) -> bool:
        """Cooperatively cancel a queued or running query: its
        `collect` raises a typed `QueryCancelledError` at the next
        checkpoint (operator / transfer-chunk / segment-fill / write
        boundary). True iff the id was live. Cancellation is a request,
        not preemption — in-flight device work unwinds through the
        normal release paths."""
        return self.scheduler().cancel(query_id)

    def close(self, timeout_s: float = 10.0) -> None:
        """Shut this session down, IDEMPOTENTLY: cancel its live
        queries, wait (bounded) for them to drain from the scheduler,
        and flush the flight recorder's pending slow-query dumps. The
        process-wide executors (scheduler, transfer engine, IO pool)
        stay up for co-resident sessions; interpreter teardown drains
        them via their atexit hooks. A closed session refuses new
        collects."""
        if self._closed:
            return
        self._closed = True
        sched = self.scheduler()
        sched.cancel_session(self)
        sched.drain_session(self, timeout_s=timeout_s)
        from hyperspace_tpu_torch import telemetry
        telemetry.flight.get_recorder().drain()

    def last_query_metrics(self):
        """`telemetry.QueryMetrics` of the most recent query collected
        through this session, or None."""
        return self._last_query_metrics

    def flight_recorder(self):
        """The PROCESS-WIDE query flight recorder: the bounded ring of
        the last-K completed `QueryMetrics` across every session
        (always on), plus the slow-query dump policy driven by
        `spark.hyperspace.telemetry.slowlog.{seconds,dir,keep}` on the
        executing session's conf. `recorder.queries(5)` is the last
        five finished queries, newest last."""
        from hyperspace_tpu_torch import telemetry
        return telemetry.get_recorder()

    def metrics_registry(self):
        """The PROCESS-WIDE metrics registry (counters, gauges,
        histograms); sessions share it."""
        from hyperspace_tpu_torch import telemetry
        return telemetry.get_registry()

    # -- data sources -----------------------------------------------------

    def read_parquet(self, *paths: str, schema: Optional[Schema] = None):
        from hyperspace_tpu_torch.engine.dataframe import DataFrame
        if not paths:
            raise HyperspaceException("read_parquet requires at least one path.")
        if schema is None:
            import pyarrow.parquet as pq
            import glob as _glob
            from hyperspace_tpu_torch.utils import storage
            probe = paths[0]
            if storage.is_url(probe):
                fs, real = storage.get_fs(probe)
                if fs.isdir(real):
                    candidates = sorted(
                        f for f in fs.find(real) if f.endswith(".parquet"))
                    if not candidates:
                        raise HyperspaceException(
                            f"No parquet files under {probe}")
                    real = candidates[0]
                with fs.open(real, "rb") as f:
                    schema = Schema.from_arrow(pq.read_schema(f))
                return DataFrame(Scan(list(paths), schema), self)
            # (local branch below probes with os paths)
            if os.path.isdir(probe):
                candidates = sorted(
                    _glob.glob(os.path.join(probe, "**", "*.parquet"),
                               recursive=True))
                if not candidates:
                    raise HyperspaceException(f"No parquet files under {probe}")
                probe = candidates[0]
            schema = Schema.from_arrow(pq.read_schema(probe))
        return DataFrame(Scan(list(paths), schema), self)

    def create_dataframe(self, table):
        """Arrow table / pandas DataFrame -> DataFrame backed by a temp
        parquet spill (all scans are file-backed, like the reference's
        relations)."""
        import tempfile
        import pyarrow as pa
        import pyarrow.parquet as pq
        if not isinstance(table, pa.Table):
            table = pa.Table.from_pandas(table, preserve_index=False)
        tmpdir = tempfile.mkdtemp(prefix="hyperspace_df_")
        pq.write_table(table, os.path.join(tmpdir, "part-0.parquet"))
        return self.read_parquet(tmpdir)

    # -- named sources (temp views) ---------------------------------------
    #
    # Spark temp-view parity (the reference's E2E suite covers view-served
    # index queries, `E2EHyperspaceRulesTests` view cases): a view is a
    # NAME bound to a logical plan, expanded at `table()` time — so the
    # rewrite rules see the underlying relations and index signatures
    # match exactly as for a directly-built DataFrame, and serialized
    # plans (log entries) capture the expansion, never the name.

    def create_or_replace_temp_view(self, name: str, df) -> None:
        self._views[name.lower()] = df.plan

    def create_temp_view(self, name: str, df) -> None:
        if name.lower() in self._views:
            raise HyperspaceException(f"Temp view already exists: {name}")
        self._views[name.lower()] = df.plan

    def table(self, name: str):
        """DataFrame over a registered temp view (expanded plan)."""
        from hyperspace_tpu_torch.engine.dataframe import DataFrame
        plan = self._views.get(name.lower())
        if plan is None:
            raise HyperspaceException(f"Unknown table or view: {name}")
        return DataFrame(plan, self)

    def drop_temp_view(self, name: str) -> bool:
        return self._views.pop(name.lower(), None) is not None

    # -- optimizer plumbing ----------------------------------------------

    def enable_hyperspace(self) -> "HyperspaceSession":
        """Plug the rewrite rule batch (reference `package.scala:46-51`):
        JoinIndexRule before FilterIndexRule, as the reference orders them
        (`package.scala:23-34`) — once the filter rule swapped a join
        side's scan, the join rule no longer sees the base relation."""
        from hyperspace_tpu_torch.plan.rules.filter_index import (
            FilterIndexRule)
        from hyperspace_tpu_torch.plan.rules.join_index import JoinIndexRule
        if not self._hyperspace_enabled:
            self._rules = [JoinIndexRule(self), FilterIndexRule(self)]
            self._hyperspace_enabled = True
        return self

    def disable_hyperspace(self) -> "HyperspaceSession":
        """Reference `package.scala:58-63`."""
        self._rules = []
        self._hyperspace_enabled = False
        return self

    @property
    def is_hyperspace_enabled(self) -> bool:
        return self._hyperspace_enabled

    def optimize(self, plan: LogicalPlan) -> LogicalPlan:
        for rule in self._rules:
            plan = rule.apply(plan)
        # Scalar subqueries embedded in expressions carry their own
        # plans; the rules rewrite those too (Spark applies the optimizer
        # to subquery plans the same way). The rewrite lands in a
        # side-slot (`_opt_plan`), refreshed EVERY optimize — including
        # rules-off, which restores the plain plan — so the original
        # expression the user holds is never mutated.
        from hyperspace_tpu_torch.engine.executor import _scalar_subqueries
        for sub in _scalar_subqueries(plan):
            sub._opt_plan = (self.optimize(sub.plan) if self._rules
                             else None)
        return plan
