"""Query-level telemetry: per-operator metrics + structured decision events.

The reference ships real query observability — `PlanAnalyzer.explain` /
`whyNot` tell the user which index rules fired and why
(`PlanAnalyzer.scala:45-360`) — and leans on Spark's per-operator SQL
metrics for its tuning story. This package is the engine's runtime half
of that: ONE `QueryMetrics` recorder is threaded through a query
execution end-to-end and returned to the user, capturing

- per-physical-operator wall time and output row counts (the executor's
  operator walk, instrumented in `engine/physical.py`);
- structured decision events: optimizer rule fired/skipped with reason
  (`plan/rules/*`);
- index usage: which covering index served which scan, bucket counts,
  files scanned vs pruned (`plan/rules/*` + `ScanExec`).

Scoping: the active recorder is a `contextvars.ContextVar`, so
concurrent sessions (or threads) never see each other's metrics. When no
recorder is active every hook is a single ContextVar read + None check —
the always-off cost on hot paths.

Surface: `DataFrame.collect(with_metrics=True)` returns the recorder
next to the result; `session.last_query_metrics()` returns the most
recent one; `to_json()` / `format_tree()` render reports.

Process-wide observability rides in sibling modules re-exported here:
`registry` (named counters/gauges/log-bucketed histograms aggregating
across queries and sessions; Prometheus text dump), `trace` (span
tracer with Chrome trace-event / Perfetto export — `enable_tracing()`
then `export_trace(path)` — and the host<->device link counters) and
`memory` (the device-memory accountant and the `cache.<name>.*`
series). The JAX package's profiler, compile instrumentation, flight
recorder, deadlines, tenants and ops server are not part of this
package yet (`ROADMAP.md`).
"""

from __future__ import annotations

import contextvars
import itertools
import json
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

from hyperspace_tpu_torch.telemetry.registry import (MetricsRegistry,
                                                     get_registry)
from hyperspace_tpu_torch.telemetry.trace import (Tracer, disable_tracing,
                                                  enable_tracing,
                                                  export_trace,
                                                  link_transfer,
                                                  record_link_transfer, span,
                                                  tracer, tracing_enabled)
from hyperspace_tpu_torch.telemetry import memory  # noqa: F401
from hyperspace_tpu_torch.telemetry.memory import (DeviceMemoryAccountant,
                                                   get_accountant)

__all__ = [
    "QueryMetrics", "OperatorRecord", "current", "recording", "event",
    "annotate", "add_seconds", "add_count", "MetricsRegistry",
    "get_registry", "Tracer", "enable_tracing", "disable_tracing",
    "tracing_enabled", "tracer", "span", "link_transfer",
    "record_link_transfer", "export_trace", "memory",
    "DeviceMemoryAccountant", "get_accountant",
]


_current: contextvars.ContextVar[Optional["QueryMetrics"]] = \
    contextvars.ContextVar("hyperspace_query_metrics", default=None)

def current() -> Optional["QueryMetrics"]:
    """The recorder of the query executing on this thread, or None."""
    return _current.get()


@contextmanager
def recording(metrics: "QueryMetrics"):
    """Make `metrics` the active recorder for the calling context."""
    token = _current.set(metrics)
    try:
        yield metrics
    finally:
        _current.reset(token)


def event(category: str, name: str, **detail) -> None:
    """Record a structured decision event on the active recorder (no-op
    without one). Keep values JSON-serializable."""
    rec = _current.get()
    if rec is not None:
        rec.event(category, name, **detail)


def annotate(**detail) -> None:
    """Attach detail to the operator record currently executing on this
    thread (no-op without a recorder or outside an operator)."""
    rec = _current.get()
    if rec is not None:
        rec.annotate_current(**detail)


def add_seconds(counter: str, seconds: float) -> None:
    """Accumulate a per-query timing counter (no-op without a recorder)."""
    rec = _current.get()
    if rec is not None:
        rec.add_seconds(counter, seconds)


def add_count(counter: str, n: int = 1) -> None:
    rec = _current.get()
    if rec is not None:
        rec.add_count(counter, n)


class OperatorRecord:
    """One physical operator execution: identity, tree position, wall
    time, and output rows. `rows_out` for device batches is the static
    shape (no sync is forced to report it); `wall_s` on the device lane
    measures dispatch-side time unless the operator itself syncs.

    The display label (`simple_string()` of the node) is resolved
    LAZILY — at query finish or first report — so the per-operator
    recording cost on the execute hot path stays at two perf_counter
    reads plus an append."""

    __slots__ = ("op_id", "parent_id", "name", "bucketed",
                 "wall_s", "rows_out", "detail", "error", "_t0",
                 "_node", "_label")

    def __init__(self, op_id: int, parent_id: Optional[int], name: str,
                 node, bucketed: bool):
        self.op_id = op_id
        self.parent_id = parent_id
        self.name = name
        self.bucketed = bucketed
        self.wall_s = 0.0
        self.rows_out: Optional[int] = None
        self.detail: Dict = {}
        self.error: Optional[str] = None
        self._node = node
        self._label: Optional[str] = None
        self._t0 = time.perf_counter()

    @property
    def label(self) -> str:
        if self._label is None:
            node, self._node = self._node, None
            if node is None:
                self._label = self.name
            else:
                try:
                    self._label = node.simple_string()
                except Exception:
                    self._label = self.name
        return self._label

    def to_dict(self) -> dict:
        d = {"op_id": self.op_id, "parent_id": self.parent_id,
             "name": self.name, "label": self.label,
             "wall_s": round(self.wall_s, 6), "rows_out": self.rows_out}
        if self.bucketed:
            d["bucketed"] = True
        if self.detail:
            d["detail"] = dict(self.detail)
        if self.error is not None:
            d["error"] = self.error
        return d


class QueryMetrics:
    """Everything recorded about ONE query execution. Thread-safe for
    append (operators may execute on pool threads); the per-thread
    operator stack lives in a threading.local so concurrent subtree
    executions keep their own parent chains."""

    def __init__(self, description: str = ""):
        self.description = description
        self.started_at = time.time()
        self.wall_s: Optional[float] = None
        self.operators: List[OperatorRecord] = []
        self.events: List[dict] = []
        self.counters: Dict[str, float] = {}
        # Device-memory watermarks observed while this query ran
        # (`telemetry/memory.py` samples at link transfers).
        self.peak_hbm_bytes = 0
        self.peak_hbm_per_device: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._tls = threading.local()
        self._t0 = time.perf_counter()

    # -- recorder side (engine hooks) ----------------------------------

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack


    def start_operator(self, name: str, node=None,
                       bucketed: bool = False) -> OperatorRecord:
        stack = self._stack()
        parent = stack[-1].op_id if stack else None
        # next() on itertools.count and list.append are both atomic
        # under the GIL — the hot path takes no lock.
        op = OperatorRecord(next(self._ids), parent, name, node, bucketed)
        self.operators.append(op)
        stack.append(op)
        return op

    def finish_operator(self, op: OperatorRecord,
                        rows_out: Optional[int] = None,
                        error: Optional[str] = None) -> None:
        op.wall_s = time.perf_counter() - op._t0
        op.rows_out = rows_out
        op.error = error
        stack = self._stack()
        if stack and stack[-1] is op:
            stack.pop()
        else:  # unbalanced (exception skipped a frame): resync
            while stack and stack[-1] is not op:
                stack.pop()
            if stack:
                stack.pop()

    def annotate_current(self, **detail) -> None:
        stack = self._stack()
        if stack:
            stack[-1].detail.update(detail)

    def event(self, category: str, name: str, **detail) -> None:
        e = {"category": category, "name": name}
        e.update(detail)
        with self._lock:
            self.events.append(e)

    def add_seconds(self, counter: str, seconds: float) -> None:
        with self._lock:
            self.counters[counter] = self.counters.get(counter, 0.0) \
                + float(seconds)

    def add_count(self, counter: str, n: int = 1) -> None:
        with self._lock:
            self.counters[counter] = self.counters.get(counter, 0) + n

    def observe_hbm(self, live: Dict[str, int]) -> None:
        """Fold one memory sample ({device: bytes in use}) into this
        query's peak watermarks."""
        with self._lock:
            for dev, in_use in live.items():
                if in_use > self.peak_hbm_per_device.get(dev, 0):
                    self.peak_hbm_per_device[dev] = in_use
            self.peak_hbm_bytes = max(self.peak_hbm_bytes,
                                      sum(live.values()))

    def finish(self) -> "QueryMetrics":
        self.wall_s = time.perf_counter() - self._t0
        for op in self.operators:
            op.label  # resolve now; releases the node references
        return self

    # -- user side (reports) -------------------------------------------

    def events_of(self, category: str, name: Optional[str] = None
                  ) -> List[dict]:
        return [e for e in self.events
                if e["category"] == category
                and (name is None or e["name"] == name)]

    def index_usage(self) -> List[dict]:
        """Index-usage records: one per rule application (index name,
        side, bucket count) joined against the scan records that actually
        read the index data (files scanned vs pruned). Bucketed scans no
        rule claimed (hand-built layouts) are reported without a name."""
        scans = [op for op in self.operators if op.name == "Scan"]
        claimed: set = set()
        out = []
        for e in self.events_of("rule"):
            if e.get("action") != "applied":
                continue
            for use in e.get("indexes", []):
                rec = dict(use)
                rec["rule"] = e["name"]
                root = use.get("root")
                for op in scans:
                    if root and root in op.detail.get("roots", ()):
                        claimed.add(op.op_id)
                        for k in ("files_scanned", "files_total",
                                  "buckets_scanned", "buckets_total",
                                  "lane"):
                            if k in op.detail:
                                rec[k] = op.detail[k]
                        rec["rows_out"] = op.rows_out
                out.append(rec)
        for op in scans:
            if op.op_id in claimed or "buckets_total" not in op.detail:
                continue
            rec = {"name": None, "rule": None,
                   "root": (op.detail.get("roots") or [None])[0],
                   "rows_out": op.rows_out}
            for k in ("files_scanned", "files_total", "buckets_scanned",
                      "buckets_total", "lane"):
                if k in op.detail:
                    rec[k] = op.detail[k]
            out.append(rec)
        return out

    def to_dict(self) -> dict:
        out = {
            "description": self.description,
            "started_at": self.started_at,
            "wall_s": (round(self.wall_s, 6)
                       if self.wall_s is not None else None),
            "operators": [op.to_dict() for op in self.operators],
            "events": list(self.events),
            "counters": {k: (round(v, 6) if isinstance(v, float) else v)
                         for k, v in self.counters.items()},
            "index_usage": self.index_usage(),
        }
        return out

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=False,
                          default=str)

    def summary(self) -> dict:
        """Compact per-query digest — what the bench artifacts embed so
        future rounds carry operator-level trajectories, not just
        totals. Operator seconds are summed per operator type over
        SELF time (child time subtracted), so the digest adds up instead
        of double-counting nested walls."""
        child_s: Dict[Optional[int], float] = {}
        for op in self.operators:
            child_s[op.parent_id] = child_s.get(op.parent_id, 0.0) \
                + op.wall_s
        per_op: Dict[str, dict] = {}
        for op in self.operators:
            ent = per_op.setdefault(op.name, {"count": 0, "self_s": 0.0,
                                              "rows_out": 0})
            ent["count"] += 1
            ent["self_s"] += max(op.wall_s
                                 - child_s.get(op.op_id, 0.0), 0.0)
            ent["rows_out"] += op.rows_out or 0
        for ent in per_op.values():
            ent["self_s"] = round(ent["self_s"], 4)
        rules: Dict[str, int] = {}
        for e in self.events_of("rule"):
            key = f"{e['name']}:{e.get('action', '?')}"
            rules[key] = rules.get(key, 0) + 1
        out = {
            "wall_s": (round(self.wall_s, 4)
                       if self.wall_s is not None else None),
            "operators": per_op,
            "rules": rules,
            "counters": {k: (round(v, 4) if isinstance(v, float) else v)
                         for k, v in self.counters.items()},
            "index_usage": self.index_usage(),
        }
        return out

    def format_tree(self) -> str:
        """Operator tree with runtime numbers."""
        children: Dict[Optional[int], List[OperatorRecord]] = {}
        for op in self.operators:
            children.setdefault(op.parent_id, []).append(op)
        lines: List[str] = []
        header = "Query metrics"
        if self.description:
            header += f" — {self.description}"
        if self.wall_s is not None:
            header += f" ({self.wall_s:.3f}s)"
        lines.append(header)

        def emit(op: OperatorRecord, depth: int) -> None:
            pad = "  " * depth + ("+- " if depth else "")
            rows = f" rows={op.rows_out}" if op.rows_out is not None else ""
            extra = ""
            if op.detail:
                keys = ("lane", "files_scanned", "files_total",
                        "buckets_scanned", "buckets_total", "reused")
                bits = [f"{k}={op.detail[k]}" for k in keys
                        if k in op.detail]
                if bits:
                    extra = " [" + ", ".join(bits) + "]"
            err = f" ERROR={op.error}" if op.error else ""
            lines.append(f"{pad}{op.label}  ({op.wall_s:.4f}s{rows})"
                         f"{extra}{err}")
            for c in children.get(op.op_id, []):
                emit(c, depth + 1)

        for root in children.get(None, []):
            emit(root, 1)
        if self.events:
            lines.append("Events:")
            for e in self.events:
                detail = {k: v for k, v in e.items()
                          if k not in ("category", "name")}
                lines.append(f"  [{e['category']}] {e['name']} "
                             + json.dumps(detail, default=str))
        if self.counters:
            lines.append("Counters:")
            for k in sorted(self.counters):
                v = self.counters[k]
                lines.append(f"  {k} = "
                             + (f"{v:.4f}" if isinstance(v, float)
                                else str(v)))
        return "\n".join(lines)

    def __repr__(self) -> str:
        return (f"QueryMetrics({len(self.operators)} operators, "
                f"{len(self.events)} events, wall_s={self.wall_s})")
