"""Query-level telemetry: per-operator metrics + structured decision events.

The reference ships real query observability — `PlanAnalyzer.explain` /
`whyNot` tell the user which index rules fired and why
(`PlanAnalyzer.scala:45-360`) — and leans on Spark's per-operator SQL
metrics for its tuning story. This package is the engine's runtime half
of that: ONE `QueryMetrics` recorder is threaded through a query
execution end-to-end and returned to the user, capturing

- the query's span tree (`telemetry/trace.py`): one span record per
  layer boundary — the `query` root, admission, the optimizer's rules,
  physical planning, each physical operator (with its output row
  count; the executor's operator walk, instrumented in
  `engine/physical.py`), fused stages' phases, segment-cache fills,
  link transfers and every wait of the host on the card — each with
  its ids, thread, `time.time_ns()` interval and thread CPU, folded
  per layer into the registry's `trace.*` counters at query finish;
- structured decision events: optimizer rule fired/skipped with reason
  (`plan/rules/*`);
- index usage: which covering index served which scan, bucket counts,
  files scanned vs pruned (`plan/rules/*` + `ScanExec`).

Scoping: the active recorder is a `contextvars.ContextVar`, so
concurrent sessions (or threads) never see each other's metrics. The
serving plane records every `collect`; without a recorder (or tracer)
every operator hook is a single ContextVar read + None check.

Surface: `DataFrame.collect(with_metrics=True)` returns the recorder
next to the result; `session.last_query_metrics()` returns the most
recent one; `to_json()` / `format_tree()` render reports.

Process-wide observability rides in sibling modules re-exported here,
the JAX package's set under its names: `registry` (named counters/
gauges/log-bucketed histograms aggregating across queries and sessions;
Prometheus text dump), `trace` (the span record, the fold, and the
tracer with Chrome trace-event / Perfetto export — `enable_tracing()`
then `export_trace(path)` — and the host<->device link counters),
`memory` (the device-memory accountant and the `cache.<name>.*`
series), `compilation` (the compile and launch seam: library builds as
`compile.*`, device seconds from CUDA events and modeled cost as
`device.*`), `critical_path` (each query's wall
decomposed into a closed segment set), `flight` (the ring of recent
queries and the slow-query dump), `artifact` and `diff` (the canonical
bench artifact and the regression differ), `timeseries`, `alerts`,
`history`, `profiler` (host stack sampling and `torch.profiler`
captures) and `ops_server` (the pull-based HTTP endpoints). The active query's
deadline rides the same contextvar scoping as the recorder
(`deadline_scope`, `check_deadline`).
"""

from __future__ import annotations

import contextvars
import json
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

from hyperspace_tpu_torch.telemetry import trace as _trace_mod
from hyperspace_tpu_torch.telemetry.registry import (MetricsRegistry,
                                                     get_registry)
from hyperspace_tpu_torch.telemetry.trace import (Span, Tracer,
                                                  disable_tracing,
                                                  enable_tracing,
                                                  export_trace,
                                                  link_transfer,
                                                  record_link_transfer, span,
                                                  tracer, tracing_enabled)
from hyperspace_tpu_torch.telemetry import memory  # noqa: F401
from hyperspace_tpu_torch.telemetry import compilation  # noqa: F401
from hyperspace_tpu_torch.telemetry import artifact  # noqa: F401
from hyperspace_tpu_torch.telemetry import diff  # noqa: F401
from hyperspace_tpu_torch.telemetry import flight  # noqa: F401
from hyperspace_tpu_torch.telemetry import timeseries  # noqa: F401
from hyperspace_tpu_torch.telemetry import ops_server  # noqa: F401
from hyperspace_tpu_torch.telemetry import critical_path  # noqa: F401
from hyperspace_tpu_torch.telemetry import profiler  # noqa: F401
from hyperspace_tpu_torch.telemetry.compilation import instrumented_device
from hyperspace_tpu_torch.telemetry.flight import (FlightRecorder,
                                                   get_recorder)
from hyperspace_tpu_torch.telemetry.memory import (DeviceMemoryAccountant,
                                                   get_accountant)

__all__ = [
    "QueryMetrics", "OperatorRecord", "Span", "current", "recording",
    "current_deadline", "deadline_scope", "check_deadline",
    "propagating", "event", "annotate", "add_seconds", "add_count",
    "DEFAULT_TENANT", "current_tenant", "tenant_scope", "charge_tenant",
    "known_tenants", "tenant_digest", "TENANT_CHARGE_COUNTERS",
    "MetricsRegistry", "get_registry", "Tracer", "enable_tracing",
    "disable_tracing", "tracing_enabled", "tracer", "span",
    "link_transfer", "record_link_transfer", "export_trace", "memory",
    "compilation", "instrumented_device", "artifact", "diff", "flight",
    "FlightRecorder", "get_recorder", "timeseries", "ops_server",
    "critical_path", "profiler",
    "DeviceMemoryAccountant", "get_accountant",
]


_current: contextvars.ContextVar[Optional["QueryMetrics"]] = \
    _trace_mod.current_recorder

# The active query's Deadline (`engine/scheduler.Deadline`) rides the
# SAME contextvar scoping as the recorder: set by the scheduler around
# execution, carried across the engine's pool threads by
# `propagating(...)`, read by the cooperative-cancellation checkpoints
# (`check_deadline`) at operator / transfer-chunk / segment-fill /
# sorted-run-write boundaries. The var lives HERE (not in the
# scheduler) because every checkpoint module already imports telemetry
# — the hooks stay one ContextVar read + None check when serving
# features are off, the same always-off contract as the recorder.
_deadline: contextvars.ContextVar = \
    contextvars.ContextVar("hyperspace_query_deadline", default=None)

# The active TENANT identity rides the same contextvar scoping as the
# recorder: set by `tenant_scope`, carried across pool threads by
# `propagating(...)`, read by every chargeback site (the device seam,
# `trace.record_link_transfer`, the segment-cache fills) to mirror
# global counters onto `tenant.<id>.*`. Unset means the DEFAULT tenant —
# charges never go unattributed, so summing `tenant.<id>.*` over all
# tenants (including "default") equals the global counters EXACTLY.
_tenant: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar("hyperspace_query_tenant", default=None)

DEFAULT_TENANT = "default"

# Tenants observed by any chargeback/scope since process start, so the
# report surfaces can enumerate `tenant.<id>.*` families without parsing
# metric names (tenant ids may themselves contain dots). Never pruned.
_known_tenants: set = {DEFAULT_TENANT}
_known_tenants_lock = threading.Lock()

def current() -> Optional["QueryMetrics"]:
    """The recorder of the query executing on this thread, or None."""
    return _current.get()


def current_deadline():
    """The Deadline of the query executing on this thread, or None."""
    return _deadline.get()


@contextmanager
def deadline_scope(deadline):
    """Make `deadline` the active cancellation token for the calling
    context (None is allowed and makes the scope a no-op carrier)."""
    token = _deadline.set(deadline)
    try:
        yield deadline
    finally:
        _deadline.reset(token)


def check_deadline(phase: str) -> None:
    """Cooperative-cancellation checkpoint: raises the active
    deadline's typed error (QueryCancelledError /
    QueryDeadlineExceededError, tagged with `phase`) when the query
    was cancelled or its deadline passed; no-op without an active
    deadline. `phase` names what the raise would interrupt —
    scan/operator/transfer/write — so timeout clusters are
    attributable to a bucket (`telemetry/diff.py`), not `residual`."""
    d = _deadline.get()
    if d is not None:
        d.check(phase)


@contextmanager
def recording(metrics: "QueryMetrics"):
    """Make `metrics` the active recorder for the calling context."""
    token = _current.set(metrics)
    try:
        yield metrics
    finally:
        _current.reset(token)


def current_tenant() -> str:
    """The tenant the calling context charges to — the contextvar if a
    tenant scope is active, else the DEFAULT tenant. Never None:
    chargeback sites must always have someone to bill."""
    return _tenant.get() or DEFAULT_TENANT


def known_tenants() -> List[str]:
    """Sorted ids of every tenant observed since process start."""
    with _known_tenants_lock:
        return sorted(_known_tenants)


def _note_tenant(tenant: str) -> None:
    if tenant not in _known_tenants:  # racy pre-check; set add is safe
        with _known_tenants_lock:
            _known_tenants.add(tenant)


@contextmanager
def tenant_scope(tenant: Optional[str]):
    """Make `tenant` the active billing identity for the calling
    context (None keeps the surrounding scope — a no-op carrier)."""
    if tenant is None:
        yield None
        return
    tenant = str(tenant)
    _note_tenant(tenant)
    token = _tenant.set(tenant)
    try:
        yield tenant
    finally:
        _tenant.reset(token)


# Every counter family the chargeback sites mirror per-tenant. The
# exactness contract: for each name here, the sum of
# `tenant.<id>.<name>` over ALL known tenants equals the global counter
# of the same name.
TENANT_CHARGE_COUNTERS = (
    "device.flops", "device.bytes_accessed", "device.dispatch.seconds",
    "link.h2d.bytes", "link.d2h.bytes", "cache.segments.fills",
)


def tenant_digest() -> Dict[str, Dict[str, float]]:
    """{tenant: {charge counter: value}} for every known tenant, read
    from the registry's `tenant.<id>.*` mirrors. Tenants with zero
    usage are included (the default tenant always appears), so a
    consumer can verify the exactness contract by summing columns.
    Values are the registry's unrounded counters (`series_snapshot`):
    a rounded seconds counter would break the sums it exists to
    check."""
    counters = get_registry().series_snapshot()["counters"]
    out: Dict[str, Dict[str, float]] = {}
    for t in known_tenants():
        out[t] = {name: counters.get(f"tenant.{t}.{name}", 0)
                  for name in TENANT_CHARGE_COUNTERS}
    return out


def charge_tenant(name: str, amount: float = 1.0,
                  tenant: Optional[str] = None) -> str:
    """Mirror a global-counter increment onto the active tenant's
    `tenant.<id>.<name>` series. Call this at the SAME site as the
    global `reg.counter(name).inc(amount)` so per-tenant sums stay
    exactly equal to the global counters. Returns the tenant charged."""
    t = tenant if tenant is not None else current_tenant()
    _note_tenant(t)
    get_registry().counter(f"tenant.{t}.{name}").inc(amount)
    return t


def propagating(fn):
    """Wrap `fn` for execution on another thread (the engine's pools),
    carrying over the active recorder, the caller's position in the
    span tree (the spans the pool thread opens are children of the
    caller's innermost open span) and the active tenant — contextvars
    do not cross thread boundaries on their own. The active Deadline
    rides along too: a cancelled query's pool-side subtree hits the same
    cooperative checkpoints its main thread does."""
    rec = _current.get()
    deadline = _deadline.get()
    tenant = _tenant.get()
    if rec is None and deadline is None and tenant is None:
        return fn
    parent = rec._current_span_id() if rec is not None else None

    def run(*args, **kwargs):
        token = _current.set(rec)
        dtoken = _deadline.set(deadline)
        ttoken = _tenant.set(tenant)
        if rec is not None:
            rec._adopt_parent(parent)
        try:
            return fn(*args, **kwargs)
        finally:
            if rec is not None:
                rec._clear_adoption()
            _tenant.reset(ttoken)
            _deadline.reset(dtoken)
            _current.reset(token)

    return run


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


def _fmt_bytes(n: int) -> str:
    """Human-readable bytes for report rendering (binary units)."""
    value = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if value < 1024 or unit == "TiB":
            return (f"{int(value)}{unit}" if unit == "B"
                    else f"{value:.1f}{unit}")
        value /= 1024
    return f"{n}B"


# A physical operator's record is a span of the `operators` layer (the
# name stays for the callers that hold one).
OperatorRecord = Span

_time_ns = time.time_ns
_thread_time_ns = time.thread_time_ns


class _ThreadSpans:
    """One thread's share of a recorder: its stack of open spans, its
    native id, and the parent its first span adopts (`propagating`)."""

    __slots__ = ("stack", "tid", "adopted")

    def __init__(self):
        self.stack: List[Span] = []
        self.tid = _trace_mod.native_id()
        self.adopted: Optional[int] = None


class QueryMetrics:
    """Everything recorded about ONE query execution. Thread-safe for
    append (operators may execute on pool threads); each thread's stack
    of open spans lives in a threading.local so concurrent subtree
    executions keep their own parent chains."""

    def __init__(self, description: str = "",
                 query_id: Optional[str] = None):
        self.description = description
        self.started_at = time.time()
        self.wall_s: Optional[float] = None
        # Whether this query reads the thread-CPU clock (one in
        # `trace.CPU_SAMPLE_EVERY`).
        self.cpu_sampled = (next(_trace_mod._cpu_tickets)
                            % _trace_mod.CPU_SAMPLE_EVERY == 0)
        # The root span `query` opens with the recorder and closes in
        # `finish()`; every span of the query (operators included) is in
        # `spans`, the physical operators also in `operators`.
        self.root = Span("query", "serving", None, None,
                         _trace_mod.native_id(), self.cpu_sampled)
        self.query_id = query_id or f"query-{self.root.span_id}"
        self.root.query_id = self.query_id
        self.spans: List[Span] = [self.root]
        # The wall is timed on the monotonic clock (`time.time_ns()`
        # only places the spans on the timeline and may step).
        self._wall_t0_ns = time.perf_counter_ns()
        self.operators: List[OperatorRecord] = []
        self.events: List[dict] = []
        self.counters: Dict[str, float] = {}
        # Device-memory watermarks observed while this query ran
        # (`telemetry/memory.py` samples at link transfers).
        self.peak_hbm_bytes = 0
        self.peak_hbm_per_device: Dict[str, int] = {}
        # Serving dimensions, stamped by the scheduler and the batch
        # lane: the routed replica slice (None = unrouted,
        # `parallel/replica.py`), the batched-execution cohort this
        # query rode ({"id", "size", ...}, None = solo) and the tenant
        # billed for the query (None = default tenant / no tenant
        # scope). The flight ring inherits all three.
        self.replica: Optional[int] = None
        self.cohort: Optional[dict] = None
        self.tenant: Optional[str] = None
        # Latency anatomy, stamped at query finish by
        # `telemetry/critical_path.py`: the wall decomposed into the
        # closed segment set, segments summing exactly to wall_s. None
        # until stamped.
        self.critical_path: Optional[dict] = None
        # CUDA event pairs of the device seam (`telemetry/compilation.
        # py`), resolved into `device.dispatch_s` by `finish()`.
        self._device_events: list = []
        self._lock = threading.Lock()
        self._tls = threading.local()

    # -- recorder side (engine hooks) ----------------------------------

    def _thread(self) -> "_ThreadSpans":
        state = getattr(self._tls, "state", None)
        if state is None:
            state = self._tls.state = _ThreadSpans()
        return state

    def _current_span_id(self) -> int:
        """The innermost open span on this thread: the parent of the
        next span it opens (the adopted parent on a pool thread, the
        root when none is open)."""
        state = self._thread()
        if state.stack:
            return state.stack[-1].span_id
        return (state.adopted if state.adopted is not None
                else self.root.span_id)

    def _adopt_parent(self, parent_id: Optional[int]) -> None:
        """Root this worker thread's span chain under `parent_id`
        (see `propagating`)."""
        self._thread().adopted = parent_id

    def _clear_adoption(self) -> None:
        self._thread().adopted = None

    def start_span(self, name: str, layer: str) -> Span:
        """Open a span on this thread, under its innermost open one.
        list.append and the id counter are atomic under the GIL — the
        hot path takes no lock."""
        state = getattr(self._tls, "state", None)
        if state is None:
            state = self._tls.state = _ThreadSpans()
        stack = state.stack
        if stack:
            top = stack[-1]
            sp = Span(name, layer, top.span_id, self.query_id, state.tid,
                      self.cpu_sampled and top.layer != layer)
        else:
            adopted = state.adopted
            sp = Span(name, layer,
                      adopted if adopted is not None else self.root.span_id,
                      self.query_id, state.tid, self.cpu_sampled)
        self.spans.append(sp)
        stack.append(sp)
        return sp

    def finish_span(self, sp: Span, error: Optional[str] = None) -> None:
        sp.end_ns = _time_ns()
        if sp.cpu_start_ns is not None:
            sp.cpu_end_ns = _thread_time_ns()
        if error is not None:
            sp.error = error
        stack = self._tls.state.stack
        if stack and stack[-1] is sp:
            stack.pop()
        else:
            _trace_mod._pop(stack, sp)
        t = _trace_mod._tracer
        if t is not None:
            t.add(sp)

    def span(self, name: str, layer: str, **detail):
        """`start_span` ... `finish_span` around a `with` block."""
        return _trace_mod._SpanScope(name, layer, detail, self)

    def start_operator(self, name: str, node=None,
                       bucketed: bool = False) -> OperatorRecord:
        op = self.start_span(name, "operators")
        op.is_operator = True
        op._node = node
        if bucketed:
            op.bucketed = True
        self.operators.append(op)
        return op

    def finish_operator(self, op: OperatorRecord,
                        rows_out: Optional[int] = None,
                        error: Optional[str] = None) -> None:
        if rows_out is not None:
            op.rows_out = rows_out
        self.finish_span(op, error)

    def _operator_parents(self) -> Dict[int, Optional[int]]:
        """{operator span id: span id of the nearest operator above it,
        None at the operator tree's roots} — the operator tree that
        reports render, whatever spans lie between."""
        by_id = {sp.span_id: sp for sp in self.spans}
        out: Dict[int, Optional[int]] = {}
        for op in self.operators:
            parent = by_id.get(op.parent_id)
            while parent is not None and not parent.is_operator:
                parent = by_id.get(parent.parent_id)
            out[op.span_id] = parent.span_id if parent is not None \
                else None
        return out

    def annotate_current(self, **detail) -> None:
        for sp in reversed(self._thread().stack):
            if sp.is_operator:
                sp.detail.update(detail)
                return

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
        """Close the root span. The query's wall is the monotonic clock's
        from the recorder's start to here; the root's thread CPU is read
        only on the thread that opened it."""
        self.wall_s = (time.perf_counter_ns() - self._wall_t0_ns) / 1e9
        root = self.root
        root.close()
        if _trace_mod.native_id() != root.tid:
            root.cpu_end_ns = root.cpu_start_ns
        t = _trace_mod._tracer
        if t is not None:
            t.add(root)
        for op in self.operators:
            op.label  # resolve now; releases the node references
        if self._device_events:
            from hyperspace_tpu_torch.telemetry import compilation
            compilation.resolve_query(self)
        return self

    @property
    def compile(self) -> dict:
        """This query's build story: how many library builds it caused
        (`traces`), how many loads found the library built
        (`cache_hits`), and the seconds spent building. A repeat query
        must show traces == 0."""
        return {
            "traces": int(self.counters.get("compile.traces", 0)),
            "cache_hits": int(self.counters.get("compile.cache_hits", 0)),
            "seconds": round(
                float(self.counters.get("compile.seconds", 0.0)), 6),
        }

    @property
    def roofline(self) -> dict:
        """This query's device cost story: the modeled flops and bytes
        accessed of its instrumented device calls (each entry point's
        cost function), their measured device seconds (CUDA events on a
        card), the device share of the query's wall (a low share says
        the bottleneck is host orchestration, not the card), and the
        arithmetic intensity that places the work on a roofline plot.
        Only the instrumented entry points are counted; device work
        outside them (plain torch operators) is not in `dispatch_s`."""
        flops = float(self.counters.get("device.flops", 0.0))
        nbytes = float(self.counters.get("device.bytes_accessed", 0.0))
        disp = float(self.counters.get("device.dispatch_s", 0.0))
        wall = self.wall_s
        return {
            "flops": round(flops, 1),
            "bytes_accessed": round(nbytes, 1),
            "dispatch_s": round(disp, 6),
            "device_share": (round(min(disp / wall, 1.0), 4)
                             if wall else None),
            "intensity_flops_per_byte": (round(flops / nbytes, 4)
                                         if nbytes else None),
            "achieved_flops_per_s": (round(flops / disp, 1)
                                     if disp > 0 else None),
        }

    # -- user side (reports) -------------------------------------------

    def events_of(self, category: str, name: Optional[str] = None
                  ) -> List[dict]:
        return [e for e in self.events
                if e["category"] == category
                and (name is None or e["name"] == name)]

    def rows_in(self, op: OperatorRecord) -> Optional[int]:
        """Sum of the operator's direct children's output rows (None when
        no child reported rows — e.g. a leaf scan)."""
        parents = self._operator_parents()
        rows = [c.rows_out for c in self.operators
                if parents.get(c.span_id) == op.span_id
                and c.rows_out is not None]
        return sum(rows) if rows else None

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
        parents = self._operator_parents()
        out = {
            "description": self.description,
            "started_at": self.started_at,
            "wall_s": (round(self.wall_s, 6)
                       if self.wall_s is not None else None),
            "operators": [op.to_dict(parents[op.span_id])
                          for op in self.operators],
            "events": list(self.events),
            "counters": {k: (round(v, 6) if isinstance(v, float) else v)
                         for k, v in self.counters.items()},
            "index_usage": self.index_usage(),
            "peak_hbm_bytes": self.peak_hbm_bytes,
            "peak_hbm_per_device": dict(self.peak_hbm_per_device),
            "compile": self.compile,
            "roofline": self.roofline,
        }
        if self.replica is not None:
            out["replica"] = self.replica
        if self.cohort is not None:
            out["cohort"] = dict(self.cohort)
        if self.tenant is not None:
            out["tenant"] = self.tenant
        if self.critical_path is not None:
            out["critical_path"] = dict(self.critical_path)
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
        parents = self._operator_parents()
        child_s: Dict[Optional[int], float] = {}
        for op in self.operators:
            parent = parents[op.span_id]
            child_s[parent] = child_s.get(parent, 0.0) + op.wall_s
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
        lanes: Dict[str, int] = {}
        for e in self.events_of("fusion", "lane"):
            lanes[e.get("lane", "?")] = lanes.get(e.get("lane", "?"), 0) + 1
        rules: Dict[str, int] = {}
        for e in self.events_of("rule"):
            key = f"{e['name']}:{e.get('action', '?')}"
            rules[key] = rules.get(key, 0) + 1
        out = {
            "wall_s": (round(self.wall_s, 4)
                       if self.wall_s is not None else None),
            "operators": per_op,
            "fusion_lanes": lanes,
            "rules": rules,
            "counters": {k: (round(v, 4) if isinstance(v, float) else v)
                         for k, v in self.counters.items()},
            "index_usage": self.index_usage(),
            "peak_hbm_bytes": self.peak_hbm_bytes,
            "compile": self.compile,
            "roofline": self.roofline,
        }
        if self.tenant is not None:
            out["tenant"] = self.tenant
        if self.critical_path is not None:
            out["critical_path"] = dict(self.critical_path)
        return out

    def format_tree(self) -> str:
        """Operator tree with runtime numbers."""
        parents = self._operator_parents()
        children: Dict[Optional[int], List[OperatorRecord]] = {}
        for op in self.operators:
            children.setdefault(parents[op.span_id], []).append(op)
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
        if self.peak_hbm_bytes:
            per_dev = ", ".join(
                f"{dev}={_fmt_bytes(b)}"
                for dev, b in sorted(self.peak_hbm_per_device.items()))
            lines.append(f"Peak HBM: {_fmt_bytes(self.peak_hbm_bytes)}"
                         + (f" ({per_dev})" if per_dev else ""))
        comp = self.compile
        if comp["traces"] or comp["cache_hits"]:
            lines.append(f"Compile: {comp['traces']} traces, "
                         f"{comp['cache_hits']} cache hits, "
                         f"{comp['seconds']:.4f}s")
        roof = self.roofline
        if roof["flops"] or roof["dispatch_s"]:
            bits = [f"{roof['flops']:.0f} flops",
                    f"{roof['bytes_accessed']:.0f} B accessed",
                    f"{roof['dispatch_s']:.4f}s dispatch"]
            if roof["device_share"] is not None:
                bits.append(f"device share {roof['device_share']:.1%}")
            if roof["intensity_flops_per_byte"] is not None:
                bits.append(
                    f"{roof['intensity_flops_per_byte']:.2f} flops/B")
            lines.append("Device: " + ", ".join(bits))
        return "\n".join(lines)

    def __repr__(self) -> str:
        return (f"QueryMetrics({len(self.operators)} operators, "
                f"{len(self.events)} events, wall_s={self.wall_s})")
