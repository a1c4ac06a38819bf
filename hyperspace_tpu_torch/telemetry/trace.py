"""The program's one span system: the span record, the fold of a
query's span tree into per-layer counters, and the tracer — a ring of
span records with Chrome trace-event / Perfetto JSON export.

Every span the port emits is a `Span`: name and layer, `span_id` and
`parent_id`, the query's id (None outside a query), the OS thread id
(`threading.get_native_id()`, the id `torch.profiler` writes as `tid`),
start and end in ns on `time.time_ns()` and, on one query in
`CPU_SAMPLE_EVERY`, the thread's CPU ns at both ends
(`time.thread_time_ns()`). One host clock for every span lets a
capture that ties `time.time_ns()` to the profiler's clock
(`telemetry/profiler.device_trace`) place each span above the kernels
it issued.

`span(name, layer)` is the one span API. Inside a query the span lives
on its recorder (`telemetry.QueryMetrics`), which keeps each thread's
stack of open spans; outside one it exists only while tracing is on and
nests on a per-thread stack here; with neither it is a detached record
that only its caller reads (`sp.wall_s`). Closed spans also go to the
tracer's ring when tracing is on.

`fold(metrics)` runs once per finished query (the scheduler calls it):
each span's SELF time (its interval minus the union of its children's
intervals, on any thread) and self thread-CPU (its own CPU minus that of
its children on the same thread) summed per layer into the registry
counters `trace.<layer>.wall_s`, `trace.<layer>.cpu_s` and
`trace.<layer>.spans`, with `trace.queries`, `trace.query.wall_s` (the
query's wall, on the monotonic clock) and `trace.query.thread_cpu_s`
(the root thread's CPU over the root span) beside them. On a query whose
spans run on one thread the self walls sum to the root's wall; children
that overlap on pool threads make the sum exceed it by their overlap.
The CPU counters sum the queries that read the CPU clock, counted with
their wall in `trace.query.cpu_sampled` and
`trace.query.cpu_sampled_wall_s`.

The tracer keeps a TIMELINE where the registry (`telemetry/registry.py`)
aggregates. It has no clock of its own. Off by default: every hook
starts with one module-global read + None check (`tracer()`).
`enable_tracing()` installs a bounded ring (old records drop, never the
process); `export_trace(path)` writes the standard `{"traceEvents":
[...]}` JSON object that chrome://tracing and https://ui.perfetto.dev
load directly, with `ts` in µs on `time.time_ns()` and each span's
`span_id`, `parent_id` and `query_id` in its `args`.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from hyperspace_tpu_torch.telemetry import registry as _registry

__all__ = ["Span", "LAYERS", "Tracer", "enable_tracing",
           "disable_tracing", "tracing_enabled", "tracer", "span",
           "link_transfer", "record_link_transfer", "export_trace",
           "self_times", "layer_totals", "fold", "PID_ENGINE", "PID_MESH"]

_tracer: Optional["Tracer"] = None

# The layer keys of the spans a query emits, from the entry point down
# (`trace.<layer>.*`). `telemetry` is timed by the scheduler after the
# recorder has finished (its bookkeeping and this fold).
LAYERS = ("serving", "rules", "plan", "operators", "segcache", "link",
          "device_wait", "telemetry")

# Trace "processes": real engine threads vs the synthetic per-shard
# tracks (tid = shard ordinal) that mesh dispatches attribute work to.
PID_ENGINE = 1
PID_MESH = 2

# The recorder of the query running in this context (`telemetry.
# current()`), here so that every span hook reads it without importing
# the package.
current_recorder: contextvars.ContextVar = contextvars.ContextVar(
    "hyperspace_query_metrics", default=None)

# Span ids are process-wide, so a trace holding many queries' spans
# never repeats one. `next()` on a count is atomic under the GIL.
_ids = itertools.count(1)

# One query in CPU_SAMPLE_EVERY reads the thread-CPU clock at its spans'
# layer changes; the others read no CPU clock. Where that clock is a
# system call (the sandboxed H100 machines of the benchmark), reading it
# at every layer change of every query cost 7-9 % of the throughput of
# two TPC-H query streams.
CPU_SAMPLE_EVERY = 16
_cpu_tickets = itertools.count()


_time_ns = time.time_ns
_thread_time_ns = time.thread_time_ns
_native = threading.local()


def native_id() -> int:
    """This thread's OS id (`threading.get_native_id()`, the `tid` the
    profiler writes), read once a thread: it is a system call."""
    try:
        return _native.tid
    except AttributeError:
        tid = _native.tid = threading.get_native_id()
        return tid


class Span:
    """One timed interval of the program. Physical operators add
    `rows_out` and a lazily resolved display `label` (their node's
    `simple_string()`, resolved at query finish or first report so the
    execute hot path stays at the clock reads plus two appends). The
    fields most spans never set are class defaults, held per instance
    only once set.

    The thread-CPU stamps are read on a query that samples the CPU
    clock, where the fold needs them: on a span whose layer differs from
    that of its parent on the same thread, and on every span without
    such a parent. A span nested in one of its own layer on its own
    thread leaves them None: its CPU stays in its parent's, which is the
    same layer's, so every layer's CPU is exact at fewer reads of a
    clock that is a system call."""

    __slots__ = ("span_id", "parent_id", "query_id", "name", "layer",
                 "tid", "start_ns", "end_ns", "cpu_start_ns", "cpu_end_ns",
                 "__dict__")

    pid = PID_ENGINE
    rows_out: Optional[int] = None
    error: Optional[str] = None
    bucketed = False
    is_operator = False
    _node = None
    _label: Optional[str] = None

    def __init__(self, name: str, layer: str, parent_id: Optional[int],
                 query_id: Optional[str], tid: int, cpu: bool = True):
        self.span_id = next(_ids)
        self.parent_id = parent_id
        self.query_id = query_id
        self.name = name
        self.layer = layer
        self.tid = tid
        self.end_ns = self.cpu_end_ns = None
        self.cpu_start_ns = _thread_time_ns() if cpu else None
        self.start_ns = _time_ns()

    def close(self, error: Optional[str] = None) -> None:
        self.end_ns = _time_ns()
        if self.cpu_start_ns is not None:
            self.cpu_end_ns = _thread_time_ns()
        if error is not None:
            self.error = error

    @property
    def detail(self) -> Dict:
        """Free-form facts about the span (exported as its `args`)."""
        d = self.__dict__.get("detail")
        if d is None:
            d = self.__dict__["detail"] = {}
        return d

    @property
    def op_id(self) -> int:
        return self.span_id

    @property
    def wall_s(self) -> float:
        if self.end_ns is None:
            return 0.0
        return (self.end_ns - self.start_ns) / 1e9

    @wall_s.setter
    def wall_s(self, seconds: float) -> None:
        """Re-time a closed span (a report built by hand)."""
        self.end_ns = self.start_ns + round(seconds * 1e9)

    @property
    def cpu_ns(self) -> int:
        """The thread's CPU over the span; 0 where it was not read."""
        if self.cpu_end_ns is None or self.cpu_start_ns is None:
            return 0
        return self.cpu_end_ns - self.cpu_start_ns

    @property
    def cpu_s(self) -> float:
        return self.cpu_ns / 1e9

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

    def to_dict(self, parent_id: Optional[int] = None) -> dict:
        """The operator form `QueryMetrics.to_dict()` reports (`op_id`,
        `parent_id` of the nearest operator above)."""
        d = {"op_id": self.span_id, "parent_id": parent_id,
             "name": self.name, "label": self.label,
             "wall_s": round(self.wall_s, 6), "rows_out": self.rows_out}
        if self.bucketed:
            d["bucketed"] = True
        detail = self.__dict__.get("detail")
        if detail:
            d["detail"] = dict(detail)
        if self.error is not None:
            d["error"] = self.error
        return d

    def to_event(self, end_ns: Optional[int] = None,
                 offset_us: float = 0.0, pid=None) -> dict:
        """One Chrome "X" (complete) event: `ts`/`dur` in µs on
        `time.time_ns()` (plus `offset_us`, to move it onto another
        clock); an open span ends at `end_ns`."""
        end = self.end_ns if self.end_ns is not None else end_ns
        args = {"span_id": self.span_id, "parent_id": self.parent_id,
                "query_id": self.query_id}
        if self.cpu_end_ns is not None:
            args["cpu_us"] = self.cpu_ns / 1e3
        if self.rows_out is not None:
            args["rows"] = self.rows_out
        detail = self.__dict__.get("detail")
        if detail:
            args.update(detail)
        if self.error is not None:
            args["error"] = self.error
        return {"name": self.name, "cat": self.layer, "ph": "X",
                "ts": self.start_ns / 1e3 + offset_us,
                "dur": max((end or self.start_ns) - self.start_ns, 0) / 1e3,
                "pid": self.pid if pid is None else pid, "tid": self.tid,
                "args": args}


# -- spans outside a query: tracer only ------------------------------------

_tls = threading.local()


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def open_span(name: str, layer: str) -> Span:
    """A span outside any query (index builds, actions), nested under
    this thread's innermost open one. The caller checks that tracing is
    on; `close_span` hands it to the ring."""
    stack = _stack()
    sp = Span(name, layer, stack[-1].span_id if stack else None, None,
              native_id())
    stack.append(sp)
    return sp


def close_span(sp: Span, error: Optional[str] = None) -> None:
    sp.close(error)
    _pop(_stack(), sp)
    t = _tracer
    if t is not None:
        t.add(sp)


def _pop(stack: list, sp: Span) -> None:
    if stack and stack[-1] is sp:
        stack.pop()
        return
    # Unbalanced (an exception skipped a frame): resync.
    while stack and stack[-1] is not sp:
        stack.pop()
    if stack:
        stack.pop()


# -- self time and the fold ------------------------------------------------

def _union_ns(intervals: List[Tuple[int, int]]) -> int:
    total = 0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def self_times(spans: List[Span]) -> Dict[int, Tuple[int, int]]:
    """{span_id: (self wall ns, self thread-CPU ns)} of every closed
    span: its interval minus the union of its children's intervals
    (clipped to it, children on any thread), and its thread's CPU minus
    the CPU of its children on the same thread. Children that all ran on
    one thread cannot overlap, so their clipped walls are summed; the
    union is taken only over children of several threads."""
    by_id = {sp.span_id: sp for sp in spans}
    # parent id -> [clipped child wall, same-thread child CPU,
    #               clipped intervals, first child's tid, several tids]
    kids: Dict[int, list] = {}
    for sp in spans:
        end = sp.end_ns
        p = by_id.get(sp.parent_id)
        if end is None or p is None or p.end_ns is None:
            continue
        s0 = sp.start_ns if sp.start_ns > p.start_ns else p.start_ns
        e0 = end if end < p.end_ns else p.end_ns
        acc = kids.get(p.span_id)
        if acc is None:
            acc = kids[p.span_id] = [0, 0, [], sp.tid, False]
        elif sp.tid != acc[3]:
            acc[4] = True
        if e0 > s0:
            acc[0] += e0 - s0
            acc[2].append((s0, e0))
        if sp.tid == p.tid:
            acc[1] += sp.cpu_ns
    out: Dict[int, Tuple[int, int]] = {}
    for sp in spans:
        if sp.end_ns is None:
            continue
        wall = sp.end_ns - sp.start_ns
        cpu = sp.cpu_ns
        acc = kids.get(sp.span_id)
        if acc is not None:
            wall -= _union_ns(acc[2]) if acc[4] else acc[0]
            cpu -= acc[1]
        out[sp.span_id] = (wall, cpu)
    return out


def layer_totals(spans: List[Span]) -> Dict[str, List[float]]:
    """{layer: [self wall s, self CPU s, spans]} over a query's spans."""
    totals: Dict[str, list] = {}
    times = self_times(spans)
    for sp in spans:
        st = times.get(sp.span_id)
        if st is None:
            continue
        t = totals.get(sp.layer)
        if t is None:
            t = totals[sp.layer] = [0, 0, 0]
        t[0] += st[0]
        t[1] += st[1]
        t[2] += 1
    for t in totals.values():
        t[0] /= 1e9
        t[1] /= 1e9
    return totals


def _names(layer: str) -> Tuple[str, str, str]:
    names = _COUNTER_NAMES.get(layer)
    if names is None:
        names = _COUNTER_NAMES[layer] = (f"trace.{layer}.wall_s",
                                         f"trace.{layer}.cpu_s",
                                         f"trace.{layer}.spans")
    return names


_COUNTER_NAMES: Dict[str, Tuple[str, str, str]] = {}


def fold(metrics, registry=None) -> Dict[str, List[float]]:
    """Fold one finished query's span tree into the registry's
    `trace.*` counters (module docstring). Returns the per-layer
    totals it added."""
    reg = registry if registry is not None else _registry.get_registry()
    totals = layer_totals(metrics.spans)
    for layer, (wall, cpu, n) in totals.items():
        wall_name, cpu_name, spans_name = _names(layer)
        reg.counter(wall_name).inc(wall)
        reg.counter(cpu_name).inc(cpu)
        reg.counter(spans_name).inc(n)
    reg.counter("trace.queries").inc()
    reg.counter("trace.query.wall_s").inc(metrics.wall_s)
    if metrics.cpu_sampled:
        reg.counter("trace.query.cpu_sampled").inc()
        reg.counter("trace.query.cpu_sampled_wall_s").inc(metrics.wall_s)
        reg.counter("trace.query.thread_cpu_s").inc(metrics.root.cpu_s)
    return totals


def add_layer_time(layer: str, wall_ns: int, cpu_ns: int,
                   registry=None) -> None:
    """Time spent outside any recorder but charged to a layer (the
    scheduler's bookkeeping after a query's recorder finished)."""
    reg = registry if registry is not None else _registry.get_registry()
    wall_name, cpu_name, spans_name = _names(layer)
    reg.counter(wall_name).inc(wall_ns / 1e9)
    reg.counter(cpu_name).inc(cpu_ns / 1e9)
    reg.counter(spans_name).inc()


class Tracer:
    def __init__(self, capacity: int = 200_000):
        self.capacity = capacity
        # Span records, and the dict events (counters) that are not
        # spans, in arrival order.
        self.records: deque = deque(maxlen=capacity)
        self.emitted = 0
        self.started_at = time.time()
        self._lock = threading.Lock()
        self._thread_names: Dict[int, str] = {}
        self._device_tracks: set = set()

    def add(self, sp: Span) -> None:
        """One closed span record."""
        if sp.pid == PID_ENGINE and sp.tid not in self._thread_names:
            self._thread_names[sp.tid] = threading.current_thread().name
        with self._lock:
            self.records.append(sp)
            self.emitted += 1

    def complete(self, name: str, layer: str, start_ns: int, end_ns: int,
                 tid: Optional[int] = None, pid: int = PID_ENGINE,
                 args: Optional[dict] = None) -> Span:
        """A span timed by its caller (a build, a shard's share of a
        dispatch), parented like a span opened here now."""
        rec = current_recorder.get()
        if rec is not None:
            parent, query_id = rec._current_span_id(), rec.query_id
        else:
            stack = _stack()
            parent = stack[-1].span_id if stack else None
            query_id = None
        sp = Span(name, layer, parent, query_id,
                  tid if tid is not None else native_id(), cpu=False)
        sp.start_ns, sp.end_ns = start_ns, end_ns
        sp.pid = pid
        if args:
            sp.detail.update(args)
        self.add(sp)
        return sp

    def counter(self, name: str, values: Dict[str, float],
                pid: int = PID_ENGINE) -> None:
        """One Chrome "C" (counter) event: a value track in Perfetto
        (the memory accountant's per-device bytes-in-use)."""
        ev = {"name": name, "ph": "C", "ts": time.time_ns() / 1e3,
              "pid": pid, "tid": 0, "args": dict(values)}
        with self._lock:
            self.records.append(ev)
            self.emitted += 1

    def device_spans(self, name: str, start_ns: int, rows_per_device,
                     cat: str = "mesh", **common) -> None:
        """One span per mesh shard on the synthetic mesh process, from
        `start_ns` to now. Every shard gets the dispatch's wall window
        (one controller drives them all); the per-shard ROW attribution
        in the span args is what exposes skew."""
        end_ns = time.time_ns()
        for d, rows in enumerate(rows_per_device):
            self._device_tracks.add(d)
            args = {"device": d, "rows": int(rows)}
            args.update(common)
            self.complete(f"{name} [dev{d}]", cat, start_ns, end_ns,
                          tid=d, pid=PID_MESH, args=args)

    def spans(self) -> List[Span]:
        with self._lock:
            return [r for r in self.records if isinstance(r, Span)]

    @property
    def events(self) -> List[dict]:
        """The ring as Chrome trace events (span records converted)."""
        with self._lock:
            records = list(self.records)
        return [r.to_event() if isinstance(r, Span) else r
                for r in records]

    def _metadata_events(self) -> List[dict]:
        out = [
            {"name": "process_name", "ph": "M", "ts": 0,
             "pid": PID_ENGINE, "tid": 0,
             "args": {"name": "hyperspace-engine"}},
        ]
        for tid, tname in sorted(self._thread_names.items()):
            out.append({"name": "thread_name", "ph": "M", "ts": 0,
                        "pid": PID_ENGINE, "tid": tid,
                        "args": {"name": tname}})
        if self._device_tracks:
            out.append({"name": "process_name", "ph": "M", "ts": 0,
                        "pid": PID_MESH, "tid": 0,
                        "args": {"name": "hyperspace-mesh"}})
            for d in sorted(self._device_tracks):
                out.append({"name": "thread_name", "ph": "M", "ts": 0,
                            "pid": PID_MESH, "tid": d,
                            "args": {"name": f"device {d}"}})
        return out

    def export(self, path: str) -> dict:
        events = self.events
        dropped = max(self.emitted - len(events), 0)
        doc = {
            "traceEvents": self._metadata_events() + events,
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "hyperspace_tpu_torch.telemetry",
                "clock": "time.time_ns",
                "started_at": self.started_at,
                "events": len(events),
                "dropped": dropped,
            },
        }
        from hyperspace_tpu_torch.utils import file_utils
        file_utils.create_file(path, json.dumps(doc, default=str))
        return {"path": path, "events": len(events), "dropped": dropped}


def enable_tracing(capacity: int = 200_000) -> Tracer:
    """Install (or keep) the process tracer. Idempotent: an already
    running tracer is reused so concurrent enablers don't drop each
    other's spans."""
    global _tracer
    if _tracer is None:
        _tracer = Tracer(capacity)
    return _tracer


def disable_tracing() -> None:
    global _tracer
    _tracer = None


def tracing_enabled() -> bool:
    return _tracer is not None


def tracer() -> Optional[Tracer]:
    """The active tracer, or None — THE always-off check every hook
    makes first."""
    return _tracer


class _SpanScope:
    """The `with` form of a span: on `rec` (the active query's recorder
    unless given), in the tracer's ring outside a query while tracing is
    on, else a detached record that only its caller reads. `__enter__`
    returns the record."""

    __slots__ = ("name", "layer", "detail", "rec", "sp")

    def __init__(self, name: str, layer: str, detail: dict, rec=None):
        self.name = name
        self.layer = layer
        self.detail = detail
        self.rec = rec

    def __enter__(self) -> Span:
        rec = self.rec
        if rec is None:
            rec = current_recorder.get()
        if rec is not None:
            sp = rec.start_span(self.name, self.layer)
        elif _tracer is not None:
            sp = open_span(self.name, self.layer)
            rec = _RING
        else:
            sp = Span(self.name, self.layer, None, None, native_id(),
                      cpu=False)
        if self.detail:
            sp.detail.update(self.detail)
        self.rec, self.sp = rec, sp
        return sp

    def __exit__(self, exc_type, exc, tb) -> bool:
        error = repr(exc) if exc is not None else None
        rec = self.rec
        if rec is _RING:
            close_span(self.sp, error)
        elif rec is not None:
            rec.finish_span(self.sp, error)
        else:
            self.sp.close(error)
        return False


# `_SpanScope.rec` of a span opened in the tracer's ring.
_RING = object()


def span(name: str, layer: str = "engine", **detail) -> _SpanScope:
    """Time the enclosed block as one span on this thread and yield its
    record: on the active query's recorder, in the tracer's ring outside
    a query while tracing is on, else a detached record that only its
    caller reads (`with span(...) as sp: ...; sp.wall_s`)."""
    return _SpanScope(name, layer, detail)


def record_link_transfer(direction: str, nbytes: int, seconds: float,
                         chunks: int = 1) -> None:
    """Count one host<->device transfer (`direction` = "h2d" | "d2h"):
    registry counters + log-bucketed byte/seconds histograms ALWAYS and
    a per-query counter when a recorder is active. Its span is
    `link_transfer`'s. `chunks` is how many pipelined chunk copies the
    logical transfer shipped as (`io/transfer.py`) —
    `link.<dir>.chunks` vs `link.<dir>.transfers` is the chunking ratio.
    CUDA copies are asynchronous — the measured wall is issue-side
    unless the measuring code synchronized; the byte counts are exact
    either way."""
    reg = _registry.get_registry()
    reg.counter(f"link.{direction}.bytes").inc(nbytes)
    reg.counter(f"link.{direction}.seconds").inc(seconds)
    reg.counter(f"link.{direction}.transfers").inc()
    reg.counter(f"link.{direction}.chunks").inc(max(int(chunks), 1))
    reg.histogram(f"link.{direction}.bytes_per_transfer").observe(nbytes)
    from hyperspace_tpu_torch import telemetry
    # Tenant chargeback at the ONE link seam: mirroring the global inc
    # here keeps per-tenant link-byte sums exactly equal to the global
    # `link.<dir>.bytes` counters.
    telemetry.charge_tenant(f"link.{direction}.bytes", nbytes)
    telemetry.add_seconds(f"link.{direction}_s", seconds)
    telemetry.add_count(f"link.{direction}_bytes", int(nbytes))
    # Every instrumented transfer moves device residency: fold a memory
    # sample (throttled; no-op unless a recorder or tracer is active).
    from hyperspace_tpu_torch.telemetry import memory as _memory
    _memory.maybe_sample()


@contextmanager
def link_transfer(direction: str, nbytes: int = 0, chunks: int = 1):
    """Time the enclosed block as one transfer: a `link` span named by
    the direction, then `record_link_transfer` with the span's wall.
    Yields a dict whose "bytes" and "chunks" the block may fill in once
    it knows them; "bytes" set to None records nothing. A transfer that
    raises is not counted."""
    link = {"bytes": nbytes, "chunks": chunks}
    with span(direction, "link") as sp:
        yield link
        if link["bytes"] is not None:
            sp.detail["bytes"] = int(link["bytes"])
    if link["bytes"] is not None:
        record_link_transfer(direction, int(link["bytes"]), sp.wall_s,
                             chunks=link["chunks"])


def export_trace(path: str) -> dict:
    """Write the collected spans as Chrome trace-event JSON at `path`
    (loadable in chrome://tracing and ui.perfetto.dev). Returns
    {path, events, dropped}. Raises if tracing was never enabled —
    silently exporting an empty timeline would mask a missing
    `enable_tracing()` call."""
    t = _tracer
    if t is None:
        from hyperspace_tpu_torch.exceptions import HyperspaceException
        raise HyperspaceException(
            "Tracing is not enabled; call telemetry.enable_tracing() "
            "before the work you want captured.")
    return t.export(path)


def merge_into_capture(path: str, mark: str, mark_ns: int, start_ns: int,
                       end_ns: int, extra: List[Span] = ()) -> int:
    """Write the program's spans that overlap [start_ns, end_ns] into the
    `torch.profiler` Chrome trace at `path`: the ring's closed spans and
    `extra` (the capturing query's own spans, open ones ending at
    `end_ns`), each on the process id and the native thread id the
    profiler gives that thread's own events. The trace's last `mark`
    event, inside which `time.time_ns()` read `mark_ns`, gives the shift
    onto the profiler's clock: its middle is taken for that read. Returns
    the number of spans written (none when the trace lacks the mark)."""
    seen = set()
    chosen: List[Span] = []
    t = _tracer
    pool = (t.spans() if t is not None else []) + list(extra)
    for sp in pool:
        if sp.pid != PID_ENGINE or sp.span_id in seen:
            continue
        end = sp.end_ns if sp.end_ns is not None else end_ns
        if end < start_ns or sp.start_ns > end_ns:
            continue
        seen.add(sp.span_id)
        chosen.append(sp)
    if not chosen:
        return 0
    with open(path) as f:
        doc = json.load(f)
    events = doc.setdefault("traceEvents", [])
    marks = [ev for ev in events
             if ev.get("name") == mark and ev.get("ph") == "X"]
    if not marks:
        return 0
    last = max(marks, key=lambda ev: float(ev["ts"]))
    offset_us = (float(last["ts"]) + float(last.get("dur", 0)) / 2
                 - mark_ns / 1e3)
    pid = os.getpid()
    events.extend(sp.to_event(end_ns, offset_us, pid=pid)
                  for sp in sorted(chosen, key=lambda s: s.start_ns))
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, default=str)
    os.replace(tmp, path)
    return len(chosen)
