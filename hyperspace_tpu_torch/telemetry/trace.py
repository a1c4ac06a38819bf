"""Span tracer with Chrome trace-event / Perfetto JSON export.

Where the registry (`telemetry/registry.py`) aggregates, the tracer
keeps a TIMELINE: complete-event spans for physical operators and
index-maintenance action phases, each stamped with the REAL thread it ran
on.

Off by default: every hook starts with one module-global read + None
check (`tracer()`), the same always-off discipline as the query
recorder. `enable_tracing()` installs a bounded ring (old events drop,
never the process); `export_trace(path)` writes the standard
`{"traceEvents": [...]}` JSON object that chrome://tracing and
https://ui.perfetto.dev load directly.

Timestamps are microseconds on the tracer's own perf_counter clock —
the Chrome format needs only internal consistency, and perf_counter is
the engine's timing base everywhere else.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

from hyperspace_tpu_torch.telemetry import registry as _registry

__all__ = ["Tracer", "enable_tracing", "disable_tracing",
           "tracing_enabled", "tracer", "span", "link_transfer",
           "record_link_transfer", "export_trace", "PID_ENGINE",
           "PID_MESH"]

# Trace "processes": real engine threads vs the synthetic per-shard
# tracks (tid = shard ordinal) that mesh dispatches attribute work to.
PID_ENGINE = 1
PID_MESH = 2

_tracer: Optional["Tracer"] = None


class Tracer:
    def __init__(self, capacity: int = 200_000):
        self.capacity = capacity
        self.events: deque = deque(maxlen=capacity)
        self.emitted = 0
        self.t0_s = time.perf_counter()
        self.started_at = time.time()
        self._lock = threading.Lock()
        self._thread_names: Dict[int, str] = {}
        self._device_tracks: set = set()

    def now_us(self) -> float:
        return (time.perf_counter() - self.t0_s) * 1e6

    def complete(self, name: str, cat: str, ts_us: float, dur_us: float,
                 tid: Optional[int] = None, pid: int = PID_ENGINE,
                 args: Optional[dict] = None) -> None:
        """One Chrome "X" (complete) event. Same-thread spans nest by
        ts/dur containment — no explicit parent links needed."""
        if tid is None:
            tid = threading.get_ident()
            if tid not in self._thread_names:
                self._thread_names[tid] = threading.current_thread().name
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": round(ts_us, 1), "dur": round(max(dur_us, 0.0), 1),
              "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        with self._lock:
            self.events.append(ev)
            self.emitted += 1

    def counter(self, name: str, values: Dict[str, float],
                pid: int = PID_ENGINE) -> None:
        """One Chrome "C" (counter) event: a value track in Perfetto
        (the memory accountant's per-device bytes-in-use)."""
        ev = {"name": name, "ph": "C", "ts": round(self.now_us(), 1),
              "pid": pid, "tid": 0, "args": dict(values)}
        with self._lock:
            self.events.append(ev)
            self.emitted += 1

    def device_spans(self, name: str, ts_us: float, rows_per_device,
                     cat: str = "mesh", **common) -> None:
        """One span per mesh shard on the synthetic mesh process, from
        `ts_us` to now. Every shard gets the dispatch's wall window (one
        controller drives them all); the per-shard ROW attribution in
        the span args is what exposes skew."""
        dur = self.now_us() - ts_us
        for d, rows in enumerate(rows_per_device):
            self._device_tracks.add(d)
            args = {"device": d, "rows": int(rows)}
            args.update(common)
            self.complete(f"{name} [dev{d}]", cat, ts_us, dur,
                          tid=d, pid=PID_MESH, args=args)

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
        with self._lock:
            events = list(self.events)
            emitted = self.emitted
        doc = {
            "traceEvents": self._metadata_events() + events,
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "hyperspace_tpu_torch.telemetry",
                "started_at": self.started_at,
                "events": len(events),
                "dropped": max(emitted - len(events), 0),
            },
        }
        from hyperspace_tpu_torch.utils import file_utils
        file_utils.create_file(path, json.dumps(doc, default=str))
        return {"path": path, "events": len(events),
                "dropped": max(emitted - len(events), 0)}


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


@contextmanager
def span(name: str, cat: str = "engine", **args):
    """Trace the enclosed block as a complete event on this thread.
    No-op (one global read) without an active tracer."""
    t = _tracer
    if t is None:
        yield
        return
    ts = t.now_us()
    try:
        yield
    finally:
        t.complete(name, cat, ts, t.now_us() - ts, args=args or None)


def record_link_transfer(direction: str, nbytes: int, seconds: float,
                         ts_us: Optional[float] = None,
                         chunks: int = 1) -> None:
    """Record one host<->device transfer (`direction` = "h2d" | "d2h"):
    registry counters + log-bucketed byte/seconds histograms ALWAYS, a
    per-query counter when a recorder is active, a span when tracing.
    `chunks` is how many pipelined chunk copies the logical transfer
    shipped as (`io/transfer.py`) — `link.<dir>.chunks` vs
    `link.<dir>.transfers` is the chunking ratio. CUDA copies are
    asynchronous — the measured wall is issue-side unless the measuring
    code synchronized; the byte counts are exact either way."""
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
    t = _tracer
    if t is not None:
        end = t.now_us()
        start = end - seconds * 1e6 if ts_us is None else ts_us
        t.complete(f"{direction} {int(nbytes):,}B", "link", start,
                   end - start,
                   args={"bytes": int(nbytes), "direction": direction})
    # Every instrumented transfer moves device residency: fold a memory
    # sample (throttled; no-op unless a recorder or tracer is active).
    from hyperspace_tpu_torch.telemetry import memory as _memory
    _memory.maybe_sample()


@contextmanager
def link_transfer(direction: str, nbytes: int, chunks: int = 1):
    """Context-manager form of `record_link_transfer`: times the
    enclosed block as the transfer wall."""
    t = _tracer
    ts = t.now_us() if t is not None else None
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record_link_transfer(direction, nbytes,
                             time.perf_counter() - t0, ts_us=ts,
                             chunks=chunks)


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
