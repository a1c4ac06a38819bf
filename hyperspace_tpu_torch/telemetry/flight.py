"""Query flight recorder: the last-K completed queries, always on,
plus a slow-query dump for post-hoc diagnosis.

The per-query recorder (`telemetry/__init__.py`) captures everything
about one execution, but it evaporates with the Python object unless
the caller thought to keep it. Production
diagnosis works the other way round: the interesting query has ALREADY
finished by the time anyone asks. So the engine keeps a bounded ring
of the last `CAPACITY` completed `QueryMetrics` (every session-attached
collect appends; one deque append + threshold check per query), and
any query whose wall exceeds `spark.hyperspace.telemetry.slowlog.seconds`
persists a self-contained dump — its full metric tree, a process
registry snapshot, and the slice of the trace ring covering the query
(when tracing is on) — to `spark.hyperspace.telemetry.slowlog.dir`.
A dump can be reloaded (`load_dump`) and diffed against a live re-run
(`telemetry.diff.diff_trees`) without ever re-running the original
under instrumentation, because the instrumentation was never off.

Dumping never fails a query: any dump error is swallowed, counted
(`flight.dump_errors`) and logged. Only the newest
`spark.hyperspace.telemetry.slowlog.keep` dumps are retained. The dump
format is the JAX package's (`kind` "hyperspace-slowlog"): a dump
written by either package loads in the other's `load_dump`.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
from collections import deque
from typing import List, Optional

from hyperspace_tpu_torch.telemetry import registry as _registry

__all__ = ["FlightRecorder", "get_recorder", "record", "load_dump"]

logger = logging.getLogger(__name__)

# Ring depth: enough to cover a burst of concurrent sessions' recent
# history while holding only finished recorders (operator node refs
# are already released by QueryMetrics.finish()).
CAPACITY = 64


class FlightRecorder:
    """Thread-safe bounded ring of completed `QueryMetrics` + the
    slow-query dump policy. One per process (`get_recorder()`);
    concurrent collects from any number of sessions append safely."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = itertools.count()  # dump-name monotonicity
        # Per-query monotonic sequence id, stamped on every recorded
        # QueryMetrics as `flight_seq` (1-based; 0 = "from the start").
        # Incremental consumers — the index advisor's workload miner —
        # poll `snapshot(since_seq)` instead of re-reading the ring.
        self._record_seq = 0
        # Slow-dump writer lane: dumps are QUEUED to one background
        # thread instead of serializing + fsyncing on the serving
        # thread (a slow query is exactly the one whose caller is
        # already past its latency budget). `drain()` flushes pending
        # writes; the module atexit hook drains the process recorder
        # so interpreter teardown cannot lose a queued dump.
        self._dump_pool = None
        self._pending: set = set()

    # -- recording ------------------------------------------------------

    def record(self, metrics, conf=None) -> Optional[str]:
        """Fold one FINISHED query recorder into the ring; dump it when
        the session's slowlog threshold says so. Returns the dump path
        when a dump was QUEUED (None otherwise) — the write itself
        rides the background lane; `drain()` flushes it."""
        with self._lock:
            self._record_seq += 1
            metrics.flight_seq = self._record_seq
            self._ring.append(metrics)
        _registry.get_registry().counter("flight.queries").inc()
        if conf is None:
            return None
        try:
            threshold = conf.slowlog_seconds
        except Exception:
            return None
        if threshold <= 0 or metrics.wall_s is None \
                or metrics.wall_s < threshold:
            return None
        try:
            return self._dump_slow(metrics, conf, threshold)
        except Exception:
            # A diagnosis feature must never fail the query it
            # diagnoses: count, log, move on.
            _registry.get_registry().counter("flight.dump_errors").inc()
            logger.warning("slow-query dump failed", exc_info=True)
            return None

    # -- inspection -----------------------------------------------------

    def queries(self, n: Optional[int] = None) -> List:
        """The most recent completed `QueryMetrics`, oldest first
        (last element = latest); `n` limits to the newest n."""
        with self._lock:
            out = list(self._ring)
        return out if n is None else out[-n:]

    def snapshot(self, since_seq: int = 0, replica=None, tenant=None):
        """Incremental, lock-light poll: `(new_entries, last_seq)` where
        `new_entries` are the ring's completed `QueryMetrics` with
        `flight_seq > since_seq`, oldest first, and `last_seq` is the
        highest sequence id ever recorded (pass it back as the next
        `since_seq`). `replica` narrows to entries the scheduler routed
        to that replica slice (`metrics.replica`); `tenant` narrows to
        entries billed to that tenant (`metrics.tenant`, stamped from
        the active tenant scope). The filters compose. `last_seq` still
        advances over skipped entries, so a filtered
        consumer's cursor stays global. The lock is held only for the
        ring copy. Entries that rotated out of the ring between polls
        are simply gone (the ring is a bounded diagnosis buffer, not a
        durable log): `last_seq` still advances past them, so a slow
        consumer skips rather than stalls."""
        with self._lock:
            entries = list(self._ring)
            last = self._record_seq
        fresh = [m for m in entries
                 if getattr(m, "flight_seq", 0) > since_seq
                 and (replica is None
                      or getattr(m, "replica", None) == replica)
                 and (tenant is None
                      or getattr(m, "tenant", None) == tenant)]
        return fresh, last

    @property
    def last_seq(self) -> int:
        with self._lock:
            return self._record_seq

    def clear(self) -> None:
        """Empty the ring (test isolation). Sequence ids keep counting —
        a consumer's `since_seq` cursor stays valid across clears."""
        with self._lock:
            self._ring.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- dump lane lifecycle --------------------------------------------

    def _lane(self):
        if self._dump_pool is None:
            with self._lock:
                if self._dump_pool is None:
                    from concurrent.futures import ThreadPoolExecutor
                    self._dump_pool = ThreadPoolExecutor(
                        max_workers=1,
                        thread_name_prefix="hs-flight-dump")
        return self._dump_pool

    def drain(self) -> None:
        """Block until every queued slow-query dump has landed (or
        failed and been counted). Idempotent; `session.close()` and the
        atexit hook call this."""
        while True:
            with self._lock:
                futs = list(self._pending)
            if not futs:
                return
            for fut in futs:
                try:
                    fut.result()
                except Exception:
                    pass  # counted + logged by the job itself
            with self._lock:
                self._pending.difference_update(futs)

    def shutdown(self) -> None:
        """Drain and stop the dump lane (idempotent; lazily re-created
        by the next dump)."""
        self.drain()
        with self._lock:
            pool, self._dump_pool = self._dump_pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    # -- slow-query dump ------------------------------------------------

    def _dump_slow(self, metrics, conf, threshold: float) -> str:
        # The SNAPSHOT happens on the calling thread (the metric tree
        # and registry state of the moment the query finished); only
        # the serialization + disk IO ride the background lane.
        dump_dir = conf.slowlog_dir
        keep = conf.slowlog_keep
        doc = {
            "kind": "hyperspace-slowlog",
            "dumped_at": round(time.time(), 3),
            "threshold_s": threshold,
            "wall_s": metrics.wall_s,
            "description": metrics.description,
            "metrics": metrics.to_dict(),
            "registry": _registry.get_registry().to_dict(),
        }
        # Latency anatomy: the stamped decomposition makes the dump
        # self-diagnosing — where the wall went, without a live re-run.
        cp = getattr(metrics, "critical_path", None)
        if cp is not None:
            doc["critical_path"] = cp
        # A slow query is exactly when a device profile is worth its
        # cost: fire a triggered capture (armed only when
        # `telemetry.profiler.capture.seconds` > 0; rate-limited) and
        # record where it will land so the dump points at it.
        try:
            from hyperspace_tpu_torch.telemetry import profiler
            capture = profiler.request_capture(conf, reason="slowlog")
            if capture is not None:
                doc["device_profile"] = capture
        except Exception:
            logger.debug("slowlog-triggered capture failed",
                         exc_info=True)
        trace_slice = self._trace_slice(metrics)
        if trace_slice is not None:
            doc["trace"] = trace_slice
        # Name sorts in creation order WITHIN this process (wall-clock
        # ms + a monotonic sequence); pruning still orders by mtime so
        # multiple processes sharing a dump dir prune correctly.
        fname = (f"slow-{int(doc['dumped_at'] * 1000)}-"
                 f"{os.getpid()}-{next(self._seq):06d}.json")
        path = os.path.join(dump_dir, fname)
        fut = self._lane().submit(self._write_dump, doc, dump_dir, path,
                                  keep, metrics.wall_s, threshold)
        with self._lock:
            self._pending.add(fut)
        fut.add_done_callback(
            lambda f: self._pending.discard(f))
        return path

    def _write_dump(self, doc: dict, dump_dir: str, path: str,
                    keep: int, wall_s, threshold: float) -> None:
        """The dump-lane job: atomic write + prune. Failures are
        counted + logged here (the query is long gone — nothing to
        fail), same contract as the old synchronous path."""
        try:
            os.makedirs(dump_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, default=str)
            os.replace(tmp, path)  # a reader never sees a torn dump
            self._prune(dump_dir, keep)
            _registry.get_registry().counter("flight.slow_dumps").inc()
            logger.warning("slow query (%.3fs >= %.3fs): metrics "
                           "dumped to %s", wall_s, threshold, path)
        except Exception:
            _registry.get_registry().counter("flight.dump_errors").inc()
            logger.warning("slow-query dump failed", exc_info=True)

    @staticmethod
    def _trace_slice(metrics) -> Optional[dict]:
        """The tracer-ring events overlapping this query's execution
        window (None when tracing is off). Timestamps stay on the
        tracer's clock so the slice loads in Perfetto as-is."""
        from hyperspace_tpu_torch.telemetry import trace as _trace
        t = _trace.tracer()
        if t is None:
            return None
        start_us = (metrics._t0 - t.t0_s) * 1e6
        with t._lock:
            events = [e for e in t.events
                      if e.get("ts", 0) + e.get("dur", 0) >= start_us]
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    @staticmethod
    def _prune(dump_dir: str, keep: int) -> None:
        def order(fname: str):
            try:
                return (os.path.getmtime(os.path.join(dump_dir, fname)),
                        fname)
            except OSError:
                return (0.0, fname)  # already pruned: oldest

        dumps = sorted((f for f in os.listdir(dump_dir)
                        if f.startswith("slow-")
                        and f.endswith(".json")), key=order)
        for stale in dumps[:max(len(dumps) - max(keep, 1), 0)]:
            try:
                os.remove(os.path.join(dump_dir, stale))
            except OSError:
                pass  # concurrent pruner got it first


_RECORDER = FlightRecorder()


def get_recorder() -> FlightRecorder:
    """THE process-wide flight recorder (sessions share it)."""
    return _RECORDER


def _atexit_drain() -> None:
    # Interpreter teardown must not lose a queued slow-query dump.
    try:
        _RECORDER.shutdown()
    except Exception:
        pass


import atexit  # noqa: E402

atexit.register(_atexit_drain)


def record(metrics, conf=None) -> Optional[str]:
    """Module-level convenience the engine's collect path calls."""
    return _RECORDER.record(metrics, conf=conf)


def load_dump(path: str) -> dict:
    """Reload a slow-query dump. `doc["metrics"]` is a full
    `QueryMetrics.to_dict()` tree — `telemetry.diff.diff_trees(
    doc["metrics"], live.to_dict())` diffs it against a fresh run."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("kind") != "hyperspace-slowlog":
        raise ValueError(f"{path}: not a slow-query dump")
    return doc
