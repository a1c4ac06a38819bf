"""The serving plane: process-wide query scheduler + cancellation +
degradation circuit breaker.

ROADMAP's north star is "heavy traffic from millions of users"; until
this module, any number of threads could call `DataFrame.collect`
simultaneously with nothing budgeting device memory, no way to stop a
running query, and a persistently broken index re-paying the expensive
degraded fallback on every single query. Every `collect` now routes
through ONE `QueryScheduler` (`get_scheduler()`), which gives the
execution plane the same treatment the storage layer has — typed failure
modes, counters behind every one of them, and fault seams a chaos test
can reach:

- **admission control**: each query's projected HBM footprint
  (`plan/footprint.py` — scan file sizes x a decode-expansion factor,
  conservative default when unknowable) is admitted against
  `spark.hyperspace.serve.hbm.budget.bytes`, derived against the
  `DeviceMemoryAccountant` live gauges (device pressure beyond the
  scheduler's own bookkeeping — resident caches, other tenants —
  shrinks the headroom). Over-budget queries wait in a bounded FIFO
  (`serve.queue.depth`); a query arriving at a full queue gets a typed
  `QueryRejectedError` IMMEDIATELY — backpressure to the caller, not a
  silent pile-up of blocked threads. Budget 0 (default) disables
  budgeting but keeps the bookkeeping (gauges, query registry, cancel).

- **deadlines & cooperative cancellation**: each query carries a
  `Deadline` (per-call `collect(timeout=...)`, else
  `serve.deadline.seconds`) in the same contextvar scope as its
  `QueryMetrics` (`telemetry.deadline_scope`, carried across pool
  threads by `telemetry.propagating`). `telemetry.check_deadline(phase)`
  checkpoints at every layer's iteration boundaries — operator entry
  and exit (`engine/physical.py`), transfer-engine chunk loops
  (`io/transfer.py`), segment-cache fill waits (`io/segcache.py`),
  sorted-run writes (`io/builder.py`) — raise
  `QueryDeadlineExceededError` / `QueryCancelledError` tagged with the
  interrupted phase;
  `session.cancel(query_id)` flips the same flag. Cancellation is
  COOPERATIVE: in-flight device work runs to its next checkpoint, so
  buffers unwind through the normal release paths (the survivor
  isolation tests pin this).

- **inter-query batched execution**: after optimization (and the
  footprint credits), eligible point/filter plans route through the
  batching lane (`engine/batcher.py`): K concurrent queries sharing an
  execution signature coalesce into ONE stacked-predicate evaluation
  on the device over the shared scan, with per-query slicing, deadlines,
  metrics, and the fallback contract preserved. `None` from the lane —
  ineligible shape, nothing to coalesce with, or a batch-lane
  fallback — lands on the per-query resilient path below unchanged.

- **degradation circuit breaker**: the `IndexDataUnavailableError`
  fallback is wrapped in a per-index breaker (closed -> open after N
  failures in a window -> half-open probe; `serve.breaker.*` knobs).
  While open, a query selecting the bad index skips STRAIGHT to the
  source plan — no failed index scan to re-pay — with
  `resilience.breaker.*` counters and flight-recorder events marking
  every transition.

Fault seams for the chaos harness (`tests/chaos.py`):
`scheduler.admit` fires at admission entry, `scheduler.run` just
before plan optimization; `batch.execute` and `transfer.put` cover the
execution layers below.

Typed serving errors and their counters are a CLOSED set
(`SERVING_ERROR_COUNTERS`): every `QueryServingError` subclass appears
in the table with its class's own `counter`, so no failure mode exists
without its scrape-able series.

Replica routing (`parallel/replica.py`): on a multi-slice topology
with replication on, `collect` routes each query to a replica slice
BEFORE admission (the least-loaded slice, or a cold range's home
slice), stamps `metrics.replica`, charges the slice's share of the
budget (`budget // n_replicas`, an idle replica always admits; gauges
`serve.replica.<i>.admitted_bytes`) and runs the query under
`parallel/context.replica_scope`, so every distribution decision sees
that slice's flat submesh. The batched lane is exempt: one invocation
serves the whole cohort. Routing never fails a query.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from hyperspace_tpu_torch import telemetry
from hyperspace_tpu_torch.io import segcache as _segcache
from hyperspace_tpu_torch.io.columnar import to_arrow
from hyperspace_tpu_torch.parallel import replica as _replica
from hyperspace_tpu_torch.parallel.context import replica_scope, topology
from hyperspace_tpu_torch.plan import footprint as _footprint
from hyperspace_tpu_torch.telemetry import compilation, critical_path
from hyperspace_tpu_torch.utils import faults
from hyperspace_tpu_torch.exceptions import (HyperspaceException,
                                       IndexDataUnavailableError,
                                       QueryCancelledError,
                                       QueryDeadlineExceededError,
                                       QueryRejectedError,
                                       QueryServingError)

__all__ = ["Deadline", "QueryScheduler", "BreakerBoard", "SloTracker",
           "get_scheduler", "set_scheduler", "reset_scheduler",
           "SERVING_ERROR_COUNTERS", "SLO_SHED_BURN_THRESHOLD"]

logger = logging.getLogger(__name__)

# Typed serving error -> the registry counter bumped when one is
# raised. Every QueryServingError subclass appears here, and its entry
# equals the class's own `counter` attribute.
SERVING_ERROR_COUNTERS = {
    "QueryRejectedError": "serve.rejected",
    "QueryCancelledError": "serve.cancelled",
    "QueryDeadlineExceededError": "serve.deadline_exceeded",
}

# Queue-wait poll quantum: waiters re-check admission at least this
# often even without a notify (cheap safety against a lost wakeup
# under chaos; the cv IS notified on every release).
_WAIT_QUANTUM_S = 0.05


class Deadline:
    """Per-query cancellation token + optional wall-clock deadline.

    `check(phase)` is the ONE cooperative checkpoint primitive: raises
    the typed error tagged with the phase it would interrupt. The
    cancelled flag is a plain bool (GIL-atomic store; checkpoints pay
    an attribute read, not a lock). A Deadline with no timeout still
    supports `cancel()` — every query gets one."""

    __slots__ = ("query_id", "timeout_s", "_expires_t", "_cancelled")

    def __init__(self, query_id: Optional[str] = None,
                 timeout_s: Optional[float] = None):
        self.query_id = query_id
        self.timeout_s = timeout_s if timeout_s and timeout_s > 0 \
            else None
        self._expires_t = (time.monotonic() + self.timeout_s
                           if self.timeout_s is not None else None)
        self._cancelled = False

    def cancel(self) -> None:
        self._cancelled = True

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def expired(self) -> bool:
        return self._expires_t is not None \
            and time.monotonic() >= self._expires_t

    def remaining(self) -> Optional[float]:
        """Seconds left (None = no time limit; 0.0 = expired)."""
        if self._expires_t is None:
            return None
        return max(0.0, self._expires_t - time.monotonic())

    def check(self, phase: str = "unknown") -> None:
        if self._cancelled:
            raise QueryCancelledError(
                f"query {self.query_id or '?'} cancelled (during "
                f"{phase})", query_id=self.query_id, phase=phase)
        if self.expired():
            raise QueryDeadlineExceededError(
                f"query {self.query_id or '?'} exceeded its "
                f"{self.timeout_s:.3f}s deadline (during {phase})",
                query_id=self.query_id, phase=phase)


# ---------------------------------------------------------------------------
# Sliding-window SLO tracking
# ---------------------------------------------------------------------------

# A p99 objective allows 1% of queries over the target; the burn rate
# is the observed violation fraction over that allowance (1.0 = burning
# the error budget exactly as fast as allowed).
_SLO_ALLOWED_FRACTION = 0.01
# Shedding engages while the burn rate exceeds this (the error budget
# is being consumed faster than the objective allows).
SLO_SHED_BURN_THRESHOLD = 1.0


class SloTracker:
    """Sliding window of completed-query walls vs the SLO target.

    The window is the scheduler's OWN deque of (monotonic t, violated)
    events rather than a view over the timeseries sampler: burn-rate
    decisions (shedding!) must be exact and available whether or not
    the background sampler is running; the sampler's `window.*` gauges
    are the derived, scrapeable view of the same story.

    `prefix` names the published series family: the global tracker
    publishes `serve.slo.*`; per-tenant trackers publish
    `serve.tenant.<id>.slo.*` — same window math, same knobs."""

    def __init__(self, prefix: str = "serve.slo"):
        self.prefix = prefix
        self._lock = threading.Lock()
        self._events: deque = deque()  # (monotonic t, violated: bool)
        self._violations_in_window = 0

    def _prune(self, now: float, window: float) -> None:
        # Caller holds the lock.
        while self._events and self._events[0][0] < now - window:
            _t, violated = self._events.popleft()
            if violated:
                self._violations_in_window -= 1

    def record(self, wall_s: float, conf) -> None:
        """Fold one completed query into the window (no-op when SLO
        tracking is off). Publishes `serve.slo.{violations,burn_rate}`."""
        target = conf.serve_slo_p99_seconds if conf is not None else 0.0
        if target <= 0 or wall_s is None:
            return
        window = max(conf.serve_slo_window_seconds, 1e-3)
        violated = wall_s > target
        now = time.monotonic()
        with self._lock:
            self._events.append((now, violated))
            if violated:
                self._violations_in_window += 1
            self._prune(now, window)
            total = len(self._events)
            violations = self._violations_in_window
        reg = telemetry.get_registry()
        if violated:
            reg.counter(f"{self.prefix}.violations").inc()
        burn = ((violations / total) / _SLO_ALLOWED_FRACTION
                if total else 0.0)
        reg.gauge(f"{self.prefix}.burn_rate").set(burn)
        reg.gauge(f"{self.prefix}.window_queries").set(total)

    def burn_rate(self, conf) -> float:
        """Current burn rate over the trailing window (0.0 = off or no
        traffic). Pruned on read so a quiet period decays the burn."""
        target = conf.serve_slo_p99_seconds if conf is not None else 0.0
        if target <= 0:
            return 0.0
        window = max(conf.serve_slo_window_seconds, 1e-3)
        with self._lock:
            self._prune(time.monotonic(), window)
            total = len(self._events)
            violations = self._violations_in_window
        return (violations / total) / _SLO_ALLOWED_FRACTION \
            if total else 0.0

    def refresh(self, conf) -> float:
        """Prune the window and RE-PUBLISH the burn gauges — the alert
        plane's feed. `record()` only publishes when a query completes,
        so after traffic stops `serve.slo.burn_rate` would freeze at
        its last (possibly burning) value and a burn incident could
        never resolve; the sampler-tick evaluation reads the burn
        through here so the published gauge always reflects the decayed
        window. Returns the current burn rate."""
        burn = self.burn_rate(conf)
        target = conf.serve_slo_p99_seconds if conf is not None else 0.0
        if target > 0:
            with self._lock:
                total = len(self._events)
            reg = telemetry.get_registry()
            reg.gauge(f"{self.prefix}.burn_rate").set(burn)
            reg.gauge(f"{self.prefix}.window_queries").set(total)
        return burn

    def snapshot(self, conf=None) -> dict:
        with self._lock:
            total = len(self._events)
            violations = self._violations_in_window
        out = {"window_queries": total,
               "window_violations": violations,
               "burn_rate": ((violations / total) / _SLO_ALLOWED_FRACTION
                             if total else 0.0)}
        if conf is not None:
            out["p99_target_s"] = conf.serve_slo_p99_seconds
            out["window_s"] = conf.serve_slo_window_seconds
            out["shed_enabled"] = conf.serve_slo_shed_enabled
        return out

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._violations_in_window = 0


# ---------------------------------------------------------------------------
# Degradation circuit breaker
# ---------------------------------------------------------------------------

_CLOSED, _OPEN, _HALF_OPEN = "closed", "open", "half_open"


class _Breaker:
    __slots__ = ("state", "failures", "opened_t", "probing")

    def __init__(self):
        self.state = _CLOSED
        self.failures: deque = deque()  # monotonic timestamps
        self.opened_t = 0.0
        self.probing = False


def _breaker_knobs(conf):
    from hyperspace_tpu_torch import constants
    if conf is None:
        return (constants.SERVE_BREAKER_FAILURES_DEFAULT,
                constants.SERVE_BREAKER_WINDOW_SECONDS_DEFAULT,
                constants.SERVE_BREAKER_COOLDOWN_SECONDS_DEFAULT)
    return (conf.serve_breaker_failures,
            conf.serve_breaker_window_seconds,
            conf.serve_breaker_cooldown_seconds)


class BreakerBoard:
    """Per-index degradation circuit breakers.

    closed --N failures in window--> open --cooldown--> half-open
    (ONE probe query allowed through) --success--> closed / --failure-->
    open again. A failure here is an `IndexDataUnavailableError`
    fallback: the breaker's job is to stop re-paying the failed index
    scan once the index is KNOWN bad, not to mask novel errors.
    Transitions land in `resilience.breaker.{opened,half_open,closed}`
    counters and, when a query recorder is active, as flight-recorder
    visible `resilience: breaker` events."""

    def __init__(self):
        self._lock = threading.Lock()
        self._breakers: Dict[str, _Breaker] = {}

    def state(self, index_name: str) -> str:
        with self._lock:
            b = self._breakers.get(index_name)
            return b.state if b is not None else _CLOSED

    def _transition(self, b: _Breaker, state: str, index_name: str) -> None:
        # Called under the lock. Counter + decision event per move.
        b.state = state
        telemetry.get_registry().counter(
            f"resilience.breaker.{state if state != _OPEN else 'opened'}"
        ).inc()
        telemetry.event("resilience", "breaker", index=index_name,
                        state=state)

    def allow(self, index_name: str, conf=None) -> str:
        """Admission verdict for a query selecting `index_name`:
        "closed" (serve from index), "probe" (half-open: THIS query is
        the probe), or "open" (skip straight to the source plan)."""
        with self._lock:
            b = self._breakers.get(index_name)
            if b is None or b.state == _CLOSED:
                return _CLOSED
            _n, _w, cooldown = _breaker_knobs(conf)
            if b.state == _OPEN:
                if time.monotonic() - b.opened_t < cooldown:
                    return _OPEN
                self._transition(b, _HALF_OPEN, index_name)
                b.probing = True
                return "probe"
            # half-open: one probe at a time
            if not b.probing:
                b.probing = True
                return "probe"
            return _OPEN

    def record_failure(self, index_name: str, conf=None) -> None:
        now = time.monotonic()
        with self._lock:
            b = self._breakers.setdefault(index_name, _Breaker())
            n, window, _cooldown = _breaker_knobs(conf)
            if b.state == _HALF_OPEN:
                # Probe failed: straight back to open, fresh cooldown.
                b.probing = False
                b.opened_t = now
                self._transition(b, _OPEN, index_name)
                return
            if b.state == _OPEN:
                return  # already open (a pre-open query finishing late)
            b.failures.append(now)
            while b.failures and b.failures[0] < now - window:
                b.failures.popleft()
            if len(b.failures) >= max(1, n):
                b.opened_t = now
                b.failures.clear()
                self._transition(b, _OPEN, index_name)

    def record_success(self, index_name: str) -> None:
        with self._lock:
            b = self._breakers.get(index_name)
            if b is None:
                return
            if b.state == _HALF_OPEN:
                b.probing = False
                self._transition(b, _CLOSED, index_name)
            elif b.state == _CLOSED:
                b.failures.clear()

    def reset(self) -> None:
        with self._lock:
            self._breakers.clear()

    def snapshot(self) -> Dict[str, str]:
        with self._lock:
            return {name: b.state for name, b in self._breakers.items()}


# ---------------------------------------------------------------------------
# The scheduler
# ---------------------------------------------------------------------------


class _QueryEntry:
    __slots__ = ("query_id", "deadline", "footprint", "session_id",
                 "admitted", "replica", "n_replicas", "tenant", "shed")

    def __init__(self, query_id: str, deadline: Deadline, footprint: int,
                 session_id: Optional[int]):
        self.query_id = query_id
        self.deadline = deadline
        self.footprint = footprint
        self.session_id = session_id
        self.admitted = False
        # Replica routing (`parallel/replica.py`): the slice this
        # query's fills and execution are pinned to, or None. With a
        # replica set, admission charges the PER-REPLICA budget
        # (budget / n_replicas) so one hot replica cannot starve the
        # others' admission headroom.
        self.replica: Optional[int] = None
        self.n_replicas: int = 0
        # Billing identity: the tenant this query charges (default
        # tenant when no tenant scope is active — never None, so every
        # query always has someone to bill) and the shed flag the SLO
        # shedder sets to evict this WAITING entry from the queue.
        self.tenant: str = telemetry.DEFAULT_TENANT
        self.shed = False


class QueryScheduler:
    """Process-wide serving-plane scheduler (module docstring). All
    waiting happens on the CALLER's thread — the scheduler spawns no
    threads of its own, so there is no dispatcher to deadlock or
    leak."""

    def __init__(self):
        self._cv = threading.Condition()
        self._active: Dict[str, _QueryEntry] = {}
        self._waiters: deque = deque()  # all waiting _QueryEntry
        self._admitted_bytes = 0
        self._inflight = 0
        self._idle_baseline = 0  # accountant live bytes at idle
        self._ids = itertools.count(1)
        self.peak_admitted_bytes = 0
        self._breakers = BreakerBoard()
        self._slo = SloTracker()
        # Per-replica load (`parallel/replica.py`): admitted bytes and
        # in-flight counts keyed by replica slice. The router reads
        # these to pick the least-loaded replica; the gauges
        # `serve.replica.<i>.admitted_bytes` mirror them.
        self._replica_bytes: Dict[int, int] = {}
        self._replica_inflight: Dict[int, int] = {}
        # Multi-tenant state. The wait queue is weighted-fair
        # deficit-round-robin across per-tenant FIFOs (one burst cannot
        # starve the long tail): `_tenant_queues` holds each tenant's
        # waiters in arrival order, `_drr_order` rotates the tenants,
        # `_drr_deficit` accumulates each tenant's configured weight
        # per round and spends 1.0 per dequeue, and `_drr_next` pins
        # the selected head until it admits or leaves (selection must
        # be stable across cv wakeups or waiters livelock). Admission
        # quotas charge `_tenant_bytes`/`_tenant_inflight`; per-tenant
        # `SloTracker`s publish `serve.tenant.<id>.slo.*` and name the
        # burning tenant the shed hook evicts first.
        self._tenant_queues: Dict[str, deque] = {}
        self._drr_order: deque = deque()  # tenant ids, round-robin
        self._drr_deficit: Dict[str, float] = {}
        self._drr_next: Optional[_QueryEntry] = None
        self._tenant_bytes: Dict[str, int] = {}
        self._tenant_inflight: Dict[str, int] = {}
        self._tenant_slo: Dict[str, SloTracker] = {}

    # -- introspection ----------------------------------------------------

    def active_queries(self) -> List[str]:
        """Query ids currently admitted or queued (cancel targets)."""
        with self._cv:
            return sorted(self._active)

    def admitted_bytes(self) -> int:
        with self._cv:
            return self._admitted_bytes

    def queue_depth(self) -> int:
        """Queries currently WAITING for admission (0 = nothing queued)."""
        with self._cv:
            return len(self._waiters)

    def pressure(self) -> dict:
        """One-shot serving-pressure snapshot for background work that
        must yield to live traffic (the index advisor's build gate):
        admitted bytes, in-flight count, and queue depth under one lock
        acquisition."""
        with self._cv:
            return {"admitted_bytes": self._admitted_bytes,
                    "inflight": self._inflight,
                    "queue_depth": len(self._waiters)}

    def replica_admitted_bytes(self) -> Dict[int, int]:
        """Per-replica admitted bytes (the router's load signal)."""
        with self._cv:
            return dict(self._replica_bytes)

    def replica_inflight(self) -> Dict[int, int]:
        """Per-replica in-flight query counts (the router's tiebreak)."""
        with self._cv:
            return dict(self._replica_inflight)

    @property
    def breakers(self) -> BreakerBoard:
        return self._breakers

    @property
    def slo(self) -> SloTracker:
        return self._slo

    def slo_snapshot(self, conf=None) -> dict:
        """SLO window state for `/healthz` and the bench drivers."""
        return self._slo.snapshot(conf)

    def _tenant_slo_for(self, tenant: str) -> SloTracker:
        """The tenant's own SLO window (created on first use),
        publishing `serve.tenant.<id>.slo.*`. Lock-free on the hit
        path: this runs once per COMPLETED query, and taking the
        scheduler cv here would put every finisher in line behind
        admission traffic."""
        trk = self._tenant_slo.get(tenant)  # atomic dict read
        if trk is not None:
            return trk
        with self._cv:
            trk = self._tenant_slo.get(tenant)
            if trk is None:
                trk = SloTracker(prefix=f"serve.tenant.{tenant}.slo")
                self._tenant_slo[tenant] = trk
            return trk

    def tenant_snapshot(self, conf=None) -> dict:
        """Per-tenant serving state for `/healthz` and
        `Hyperspace.tenant_report()`: admitted bytes, in-flight and
        queued counts, the tenant's SLO window, and its configured
        scheduling knobs."""
        with self._cv:
            tenants = (set(self._tenant_bytes)
                       | set(self._tenant_inflight)
                       | set(self._tenant_queues)
                       | set(self._tenant_slo))
            out = {t: {"admitted_bytes": self._tenant_bytes.get(t, 0),
                       "inflight": self._tenant_inflight.get(t, 0),
                       "queued": len(self._tenant_queues.get(t, ()))}
                   for t in sorted(tenants)}
            trackers = dict(self._tenant_slo)
        for t, d in out.items():
            trk = trackers.get(t)
            if trk is not None:
                d["slo"] = trk.snapshot(conf)
            if conf is not None:
                d["weight"] = conf.serve_tenant_weight(t)
                frac = conf.serve_tenant_hbm_fraction(t)
                if frac > 0:
                    d["hbm_fraction"] = frac
                tdepth = conf.serve_tenant_queue_depth(t)
                if tdepth > 0:
                    d["queue_depth"] = tdepth
        return out

    # -- cancellation -----------------------------------------------------

    def cancel(self, query_id: str) -> bool:
        """Cooperatively cancel a queued or running query. True iff the
        id was live (the query raises `QueryCancelledError` at its next
        checkpoint — cancellation is a request, not preemption)."""
        with self._cv:
            ent = self._active.get(query_id)
            if ent is None:
                return False
            ent.deadline.cancel()
            self._cv.notify_all()
        return True

    def cancel_session(self, session) -> int:
        """Cancel every live query submitted through `session`
        (`session.close()`'s drain). Returns how many were flagged."""
        sid = id(session)
        n = 0
        with self._cv:
            for ent in self._active.values():
                if ent.session_id == sid:
                    ent.deadline.cancel()
                    n += 1
            if n:
                self._cv.notify_all()
        return n

    def drain_session(self, session, timeout_s: float = 10.0) -> bool:
        """Block until no query of `session` is live (or timeout).
        True iff drained."""
        sid = id(session)
        t_end = time.monotonic() + timeout_s
        with self._cv:
            while any(e.session_id == sid for e in self._active.values()):
                left = t_end - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(timeout=min(left, _WAIT_QUANTUM_S))
        return True

    # -- admission --------------------------------------------------------

    def _live_device_bytes(self) -> int:
        """Last-sampled accountant live total (no walk forced — the
        accountant samples at span boundaries and query ends already;
        admission reads whatever is freshest)."""
        try:
            return sum(telemetry.get_accountant().live.values())
        except Exception:
            return 0

    def _fits(self, ent: "_QueryEntry", budget: int, conf=None) -> bool:
        # Caller holds the cv lock. Progress guarantee: with nothing in
        # flight a query larger than the whole budget still admits —
        # the budget bounds CONCURRENCY, it must never wedge serving.
        if self._inflight == 0:
            return True
        # Per-tenant HBM quota (`serve.tenant.<id>.hbm.fraction`): a
        # configured tenant may hold at most its fraction of the budget
        # admitted concurrently, with the same progress guarantee — a
        # tenant with nothing in flight always admits one query.
        frac = (conf.serve_tenant_hbm_fraction(ent.tenant)
                if conf is not None else 0.0)
        if frac > 0 and self._tenant_inflight.get(ent.tenant, 0) > 0 \
                and self._tenant_bytes.get(ent.tenant, 0) \
                + ent.footprint > int(budget * frac):
            return False
        if ent.replica is not None and ent.n_replicas > 1:
            # Per-replica admission: the query charges its SLICE's share
            # of the budget, with the same per-replica progress
            # guarantee — an idle replica always admits.
            if self._replica_inflight.get(ent.replica, 0) == 0:
                return True
            if self._replica_bytes.get(ent.replica, 0) \
                    + ent.footprint > budget // ent.n_replicas:
                return False
        live = self._live_device_bytes()
        used = max(self._admitted_bytes,
                   live - self._idle_baseline if live else 0)
        return used + ent.footprint <= budget

    # -- weighted-fair wait queue (deficit round robin) -------------------

    def _enqueue_waiter(self, ent: _QueryEntry) -> None:
        # Caller holds the cv lock.
        self._waiters.append(ent)
        q = self._tenant_queues.setdefault(ent.tenant, deque())
        q.append(ent)
        if ent.tenant not in self._drr_order:
            self._drr_order.append(ent.tenant)

    def _remove_waiter(self, ent: _QueryEntry) -> None:
        # Caller holds the cv lock. Safe to call when not queued.
        try:
            self._waiters.remove(ent)
        except ValueError:
            pass
        q = self._tenant_queues.get(ent.tenant)
        if q is not None:
            try:
                q.remove(ent)
            except ValueError:
                pass
            if not q:
                self._tenant_queues.pop(ent.tenant, None)
        if self._drr_next is ent:
            self._drr_next = None

    def _drr_select(self, conf) -> Optional[_QueryEntry]:
        """The waiter that admits next, by weighted-fair deficit round
        robin over the per-tenant FIFOs: each visited tenant banks its
        configured weight and a dequeue spends 1.0, so a weight-2
        tenant drains twice as fast as a weight-1 tenant under
        contention — and a one-tenant burst cannot starve the others'
        heads the way the old global FIFO could. The pick is PINNED
        (`_drr_next`) until that entry admits or leaves: selection must
        be stable across cv wakeups or waiters spin past each other.
        Caller holds the cv lock."""
        if self._drr_next is not None:
            return self._drr_next
        if not self._waiters:
            return None
        for _ in range(4096):  # weights are clamped > 0: bounded spin
            if not self._drr_order:
                self._drr_order.extend(self._tenant_queues)
                if not self._drr_order:
                    break
            t = self._drr_order[0]
            q = self._tenant_queues.get(t)
            if not q:
                self._drr_order.popleft()
                self._drr_deficit.pop(t, None)
                continue
            d = self._drr_deficit.get(t, 0.0)
            if d < 1.0:
                # Bank the weight only when broke: deficits stay
                # bounded in [0, max(w, 1)) instead of accumulating
                # credit a tenant could never spend.
                d += (conf.serve_tenant_weight(t)
                      if conf is not None else 1.0)
            if d >= 1.0:
                self._drr_deficit[t] = d - 1.0
                if d - 1.0 < 1.0:
                    # Deficit spent: this tenant's turn ends. While
                    # credit remains it stays at the head — a weight-2
                    # tenant dequeues twice per visit, which is what
                    # makes the weights mean drain RATE.
                    self._drr_order.rotate(-1)
                self._drr_next = q[0]
                return self._drr_next
            self._drr_deficit[t] = d
            self._drr_order.rotate(-1)
        self._drr_next = self._waiters[0]  # defensive: degrade to FIFO
        return self._drr_next

    def _shed_victim(self, arriving: _QueryEntry, conf) \
            -> Optional[_QueryEntry]:
        """While shedding is active, the BURNING tenant's queue sheds
        first: the waiter shed to make room is the newest queued entry
        of the tenant whose own SLO window burns hottest — not the
        arriving query, unless the arriver IS the burning tenant (or
        no burning tenant has anything queued). Caller holds the cv
        lock; returns None when the arriving query should be rejected
        instead (the pre-tenant behavior)."""
        burning, worst = None, SLO_SHED_BURN_THRESHOLD
        for t, trk in self._tenant_slo.items():
            if t == arriving.tenant:
                continue
            q = self._tenant_queues.get(t)
            if not q:
                continue
            burn = trk.burn_rate(conf)
            if burn > worst:
                burning, worst = t, burn
        if burning is None:
            return None
        return self._tenant_queues[burning][-1]

    def _admit(self, ent: _QueryEntry, conf) -> float:
        """Admit `ent` (blocking, weighted-fair across tenants, when
        over budget). Returns seconds spent queued. Raises
        QueryRejectedError when the wait queue is full (globally or for
        the entry's tenant), or the entry's own deadline error when it
        expires/cancels while queued."""
        faults.fire("scheduler.admit")
        reg = telemetry.get_registry()
        budget = conf.serve_hbm_budget_bytes if conf is not None else 0
        with self._cv:
            if budget <= 0 or (not self._waiters
                               and self._fits(ent, budget, conf)):
                self._grant(ent, reg)
                reg.histogram("serve.queue_wait_s").observe(0.0)
                return 0.0
            depth = max(0, conf.serve_queue_depth
                        if conf is not None else 0)
            # Per-tenant queue-depth quota: a configured tenant may
            # hold at most `serve.tenant.<id>.queue.depth` WAITING
            # queries — its burst backpressures itself before it can
            # occupy the shared queue.
            tdepth = (conf.serve_tenant_queue_depth(ent.tenant)
                      if conf is not None else 0)
            tqueued = len(self._tenant_queues.get(ent.tenant, ()))
            if tdepth > 0 and tqueued >= tdepth:
                reg.counter(f"serve.tenant.{ent.tenant}.rejected").inc()
                raise QueryRejectedError(
                    f"query {ent.query_id} rejected: tenant "
                    f"'{ent.tenant}' wait queue is full "
                    f"({tqueued}/{tdepth})",
                    query_id=ent.query_id, phase="queue")
            # SLO shedding (opt-in): while the burn rate says the error
            # budget is being consumed faster than the p99 objective
            # allows, tighten the wait queue to HALF its configured
            # depth — controlled backpressure at the admission door
            # instead of a queue whose tail is guaranteed to violate.
            # A query rejected by the tightened (not the configured)
            # depth counts `serve.slo.shed` exactly once. With tenants
            # in play the shed targets the BURNING tenant's queue
            # first: its newest waiter is evicted to make room for the
            # arriver, so one tenant burning its budget cannot convert
            # tightened depth into rejections for everyone else.
            effective = depth
            if conf is not None and conf.serve_slo_shed_enabled \
                    and self._slo.burn_rate(conf) \
                    > SLO_SHED_BURN_THRESHOLD:
                effective = depth // 2
            if len(self._waiters) >= effective:
                shed_mode = effective < depth \
                    and len(self._waiters) < depth
                if shed_mode:
                    victim = self._shed_victim(ent, conf)
                    if victim is not None and not victim.shed:
                        victim.shed = True
                        reg.counter("serve.slo.shed").inc()
                        reg.counter(
                            f"serve.tenant.{victim.tenant}.rejected"
                        ).inc()
                        self._cv.notify_all()
                    else:
                        reg.counter("serve.slo.shed").inc()
                        reg.counter(
                            f"serve.tenant.{ent.tenant}.rejected").inc()
                        raise QueryRejectedError(
                            f"query {ent.query_id} rejected: projected "
                            f"{ent.footprint} B does not fit the "
                            f"serving budget ({budget} B, "
                            f"{self._admitted_bytes} B admitted) and "
                            f"the wait queue is full "
                            f"({len(self._waiters)}/{effective} — SLO "
                            f"shedding active)",
                            query_id=ent.query_id, phase="queue")
                else:
                    reg.counter(
                        f"serve.tenant.{ent.tenant}.rejected").inc()
                    raise QueryRejectedError(
                        f"query {ent.query_id} rejected: projected "
                        f"{ent.footprint} B does not fit the serving "
                        f"budget ({budget} B, {self._admitted_bytes} B "
                        f"admitted) and the wait queue is full "
                        f"({len(self._waiters)}/{effective})",
                        query_id=ent.query_id, phase="queue")
            t0 = time.perf_counter()
            self._enqueue_waiter(ent)
            reg.counter("serve.queued").inc()
            reg.counter(f"serve.tenant.{ent.tenant}.queued").inc()
            reg.gauge("serve.queue_depth").set(len(self._waiters))
            try:
                while not (self._drr_select(conf) is ent
                           and self._fits(ent, budget, conf)):
                    if ent.shed:
                        raise QueryRejectedError(
                            f"query {ent.query_id} shed from the wait "
                            f"queue: tenant '{ent.tenant}' is burning "
                            f"its SLO error budget",
                            query_id=ent.query_id, phase="queue")
                    ent.deadline.check("queue")
                    rem = ent.deadline.remaining()
                    self._cv.wait(timeout=(_WAIT_QUANTUM_S if rem is None
                                           else min(rem + 1e-3,
                                                    _WAIT_QUANTUM_S)))
                self._remove_waiter(ent)
                self._grant(ent, reg)
            finally:
                self._remove_waiter(ent)  # no-op when admitted above
                reg.gauge("serve.queue_depth").set(len(self._waiters))
                self._cv.notify_all()
            wait_s = time.perf_counter() - t0
        reg.histogram("serve.queue_wait_s").observe(wait_s)
        return wait_s

    def _grant(self, ent: _QueryEntry, reg) -> None:
        # Caller holds the cv lock.
        self._admitted_bytes += ent.footprint
        self._inflight += 1
        ent.admitted = True
        if self._admitted_bytes > self.peak_admitted_bytes:
            self.peak_admitted_bytes = self._admitted_bytes
        reg.counter("serve.admitted").inc()
        reg.counter(f"serve.tenant.{ent.tenant}.admitted").inc()
        reg.gauge("serve.admitted_bytes").set(self._admitted_bytes)
        reg.gauge("serve.active").set(self._inflight)
        self._tenant_bytes[ent.tenant] = \
            self._tenant_bytes.get(ent.tenant, 0) + ent.footprint
        self._tenant_inflight[ent.tenant] = \
            self._tenant_inflight.get(ent.tenant, 0) + 1
        if ent.replica is not None:
            r = ent.replica
            self._replica_bytes[r] = (self._replica_bytes.get(r, 0)
                                      + ent.footprint)
            self._replica_inflight[r] = \
                self._replica_inflight.get(r, 0) + 1
            reg.gauge(f"serve.replica.{r}.admitted_bytes").set(
                self._replica_bytes[r])

    def _credit(self, ent: _QueryEntry, *amounts: int) -> List[int]:
        """Footprint credits, applied in order under one lock: once the
        optimized plan is known, the bytes its rewrite no longer reads
        and the bytes its index scans will serve from the segment cache
        (`io/segcache.py`) are NOT bytes this query will stage — shrink
        its admitted charge so queued queries over the same hot index
        stop serially occupying budget as if each re-staged the data
        (the admission-side half of shared-scan coalescing; the cache's
        single-flight fill is the other half). Returns the bytes
        actually credited for each amount (clamped so a query never
        charges below the footprint floor)."""
        credited = []
        with self._cv:
            for nbytes in amounts:
                delta = 0
                if ent.admitted and nbytes > 0:
                    delta = max(0, min(
                        int(nbytes), ent.footprint
                        - _footprint.MIN_FOOTPRINT_BYTES))
                if delta > 0:
                    ent.footprint -= delta
                    self._admitted_bytes -= delta
                    self._tenant_bytes[ent.tenant] = max(
                        0, self._tenant_bytes.get(ent.tenant, 0) - delta)
                credited.append(delta)
            total = sum(credited)
            if total:
                reg = telemetry.get_registry()
                reg.counter("serve.footprint_credit_bytes").inc(total)
                reg.gauge("serve.admitted_bytes").set(self._admitted_bytes)
                if ent.replica is not None:
                    r = ent.replica
                    self._replica_bytes[r] = max(
                        0, self._replica_bytes.get(r, 0) - total)
                    reg.gauge(f"serve.replica.{r}.admitted_bytes").set(
                        self._replica_bytes[r])
                self._cv.notify_all()
        return credited

    def _release(self, ent: _QueryEntry) -> None:
        reg = telemetry.get_registry()
        with self._cv:
            self._active.pop(ent.query_id, None)
            if ent.admitted:
                self._admitted_bytes -= ent.footprint
                self._inflight -= 1
                self._tenant_bytes[ent.tenant] = max(
                    0, self._tenant_bytes.get(ent.tenant, 0)
                    - ent.footprint)
                self._tenant_inflight[ent.tenant] = max(
                    0, self._tenant_inflight.get(ent.tenant, 0) - 1)
                if ent.replica is not None:
                    r = ent.replica
                    self._replica_bytes[r] = max(
                        0, self._replica_bytes.get(r, 0) - ent.footprint)
                    self._replica_inflight[r] = max(
                        0, self._replica_inflight.get(r, 0) - 1)
                    reg.gauge(f"serve.replica.{r}.admitted_bytes").set(
                        self._replica_bytes[r])
                if self._inflight == 0:
                    # Re-anchor: bookkeeping drift cannot accumulate,
                    # and the idle baseline tracks resident caches so
                    # `_fits` charges queries only for QUERY memory.
                    self._admitted_bytes = 0
                    self._replica_bytes.clear()
                    self._replica_inflight.clear()
                    self._tenant_bytes.clear()
                    self._tenant_inflight.clear()
                    self._idle_baseline = self._live_device_bytes()
                reg.gauge("serve.admitted_bytes").set(self._admitted_bytes)
                reg.gauge("serve.active").set(self._inflight)
            self._cv.notify_all()

    # -- serving-error bookkeeping ---------------------------------------

    def _record_serving_error(self, exc: QueryServingError, metrics,
                              conf) -> None:
        """One place counts every typed serving error (exactly once):
        the class-declared counter, a per-phase `serve.interrupted.*`
        series, and — when the query had started executing — the event
        + interrupted-phase counter on its recorder, which then joins
        the flight ring so timeout clusters are diagnosable post-hoc."""
        reg = telemetry.get_registry()
        reg.counter(exc.counter).inc()
        phase = exc.phase or "unknown"
        reg.counter(f"serve.interrupted.{phase}").inc()
        if metrics is None:
            return
        metrics.event("serve", exc.counter.split(".", 1)[1],
                      query_id=exc.query_id, phase=phase)
        metrics.add_count(f"serve.interrupted.{phase}")
        metrics.finish()
        telemetry.flight.record(metrics, conf=conf)
        # Completed puts of the cancelled query release their window
        # bytes + staging buffers now, not at the next caller's put.
        try:
            from hyperspace_tpu_torch.io import transfer
            transfer.get_engine().sweep()
        except Exception:
            pass

    # -- resilient execution (breaker + degradation fallback) ------------

    @staticmethod
    def _index_scans(plan) -> List[tuple]:
        """(index_name, breaker_key, index_roots) of every rule-selected
        index scan. The breaker keys on name AND data root: two
        warehouses (or two test environments) reusing an index name are
        different indexes, and one going bad must not short-circuit the
        other. `index_roots` (the parents of its `v__=N` dirs) is what
        the segment cache tallies resident bytes under."""
        from hyperspace_tpu_torch.plan.nodes import Scan
        out: List[tuple] = []

        def visit(node):
            if isinstance(node, Scan) and node.index_name:
                root = node.root_paths[0] if node.root_paths else ""
                out.append((node.index_name,
                            f"{node.index_name}@{root}",
                            _segcache.index_roots(node.root_paths)))
            for c in node.children:
                visit(c)

        visit(plan)
        return out

    def _degrade(self, df, metrics, conf, index_name, reason: str):
        """Answer from the SOURCE plan (graceful degradation), keeping
        the downgrade loud in telemetry."""
        from hyperspace_tpu_torch.engine.executor import execute_plan
        telemetry.get_registry().counter("resilience.fallbacks").inc()
        metrics.add_count("resilience.fallbacks")
        metrics.event("resilience", "degraded", index=index_name,
                      reason=reason)
        return execute_plan(df.plan, conf=conf)

    def _execute_resilient(self, df, plan, metrics, conf, index_scans):
        """Execute the optimized plan with the per-index circuit
        breaker wrapped around the degradation fallback. `index_scans`
        is `_index_scans(plan)` for a rewritten plan, else empty."""
        from hyperspace_tpu_torch.engine.executor import execute_plan
        for name, key, _roots in index_scans:
            verdict = self._breakers.allow(key, conf)
            if verdict == _OPEN:
                # Known-bad index: skip STRAIGHT to the source plan —
                # no failed index scan to re-pay.
                telemetry.get_registry().counter(
                    "resilience.breaker.short_circuits").inc()
                metrics.add_count("resilience.breaker.short_circuits")
                return self._degrade(df, metrics, conf, name,
                                     "breaker open")
        try:
            batch = execute_plan(plan, conf=conf)
        except IndexDataUnavailableError as exc:
            if plan is df.plan:
                raise  # no rewrite to fall back from
            logger.warning("Index data unavailable (%s); falling back "
                           "to the source plan", exc)
            for name, key, _roots in index_scans:
                if name == exc.index_name:
                    self._breakers.record_failure(key, conf)
                    break
            return self._degrade(df, metrics, conf, exc.index_name,
                                 str(exc))
        for _name, key, _roots in index_scans:
            self._breakers.record_success(key)
        return batch

    # -- the collect pipeline ---------------------------------------------

    def collect(self, df, timeout: Optional[float] = None,
                tenant: Optional[str] = None):
        """Execute a DataFrame end to end under serving control.
        Returns `(arrow_table, QueryMetrics)` — `DataFrame.collect`
        owns the user-facing return shape. `tenant` (else the
        session's sticky `session.tenant(...)` default, else the
        DEFAULT tenant) is the billing identity the query charges:
        admission quotas, DRR dequeue weight, SLO window, and every
        chargeback counter key on it."""
        session = df.session
        conf = session.conf if session is not None else None
        if session is not None and getattr(session, "_closed", False):
            raise HyperspaceException(
                "Session is closed; create a new HyperspaceSession.")
        if tenant is None and session is not None:
            tenant = getattr(session, "_default_tenant", None)
        eff_tenant = str(tenant) if tenant else telemetry.DEFAULT_TENANT
        query_id = f"q-{next(self._ids)}"
        if timeout is None and conf is not None:
            timeout = conf.serve_deadline_seconds or None
        deadline = Deadline(query_id, timeout)
        ent = _QueryEntry(query_id, deadline,
                          _footprint.projected_bytes(df.plan),
                          id(session) if session is not None else None)
        ent.tenant = eff_tenant
        # Replica routing (`parallel/replica.py`): on a multi-slice
        # topology with replication on, pin this query's fills and
        # execution to the least-loaded replica slice (cold-range
        # queries pin to their home slice). Routed BEFORE admission so
        # the per-replica budget charges the right slice; routing must
        # never fail a query.
        try:
            rep = _replica.get_router().route(df.plan, conf, self)
            if rep is not None:
                topo = topology(conf)
                ent.replica = rep
                ent.n_replicas = topo[0] if topo is not None else 0
        except Exception:
            logger.debug("replica routing skipped", exc_info=True)
        description = ", ".join(df.schema.names[:6])
        # The query id is the cancel/log correlation handle and the id
        # every span of the query carries.
        metrics = telemetry.QueryMetrics(description=description,
                                         query_id=query_id)
        # Routed-replica dimension: flight-ring consumers (/healthz's
        # by-replica grouping) group entries by the slice that served
        # them; None = unrouted.
        metrics.replica = ent.replica
        # Tenant dimension: stamped on the recorder (flight-ring
        # `tenant=` filter, /healthz by-tenant grouping) — always the
        # EFFECTIVE tenant, "default" included, so post-hoc grouping
        # never needs a null branch.
        metrics.tenant = eff_tenant
        # The SOURCE (pre-optimization) logical plan rides the recorder
        # into the flight ring: the index advisor's what-if scorer
        # replays exactly this plan against hypothetical indexes
        # (logical plans are immutable once built; holding the reference
        # costs nothing per query — no serialization on the hot path).
        metrics.logical_plan = df.plan
        with self._cv:
            self._active[query_id] = ent
        reg = telemetry.get_registry()
        try:
            try:
                # The span places admission on the timeline; its
                # seconds are timed on the monotonic clock, as the queue
                # wait inside it is.
                t_admit0 = time.perf_counter_ns()
                with metrics.span("serve:admit", "serving"):
                    wait_s = self._admit(ent, conf)
                admit_s = (time.perf_counter_ns() - t_admit0) / 1e9
                # Critical-path sources: the recorder's wall started at
                # construction (before admission), so queue wait and the
                # admission bookkeeping around it are genuine wall
                # segments — stamp both as per-query counters for
                # `telemetry/critical_path.py` to classify.
                metrics.add_seconds("serve.queue_wait_s", wait_s)
                metrics.add_seconds("serve.admission_s",
                                    max(admit_s - wait_s, 0.0))
            except QueryServingError as exc:
                self._record_serving_error(exc, None, conf)
                raise
            try:
                with telemetry.recording(metrics), \
                        telemetry.deadline_scope(deadline), \
                        telemetry.tenant_scope(eff_tenant):
                    metrics.event("serve", "admitted",
                                  query_id=query_id,
                                  footprint_bytes=ent.footprint,
                                  queue_wait_s=round(wait_s, 6))
                    faults.fire("scheduler.run")
                    deadline.check("plan")
                    plan = (session.optimize(df.plan)
                            if session is not None else df.plan)
                    index_scans = []
                    if plan is not df.plan:
                        # Admission charged the UNOPTIMIZED plan. The
                        # rewritten plan may read strictly fewer bytes —
                        # a covering index's narrower data, or a
                        # sketch-pruned scan's surviving files — so
                        # re-project and credit the difference:
                        # admission control charges only what the plan
                        # will actually stage. Already-resident index
                        # segments are bytes this query will never
                        # stage either: credit them back too, so queued
                        # queries coalesce onto the warm cache.
                        index_scans = self._index_scans(plan)
                        reproject = max(
                            0, ent.footprint
                            - _footprint.projected_bytes(plan))
                        roots = set()
                        for _name, _key, scan_roots in index_scans:
                            roots |= scan_roots
                        try:
                            resident = (_segcache.get_cache()
                                        .resident_bytes_for_roots(roots))
                        except Exception:
                            resident = 0
                        reproj, credited = self._credit(ent, reproject,
                                                        resident)
                        if reproj:
                            metrics.event("serve",
                                          "footprint_reprojected",
                                          query_id=query_id,
                                          credited_bytes=reproj)
                        if credited:
                            metrics.event("serve", "footprint_credit",
                                          query_id=query_id,
                                          credited_bytes=credited)
                    # Inter-query batched execution (`engine/batcher.py`):
                    # concurrent same-signature point/filter queries
                    # coalesce into one batched predicate evaluation over
                    # the shared scan. None = ineligible shape, nothing
                    # to coalesce with, or batch-lane fallback — the
                    # per-query resilient path below stays the general
                    # executor (and the fallback target).
                    batch = None
                    if conf is not None and conf.serve_batch_enabled:
                        from hyperspace_tpu_torch.engine import batcher
                        batch = batcher.get_batcher().try_collect(
                            df, plan, metrics, conf, deadline, self)
                    if batch is None:
                        # Replica-pinned execution: under the scope,
                        # every distribution decision (fills, SPMD
                        # programs) sees the routed slice's flat
                        # submesh. The batched lane above is exempt by
                        # design: its one invocation already serves the
                        # whole cohort.
                        if ent.replica is not None:
                            metrics.event("serve", "replica",
                                          query_id=query_id,
                                          replica=ent.replica)
                        with replica_scope(ent.replica):
                            batch = self._execute_resilient(
                                df, plan, metrics, conf, index_scans)
                    if _cuda_initialized():
                        # Query-end device-memory watermark, inside the
                        # recording so it attributes here. Throttled,
                        # unlike the JAX package's forced sample: a card
                        # result's D2H copy has just sampled (the link
                        # record does), and a forced read of the
                        # allocator's counters per query is a cost the
                        # warm filters feel. Never a walk of the CPU
                        # lane's live tensors per query.
                        telemetry.memory.maybe_sample()
                    with telemetry.span("result:to_arrow", "link"):
                        table = to_arrow(batch)
            except QueryServingError as exc:
                self._record_serving_error(exc, metrics, conf)
                raise
            except BaseException:
                # The device calls queued before the failure ran all
                # the same: charge them and return their events.
                compilation.resolve_query(metrics)
                raise
        finally:
            self._release(ent)
        metrics.finish()
        # The bookkeeping below runs after the recorder has finished: it
        # is timed here into the `telemetry` layer of the span fold.
        # Its CPU is read on the queries that sample the CPU clock.
        sampled = metrics.cpu_sampled
        t_wall0 = time.perf_counter_ns()
        t_cpu0 = time.thread_time_ns() if sampled else 0
        try:
            telemetry.trace.fold(metrics, reg)
        except Exception:
            logger.debug("span fold failed", exc_info=True)
        # Latency anatomy: decompose the finished wall into the closed
        # segment set and stamp it on the recorder BEFORE the flight
        # ring sees it, so ring entries and slow-query dumps carry
        # their own anatomy. Decomposition failure never fails the
        # query it explains.
        if conf is None or conf.critpath_enabled:
            try:
                critical_path.stamp(metrics)
            except Exception:
                logger.debug("critical-path stamp failed",
                             exc_info=True)
        # Process-lifetime aggregates next to the per-query recorder.
        reg.counter("queries.total").inc()
        reg.counter("queries.seconds").inc(metrics.wall_s)
        reg.histogram("query.wall_s").observe(metrics.wall_s)
        # Tenant-dimensioned wall: the sampler windows this histogram
        # like `query.wall_s`, so per-tenant window p50/p99 land on
        # `/metrics` and `/timeseries` beside the global series.
        reg.histogram(f"tenant.{eff_tenant}.query_wall_s").observe(
            metrics.wall_s)
        # Sliding-window SLO: fold this wall into the burn window
        # (no-op while `serve.slo.p99.seconds` is 0) — globally AND
        # into the tenant's own window (`serve.tenant.<id>.slo.*`),
        # which the shed hook reads to name the burning tenant.
        self._slo.record(metrics.wall_s, conf)
        self._tenant_slo_for(eff_tenant).record(metrics.wall_s, conf)
        # Triggered device capture: a burn rate past 1.0 grabs a
        # device profile of the incident while it is happening (armed
        # only when `telemetry.profiler.capture.seconds` > 0; the
        # capture itself rides the profiler's background lane).
        if conf is not None and conf.profiler_capture_seconds > 0:
            try:
                from hyperspace_tpu_torch.telemetry import profiler
                profiler.maybe_capture_on_burn(
                    conf, self._slo.burn_rate(conf))
            except Exception:
                logger.debug("burn-triggered capture failed",
                             exc_info=True)
        # Per-index rule-usage mining (the drop advisor's raw signal):
        # one process counter per index a rule actually SERVED this
        # query from — `Hyperspace.index_usage()` joins these against
        # the flight ring to name indexes nothing selects anymore.
        # `rules.queries_served` counts the query once when a rule served
        # it from at least one index.
        served = False
        for use in metrics.index_usage():
            if use.get("name"):
                reg.counter(f"rules.served.{use['name']}").inc()
                served = True
        if served:
            reg.counter("rules.queries_served").inc()
        # Flight recorder: the finished recorder joins the always-on
        # ring of recent queries; a wall past the session's slowlog
        # threshold also persists a self-contained dump (metric tree +
        # registry snapshot + trace slice) for post-hoc diagnosis.
        telemetry.flight.record(metrics, conf=conf)
        if session is not None:
            session._last_query_metrics = metrics
        telemetry.trace.add_layer_time(
            "telemetry", time.perf_counter_ns() - t_wall0,
            time.thread_time_ns() - t_cpu0 if sampled else 0, reg)
        return table, metrics


def _cuda_initialized() -> bool:
    import torch
    return torch.cuda.is_initialized()


# ---------------------------------------------------------------------------
# Process-wide scheduler
# ---------------------------------------------------------------------------

_scheduler: Optional[QueryScheduler] = None
_scheduler_lock = threading.Lock()


def get_scheduler() -> QueryScheduler:
    global _scheduler
    if _scheduler is None:
        with _scheduler_lock:
            if _scheduler is None:
                _scheduler = QueryScheduler()
    return _scheduler


def set_scheduler(scheduler: QueryScheduler) -> QueryScheduler:
    """Install a specific scheduler (tests: fresh budgets/breakers)."""
    global _scheduler
    _scheduler = scheduler
    return scheduler


def reset_scheduler() -> None:
    global _scheduler
    _scheduler = None
