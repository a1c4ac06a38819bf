"""Framework exception types.

Parity: reference `HyperspaceException.scala:19` (single framework
exception), plus the typed scan-time signal the graceful-degradation
path keys on.
"""


class HyperspaceException(Exception):
    """Raised for all user-facing framework errors."""

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message


class IndexDataUnavailableError(HyperspaceException):
    """An index the optimizer selected turned out missing or unreadable
    at SCAN time (data root deleted out-of-band, files corrupt, storage
    failing past the retry policy). Raised only for rule-selected index
    scans — the serving plane (`engine/scheduler.py`) catches it and
    falls back to the source-data plan instead of failing the query,
    recording a `resilience.fallbacks` counter and a `degraded`
    decision event; repeated failures trip the per-index circuit
    breaker so a known-bad index stops re-paying the failed scan."""

    def __init__(self, message: str, index_name=None):
        super().__init__(message)
        self.index_name = index_name


class QueryServingError(HyperspaceException):
    """Base of the TYPED serving-plane errors the query scheduler
    raises (`engine/scheduler.py`). The contract: every concrete subclass
    declares `counter` — the registry counter the scheduler bumps when
    it raises the error — and appears in
    `scheduler.SERVING_ERROR_COUNTERS`, so no serving failure mode can
    exist without a scrape-able series behind it. `query_id` names the
    query for `session.cancel`/log correlation; `phase` (when set) is
    the execution phase the error interrupted (queue/scan/operator/
    stage/transfer/write) — the flight recorder and the regression
    differ's `cancellation` bucket read it."""

    counter: str = ""  # concrete subclasses MUST override

    def __init__(self, message: str, query_id=None, phase=None):
        super().__init__(message)
        self.query_id = query_id
        self.phase = phase


class QueryRejectedError(QueryServingError):
    """Admission control rejected the query OUTRIGHT: the projected
    HBM footprint does not fit the serving budget and the wait queue
    is already at `spark.hyperspace.serve.queue.depth` — backpressure
    surfaces to the caller immediately instead of piling threads up
    behind a full device."""

    counter = "serve.rejected"


class QueryCancelledError(QueryServingError):
    """The query was cooperatively cancelled (`session.cancel(id)` /
    scheduler shutdown) and stopped at the next deadline checkpoint."""

    counter = "serve.cancelled"


class QueryDeadlineExceededError(QueryCancelledError):
    """The query's deadline (`collect(timeout=...)` or
    `spark.hyperspace.serve.deadline.seconds`) expired — while queued
    or at an execution checkpoint; `phase` says which."""

    counter = "serve.deadline_exceeded"
