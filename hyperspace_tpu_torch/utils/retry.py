"""THE storage-IO retry seam: one policy point for every backoff in the
package.

The paper's design premise is that all index data AND metadata live on
the lake with no catalog service (PAPER.md; cf. Delta Lake's lake-resident
log protocol) — every correctness guarantee rides on storage calls that
can fail transiently. Before this module, retry logic existed as ad-hoc
inline loops (the log manager's torn-read loop, the S3 409 conflict loop)
that no test exercised; now every retry routes through `call()` under one
configurable `RetryPolicy`, and `scripts/check_metrics_coverage.py` fails
the build if a `time.sleep` inside an `except` block appears anywhere
else in the package.

Policy: exponential backoff (`base_ms * 2**retry`, capped at `max_ms`)
with DETERMINISTIC jitter — a hash of (operation, attempt) spreads
concurrent writers without nondeterminism, so a seeded fault-injection
run replays byte-identically. Conf knobs (session-scoped):
`spark.hyperspace.io.retry.{attempts,base.ms,max.ms}`.

Classification is TYPED, transient-vs-permanent:

- transient (retried): ConnectionError/TimeoutError/InterruptedError
  families, OSErrors whose errno says "try again" (EAGAIN/EBUSY/EIO/...),
  exceptions carrying an HTTP status of 408/409/429/5xx (fsspec
  object-store backends flatten server errors into such shapes), and any
  caller-supplied `retryable` types/predicate (e.g. the log reader's
  torn-read JSONDecodeError);
- permanent (raised immediately): everything else — not-found,
  permission, 4xx, programming errors. Misclassifying permanent as
  transient turns a clean failure into attempts× the latency, so the
  default answer is "permanent".

Observability: every retry increments the process registry counter
`io.retries` and emits a `resilience: retry` decision event on the
active `QueryMetrics`; exhausting the policy increments `io.giveups`
and emits `resilience: giveup` before re-raising the last error.
"""

from __future__ import annotations

import errno
import hashlib
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Tuple, Union

from hyperspace_tpu_torch import constants

# errno values that mean "the operation may succeed if simply re-issued".
_TRANSIENT_ERRNOS = frozenset({
    errno.EAGAIN, errno.EBUSY, errno.EINTR, errno.EIO, errno.ETIMEDOUT,
    errno.ECONNRESET, errno.ECONNABORTED, errno.ECONNREFUSED,
    errno.ENETUNREACH, errno.ENETRESET, errno.EHOSTUNREACH,
    errno.EPIPE, errno.ESTALE,
})

# Typed families that are transient by construction. NOTE: FileNotFoundError,
# PermissionError, FileExistsError etc. are OSError subclasses but carry
# errnos outside _TRANSIENT_ERRNOS, so they classify permanent below.
_TRANSIENT_TYPES = (ConnectionError, TimeoutError, InterruptedError)

_TRANSIENT_HTTP = frozenset({408, 409, 429, 500, 502, 503, 504})


def _http_status(exc: Exception) -> Optional[int]:
    """HTTP status carried by `exc`, across the attr spellings fsspec
    backends use (same shapes `storage._is_precondition_failure` reads)."""
    for attr in ("code", "status", "status_code"):
        value = getattr(exc, attr, None)
        if isinstance(value, int):
            return value
    response = getattr(exc, "response", None)  # botocore ClientError shape
    if isinstance(response, dict):
        meta = response.get("ResponseMetadata") or {}
        status = meta.get("HTTPStatusCode")
        if isinstance(status, int):
            return status
    return None


def is_transient(exc: Exception) -> bool:
    """Typed transient-vs-permanent classification (module docstring)."""
    if isinstance(exc, _TRANSIENT_TYPES):
        return True
    if isinstance(exc, OSError) and exc.errno in _TRANSIENT_ERRNOS:
        return True
    status = _http_status(exc)
    return status in _TRANSIENT_HTTP


def _jitter(operation: str, attempt: int) -> float:
    """[0, 1) jitter, deterministic in (operation, attempt) — replayable
    under seeded fault injection, yet decorrelated across operations."""
    digest = hashlib.blake2b(f"{operation}#{attempt}".encode(),
                             digest_size=4).digest()
    return int.from_bytes(digest, "big") / 2 ** 32


@dataclass(frozen=True)
class RetryPolicy:
    """attempts = TOTAL tries (>=1); delays double from base_ms, capped at
    max_ms, scaled by 0.5 + 0.5*jitter. `clock`/`sleep` are injectable so
    tests assert backoff schedules without wall-clock waits."""

    attempts: int = constants.IO_RETRY_ATTEMPTS_DEFAULT
    base_ms: float = constants.IO_RETRY_BASE_MS_DEFAULT
    max_ms: float = constants.IO_RETRY_MAX_MS_DEFAULT
    clock: Callable[[], float] = field(default=time.monotonic, repr=False)
    sleep: Callable[[float], None] = field(default=time.sleep, repr=False)

    def delay_s(self, operation: str, attempt: int) -> float:
        """Backoff before try `attempt+1` (attempt is the 1-based try that
        just failed)."""
        raw = min(self.base_ms * (2 ** (attempt - 1)), self.max_ms)
        return raw * (0.5 + 0.5 * _jitter(operation, attempt)) / 1000.0


DEFAULT_POLICY = RetryPolicy()


def policy_for(conf=None) -> RetryPolicy:
    """RetryPolicy from a HyperspaceConf (None -> package defaults)."""
    if conf is None:
        return DEFAULT_POLICY
    try:
        return RetryPolicy(attempts=conf.io_retry_attempts,
                           base_ms=conf.io_retry_base_ms,
                           max_ms=conf.io_retry_max_ms)
    except Exception:
        # A conf-shaped object without the retry properties (test fakes):
        # defaults, not a crash on the IO path.
        return DEFAULT_POLICY


Retryable = Union[Sequence[type], Tuple[type, ...],
                  Callable[[Exception], bool], None]


def _should_retry(exc: Exception, retryable: Retryable) -> bool:
    if retryable is not None:
        if callable(retryable) and not isinstance(retryable, type):
            if retryable(exc):
                return True
        elif isinstance(exc, tuple(retryable)):
            return True
    return is_transient(exc)


def call(fn: Callable, *, operation: str,
         policy: Optional[RetryPolicy] = None, conf=None,
         retryable: Retryable = None):
    """Run `fn()` under the retry policy. `operation` names the IO for
    counters, decision events, and the deterministic jitter stream.
    `retryable` extends the typed transient classification with extra
    exception types or a predicate (it can only ADD retries, never
    suppress one). Exceptions that classify permanent — and BaseExceptions
    like an injected crash — propagate on the first failure."""
    pol = policy if policy is not None else policy_for(conf)
    attempts = max(1, int(pol.attempts))
    last: Optional[Exception] = None
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except Exception as exc:
            last = exc
            if attempt >= attempts or not _should_retry(exc, retryable):
                if attempt > 1:
                    _record_giveup(operation, attempt, exc)
                raise
            delay = pol.delay_s(operation, attempt)
            _record_retry(operation, attempt, delay, exc)
            pol.sleep(delay)
    raise last  # unreachable; keeps the type checker honest


def _record_retry(operation: str, attempt: int, delay_s: float,
                  exc: Exception) -> None:
    try:
        from hyperspace_tpu_torch import telemetry
        telemetry.get_registry().counter("io.retries").inc()
        telemetry.event("resilience", "retry", operation=operation,
                        attempt=attempt, delay_ms=round(delay_s * 1000, 3),
                        error=repr(exc))
    except Exception:
        pass  # observability must never fail the IO it observes


def _record_giveup(operation: str, attempts: int, exc: Exception) -> None:
    try:
        from hyperspace_tpu_torch import telemetry
        telemetry.get_registry().counter("io.giveups").inc()
        telemetry.event("resilience", "giveup", operation=operation,
                        attempts=attempts, error=repr(exc))
    except Exception:
        pass
