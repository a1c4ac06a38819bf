"""Seedable, plan-driven fault injection for the storage seam and the
action FSM.

The resilience layer (`utils/retry.py`, crash recovery, graceful query
degradation) is only as good as the failure paths a test can actually
reach — so the injector is wired into the SAME seams production traffic
crosses: every `file_utils` primitive, `storage.exclusive_create`, the
parquet read/write entry points, each Action phase boundary
(`action.<Class>.<phase>` fires just before validate/begin/op/end runs —
a "crash" there is an abort BETWEEN phases, exactly the stranded-writer
scenario CancelAction/lease recovery must unwind), and the execution
plane's serving seams: `transfer.put` (every host->device link
crossing, `io/transfer.py`), `fusion.stage` (fused-stage entry,
`engine/fusion.py`), `batch.execute` (the batched lane's shared
execution, `engine/batcher.py`), and the scheduler boundaries
`scheduler.admit` / `scheduler.run` (`engine/scheduler.py`) the chaos
harness drives concurrent query traffic against.

A `FaultPlan` is just a list of `FaultRule`s: fail the `nth` call whose
operation matches an fnmatch pattern (optionally path-filtered), `times`
consecutive matches (-1 = forever), with a `kind`:

- `transient` -> raises `InjectedTransientError` (a ConnectionError, so
  the retry seam classifies and retries it);
- `permanent` -> raises `InjectedPermanentError` (never retried);
- `torn`      -> the call site that supports tearing writes a PREFIX of
  the payload then raises `TornWriteError` (partial bytes LAND, like a
  writer dying mid-write); sites without torn support treat it as
  transient;
- `crash`     -> raises `InjectedCrash`, a BaseException — no
  `except Exception` guard in the stack can swallow it, simulating
  process death at that instant.

Probabilistic rules (`probability=`) draw from a `random.Random(seed)`
owned by the injector, so a chaos run replays exactly. When no injector
is installed, `fire()` is one global read + None check — the always-off
cost at every seam.

Tests arm it through a fixture that uninstalls it on teardown.
"""

from __future__ import annotations

import fnmatch
import random
import threading
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple


class InjectedTransientError(ConnectionError):
    """A retryable injected failure (classified transient by retry.py)."""


class TornWriteError(InjectedTransientError):
    """A write that left partial bytes behind; a fresh attempt rewrites
    the payload in full, so the retry seam treats it as transient."""


class InjectedPermanentError(RuntimeError):
    """A non-retryable injected failure."""


class InjectedCrash(BaseException):
    """Simulated process death — deliberately NOT an Exception so no
    best-effort `except Exception` guard can absorb it."""


TORN = "torn"
_KINDS = ("transient", "permanent", "torn", "crash")


@dataclass
class FaultRule:
    """Fail calls whose operation (and optional path) match. Counting is
    per rule: the `nth` matching call (1-based) starts firing, `times`
    consecutive matches fire (-1 = forever). With `probability` set, each
    matching call past warm-up fires with that chance instead (seeded by
    the injector), still bounded by `times`."""

    operation: str
    kind: str = "transient"
    nth: int = 1
    times: int = 1
    path: Optional[str] = None
    probability: Optional[float] = None
    # runtime counters (owned by the installing injector's lock)
    calls: int = field(default=0, compare=False)
    fired: int = field(default=0, compare=False)

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"Unknown fault kind: {self.kind!r} "
                             f"(use one of {_KINDS})")


class FaultInjector:
    """Holds a fault plan plus the audit log of everything it fired."""

    def __init__(self, rules: Sequence[FaultRule] = (), seed: int = 0):
        self.rules: List[FaultRule] = list(rules)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.log: List[Tuple[str, Optional[str], str]] = []

    def add(self, rule: FaultRule) -> "FaultInjector":
        with self._lock:
            self.rules.append(rule)
        return self

    def fired(self, operation_pattern: str = "*") -> int:
        """How many injections matching `operation_pattern` have fired."""
        with self._lock:
            return sum(1 for op, _p, _k in self.log
                       if fnmatch.fnmatchcase(op, operation_pattern))

    def check(self, operation: str, path: Optional[str] = None):
        """Evaluate the plan for one seam crossing: raises the injected
        error, returns `TORN` for a cooperative torn write, or returns
        None (no fault)."""
        directive = None
        with self._lock:
            for rule in self.rules:
                if not fnmatch.fnmatchcase(operation, rule.operation):
                    continue
                if rule.path is not None and (
                        path is None
                        or not fnmatch.fnmatchcase(path, rule.path)):
                    continue
                rule.calls += 1
                if rule.times >= 0 and rule.fired >= rule.times:
                    continue
                if rule.calls < rule.nth:
                    continue
                if rule.probability is not None \
                        and self._rng.random() >= rule.probability:
                    continue
                rule.fired += 1
                self.log.append((operation, path, rule.kind))
                directive = rule.kind
                break
        if directive is None:
            return None
        self._count_injection()
        message = f"injected {directive} fault at {operation}" \
                  + (f" ({path})" if path else "")
        if directive == "transient":
            raise InjectedTransientError(message)
        if directive == "permanent":
            raise InjectedPermanentError(message)
        if directive == "crash":
            raise InjectedCrash(message)
        return TORN

    @staticmethod
    def _count_injection() -> None:
        try:
            from hyperspace_tpu_torch import telemetry
            telemetry.get_registry().counter("faults.injected").inc()
        except Exception:
            pass


_active: Optional[FaultInjector] = None


def install(injector: FaultInjector) -> FaultInjector:
    global _active
    _active = injector
    return injector


def uninstall() -> None:
    global _active
    _active = None


def active() -> Optional[FaultInjector]:
    return _active


def fire(operation: str, path: Optional[str] = None):
    """The seam hook: no-op unless an injector is installed. Returns
    `TORN` when the call site should tear its write; raises the injected
    error otherwise."""
    injector = _active
    if injector is None:
        return None
    return injector.check(operation, path)
