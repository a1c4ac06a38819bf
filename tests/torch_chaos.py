"""Chaos harness for the PyTorch port's serving plane: `tests/chaos.py`
with the port's typed errors — K client threads, a mixed query
workload, typed-outcome accounting, and deadlock detection.

Not a test module — the port's serving tests and `chip_smoke.py`'s
chaos lap drive it. The harness is
deliberately dumb: it runs queries on plain threads and RECORDS what
happened; every invariant (no deadlock, budget respected, correctness,
telemetry isolation, counter/outcome agreement) is asserted by the
caller against the returned `ChaosReport`, so a failure names the
invariant, not the harness.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple


def canonical(table):
    """Row-order-insensitive canonical form of an Arrow table (every
    correctness comparison here is set-of-rows equality — the engine
    guarantees deterministic CONTENT, not row order, under
    concurrency)."""
    return table.sort_by([(n, "ascending") for n in table.schema.names])


class ChaosReport:
    """Everything the chaos run observed, for the caller to assert on."""

    def __init__(self):
        self.outcomes: Dict[str, int] = {
            "ok": 0, "rejected": 0, "deadline": 0, "cancelled": 0,
            "injected": 0, "error": 0}
        self.latencies: List[float] = []
        self.mismatches: List[str] = []
        self.errors: List[str] = []
        self.success_metrics: List = []   # QueryMetrics of ok queries
        self.typed_phases: List[str] = []  # phase of each typed failure
        self.stuck_threads: List[str] = []
        self.wall_s: float = 0.0

    @property
    def total(self) -> int:
        return sum(self.outcomes.values())

    def summary(self) -> str:
        return (f"{self.total} queries in {self.wall_s:.2f}s: "
                + ", ".join(f"{k}={v}" for k, v in self.outcomes.items()
                            if v)
                + (f"; {len(self.mismatches)} mismatches"
                   if self.mismatches else ""))


def run_chaos(workload: List[Tuple[str, object]],
              expected: Dict[str, object],
              clients: int,
              total_queries: int,
              timeout_for: Optional[Callable[[int], Optional[float]]]
              = None,
              join_timeout_s: float = 120.0) -> ChaosReport:
    """Drive `total_queries` from `workload` (list of (name, DataFrame))
    across `clients` closed-loop threads. `expected` maps name ->
    canonical serial-run table (the correctness oracle).
    `timeout_for(i)` optionally assigns a per-query deadline by global
    query index. Threads that fail to join within `join_timeout_s` are
    reported in `stuck_threads` — the caller's deadlock assertion."""
    from hyperspace_tpu_torch.exceptions import (QueryCancelledError,
                                                 QueryDeadlineExceededError,
                                                 QueryRejectedError,
                                                 QueryServingError)
    from hyperspace_tpu_torch.utils.faults import (InjectedPermanentError,
                                                   InjectedTransientError)

    report = ChaosReport()
    next_q = [0]
    lock = threading.Lock()

    def client():
        while True:
            with lock:
                if next_q[0] >= total_queries:
                    return
                qi = next_q[0]
                next_q[0] += 1
            name, df = workload[qi % len(workload)]
            timeout = timeout_for(qi) if timeout_for is not None else None
            t0 = time.perf_counter()
            try:
                table, metrics = df.collect(with_metrics=True,
                                            timeout=timeout)
            except QueryRejectedError as exc:
                with lock:
                    report.outcomes["rejected"] += 1
                    report.typed_phases.append(exc.phase or "?")
                continue
            except QueryDeadlineExceededError as exc:
                with lock:
                    report.outcomes["deadline"] += 1
                    report.typed_phases.append(exc.phase or "?")
                continue
            except QueryCancelledError as exc:
                with lock:
                    report.outcomes["cancelled"] += 1
                    report.typed_phases.append(exc.phase or "?")
                continue
            except (InjectedTransientError, InjectedPermanentError) as exc:
                # An injected fault that escaped retry/degradation: a
                # legitimate failed query (the injector aimed past the
                # resilience layers), NOT a serving defect.
                with lock:
                    report.outcomes["injected"] += 1
                    report.errors.append(f"{name}: {exc!r}")
                continue
            except QueryServingError as exc:  # pragma: no cover
                with lock:
                    report.outcomes["error"] += 1
                    report.errors.append(f"{name}: untyped serving "
                                         f"path? {exc!r}")
                continue
            except Exception as exc:
                with lock:
                    report.outcomes["error"] += 1
                    report.errors.append(f"{name}: {exc!r}")
                continue
            wall = time.perf_counter() - t0
            ok = canonical(table).equals(expected[name])
            with lock:
                report.outcomes["ok"] += 1
                report.latencies.append(wall)
                report.success_metrics.append(metrics)
                if not ok:
                    report.mismatches.append(
                        f"{name} (query {qi}): result differs from "
                        "serial run")

    threads = [threading.Thread(target=client, name=f"chaos-{c}",
                                daemon=True)
               for c in range(clients)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    deadline_t = time.monotonic() + join_timeout_s
    for th in threads:
        th.join(timeout=max(0.0, deadline_t - time.monotonic()))
        if th.is_alive():
            report.stuck_threads.append(th.name)
    report.wall_s = time.perf_counter() - t0
    return report
