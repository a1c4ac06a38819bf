"""Self-driving index advisor: close the loop from observed workload to
recommended index to background build.

The Hyperspace plan-analysis layer stops at explain / what-if over
hypothetical indexes (PAPER.md §"whatIf"); this engine has something
Hyperspace never shipped — an always-on flight recorder holding every
query's operator tree, rule decisions (including the structured whyNot
records both rewrite rules emit on every decline), and pruning stats.
The advisor closes the loop in three stages, one module each:

- **miner** (`advisor/miner.py`): polls the flight ring INCREMENTALLY
  (`FlightRecorder.snapshot(since_seq)` — one lock acquire per poll,
  nothing re-read) and distills recurring (relation, filter-cols,
  join-cols) workload signatures from the whyNot events, with observed
  repeat counts and per-relation scan bytes.
- **what-if scorer** (`advisor/whatif.py`): synthesizes hypothetical
  covering (and data-skipping) index candidates per signature, REPLAYS
  the recorded logical plans through the real rewrite rules against a
  hypothetical catalog (no data touched — the same rule code that will
  serve the real index decides whether the candidate would fire), and
  scores candidates by estimated bytes avoided amortized over the
  observed frequency.
- **executor** (`advisor/executor.py`): auto-builds the top-scoring
  candidates through the NORMAL index-creation path (the collection
  manager's Create actions — maintenance lease, OCC one-winner races,
  action reports all apply; no other advisor module builds),
  gated by serving pressure (never starve admission), a per-warehouse
  build budget, and a per-run build cap; every recommendation,
  decision, and build lands in `advisor.*` counters and the persisted
  `_advisor_state.json`.

Surface: `Hyperspace.advisor()` returns the session's `IndexAdvisor`;
`run_once()` is one mine→score→build cycle, `start(interval_s)` runs
it on a background daemon thread. `spark.hyperspace.advisor.*` knobs
(`constants.py`) size the budgets; `advisor.enabled=false` makes the
executor a no-op while mining keeps measuring.
"""

from __future__ import annotations

import json
import threading
import time
from typing import List, Optional

from hyperspace_tpu_torch.advisor.executor import AdvisorExecutor
from hyperspace_tpu_torch.advisor.miner import WorkloadMiner, WorkloadSignature
from hyperspace_tpu_torch.advisor.whatif import Candidate, score_signatures

__all__ = ["IndexAdvisor", "WorkloadMiner", "WorkloadSignature",
           "Candidate", "score_signatures", "AdvisorExecutor",
           "STATE_FILE"]

STATE_FILE = "_advisor_state.json"


class IndexAdvisor:
    """One session's advisor: a miner cursor over the process flight
    ring, the what-if scorer, and the build executor. `run_once()` is
    deterministic over a fixed recorded workload (the determinism test
    pins this): same ring contents → same ranked recommendations."""

    def __init__(self, session):
        self.session = session
        self.conf = session.conf
        self.miner = WorkloadMiner(min_repeats=self.conf.advisor_min_repeats)
        self.executor = AdvisorExecutor(session)
        self._lock = threading.Lock()
        self._recommendations: List[Candidate] = []
        self._decisions: List[dict] = []
        self._daemon: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- the mine -> score -> build cycle ---------------------------------

    def observe(self) -> int:
        """Incremental mine of the flight ring; returns how many new
        queries were folded in."""
        from hyperspace_tpu_torch import telemetry
        mined = self.miner.poll()
        if mined:
            telemetry.get_registry().counter(
                "advisor.queries_mined").inc(mined)
        return mined

    def recommendations(self) -> List[Candidate]:
        """Ranked candidates of the latest scoring pass (best first)."""
        with self._lock:
            return list(self._recommendations)

    def decisions(self) -> List[dict]:
        with self._lock:
            return list(self._decisions)

    def run_once(self) -> dict:
        """One full advisor cycle: poll the ring, what-if score the
        recurring signatures, build what wins (unless disabled or
        deferred), persist `_advisor_state.json`. Returns a summary
        dict (also the shape persisted per run)."""
        from hyperspace_tpu_torch import telemetry

        reg = telemetry.get_registry()
        reg.counter("advisor.runs").inc()
        with self._lock:
            mined = self.miner.poll()
            if mined:
                reg.counter("advisor.queries_mined").inc(mined)
            signatures = self.miner.recurring()
            reg.gauge("advisor.signatures").set(len(signatures))
            candidates = score_signatures(self.session, signatures,
                                          self.conf)
            reg.counter("advisor.candidates").inc(len(candidates))
            recommended = [c for c in candidates if c.score > 0
                           and c.score
                           >= self.conf.advisor_min_benefit_bytes]
            reg.gauge("advisor.recommended").set(len(recommended))
            self._recommendations = recommended
            if self.conf.advisor_enabled:
                decisions = self.executor.execute(recommended)
            else:
                decisions = [{"name": c.name, "action": "disabled",
                              "reason": "spark.hyperspace.advisor."
                                        "enabled=false"}
                             for c in recommended]
            self._decisions.extend(decisions)
            summary = {
                "ran_at": round(time.time(), 3),
                "queries_mined": mined,
                "last_seq": self.miner.last_seq,
                "signatures": [s.to_dict() for s in signatures],
                "recommendations": [c.to_dict() for c in recommended],
                "decisions": decisions,
                "skipping_drift": self.skipping_drift(),
            }
            self._persist(summary)
        telemetry.event("advisor", "run",
                        signatures=len(signatures),
                        recommended=len(recommended),
                        built=sum(1 for d in decisions
                                  if d.get("action") == "built"))
        return summary

    def skipping_drift(self) -> dict:
        """How far reality drifted from the what-if scorer's blind
        constant: the scorer assumes every skipping index prunes
        `spark.hyperspace.advisor.skipping.prune.fraction` of a scan,
        while `FilterIndexRule` records the MEASURED fraction of every
        served query (`skipping.measured_prune_fraction` histogram +
        per-index gauges). The loop is CLOSED: `whatif.py` now scores
        skipping candidates with the measured fraction (per-index
        gauge first, then the global mean) and falls back to the
        assumption only before anything has been measured —
        `scoring_source` here says which one the next scoring pass
        will use, and each candidate's
        `detail["prune_fraction_source"]` records which one it DID
        use."""
        from hyperspace_tpu_torch import telemetry

        assumed = self.conf.advisor_skipping_prune_fraction
        out: dict = {"assumed_fraction": assumed,
                     "measured_mean_fraction": None,
                     "queries_measured": 0, "drift": None,
                     "scoring_source": "assumed",
                     "per_index": {}}
        snap = telemetry.get_registry().series_snapshot()
        hist = snap.get("histograms", {}).get(
            "skipping.measured_prune_fraction")
        if hist and hist.get("count"):
            mean = hist["sum"] / hist["count"]
            out["measured_mean_fraction"] = round(mean, 4)
            out["queries_measured"] = hist["count"]
            out["drift"] = round(mean - assumed, 4)
            out["scoring_source"] = "measured"
        for name, value in snap.get("gauges", {}).items():
            if name.startswith("skipping.") and \
                    name.endswith(".measured_prune_fraction"):
                index = name[len("skipping."):
                             -len(".measured_prune_fraction")]
                out["per_index"][index] = round(value, 4)
        return out

    def report(self) -> dict:
        """One human-facing advisor report: the latest ranked
        recommendations and decisions, the skipping-drift story, and
        the per-index usage rows (`Hyperspace.index_usage`) with their
        `unused` drop candidates — each section error-isolated, so a
        mid-teardown subsystem degrades to an `{"error": ...}` stub
        instead of failing the whole read. Report-only: nothing is
        built or vacuumed by asking."""
        doc: dict = {"generated_at": round(time.time(), 3)}

        def section(name, fn):
            try:
                doc[name] = fn()
            except Exception as exc:
                doc[name] = {"error": repr(exc)}

        def _usage():
            from hyperspace_tpu_torch.facade import Hyperspace
            rows = Hyperspace(self.session).index_usage()
            return {"indexes": rows,
                    "unused": [r["index"] for r in rows if r["unused"]]}

        section("recommendations",
                lambda: [c.to_dict() for c in self.recommendations()])
        section("decisions", self.decisions)
        section("skipping_drift", self.skipping_drift)
        section("index_usage", _usage)
        return doc

    # -- persisted state ---------------------------------------------------

    def _state_path(self) -> str:
        from hyperspace_tpu_torch.utils import storage
        return storage.join(self.conf.system_path, STATE_FILE)

    def _persist(self, summary: dict) -> None:
        """Atomic single-file state: the latest run summary plus the
        decision history — what a fresh process (or an operator asking
        "why did you build that?") reads back. A persistence failure
        never fails the run (counted `advisor.state_errors`)."""
        from hyperspace_tpu_torch import telemetry
        from hyperspace_tpu_torch.utils import file_utils
        doc = {
            "kind": "hyperspace-advisor-state",
            "version": 1,
            "updated_at": summary["ran_at"],
            "last_seq": summary["last_seq"],
            "last_run": summary,
            "decision_history": self._decisions[-200:],
        }
        try:
            file_utils.create_directory(self.conf.system_path)
            file_utils.atomic_publish(self._state_path(),
                                      json.dumps(doc, default=str,
                                                 indent=1))
        except Exception:
            telemetry.get_registry().counter(
                "advisor.state_errors").inc()

    def state(self) -> Optional[dict]:
        """Reload the persisted advisor state, or None."""
        from hyperspace_tpu_torch.utils import file_utils
        try:
            raw = file_utils.load_byte_array(self._state_path())
        except Exception:
            return None
        try:
            return json.loads(raw)
        except Exception:
            return None

    # -- background mode ---------------------------------------------------

    def start(self, interval_s: float = 60.0) -> None:
        """Run `run_once` on a background daemon thread every
        `interval_s` seconds until `stop()`. Idempotent. The thread
        lives in advisor/, not engine/ — it issues no queries, only
        maintenance builds, which the serving-pressure gate makes yield
        to live traffic."""
        if self._daemon is not None and self._daemon.is_alive():
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.run_once()
                except Exception:
                    from hyperspace_tpu_torch import telemetry
                    telemetry.get_registry().counter(
                        "advisor.run_errors").inc()

        self._daemon = threading.Thread(target=loop, name="hs-advisor",
                                        daemon=True)
        self._daemon.start()

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        daemon, self._daemon = self._daemon, None
        if daemon is not None:
            daemon.join(timeout=timeout_s)
