"""Advisor build executor — the ONE place advisor code turns a
recommendation into an index.

Builds go through the session's `CachingIndexCollectionManager.create`,
i.e. the exact transactional path a user-issued `hs.create_index`
takes: lease-based stale-writer recovery in `validate()`, optimistic
one-winner concurrency on the op-log slot in `begin()`, action reports,
and the commit-marker protocol. No other advisor module constructs an
Action — an advisor build that bypassed the lease path could corrupt an
index the moment a manual maintenance verb raced it.

Gates, in order, per run:

1. **serving pressure** — the whole run defers (`advisor.deferred`)
   while queries wait in the scheduler queue, or while admitted bytes
   exceed `spark.hyperspace.advisor.serve.headroom` of the serving HBM
   budget. Background index builds must NEVER starve admission; a
   deferred run simply retries on the next cycle.
2. **build budget** — summed ESTIMATED index bytes per run stay under
   `spark.hyperspace.advisor.build.budget.bytes`
   (`advisor.rejected_budget` past it) and at most
   `spark.hyperspace.advisor.max.builds` builds start. Signatures are
   keyed by tenant (`advisor/miner.py`), and each tenant's share of the
   run additionally stays under its own
   `spark.hyperspace.advisor.tenant.<id>.budget.bytes` when set —
   one chatty tenant cannot monopolize the build pool.
3. **the lease path** — a lost OCC race or an index that appeared
   since scoring is a clean `conflict` decision (`advisor.
   build_conflicts`), not an error: somebody else built it, the
   workload is served either way.
"""

from __future__ import annotations

import time
from typing import List, Optional

__all__ = ["AdvisorExecutor"]


class AdvisorExecutor:
    def __init__(self, session):
        self.session = session
        self.conf = session.conf

    # -- gates -------------------------------------------------------------

    def serving_pressure(self) -> Optional[str]:
        """A human-readable reason to defer every build this run, or
        None when serving is quiet enough."""
        from hyperspace_tpu_torch.engine.scheduler import get_scheduler
        try:
            p = get_scheduler().pressure()
        except Exception:
            return None
        if p.get("queue_depth", 0) > 0:
            return (f"{p['queue_depth']} queries waiting for admission")
        budget = self.conf.serve_hbm_budget_bytes
        if budget and budget > 0:
            headroom = max(0.0, min(self.conf.advisor_serve_headroom,
                                    1.0))
            if p.get("admitted_bytes", 0) > budget * headroom:
                return (f"admitted {p['admitted_bytes']} B exceeds "
                        f"{headroom:.0%} of the {budget} B serving "
                        "budget")
        return None

    # -- the build ---------------------------------------------------------

    def _exists(self, index_name: str) -> bool:
        from hyperspace_tpu_torch.constants import States
        from hyperspace_tpu_torch.facade import Hyperspace
        try:
            manager = Hyperspace.get_context(
                self.session).index_collection_manager
            return any(e.name == index_name for e in manager.get_indexes()
                       if e.state != States.DOESNOTEXIST)
        except Exception:
            return False

    def _build_one(self, config, scan) -> None:
        """One index build through the lease path (module docstring).
        Raises whatever the action raises — the caller classifies."""
        from hyperspace_tpu_torch.engine.dataframe import DataFrame
        from hyperspace_tpu_torch.facade import Hyperspace
        from hyperspace_tpu_torch.plan.nodes import Scan

        manager = Hyperspace.get_context(
            self.session).index_collection_manager
        # A fresh Scan clone: create() fingerprints and lists the
        # CURRENT source state, never the recorded plan object (whose
        # listing may be stale or pinned).
        df = DataFrame(Scan(list(scan.root_paths), scan.schema),
                       self.session)
        manager.create(df, config)

    def execute(self, candidates: List) -> List[dict]:
        """Act on ranked candidates; returns one decision dict per
        candidate (and one 'deferred' marker for the whole run when the
        serving gate trips)."""
        from hyperspace_tpu_torch import telemetry
        from hyperspace_tpu_torch.exceptions import HyperspaceException

        reg = telemetry.get_registry()
        decisions: List[dict] = []
        if not candidates:
            return decisions
        pressure = self.serving_pressure()
        if pressure is not None:
            reg.counter("advisor.deferred").inc()
            return [{"name": c.name, "action": "deferred",
                     "reason": pressure, "score": c.score}
                    for c in candidates]

        budget = self.conf.advisor_build_budget_bytes
        max_builds = max(0, self.conf.advisor_max_builds)
        spent = 0
        tenant_spent: dict = {}
        builds = 0
        for cand in candidates:
            tenant = getattr(cand.signature, "tenant", None) or "default"
            decision = {"name": cand.name, "kind": cand.kind,
                        "score": cand.score, "tenant": tenant,
                        "est_index_bytes": cand.est_index_bytes,
                        "decided_at": round(time.time(), 3)}
            if builds + len(cand.configs) > max_builds:
                decision.update(action="skipped",
                                reason=f"max.builds={max_builds} "
                                       "reached this run")
                decisions.append(decision)
                continue
            if budget > 0 and spent + cand.est_index_bytes > budget:
                reg.counter("advisor.rejected_budget").inc()
                decision.update(
                    action="rejected_budget",
                    reason=f"estimated {cand.est_index_bytes} B would "
                           f"exceed the {budget} B build budget "
                           f"({spent} B already committed this run)")
                decisions.append(decision)
                continue
            # Per-tenant build budget: the miner keys signatures by
            # tenant, so each candidate bills exactly one tenant;
            # `advisor.tenant.<id>.budget.bytes` caps what one tenant's
            # workload can spend per run without starving the others
            # out of the shared `build.budget.bytes` pool (0 = no
            # per-tenant cap; the global budget still applies).
            t_budget = self.conf.advisor_tenant_budget_bytes(tenant)
            t_spent = tenant_spent.get(tenant, 0)
            if t_budget > 0 and t_spent + cand.est_index_bytes > t_budget:
                reg.counter("advisor.rejected_budget").inc()
                reg.counter(
                    f"advisor.tenant.{tenant}.rejected_budget").inc()
                decision.update(
                    action="rejected_budget",
                    reason=f"estimated {cand.est_index_bytes} B would "
                           f"exceed tenant '{tenant}'s {t_budget} B "
                           f"build budget ({t_spent} B already "
                           "committed this run)")
                decisions.append(decision)
                continue
            try:
                built_names = []
                for config, scan in zip(cand.configs, cand.scans):
                    if self._exists(config.index_name):
                        # Half-built pair from an interrupted prior run,
                        # or a manual build: finish the missing side(s)
                        # instead of refusing the whole candidate.
                        continue
                    self._build_one(config, scan)
                    builds += 1
                    built_names.append(config.index_name)
                spent += cand.est_index_bytes
                tenant_spent[tenant] = t_spent + cand.est_index_bytes
                if built_names:
                    reg.counter("advisor.builds").inc(len(built_names))
                    decision.update(action="built", indexes=built_names)
                else:
                    decision.update(action="exists",
                                    reason="every index of the "
                                           "candidate already exists")
            except HyperspaceException as exc:
                # Lost the op-log slot / index appeared since scoring:
                # the lease path kept the catalog consistent; somebody
                # else owns the build. Clean concede.
                reg.counter("advisor.build_conflicts").inc()
                decision.update(action="conflict", reason=str(exc))
            except Exception as exc:  # noqa: BLE001 — classified below
                reg.counter("advisor.build_failures").inc()
                decision.update(action="failed", reason=repr(exc))
            decisions.append(decision)
            telemetry.event("advisor", "decision",
                            candidate=decision.get("name"),
                            action=decision.get("action"),
                            score=decision.get("score"))
        return decisions
