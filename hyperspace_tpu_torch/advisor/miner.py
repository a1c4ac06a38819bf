"""Workload miner: distill recurring index opportunities from the
flight ring.

The ring holds finished `QueryMetrics` — each carries its SOURCE
logical plan (the scheduler attaches it) and a monotonic `flight_seq`.
The miner polls incrementally (`FlightRecorder.snapshot(since_seq)`)
and reads three signal families out of each new query:

- the rewrite rules' structured whyNot events: `FilterIndexRule
  skipped` carries the scan roots, predicate columns (and which of them
  are point equalities — bucket pruning only helps those) and the
  projected column set; `JoinIndexRule skipped ("no usable/compatible
  index pair")` carries per-side roots, join keys, and referenced
  columns. A query that a rule already SERVED contributes no miss — an
  existing index is doing its job.
- per-scan telemetry: `bytes_scanned` / `files_scanned` on the Scan
  operator records, attributed to their roots — the cost the candidate
  would amortize.
- repeat counts: misses aggregate into `WorkloadSignature`s keyed by
  (kind, relation root(s), filter/join columns, projected columns); a
  signature below `spark.hyperspace.advisor.min.repeats` observations
  is noise, not workload.

Everything here is read-only over already-recorded data: no IO, no
plan execution, no lock held beyond the ring's snapshot copy.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

__all__ = ["WorkloadMiner", "WorkloadSignature"]


class WorkloadSignature:
    """One recurring workload shape the advisor can act on.

    kind="filter": `roots` is the scanned relation, `filter_columns` /
    `eq_columns` / `project_columns` describe the recurring predicate
    shape. kind="join": `roots`/`join_columns`/`referenced_columns` and
    the `right_*` twins describe the two sides. `plan` is the most
    recently recorded source logical plan exhibiting the shape — the
    what-if scorer's replay input."""

    __slots__ = ("kind", "key", "roots", "right_roots", "filter_columns",
                 "eq_columns", "project_columns", "join_columns",
                 "right_join_columns", "referenced_columns",
                 "right_referenced_columns", "count", "total_scan_bytes",
                 "last_seq", "plan", "tenant")

    def __init__(self, kind: str, key: tuple):
        self.kind = kind
        self.key = key
        # The tenant whose queries exhibit the shape: signatures are
        # KEYED by tenant, so two tenants' identical misses stay
        # separate candidates — the executor budgets each against its
        # own `advisor.tenant.<id>.budget.bytes`.
        self.tenant: str = "default"
        self.roots: Tuple[str, ...] = ()
        self.right_roots: Tuple[str, ...] = ()
        self.filter_columns: Tuple[str, ...] = ()
        self.eq_columns: Tuple[str, ...] = ()
        self.project_columns: Tuple[str, ...] = ()
        self.join_columns: Tuple[str, ...] = ()
        self.right_join_columns: Tuple[str, ...] = ()
        self.referenced_columns: Tuple[str, ...] = ()
        self.right_referenced_columns: Tuple[str, ...] = ()
        self.count = 0
        self.total_scan_bytes = 0
        self.last_seq = 0
        self.plan = None

    @property
    def mean_scan_bytes(self) -> int:
        return self.total_scan_bytes // self.count if self.count else 0

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "roots": list(self.roots),
            "right_roots": list(self.right_roots) or None,
            "filter_columns": list(self.filter_columns) or None,
            "eq_columns": list(self.eq_columns) or None,
            "project_columns": list(self.project_columns) or None,
            "join_columns": list(self.join_columns) or None,
            "count": self.count,
            "total_scan_bytes": self.total_scan_bytes,
            "last_seq": self.last_seq,
            "tenant": self.tenant,
        }


def _scan_bytes_by_root(metrics) -> Dict[str, int]:
    """{root: summed bytes_scanned} over the query's Scan operator
    records (first root wins attribution for multi-root scans — good
    enough for amortization)."""
    out: Dict[str, int] = {}
    for op in getattr(metrics, "operators", ()):
        if op.name != "Scan":
            continue
        roots = op.detail.get("roots") or ()
        nbytes = op.detail.get("bytes_scanned")
        if not roots or not isinstance(nbytes, (int, float)):
            continue
        root = roots[0]
        out[root] = out.get(root, 0) + int(nbytes)
    return out


class WorkloadMiner:
    """Incremental aggregation of workload signatures from the process
    flight ring. Single-consumer cursor (`last_seq`); thread safety is
    the caller's (the `IndexAdvisor` serializes polls under its lock)."""

    def __init__(self, min_repeats: int = 2):
        self.min_repeats = max(1, int(min_repeats))
        self.last_seq = 0
        self._signatures: Dict[tuple, WorkloadSignature] = {}
        self.queries_seen = 0
        self.queries_served = 0

    # -- polling -----------------------------------------------------------

    def poll(self, recorder=None) -> int:
        """Fold every ring entry newer than the cursor into the
        signature table. Returns how many queries were mined."""
        if recorder is None:
            from hyperspace_tpu_torch import telemetry
            recorder = telemetry.get_recorder()
        fresh, self.last_seq = recorder.snapshot(self.last_seq)
        for metrics in fresh:
            try:
                self._mine_one(metrics)
            except Exception:
                # One malformed recorder (test fakes, partial records)
                # must not stall the miner's cursor.
                continue
        self.queries_seen += len(fresh)
        return len(fresh)

    def _mine_one(self, metrics) -> None:
        events = [e for e in getattr(metrics, "events", ())
                  if e.get("category") == "rule"]
        if any(e.get("action") == "applied" for e in events):
            # An index already serves this query; nothing to advise.
            self.queries_served += 1
            return
        seq = getattr(metrics, "flight_seq", 0)
        plan = getattr(metrics, "logical_plan", None)
        tenant = getattr(metrics, "tenant", None) or "default"
        bytes_by_root = _scan_bytes_by_root(metrics)
        # One observation per (relation, predicate) per QUERY: the
        # filter rule declines both the outer Project(Filter(Scan))
        # match and the inner bare Filter(Scan) on the same walk,
        # emitting two whyNot records for one miss. Keep the one with
        # the NARROWEST projected set (the outer match — the columns
        # the query actually needs; the bare match reports the full
        # relation schema).
        filters: Dict[tuple, dict] = {}
        for e in events:
            if e.get("action") != "skipped":
                continue
            if e.get("name") == "FilterIndexRule" and e.get("roots"):
                k = (tuple(e["roots"]),
                     self._cols(e, "filter_columns"))
                best = filters.get(k)
                if best is None or len(e.get("project_columns") or ()) \
                        < len(best.get("project_columns") or ()):
                    filters[k] = e
            elif e.get("name") == "JoinIndexRule" \
                    and e.get("left_roots") and e.get("right_roots"):
                self._fold_join(e, seq, plan, bytes_by_root, tenant)
        for e in filters.values():
            self._fold_filter(e, seq, plan, bytes_by_root, tenant)

    @staticmethod
    def _cols(e, key) -> Tuple[str, ...]:
        return tuple(sorted({str(c).lower() for c in (e.get(key) or ())}))

    def _fold_filter(self, e, seq, plan, bytes_by_root,
                     tenant: str = "default") -> None:
        roots = tuple(e["roots"])
        filter_cols = self._cols(e, "filter_columns")
        if not filter_cols:
            return
        project_cols = self._cols(e, "project_columns")
        key = ("filter", tenant, roots, filter_cols, project_cols)
        sig = self._signatures.get(key)
        if sig is None:
            sig = self._signatures[key] = WorkloadSignature("filter", key)
            sig.tenant = tenant
            sig.roots = roots
            sig.filter_columns = filter_cols
            sig.project_columns = project_cols
        sig.eq_columns = tuple(sorted(set(sig.eq_columns)
                                      | set(self._cols(e, "eq_columns"))))
        self._observe(sig, seq, plan,
                      sum(bytes_by_root.get(r, 0) for r in roots))

    def _fold_join(self, e, seq, plan, bytes_by_root,
                   tenant: str = "default") -> None:
        left_roots = tuple(e["left_roots"])
        right_roots = tuple(e["right_roots"])
        left_cols = tuple(str(c).lower()
                          for c in (e.get("left_join_columns") or ()))
        right_cols = tuple(str(c).lower()
                           for c in (e.get("right_join_columns") or ()))
        if not left_cols or len(left_cols) != len(right_cols):
            return
        key = ("join", tenant, left_roots, right_roots, left_cols,
               right_cols)
        sig = self._signatures.get(key)
        if sig is None:
            sig = self._signatures[key] = WorkloadSignature("join", key)
            sig.tenant = tenant
            sig.roots = left_roots
            sig.right_roots = right_roots
            sig.join_columns = left_cols
            sig.right_join_columns = right_cols
        sig.referenced_columns = tuple(sorted(
            set(sig.referenced_columns)
            | set(self._cols(e, "left_referenced"))))
        sig.right_referenced_columns = tuple(sorted(
            set(sig.right_referenced_columns)
            | set(self._cols(e, "right_referenced"))))
        nbytes = (sum(bytes_by_root.get(r, 0) for r in left_roots)
                  + sum(bytes_by_root.get(r, 0) for r in right_roots))
        self._observe(sig, seq, plan, nbytes)

    @staticmethod
    def _observe(sig: WorkloadSignature, seq: int, plan,
                 nbytes: int) -> None:
        sig.count += 1
        sig.total_scan_bytes += max(0, int(nbytes))
        if seq >= sig.last_seq:
            sig.last_seq = seq
            if plan is not None:
                sig.plan = plan

    # -- results -----------------------------------------------------------

    def signatures(self) -> List[WorkloadSignature]:
        """Every signature seen so far, deterministically ordered
        (most-observed first, then key)."""
        return sorted(self._signatures.values(),
                      key=lambda s: (-s.count, s.key))

    def recurring(self) -> List[WorkloadSignature]:
        """Signatures at or past the repeat threshold, with a replayable
        plan — the scorer's input."""
        return [s for s in self.signatures()
                if s.count >= self.min_repeats and s.plan is not None]
