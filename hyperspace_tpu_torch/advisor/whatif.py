"""What-if scoring: replay recorded plans against hypothetical indexes.

The Hyperspace paper's `whatIf` answers "would this index be used, and
what would it save?" without building anything. This module does the
same with the engine's REAL machinery instead of a cost-model clone:

- for each recurring workload signature (`advisor/miner.py`), it
  synthesizes a hypothetical ACTIVE `IndexLogEntry` — fingerprinted
  with the same `FileBasedSignatureProvider` a real build would use, so
  signature matching behaves identically — whose `extra.stats` carries
  the ESTIMATED on-disk size (the rules' cost-based ranking reads
  stamped stats, never the filesystem, so a nonexistent data root is
  fine);
- it REPLAYS the recorded source plan through the real rewrite rules
  (`JoinIndexRule` + `FilterIndexRule` via a throwaway session whose
  catalog is the real ACTIVE entries plus the hypotheticals — candidate
  selection, coverage, ranking all run the production code path) and
  keeps a candidate only if the rules actually select it;
- it scores each kept candidate by estimated bytes avoided per
  occurrence, amortized over the signature's observed repeat count.

No data is touched: the only IO is the signature provider's file
stats. The byte model: a covering
index over columns C of a relation with schema S costs
`src_bytes * width(C)/width(S)` to read; a point (equality) predicate
on the leading indexed column additionally prunes to 1/num_buckets of
it. A hypothetical DATA-SKIPPING index cannot be replayed (the rules
consult sketch blobs that do not exist yet), so it scores with the
conservative `spark.hyperspace.advisor.skipping.prune.fraction`
constant and is marked estimate-only.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

from hyperspace_tpu_torch.utils.hashing import md5_hex

__all__ = ["Candidate", "score_signatures", "hypothetical_entry",
           "replay_plan", "measured_prune_fraction"]

# Approximate decoded bytes per value per logical dtype — only RATIOS
# matter (index width over relation width).
_DTYPE_WIDTH = {
    "bool": 1, "int8": 1, "int16": 2, "int32": 4, "int64": 8,
    "float32": 4, "float64": 8, "date32": 4, "timestamp": 8,
    # int32 codes + an amortized share of dictionary + hashes.
    "string": 12,
}


def _width(schema, columns: Optional[Sequence[str]] = None) -> int:
    names = ({c.lower() for c in columns} if columns is not None
             else None)
    total = 0
    for f in schema.fields:
        if names is None or f.name.lower() in names:
            total += _DTYPE_WIDTH.get(f.dtype, 8)
    return max(total, 1)


class Candidate:
    """One scored recommendation: the config(s) to build, the relation
    scan(s) to build them over, and the what-if verdict."""

    __slots__ = ("kind", "name", "configs", "scans", "signature",
                 "est_index_bytes", "est_bytes_avoided_per_query",
                 "score", "replayed", "replay_applied", "detail")

    def __init__(self, kind: str, name: str, configs, scans, signature,
                 est_index_bytes: int, est_avoided: int,
                 replayed: bool, replay_applied: Optional[bool],
                 detail: Optional[dict] = None):
        self.kind = kind
        self.name = name
        self.configs = list(configs)
        self.scans = list(scans)
        self.signature = signature
        self.est_index_bytes = int(est_index_bytes)
        self.est_bytes_avoided_per_query = int(est_avoided)
        self.score = int(est_avoided) * signature.count
        self.replayed = replayed
        self.replay_applied = replay_applied
        self.detail = detail or {}

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "name": self.name,
            "indexes": [getattr(c, "index_name", None)
                        for c in self.configs],
            "signature": self.signature.to_dict(),
            "est_index_bytes": self.est_index_bytes,
            "est_bytes_avoided_per_query":
                self.est_bytes_avoided_per_query,
            "score": self.score,
            "replayed": self.replayed,
            "replay_applied": self.replay_applied,
            "detail": dict(self.detail),
        }


def _candidate_name(kind: str, root: str, indexed, included) -> str:
    """Deterministic, collision-resistant advisor index name — the same
    signature always proposes the same name, so re-runs recognize their
    own builds in the catalog instead of proposing duplicates."""
    digest = md5_hex("|".join((kind, root, ",".join(indexed),
                               ",".join(included))))[:10]
    return f"adv_{kind}_{digest}"


def measured_prune_fraction(conf, index_name: Optional[str] = None):
    """The skipping prune fraction the scorer should assume, as
    `(fraction, source)` — closing the advisor's blind-constant loop:
    prefer the MEASURED per-index gauge for `index_name` (candidate
    names are deterministic, so a signature re-proposing an index the
    advisor already built reads that index's own recorded reality),
    then the global measured mean (`skipping.measured_prune_fraction`
    histogram over every served skipping query), and only then the
    `advisor.skipping.prune.fraction` conf assumption. `source` is one
    of "measured:index" / "measured:global" / "assumed" — candidates
    carry it in `detail["prune_fraction_source"]` and the drift report
    says when measurement overrode the assumption."""
    from hyperspace_tpu_torch import telemetry

    def clamp(v):
        return min(max(float(v), 0.0), 1.0)

    snap = telemetry.get_registry().series_snapshot()
    if index_name is not None:
        v = snap.get("gauges", {}).get(
            f"skipping.{index_name}.measured_prune_fraction")
        if v is not None:
            return clamp(v), "measured:index"
    hist = snap.get("histograms", {}).get(
        "skipping.measured_prune_fraction")
    count = (hist or {}).get("count") or 0
    if count:
        return clamp(hist["sum"] / count), "measured:global"
    return clamp(conf.advisor_skipping_prune_fraction), "assumed"


def _single_scan(plan, roots) -> Optional[object]:
    """The plan's Scan leaf over exactly `roots`, or None."""
    from hyperspace_tpu_torch.plan.nodes import Scan
    for leaf in plan.collect_leaves():
        if isinstance(leaf, Scan) and tuple(leaf.root_paths) == roots:
            return leaf
    return None


def hypothetical_entry(name: str, scan, indexed: Sequence[str],
                       included: Sequence[str], num_buckets: int,
                       system_path: str, est_bytes: int):
    """An ACTIVE `IndexLogEntry` for an index that does not exist:
    fingerprinted over the live source files exactly as
    `CreateActionBase.get_index_log_entry` would, data root pointed at
    the path a real build WOULD use, estimated size stamped into
    `extra.stats` (what the rules' ranking reads). Returns None when
    the source cannot be fingerprinted (files vanished since
    recording)."""
    from hyperspace_tpu_torch.constants import States
    from hyperspace_tpu_torch.index.log_entry import (Content, CoveringIndex,
                                                Directory, Hdfs,
                                                IndexLogEntry,
                                                LogicalPlanFingerprint,
                                                NoOpFingerprint,
                                                PlanSource, Signature,
                                                Source)
    from hyperspace_tpu_torch.index.signature import FileBasedSignatureProvider
    from hyperspace_tpu_torch.plan.serde import plan_to_json

    provider = FileBasedSignatureProvider()
    try:
        sig_value = provider.signature(scan)
    except Exception:
        sig_value = None
    if sig_value is None:
        return None
    schema = scan.schema.select(list(indexed) + list(included))
    files = scan.files()
    entry = IndexLogEntry(
        name=name,
        derived_dataset=CoveringIndex(
            indexed_columns=list(indexed),
            included_columns=list(included),
            schema_json=schema.to_json(),
            num_buckets=num_buckets),
        content=Content(root=os.path.join(system_path, name, "v__=0"),
                        directories=[]),
        source=Source(
            plan=PlanSource(
                raw_plan=plan_to_json(scan),
                fingerprint=LogicalPlanFingerprint(
                    [Signature(provider.name(), sig_value)])),
            data=[Hdfs(Content(root="", directories=[
                Directory(path="", files=files,
                          fingerprint=NoOpFingerprint())]))]),
        extra={"stats": {"dataSizeBytes": int(est_bytes),
                         "rowCount": 0},
               "hypothetical": True})
    entry.state = States.ACTIVE
    return entry


class _WhatIfManager:
    """Catalog stand-in the replay session's rules read: the REAL
    active entries plus the hypotheticals under test."""

    def __init__(self, entries):
        self._entries = list(entries)

    def get_indexes(self, states=None):
        return [e for e in self._entries
                if states is None or e.state in states]


def replay_plan(session, plan, hypothetical_entries):
    """Run the production rewrite rules over (a serde clone of) `plan`
    with the hypothetical entries visible, returning the set of index
    names the rules actually SELECTED. The clone keeps replay-side plan
    mutation (snapshot pins, explicit file lists) off the recorded
    object."""
    from hyperspace_tpu_torch.constants import States
    from hyperspace_tpu_torch.engine.session import HyperspaceSession
    from hyperspace_tpu_torch.facade import Hyperspace, HyperspaceContext
    from hyperspace_tpu_torch.plan.nodes import Scan
    from hyperspace_tpu_torch.plan.serde import plan_from_json, plan_to_json

    real = []
    try:
        manager = Hyperspace.get_context(session).index_collection_manager
        real = manager.get_indexes([States.ACTIVE])
    except Exception:
        pass
    shadow = HyperspaceSession(session.conf)
    shadow.enable_hyperspace()
    ctx = HyperspaceContext.__new__(HyperspaceContext)
    ctx.index_collection_manager = _WhatIfManager(
        real + list(hypothetical_entries))
    with Hyperspace._lock:
        Hyperspace._contexts[shadow] = ctx
    try:
        clone = plan_from_json(plan_to_json(plan))
        optimized = shadow.optimize(clone)
    except Exception:
        return set()
    selected = set()

    def visit(node):
        if isinstance(node, Scan) and node.index_name:
            selected.add(node.index_name)
        for c in node.children:
            visit(c)

    visit(optimized)
    return selected


def _filter_candidates(session, sig, conf, system_path) -> List[Candidate]:
    """Covering + data-skipping candidates for one recurring filter
    signature."""
    from hyperspace_tpu_torch.index.index_config import (DataSkippingIndexConfig,
                                                   IndexConfig)

    if len(sig.roots) != 1 or sig.plan is None:
        return []
    scan = _single_scan(sig.plan, sig.roots)
    if scan is None:
        return []
    root = sig.roots[0]
    src_bytes = max(sig.mean_scan_bytes, 0)
    if src_bytes <= 0:
        from hyperspace_tpu_torch.plan import footprint
        src_bytes = footprint.scan_disk_bytes(scan)
    out: List[Candidate] = []

    # Covering candidate: eq columns lead (bucket pruning serves point
    # predicates), then the remaining filter columns; included = every
    # other column the query shape reads.
    eq = [c for c in sig.filter_columns if c in set(sig.eq_columns)]
    non_eq = [c for c in sig.filter_columns if c not in set(eq)]
    indexed = list(eq) + list(non_eq)
    needed = set(sig.project_columns) | set(sig.filter_columns)
    included = sorted(needed - set(indexed))
    covered_all = {f.name.lower() for f in scan.schema.fields} <= \
        (set(indexed) | set(included))
    num_buckets = conf.num_buckets
    width_frac = _width(scan.schema, indexed + included) \
        / _width(scan.schema)
    est_idx_bytes = max(1, int(src_bytes * min(width_frac, 1.0)))
    read_frac = (1.0 / max(num_buckets, 1)
                 if indexed and indexed[0] in set(eq) else 1.0)
    avoided = max(0, src_bytes - int(est_idx_bytes * read_frac))
    if avoided > 0:
        name = _candidate_name("cov", root, indexed, included)
        entry = hypothetical_entry(name, scan, indexed, included,
                                   num_buckets, system_path,
                                   est_idx_bytes)
        if entry is not None:
            applied = name in replay_plan(session, sig.plan, [entry])
            if applied:
                cfg = IndexConfig(name, indexed, included)
                out.append(Candidate(
                    "covering", name, [cfg], [scan], sig,
                    est_idx_bytes, avoided, replayed=True,
                    replay_applied=True,
                    detail={"root": root, "indexed": indexed,
                            "included": included,
                            "read_fraction": round(read_frac, 6),
                            "covers_full_schema": covered_all}))

    # Data-skipping candidate: cheap to build and store (per-file
    # sketches), prunes whole files instead of narrowing rows. The
    # rules cannot replay sketches that do not exist — estimate-only,
    # scored with the MEASURED prune fraction when the rules have
    # recorded one (per-index first, then the global mean), and only
    # the conf assumption when nothing has been measured yet.
    sk_name = _candidate_name("skip", root, list(sig.filter_columns), [])
    prune_frac, prune_src = measured_prune_fraction(conf, sk_name)
    sk_avoided = int(src_bytes * prune_frac)
    if sk_avoided > 0 and sig.filter_columns:
        sk_cfg = DataSkippingIndexConfig(sk_name,
                                         list(sig.filter_columns))
        out.append(Candidate(
            "skipping", sk_name, [sk_cfg], [scan], sig,
            # Sketch blobs are ~per-file metadata: budget them at 1% of
            # the source, floored at 64 KiB.
            max(64 * 1024, src_bytes // 100), sk_avoided,
            replayed=False, replay_applied=None,
            detail={"root": root,
                    "skip_by": list(sig.filter_columns),
                    "prune_fraction": prune_frac,
                    "prune_fraction_source": prune_src}))
    return out


def _join_candidates(session, sig, conf, system_path) -> List[Candidate]:
    """A compatible covering-index PAIR for one recurring join
    signature (both sides must exist for the join rule to fire — the
    candidate is the pair, built together)."""
    from hyperspace_tpu_torch.index.index_config import IndexConfig

    if len(sig.roots) != 1 or len(sig.right_roots) != 1 \
            or sig.plan is None:
        return []
    left_scan = _single_scan(sig.plan, sig.roots)
    right_scan = _single_scan(sig.plan, sig.right_roots)
    if left_scan is None or right_scan is None:
        return []
    from hyperspace_tpu_torch.plan import footprint

    sides = []
    total_avoided = 0
    total_idx_bytes = 0
    entries = []
    configs = []
    names = []
    for scan, join_cols, referenced in (
            (left_scan, sig.join_columns, sig.referenced_columns),
            (right_scan, sig.right_join_columns,
             sig.right_referenced_columns)):
        src = footprint.scan_disk_bytes(scan)
        indexed = list(join_cols)
        needed = set(referenced) or \
            {f.name.lower() for f in scan.schema.fields}
        included = sorted(needed - set(indexed))
        width_frac = _width(scan.schema, indexed + included) \
            / _width(scan.schema)
        est_idx = max(1, int(src * min(width_frac, 1.0)))
        name = _candidate_name("cov", scan.root_paths[0], indexed,
                               included)
        entry = hypothetical_entry(name, scan, indexed, included,
                                   conf.num_buckets, system_path,
                                   est_idx)
        if entry is None:
            return []
        entries.append(entry)
        configs.append(IndexConfig(name, indexed, included))
        names.append(name)
        sides.append(scan)
        total_avoided += max(0, src - est_idx)
        total_idx_bytes += est_idx
    # The pair also elides the join's Exchange+Sort (the bucketed
    # layout IS the sort) — count the join keys' width once more as a
    # stand-in for that saved pass, so an equal-width pair still
    # scores.
    total_avoided += _width(left_scan.schema, sig.join_columns) \
        * max(1, sig.count)
    if total_avoided <= 0:
        return []
    selected = replay_plan(session, sig.plan, entries)
    if not set(names) <= selected:
        return []
    return [Candidate(
        "join", "+".join(names), configs, sides, sig,
        total_idx_bytes, total_avoided, replayed=True,
        replay_applied=True,
        detail={"left_root": sig.roots[0],
                "right_root": sig.right_roots[0],
                "join_columns": list(sig.join_columns)})]


def _already_built(session, candidate: Candidate) -> bool:
    """True when every index of the candidate already exists in the
    catalog in any non-DOESNOTEXIST state (built by a previous advisor
    run — deterministic names make this an exact check — or by hand)."""
    from hyperspace_tpu_torch.constants import States
    from hyperspace_tpu_torch.facade import Hyperspace
    try:
        manager = Hyperspace.get_context(session).index_collection_manager
        existing = {e.name for e in manager.get_indexes()
                    if e.state != States.DOESNOTEXIST}
    except Exception:
        return False
    return all(getattr(c, "index_name", None) in existing
               for c in candidate.configs)


def score_signatures(session, signatures, conf) -> List[Candidate]:
    """Candidates for every recurring signature, what-if verified where
    replayable, deduplicated against the live catalog, ranked by score
    (desc) then name — deterministic over fixed inputs."""
    system_path = conf.system_path
    out: List[Candidate] = []
    for sig in signatures:
        try:
            if sig.kind == "filter":
                cands = _filter_candidates(session, sig, conf,
                                           system_path)
            elif sig.kind == "join":
                cands = _join_candidates(session, sig, conf,
                                         system_path)
            else:
                cands = []
        except Exception:
            continue  # one unscorable signature never stalls the rest
        for c in cands:
            if not _already_built(session, c):
                out.append(c)
    seen = set()
    deduped = []
    for c in sorted(out, key=lambda c: (-c.score, c.name)):
        if c.name not in seen:
            seen.add(c.name)
            deduped.append(c)
    return deduped
