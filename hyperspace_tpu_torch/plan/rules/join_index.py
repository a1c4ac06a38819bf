"""JoinIndexRule: redirect equi-joins to bucketed covering indexes.

Parity: reference `index/rules/JoinIndexRule.scala:54-595`.
Applicability (reference `:163-166`):
- equi-join condition in AND-only CNF of column equalities (`:179-185`);
- both subplans *linear* (<=1 child per node) — guards against signature
  collisions since the file-based signature ignores plan structure
  (`:194-205, 210-211`);
- join attributes resolve directly to base relations with a strict
  one-to-one left<->right column mapping (`:278-317`).
Index selection (reference `:328-594`):
- per-side candidates by EXACT signature match;
- an index is usable iff its indexed columns are SET-equal to that side's
  join columns and it covers every column the side needs;
- left/right indexes are compatible iff their indexed-column ORDER agrees
  under the left<->right mapping;
- best pair chosen by JoinIndexRanker.
Replacement swaps each side's scan for the index scan WITH its bucket spec
so the physical planner elides Exchange+Sort (reference `:124-153`).
Errors degrade to a no-op with a warning (reference `:66-69`).

The JAX package's hybrid scan (an index over a source that changed since
the build, served with the appended files unioned in) is not part of this
package yet (ROADMAP.md): such a side is skipped with a recorded reason.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

from hyperspace_tpu_torch import telemetry
from hyperspace_tpu_torch.constants import LINEAGE_COLUMN
from hyperspace_tpu_torch.index.log_entry import IndexLogEntry
from hyperspace_tpu_torch.plan import expr as E
from hyperspace_tpu_torch.plan.nodes import (Filter, Join, LogicalPlan,
                                             Project, Scan)
from hyperspace_tpu_torch.plan.rules.base import Rule
from hyperspace_tpu_torch.plan.rules.ranker import JoinIndexRanker

logger = logging.getLogger(__name__)


def _skip(reason: str, **detail) -> None:
    """Structured whyNot record: the rule looked at a join and declined,
    with the reason."""
    telemetry.event("rule", "JoinIndexRule", action="skipped",
                    reason=reason, **detail)


class JoinIndexRule(Rule):
    def apply(self, plan: LogicalPlan) -> LogicalPlan:
        self._sig_cache = {}
        try:
            return plan.transform_up(self._rewrite)
        except Exception as exc:
            logger.warning("JoinIndexRule failed; skipping: %s", exc)
            return plan

    def _rewrite(self, node: LogicalPlan) -> LogicalPlan:
        # The reference rule matches ANY `Join(l, r, Some(cond))` with a
        # supported equi condition (`JoinIndexRule.scala:55-71`) — outer
        # equi-joins are index-served too.
        if not isinstance(node, Join):
            return node
        join = node
        if join.condition is None:
            return node  # cross join: nothing to bucket on
        mapping = self._column_mapping(join)
        if mapping is None:
            _skip("condition is not an AND-only CNF of one-to-one "
                  "column equalities")
            return node
        if not (join.left.is_linear() and join.right.is_linear()):
            _skip("non-linear join subplan")
            return node
        left_scan = self._base_scan(join.left)
        right_scan = self._base_scan(join.right)
        if left_scan is None or right_scan is None:
            _skip("join side does not resolve to a single base relation")
            return node
        if left_scan.bucket_spec is not None \
                or right_scan.bucket_spec is not None:
            _skip("relation already bucketed (rule already applied)")
            return node

        pair = self._best_index_pair(join, mapping)
        if pair is None:
            left_cols = sorted(mapping)
            _skip("no usable/compatible index pair",
                  join_columns=left_cols,
                  left_join_columns=left_cols,
                  right_join_columns=[mapping[c] for c in left_cols],
                  left_roots=list(left_scan.root_paths),
                  right_roots=list(right_scan.root_paths),
                  left_referenced=self._referenced_columns(join.left),
                  right_referenced=self._referenced_columns(join.right))
            return node
        left_index, right_index = pair
        logger.info("JoinIndexRule: applying indexes %s, %s",
                    left_index.name, right_index.name)
        telemetry.event(
            "rule", "JoinIndexRule", action="applied",
            indexes=[{"name": e.name, "root": e.content.root,
                      "num_buckets": e.num_buckets, "side": side,
                      "appended_files": 0, "deleted_files": 0}
                     for e, side in ((left_index, "left"),
                                     (right_index, "right"))])
        return Join(self._swap(join.left, left_index),
                    self._swap(join.right, right_index),
                    join.condition, join.join_type)

    def _swap(self, side_plan: LogicalPlan,
              entry: IndexLogEntry) -> LogicalPlan:
        replacement: LogicalPlan = self.index_scan(entry, bucketed=True)
        if replacement.schema.contains(LINEAGE_COLUMN):
            # A lineage-enabled index carries the internal `_hs_file_id`
            # column; a Project (which preserves bucketing) keeps it out
            # of the join's output schema.
            needed = set(self._referenced_columns(side_plan))
            replacement = Project([f.name for f in replacement.schema.fields
                                   if f.name.lower() in needed], replacement)

        def f(n: LogicalPlan) -> LogicalPlan:
            return replacement if isinstance(n, Scan) else n

        return side_plan.transform_up(f)

    # -- applicability ----------------------------------------------------

    @staticmethod
    def _base_scan(plan: LogicalPlan) -> Optional[Scan]:
        leaves = plan.collect_leaves()
        if len(leaves) == 1 and isinstance(leaves[0], Scan):
            return leaves[0]
        return None

    def _column_mapping(self, join: Join) -> Optional[Dict[str, str]]:
        """Strict one-to-one left->right join column mapping from an
        AND-only CNF of column equalities (reference `:179-185, 278-317`)."""
        left_schema, right_schema = join.left.schema, join.right.schema
        mapping: Dict[str, str] = {}
        reverse: Dict[str, str] = {}
        for conjunct in E.split_conjunctive(join.condition):
            if not isinstance(conjunct, E.EqualTo):
                return None
            a, b = conjunct.left, conjunct.right
            if not isinstance(a, E.Column) or not isinstance(b, E.Column):
                return None
            if left_schema.contains(a.name) and right_schema.contains(b.name):
                l, r = a.name.lower(), b.name.lower()
            elif left_schema.contains(b.name) \
                    and right_schema.contains(a.name):
                l, r = b.name.lower(), a.name.lower()
            else:
                return None
            if mapping.get(l, r) != r or reverse.get(r, l) != l:
                return None  # one-to-many mapping
            mapping[l] = r
            reverse[r] = l
        return mapping or None

    # -- index selection --------------------------------------------------

    @staticmethod
    def _referenced_columns(plan: LogicalPlan) -> List[str]:
        """BASE-relation columns the side needs (reference `:446-457`): the
        output resolved top-down through projections — computed entries
        contribute their references, not their alias names — plus every
        filter reference along the chain."""

        def walk(node: LogicalPlan, required: set) -> set:
            if isinstance(node, Scan):
                return {r.lower() for r in required}
            if isinstance(node, Filter):
                return walk(node.child,
                            set(required) | node.condition.references())
            if isinstance(node, Project):
                return walk(node.child, node.references())
            out = {r.lower() for r in required}
            for c in node.children:
                out |= walk(c, set(c.schema.names))
            return out

        return sorted(walk(plan, set(plan.schema.names)))

    def _usable_indexes(self, plan: LogicalPlan, join_cols: Sequence[str]
                        ) -> List[IndexLogEntry]:
        """Signature-matching ACTIVE indexes whose indexed columns are
        set-equal to the join columns and that cover the side's referenced
        columns (reference `:328-353, 399-409, 515-524`). A covering index
        whose signature no longer matches (the source changed) would need
        hybrid scan and is skipped with a recorded reason."""
        referenced = set(self._referenced_columns(plan))
        join_set = {c.lower() for c in join_cols}
        out = []
        for entry in self._covering_indexes():
            if {c.lower() for c in entry.indexed_columns} != join_set:
                continue
            covered = {c.lower() for c in
                       (entry.indexed_columns + entry.included_columns)}
            if not referenced <= covered:
                continue
            if self.signature_matches(entry, plan):
                out.append(entry)
            else:
                _skip("index signature does not match the current source "
                      "(hybrid scan is not part of this package yet)",
                      index=entry.name)
        return out

    def _best_index_pair(self, join: Join, mapping: Dict[str, str]):
        left_join_cols = list(mapping.keys())
        right_join_cols = [mapping[c] for c in left_join_cols]
        left_candidates = self._usable_indexes(join.left, left_join_cols)
        right_candidates = self._usable_indexes(join.right, right_join_cols)
        compatible = [(lc, rc) for lc in left_candidates
                      for rc in right_candidates
                      if self._compatible(lc, rc, mapping)]
        if not compatible:
            return None
        return JoinIndexRanker.rank(compatible)[0]

    @staticmethod
    def _compatible(left_index: IndexLogEntry, right_index: IndexLogEntry,
                    mapping: Dict[str, str]) -> bool:
        """Indexed-column ORDER must agree under the left<->right mapping —
        bucket b of each side must hold the same key hashes (reference
        `:547-594`)."""
        left_order = [c.lower() for c in left_index.indexed_columns]
        right_order = [c.lower() for c in right_index.indexed_columns]
        return [mapping.get(c) for c in left_order] == right_order
