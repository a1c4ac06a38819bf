"""Explain: physical-plan diff with rules enabled vs disabled.

Parity: reference `index/plananalysis/PlanAnalyzer.scala:45-360` — plans the
query twice (rules on / rules off, saving and restoring the enabled state),
highlights differing subtrees, emits "Plan with indexes / Plan without
indexes / Indexes used" sections, and in verbose mode appends the operator
occurrence diff table.
"""

from __future__ import annotations

from typing import List, Sequence

from hyperspace_tpu_torch.engine.physical import PhysicalNode, ScanExec
from hyperspace_tpu_torch.plananalysis import op_analyzer
from hyperspace_tpu_torch.plananalysis.buffer_stream import BufferStream
from hyperspace_tpu_torch.plananalysis.display_mode import get_display_mode


class PlanAnalyzer:
    @staticmethod
    def explain_string(df, session, index_summaries: Sequence,
                       verbose: bool = False, metrics=None) -> str:
        """Reference `PlanAnalyzer.scala:45-126`. Pass a
        `telemetry.QueryMetrics` (e.g. `session.last_query_metrics()` or
        the `collect(with_metrics=True)` companion) as `metrics` to
        append the runtime numbers — per-operator timings/rows, lane and
        rule decision events — under the plan diff, so the what-changed
        and the what-it-cost views read as one report."""
        was_enabled = session.is_hyperspace_enabled
        try:
            session.enable_hyperspace()
            _, _, plan_with = df.explain_plans()
            session.disable_hyperspace()
            _, _, plan_without = df.explain_plans()
        finally:
            if was_enabled:
                session.enable_hyperspace()
            else:
                session.disable_hyperspace()

        mode = get_display_mode(session.conf)
        buffer = BufferStream(mode)

        with_lines: List[tuple] = []
        without_lines: List[tuple] = []
        PlanAnalyzer._lockstep_diff(plan_with, plan_without, 0,
                                    with_lines, without_lines)

        buffer.write_line("=============================================================")
        buffer.write_line("Plan with indexes:")
        buffer.write_line("=============================================================")
        for line, highlighted in with_lines:
            if highlighted:
                buffer.highlight_line(line)
            else:
                buffer.write_line(line)
        buffer.write_line()

        buffer.write_line("=============================================================")
        buffer.write_line("Plan without indexes:")
        buffer.write_line("=============================================================")
        for line, highlighted in without_lines:
            if highlighted:
                buffer.highlight_line(line)
            else:
                buffer.write_line(line)
        buffer.write_line()

        buffer.write_line("=============================================================")
        buffer.write_line("Indexes used:")
        buffer.write_line("=============================================================")
        for name, location in PlanAnalyzer._indexes_used(plan_with,
                                                         index_summaries):
            buffer.write_line(f"{name}:{location}")
        buffer.write_line()

        if verbose:
            buffer.write_line("=============================================================")
            buffer.write_line("Physical operator stats:")
            buffer.write_line("=============================================================")
            for line in op_analyzer.stats_table(plan_with,
                                                plan_without).splitlines():
                buffer.write_line(line)
            buffer.write_line()

        if metrics is not None:
            buffer.write_line("=============================================================")
            buffer.write_line("Runtime metrics (last execution):")
            buffer.write_line("=============================================================")
            for line in metrics.format_tree().splitlines():
                buffer.write_line(line)
            buffer.write_line()

        return buffer.to_string()

    # -- lockstep subtree diff -------------------------------------------
    #
    # Reference `PlanAnalyzer.scala:56-101`: both physical plans are
    # walked in lockstep top-down; while paired nodes are equal the line
    # prints plain and the walk recurses pairwise into the children, and
    # at the first difference BOTH differing subtrees are emitted fully
    # highlighted. Unlike a line-set diff, repeated identical operator
    # lines (e.g. two `Sort [key]` nodes of which only one was elided)
    # classify by POSITION, not by text membership.

    @staticmethod
    def _fmt(node: PhysicalNode, depth: int) -> str:
        # First line of tree_string at this depth — ONE source of truth
        # for plan rendering, so highlighted and plain sections align.
        return node.tree_string(depth).splitlines()[0]

    @staticmethod
    def _node_equal(a: PhysicalNode, b: PhysicalNode) -> bool:
        """Node-level equality; scans compare by root paths (reference
        `PlanAnalyzer.scala:189-200` — FileSourceScanExec equality is
        root-path equality)."""
        if type(a) is not type(b):
            return False
        if isinstance(a, ScanExec):
            return sorted(a.scan.root_paths) == sorted(b.scan.root_paths)
        return a.simple_string() == b.simple_string()

    @staticmethod
    def _emit_subtree(node: PhysicalNode, depth: int, out: List[tuple],
                      highlighted: bool) -> None:
        for line in node.tree_string(depth).splitlines():
            out.append((line, highlighted))

    @staticmethod
    def _lockstep_diff(a: PhysicalNode, b: PhysicalNode, depth: int,
                       out_a: List[tuple], out_b: List[tuple]) -> None:
        if (PlanAnalyzer._node_equal(a, b)
                and len(a.children) == len(b.children)):
            out_a.append((PlanAnalyzer._fmt(a, depth), False))
            out_b.append((PlanAnalyzer._fmt(b, depth), False))
            for ca, cb in zip(a.children, b.children):
                PlanAnalyzer._lockstep_diff(ca, cb, depth + 1, out_a, out_b)
        else:
            PlanAnalyzer._emit_subtree(a, depth, out_a, True)
            PlanAnalyzer._emit_subtree(b, depth, out_b, True)

    @staticmethod
    def _indexes_used(plan: PhysicalNode, index_summaries: Sequence
                      ) -> List[tuple]:
        """Match scan root paths against the index catalog (reference
        `PlanAnalyzer.scala:209-221`, scan equality = root path equality);
        the containment matching itself lives in `index/manager.py`
        (shared with the telemetry index-usage reports)."""
        from hyperspace_tpu_torch.index.manager import summaries_for_roots

        roots = [root for node in plan.collect() if isinstance(node, ScanExec)
                 for root in node.scan.root_paths]
        return [(s.name, s.index_location)
                for s in summaries_for_roots(index_summaries, roots)]
