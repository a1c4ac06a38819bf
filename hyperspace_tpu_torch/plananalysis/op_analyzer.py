"""Operator-occurrence diff of two physical plans.

Parity: reference `index/plananalysis/PhysicalOperatorAnalyzer.scala:30-58` —
counts operator occurrences in both plans and spells out the
shuffle/broadcast operators; the Exchange row is how shuffle elimination is
made visible to users.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Tuple

from hyperspace_tpu_torch.engine.physical import PhysicalNode


def count_operators(plan: PhysicalNode) -> Counter:
    return Counter(node.name for node in plan.collect())


def compare(with_index: PhysicalNode, without_index: PhysicalNode
            ) -> List[Tuple[str, int, int]]:
    """(operator, count with indexes, count without indexes), sorted by
    name, only rows where either count is nonzero."""
    a = count_operators(with_index)
    b = count_operators(without_index)
    names = sorted(set(a) | set(b))
    return [(n, a.get(n, 0), b.get(n, 0)) for n in names]


def stats_table(with_index: PhysicalNode, without_index: PhysicalNode) -> str:
    rows = compare(with_index, without_index)
    header = ("Physical Operator", "Hyperspace Disabled", "Hyperspace Enabled",
              "Difference")
    table_rows = [(name, str(without), str(with_), str(with_ - without))
                  for name, with_, without in rows]
    widths = [max(len(header[i]), *(len(r[i]) for r in table_rows))
              for i in range(4)] if table_rows else [len(h) for h in header]

    def fmt(cells):
        return "| " + " | ".join(c.ljust(widths[i])
                                 for i, c in enumerate(cells)) + " |"

    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    lines = [sep, fmt(header), sep]
    lines += [fmt(r) for r in table_rows]
    lines.append(sep)
    return "\n".join(lines)
