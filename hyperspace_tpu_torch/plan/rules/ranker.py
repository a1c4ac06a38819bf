"""JoinIndexRanker: order candidate index pairs.

Parity: reference `index/rankers/JoinIndexRanker.scala:24-56` — pairs with
EQUAL bucket counts first (zero re-bucket traffic: every bucket pair joins
in place), then larger bucket counts (more parallelism).
"""

from __future__ import annotations

from typing import List, Tuple

from hyperspace_tpu_torch.index.log_entry import IndexLogEntry


class JoinIndexRanker:
    @staticmethod
    def rank(pairs: List[Tuple[IndexLogEntry, IndexLogEntry]]
             ) -> List[Tuple[IndexLogEntry, IndexLogEntry]]:
        def key(pair):
            left, right = pair
            equal = left.num_buckets == right.num_buckets
            return (0 if equal else 1, -(left.num_buckets + right.num_buckets))
        return sorted(pairs, key=key)
