"""Merge-compaction permutations: every bucket's runs sorted at once.

OptimizeAction compacts the base + incremental delta runs living side by
side in one `v__=N` dir into a single fully-sorted file per bucket. The
rows arrive concatenated in bucket order (each bucket's runs in version
order: base first, then deltas by delta number); each function here
returns the permutation that sorts every bucket by its key columns,
stably, in the shape `io/builder._write_sorted_runs` consumes:
`([perm], starts, ends)`.

Three lanes compute the same permutation:

- `host_merge_runs_permutation` — a true k-way MERGE for the common shape
  (one sorted base run plus small delta runs over a single null-free
  integer key): no re-sort of the base run;
- `host_bucket_sort_permutation` — a numpy `lexsort` keyed by
  (bucket, *key lanes), for small compactions;
- `bucket_sort_permutation` — the same stable (bucket, *key lanes) sort
  on the device. Rows are already in bucket-major order, so a stable sort
  keyed by the row's bucket and its key lanes yields exactly the
  per-bucket stable permutation; the JAX package's padded [B, L] layout
  exists only so XLA reuses one compile, and an LSD `torch.sort` chain
  needs no padding.

Only key lanes touch the device; the host applies the permutation to the
payload.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from hyperspace_tpu_torch.ops import keys as keymod


def _bounds(lengths: np.ndarray):
    ends = np.cumsum(lengths)
    return ends - lengths, ends


def bucket_sort_permutation(key_batch, sort_columns: Sequence[str],
                            lengths: np.ndarray):
    """Permutation that sorts every bucket of a concat-in-bucket-order
    device batch by `sort_columns`, stably, as one device sort across all
    buckets. `key_batch` needs only the key columns. Returns
    ([int64 perm tensor], starts, ends)."""
    lengths = np.asarray(lengths, dtype=np.int64)
    device = key_batch.device
    lanes: List[torch.Tensor] = []
    for name in sort_columns:
        lanes.extend(keymod.column_sort_lanes(key_batch.column(name)))
    bucket_of_row = torch.repeat_interleave(
        torch.arange(len(lengths), dtype=torch.int32, device=device),
        torch.from_numpy(lengths).to(device),
        output_size=int(lengths.sum()))
    perm = keymod.lexsort_permutation([bucket_of_row] + lanes)
    starts, ends = _bounds(lengths)
    return [perm], starts, ends


def host_merge_runs_permutation(key: np.ndarray, run_bounds):
    """True k-way MERGE permutation for the common compaction shape: per
    bucket, one large sorted base run plus small sorted-ish delta runs,
    over a single null-free integer key column.

    Per bucket the deltas are stable-sorted together (tiny), their insert
    positions into the base run found with ONE searchsorted (side='right'
    — appended rows follow equal-key base rows, the same tie order a
    stable sort of base-then-deltas produces), and the output permutation
    assembled by prefix counting. O(n + k log k + k log n) per bucket with
    NO re-sort of the base run. Falls back to a bucket-local stable sort
    when a base run is not actually sorted.

    `run_bounds`: per bucket, list of (start, end) global row ranges of
    its runs in version order (base first). Returns ([perm], starts, ends)
    in the writer's shape.
    """
    lengths = np.array([sum(e - s for s, e in runs)
                        for runs in run_bounds], dtype=np.int64)
    total = int(lengths.sum())
    perm = np.empty(total, dtype=np.int64)
    out = 0
    for runs in run_bounds:
        n_bucket = sum(e - s for s, e in runs)
        if n_bucket == 0:
            continue
        (b0, b1) = runs[0]
        base = key[b0:b1]
        if len(runs) == 1:
            perm[out:out + n_bucket] = np.arange(b0, b1)
            out += n_bucket
            continue
        d_idx = np.concatenate([np.arange(s, e) for s, e in runs[1:]])
        if len(base) and not (base[1:] >= base[:-1]).all():
            # Base run unexpectedly unsorted: bucket-local stable sort.
            all_idx = np.concatenate([np.arange(b0, b1), d_idx])
            perm[out:out + n_bucket] = all_idx[
                np.argsort(key[all_idx], kind="stable")]
            out += n_bucket
            continue
        d_sorted = d_idx[np.argsort(key[d_idx], kind="stable")]
        pos = np.searchsorted(base, key[d_sorted], side="right")
        nb, kd = len(base), len(d_sorted)
        # base row i lands at i + #{deltas inserted at or before i}
        shift = np.cumsum(np.bincount(pos, minlength=nb + 1))[:nb]
        local = np.empty(n_bucket, dtype=np.int64)
        local[np.arange(nb) + shift] = np.arange(b0, b1)
        local[pos + np.arange(kd)] = d_sorted
        perm[out:out + n_bucket] = local
        out += n_bucket
    starts, ends = _bounds(lengths)
    return [perm], starts, ends


def host_bucket_sort_permutation(key_batch, sort_columns: Sequence[str],
                                 lengths: np.ndarray):
    """Host twin of `bucket_sort_permutation`: a stable sort keyed
    (bucket, *sort lanes) — the native C++ radix lane when the library
    loads (`native.bucket_key_sort_perm`), `np.lexsort` otherwise."""
    from hyperspace_tpu_torch import native

    lengths = np.asarray(lengths, dtype=np.int64)
    bucket_of_row = np.repeat(np.arange(len(lengths), dtype=np.int32),
                              lengths)
    sort_lanes: List = []
    for name in sort_columns:
        sort_lanes.extend(keymod.host_column_sort_lanes(
            key_batch.column(name)))
    starts, ends = _bounds(lengths)
    nat = native.bucket_key_sort_perm(bucket_of_row, len(lengths),
                                      sort_lanes)
    if nat is not None:
        # Only the permutation is consumed: bounds from `lengths` agree
        # with the sort's by construction.
        return [nat[0]], starts, ends
    perm = np.lexsort(tuple(reversed([bucket_of_row] + sort_lanes)))
    return [perm.astype(np.int64)], starts, ends
