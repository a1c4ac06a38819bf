"""Equi-join row-index pairs over columnar batches.

The reference's query-time win is Spark's SortMergeJoin with Exchange+Sort
elided thanks to bucketed relations (`index/rules/JoinIndexRule.scala:41-43`).
The device lane joins with tensor primitives only — no scalar merge loop:

1. both sides' key columns decompose into order-preserving 32-bit lanes
   (`ops/keys.py`), led by a null-marker lane, and ONE stable sort of the
   concatenated lanes lines equal keys up in runs;
2. per-run right counts and bracket starts come from cumulative sums over
   the sorted sequence (`_runs_to_counts`);
3. the ragged match expansion is one `repeat_interleave` sized by the
   one host sync (the total match count).

Wide keys (>= `HASH_MATCH_MIN_LANES` lanes) sort one u64 hash lane instead
and verify runs against the full lanes; a collision re-runs the exact sort.

The host lane (numpy) keeps the same semantics for small batches.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.io.columnar import ColumnBatch

_INT64_SIGN = -(1 << 63)


def _join_lane_operands(left: ColumnBatch, right: ColumnBatch,
                        left_keys: Sequence[str],
                        right_keys: Sequence[str]):
    """Per-side 32-bit lane tuples for the one-sort counting join: a
    null-marker lane (0 = valid keys; 1 = left-null; 2 = right-null — so
    null keys form single-side runs and match nothing) followed by the
    order-preserving value lanes (`ops/keys.py`). Strings unify onto one
    merged dictionary first."""
    from hyperspace_tpu_torch.io.columnar import unify_string_columns
    from hyperspace_tpu_torch.ops import keys as keymod

    if len(left_keys) != len(right_keys) or not left_keys:
        raise HyperspaceException("Join requires matching key column lists.")
    device = left.device
    n, m = left.num_rows, right.num_rows
    l_valid = torch.ones(n, dtype=torch.bool, device=device)
    r_valid = torch.ones(m, dtype=torch.bool, device=device)
    l_lanes: List[torch.Tensor] = []
    r_lanes: List[torch.Tensor] = []
    for lk, rk in zip(left_keys, right_keys):
        lcol, rcol = left.column(lk), right.column(rk)
        if lcol.is_string != rcol.is_string:
            raise HyperspaceException(f"Join key type mismatch: {lk} vs {rk}")
        if lcol.is_string:
            lcol, rcol = unify_string_columns(lcol, rcol)
        if lcol.validity is not None:
            l_valid = l_valid & lcol.validity
        if rcol.validity is not None:
            r_valid = r_valid & rcol.validity
        ldata, rdata = lcol.data, rcol.data
        if ldata.dtype != rdata.dtype:
            common = torch.promote_types(ldata.dtype, rdata.dtype)
            ldata, rdata = ldata.to(common), rdata.to(common)
        l_lanes.extend(keymod.key_lanes(ldata))
        r_lanes.extend(keymod.key_lanes(rdata))
    marker_l = torch.where(l_valid, 0, 1).to(torch.int32)
    marker_r = torch.where(r_valid, 0, 2).to(torch.int32)
    return (marker_l, *l_lanes), (marker_r, *r_lanes)


def _run_bounds(differs: torch.Tensor):
    """(run_first, run_last): each sorted element's run's first and last
    position, from the (T-1) adjacent-key-difference vector. int64."""
    T = differs.shape[0] + 1
    device = differs.device
    pos = torch.arange(T, dtype=torch.int64, device=device)
    run_start = torch.cat([torch.ones(1, dtype=torch.bool, device=device),
                           differs])
    run_first = torch.cummax(torch.where(run_start, pos, 0), 0).values
    nxt = torch.flip(torch.cummin(torch.flip(
        torch.where(run_start, pos, T), [0]), 0).values, [0])
    run_last = torch.cat([nxt[1:], torch.full((1,), T, dtype=torch.int64,
                                              device=device)]) - 1
    return run_first, run_last


def _runs_to_counts(differs: torch.Tensor, side_s: torch.Tensor,
                    left_outer: bool):
    """Shared tail of the counting match: per-run right-counts and bracket
    starts from the (T-1) adjacent-key-difference vector over the sorted
    (key, side, orig) sequence. All int64."""
    run_first, run_last = _run_bounds(differs)
    R = torch.cumsum(side_s, 0)  # inclusive right-element count
    rights = R[run_last] - R[run_first] + side_s[run_first]
    rstart = run_last - rights + 1
    counts = torch.where(side_s == 0, rights, 0)
    if left_outer:
        counts = torch.where(side_s == 0, torch.clamp(counts, min=1), 0)
    starts = torch.cumsum(counts, 0) - counts
    return counts, starts, rights, rstart


def _sides(n: int, m: int, device):
    """(side, orig) of the concatenated left+right sequence, int64."""
    side = torch.cat([torch.zeros(n, dtype=torch.int64, device=device),
                      torch.ones(m, dtype=torch.int64, device=device)])
    orig = torch.cat([torch.arange(n, dtype=torch.int64, device=device),
                      torch.arange(m, dtype=torch.int64, device=device)])
    return side, orig


def _counting_match_lanes(lanes_l, lanes_r, left_outer: bool):
    """The counting match over raw key LANES: one stable sort of
    (marker, *value lanes, side, orig), runs from adjacent lane
    differences. The concatenation already lists rows in (side, orig)
    order and every pass is stable, so sorting the key lanes alone gives
    the same order as sorting the trailing (side, orig) operands too —
    the JAX package's order, element for element."""
    from hyperspace_tpu_torch.ops.keys import staged_sort

    n, m = lanes_l[0].shape[0], lanes_r[0].shape[0]
    lanes = [torch.cat([a, b]) for a, b in zip(lanes_l, lanes_r)]
    side, orig = _sides(n, m, lanes[0].device)
    perm, keys_sorted = staged_sort(lanes)
    side_s, orig_s = side[perm], orig[perm]
    differs = torch.zeros(n + m - 1, dtype=torch.bool, device=side.device)
    for k in keys_sorted:
        differs = differs | (k[1:] != k[:-1])
    counts, starts, rights, rstart = _runs_to_counts(differs, side_s,
                                                     left_outer)
    return counts, starts, rights, rstart, orig_s


# Wide join keys route through ONE u64-hash-lane sort instead of the
# multi-lane sort (with a collision re-run). Below this lane count (incl.
# the null-marker lane) the exact sort is used.
HASH_MATCH_MIN_LANES = 4


def _counting_match_lanes_hashed(lanes_l, lanes_r, left_outer: bool):
    """Hashed counting match: sort (u64 key-hash, side, orig), then derive
    runs from the FULL lane differences gathered through the permutation.
    Equal keys share a hash, so runs stay contiguous unless two different
    keys collide; `collision` (a full-key boundary inside an equal-hash
    run) tells the caller to re-run the exact path. The hash is unsigned:
    its int64 bit pattern sorts in unsigned order once the sign bit is
    flipped."""
    from hyperspace_tpu_torch.ops.hash_partition import dual_hash64

    n, m = lanes_l[0].shape[0], lanes_r[0].shape[0]
    lanes = [torch.cat([a, b]) for a, b in zip(lanes_l, lanes_r)]
    h = dual_hash64(lanes) ^ _INT64_SIGN
    side, orig = _sides(n, m, h.device)
    # Stable sort on the hash alone == the sort of (hash, side, orig):
    # the concatenation is already in (side, orig) order.
    perm = torch.sort(h, stable=True).indices
    h_s, side_s, orig_s = h[perm], side[perm], orig[perm]
    differs = torch.zeros(n + m - 1, dtype=torch.bool, device=h.device)
    for k in lanes:
        ks = k[perm]
        differs = differs | (ks[1:] != ks[:-1])
    h_differs = h_s[1:] != h_s[:-1]
    collision = torch.any(differs & ~h_differs)
    counts, starts, rights, rstart = _runs_to_counts(differs, side_s,
                                                     left_outer)
    return counts, starts, rights, rstart, orig_s, collision


def _match_lanes(lanes_l, lanes_r, left_outer: bool):
    """(counts, starts, rights, rstart, orig_s, collision|None): the
    hashed match for wide keys, the exact sort otherwise. A None collision
    needs no verification; a tensor collision is folded into the caller's
    sizing sync, and a true value means re-running `_counting_match_lanes`."""
    if len(lanes_l) >= HASH_MATCH_MIN_LANES:
        return _counting_match_lanes_hashed(lanes_l, lanes_r, left_outer)
    return (*_counting_match_lanes(lanes_l, lanes_r, left_outer), None)


def _packed_sync(value: torch.Tensor, collision: torch.Tensor):
    """ONE device read carrying (sizing value, collision flag): returns
    (int value, collided). `value` must be an int64 scalar tensor."""
    packed = int(value * 2 + collision.to(torch.int64))
    return packed >> 1, bool(packed & 1)


def _empty_pair(device):
    empty = torch.zeros(0, dtype=torch.int64, device=device)
    return empty, empty


def counting_join_batch_indices(left: ColumnBatch, right: ColumnBatch,
                                left_keys: Sequence[str],
                                right_keys: Sequence[str],
                                how: str = "inner") -> Tuple:
    """Device join row-index pairs (int64 tensors) straight from the key
    COLUMNS: one sort+count and one host sync. `how` is inner or
    left_outer (unmatched left rows appear once with right index -1).
    Pair order is the JAX package's: key-sorted for narrow keys, hash-run
    order for wide keys."""
    left_outer = how == "left_outer"
    n, m = left.num_rows, right.num_rows
    device = left.device
    if n == 0 or (m == 0 and not left_outer):
        return _empty_pair(device)
    if m == 0:
        return (torch.arange(n, dtype=torch.int64, device=device),
                torch.full((n,), -1, dtype=torch.int64, device=device))
    lanes_l, lanes_r = _join_lane_operands(left, right, left_keys,
                                           right_keys)
    counts, starts, rights, rstart, orig_s, collision = _match_lanes(
        lanes_l, lanes_r, left_outer)
    if collision is None:
        total = int(counts.sum())  # the one host sync
    else:
        total, collided = _packed_sync(counts.sum(), collision)
        if collided:
            counts, starts, rights, rstart, orig_s = _counting_match_lanes(
                lanes_l, lanes_r, left_outer)
            total = int(counts.sum())
    if total == 0:
        return _empty_pair(device)
    return _counting_expand(counts, starts, rights, rstart, orig_s, total,
                            left_outer)


def _counting_expand(counts, starts, rights, rstart, orig_s, total: int,
                     left_outer: bool):
    T = counts.shape[0]
    rows = torch.repeat_interleave(
        torch.arange(T, dtype=torch.int64, device=counts.device), counts,
        output_size=total)
    slots = torch.arange(total, dtype=torch.int64, device=counts.device)
    offset = slots - starts[rows]
    li = orig_s[rows]
    r_sorted_pos = torch.clamp(rstart[rows] + offset, 0, T - 1)
    ri = orig_s[r_sorted_pos]
    if left_outer:
        ri = torch.where(rights[rows] > 0, ri, -1)
    return li, ri


def unmatched_right_from_indices(ri, num_right: int):
    """Right-row indices absent from a join's right index vector `ri` —
    the rows a FULL OUTER join appends after its left_outer expansion.
    Works on host (numpy) and device (tensor) indices; the device path
    costs one host sync to size the output."""
    if isinstance(ri, np.ndarray):
        matched = np.zeros(num_right, dtype=bool)
        matched[ri[ri >= 0]] = True
        return np.nonzero(~matched)[0].astype(np.int32)
    matched = torch.zeros(num_right, dtype=torch.bool, device=ri.device)
    matched[ri[ri >= 0]] = True
    return torch.nonzero(~matched).squeeze(1)


def semi_anti_indices(left: ColumnBatch, right: ColumnBatch,
                      left_keys: Sequence[str], right_keys: Sequence[str],
                      anti: bool = False):
    """Left-row indices for LEFT SEMI (has >= 1 match) or LEFT ANTI (NOT
    EXISTS: no match; null-key left rows are emitted) joins. Host batches
    compute in numpy; device batches in tensor ops + one host sync."""
    if left.num_rows == 0:
        return (np.zeros(0, dtype=np.int32) if left.is_host
                else torch.zeros(0, dtype=torch.int64, device=left.device))
    if left.is_host and right.is_host:
        if right.num_rows == 0:
            matched = np.zeros(left.num_rows, dtype=bool)
        else:
            packed = _packed_keys(left, right, left_keys, right_keys)
            if packed is not None:
                lv, rv = packed
            else:
                lv, rv = _host_encode_join_keys(left, right, left_keys,
                                                right_keys)
            rs = np.sort(rv)
            matched = (np.searchsorted(rs, lv, side="left")
                       < np.searchsorted(rs, lv, side="right"))
        mask = ~matched if anti else matched
        return np.nonzero(mask)[0].astype(np.int32)
    device = left.device
    if right.num_rows == 0:
        if anti:
            return torch.arange(left.num_rows, dtype=torch.int64,
                                device=device)
        return torch.zeros(0, dtype=torch.int64, device=device)
    # Membership via the one-sort counting match over raw key lanes: with
    # left_outer counting, counts > 0 marks exactly the LEFT elements in
    # sorted space, and `rights` holds each element's run match count.
    # Right elements' orig values may exceed the left's row count, so only
    # left elements are written back to original row order.
    lanes_l, lanes_r = _join_lane_operands(left, right, left_keys,
                                           right_keys)

    def membership_mask(counts, rights, orig_s):
        is_left = counts > 0
        hit = (rights == 0) if anti else (rights > 0)
        mask = torch.zeros(left.num_rows, dtype=torch.bool, device=device)
        mask[orig_s[is_left]] = hit[is_left]
        return mask

    counts, _starts, rights, _rstart, orig_s, collision = _match_lanes(
        lanes_l, lanes_r, True)
    mask = membership_mask(counts, rights, orig_s)
    if collision is not None:
        _, collided = _packed_sync(mask.sum(), collision)
        if collided:  # hash collision: exact re-run
            counts, _starts, rights, _rstart, orig_s = \
                _counting_match_lanes(lanes_l, lanes_r, True)
            mask = membership_mask(counts, rights, orig_s)
    return torch.nonzero(mask).squeeze(1)


def _cat_pair(li, ri, extra):
    """Append the unmatched right rows `extra` (left index -1) to a
    left_outer expansion — the full_outer tail, on either lane."""
    if isinstance(ri, np.ndarray):
        return (np.concatenate([li, np.full(len(extra), -1, dtype=np.int32)]),
                np.concatenate([ri, extra]))
    return (torch.cat([li, torch.full((extra.shape[0],), -1,
                                      dtype=li.dtype, device=li.device)]),
            torch.cat([ri, extra.to(ri.dtype)]))


def sort_merge_join(left: ColumnBatch, right: ColumnBatch,
                    left_keys: Sequence[str], right_keys: Sequence[str],
                    how: str = "inner", columns=None):
    """Join of two batches on equi-keys (inner / left_outer / right_outer
    / full_outer). Neither side needs to be pre-sorted. Both sides are on
    one lane (the caller moves a host side to the device where they
    differ). full_outer = the left_outer expansion plus one appended row
    per unmatched right row. Output column names are left's then right's;
    duplicate names get a `_r` suffix on the right."""
    from hyperspace_tpu_torch.ops.bucketed_join import assemble_join_output

    host = left.is_host and right.is_host
    pairs = host_join_indices if host else counting_join_batch_indices
    if how == "right_outer":
        ri, li = pairs(right, left, right_keys, left_keys, how="left_outer")
    else:
        li, ri = pairs(left, right, left_keys, right_keys,
                       how="left_outer" if how == "full_outer" else how)
        if how == "full_outer":
            li, ri = _cat_pair(li, ri, unmatched_right_from_indices(
                ri, right.num_rows))
    return assemble_join_output(left, right, li, ri, how=how,
                                columns=columns)


# ---------------------------------------------------------------------------
# Host lane (numpy): same join semantics, zero device round-trips.
# ---------------------------------------------------------------------------


def _host_encode_join_keys(left: ColumnBatch, right: ColumnBatch,
                           left_keys: Sequence[str],
                           right_keys: Sequence[str]):
    """Order-preserving dense group ids over host batches, with null
    sentinels -1 (left) / -2 (right) that never compare equal."""
    from hyperspace_tpu_torch.io.columnar import _merged_dictionary
    from hyperspace_tpu_torch.ops.keys import (host_dense_group_ids,
                                               host_key_lanes)

    if len(left_keys) != len(right_keys) or not left_keys:
        raise HyperspaceException("Join requires matching key column lists.")
    n, m = left.num_rows, right.num_rows
    operands: List = []
    l_valid = np.ones(n, dtype=bool)
    r_valid = np.ones(m, dtype=bool)
    for lk, rk in zip(left_keys, right_keys):
        lcol, rcol = left.column(lk), right.column(rk)
        if lcol.is_string != rcol.is_string:
            raise HyperspaceException(f"Join key type mismatch: {lk} vs {rk}")
        if lcol.validity is not None:
            l_valid = l_valid & np.asarray(lcol.validity)
        if rcol.validity is not None:
            r_valid = r_valid & np.asarray(rcol.validity)
        if lcol.is_string:
            _, (remap_l, remap_r), _ = _merged_dictionary(
                [lcol.dictionary, rcol.dictionary], None)
            operands.append(np.concatenate([remap_l[lcol.data],
                                            remap_r[rcol.data]]))
            continue
        ldata, rdata = lcol.data, rcol.data
        if ldata.dtype != rdata.dtype:
            common = np.promote_types(ldata.dtype, rdata.dtype)
            ldata, rdata = ldata.astype(common), rdata.astype(common)
        for ll, rl in zip(host_key_lanes(ldata), host_key_lanes(rdata)):
            operands.append(np.concatenate([ll, rl]))
    validity_key = np.concatenate([l_valid, r_valid])
    perm, group_sorted = host_dense_group_ids([validity_key, *operands])
    groups = np.empty(n + m, dtype=np.int32)
    groups[perm] = group_sorted
    l_ids = np.where(l_valid, groups[:n], np.int32(-1))
    r_ids = np.where(r_valid, groups[n:], np.int32(-2))
    return l_ids, r_ids


def _expand_ranges(lo, hi, how: str):
    """(left_idx, offsets, total) of the ragged expansion of per-left-row
    match ranges [lo, hi); left_outer keeps unmatched rows once."""
    counts = hi - lo
    if how == "left_outer":
        counts = np.maximum(counts, 1)
    total = int(counts.sum())
    left_idx = np.repeat(np.arange(len(lo)), counts)
    starts = np.cumsum(counts) - counts
    offsets = np.arange(total) - starts[left_idx]
    return left_idx, offsets, total


def _host_merge_join_indices(left_ids, right_ids, how: str = "inner"):
    """Join row index pairs of two sorted id arrays (numpy)."""
    lo = np.searchsorted(right_ids, left_ids, side="left")
    hi = np.searchsorted(right_ids, left_ids, side="right")
    left_idx, offsets, total = _expand_ranges(lo, hi, how)
    if total == 0:
        empty = np.zeros(0, dtype=np.int32)
        return empty, empty
    matched = hi[left_idx] > lo[left_idx]
    right_idx = np.where(matched, lo[left_idx] + offsets, -1)
    return left_idx.astype(np.int32), right_idx.astype(np.int32)


def _packed_keys(left: ColumnBatch, right: ColumnBatch,
                 left_keys: Sequence[str], right_keys: Sequence[str]):
    """(left_vals, right_vals) int64/float arrays whose scalar order equals
    the key-tuple lexicographic order, or None when the keys are not
    packable (strings, nulls, ranges too wide). A single numeric key
    returns the values as-is; several integer keys pack into one int64
    via per-column offsets and range products."""
    if len(left_keys) != len(right_keys) or not left_keys:
        raise HyperspaceException("Join requires matching key column lists.")
    lvals, rvals = [], []
    for lk, rk in zip(left_keys, right_keys):
        lcol, rcol = left.column(lk), right.column(rk)
        if (lcol.is_string or rcol.is_string or lcol.validity is not None
                or rcol.validity is not None):
            return None
        ld, rd = np.asarray(lcol.data), np.asarray(rcol.data)
        if ld.dtype != rd.dtype:
            common = np.promote_types(ld.dtype, rd.dtype)
            ld, rd = ld.astype(common), rd.astype(common)
        lvals.append(ld)
        rvals.append(rd)
    if len(lvals) == 1:
        return lvals[0], rvals[0]
    if any(v.dtype.kind == "f" for v in lvals):
        return None  # float digits don't pack
    mins, ranges = [], []
    for ld, rd in zip(lvals, rvals):
        both = [a for a in (ld, rd) if len(a)]
        if not both:
            mins.append(0)
            ranges.append(1)
            continue
        mn = min(int(a.min()) for a in both)
        mx = max(int(a.max()) for a in both)
        mins.append(mn)
        ranges.append(mx - mn + 1)
    capacity = 1
    for r in ranges:
        capacity *= r
        if capacity > 1 << 62:
            return None
    lp = np.zeros(len(lvals[0]), dtype=np.int64)
    rp = np.zeros(len(rvals[0]), dtype=np.int64)
    for ld, rd, mn, r in zip(lvals, rvals, mins, ranges):
        lp = lp * r + (ld.astype(np.int64) - mn)
        rp = rp * r + (rd.astype(np.int64) - mn)
    return lp, rp


def _host_probe_join_indices(lv, rv, how: str) -> Tuple:
    """Probe join over packed scalar keys: sort ONLY the right side, then
    per-left-row match ranges via searchsorted."""
    r_order = np.argsort(rv, kind="stable")
    rs = rv[r_order]
    lo = np.searchsorted(rs, lv, side="left")
    hi = np.searchsorted(rs, lv, side="right")
    left_idx, offsets, total = _expand_ranges(lo, hi, how)
    if total == 0:
        empty = np.zeros(0, dtype=np.int32)
        return empty, empty
    if how == "inner":
        right_idx = r_order[lo[left_idx] + offsets]
    else:
        matched = hi[left_idx] > lo[left_idx]
        right_idx = np.where(
            matched, r_order[np.clip(lo[left_idx] + offsets, 0,
                                     max(len(rv) - 1, 0))], -1)
    return left_idx.astype(np.int32), right_idx.astype(np.int32)


def host_join_indices(left: ColumnBatch, right: ColumnBatch,
                      left_keys: Sequence[str], right_keys: Sequence[str],
                      how: str = "inner") -> Tuple:
    """Join row-index pairs computed on the host (numpy) for host-lane
    batches. `how` is inner or left_outer (callers swap sides for
    right_outer). Null-free numeric keys take the probe path (only the
    build side is sorted); everything else goes through the dense
    group-id encode."""
    empty = np.zeros(0, dtype=np.int32)
    if left.num_rows == 0:
        return empty, empty
    if right.num_rows == 0:
        if how == "left_outer":
            return (np.arange(left.num_rows, dtype=np.int32),
                    np.full(left.num_rows, -1, dtype=np.int32))
        return empty, empty
    packed = _packed_keys(left, right, left_keys, right_keys)
    if packed is not None:
        return _host_probe_join_indices(packed[0], packed[1], how)
    l_ids, r_ids = _host_encode_join_keys(left, right, left_keys, right_keys)
    l_perm = np.argsort(l_ids, kind="stable")
    r_perm = np.argsort(r_ids, kind="stable")
    li_s, ri_s = _host_merge_join_indices(l_ids[l_perm], r_ids[r_perm],
                                          how=how)
    if len(li_s) == 0:
        return li_s, ri_s
    li = l_perm[li_s].astype(np.int32)
    ri = np.where(ri_s >= 0, r_perm[np.clip(ri_s, 0, None)],
                  -1).astype(np.int32)
    return li, ri


def _unsorted_within(key: np.ndarray, bounds: np.ndarray) -> bool:
    """True when `key` is not ascending inside some bucket of the
    cumulative `bounds`."""
    if len(key) <= 1:
        return False
    in_bucket = np.ones(len(key) - 1, dtype=bool)
    boundary = bounds[1:-1]
    boundary = boundary[(boundary > 0) & (boundary < len(key))]
    in_bucket[boundary - 1] = False
    return not (key[1:][in_bucket] >= key[:-1][in_bucket]).all()


def host_bucketed_join_indices(left: ColumnBatch, right: ColumnBatch,
                               l_lengths, r_lengths,
                               left_keys: Sequence[str],
                               right_keys: Sequence[str],
                               how: str = "inner") -> Tuple:
    """Host join over concat-in-bucket-order sides that EXPLOITS the index
    layout: keys within each bucket arrive sorted from the bucketed write,
    so matching is a per-bucket `searchsorted` — no sort, no hash table.
    Fast path: packable null-free numeric keys; anything else takes the
    general host sort join."""
    packed = (None if how not in ("inner", "left_outer")
              else _packed_keys(left, right, left_keys, right_keys))
    if packed is None:
        return host_join_indices(left, right, left_keys, right_keys,
                                 how="left_outer" if how == "left_outer"
                                 else "inner")
    # Packing is monotone in key-tuple order, so within-bucket sortedness
    # of the key tuples carries over to the packed scalars.
    lkey, rkey = packed
    lb = np.concatenate([[0], np.cumsum(l_lengths)]).astype(np.int64)
    rb = np.concatenate([[0], np.cumsum(r_lengths)]).astype(np.int64)

    # The right side must be sorted within each bucket (an Exchange output
    # or a multi-run bucket is not): one vectorized check, repaired with a
    # per-bucket stable sort.
    r_perm = None
    if _unsorted_within(rkey, rb):
        bucket_of = np.searchsorted(rb[1:], np.arange(len(rkey)),
                                    side="right")
        r_perm = np.lexsort((rkey, bucket_of)).astype(np.int64)
        rkey = rkey[r_perm]

    # Native lane: a multithreaded C++ per-bucket merge join emits the
    # (li, ri) pairs directly — no searchsorted pass, no numpy expansion.
    # It needs the LEFT side sorted within buckets too (the index
    # layout's guarantee; repaired above only for the right), so check
    # and fall through when it is not.
    if (lkey.dtype == np.int64 and rkey.dtype == np.int64
            and not _unsorted_within(lkey, lb)):
        from hyperspace_tpu_torch import native
        pairs = native.bucketed_merge_join_i64(
            lkey, rkey, lb, rb, left_outer=(how == "left_outer"))
        if pairs is not None:
            li, ri = pairs
            if r_perm is not None and len(ri):
                ri = np.where(ri >= 0, r_perm[np.clip(ri, 0, None)],
                              -1).astype(np.int32)
            return li, ri

    lo = np.empty(len(lkey), dtype=np.int64)
    hi = np.empty(len(lkey), dtype=np.int64)
    for b in range(len(l_lengths)):
        ls, le = lb[b], lb[b + 1]
        rs, re = rb[b], rb[b + 1]
        if le == ls:
            continue
        lo[ls:le] = rs + np.searchsorted(rkey[rs:re], lkey[ls:le], "left")
        hi[ls:le] = rs + np.searchsorted(rkey[rs:re], lkey[ls:le], "right")
    left_idx, offsets, total = _expand_ranges(lo, hi, how)
    if total == 0:
        empty = np.zeros(0, dtype=np.int32)
        return empty, empty
    if how == "inner":
        # Zero-count rows emit nothing, so every emitted row is a match.
        right_idx = lo[left_idx] + offsets
    else:
        matched = hi[left_idx] > lo[left_idx]
        right_idx = np.where(matched, lo[left_idx] + offsets, -1)
    if r_perm is not None:
        right_idx = np.where(right_idx >= 0,
                             r_perm[np.clip(right_idx, 0, None)], -1)
    return left_idx.astype(np.int32), right_idx.astype(np.int32)
