"""Broadcast-style dimension join: replicate a SMALL unique-keyed build
side and match probe rows by direct-address lookup — no Exchange, no sort
of the probe side.

The reference gets BroadcastHashJoin from Spark for dimension joins
(`spark.sql.autoBroadcastJoinThreshold`); its E2E suite has to DISABLE
broadcast to even exercise the bucketed SMJ path
(`E2EHyperspaceRulesTests.scala:42`). This engine's general join is the
counting join (`ops/join.py`), whose cost is a joint sort of probe+build
rows — for a fact x dimension join pure overhead.

The equivalent of a hash table here is a dense lookup TABLE over the
build-side key range: dimension surrogate keys are dense integers, so the
table size ~ build rows. Build: pack each build key tuple into one int64
digit space and scatter build row ids into the table (numpy — the build
side is small). Probe: one gather per probe row + range/validity masks, on
the probe's lane. The table crosses to the device once.

Eligibility is decided at RUN time from the build side: integer-family
keys on both sides, key-tuple digit space <= `_MAX_TABLE` slots, and
unique non-null build key tuples. Anything else returns None and the
caller runs the counting join — same results, without the shortcut.

SQL join-null semantics: a NULL in any key column on either side matches
nothing.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch.io.columnar import ColumnBatch

# Integer-family dtypes whose values join by exact integer identity
# (date32/timestamp are day/us counts; bool is 0/1). Floats are excluded:
# the float key identity normalizes -0.0/NaN through order lanes
# (`ops/keys.py`), which a raw int cast would diverge from.
_INT_DTYPES = ("int8", "int16", "int32", "int64", "date32", "timestamp",
               "bool")

# Table slot cap: 16M int32 slots = 64 MB.
_MAX_TABLE = 1 << 24


def _numpy(a):
    return a if isinstance(a, np.ndarray) else a.cpu().numpy()


def _int_key_arrays(batch: ColumnBatch, keys: Sequence[str], to_numpy: bool):
    """Per-key arrays + combined validity, or None when any key is outside
    the integer family. `to_numpy` pulls device columns to the host
    (build side only — small)."""
    arrays = []
    valid = None
    for k in keys:
        col = batch.column(k)
        if col.is_string or col.dtype not in _INT_DTYPES:
            return None
        arrays.append(_numpy(col.data) if to_numpy else col.data)
        if col.validity is not None:
            v = _numpy(col.validity) if to_numpy else col.validity
            valid = v if valid is None else (valid & v)
    return arrays, valid


def _pack_table(arrays, fill_rows):
    """(table, mins, ranges) over the valid build key arrays, with
    `fill_rows` written at each packed key, or None past `_MAX_TABLE`."""
    mins = [int(a.min()) for a in arrays]
    ranges = []
    capacity = 1
    for a, mn in zip(arrays, mins):
        r = int(a.max()) - mn + 1
        ranges.append(r)
        capacity *= r
        if capacity > _MAX_TABLE:
            return None
    packed = np.zeros(len(arrays[0]), dtype=np.int64)
    for a, mn, r in zip(arrays, mins, ranges):
        packed = packed * r + (a - mn)
    table = np.full(capacity, -1, dtype=np.int32)
    table[packed] = fill_rows
    return table, mins, ranges


def _empty_table(n_keys: int):
    """All build keys NULL: nothing can match — a 1-slot empty table keeps
    the probe path uniform."""
    return np.full(1, -1, dtype=np.int32), [0] * n_keys, [1] * n_keys


def build_broadcast_table(build: ColumnBatch, build_keys: Sequence[str]):
    """(table, mins, ranges) for the build side, or None when ineligible.
    `table[packed_key] = build row id`, -1 elsewhere; `mins`/`ranges`
    define the per-column digit packing probe rows must mirror."""
    m = build.num_rows
    if m == 0:
        return None
    prep = _int_key_arrays(build, build_keys, to_numpy=True)
    if prep is None:
        return None
    arrays, valid = prep
    arrays = [np.asarray(a, dtype=np.int64) for a in arrays]
    if valid is not None:
        if not valid.any():
            return _empty_table(len(arrays))
        arrays = [a[valid] for a in arrays]
    rows = (np.nonzero(valid)[0] if valid is not None
            else np.arange(m)).astype(np.int32)
    out = _pack_table(arrays, rows)
    # Uniqueness: every valid build row must own its slot (duplicates
    # overwrote each other — detect by occupancy count).
    if out is None or int((out[0] >= 0).sum()) != len(rows):
        return None
    return out


def _probe_lookup(probe: ColumnBatch, probe_keys: Sequence[str], table,
                  mins, ranges):
    """(build_row_or_minus1, matched) per probe row, on the probe's lane.
    None when a probe key is outside the integer family. On the device
    lane `table` may be a host array or a tensor on the probe's device."""
    prep = _int_key_arrays(probe, probe_keys, to_numpy=probe.is_host)
    if prep is None:
        return None
    arrays, valid = prep
    n = probe.num_rows
    if probe.is_host:
        ok = np.ones(n, dtype=bool) if valid is None else np.asarray(valid)
        idx = np.zeros(n, dtype=np.int64)
        for a, mn, r in zip(arrays, mins, ranges):
            av = np.asarray(a).astype(np.int64)
            # Range-check on the ORIGINAL values (comparisons cannot
            # wrap); `av - mn` can wrap for adversarial keys, and a
            # wrapped digit must never slip into [0, r) as a false match.
            ok = ok & (av >= mn) & (av <= mn + (r - 1))
            idx = idx * r + np.clip(av - mn, 0, r - 1)
        hit = np.where(ok, np.take(table, np.where(ok, idx, 0)),
                       np.int32(-1)).astype(np.int32)
        return hit, hit >= 0
    device = probe.device
    # A fused stage passes the table already on the device
    # (`engine/fusion._to_device`); the eager join passes the host table.
    table_t = (table if isinstance(table, torch.Tensor)
               else torch.from_numpy(table).to(device))
    ok = (torch.ones(n, dtype=torch.bool, device=device) if valid is None
          else valid)
    idx = torch.zeros(n, dtype=torch.int64, device=device)
    for a, mn, r in zip(arrays, mins, ranges):
        av = a.to(torch.int64)
        ok = ok & (av >= mn) & (av <= mn + (r - 1))
        idx = idx * r + torch.clamp(av - mn, 0, r - 1)
    hit = torch.where(ok, table_t[torch.where(ok, idx, 0)], -1)
    return hit.to(torch.int64), hit >= 0


def broadcast_join_indices(probe: ColumnBatch, build: ColumnBatch,
                           probe_keys: Sequence[str],
                           build_keys: Sequence[str],
                           how: str) -> Optional[Tuple]:
    """(probe_idx, build_idx) row-index pairs for `how` in inner /
    left_outer (probe plays left), or None when the direct-address path is
    ineligible. With unique build keys every probe row matches at most
    once: left_outer is the identity on probe rows and inner one
    mask-compress."""
    prep = build_broadcast_table(build, build_keys)
    if prep is None:
        return None
    looked = _probe_lookup(probe, probe_keys, *prep)
    if looked is None:
        return None
    hit, matched = looked
    n = probe.num_rows
    if probe.is_host:
        if how == "left_outer":
            return np.arange(n, dtype=np.int32), hit
        li = np.nonzero(matched)[0].astype(np.int32)
        return li, hit[li]
    if how == "left_outer":
        return torch.arange(n, dtype=torch.int64, device=hit.device), hit
    li = torch.nonzero(matched).squeeze(1)
    return li, hit[li]


def build_membership_table(build: ColumnBatch, build_keys: Sequence[str]):
    """(table, mins, ranges) occupancy table over the build side's valid
    key tuples (duplicates allowed — existence is all membership needs),
    or None when ineligible."""
    prep = _int_key_arrays(build, build_keys, to_numpy=True)
    if prep is None:
        return None
    arrays, valid = prep
    arrays = [np.asarray(a, dtype=np.int64) for a in arrays]
    if valid is not None:
        arrays = [a[valid] for a in arrays]
        if len(arrays[0]) == 0:
            return _empty_table(len(build_keys))
    return _pack_table(arrays, 1)


def broadcast_membership(probe: ColumnBatch, build: ColumnBatch,
                         probe_keys: Sequence[str],
                         build_keys: Sequence[str], anti: bool):
    """Probe-row indices for LEFT SEMI (matched) / LEFT ANTI (unmatched —
    NULL-key probe rows are emitted, NOT EXISTS semantics), or None when
    ineligible. Membership tolerates duplicate build keys."""
    if build.num_rows == 0:
        return None  # callers' empty-side paths are already exact
    prep = build_membership_table(build, build_keys)
    if prep is None:
        return None
    looked = _probe_lookup(probe, probe_keys, *prep)
    if looked is None:
        return None
    _hit, matched = looked
    want = ~matched if anti else matched
    if probe.is_host:
        return np.nonzero(want)[0].astype(np.int32)
    return torch.nonzero(want).squeeze(1)
