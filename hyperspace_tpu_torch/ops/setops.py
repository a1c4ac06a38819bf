"""Set operations: INTERSECT / EXCEPT with SQL DISTINCT semantics.

Output = DISTINCT rows of the left side present in (intersect) / absent
from (except) the right side. Row identity treats NULL as equal to NULL
(SQL set-op semantics — joins do the opposite), so validity participates
as a leading key lane and null slots' payloads are zeroed to one
canonical value before lane decomposition.

Device lane: one stable lexicographic sort of both sides' lanes
(`ops/keys.staged_sort`) -> dense group ids -> right-presence scatter +
first-left-occurrence `scatter_reduce_` (amin) -> selection mask, plus the
single host sync that sizes the output. Host lane: the numpy mirror over
`host_dense_group_ids`.

The reference serializes Catalyst Intersect/Except for exactly these
queries (`index/serde/package.scala:64-167`); execution there is Spark's.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.io.columnar import (ColumnBatch,
                                              host_batch_to_device,
                                              unify_string_columns)


def _check_types(lcol, rcol, name: str) -> None:
    if lcol.is_string != rcol.is_string:
        raise HyperspaceException(f"Set-op column type mismatch: {name}")


def _device_lanes(left: ColumnBatch, right: ColumnBatch,
                  names: Sequence[str]) -> List[torch.Tensor]:
    from hyperspace_tpu_torch.ops.keys import key_lanes

    device = left.device if left.device is not None else right.device
    if left.is_host:
        left = host_batch_to_device(left, device)
    if right.is_host:
        right = host_batch_to_device(right, device)
    n, m = left.num_rows, right.num_rows
    lanes: List[torch.Tensor] = []
    for name in names:
        lcol, rcol = left.column(name), right.column(name)
        _check_types(lcol, rcol, name)
        if lcol.is_string:
            lcol, rcol = unify_string_columns(lcol, rcol)
        lv = (torch.ones(n, dtype=torch.bool, device=device)
              if lcol.validity is None else lcol.validity)
        rv = (torch.ones(m, dtype=torch.bool, device=device)
              if rcol.validity is None else rcol.validity)
        lanes.append(torch.cat([lv, rv]).to(torch.int32))
        ldata, rdata = lcol.data, rcol.data
        if ldata.dtype != rdata.dtype:
            common = torch.promote_types(ldata.dtype, rdata.dtype)
            ldata, rdata = ldata.to(common), rdata.to(common)
        # Null slots -> one canonical payload so all NULLs compare equal.
        ldata = torch.where(lv, ldata, ldata.new_zeros(()))
        rdata = torch.where(rv, rdata, rdata.new_zeros(()))
        for ll, rl in zip(key_lanes(ldata), key_lanes(rdata)):
            lanes.append(torch.cat([ll, rl]))
    return lanes


def _setop_core(lanes: Sequence[torch.Tensor], n: int, anti: bool):
    """(mask over the left rows, its count as a device scalar)."""
    from hyperspace_tpu_torch.ops.keys import staged_sort

    total = lanes[0].shape[0]
    device = lanes[0].device
    perm, sorted_ops = staged_sort(list(lanes))
    differs = torch.zeros(total, dtype=torch.int64, device=device)
    for k in sorted_ops:
        differs[1:] |= (k[1:] != k[:-1]).to(torch.int64)
    groups = torch.empty(total, dtype=torch.int64, device=device)
    groups[perm] = torch.cumsum(differs, 0)
    l_ids, r_ids = groups[:n], groups[n:]
    present_r = torch.zeros(total, dtype=torch.bool, device=device)
    present_r[r_ids] = True
    member = present_r[l_ids]
    iota = torch.arange(n, dtype=torch.int64, device=device)
    first = torch.full((total,), n, dtype=torch.int64,
                       device=device).scatter_reduce_(
        0, l_ids, iota, "amin", include_self=True)
    keep = iota == first[l_ids]
    mask = keep & (~member if anti else member)
    return mask, mask.sum()


def _host_indices(left: ColumnBatch, right: ColumnBatch,
                  names: Sequence[str], anti: bool) -> np.ndarray:
    from hyperspace_tpu_torch.io.columnar import _merged_dictionary
    from hyperspace_tpu_torch.ops.keys import (host_dense_group_ids,
                                               host_key_lanes)

    n, m = left.num_rows, right.num_rows
    lanes: List = []
    for name in names:
        lcol, rcol = left.column(name), right.column(name)
        _check_types(lcol, rcol, name)
        if lcol.is_string:
            _, (rl, rr), _ = _merged_dictionary(
                [lcol.dictionary, rcol.dictionary], device=None)
            ldata = rl[np.asarray(lcol.data)]
            rdata = rr[np.asarray(rcol.data)]
        else:
            ldata, rdata = np.asarray(lcol.data), np.asarray(rcol.data)
            if ldata.dtype != rdata.dtype:
                common = np.promote_types(ldata.dtype, rdata.dtype)
                ldata, rdata = ldata.astype(common), rdata.astype(common)
        lv = (np.ones(n, bool) if lcol.validity is None
              else np.asarray(lcol.validity))
        rv = (np.ones(m, bool) if rcol.validity is None
              else np.asarray(rcol.validity))
        lanes.append(np.concatenate([lv, rv]).astype(np.int32))
        # Null slots -> one canonical payload so all NULLs compare equal.
        ldata = np.where(lv, ldata, np.zeros((), ldata.dtype))
        rdata = np.where(rv, rdata, np.zeros((), rdata.dtype))
        for ll, rl_ in zip(host_key_lanes(ldata), host_key_lanes(rdata)):
            lanes.append(np.concatenate([ll, rl_]))
    perm, gid_sorted = host_dense_group_ids(lanes)
    groups = np.empty(n + m, dtype=np.int32)
    groups[perm] = gid_sorted
    l_ids, r_ids = groups[:n], groups[n:]
    present_r = np.zeros(n + m, dtype=bool)
    present_r[r_ids] = True
    member = present_r[l_ids]
    first = np.full(n + m, n, dtype=np.int64)
    np.minimum.at(first, l_ids, np.arange(n))
    keep = np.arange(n) == first[l_ids]
    mask = keep & (~member if anti else member)
    return np.nonzero(mask)[0].astype(np.int32)


def set_op_indices(left: ColumnBatch, right: ColumnBatch,
                   names: Sequence[str], anti: bool):
    """Left-row indices of the set-op result, in first-occurrence order:
    a numpy int32 array when both sides are host batches (or the result
    is empty), else an int64 tensor on the device.
    `anti=False` -> INTERSECT, `anti=True` -> EXCEPT."""
    if left.num_rows == 0:
        return np.zeros(0, dtype=np.int32)
    if right.num_rows == 0 and not anti:
        return np.zeros(0, dtype=np.int32)
    if left.is_host and right.is_host:
        return _host_indices(left, right, names, anti)
    lanes = _device_lanes(left, right, names)
    mask, cnt = _setop_core(lanes, left.num_rows, anti)
    if int(cnt) == 0:  # the one host sync
        return np.zeros(0, dtype=np.int32)
    return torch.nonzero(mask).squeeze(1)
