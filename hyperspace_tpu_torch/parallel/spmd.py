"""The inter-query batched predicate lane (`engine/batcher.py` is its
only caller).

K concurrent point/filter queries over one shared scan differ only in
their predicate CONSTANTS once they share an execution signature
(`engine/batcher.py` groups them). `batched_predicate_masks` evaluates
all K predicates in ONE call through the device seam
(`telemetry/compilation.instrumented_device("serve.batch")`): the
constants ride [K, T] lanes (K padded to a power-of-two bucket by the
batcher) and the result is a [K, N] boolean mask matrix that stays
where the columns live (on the card for a device batch) — the batcher
slices it per query there. Term semantics mirror `engine/compiler.py`'s
definite-truth masks exactly for the supported shapes — numeric
comparisons against literals, integer IN lists, and IS [NOT] NULL — so
a batched member's rows are bit-identical to its solo run:

- a float literal is compared in the column's own float width (numpy's
  weak-scalar promotion on the solo path), an int literal against a
  float column likewise in the column's width;
- an int column against a float literal is compared in float64;
- an int column against an int literal is compared in int64 (exact at
  any width);
- an `in` term checks the column (lifted to int64) against its padded
  value lane (padding repeats a real value, harmless for membership);
- a column with a validity mask is false wherever it is null;
- a constants-free shape (only null-ness terms) evaluates as one row
  and is broadcast to [K, N].

The JAX package evaluates the same program as one jitted XLA
computation; here it is eager torch operations (one kernel launch per
term and lane). The rest of the JAX package's `parallel/spmd.py` (the
born-sharded read, the subshard plans and the SPMD join program,
ROADMAP item 13c) is not ported yet.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from hyperspace_tpu_torch.telemetry.compilation import instrumented_device

__all__ = ["batched_predicate_masks"]

# One shape term is a tuple:
#   ("cmp", op, col_index, lane)       lane: "i" (int64) | "f" (float64)
#   ("in", col_index, padded_len)      int lane, `padded_len` values
#   ("isnull"|"notnull", col_index)
_OPS = {"eq": torch.eq, "ne": torch.ne, "lt": torch.lt, "le": torch.le,
        "gt": torch.gt, "ge": torch.ge}


def _masks_cost(shape, datas, valids, iconst, fconst):
    """Modeled (operations, bytes accessed) for the device seam: every
    referenced column and validity mask read once, the [K, N] mask
    written once; one compare (plus one AND) per row, member and
    compared value."""
    n = int(datas[0].shape[0]) if datas else 0
    k = int(iconst.shape[0])
    read = sum(int(d.numel()) * d.element_size() for d in datas)
    read += sum(int(v.numel()) for v in valids if v is not None)
    ops = 0
    for term in shape:
        width = term[2] if term[0] == "in" else 1
        ops += 2 * n * k * width
    return ops, read + n * k


@instrumented_device("serve.batch", cost=_masks_cost)
def _evaluate(shape: tuple, datas: tuple, valids: tuple,
              iconst: torch.Tensor, fconst: torch.Tensor) -> torch.Tensor:
    """The stacked program over tensors that all live on one device."""
    total: Optional[torch.Tensor] = None
    ii = fi = 0
    for term in shape:
        kind = term[0]
        if kind == "cmp":
            _k, op, ci, lane = term
            data = datas[ci]
            if lane == "f":
                const = fconst[:, fi]
                fi += 1
            else:
                const = iconst[:, ii]
                ii += 1
            if data.dtype.is_floating_point:
                # Compare in the column's own float width (the solo
                # path's weak-scalar promotion).
                const = const.to(data.dtype)
            elif lane == "f":
                # Int column against a float literal: float64 on both
                # paths.
                data = data.to(torch.float64)
            else:
                # Integer compares are exact at any width; lift the
                # column to int64 so the [K] lane broadcasts without
                # narrowing the literal.
                data = data.to(torch.int64)
            m = _OPS[op](data[None, :], const[:, None])
        elif kind == "in":
            _k, ci, padded = term
            vals = iconst[:, ii:ii + padded]
            ii += padded
            data = datas[ci].to(torch.int64)[None, :]
            # One [K, N] compare per padded value (the JAX program's
            # [K, N, P] any() without materializing P copies).
            m = data == vals[:, 0:1]
            for p in range(1, padded):
                m |= data == vals[:, p:p + 1]
        elif kind == "isnull":
            _k, ci = term
            v = valids[ci]
            n = datas[ci].shape[0]
            m = (torch.zeros((1, n), dtype=torch.bool,
                             device=datas[ci].device)
                 if v is None else (~v)[None, :])
        else:  # notnull
            _k, ci = term
            v = valids[ci]
            n = datas[ci].shape[0]
            m = (torch.ones((1, n), dtype=torch.bool,
                            device=datas[ci].device)
                 if v is None else v[None, :])
        if kind in ("cmp", "in"):
            v = valids[term[2] if kind == "cmp" else term[1]]
            if v is not None:
                m = m & v[None, :]
        total = m if total is None else total & m
    # A constants-free shape evaluates as one [1, N] row — broadcast so
    # every member slices its own lane regardless.
    return total.expand(iconst.shape[0], total.shape[1])


def _as_tensor(arr, device: torch.device) -> torch.Tensor:
    """A tensor view of a column (read-only Arrow-owned numpy arrays
    included: the program never writes its inputs)."""
    if isinstance(arr, torch.Tensor):
        return arr
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def batched_predicate_masks(shape: tuple, datas: Sequence,
                            valids: Sequence, iconst, fconst) -> torch.Tensor:
    """THE batched-execution entry point: evaluate the K stacked
    predicates described by `shape` over the shared columns. `datas` is
    one array per referenced column (shape order indexes into it),
    `valids` the matching validity masks (None for a column without
    one), `iconst`/`fconst` the [K_bucket, T] padded constant lanes
    (int64 / float64). Columns are torch tensors on one device (the
    device lane) or numpy arrays (the host lane, evaluated with torch on
    the CPU). Returns the [K_bucket, N] boolean mask matrix on the
    columns' device; callers slice rows per member there."""
    device = next((d.device for d in datas if isinstance(d, torch.Tensor)),
                  torch.device("cpu"))
    datas_t = tuple([_as_tensor(d, device) for d in datas])
    valids_t = tuple([None if v is None else _as_tensor(v, device)
                      for v in valids])
    iconst_t = (iconst.to(device, torch.int64)
                if isinstance(iconst, torch.Tensor)
                else _as_tensor(np.asarray(iconst, dtype=np.int64), device))
    fconst_t = (fconst.to(device, torch.float64)
                if isinstance(fconst, torch.Tensor)
                else _as_tensor(np.asarray(fconst, dtype=np.float64),
                                device))
    return _evaluate(tuple(shape), datas_t, valids_t, iconst_t, fconst_t)
