"""Sketch kernels for data-skipping indexes: zone maps, blocked bloom
filters, and the Z-order clustering permutation.

Build-side math for `index/sketch.py` (blob IO) and
`actions/skipping.py` (the FSM action). Two lanes, one identity:

- DEVICE lane (batches staged through the `TransferEngine` by
  `columnar.from_arrow(device=...)`): per-column min/max/null/NaN
  reductions and the bloom bit-set run as torch operations on the
  batch's device. The bloom scatter-OR is a `torch.bincount` over FLAT
  BIT POSITIONS followed by a pack, as the JAX package writes it
  (`counts.at[flat_bits].add(1)`).
- HOST lane (numpy mirror, used below the device-amortization row
  count): identical results bit-for-bit — the bloom words and zone
  values a query probes against must not depend on which lane built
  them (`tests/test_torch_sketch.py` pins host == device == the JAX
  package's lanes).

Hash identity: blooms hash COLUMN VALUES through the same lanes the
bucket hash uses (`ops/hash_partition.column_hash_lanes` /
`ops/host_hash.host_column_hash_lanes` — strings contribute their
per-dictionary FNV-1a value hashes, numerics their order-preserving
32-bit key lanes, null rows all-zero lanes), mixed into a (h1, h2)
uint32 pair by a dual murmur-style mix. A plan-time literal probes with
`probe_hash_pair(value, dtype)` over the same lanes, so build and probe
can never disagree. The filter layout is a parquet-style SPLIT-BLOCK
bloom: 256-bit blocks of 8 uint32 words, block chosen by h1, one bit
per word from h2 x per-word salt.

Torch has no uint32 shifts, adds or remainders on the CPU, so the device
lane holds every uint32 value in int64 masked to 32 bits and casts only
the packed words; CUDA runs the same operations, so the two devices
cannot drift apart.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.telemetry.compilation import instrumented_device

# Per-word salts of the split-block bloom (parquet's constants).
_SALT = (0x47B6137B, 0x44974D91, 0x8824AD5B, 0xA2B7289D,
         0x705495C7, 0x2DF1424B, 0x9EFC4947, 0x5C6BFB31)
_SEED2 = 0x6A09E667  # second-hash derivation seed (mirrors dual_hash64)

BLOCK_BITS = 256
WORDS_PER_BLOCK = 8


def bloom_num_bits(rows: int, fpp: float, max_bytes: int) -> int:
    """Filter size in bits for `rows` distinct-ish values at target
    false-positive rate `fpp`: the standard -n*ln(p)/ln(2)^2 estimate,
    rounded UP to whole 256-bit blocks and capped at `max_bytes` (a
    huge file degrades to a higher-FPP filter, never an unbounded
    blob)."""
    rows = max(1, int(rows))
    fpp = min(max(float(fpp), 1e-6), 0.5)
    bits = int(math.ceil(-rows * math.log(fpp) / (math.log(2.0) ** 2)))
    blocks = max(1, (bits + BLOCK_BITS - 1) // BLOCK_BITS)
    max_blocks = max(1, (int(max_bytes) * 8) // BLOCK_BITS)
    return min(blocks, max_blocks) * BLOCK_BITS


# ---------------------------------------------------------------------------
# The dual hash (build and probe share it)
# ---------------------------------------------------------------------------


def _dual_mix_host(lanes: Sequence[np.ndarray]):
    """(h1, h2) uint32 pair per row from hash-input lanes (numpy)."""
    from hyperspace_tpu_torch.ops.host_hash import _combine, _fmix32
    u0 = lanes[0].astype(np.uint32)
    h1 = _fmix32(u0)
    h2 = _fmix32(u0 ^ np.uint32(_SEED2))
    for lane in lanes[1:]:
        u = lane.astype(np.uint32)
        h1 = _combine(h1, _fmix32(u))
        h2 = _combine(h2, _fmix32(u ^ np.uint32(_SEED2)))
    return h1, h2


def _dual_mix_device(lanes: Sequence[torch.Tensor]):
    """(h1, h2) per row as int64 tensors holding uint32 values."""
    from hyperspace_tpu_torch.ops.hash_partition import (_combine, _fmix32,
                                                         _u32)
    u0 = _u32(lanes[0])
    h1 = _fmix32(u0)
    h2 = _fmix32(u0 ^ _SEED2)
    for lane in lanes[1:]:
        u = _u32(lane)
        h1 = _combine(h1, _fmix32(u))
        h2 = _combine(h2, _fmix32(u ^ _SEED2))
    return h1, h2


def probe_hash_pair(value, dtype: str) -> Tuple[int, int]:
    """(h1, h2) of ONE literal value under the bloom hash identity —
    what the plan-time rule probes membership with. Raises
    HyperspaceException when the value is not representable in the
    column's dtype (callers treat that as un-refutable)."""
    from hyperspace_tpu_torch.ops.host_hash import _hash_lanes
    try:
        lanes = _hash_lanes([value], dtype)
    except (ValueError, TypeError, OverflowError) as exc:
        raise HyperspaceException(
            f"Unprobeable literal {value!r} for dtype {dtype}") from exc
    h1, h2 = _dual_mix_host(lanes)
    return int(h1[0]), int(h2[0])


# ---------------------------------------------------------------------------
# Bloom build (host + device) and probe
# ---------------------------------------------------------------------------


def _host_bloom_words(h1: np.ndarray, h2: np.ndarray,
                      nbits: int) -> np.ndarray:
    nblocks = nbits // BLOCK_BITS
    words = np.zeros(nblocks * WORDS_PER_BLOCK, dtype=np.uint32)
    block = (h1 % np.uint32(nblocks)).astype(np.int64)
    for j, salt in enumerate(_SALT):
        bit = (h2 * np.uint32(salt)) >> np.uint32(27)
        np.bitwise_or.at(words, block * WORDS_PER_BLOCK + j,
                         np.uint32(1) << bit)
    return words


def _bloom_cost(h1: torch.Tensor, h2: torch.Tensor, nbits: int):
    """Modeled (operations, bytes accessed) for the device seam: both
    hash tensors read once and the nbits/32 int64 words written once;
    per row one block modulo, then a multiply, a shift and an add per
    salt."""
    n = int(h1.numel())
    return (n * (1 + 3 * len(_SALT)),
            n * (h1.element_size() + h2.element_size()) + (nbits // 32) * 8)


@instrumented_device("sketch.bloom", cost=_bloom_cost)
def _device_bloom_words(h1: torch.Tensor, h2: torch.Tensor,
                        nbits: int) -> torch.Tensor:
    """Per-row flat bit positions -> bincount -> packed words (int64
    holding uint32 values), on the tensors' device."""
    from hyperspace_tpu_torch.ops.hash_partition import _mul32

    nblocks = nbits // BLOCK_BITS
    block = h1 % nblocks
    flats = [block * BLOCK_BITS + (j * 32) + (_mul32(h2, salt) >> 27)
             for j, salt in enumerate(_SALT)]
    flat = torch.stack(flats, dim=1).reshape(-1)
    counts = torch.bincount(flat, minlength=nbits)
    bits = (counts > 0).reshape(nbits // 32, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return (bits << shifts).sum(dim=1)


def bloom_build(col, nbits: int) -> np.ndarray:
    """Bloom words (uint32, host) over every row of one column
    (DeviceColumn, host- or device-lane). Null rows insert their
    all-zero lanes — a harmless extra member, never a false negative."""
    if col.is_host:
        from hyperspace_tpu_torch.ops.host_hash import host_column_hash_lanes
        h1, h2 = _dual_mix_host(host_column_hash_lanes(col))
        return _host_bloom_words(h1, h2, nbits)
    from hyperspace_tpu_torch.ops.hash_partition import column_hash_lanes
    h1, h2 = _dual_mix_device(column_hash_lanes(col))
    words = _device_bloom_words(h1, h2, nbits)
    return words.cpu().numpy().astype(np.uint32)


def bloom_maybe_contains(words: np.ndarray, h1: int, h2: int) -> bool:
    """Membership probe: True = value MAY be present (bloom semantics);
    False = definitely absent."""
    nblocks = len(words) // WORDS_PER_BLOCK
    if nblocks <= 0:
        return True
    block = (int(h1) & 0xFFFFFFFF) % nblocks
    for j, salt in enumerate(_SALT):
        bit = (((int(h2) & 0xFFFFFFFF) * salt) & 0xFFFFFFFF) >> 27
        if not (int(words[block * WORDS_PER_BLOCK + j]) >> bit) & 1:
            return False
    return True


# ---------------------------------------------------------------------------
# Zone maps (host + device)
# ---------------------------------------------------------------------------

_FLOAT_DTYPES = ("float32", "float64")


def _zones_cost(data: torch.Tensor, valid: torch.Tensor,
                nan: torch.Tensor):
    """Modeled (operations, bytes accessed) for the device seam: the
    data and the two bool masks read once, five 8-byte facts written;
    eight elementwise operations per row (the ok mask, two selects, min,
    max, two counts and the NaN test)."""
    n = int(data.numel())
    return 8 * n, n * (data.element_size() + 2) + 5 * 8


@instrumented_device("sketch.zones", cost=_zones_cost)
def _device_zones(data: torch.Tensor, valid: torch.Tensor,
                  nan: torch.Tensor):
    """(valid_count, ok_count, has_nan, min, max) as Python scalars, with
    ok = valid AND not-NaN; one device-to-host copy for the counts and
    one for the bounds. Identity fill values keep the min/max defined
    when nothing qualifies (the caller gates on ok_count)."""
    ok = valid & ~nan
    if data.dtype.is_floating_point:
        info = torch.finfo(data.dtype)
    else:
        info = torch.iinfo(data.dtype)
    big = torch.full((), info.max, dtype=data.dtype, device=data.device)
    small = torch.full((), info.min, dtype=data.dtype, device=data.device)
    vmin = torch.where(ok, data, big).min()
    vmax = torch.where(ok, data, small).max()
    counts = torch.stack([valid.sum(dtype=torch.int64),
                          ok.sum(dtype=torch.int64),
                          (valid & nan).any().to(torch.int64)]).tolist()
    bounds = torch.stack([vmin, vmax]).tolist()
    return counts[0], counts[1], bool(counts[2]), bounds[0], bounds[1]


def zones(col) -> dict:
    """Zone-map facts of one column (DeviceColumn, host- or
    device-lane): {"nulls", "ok" (non-null, non-NaN count), "min",
    "max" (python scalars in code space for strings; None when no row
    qualifies), "has_nan"}. String columns reduce over their
    order-preserving dictionary codes; the caller maps the code bounds
    back through the dictionary."""
    n = len(col)
    is_float = col.dtype in _FLOAT_DTYPES and not col.is_string
    is_bool = col.dtype == "bool" and not col.is_string
    if col.is_host:
        data = col.data
        if is_bool:  # min/max over ints (no iinfo for bool)
            data = data.astype(np.int32)
        valid = (col.validity if col.validity is not None
                 else np.ones(n, dtype=bool))
        nan = np.isnan(data) if is_float else np.zeros(n, dtype=bool)
        ok = valid & ~nan
        cnt_valid = int(valid.sum())
        cnt_ok = int(ok.sum())
        vmin = data[ok].min().item() if cnt_ok else None
        vmax = data[ok].max().item() if cnt_ok else None
        has_nan = bool((valid & nan).any())
    elif n == 0:
        cnt_valid = cnt_ok = 0
        vmin = vmax = None
        has_nan = False
    else:
        data = col.data
        if is_bool:
            data = data.to(torch.int32)
        valid = (col.validity if col.validity is not None
                 else torch.ones(n, dtype=torch.bool, device=data.device))
        nan = (torch.isnan(data) if is_float
               else torch.zeros(n, dtype=torch.bool, device=data.device))
        cnt_valid, cnt_ok, has_nan, vmin, vmax = _device_zones(data, valid,
                                                               nan)
        if not cnt_ok:
            vmin = vmax = None
    return {"nulls": n - cnt_valid, "ok": cnt_ok, "min": vmin,
            "max": vmax, "has_nan": has_nan}


# ---------------------------------------------------------------------------
# Z-order clustering permutation
# ---------------------------------------------------------------------------

# Quantile resolution per column: 16 bits (65536 quantiles) is plenty
# for file-level clustering and keeps up to 4 interleaved columns in
# one uint64 z-value.
_Z_BITS_MAX = 16


def zorder_permutation(batch, columns: Sequence[str]) -> np.ndarray:
    """Stable row permutation clustering `batch` by the Z-order
    (Morton) interleave of `columns`. Each column is RANK-normalized
    first (dense quantiles via its order-preserving sort lanes, nulls
    first) so low-entropy or skewed value ranges still interleave
    meaningfully, then the quantile bits are woven MSB-first. One
    column degenerates to a plain sort. Host-side: the build's row
    gather and parquet encode are host work already, and the rank pass
    is one lexsort per column."""
    from hyperspace_tpu_torch.ops.keys import host_column_sort_lanes

    n = batch.num_rows
    if n == 0:
        return np.arange(0, dtype=np.int64)
    k = max(1, len(columns))
    bits = min(_Z_BITS_MAX, 64 // k)
    quantized: List[np.ndarray] = []
    for name in columns:
        lanes = host_column_sort_lanes(batch.column(name))
        order = np.lexsort(tuple(reversed([np.asarray(l) for l in lanes])))
        rank = np.empty(n, dtype=np.uint64)
        rank[order] = np.arange(n, dtype=np.uint64)
        quantized.append((rank * np.uint64(1 << bits))
                         // np.uint64(n))
    z = np.zeros(n, dtype=np.uint64)
    for i in range(bits):
        shift = np.uint64(bits - 1 - i)
        for q in quantized:
            z = (z << np.uint64(1)) | ((q >> shift) & np.uint64(1))
    return np.argsort(z, kind="stable").astype(np.int64)
