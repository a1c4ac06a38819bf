"""Loader for the native host library (ctypes, no pybind11).

`hyperspace_host.cpp` (beside this file) holds the host lane's hot
loops in C++: the FNV-1a string hash over Arrow's packed string buffers,
the stable LSD radix sorts behind the build's (bucket, *keys)
permutation and the host sort, and a multithreaded per-bucket merge
join. The library is built with `g++` at first use, into
`hyperspace_tpu_torch/_build/` (listed in `.gitignore`), and named by a
hash of its source and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. Nothing runs at import time.

Every entry point returns None when the library is unavailable (no
`g++` on the machine) and the caller takes its numpy lane; each such
fallback counts `native.unavailable`, so a run can prove the library
carried its path. A build that runs and fails raises. The build is
counted by the compile seam (`telemetry/compilation.py`) as
`compile.hyperspace_host.traces`; a load of an existing library as a
`compile.cache_hits`.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
import time
from typing import Optional

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "hyperspace_host.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_attempted = False
# Seconds the last `get_lib` spent building (0.0 when the library was
# already built) — `chip_smoke.py` reports it.
build_seconds: Optional[float] = None


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode()
                                ).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libhyperspace_host-{digest}.so")


def _build(out: str) -> bool:
    """Build the library into `out`. False when there is no `g++` (the
    numpy lanes take over); a compile that fails raises."""
    from hyperspace_tpu_torch.exceptions import HyperspaceException
    from hyperspace_tpu_torch.telemetry import compilation

    os.makedirs(BUILD_DIR, exist_ok=True)
    cause = compilation.build_cause(BUILD_DIR, "libhyperspace_host-",
                                    "native/hyperspace_host.cpp")
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCE],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
    except FileNotFoundError as exc:
        logger.warning("No g++ for the native host library (the numpy "
                       "lanes take over): %s", exc)
        return False
    except subprocess.CalledProcessError as exc:
        raise HyperspaceException(
            f"g++ failed for {os.path.basename(SOURCE)} (exit "
            f"{exc.returncode}):\n"
            + exc.stderr.decode(errors="replace")) from exc
    except subprocess.TimeoutExpired as exc:
        raise HyperspaceException(
            f"g++ timed out for {os.path.basename(SOURCE)}") from exc
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    compilation.record_build("hyperspace_host", time.perf_counter() - t0,
                             cause)
    return True


def _declare(lib: ctypes.CDLL) -> None:
    vp, i64, i32, c_int = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                           ctypes.c_int)
    for suffix in ("i32", "i64"):
        fn = getattr(lib, f"fnv1a64_batch_{suffix}")
        fn.restype = None
        fn.argtypes = [vp, vp, i64, vp]
    lib.bucketed_merge_join_count_i64.restype = None
    lib.bucketed_merge_join_count_i64.argtypes = [
        vp, vp, vp, vp, i64, c_int, c_int, vp]
    lib.bucketed_merge_join_fill_i64.restype = None
    lib.bucketed_merge_join_fill_i64.argtypes = [
        vp, vp, vp, vp, i64, c_int, c_int, vp, vp, vp]
    lib.bucket_key_sort_perm.restype = None
    lib.bucket_key_sort_perm.argtypes = [vp, i64, i64, vp, i32, vp, vp, vp]
    lib.key_sort_perm_u64.restype = None
    lib.key_sort_perm_u64.argtypes = [i64, vp, i32, vp]


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it first if needed; None when there
    is no `g++` or the library does not load (the attempt is made once
    per process). A compile that fails raises."""
    global _lib, _load_attempted, build_seconds
    with _lock:
        if _lib is not None or _load_attempted:
            return _lib
        t0 = time.perf_counter()
        out = library_path()
        if os.path.exists(out):
            from hyperspace_tpu_torch.telemetry import compilation
            compilation.record_cache_hit("hyperspace_host")
        elif not _build(out):  # a failed compile raises, and is retried
            _load_attempted = True
            return None
        _load_attempted = True
        build_seconds = time.perf_counter() - t0
        try:
            lib = ctypes.CDLL(out)
            _declare(lib)
            _lib = lib
        except (OSError, AttributeError) as exc:
            logger.warning("Native host library load failed: %s", exc)
        return _lib


def _unavailable():
    """Count one fallback to the numpy lane; returns None."""
    from hyperspace_tpu_torch import telemetry
    telemetry.get_registry().counter("native.unavailable").inc()
    return None


def _ptr(arr) -> ctypes.c_void_p:
    return arr.ctypes.data_as(ctypes.c_void_p)


def arrow_string_hash64(arr) -> Optional["numpy.ndarray"]:
    """FNV-1a 64 over each element of an Arrow string array, operating
    directly on its packed offset/data buffers (no per-value Python).
    Returns None if the library is unavailable or the array has nulls."""
    import numpy as np
    import pyarrow as pa

    lib = get_lib()
    if lib is None:
        return _unavailable()
    if hasattr(arr, "combine_chunks"):
        arr = arr.combine_chunks()
    if arr.null_count:
        return None
    large = pa.types.is_large_string(arr.type)
    _validity, offsets_buf, data_buf = arr.buffers()
    off_dtype = np.int64 if large else np.int32
    # Offset values index the shared data buffer absolutely, so a sliced
    # array only shifts where reading of the offsets buffer STARTS.
    offsets = np.frombuffer(offsets_buf, dtype=off_dtype, count=len(arr) + 1,
                            offset=arr.offset * np.dtype(off_dtype).itemsize)
    out = np.empty(len(arr), dtype=np.uint64)
    data_ptr = data_buf.address if data_buf is not None else 0
    fn = lib.fnv1a64_batch_i64 if large else lib.fnv1a64_batch_i32
    fn(ctypes.c_void_p(data_ptr), _ptr(offsets), ctypes.c_int64(len(arr)),
       _ptr(out))
    return out


def string_hash64(values) -> Optional["numpy.ndarray"]:
    """FNV-1a 64 over a numpy array of strings. None when the library is
    unavailable."""
    import numpy as np
    import pyarrow as pa

    if get_lib() is None:
        return _unavailable()
    values = np.asarray(values)
    if values.dtype.kind != "U":
        values = values.astype(object)
    return arrow_string_hash64(pa.array(values, type=pa.string()))


def pack_sort_words(lanes):
    """Pack order-preserving uint32 sort lanes (most significant first)
    into uint64 words for the radix sorts. Accepts the lane dtypes
    `ops/keys.host_column_sort_lanes` produces: bool validity (False =
    null sorts first), signed int8/16/32 (biased to order-equivalent
    uint32), and uint32. Returns a list of C-contiguous uint64 arrays, or
    None when a lane's dtype can't be mapped (the caller falls back to
    np.lexsort)."""
    import numpy as np

    u32 = []
    for lane in lanes:
        lane = np.asarray(lane)
        if lane.dtype == np.bool_:
            u32.append(lane.astype(np.uint32))
        elif lane.dtype == np.int32:
            u32.append(lane.view(np.uint32) ^ np.uint32(0x80000000))
        elif lane.dtype == np.uint32:
            u32.append(lane)
        elif lane.dtype in (np.int8, np.int16):
            u32.append(lane.astype(np.int32).view(np.uint32)
                       ^ np.uint32(0x80000000))
        else:
            return None
    if len(u32) % 2:
        u32.insert(0, None)  # zero-pad the most significant word's hi lane
    words = []
    for hi, lo in zip(u32[0::2], u32[1::2]):
        w = lo.astype(np.uint64)
        if hi is not None:
            w |= hi.astype(np.uint64) << np.uint64(32)
        words.append(np.ascontiguousarray(w))
    return words


def key_sort_perm(n: int, lanes):
    """Stable ascending sort permutation over `lanes` (no bucket
    grouping) via the native radix. Returns an int32 permutation or None
    (library unavailable, unsupported lane dtype, or n >= 2^31)."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return _unavailable()
    if n >= 1 << 31:
        return None  # int32 permutation indices would wrap
    words = pack_sort_words(lanes)
    if words is None:
        return None
    perm = np.empty(n, dtype=np.int32)
    word_ptrs = (ctypes.c_void_p * len(words))(
        *[_ptr(w).value for w in words])
    lib.key_sort_perm_u64(ctypes.c_int64(n), word_ptrs,
                          ctypes.c_int32(len(words)), _ptr(perm))
    return perm


def bucket_key_sort_perm(bucket_ids, num_buckets: int, lanes):
    """Stable (bucket, *lanes) ascending sort permutation + per-bucket
    bounds via the native radix sort — the index build's host lane.
    Returns (perm int32, starts int64, ends int64) or None when the
    library is unavailable, a lane dtype is unsupported, or n >= 2^31."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return _unavailable()
    bucket_ids = np.ascontiguousarray(bucket_ids, dtype=np.int32)
    n = len(bucket_ids)
    if n >= 1 << 31:
        return None  # the int64-permutation lanes take over
    words = pack_sort_words(lanes)
    if words is None:
        return None
    perm = np.empty(n, dtype=np.int32)
    starts = np.empty(num_buckets, dtype=np.int64)
    ends = np.empty(num_buckets, dtype=np.int64)
    word_ptrs = (ctypes.c_void_p * len(words))(
        *[_ptr(w).value for w in words])
    lib.bucket_key_sort_perm(
        _ptr(bucket_ids), ctypes.c_int64(n), ctypes.c_int64(num_buckets),
        word_ptrs, ctypes.c_int32(len(words)), _ptr(perm), _ptr(starts),
        _ptr(ends))
    return perm, starts, ends


def bucketed_merge_join_i64(lkey, rkey, lbounds, rbounds,
                            left_outer: bool = False):
    """Multithreaded per-bucket sorted merge join over int64 keys in the
    bucket-major index layout. `lbounds`/`rbounds` are the B+1 cumulative
    bucket boundaries; both sides must be sorted within each bucket.
    Returns (li, ri) int32 row-index pairs (ri -1 for unmatched left rows
    under left_outer), or None when the library is unavailable."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return _unavailable()
    lkey = np.ascontiguousarray(lkey, dtype=np.int64)
    rkey = np.ascontiguousarray(rkey, dtype=np.int64)
    lbounds = np.ascontiguousarray(lbounds, dtype=np.int64)
    rbounds = np.ascontiguousarray(rbounds, dtype=np.int64)
    B = len(lbounds) - 1
    n_threads = min(os.cpu_count() or 1, 16)
    outer = ctypes.c_int(1 if left_outer else 0)
    counts = np.zeros(B, dtype=np.int64)
    lib.bucketed_merge_join_count_i64(
        _ptr(lkey), _ptr(rkey), _ptr(lbounds), _ptr(rbounds),
        ctypes.c_int64(B), outer, ctypes.c_int(n_threads), _ptr(counts))
    offsets = np.zeros(B, dtype=np.int64)
    if B > 1:
        np.cumsum(counts[:-1], out=offsets[1:])
    total = int(counts.sum())
    li = np.empty(total, dtype=np.int32)
    ri = np.empty(total, dtype=np.int32)
    if total:
        lib.bucketed_merge_join_fill_i64(
            _ptr(lkey), _ptr(rkey), _ptr(lbounds), _ptr(rbounds),
            ctypes.c_int64(B), outer, ctypes.c_int(n_threads),
            _ptr(offsets), _ptr(li), _ptr(ri))
    return li, ri
