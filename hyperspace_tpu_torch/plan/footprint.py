"""On-disk byte accounting for plans — the stamped file-size cache.

Every Scan's operator record carries the raw on-disk bytes behind its
read (`bytes_scanned`), and serving traffic re-scans the same hot index
files — but a file rewritten in place (source data appends, a
hybrid-scan dir, an object-store overwrite) must not keep reporting its
old size. Entries validate against the same (size, mtime) stamp the
parquet caches use (`io/parquet._file_stamp`) — and since the stamp
CARRIES the size, a validated hit and a revalidation cost the same
single stat. The index-FSM invalidation hook (`io/segcache.py`)
additionally sweeps entries under a committed index root
(`invalidate_sizes`).

The JAX package's admission-control projection (`projected_bytes` and
its constants) waits for the serving plane (`ROADMAP.md`).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

__all__ = ["file_sizes_total", "invalidate_sizes"]

_size_cache: Dict[str, Tuple[object, int]] = {}


def _file_size(path: str) -> int:
    from hyperspace_tpu_torch.io.parquet import _file_stamp
    try:
        stamp = _file_stamp(path)
    except OSError:
        stamp = None
    if stamp is None:
        # Unstampable (directory, no mtime, stat failure): unknowable —
        # never cached.
        _size_cache.pop(path, None)
        return -1
    cached = _size_cache.get(path)
    if cached is not None and cached[0] == stamp:
        return cached[1]
    size = int(stamp[0])
    if len(_size_cache) > 65536:  # bound the cache
        _size_cache.clear()
    _size_cache[path] = (stamp, size)
    return size


def invalidate_sizes(prefix: str) -> None:
    """Drop cached sizes for every file under `prefix` (the index-FSM
    invalidation hook — a refresh/optimize/vacuum boundary must not
    leave readers with pre-commit sizes)."""
    prefix = prefix.rstrip("/\\")
    for path in [p for p in list(_size_cache)
                 if p == prefix or p.startswith(prefix + "/")
                 or p.startswith(prefix + os.sep)]:
        _size_cache.pop(path, None)


def file_sizes_total(files) -> int:
    """Summed on-disk bytes of `files` through the stamp-validated size
    cache. Unstatable files contribute 0 — this is a telemetry input,
    not a correctness one."""
    total = 0
    for f in files:
        size = _file_size(f)
        if size > 0:
            total += size
    return total
