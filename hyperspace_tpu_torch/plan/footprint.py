"""Projected per-query memory footprint — the admission-control input.

The serving plane (`engine/scheduler.py`) admits each query against a
byte budget; what it needs from the plan layer is a CONSERVATIVE
estimate of how much host+device working memory executing the plan may
pin at once. Exact answers are impossible before execution (selectivity,
join fan-out), so the estimate is deliberately simple and biased high:

- every Scan contributes the total on-disk size of its files times
  `DECODE_EXPANSION` (parquet is column-compressed; decoded Arrow +
  numpy staging + a device copy routinely run 2-4x the file bytes);
- a scan whose files cannot be listed or stat'ed (remote store hiccup,
  empty glob) contributes `DEFAULT_SCAN_BYTES` instead — admission
  control must DEGRADE to a guess, never block on or crash from a
  storage error (the storage plane has its own retry/degradation
  story);
- the whole-plan floor is `MIN_FOOTPRINT_BYTES`, so a zero-byte plan
  still pays a nonzero admission (executor scratch, kernel workspace);
- an unpinned scan's total is re-stat'ed at most every
  `SCAN_BYTES_REVALIDATE_S` for the same file list: a `stat` costs tens
  of microseconds on some hosts (`stat_us` on `chip_smoke.py`'s
  `telemetry_overhead` line), and every collect projects its source
  plan, so a file rewritten in place reaches admission within that
  window (or at once after `invalidate_sizes`), not at the next collect.

Operators above the scans are NOT modeled: sort/join scratch scales
with scan bytes for this engine's operators, and the expansion factor
absorbs it. When real workloads prove the bias wrong, tune the constants —
the scheduler reads only `projected_bytes`.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Tuple

from hyperspace_tpu_torch.plan.nodes import LogicalPlan, Scan

__all__ = ["projected_bytes", "scan_disk_bytes", "file_sizes_total",
           "invalidate_sizes", "DECODE_EXPANSION", "DEFAULT_SCAN_BYTES",
           "MIN_FOOTPRINT_BYTES", "SCAN_BYTES_REVALIDATE_S"]

# Decoded + staged + device-resident expansion over on-disk parquet.
DECODE_EXPANSION = 3.0

# Per-scan stand-in when file sizes are unknowable (listing/stat
# failed): 32 MiB — large enough that a burst of unknown scans still
# queues under a tight budget, small enough not to starve admission.
DEFAULT_SCAN_BYTES = 32 * 1024 * 1024

# Whole-plan floor.
MIN_FOOTPRINT_BYTES = 1 * 1024 * 1024

# Per-file size cache, STAMP-VALIDATED: footprint estimation runs on
# EVERY collect, and serving traffic re-scans the same hot index files
# — but a file rewritten in place (source data appends, a hybrid-scan
# dir, an object-store overwrite) must not keep serving its old size
# to admission control forever. Entries validate against the same
# (size, mtime) stamp the parquet caches use (`io/parquet._file_stamp`)
# — and since the stamp CARRIES the size, a validated hit and a
# revalidation cost the same single stat. The index-FSM invalidation
# hook (`io/segcache.py`) additionally sweeps entries under a
# committed index root (`invalidate_sizes`).
_size_cache: Dict[str, Tuple[object, int]] = {}


def _file_size(path: str) -> int:
    from hyperspace_tpu_torch.io.parquet import _file_stamp
    try:
        stamp = _file_stamp(path)
    except Exception:
        stamp = None
    if stamp is None:
        # Unstampable (directory, no mtime, stat failure): unknowable —
        # never cached, caller substitutes the default.
        _size_cache.pop(path, None)
        return -1
    cached = _size_cache.get(path)
    if cached is not None and cached[0] == stamp:
        return cached[1]
    size = int(stamp[0])
    if len(_size_cache) > 65536:  # bound the cache, arbitrary-large safe
        _size_cache.clear()
    _size_cache[path] = (stamp, size)
    return size


def invalidate_sizes(prefix: str) -> None:
    """Drop cached sizes for every file under `prefix` (the index-FSM
    invalidation hook — a refresh/optimize/vacuum boundary must not
    leave admission control reading pre-commit sizes)."""
    prefix = prefix.rstrip("/\\")
    for path in [p for p in _size_cache
                 if p == prefix or p.startswith(prefix + "/")
                 or p.startswith(prefix + os.sep)]:
        _size_cache.pop(path, None)
    for key in [k for k in _pinned_bytes_cache
                if k[0] == prefix or k[0].startswith(prefix + "/")
                or k[0].startswith(prefix + os.sep)]:
        _pinned_bytes_cache.pop(key, None)
    for key in [k for k in _scan_bytes_memo
                if any(p == prefix or p.startswith(prefix + "/")
                       or p.startswith(prefix + os.sep) for p in k)]:
        _scan_bytes_memo.pop(key, None)


# Per-(root, pinned version) total-bytes memo for VERSION-PINNED index
# scans: a committed `v__=N` dir is immutable, so its total on-disk
# size never changes — the footprint re-projection that runs on every
# optimized plan (scheduler credit) must not re-stat 200 bucket files
# per collect. Swept by `invalidate_sizes` with everything else;
# bounded like the per-file cache.
_pinned_bytes_cache: Dict[Tuple[str, int], int] = {}

# Per-file-list (monotonic time validated, total bytes) memo for
# UNPINNED scans (module docstring): the source plan every collect
# projects re-stats its files at most this often. Swept by
# `invalidate_sizes`; bounded like the caches above.
SCAN_BYTES_REVALIDATE_S = 1.0
_scan_bytes_memo: Dict[Tuple[str, ...], Tuple[float, int]] = {}


def _scan_bytes(scan: Scan) -> int:
    pinned = getattr(scan, "pinned_version", None)
    pin_key = None
    if pinned is not None and not getattr(scan, "_explicit_files", False) \
            and len(scan.root_paths) == 1:
        pin_key = (scan.root_paths[0], int(pinned))
        hit = _pinned_bytes_cache.get(pin_key)
        if hit is not None:
            return hit
    try:
        files = scan.files()
    except Exception:
        return DEFAULT_SCAN_BYTES
    if not files:
        return 0
    memo_key = None
    if pin_key is None:
        memo_key = tuple(files)
        memo = _scan_bytes_memo.get(memo_key)
        now = time.monotonic()
        if memo is not None and now - memo[0] < SCAN_BYTES_REVALIDATE_S:
            return memo[1]
    total = 0
    unknown = 0
    for f in files:
        size = _file_size(f)
        if size < 0:
            unknown += 1
        else:
            total += size
    if unknown:
        # Extrapolate unknown files from the known mean (or the default
        # when nothing stat'ed) — still biased high via the expansion.
        known = len(files) - unknown
        per = (total // known) if known else DEFAULT_SCAN_BYTES
        total += unknown * per
    elif pin_key is not None:
        if len(_pinned_bytes_cache) > 4096:
            _pinned_bytes_cache.clear()
        _pinned_bytes_cache[pin_key] = total
    else:
        if len(_scan_bytes_memo) > 4096:
            _scan_bytes_memo.clear()
        _scan_bytes_memo[memo_key] = (now, total)
    return total


def file_sizes_total(files) -> int:
    """Summed on-disk bytes of `files` through the stamp-validated size
    cache (admission control stats the same files every collect, so
    calls on the execute path hit warm cache/dentry entries). Unstatable
    files contribute 0 — this is a telemetry/estimation input, not a
    correctness one."""
    total = 0
    for f in files:
        try:
            size = _file_size(f)
        except Exception:
            size = -1
        if size > 0:
            total += size
    return total


def scan_disk_bytes(plan: LogicalPlan) -> int:
    """Total RAW on-disk bytes of every Scan leaf of `plan` (no decode
    expansion, no floor) — the index advisor's what-if before/after
    unit. Degrades like
    `projected_bytes`: estimation failures return the default, never
    raise."""
    total = 0
    try:
        def visit(node):
            nonlocal total
            if isinstance(node, Scan):
                total += max(0, _scan_bytes(node))
            for c in node.children:
                visit(c)

        visit(plan)
    except Exception:
        return DEFAULT_SCAN_BYTES
    return total


def projected_bytes(plan: LogicalPlan) -> int:
    """Conservative projected working-set bytes of executing `plan`
    (module docstring). Never raises: estimation failures degrade to
    the defaults — admission control is a budget gate, not a second
    failure mode."""
    scans = 0
    disk = 0
    try:
        def visit(node):
            nonlocal scans, disk
            if isinstance(node, Scan):
                scans += 1
                disk += _scan_bytes(node)
            for c in node.children:
                visit(c)

        visit(plan)
    except Exception:
        return max(MIN_FOOTPRINT_BYTES, DEFAULT_SCAN_BYTES)
    est = int(disk * DECODE_EXPANSION)
    if scans and est <= 0:
        est = DEFAULT_SCAN_BYTES
    return max(MIN_FOOTPRINT_BYTES, est)
