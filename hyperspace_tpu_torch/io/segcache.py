"""Device-resident index segment cache — THE device-residency seam.

Under repeat traffic every query would re-pay parquet decode + H2D for
the same hot index buckets; a covering index is a *reusable* derived
dataset, read many times per build, and on a CUDA card the analog of
Spark's distributed page cache is device residency. This module owns it
end to end: a process-wide, byte-budgeted segment cache of decoded
`ColumnBatch`es on the device.

- **keying**: a committed index segment is keyed by
  `(index root, v__=N, bucket selector, columns, schema, device)` —
  content identity, NO per-read stat/stamp validation. Index version
  dirs are immutable once their `_committed` marker lands, and the rules
  only ever select committed versions, so a key can never alias two
  byte-states. Version keying also gives reads pinned-version
  stability: a refresh committing `v__=N+1` mid-query cannot perturb a
  scan already reading (and caching under) `v__=N`. Non-index device
  scans (source data, hybrid-scan appended files) have no version to
  key on and fall back to `(paths, size+mtime stamp)` validation.
- **fills**: misses decode through the stamped host read cache and
  cross the link through the `TransferEngine` (chunked, staged,
  budget-shared with live queries' transfers) tagged as the `fill`
  lane, with per-key SINGLE-FLIGHT: N concurrent readers of the same
  cold segment trigger exactly one decode+H2D, and every one of them
  gets the same batch. A fill names its device explicitly — it never
  relies on the current device of the thread that runs it. A fill's
  projected bytes are RESERVED against the budget before the transfer
  starts (concurrent fills cannot collectively blow past it) and
  released on every exit path.
- **eviction**: byte-budgeted LRU. Indexes listed in
  `spark.hyperspace.cache.segments.pin.indexes` are pinned: their
  segments survive byte pressure (but not invalidation).
- **invalidation**: hooks off the index log FSM, not ad-hoc clears —
  `IndexDataManagerImpl.commit/delete` and the log manager's stable-log
  publish call `on_version_committed` / `on_version_deleted` /
  `on_index_dropped`, which also drop the stamped host caches and the
  footprint size cache for the affected paths.
- **host tier (tiered cache)**: with
  `spark.hyperspace.cache.segments.host.bytes` > 0, a `ColumnBatch`
  evicted from the device tier by byte pressure DEMOTES into a host-RAM
  copy (decoded columns fetched D2H once, `io/columnar.batch_to_host`)
  instead of dropping. A later read of the demoted key re-promotes
  through the TransferEngine FILL lane — the H2D cost is paid again,
  the parquet decode is NOT. The host tier is its own byte-budgeted
  LRU; invalidation sweeps both tiers.
- **bucket-scoped invalidation**: an incremental refresh names the
  buckets it actually touched (`on_version_committed(...,
  touched_buckets=, carried_from=)`); entries of the carried-from
  version whose bucket selector provably avoids every touched bucket
  are REKEYED to the new version (the new version hard-links those
  buckets' files byte-for-byte, so content identity holds) instead of
  dropped. Selectors whose bucket coverage is unknowable ("all",
  explicit file lists) drop conservatively.

A cached batch is SHARED by every reader that hits it: no operator of
the package writes into a tensor or a `columns` dict it did not
allocate (`tests/test_torch_cache.py` holds checksums of the cached
tensors across queries).

Telemetry: `cache.segments.{hits,misses,fills,evictions,bytes_held,
entries,pins}` and `cache.segments.host.{hits,demotions,evictions,
bytes_held,entries}` plus `cache.segments.rekeyed`, `cache.invalidations`
(one per FSM hook call), `segcache.fill` spans, and `transfer.fill.*`
counters on the fill lane. Budget knobs:
`spark.hyperspace.cache.segments.bytes` (falls back to the legacy
`cache.device.bytes` key, then the HYPERSPACE_SEGMENT_CACHE_BYTES /
HYPERSPACE_DEVICE_CACHE_BYTES env defaults; 4 GiB) and
`spark.hyperspace.cache.segments.host.bytes` (0 = host tier off).
"""

from __future__ import annotations

import os
import re
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, replace
from typing import Dict, Optional, Sequence, Tuple

from hyperspace_tpu_torch import constants

__all__ = ["SegmentCache", "SegmentRef", "get_cache", "set_cache", "clear",
           "segment_ref_for_scan", "on_version_committed",
           "on_version_deleted", "on_index_dropped",
           "invalidate_source_paths", "read_segment"]

# Process-wide default budget (bytes); session conf overrides. The new
# env var wins; the legacy device-cache env keeps old sizing working.
SEGMENT_CACHE_BYTES = int(os.environ.get(
    "HYPERSPACE_SEGMENT_CACHE_BYTES",
    os.environ.get("HYPERSPACE_DEVICE_CACHE_BYTES", 4 * 1024 ** 3)))

# Host-tier default (bytes); 0 = tier off. Session conf
# (`cache.segments.host.bytes`) overrides.
SEGMENT_CACHE_HOST_BYTES = int(os.environ.get(
    "HYPERSPACE_SEGMENT_CACHE_HOST_BYTES", 0))

# Wait quantum for single-flight waiters.
_FILL_WAIT_QUANTUM_S = 0.05

_VERSION_DIR_RE = re.compile(
    re.escape(constants.INDEX_VERSION_DIRECTORY_PREFIX) + r"=(\d+)$")


def index_roots(root_paths) -> set:
    """The index roots (parents of the `v__=N` dirs) among a scan's
    root paths."""
    roots = set()
    for r in root_paths:
        root = r.rstrip("/\\")
        if _VERSION_DIR_RE.search(os.path.basename(root)):
            roots.add(os.path.dirname(root))
    return roots


@dataclass(frozen=True)
class SegmentRef:
    """Identity of one cacheable index segment: WHICH committed bytes a
    read covers, independent of how the filesystem is asked for them.
    `bucket` is the bucket selector the read applied — a single bucket
    id, a ("pruned", sorted bucket ids) pair, or "all"."""

    index_name: str
    index_root: str   # parent of the v__=N dir (warehouse-unique)
    version: int
    bucket: object

    @property
    def key(self) -> tuple:
        return ("seg", self.index_root, self.version, self.bucket)


def segment_ref_for_scan(scan, bucket=None, allowed_buckets=None,
                         bucketed: bool = False) -> Optional[SegmentRef]:
    """SegmentRef for a rule-selected index scan, or None when the read
    is not version-addressable (source-data scans, multi-root scans, a
    root that is not a `v__=N` dir). Only the rules put `index_name` on
    a Scan, and they only ever resolve COMMITTED versions, so a
    parseable version here is a committed one by construction."""
    if not getattr(scan, "index_name", None):
        return None
    roots = list(scan.root_paths)
    if len(roots) != 1:
        return None
    root = roots[0].rstrip("/\\")
    m = _VERSION_DIR_RE.search(os.path.basename(root))
    if m is None:
        return None
    if bucket is not None:
        selector: object = int(bucket)
    elif allowed_buckets is not None:
        selector = ("pruned", tuple(sorted(allowed_buckets)))
    else:
        selector = "all"
    if getattr(scan, "_explicit_files", False):
        # An explicit file list restricts WHICH of the version's bytes
        # the read covers — two survivor sets under one version must not
        # alias one cache entry.
        selector = ("files", selector,
                    tuple(os.path.basename(f) for f in scan.files()))
    if bucketed:
        # The bucket-ordered read (`execute_bucketed`) and the plain read
        # can concatenate the same files in different orders — distinct
        # layouts, distinct keys.
        selector = ("bucketed", selector)
    return SegmentRef(index_name=scan.index_name,
                      index_root=os.path.dirname(root),
                      version=int(m.group(1)),
                      bucket=selector)


class _Entry:
    __slots__ = ("batch", "nbytes", "ref", "pinned", "stamps")

    def __init__(self, batch, nbytes: int, ref: Optional[SegmentRef],
                 pinned: bool, stamps=None):
        self.batch = batch
        self.nbytes = nbytes
        self.ref = ref
        self.pinned = pinned
        # Per-file (size, mtime) stamps for UNVERSIONED entries; hits
        # revalidate against the live stamps (version-keyed entries are
        # immutable by construction and carry None).
        self.stamps = stamps


class _HostEntry:
    """One host-tier (demoted) segment: the fully-decoded host copy of
    a device batch, plus the identity it was cached under so
    invalidation reaches it."""

    __slots__ = ("batch", "nbytes", "ref", "stamps")

    def __init__(self, batch, nbytes: int, ref: Optional[SegmentRef],
                 stamps=None):
        self.batch = batch
        self.nbytes = nbytes
        self.ref = ref
        self.stamps = stamps


def _selector_buckets(selector) -> Optional[frozenset]:
    """The exact bucket-id set a cache-key selector covers, or None
    when it is unknowable ("all", explicit file lists) — an entry may
    only survive a touched-bucket commit when its coverage PROVABLY
    avoids every touched bucket."""
    if isinstance(selector, int):
        return frozenset((selector,))
    if isinstance(selector, tuple) and len(selector) == 2:
        if selector[0] == "pruned":
            return frozenset(int(b) for b in selector[1])
        if selector[0] == "bucketed":
            return _selector_buckets(selector[1])
    return None


class _Fill:
    """One in-flight single-flight fill. `event` flips when the filler
    finishes (success or not); waiters read `batch`/`error` after it.
    `doomed` marks a fill whose index was invalidated mid-flight — its
    result is still returned to its waiters (their query pinned that
    version) but never inserted."""

    __slots__ = ("event", "batch", "error", "doomed", "reserved",
                 "index_root")

    def __init__(self, index_root: Optional[str]):
        self.event = threading.Event()
        self.batch = None
        self.error: Optional[BaseException] = None
        self.doomed = False
        self.reserved = 0
        self.index_root = index_root


def _array_nbytes(arr) -> int:
    """Resident bytes of one column array: a tensor's whole storage (a
    view keeps all of it alive), a numpy array's own bytes."""
    import torch

    if isinstance(arr, torch.Tensor):
        return int(arr.untyped_storage().nbytes())
    return int(getattr(arr, "nbytes", 0))


def _batch_nbytes(batch) -> int:
    """Resident bytes of a ColumnBatch (payload + validity + the string
    dictionary hashes)."""
    total = 0
    for col in batch.columns.values():
        total += _array_nbytes(col.data)
        if col.validity is not None:
            total += _array_nbytes(col.validity)
        if col.dict_hashes is not None:
            total += sum(_array_nbytes(h) for h in col.dict_hashes)
    return total


def _pinned_indexes(conf) -> frozenset:
    if conf is None:
        return frozenset()
    raw = conf.segment_cache_pin_indexes
    return frozenset(n.strip() for n in raw.split(",") if n.strip())


def _resolve_device(device, conf):
    import torch

    if device is not None:
        return torch.device(device)
    from hyperspace_tpu_torch._torch_config import device_of
    return device_of(conf)


class SegmentCache:
    """Process-wide device segment cache (module docstring). All
    blocking happens on caller threads; the cache spawns none of its
    own."""

    def __init__(self, budget_bytes: Optional[int] = None,
                 host_budget_bytes: Optional[int] = None):
        self._cv = threading.Condition()
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._fills: Dict[tuple, _Fill] = {}
        self._bytes_held = 0
        # Device-tier bytes per index root, kept with `_bytes_held` by
        # `_put`/`_pop`: the serving plane's admission credit reads it
        # on every collect, without a walk of the entries.
        self._root_bytes: Dict[str, int] = {}
        self._reserved = 0
        self._default_budget = (SEGMENT_CACHE_BYTES if budget_bytes is None
                                else int(budget_bytes))
        # Host (demotion) tier: LRU of _HostEntry under its own byte
        # budget. Guarded by the same cv as the device tier — demotion
        # moves an entry between tiers atomically.
        self._host: "OrderedDict[tuple, _HostEntry]" = OrderedDict()
        self._host_bytes = 0
        self._default_host_budget = (
            SEGMENT_CACHE_HOST_BYTES if host_budget_bytes is None
            else int(host_budget_bytes))

    # -- budget math ------------------------------------------------------

    def _configured_budget(self, conf, override: Optional[int]) -> int:
        if override is not None:
            return int(override)
        if conf is not None:
            value = conf.segment_cache_bytes
            if value is not None:
                return int(value)
        return self._default_budget

    def _effective_budget(self, conf, override: Optional[int]) -> int:
        """The configured budget, CAPPED by what the serving budget
        leaves after non-cache device residency — the accountant's live
        gauges are the shared truth between this cache and the
        admission controller (`engine/scheduler.py` derives headroom
        from the same numbers)."""
        budget = self._configured_budget(conf, override)
        serve = conf.serve_hbm_budget_bytes if conf is not None else 0
        if serve and serve > 0:
            try:
                from hyperspace_tpu_torch import telemetry
                live = sum(telemetry.get_accountant().live.values())
            except Exception:
                live = 0
            non_cache = max(0, live - self._bytes_held - self._reserved)
            budget = min(budget, max(0, serve - non_cache))
        return budget

    def _host_budget(self, conf) -> int:
        if conf is not None:
            return int(conf.segment_cache_host_bytes)
        return self._default_host_budget

    # -- residency accounting --------------------------------------------

    def _put(self, key: tuple, ent: "_Entry") -> None:
        # Caller holds the cv lock; `key` is not in the device tier.
        self._entries[key] = ent
        self._bytes_held += ent.nbytes
        if ent.ref is not None:
            root = ent.ref.index_root
            self._root_bytes[root] = \
                self._root_bytes.get(root, 0) + ent.nbytes

    def _pop(self, key: tuple) -> "_Entry":
        # Caller holds the cv lock.
        ent = self._entries.pop(key)
        self._bytes_held -= ent.nbytes
        if ent.ref is not None:
            root = ent.ref.index_root
            left = self._root_bytes.get(root, 0) - ent.nbytes
            if left > 0:
                self._root_bytes[root] = left
            else:
                self._root_bytes.pop(root, None)
        return ent

    def _publish_stats(self) -> None:
        # Caller holds the cv lock.
        from hyperspace_tpu_torch import telemetry
        from hyperspace_tpu_torch.telemetry import memory as _mem
        _mem.cache_stats("segments", self._bytes_held, len(self._entries))
        _mem.cache_stats("segments.host", self._host_bytes,
                         len(self._host))
        telemetry.get_registry().gauge("cache.segments.pins").set(
            sum(1 for e in self._entries.values() if e.pinned))

    def _host_insert(self, key: tuple, hent: _HostEntry,
                     host_budget: int) -> int:
        """Insert one demoted entry into the host LRU, evicting host LRU
        victims past the budget. Caller holds the cv lock. Returns host
        evictions (an entry larger than the whole tier is dropped)."""
        evictions = 0
        if key in self._host:
            self._host_bytes -= self._host.pop(key).nbytes
        while self._host and self._host_bytes + hent.nbytes > host_budget:
            _k, victim = self._host.popitem(last=False)
            self._host_bytes -= victim.nbytes
            evictions += 1
        if hent.nbytes <= host_budget:
            self._host[key] = hent
            self._host_bytes += hent.nbytes
        return evictions

    def _demote(self, key: tuple, ent: _Entry, conf) -> bool:
        """Try to move an evicted device entry into the host tier.
        Caller holds the cv lock. The D2H fetch runs under the lock —
        demotion is an eviction-path event, not a hot-path one. A failed
        demotion is just an eviction."""
        from hyperspace_tpu_torch import telemetry
        from hyperspace_tpu_torch.io import columnar
        from hyperspace_tpu_torch.telemetry import memory as _mem

        host_budget = self._host_budget(conf)
        if host_budget <= 0 or not isinstance(ent.batch,
                                              columnar.ColumnBatch):
            # `get_or_fill` payloads (born-sharded shards, remap tables)
            # have no host form the promote path could rebuild.
            return False
        hbatch = columnar.batch_to_host(ent.batch)
        hent = _HostEntry(hbatch, _batch_nbytes(hbatch), ent.ref,
                          stamps=ent.stamps)
        host_evictions = self._host_insert(key, hent, host_budget)
        telemetry.get_registry().counter(
            "cache.segments.host.demotions").inc()
        _mem.cache_eviction("segments.host", host_evictions)
        return key in self._host

    def _host_take(self, key: tuple):
        """Pop the host-tier entry for `key` (promotion consumes it),
        or None. Caller holds the cv lock."""
        hent = self._host.pop(key, None)
        if hent is not None:
            self._host_bytes -= hent.nbytes
        return hent

    def _evict_until(self, need: int, budget: int, conf=None) -> int:
        """Evict unpinned LRU entries until `need` extra bytes fit under
        `budget`, demoting each victim into the host tier when one is
        configured. Caller holds the cv lock. Returns evictions."""
        evictions = 0
        while self._bytes_held + self._reserved + need > budget:
            victim_key = next((k for k, e in self._entries.items()
                               if not e.pinned), None)  # LRU order
            if victim_key is None:
                break  # only pinned residency left
            ent = self._pop(victim_key)
            self._demote(victim_key, ent, conf)
            evictions += 1
        return evictions

    def _insert(self, key, batch, nbytes: int, ref, conf, stamps,
                budget: int) -> int:
        """Insert one filled entry, evicting LRU for room. Caller holds
        the cv lock. Returns evictions."""
        evictions = self._evict_until(nbytes, budget, conf)
        self._put(key, _Entry(
            batch, nbytes, ref,
            pinned=(ref is not None
                    and ref.index_name in _pinned_indexes(conf)),
            stamps=stamps))
        return evictions

    def bytes_held(self) -> int:
        with self._cv:
            return self._bytes_held

    def resident_bytes_for_roots(self, roots) -> int:
        """Bytes device-resident under the index roots `roots` (parents
        of `v__=N` dirs, as `index_roots` gives them): the serving
        plane's admission credit reads this on every collect."""
        if not roots:
            return 0
        with self._cv:
            return sum(self._root_bytes.get(r, 0) for r in roots)

    # -- the read path ----------------------------------------------------

    def read(self, paths: Sequence[str],
             columns: Optional[Sequence[str]], schema,
             ref: Optional[SegmentRef] = None,
             conf=None, budget: Optional[int] = None, device=None):
        """Read parquet `paths` into a ColumnBatch on `device` (default:
        the session conf's device) through the segment cache: a hit
        skips the parquet decode AND the host->device transfer; a miss
        fills once per key no matter how many threads ask
        (single-flight)."""
        from hyperspace_tpu_torch import telemetry
        from hyperspace_tpu_torch.io import parquet
        from hyperspace_tpu_torch.telemetry import memory as _mem

        device = _resolve_device(device, conf)
        cols = tuple(columns) if columns is not None else None
        schema_json = schema.to_json() if schema is not None else None
        stamps = None
        if ref is not None:
            key = ref.key + (cols, schema_json, str(device))
        else:
            # Unversioned read: stamp validation (size+mtime per file).
            # Unstampable paths are uncacheable.
            stamps = parquet._stamps(paths)
            if stamps is None:
                _mem.cache_miss("segments")
                return self._decode(paths, cols, schema, device)
            key = ("path", tuple(paths), cols, schema_json, str(device))

        while True:
            with self._cv:
                ent = self._entries.get(key)
                if ent is not None:
                    if ent.stamps is not None and ent.stamps != stamps:
                        # Rewritten since caching: stale — drop and fall
                        # through to a fresh fill.
                        self._pop(key)
                        self._publish_stats()
                    else:
                        self._entries.move_to_end(key)
                        _mem.cache_hit("segments")
                        return ent.batch
                fill = self._fills.get(key)
                if fill is None:
                    fill = _Fill(ref.index_root if ref is not None
                                 else None)
                    self._fills[key] = fill
                    break
            # Another thread owns the fill: wait on IT, not the link —
            # deadline-checkpointed so a cancelled waiter leaves the
            # queue promptly (the filler keeps going for its own query).
            t_wait0 = time.perf_counter()
            try:
                while not fill.event.is_set():
                    telemetry.check_deadline("cache.fill")
                    fill.event.wait(_FILL_WAIT_QUANTUM_S)
            finally:
                telemetry.add_seconds("cache.fill_wait_s",
                                      time.perf_counter() - t_wait0)
            if fill.error is None and fill.batch is not None:
                # Coalesced: one decode+H2D served K waiters the SAME
                # batch object.
                _mem.cache_hit("segments")
                telemetry.add_count("cache.segments.coalesced")
                return fill.batch
            # The filler died: retry with our own fill — its failure was
            # its caller's, not necessarily ours.

        # This thread is the filler.
        _mem.cache_miss("segments")
        try:
            with telemetry.span("segcache.fill", "segcache",
                                index=(ref.index_name if ref else None),
                                files=len(paths)):
                telemetry.get_registry().counter(
                    "cache.segments.fills").inc()
                telemetry.charge_tenant("cache.segments.fills")
                batch = self._fill(key, fill, paths, cols, schema, stamps,
                                   ref, conf, budget, device)
            fill.batch = batch
            return batch
        except BaseException as exc:
            fill.error = exc
            raise
        finally:
            with self._cv:
                if self._fills.get(key) is fill:
                    del self._fills[key]
                if fill.reserved:
                    self._reserved -= fill.reserved
                    fill.reserved = 0
                self._cv.notify_all()
            fill.event.set()

    def get_or_fill(self, key: tuple, fill_fn, ref: Optional[SegmentRef]
                    = None, conf=None, budget: Optional[int] = None):
        """Generic cached fill under the cache's single-flight, byte
        budget, LRU and index-FSM invalidation, for payloads the cache
        does not decode itself: the born-sharded read's per-shard
        bucket-range fills (`parallel/spmd.read_sharded`, key components
        `("spmd", ...)` and `("spmd-sub", ...)`), its global
        dictionaries, and the string remap tables and LIKE masks. A
        version of an index on an n-shard mesh caches n range entries,
        each holding one shard's padded rows on its device, so a warm
        read moves nothing over the link. `fill_fn` runs outside the
        lock and returns (payload, resident bytes); `ref` ties the entry
        to the index log FSM's invalidation hooks (a commit under the
        root drops it). Such entries never demote to the host tier."""
        from hyperspace_tpu_torch import telemetry
        from hyperspace_tpu_torch.telemetry import memory as _mem

        while True:
            with self._cv:
                ent = self._entries.get(key)
                if ent is not None:
                    self._entries.move_to_end(key)
                    _mem.cache_hit("segments")
                    return ent.batch
                fill = self._fills.get(key)
                if fill is None:
                    fill = _Fill(ref.index_root if ref is not None
                                 else None)
                    self._fills[key] = fill
                    break
            t_wait0 = time.perf_counter()
            try:
                while not fill.event.is_set():
                    telemetry.check_deadline("cache.fill")
                    fill.event.wait(_FILL_WAIT_QUANTUM_S)
            finally:
                telemetry.add_seconds("cache.fill_wait_s",
                                      time.perf_counter() - t_wait0)
            if fill.error is None and fill.batch is not None:
                _mem.cache_hit("segments")
                telemetry.add_count("cache.segments.coalesced")
                return fill.batch
            # The filler died; retry with our own fill.

        _mem.cache_miss("segments")
        try:
            with telemetry.span("segcache.fill", "segcache",
                                index=(ref.index_name if ref else None)):
                telemetry.get_registry().counter(
                    "cache.segments.fills").inc()
                telemetry.charge_tenant("cache.segments.fills")
                payload, nbytes = fill_fn()
                evictions = 0
                with self._cv:
                    budget_eff = self._effective_budget(conf, budget)
                    if not fill.doomed and 0 < nbytes <= budget_eff:
                        evictions = self._insert(key, payload, nbytes, ref,
                                                 conf, None, budget_eff)
                    self._publish_stats()
                    self._cv.notify_all()
                _mem.cache_eviction("segments", evictions)
            fill.batch = payload
            return payload
        except BaseException as exc:
            fill.error = exc
            raise
        finally:
            with self._cv:
                if self._fills.get(key) is fill:
                    del self._fills[key]
                self._cv.notify_all()
            fill.event.set()

    def _decode(self, paths, cols, schema, device):
        """Uncached decode+transfer (fill lane, no insert)."""
        from hyperspace_tpu_torch.io import columnar, parquet
        table = parquet.read_table(paths, columns=list(cols) if cols
                                   else None)
        return columnar.from_arrow(table, schema, device=device,
                                   transfer_tag="fill")

    def _promote(self, key, paths, device):
        """Host-tier promotion: when the missed key has a demoted host
        copy, rebuild the device batch from it through the transfer
        engine's FILL lane — H2D paid, parquet decode skipped. Returns
        (batch, nbytes) or None (no/stale host entry). Runs on the
        filler thread, inside its single-flight slot."""
        from hyperspace_tpu_torch.io import columnar, parquet
        from hyperspace_tpu_torch.telemetry import memory as _mem

        with self._cv:
            hent = self._host.get(key)
        if hent is None:
            return None
        if hent.stamps is not None and parquet._stamps(paths) != hent.stamps:
            # Unversioned entry demoted before a rewrite: stale.
            with self._cv:
                if self._host.get(key) is hent:
                    self._host_take(key)
                    self._publish_stats()
            return None
        with self._cv:
            if self._host_take(key) is not hent:
                return None  # raced an invalidation sweep
            self._publish_stats()
        batch = columnar.host_batch_to_device(hent.batch, device,
                                              transfer_tag="fill")
        _mem.cache_hit("segments.host")
        return batch, _batch_nbytes(batch)

    def _fill(self, key, fill: _Fill, paths, cols, schema, stamps, ref,
              conf, budget_override, device):
        """One fill: host decode, byte reservation (evicting LRU for
        headroom), H2D through the transfer engine's fill lane, insert.
        Runs OUTSIDE the cache lock except for the bookkeeping. A key
        with a demoted host-tier copy promotes instead of decoding."""
        from hyperspace_tpu_torch.io import columnar, parquet
        from hyperspace_tpu_torch.telemetry import memory as _mem

        promoted = self._promote(key, paths, device)
        if promoted is not None:
            batch, nbytes = promoted
            evictions = 0
            with self._cv:
                budget = self._effective_budget(conf, budget_override)
                if not fill.doomed and 0 < nbytes <= budget:
                    evictions = self._insert(key, batch, nbytes, ref, conf,
                                             stamps, budget)
                self._publish_stats()
                self._cv.notify_all()
            _mem.cache_eviction("segments", evictions)
            return batch

        table = parquet.read_table(paths, columns=list(cols) if cols
                                   else None)
        budget = self._effective_budget(conf, budget_override)
        # Reserve the projected device bytes BEFORE the transfer: the
        # Arrow nbytes is a close proxy for the decoded device batch.
        # Without a reservation, K concurrent fills each under budget
        # could collectively blow past it.
        projected = int(table.nbytes)
        cacheable = budget > 0 and projected <= budget
        if cacheable:
            with self._cv:
                evictions = self._evict_until(projected, budget, conf)
                self._reserved += projected
                fill.reserved = projected
                self._publish_stats()
            _mem.cache_eviction("segments", evictions)
        batch = columnar.from_arrow(table, schema, device=device,
                                    transfer_tag="fill")
        if not cacheable:
            return batch
        if stamps is not None and parquet._stamps(paths) != stamps:
            return batch  # unversioned read raced a rewrite: serve only
        nbytes = _batch_nbytes(batch)
        evictions = 0
        with self._cv:
            self._reserved -= fill.reserved
            fill.reserved = 0
            budget = self._effective_budget(conf, budget_override)
            if not fill.doomed and nbytes <= budget:
                evictions = self._insert(key, batch, nbytes, ref, conf,
                                         stamps, budget)
            self._publish_stats()
            self._cv.notify_all()
        _mem.cache_eviction("segments", evictions)
        return batch

    # -- invalidation (the index log FSM hooks) ---------------------------

    def _drop(self, predicate) -> int:
        from hyperspace_tpu_torch.telemetry import memory as _mem
        with self._cv:
            victims = [k for k, e in self._entries.items()
                       if e.ref is not None and predicate(e.ref)]
            for k in victims:
                self._pop(k)
            host_victims = [k for k, e in self._host.items()
                            if e.ref is not None and predicate(e.ref)]
            for k in host_victims:
                self._host_bytes -= self._host.pop(k).nbytes
            for f in self._fills.values():
                if f.index_root is not None and predicate(
                        SegmentRef("", f.index_root, -1, "all")):
                    f.doomed = True
            self._publish_stats()
            self._cv.notify_all()
        _mem.cache_eviction("segments", len(victims))
        _mem.cache_eviction("segments.host", len(host_victims))
        return len(victims)

    def rekey_carried(self, index_root: str, new_version: int,
                      carried_from: int, touched) -> int:
        """Bucket-scoped commit handling for an INCREMENTAL refresh:
        `v__=<new_version>` carried `v__=<carried_from>`'s bucket runs
        forward (hard-linked, byte-identical) except for the buckets in
        `touched`. Entries of the carried-from version whose bucket
        selector provably avoids every touched bucket are REKEYED under
        the new version, while touched-bucket, unknowable-selector, and
        other-version entries drop. Both tiers. Returns how many
        entries were rekeyed (`cache.segments.rekeyed`)."""
        from hyperspace_tpu_torch import telemetry
        from hyperspace_tpu_torch.telemetry import memory as _mem

        root = index_root.rstrip("/\\")
        touched = frozenset(int(b) for b in touched)
        rekeyed = dropped = host_dropped = 0
        with self._cv:
            for tier in (self._entries, self._host):
                for key in list(tier.keys()):
                    ent = tier[key]
                    ref = ent.ref
                    if ref is None or ref.index_root != root \
                            or ref.version == new_version:
                        continue
                    coverage = (_selector_buckets(ref.bucket)
                                if ref.version == carried_from else None)
                    # Key shape: ("seg", root, version, bucket, ...) —
                    # rekey = the same tuple with the version swapped.
                    new_key = None
                    if coverage is not None and not (coverage & touched):
                        new_key = key[:2] + (new_version,) + key[3:]
                    if new_key is not None and new_key not in tier:
                        ent.ref = replace(ref, version=new_version)
                        tier[new_key] = tier.pop(key)
                        rekeyed += 1
                        continue
                    if tier is self._entries:
                        self._pop(key)
                        dropped += 1
                    else:
                        self._host_bytes -= tier.pop(key).nbytes
                        host_dropped += 1
            for f in self._fills.values():
                if f.index_root == root:
                    # Conservative: an in-flight fill may cover touched
                    # buckets under the old version; serve its waiters,
                    # never insert.
                    f.doomed = True
            self._publish_stats()
            self._cv.notify_all()
        if rekeyed:
            telemetry.get_registry().counter(
                "cache.segments.rekeyed").inc(rekeyed)
        _mem.cache_eviction("segments", dropped)
        _mem.cache_eviction("segments.host", host_dropped)
        return rekeyed

    def replica_residency(self, index_root: Optional[str] = None) -> dict:
        """{device tag: resident per-shard entry count} over the
        born-sharded (spmd) entries, optionally restricted to one index
        root — the replica-coverage introspection: a bucket range that
        concurrent traffic filled on two slices shows up as two device
        tags covering the same root, and the coherence checks assert
        that a committed version sweeps EVERY tag. The tag is the last
        element of the spmd key component
        (`parallel/mesh.mesh_device_tag`); other entries are not
        counted."""
        out: dict = {}
        root = None if index_root is None else index_root.rstrip("/\\")
        with self._cv:
            for key, ent in self._entries.items():
                if root is not None and (ent.ref is None
                                         or ent.ref.index_root != root):
                    continue
                for part in key:
                    if (isinstance(part, tuple) and part
                            and part[0] in ("spmd", "spmd-sub")
                            and isinstance(part[-1], tuple)):
                        out[part[-1]] = out.get(part[-1], 0) + 1
                        break
        return out

    def invalidate_index(self, index_root: str,
                         keep_version: Optional[int] = None) -> int:
        """Drop every cached segment of the index rooted at
        `index_root` (optionally sparing one version). Returns how many
        entries were dropped. In-flight fills for the index are doomed:
        their waiters still get their batch (pinned-version stability)
        but nothing stale is inserted."""
        root = index_root.rstrip("/\\")
        return self._drop(lambda ref: ref.index_root == root
                          and ref.version != keep_version)

    def invalidate_version(self, index_root: str, version: int) -> int:
        root = index_root.rstrip("/\\")
        return self._drop(lambda ref: ref.index_root == root
                          and (ref.version == version or version < 0))

    def clear(self) -> None:
        from hyperspace_tpu_torch.telemetry import memory as _mem
        with self._cv:
            n, nh = len(self._entries), len(self._host)
            self._entries.clear()
            self._bytes_held = 0
            self._root_bytes.clear()
            self._host.clear()
            self._host_bytes = 0
            for f in self._fills.values():
                f.doomed = True
            self._publish_stats()
            self._cv.notify_all()
        _mem.cache_eviction("segments", n)
        _mem.cache_eviction("segments.host", nh)

    # -- introspection ----------------------------------------------------

    def snapshot(self) -> dict:
        with self._cv:
            return {
                "entries": len(self._entries),
                "bytes_held": self._bytes_held,
                "reserved_bytes": self._reserved,
                "fills_in_flight": len(self._fills),
                "pinned_entries": sum(1 for e in self._entries.values()
                                      if e.pinned),
                "host_entries": len(self._host),
                "host_bytes_held": self._host_bytes,
            }


# ---------------------------------------------------------------------------
# Process-wide cache + the index-FSM invalidation hooks
# ---------------------------------------------------------------------------

_cache: Optional[SegmentCache] = None
_cache_lock = threading.Lock()


def get_cache() -> SegmentCache:
    global _cache
    if _cache is None:
        with _cache_lock:
            if _cache is None:
                _cache = SegmentCache()
    return _cache


def set_cache(cache: SegmentCache) -> SegmentCache:
    """Install a specific cache (tests: tiny budgets, fresh state)."""
    global _cache
    _cache = cache
    return cache


def clear() -> None:
    """Empty the process cache (cold passes, test isolation)."""
    cache = _cache
    if cache is not None:
        cache.clear()


def read_segment(paths, columns, schema, ref=None, conf=None,
                 budget=None, device=None, shared_members: int = 0):
    """Module-level convenience: `get_cache().read(...)`.

    `shared_members > 1` marks the SHARED read of an inter-query batch
    cohort (`engine/batcher.py`): one pass through the cache — one hit,
    or one single-flight fill — serves that many concurrent queries.
    Counted as `cache.segments.shared.{reads,members}` so the
    amortization is scrape-able next to the hit/miss series (the
    single-flight fill dedupes concurrent fills of one key; the batch
    lane goes further and dedupes the LOOKUP to one caller)."""
    if shared_members > 1:
        from hyperspace_tpu_torch import telemetry
        reg = telemetry.get_registry()
        reg.counter("cache.segments.shared.reads").inc()
        reg.counter("cache.segments.shared.members").inc(shared_members)
    return get_cache().read(paths, columns, schema, ref=ref, conf=conf,
                            budget=budget, device=device)


def _invalidate_host_caches(prefix: str) -> None:
    """Stale-entry sweep of the HOST-side stamped caches + the
    footprint size cache for paths under `prefix` — the other half of
    the invalidation contract (stamp validation alone races a
    mid-commit rewrite: a query can stat, validate, and serve bytes the
    action is replacing)."""
    from hyperspace_tpu_torch import telemetry
    from hyperspace_tpu_torch.io import parquet
    from hyperspace_tpu_torch.plan import footprint
    parquet.invalidate_paths(prefix)
    footprint.invalidate_sizes(prefix)
    telemetry.get_registry().counter("cache.invalidations").inc()


def invalidate_source_paths(prefix: str) -> None:
    """Sweep the stamped HOST caches + the footprint size cache under a
    SOURCE data root (not an index root)."""
    _invalidate_host_caches(prefix)


def on_version_committed(index_root: str, version: int,
                         touched_buckets=None,
                         carried_from: Optional[int] = None) -> None:
    """A data-writing action committed `v__=<version>` under
    `index_root` (refresh/optimize/create/incremental). Older versions'
    segments are dropped — new queries resolve the new version and fill
    fresh keys. An incremental refresh that carried
    `v__=<carried_from>`'s runs forward passes the bucket ids it touched;
    carried-from entries over provably-untouched buckets are rekeyed to
    the new version instead of dropped."""
    cache = _cache
    if cache is not None:
        if touched_buckets is not None and carried_from is not None:
            cache.rekey_carried(index_root, version, carried_from,
                                touched_buckets)
        else:
            cache.invalidate_index(index_root, keep_version=version)
    _invalidate_host_caches(index_root)


def on_version_deleted(index_root: str, version: int) -> None:
    """Vacuum hard-deleted `v__=<version>`: its bytes no longer exist
    on disk, so its segments must not survive on the device either."""
    cache = _cache
    if cache is not None:
        cache.invalidate_version(index_root, version)
    _invalidate_host_caches(index_root)


def on_index_dropped(index_root: str) -> None:
    """The index log published a terminal state (DELETED/DOESNOTEXIST):
    release every segment of the index — the rules will not select it
    again, and pinned device memory for a dropped index is a leak."""
    cache = _cache
    if cache is not None:
        cache.invalidate_index(index_root)
    _invalidate_host_caches(index_root)
