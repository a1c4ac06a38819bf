"""Whole-stage fusion: operator chains run as ONE masked stage.

Eager per-operator execution on the card pays an output-sizing host
sync per operator: every `FilterExec` compacts with a `nonzero`, and a
broadcast join compacts its matches with another. This module fuses
maximal chains of shape-preserving operators — Filter, Project,
BroadcastHashJoin — into one stage with MASKED row semantics:

- a Filter contributes its predicate to a running boolean selection mask
  instead of compacting (no sizing sync, no mid-stage gather);
- a Project computes its columns full-length (dead rows compute garbage
  harmlessly — every operator in a region is row-local);
- a BroadcastHashJoin with a unique-keyed build side is ONE gather per
  output column plus a `matched` mask (the direct-address table from
  `ops/broadcast_join.py`, prepared host-side and cached); inner joins
  AND `matched` into the selection, outer joins null the build columns.

One host sync per stage (`fusion:sync`: the compaction `nonzero`, whose
length is the selection count) replaces one per operator. Stage leaves
(scans, sort-merge joins, aggregates, unions — anything with a
data-dependent output shape) execute eagerly as before and feed the
stage as inputs.

The stage runs as torch operations on the sources' device, inside the
device seam as `fusion.run_stage` (CUDA-event seconds under a query
recorder). The stage-program cache keeps the JAX package's key
(`_StageProgram`: operator structure, expressions, schemas, validity
presence, string-dictionary identity, broadcast-table packing) and its
output metadata (`_OUT_META`), so a re-run of the same query is a
program-key hit (`fusion.trace_misses` stays put) although eager torch
compiles nothing.

Host-lane stages run the ORIGINAL eager operator graph instead: on
numpy a compaction is free, so eager filters cutting the row count early
beat masked full-length evaluation. The masked semantics get CPU
coverage through torch CPU tensors (tests force the device lane with
execution.min.device.rows=0).
"""

from __future__ import annotations

import itertools
import json
import threading
import weakref
from collections.abc import MutableMapping as _MutableMapping
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from hyperspace_tpu_torch import constants as _constants
from hyperspace_tpu_torch import telemetry
from hyperspace_tpu_torch.engine.physical import (BroadcastHashJoinExec,
                                                  ExchangeExec, FilterExec,
                                                  PhysicalNode, ProjectExec,
                                                  ReusedExec, SortExec,
                                                  SortMergeJoinExec)
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.io.columnar import ColumnBatch, DeviceColumn
from hyperspace_tpu_torch.plan.schema import Field, Schema
from hyperspace_tpu_torch.telemetry.compilation import instrumented_device
from hyperspace_tpu_torch.utils.identity import IdentityMemo


class _FusionIneligible(Exception):
    """Raised while a region runs when it cannot run masked (e.g.
    non-integer broadcast keys); the caller falls back to the original
    eager operator graph — same results, without the fused stage."""


# One lock over every module-level cache below: concurrent serving
# threads insert, evict and reset them while others look them up.
_lock = threading.RLock()

# ---------------------------------------------------------------------------
# Identity tokens: stable per-object ids for arrays whose CONTENT shapes a
# stage program (string dictionaries; broadcast tables). Object identity
# is enough: warm runs re-serve the same cached arrays, and a freed array
# can never reclaim its token.
# ---------------------------------------------------------------------------

_token_counter = itertools.count()
_tokens = IdentityMemo()


def _token_of(obj) -> int:
    if obj is None:
        return -1
    return _tokens.get(obj, lambda: next(_token_counter))[0]


# ---------------------------------------------------------------------------
# Device promotion cache: host (numpy) source columns — dimension tables
# ride the host lane — become device tensors ONCE and are re-served by
# token while the host array lives. Without it every execution
# re-transfers dimension payloads over the link.
#
# Both fusion caches hold REAL device memory, so they evict on a BYTE
# budget (conf `spark.hyperspace.fusion.cache.{promote,broadcast}.bytes`,
# refreshed from the session conf at each fused execution) and report
# `cache.fusion_{promote,bcast}.*` series to the metrics registry.
# ---------------------------------------------------------------------------

_promote_cache: Dict[tuple, tuple] = {}  # (token, device) -> (ref, tensor)
_promote_budget = [_constants.FUSION_PROMOTE_CACHE_BYTES_DEFAULT]
_bcast_budget = [_constants.FUSION_BCAST_CACHE_BYTES_DEFAULT]


def _configure_cache_budgets(conf) -> None:
    """Refresh the effective byte budgets from the session conf (the
    caches are process-wide; sessions sharing a process should agree).
    The transfer engine's io.transfer.* knobs refresh on the same
    cadence."""
    if conf is None:
        return
    _promote_budget[0] = conf.fusion_promote_cache_bytes
    _bcast_budget[0] = conf.fusion_bcast_cache_bytes
    from hyperspace_tpu_torch.io import transfer
    transfer.configure(conf)


def _nbytes(arr) -> int:
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return int(getattr(arr, "nbytes", 0))


def _promote_nbytes(ent) -> int:
    return _nbytes(ent[1])


def _promote_dead(ent) -> bool:
    return ent[0]() is None


def _bcast_nbytes(ent) -> int:
    return _nbytes(ent[0]) if ent is not None else 0


def _evict(cache: dict, name: str, budget_bytes: int, nbytes_of,
           dead=None) -> None:
    """Byte-budget eviction, run on every insert (caller holds `_lock`):
    sweep dead-source entries FIRST and unconditionally (a collected
    host source must not pin its device copy until byte pressure), then
    drop oldest-inserted entries until held bytes fit the budget.
    Residency lands as `cache.<name>.{bytes_held,entries}`."""
    evicted = 0
    if dead is not None:
        for k in [k for k, v in cache.items() if dead(v)]:
            cache.pop(k, None)
            evicted += 1
    total = sum(nbytes_of(v) for v in cache.values())
    while total > budget_bytes and cache:
        total -= nbytes_of(cache.pop(next(iter(cache))))
        evicted += 1
    telemetry.memory.cache_eviction(name, evicted)
    telemetry.memory.cache_stats(name, total, len(cache))


def _to_device(arr, device: torch.device, cast=None):
    """`arr` (a host array) as a tensor on `device`, served from the
    promotion cache while `arr` lives. `cast` widens the host array on
    its way (string hash halves travel as int64 lanes)."""
    if arr is None or not isinstance(arr, np.ndarray):
        return arr
    key = (_token_of(arr), str(device))
    with _lock:
        ent = _promote_cache.get(key)
        if ent is not None and ent[0]() is arr:
            telemetry.memory.cache_hit("fusion_promote")
            return ent[1]
    telemetry.memory.cache_miss("fusion_promote")
    from hyperspace_tpu_torch.io import transfer
    # Cache MISSES are exactly the executions that pay the link; the
    # engine's transfer record makes the promotion cost attributable.
    src = transfer.HostCast(arr, cast) if cast is not None else arr
    out = transfer.get_engine().put(src, device=device)
    try:
        ref = weakref.ref(arr)
    except TypeError:
        ref = (lambda o: (lambda: o))(arr)
    with _lock:
        _promote_cache[key] = (ref, out)
        _evict(_promote_cache, "fusion_promote", _promote_budget[0],
               _promote_nbytes, dead=_promote_dead)
    return out


def _promote_batch(batch: ColumnBatch, device: torch.device) -> ColumnBatch:
    """A batch with every host column on `device` (device columns pass
    through): the device lane's representation of each column, as
    `io/columnar.host_batch_to_device` makes it."""
    if not any(c.is_host for c in batch.columns.values()):
        return batch
    columns = {}
    for name, col in batch.columns.items():
        if not col.is_host:
            columns[name] = col
            continue
        hashes = col.dict_hashes
        if hashes is not None:
            hashes = (_to_device(hashes[0], device, np.int64),
                      _to_device(hashes[1], device, np.int64))
        columns[name] = DeviceColumn(_to_device(col.data, device), col.dtype,
                                     _to_device(col.validity, device),
                                     col.dictionary, hashes)
    return ColumnBatch(batch.schema, columns)


# ---------------------------------------------------------------------------
# Broadcast table prep (host side, cached by build-column identity).
# ---------------------------------------------------------------------------

_bcast_cache: Dict[tuple, object] = {}


def _prepare_broadcast(node, build_batch: ColumnBatch):
    """(table ndarray, mins, ranges) for this join's build side, or None
    when the direct-address path is ineligible (the caller then falls
    back to the eager operator graph, whose own runtime fallback covers
    duplicates/strings/wide ranges). Cached by build key-column identity
    so warm runs skip the host scatter AND the device transfer."""
    membership = node.how in ("left_semi", "left_anti")
    keys = (node.right_keys if node.build_side == "right"
            else node.left_keys)
    if build_batch.num_rows == 0:
        return None  # eager path has exact empty-side shortcuts
    try:
        ident = []
        for k in keys:
            col = build_batch.column(k)
            ident.append((_token_of(col.data), _token_of(col.validity)))
    except HyperspaceException:
        return None
    ck = (membership, tuple(k.lower() for k in keys), tuple(ident))
    with _lock:
        if ck in _bcast_cache:
            telemetry.memory.cache_hit("fusion_bcast")
            return _bcast_cache[ck]
    telemetry.memory.cache_miss("fusion_bcast")
    from hyperspace_tpu_torch.ops.broadcast_join import (
        build_broadcast_table, build_membership_table)
    builder = build_membership_table if membership else build_broadcast_table
    out = builder(build_batch, keys)
    if out is not None:
        table, mins, ranges = out
        out = (table, tuple(int(m) for m in mins),
               tuple(int(r) for r in ranges))
    with _lock:
        _bcast_cache[ck] = out
        _evict(_bcast_cache, "fusion_bcast", _bcast_budget[0],
               _bcast_nbytes)
    return out


_INT_KEY_DTYPES = ("int8", "int16", "int32", "int64", "date32",
                   "timestamp", "bool")


# ---------------------------------------------------------------------------
# Region nodes
# ---------------------------------------------------------------------------


class _SourceExec(PhysicalNode):
    """Region leaf: a materialized input. During a fused execution the
    batch slot is pre-loaded; outside one it delegates to the wrapped
    node (the eager-fallback and bucketed-protocol paths)."""

    name = "StageInput"

    def __init__(self, node, index: int):
        self.node = node
        self.index = index
        self._batch: Optional[ColumnBatch] = None

    @property
    def children(self):
        return [self.node]

    def simple_string(self):
        return "StageInput"

    def execute(self) -> ColumnBatch:
        if self._batch is not None:
            return self._batch
        return self.node.execute()

    def execute_bucketed(self, num_buckets: int):
        return self.node.execute_bucketed(num_buckets)


def _region_nodes(root) -> List:
    """All fused operator nodes of a region (stops at _SourceExec)."""
    out = []

    def walk(n):
        if isinstance(n, _SourceExec):
            return
        out.append(n)
        if isinstance(n, (FilterExec, ProjectExec)):
            walk(n.child)
        elif isinstance(n, BroadcastHashJoinExec):
            walk(n.left if n.build_side == "right" else n.right)
    walk(root)
    return out


class _StageProgram:
    """One stage program: the region and the host-side constants its
    evaluation reads. Two programs with equal keys evaluate identically;
    `device` is where the stage runs (the device seam reads it)."""

    def __init__(self, key: str, region, source_meta, tables_meta,
                 device: torch.device):
        self.key = key
        self.region = region
        self.source_meta = source_meta  # [(schema, num_rows)] by index
        self.tables_meta = tables_meta  # {slot: (mins, ranges)}
        self.device = device

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, other):
        return (isinstance(other, _StageProgram)
                and other.key == self.key)

    def __repr__(self):
        return f"_StageProgram({hash(self.key) & 0xFFFFFFFF:08x})"


# Output metadata per program key, recorded on a program's first run:
# (output schema, reduced schema, aux, lazy specs). `aux` is None here —
# the slot stays so the entries line up with the JAX package's.
_OUT_META: Dict[str, tuple] = {}
# Program keys whose run proved ineligible — skip straight to eager.
_INELIGIBLE_KEYS: set = set()
# Program-cache size at which metadata resets (the JAX package's value).
_OUT_META_MAX = 1024


class _RegistryStats(_MutableMapping):
    """PROCESS-WIDE diagnostics aggregate — stage executions, program
    misses, seconds dispatching / blocked on the stage sync — backed by
    the metrics registry (counters `fusion.<key>`): one storage, two
    views. Per-QUERY attribution of the same quantities lands on the
    active `telemetry.QueryMetrics` (counters `fusion.*`)."""

    _KEYS = ("stage_execs", "trace_misses", "sync_s", "dispatch_s")
    _INT_KEYS = ("stage_execs", "trace_misses")

    def _counter(self, key: str):
        if key not in self._KEYS:
            raise KeyError(key)
        return telemetry.get_registry().counter(f"fusion.{key}")

    def __getitem__(self, key):
        value = self._counter(key).value
        return int(value) if key in self._INT_KEYS else value

    def __setitem__(self, key, value):
        self._counter(key).set(float(value))

    def __delitem__(self, key):
        raise TypeError("fusion.STATS keys are fixed")

    def __iter__(self):
        return iter(self._KEYS)

    def __len__(self):
        return len(self._KEYS)

    def __repr__(self):
        return repr(dict(self))


STATS = _RegistryStats()


def _stat(key: str, value) -> None:
    """THE single mutation path for fusion stage statistics: the
    process registry (which `STATS` views) AND the per-query recorder."""
    telemetry.get_registry().counter(f"fusion.{key}").inc(value)
    if isinstance(value, float):
        telemetry.add_seconds(f"fusion.{key}", value)
    else:
        telemetry.add_count(f"fusion.{key}", value)


def _gather_build(src_data, src_validity, hit, matched):
    """THE build-side gather semantics (data, validity) — shared by lazy
    materialization and the post-compaction finalize, so the sites can
    never diverge. Unmatched rows (hit -1) read build row 0 and come out
    NULL."""
    g = hit.clamp(min=0)
    data = src_data[g]
    validity = (matched if src_validity is None
                else src_validity[g] & matched)
    return data, validity


class _LazyGatherColumn:
    """A broadcast join's build-side column inside a stage, DEFERRED:
    most dimension payload is only CARRIED to the stage output, where
    the selection then discards most rows — gathering it full-length
    through every join would be the stage's dominant data movement. The
    gather materializes if a mid-stage expression reads the column (the
    result is kept); columns still lazy at stage end leave the stage as
    their join's (hit, matched) pair, and are gathered AFTER compaction,
    at selection size.

    Duck-types DeviceColumn (`io/columnar.py`); valid only within one
    stage execution."""

    __slots__ = ("_src", "hit", "matched", "dtype", "dictionary",
                 "pair_slot", "source_index", "src_name", "_mat")

    def __init__(self, src, hit, matched, pair_slot: int,
                 source_index: int, src_name: str):
        self._src = src
        self.hit = hit
        self.matched = matched
        self.dtype = src.dtype
        self.dictionary = src.dictionary
        self.pair_slot = pair_slot
        self.source_index = source_index
        self.src_name = src_name
        self._mat = None

    @property
    def materialized(self) -> bool:
        return self._mat is not None

    def _materialize(self):
        if self._mat is None:
            self._mat = _gather_build(self._src.data, self._src.validity,
                                      self.hit, self.matched)
        return self._mat

    @property
    def data(self):
        return self._materialize()[0]

    @property
    def validity(self):
        return self._materialize()[1]

    @property
    def dict_hashes(self):
        return self._src.dict_hashes

    @property
    def device(self) -> torch.device:
        return self.hit.device

    @property
    def is_string(self) -> bool:
        return self.dictionary is not None

    @property
    def is_host(self) -> bool:
        return False

    def __len__(self) -> int:
        return int(self.hit.shape[0])


# ---------------------------------------------------------------------------
# The masked interpreter (torch on the stage's device; the host lane
# routes to the eager operator graph instead).
# ---------------------------------------------------------------------------


def _interpret(node, env: Dict[int, ColumnBatch], tables: Dict[int, tuple]):
    from hyperspace_tpu_torch.engine.compiler import compile_predicate

    if isinstance(node, _SourceExec):
        return env[node.index], None
    if isinstance(node, FilterExec):
        batch, sel = _interpret(node.child, env, tables)
        mask = compile_predicate(node.condition, batch)
        return batch, (mask if sel is None else sel & mask)
    if isinstance(node, ProjectExec):
        batch, sel = _interpret(node.child, env, tables)
        return node._project(batch), sel
    if isinstance(node, BroadcastHashJoinExec):
        return _interpret_bhj(node, env, tables)
    raise HyperspaceException(f"Unfusible node in region: {node!r}")


def _interpret_bhj(node, env, tables):
    from hyperspace_tpu_torch.ops.broadcast_join import _probe_lookup
    from hyperspace_tpu_torch.ops.bucketed_join import join_output_plan

    probe_is_left = node.build_side == "right"
    probe_node = node.left if probe_is_left else node.right
    build_node = node.right if probe_is_left else node.left
    probe_keys = node.left_keys if probe_is_left else node.right_keys
    probe_batch, sel = _interpret(probe_node, env, tables)
    build_batch = env[build_node.index]
    table, mins, ranges = tables[node._table_slot]
    for k in probe_keys:
        col = probe_batch.column(k)
        if col.is_string or col.dtype not in _INT_KEY_DTYPES:
            raise _FusionIneligible(f"non-integer probe key {k}")
    looked = _probe_lookup(probe_batch, probe_keys, table, list(mins),
                           list(ranges))
    if looked is None:
        raise _FusionIneligible("probe lookup declined")
    hit, matched = looked

    if node.how in ("left_semi", "left_anti"):
        want = ~matched if node.how == "left_anti" else matched
        return probe_batch, (want if sel is None else sel & want)

    if node.how == "inner":
        sel = matched if sel is None else sel & matched
    # THE shared output-naming contract (`join_output_plan`) keeps the
    # fused lane and the eager assembly from ever diverging.
    left_batch = probe_batch if probe_is_left else build_batch
    right_batch = build_batch if probe_is_left else probe_batch
    plan = join_output_plan(left_batch.schema, right_batch.schema,
                            node.out_columns)

    build_side_tag = "r" if probe_is_left else "l"
    fields, out_columns = [], {}
    for out, side, src, dtype in plan:
        if side == build_side_tag:
            col = build_batch.column(src)
            # Deferred: gathers only if a mid-stage expression reads it;
            # otherwise the stage end gathers at selection size.
            out_columns[out] = _LazyGatherColumn(
                col, hit, matched, node._table_slot,
                build_node.index, src)
            fields.append(Field(out, dtype, True))
        else:
            # Probe rows are never unmatched-nulled (outer joins only
            # broadcast their inner side), so probe fields keep their
            # nullability.
            out_columns[out] = probe_batch.column(src)
            fields.append(Field(out, dtype,
                                probe_batch.schema.field(src).nullable))
    return ColumnBatch(Schema(fields), out_columns), sel


# ---------------------------------------------------------------------------
# The stage runner and the deferred gather, both entry points of the
# device seam.
# ---------------------------------------------------------------------------


def _stage_cost(prog: _StageProgram, env, tables):
    """Modeled (operations, bytes accessed) of one stage: every source
    column and broadcast table read once; the arithmetic is not
    modeled."""
    total = 0
    for batch in env.values():
        for col in batch.columns.values():
            total += _nbytes(col.data)
            if col.validity is not None:
                total += _nbytes(col.validity)
    for table, _mins, _ranges in tables.values():
        total += _nbytes(table)
    return 0, total


def _stage_body(prog: _StageProgram, env, tables):
    """Evaluate the region masked. Returns (output schema, the batch of
    its non-deferred columns, lazy specs, {slot: (hit, matched)} of the
    deferred columns' joins, selection mask or None). Queues device
    work only: nothing here waits on the device."""
    out_batch, sel = _interpret(prog.region, env, tables)
    keep_fields, keep_cols = [], {}
    lazy_specs, lazy_pairs = [], {}
    for f in out_batch.schema.fields:
        col = out_batch.columns[f.name]
        if isinstance(col, _LazyGatherColumn) and not col.materialized:
            lazy_pairs[col.pair_slot] = (col.hit, col.matched)
            lazy_specs.append((f.name, col.pair_slot, col.source_index,
                               col.src_name, f.dtype))
        else:
            if isinstance(col, _LazyGatherColumn):  # read mid-stage
                col = DeviceColumn(col.data, col.dtype, col.validity,
                                   col.dictionary, col.dict_hashes)
            keep_fields.append(f)
            keep_cols[f.name] = col
    reduced = ColumnBatch(Schema(keep_fields), keep_cols)
    lazy_specs = tuple(lazy_specs)
    with _lock:
        _OUT_META[prog.key] = (out_batch.schema, reduced.schema, None,
                               lazy_specs)
    return out_batch.schema, reduced, lazy_specs, lazy_pairs, sel


_run_stage = instrumented_device("fusion.run_stage", _stage_body,
                                 cost=_stage_cost)


def _finalize_cost(hits, matcheds, slots, idx, srcs):
    m = int(idx.numel()) if idx is not None else int(hits[0].numel())
    total = 0
    for _slot, data, validity in srcs:
        total += 2 * m * data.element_size()
        if validity is not None:
            total += 2 * m
    return 0, total + m * 9 * len(hits)


def _finalize_body(hits, matcheds, slots, idx, srcs):
    """ONE device-seam call for every deferred build column of a stage:
    compose each join's (hit, matched) with the compaction index `idx`
    (None = no compaction), then apply `_gather_build` per column.
    `srcs` is [(slot, source data, source validity|None)]."""
    composed = {}
    for slot, hit, matched in zip(slots, hits, matcheds):
        if idx is not None:
            hit, matched = hit[idx], matched[idx]
        composed[slot] = (hit, matched)
    return [_gather_build(data, validity, *composed[slot])
            for slot, data, validity in srcs]


_finalize_lazy = instrumented_device("fusion.finalize_lazy", _finalize_body,
                                     cost=_finalize_cost)


# ---------------------------------------------------------------------------
# FusedStageExec
# ---------------------------------------------------------------------------


class FusedStageExec(PhysicalNode):
    """Physical node executing a fused region. Sources run eagerly first;
    the region then runs masked with a single sync (device lane) or as
    the eager operator graph (host lane — early compaction wins on
    numpy)."""

    name = "FusedStage"

    def __init__(self, root, sources: Sequence[_SourceExec], conf=None):
        self.root = root
        self.sources = list(sources)
        self.conf = conf
        self._bhj_nodes = [n for n in _region_nodes(root)
                           if isinstance(n, BroadcastHashJoinExec)]
        for slot, n in enumerate(self._bhj_nodes):
            n._table_slot = slot

    @property
    def children(self):
        return [self.root]

    def simple_string(self):
        return f"FusedStage ({len(_region_nodes(self.root))} ops)"

    def execute_bucketed(self, num_buckets: int):
        """Bucketed-protocol passthrough (regions never contain joins on
        this path — only Filter/Project chains support it)."""
        return self.root.execute_bucketed(num_buckets)

    def execute(self) -> ColumnBatch:
        # Stage-boundary seams: the fault point the chaos harness
        # drives (`fusion.stage`) and the cooperative-cancellation
        # checkpoint — both BEFORE source execution, so an injected
        # fault or an expired deadline costs nothing downstream.
        from hyperspace_tpu_torch.utils import faults
        faults.fire("fusion.stage")
        telemetry.check_deadline("stage")
        _configure_cache_budgets(self.conf)
        for s in self.sources:
            s._batch = s.node.execute()
        try:
            out = self._execute_masked()
            if out is not None:
                return out
            # Eager fallback: the original operator graph, sources served
            # from the already-executed batches.
            return self.root.execute()
        finally:
            for s in self.sources:
                s._batch = None

    # -- masked execution -------------------------------------------------

    def _execute_masked(self) -> Optional[ColumnBatch]:
        batches = [s._batch for s in self.sources]
        if any(b.num_rows == 0 for b in batches):
            telemetry.event("fusion", "lane", lane="eager",
                            trigger="empty-source")
            return None  # eager path has exact empty-side shortcuts
        from hyperspace_tpu_torch.parallel.context import should_distribute
        host = all(b.is_host for b in batches)
        if should_distribute(self.conf, max(b.num_rows for b in batches),
                             host_batch=host) is not None:
            telemetry.event("fusion", "lane", lane="eager",
                            trigger="mesh-distribution")
            return None  # mesh execution owns these operators instead
        if host:
            # Host lane: run the ORIGINAL eager operator graph (before
            # any broadcast-table prep — the eager join builds its own).
            # On numpy a compaction is free, so eager filters cutting
            # the row count EARLY beat full-length masked evaluation.
            telemetry.event("fusion", "lane", lane="eager-host",
                            trigger="host-resident sources")
            return self.root.execute()

        preps = {}
        for n in self._bhj_nodes:
            build_node = n.right if n.build_side == "right" else n.left
            prep = _prepare_broadcast(n, build_node._batch)
            if prep is None:
                telemetry.event("fusion", "lane", lane="eager",
                                trigger="broadcast-prep-declined")
                return None
            preps[n._table_slot] = prep
        return self._execute_device(batches, preps)

    def _execute_device(self, batches, preps) -> Optional[ColumnBatch]:
        with telemetry.span("fusion:prepare", "plan"):
            prepared = self._prepare_device(batches, preps)
        if prepared is None:
            return None
        prog, env, tables, ops, cache_hit = prepared
        # Last checkpoint before committing to the stage's device work.
        telemetry.check_deadline("stage")
        try:
            with telemetry.span("fusion:dispatch", "operators", ops=ops,
                                cache_hit=cache_hit) as sp:
                schema, base, lazy_specs, lazy_pairs, sel = _run_stage(
                    prog, env, tables)
        except _FusionIneligible as exc:
            with _lock:
                _INELIGIBLE_KEYS.add(prog.key)
            telemetry.event("fusion", "lane", lane="eager",
                            trigger=f"trace-ineligible ({exc})")
            return None
        _stat("dispatch_s", sp.wall_s)
        # The region's broadcast joins ran on their direct-address tables
        # (a declined table takes the eager graph, which counts its own).
        if self._bhj_nodes:
            telemetry.get_registry().counter("join.broadcast.calls").inc(
                len(self._bhj_nodes))
        # Span boundary of the stage dispatch: the working set (sources,
        # broadcast tables, stage outputs) is device-resident here.
        telemetry.memory.maybe_sample()
        telemetry.event("fusion", "lane", lane="masked-device",
                        trigger="device-resident sources")
        idx = None
        if sel is not None:
            with telemetry.span("fusion:sync", "device_wait") as sp:
                # THE stage sync: `nonzero` sizes its output on the host,
                # so the selection count is its length — one wait.
                idx = torch.nonzero(sel).squeeze(1)
            _stat("sync_s", sp.wall_s)
        with telemetry.span("fusion:finalize", "operators"):
            return self._finalize(schema, base, lazy_specs, lazy_pairs,
                                  idx, env)

    def _prepare_device(self, batches, preps):
        """The stage program and its trace-cache lookup: (program, env,
        tables, ops, cache hit), or None when the key is known to be
        ineligible."""
        key = self._program_key(batches, preps)
        ops = len(_region_nodes(self.root))
        with _lock:
            if key in _INELIGIBLE_KEYS:
                ineligible = True
            else:
                ineligible = False
                if len(_OUT_META) > _OUT_META_MAX:
                    # The program cache retires wholesale, as the JAX
                    # package's metadata and executables do together.
                    telemetry.memory.cache_eviction("fusion_trace",
                                                    len(_OUT_META))
                    _OUT_META.clear()
                cache_hit = key in _OUT_META
                entries = len(_OUT_META)
        if ineligible:
            telemetry.event("fusion", "lane", lane="eager",
                            trigger="trace-ineligible (cached)")
            return None
        device = next(b.device for b in batches if not b.is_host)
        env = {i: _promote_batch(b, device) for i, b in enumerate(batches)}
        tables = {slot: (_to_device(p[0], device), p[1], p[2])
                  for slot, p in preps.items()}
        prog = _StageProgram(key, self.root,
                             [(b.schema, b.num_rows) for b in batches],
                             {slot: (p[1], p[2])
                              for slot, p in preps.items()}, device)
        _stat("stage_execs", 1)
        if not cache_hit:
            _stat("trace_misses", 1)
            telemetry.memory.cache_miss("fusion_trace")
        else:
            telemetry.memory.cache_hit("fusion_trace")
        telemetry.memory.cache_stats("fusion_trace", None, entries)
        telemetry.event("fusion", "trace-cache", hit=cache_hit, ops=ops)
        return prog, env, tables, ops, cache_hit

    @staticmethod
    def _finalize(schema, base, lazy_specs, lazy_pairs, idx, env):
        """The stage's output: the compaction gather, then the deferred
        build-side gathers."""
        if idx is not None:
            base = base.take(idx)
        if not lazy_specs:
            return base
        # Deferred build-side gathers, AT SELECTION SIZE: compose each
        # lazy column's hit chain with the compaction index and gather
        # from the promoted source batch, all in one seam call.
        slots = sorted({spec[1] for spec in lazy_specs})
        srcs = []
        src_cols = []
        for out_name, slot, source_index, src_name, dtype in lazy_specs:
            src = env[source_index].column(src_name)
            srcs.append((slot, src.data, src.validity))
            src_cols.append((out_name, dtype, src))
        gathered = _finalize_lazy([lazy_pairs[s][0] for s in slots],
                                  [lazy_pairs[s][1] for s in slots],
                                  slots, idx, srcs)
        columns = dict(base.columns)
        for (out_name, dtype, src), (data, validity) in zip(src_cols,
                                                            gathered):
            columns[out_name] = DeviceColumn(data, dtype, validity,
                                             src.dictionary,
                                             src.dict_hashes)
        return ColumnBatch(schema, {f.name: columns[f.name]
                                    for f in schema.fields})

    def _program_key(self, batches, preps) -> str:
        parts = [_node_key(self.root)]
        for b in batches:
            cols = []
            for f in b.schema.fields:
                col = b.columns[f.name]
                cols.append((f.name, f.dtype, col.validity is not None,
                             _token_of(col.dictionary)))
            parts.append(repr(cols))
        for slot in sorted(preps):
            _t, mins, ranges = preps[slot]
            parts.append(f"T{slot}:{mins}:{ranges}")
        return "\x1e".join(parts)


def _node_key(node) -> str:
    if isinstance(node, _SourceExec):
        return f"S{node.index}"
    if isinstance(node, FilterExec):
        return (f"F({json.dumps(node.condition.to_dict(), sort_keys=True)})"
                f"[{_node_key(node.child)}]")
    if isinstance(node, ProjectExec):
        entries = [(name, src if isinstance(src, str)
                    else json.dumps(src.to_dict(), sort_keys=True))
                   for name, src in node.entries]
        return f"P({entries!r})[{_node_key(node.child)}]"
    if isinstance(node, BroadcastHashJoinExec):
        probe = node.left if node.build_side == "right" else node.right
        build = node.right if node.build_side == "right" else node.left
        cols = (sorted(node.out_columns)
                if node.out_columns is not None else None)
        return (f"B({node.how},{node.build_side},{node.left_keys},"
                f"{node.right_keys},{cols},{node._table_slot},"
                f"S{build.index})[{_node_key(probe)}]")
    raise HyperspaceException(f"Unfusible node in region: {node!r}")


# ---------------------------------------------------------------------------
# The fusion pass
# ---------------------------------------------------------------------------


def fuse_physical(root, conf=None):
    """Rewrite a physical tree, replacing maximal Filter/Project/
    BroadcastHashJoin regions with FusedStageExec. Sort-merge joins keep
    their subtrees intact on the bucketed path (the (batch, lengths)
    protocol and Exchange/Sort unwrapping are planner contracts); their
    general-path inner children still fuse."""
    fusible = (FilterExec, ProjectExec, BroadcastHashJoinExec)
    seen: Dict[int, object] = {}

    def rec(node):
        hit = seen.get(id(node))
        if hit is not None:
            return hit
        if isinstance(node, fusible):
            sources: List[_SourceExec] = []
            new_root = build_region(node, sources)
            out = FusedStageExec(new_root, sources, conf=conf)
        elif isinstance(node, SortMergeJoinExec):
            if not node.bucketed:
                # General path: the join unwraps Sort(Exchange(child))
                # wrappers itself — fuse the inner children, keep the
                # wrapper chain.
                for attr in ("left", "right"):
                    side = getattr(node, attr)
                    inner_holder, inner_attr = None, None
                    probe = side
                    if isinstance(probe, SortExec):
                        inner_holder, inner_attr = probe, "child"
                        probe = probe.child
                    if isinstance(probe, ExchangeExec):
                        inner_holder, inner_attr = probe, "child"
                        probe = probe.child
                    if inner_holder is None:
                        setattr(node, attr, rec(side))
                    else:
                        setattr(inner_holder, inner_attr, rec(probe))
            out = node
        else:
            if isinstance(node, ReusedExec):
                node.child = rec(node.child)
            elif hasattr(node, "_children"):  # UnionExec
                node._children = [rec(c) for c in node._children]
            else:
                for attr in ("child", "left", "right"):
                    c = getattr(node, attr, None)
                    if c is not None and hasattr(c, "execute"):
                        setattr(node, attr, rec(c))
            out = node
        seen[id(node)] = out
        return out

    def build_region(node, sources: List[_SourceExec]):
        if isinstance(node, FilterExec):
            return FilterExec(node.condition,
                              build_region(node.child, sources),
                              conf=node.conf)
        if isinstance(node, ProjectExec):
            return ProjectExec(list(node.entries),
                               build_region(node.child, sources))
        if isinstance(node, BroadcastHashJoinExec):
            probe_attr = "left" if node.build_side == "right" else "right"
            build_attr = "right" if node.build_side == "right" else "left"
            probe = build_region(getattr(node, probe_attr), sources)
            build = _SourceExec(rec(getattr(node, build_attr)),
                                len(sources))
            sources.append(build)
            sides = {probe_attr: probe, build_attr: build}
            return BroadcastHashJoinExec(
                sides["left"], sides["right"], node.left_keys,
                node.right_keys, node.build_side, how=node.how,
                out_columns=node.out_columns)
        src = _SourceExec(rec(node), len(sources))
        sources.append(src)
        return src

    return rec(root)
