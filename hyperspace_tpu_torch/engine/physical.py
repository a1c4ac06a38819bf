"""Physical plan: executable operator tree.

The reference's observable win is Spark's physical planner *not* inserting
ShuffleExchange/Sort under a SortMergeJoin when both sides are bucketed
(`index/rules/JoinIndexRule.scala:41-43`). This package owns that planning
step: Join compiles to SortMergeJoinExec, with ExchangeExec (hash
repartition) inserted only when a side is not already bucketed on the join
keys — so explain() shows the Exchange elision, and execution actually
skips the work. Scan, Filter and Project run the filter path, with bucket
pruning of equality literals over an index's bucketed layout; small join
sides broadcast (`BroadcastHashJoinExec`). Union runs hybrid scan (index
data UNION appended files), and a join over a Union distributes over it
where the join type allows. Aggregate, Sort, Limit (TopK over a Sort) and
cross joins run the analytic operators, Window the window functions and
Intersect/Except the set operations; identical subtrees plan as one
shared `ReusedExec`.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np

from hyperspace_tpu_torch import telemetry
from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.io import columnar, parquet
from hyperspace_tpu_torch.plan import expr as E
from hyperspace_tpu_torch.plan.nodes import (Aggregate, BucketSpec, Except,
                                             Filter, Join, Limit,
                                             LogicalPlan, Project, Scan,
                                             SetOp, Sort, Union, Window,
                                             sort_direction)
from hyperspace_tpu_torch.plan.schema import Schema


def _batch_rows(out) -> Optional[int]:
    """Output row count of an execute/execute_bucketed result."""
    if isinstance(out, tuple):
        out = out[0]
    return out.num_rows


def _close_unrecorded(op, rows_out=None, error=None) -> None:
    if rows_out is not None:
        op.rows_out = rows_out
    telemetry.trace.close_span(op, error)


def _instrument(fn, bucketed: bool):
    """Wrap an execute/execute_bucketed implementation with the telemetry
    operator hook: one span of the `operators` layer per execution — on
    the active query's recorder, or in the tracer's ring outside a query
    while tracing is on — reading each clock once at each boundary, and
    the deadline checkpoints at entry and exit. With neither active, the
    cost is a few ContextVar reads + one global read + None checks.
    Applied automatically to every PhysicalNode subclass by
    `PhysicalNode.__init_subclass__`."""

    @functools.wraps(fn)
    def wrapper(self, *args):
        # Cooperative-cancellation checkpoints bracket every operator
        # (one contextvar read + None check each when no deadline is
        # active — same always-off contract as the recorder hooks).
        # BOTH ends matter in a pull-based executor: every operator
        # STARTS during the initial tree descent (microseconds), so the
        # entry check alone would see the whole plan before any real
        # work ran; the finish check below — after the operator's
        # actual compute, on the way up — is what stops a cancelled
        # query between operators.
        phase = "scan" if self.name == "Scan" else "operator"
        telemetry.check_deadline(phase)
        rec = telemetry.current()
        if rec is not None:
            op = rec.start_operator(self.name, self, bucketed=bucketed)
            finish = rec.finish_operator
        elif telemetry.tracer() is not None:
            op = telemetry.trace.open_span(self.name, "operators")
            op.is_operator = True
            op.bucketed = bucketed
            finish = _close_unrecorded
        else:
            out = fn(self, *args)
            telemetry.check_deadline(phase)
            return out
        if bucketed:
            op.detail["num_buckets"] = args[0]
        try:
            out = fn(self, *args)
        except BaseException as exc:
            finish(op, error=repr(exc))
            raise
        finish(op, rows_out=_batch_rows(out))
        # The mid-query cancellation point (see entry comment): the
        # operator's record is already closed cleanly — the QUERY
        # aborts before the parent consumes the result.
        telemetry.check_deadline(phase)
        return out

    wrapper.__telemetry_instrumented__ = True
    return wrapper


class PhysicalNode:
    name: str = "Physical"

    def __init_subclass__(cls, **kwargs):
        # EVERY subclass's execute/execute_bucketed emits an operator
        # metrics record.
        super().__init_subclass__(**kwargs)
        for attr, bucketed in (("execute", False),
                               ("execute_bucketed", True)):
            fn = cls.__dict__.get(attr)
            if fn is not None and not getattr(
                    fn, "__telemetry_instrumented__", False):
                setattr(cls, attr, _instrument(fn, bucketed))

    @property
    def children(self) -> List["PhysicalNode"]:
        return []

    def execute(self) -> columnar.ColumnBatch:
        raise NotImplementedError

    def execute_bucketed(self, num_buckets: int):
        """Produce (batch concatenated in bucket order, per-bucket lengths
        as an int64 numpy array) for the bucketed join. Only meaningful on
        chains over a bucketed scan, or an Exchange."""
        raise HyperspaceException(
            f"{type(self).__name__} does not support bucketed execution.")

    def execute_sharded(self, num_buckets: int, mesh, align_plan=None):
        """Born-sharded execution (`parallel/spmd.py`): this node's output
        as a `ShardedBatch` whose shard s holds bucket range s, or None
        when the shape does not qualify (unbucketed source, host-lane row
        counts). None is a ROUTING answer, not an error: the caller runs
        the single-device path. `align_plan` asks this side to read
        ALIGNED to the other side's virtual sub-shard split. Default: not
        shardable."""
        return None

    def simple_string(self) -> str:
        return self.name

    def tree_string(self, depth: int = 0) -> str:
        lines = [("  " * depth) + ("+- " if depth else "")
                 + self.simple_string()]
        for c in self.children:
            lines.append(c.tree_string(depth + 1))
        return "\n".join(lines)

    def collect(self) -> List["PhysicalNode"]:
        out = [self]
        for c in self.children:
            out.extend(c.collect())
        return out


def _empty_batch(schema: Schema) -> columnar.ColumnBatch:
    import pyarrow as pa
    return columnar.from_arrow(
        pa.table({f.name: pa.array([], type=t.type)
                  for f, t in zip(schema.fields, schema.to_arrow())}), schema)


class ScanExec(PhysicalNode):
    name = "Scan"

    def __init__(self, scan: Scan, columns: Sequence[str],
                 allowed_buckets: Optional[Set[int]] = None, conf=None,
                 shared_members: int = 0):
        self.scan = scan
        self.columns = list(columns)
        self.out_schema = scan.schema.select(columns)
        self.conf = conf
        # >0: this scan is the SHARED read of an inter-query batch
        # cohort (`engine/batcher.py`) — one read serving that many
        # concurrent queries. Threaded to the segment cache's shared-
        # read counters and onto the operator record so the differ can
        # attribute amortized reads.
        self.shared_members = shared_members
        # Bucket pruning: when a filter above constrains every bucket
        # column to literal values, only these buckets can contain matches
        # (set by the planner, `_prune_buckets`). The index read then
        # touches 1/num_buckets of the files per point value.
        self.allowed_buckets = allowed_buckets

    def _annotate_read(self, files: List[str], host: bool,
                       files_total: Optional[int], nbytes: int) -> None:
        """Index-usage detail on this scan's operator record: lane, files
        scanned vs total, buckets scanned vs total, and the raw on-disk
        bytes behind the read (`nbytes`, from the stat that validated the
        footer counts — no second stat a file)."""
        if telemetry.current() is None:
            return
        detail = {"lane": "host" if host else "device",
                  "files_scanned": len(files),
                  "bytes_scanned": nbytes,
                  "roots": list(self.scan.root_paths)}
        if self.shared_members:
            detail["shared_members"] = self.shared_members
        spec = self.scan.bucket_spec
        if spec is not None:
            detail["buckets_total"] = spec.num_buckets
            detail["buckets_scanned"] = (len(self.allowed_buckets)
                                         if self.allowed_buckets is not None
                                         else spec.num_buckets)
            if self.allowed_buckets is not None \
                    and len(self.allowed_buckets) <= 128:
                # Per-bucket access identity for the replica router's
                # hot-range miner (`parallel/replica.py`): only when
                # pruning narrowed the read (a full-range scan carries no
                # hotness signal) and small enough to ride the ring.
                detail["bucket_ids"] = sorted(self.allowed_buckets)
        if files_total is not None:
            detail["files_total"] = files_total
        telemetry.annotate(**detail)

    def simple_string(self) -> str:
        bucket = (f", buckets={self.scan.bucket_spec.num_buckets}"
                  if self.scan.bucket_spec else "")
        pruned = ""
        if self.allowed_buckets is not None and self.scan.bucket_spec:
            pruned = (f", prunedBuckets={len(self.allowed_buckets)}"
                      f"/{self.scan.bucket_spec.num_buckets}")
        return (f"Scan parquet [{', '.join(self.columns)}] "
                f"{self.scan.root_paths}{bucket}{pruned}")

    def _guard_index_read(self, fn):
        """Run the read with the graceful-degradation contract: for a
        RULE-SELECTED index scan (scan.index_name set), data that turns
        out missing or unreadable raises the typed
        IndexDataUnavailableError that `DataFrame.collect` converts into a
        fallback to the source plan. Source-data scans keep their raw
        errors: there is nothing to degrade to. A snapshot-pinned index
        read holds its version directories pinned for the read's duration,
        so a concurrent vacuum defers its delete (`index/pins.py`)."""
        name = self.scan.index_name
        if name is None:
            return fn()
        if self.scan.pinned_version is not None:
            from hyperspace_tpu_torch.index import pins
            with pins.pinned(self.scan.root_paths):
                return self._checked_index_read(name, fn)
        return self._checked_index_read(name, fn)

    def _checked_index_read(self, name: str, fn):
        from hyperspace_tpu_torch.exceptions import IndexDataUnavailableError

        from hyperspace_tpu_torch.utils import file_utils
        missing = [r for r in self.scan.root_paths
                   if not file_utils.is_dir(r)
                   and not file_utils.is_file(r)]
        if missing:
            raise IndexDataUnavailableError(
                f"Index {name!r} data root(s) missing: "
                f"{', '.join(missing)}", index_name=name)
        try:
            return fn()
        except HyperspaceException:
            raise
        except Exception as exc:
            raise IndexDataUnavailableError(
                f"Index {name!r} data unreadable: {exc!r}",
                index_name=name) from exc

    def execute(self) -> columnar.ColumnBatch:
        return self._guard_index_read(self._execute)

    def _per_bucket_files(self) -> dict:
        """{bucket id: files} for this scan. An explicit or plan-time
        pinned file listing is grouped as it stands (no re-listing at
        execution); otherwise each root is listed."""
        if self.scan.pinned_version is not None \
                or self.scan._explicit_files:
            return parquet.bucket_map(self.scan.files())
        out: dict = {}
        for root in self.scan.root_paths:
            for b, fs in parquet.bucket_files(root).items():
                out.setdefault(b, []).extend(fs)
        return out

    def _execute(self) -> columnar.ColumnBatch:
        if self.allowed_buckets is not None and self.scan.bucket_spec:
            per_bucket = self._per_bucket_files()
            files_total = sum(len(v) for v in per_bucket.values())
            files = [f for b in sorted(self.allowed_buckets)
                     for f in per_bucket.get(b, [])]
        else:
            files = self.scan.files()
            files_total = len(files)
        if not files:
            return _empty_batch(self.out_schema)
        stats = parquet.file_footer_stats(files)
        return self._read(files, sum(r for r, _ in stats), files_total,
                          sum(b for _, b in stats))

    def _budget(self, device: bool):
        """Session-conf cache budget for this scan's lane (None = the
        process-wide env default). The device lane is the segment cache
        (`spark.hyperspace.cache.segments.bytes`), the host lane the
        decoded-batch cache (`spark.hyperspace.cache.read.bytes`)."""
        if self.conf is None:
            return None
        return (self.conf.segment_cache_bytes if device
                else self.conf.read_cache_bytes)

    def _read_device(self, files: List[str],
                     bucketed: bool = False) -> columnar.ColumnBatch:
        """Device-lane read THROUGH the segment cache: a warm hit is
        link-free (no parquet decode, no H2D). Rule-selected index scans
        key by (index root, committed version, bucket selector);
        unversioned scans fall back to stamp validation inside the
        cache."""
        from hyperspace_tpu_torch.io import segcache
        ref = segcache.segment_ref_for_scan(
            self.scan, allowed_buckets=self.allowed_buckets,
            bucketed=bucketed)
        return segcache.read_segment(files, self.columns, self.out_schema,
                                     ref=ref, conf=self.conf,
                                     budget=self._budget(device=True),
                                     shared_members=self.shared_members)

    def _read(self, files: List[str], rows: int, files_total: int,
              nbytes: int, bucketed: bool = False):
        """Read `files` (holding `rows` rows) on the adaptive lane: small
        reads (e.g. a pruned point-filter bucket) stay in host memory — a
        device round-trip would dwarf the work — and come through the
        stamped decoded-batch cache; larger ones come through the device
        segment cache onto the session's device."""
        from hyperspace_tpu_torch.constants import MIN_DEVICE_ROWS_DEFAULT
        min_dev = (self.conf.min_device_rows if self.conf is not None
                   else MIN_DEVICE_ROWS_DEFAULT)
        host = rows < min_dev
        self._annotate_read(files, host, files_total, nbytes)
        if host:
            return parquet.read_host_batch(
                files, self.columns, self.out_schema,
                budget=self._budget(device=False))
        return self._read_device(files, bucketed=bucketed)

    def execute_bucketed(self, num_buckets: int):
        return self._guard_index_read(
            lambda: self._execute_bucketed(num_buckets))

    def execute_sharded(self, num_buckets: int, mesh, align_plan=None):
        return self._guard_index_read(
            lambda: self._execute_sharded(num_buckets, mesh,
                                          align_plan=align_plan))

    def _execute_sharded(self, num_buckets: int, mesh, align_plan=None):
        """Born-sharded bucket-range read: shard s's bucket range decodes
        and lands on `mesh.devices[s]` through the segment cache
        (`spmd.read_sharded`), so a warm read is a cache hit per shard.
        Returns a ShardedBatch, or None when the read belongs on another
        lane: no bucket layout (or another bucket count), no rows, or —
        with `distribution.enabled=auto` — fewer rows than
        `max(min.device.rows, distribution.min.rows)`.

        Hot-bucket skew (`spmd.pad_blowup`) splits the hot range into
        virtual sub-shards instead of declining: equal row segments
        whose cuts may fall inside a hot bucket (`spmd.plan_skew_read`),
        stamped as `split_plan` so the join reads its other side aligned.
        `align_plan` IS that other side's read: each shard holds every
        row of the buckets intersecting the plan's segment."""
        from hyperspace_tpu_torch.io import segcache
        from hyperspace_tpu_torch.parallel import spmd
        from hyperspace_tpu_torch.parallel.mesh import (bucket_ranges,
                                                        total_shards)

        spec = self.scan.bucket_spec
        if spec is None or spec.num_buckets != num_buckets:
            return None
        if not spmd.supports_sharded(self.out_schema):
            return None
        per_bucket, files_total, ordered, stats, lengths = (
            self._bucket_layout(num_buckets))
        total = int(lengths.sum())
        if total == 0:
            return None
        mode = self.conf.distribution if self.conf is not None else "auto"
        if mode == "auto":
            from hyperspace_tpu_torch.constants import (
                DISTRIBUTION_MIN_ROWS_DEFAULT, MIN_DEVICE_ROWS_DEFAULT)
            min_dev = (self.conf.min_device_rows if self.conf is not None
                       else MIN_DEVICE_ROWS_DEFAULT)
            min_dist = (self.conf.distribution_min_rows
                        if self.conf is not None
                        else DISTRIBUTION_MIN_ROWS_DEFAULT)
            if total < max(min_dev, min_dist):
                return None  # host or single-device lane territory
        n_shards = total_shards(mesh)
        ref = segcache.segment_ref_for_scan(
            self.scan, allowed_buckets=self.allowed_buckets, bucketed=True)
        budget = self._budget(device=True)
        self._annotate_read([f for _, f in ordered], False, files_total,
                            sum(n for _, n in stats))
        if align_plan is not None:
            # The other side of a sub-shard join: intersected buckets
            # replicated per covering shard. Decline when replication
            # would itself blow the padded layout (both sides hot).
            if (align_plan.num_buckets != num_buckets
                    or align_plan.n_shards != n_shards):
                return None
            specs = spmd.plan_aligned_read(per_bucket, lengths, align_plan)
            C = max(1, max(spec[2] for spec in specs))
            if C * n_shards > max(spmd.PAD_BLOWUP_FACTOR * total, 1 << 16):
                return None
            return spmd.read_sharded([], lengths, self.columns,
                                     self.scan.schema, mesh, base_ref=ref,
                                     conf=self.conf, budget=budget,
                                     shard_specs=specs)
        if spmd.pad_blowup(lengths, n_shards):
            # Hot-bucket skew: split the hot range into row-balanced
            # virtual sub-shards and stay on the SPMD lane.
            split_plan, shard_specs = spmd.plan_skew_read(
                per_bucket, lengths, n_shards)
            telemetry.get_registry().counter(
                "mesh.spmd.subshard_reads").inc()
            telemetry.annotate(subsharded=True)
            return spmd.read_sharded([], lengths, self.columns,
                                     self.scan.schema, mesh, base_ref=ref,
                                     conf=self.conf, budget=budget,
                                     shard_specs=shard_specs,
                                     split_plan=split_plan)
        per_shard_files = [[f for b in range(lo, hi)
                            for f in per_bucket.get(b, [])]
                           for lo, hi in bucket_ranges(num_buckets,
                                                       n_shards)]
        return spmd.read_sharded(per_shard_files, lengths, self.columns,
                                 self.scan.schema, mesh, base_ref=ref,
                                 conf=self.conf, budget=budget)

    def _bucket_layout(self, num_buckets: int):
        """The surviving buckets' files and their per-bucket row counts,
        from the Parquet footers (no data read): (files per bucket, files
        before pruning, (bucket, file) in bucket order, footer stats,
        int64 lengths)."""
        per_bucket: dict = {}
        files_total = 0
        for b, files in self._per_bucket_files().items():
            files_total += len(files)
            if (self.allowed_buckets is not None
                    and b not in self.allowed_buckets):
                continue
            per_bucket.setdefault(b, []).extend(files)
        ordered = [(b, f) for b in range(num_buckets)
                   for f in per_bucket.get(b, [])]
        lengths = np.zeros(num_buckets, dtype=np.int64)
        stats = parquet.file_footer_stats([f for _, f in ordered])
        for (b, _), (c, _) in zip(ordered, stats):
            lengths[b] += c
        return per_bucket, files_total, ordered, stats, lengths

    def _execute_bucketed(self, num_buckets: int):
        """Read all bucket files in bucket order; per-bucket lengths come
        from the Parquet footers (no data read). The bucketed join matches
        globally, so multi-run buckets need no pre-sort here."""
        if self.scan.bucket_spec is None:
            raise HyperspaceException("Bucketed read on unbucketed scan.")
        per_bucket = self._per_bucket_files()
        files_total = sum(len(v) for v in per_bucket.values())
        # Buckets pruned by a filter above hold no row that can survive
        # it, so reading them as empty is equivalent.
        ordered = [(b, f) for b in range(num_buckets)
                   if self.allowed_buckets is None
                   or b in self.allowed_buckets
                   for f in per_bucket.get(b, [])]
        lengths = np.zeros(num_buckets, dtype=np.int64)
        if not ordered:
            return _empty_batch(self.out_schema), lengths
        files = [f for _, f in ordered]
        stats = parquet.file_footer_stats(files)
        for (b, _), (c, _) in zip(ordered, stats):
            lengths[b] += c
        return (self._read(files, int(lengths.sum()), files_total,
                           sum(n for _, n in stats), bucketed=True),
                lengths)


class FilterExec(PhysicalNode):
    name = "Filter"

    def __init__(self, condition: E.Expression, child: PhysicalNode,
                 conf=None):
        self.condition = condition
        self.child = child
        self.conf = conf

    @property
    def children(self):
        return [self.child]

    def simple_string(self) -> str:
        return f"Filter ({self.condition!r})"

    def execute(self) -> columnar.ColumnBatch:
        from hyperspace_tpu_torch.engine.compiler import apply_filter
        from hyperspace_tpu_torch.parallel.context import should_distribute
        batch = self.child.execute()
        if batch.num_rows == 0:
            return batch
        mesh = should_distribute(self.conf, batch.num_rows,
                                 host_batch=batch.is_host)
        if mesh is not None:
            from hyperspace_tpu_torch.parallel.scan import distributed_filter
            return distributed_filter(batch, self.condition, mesh)
        return apply_filter(batch, self.condition)

    def execute_bucketed(self, num_buckets: int):
        """Filter preserves bucket grouping: the compaction gather is
        stable-ascending, so surviving rows stay in bucket order; the new
        per-bucket lengths are counts of the mask per bucket."""
        import torch

        from hyperspace_tpu_torch.engine.compiler import compile_predicate

        batch, lengths = self.child.execute_bucketed(num_buckets)
        if batch.num_rows == 0:
            return batch, lengths
        mask = compile_predicate(self.condition, batch)
        if isinstance(mask, np.ndarray):  # host lane
            row_bucket = np.repeat(np.arange(num_buckets), lengths)
            new_lengths = np.bincount(row_bucket[mask],
                                      minlength=num_buckets).astype(np.int64)
            return batch.take(np.nonzero(mask)[0]), new_lengths
        row_bucket = torch.repeat_interleave(
            torch.arange(num_buckets, device=mask.device),
            torch.from_numpy(lengths).to(mask.device),
            output_size=batch.num_rows)
        with telemetry.span("sync:filter.bucketed", "device_wait"):
            new_lengths = torch.bincount(row_bucket[mask],
                                         minlength=num_buckets)
            idx = torch.nonzero(mask).squeeze(1)
            new_lengths = new_lengths.cpu().numpy().astype(np.int64)
        return batch.take(idx), new_lengths

    def execute_sharded(self, num_buckets: int, mesh, align_plan=None):
        """Filter keeps the sharded layout: rows never move, the mask
        narrows `row_valid` shard by shard, and the join or aggregate
        above skips masked rows as it skips padding. The bucket
        histogram is stale after filtering and is dropped; a sub-shard
        split carries over."""
        sh = self.child.execute_sharded(num_buckets, mesh,
                                        align_plan=align_plan)
        if sh is None:
            return None
        from hyperspace_tpu_torch.engine.compiler import compile_predicate
        from hyperspace_tpu_torch.parallel.spmd import (
            count_string_predicate_lookups)
        count_string_predicate_lookups(self.condition, sh.shards[0])
        return sh.narrowed(sh.shards, [
            valid & compile_predicate(self.condition, shard)
            for shard, valid in zip(sh.shards, sh.row_valid)],
            keep_lengths=False)


class ProjectExec(PhysicalNode):
    """Projection over (out_name, source) entries, where source is a plain
    child column name (pass-through) or a value Expression compiled by the
    same compiler filters use."""

    name = "Project"

    def __init__(self, entries, child: PhysicalNode):
        # Accept bare name strings (pass-through) or (out_name, source)
        # pairs; `source` is a child column name or an Expression.
        self.entries = [(e, e) if isinstance(e, str) else (e[0], e[1])
                        for e in entries]
        self.child = child

    @property
    def columns(self) -> List[str]:
        """Output names (the view the plan display uses)."""
        return [name for name, _ in self.entries]

    @property
    def children(self):
        return [self.child]

    def simple_string(self) -> str:
        parts = [name if isinstance(src, str) and src == name
                 else f"{src!r} AS {name}" for name, src in self.entries]
        return f"Project [{', '.join(parts)}]"

    def execute(self) -> columnar.ColumnBatch:
        return self._project(self.child.execute())

    def execute_bucketed(self, num_buckets: int):
        """Projection keeps rows in place, so the bucketed contract (batch
        + lengths) carries through."""
        batch, lengths = self.child.execute_bucketed(num_buckets)
        return self._project(batch), lengths

    def execute_sharded(self, num_buckets: int, mesh, align_plan=None):
        """Projection keeps the sharded layout (same rows, same shards):
        each shard projects its own columns."""
        sh = self.child.execute_sharded(num_buckets, mesh,
                                        align_plan=align_plan)
        if sh is None:
            return None
        return sh.narrowed([self._project(shard) for shard in sh.shards],
                           sh.row_valid, keep_lengths=True)

    def _project(self, batch: columnar.ColumnBatch) -> columnar.ColumnBatch:
        if all(isinstance(src, str) for _, src in self.entries):
            return batch.select([src for _, src in self.entries])
        from hyperspace_tpu_torch.engine.compiler import ExpressionCompiler
        from hyperspace_tpu_torch.plan.expr import infer_dtype
        from hyperspace_tpu_torch.plan.schema import Field
        compiler = ExpressionCompiler(batch)
        fields: List[Field] = []
        columns = {}
        for name, src in self.entries:
            if isinstance(src, str):
                f = batch.schema.field(src)
                columns[name] = batch.column(src)
                fields.append(Field(name, f.dtype, f.nullable))
            else:
                dtype = infer_dtype(src, batch.schema)
                columns[name] = compiler.value_column(src, dtype)
                fields.append(Field(name, dtype, True))
        return columnar.ColumnBatch(Schema(fields), columns)


def _one_lane(left: columnar.ColumnBatch, right: columnar.ColumnBatch):
    """Both join inputs on one lane: where one side was read on the host
    (below `min.device.rows`) and the other on the device, the host side
    takes one H2D copy per column onto the other's device."""
    if left.is_host == right.is_host:
        return left, right
    if left.is_host:
        return columnar.host_batch_to_device(left, right.device), right
    return left, columnar.host_batch_to_device(right, left.device)


class ExchangeExec(PhysicalNode):
    """Hash repartition — a REAL operator, not a marker. Its output is the
    child's rows grouped by hash partition of the keys, with THE bucket
    hash identity, so the layout matches what a bucketed index read
    produces. Its presence/absence in the plan is the explain()
    observable, and the work it represents is actually performed or
    actually elided. On a CUDA batch with at most
    `partition_kernel.MAX_KERNEL_BUCKETS` partitions the ids and lengths
    come from the fused CUDA kernel (`csrc/partition_histogram.cu`);
    above that from the hash kernel and `torch.bincount`."""

    name = "Exchange"

    def __init__(self, keys: Sequence[str], num_partitions: int,
                 child: PhysicalNode):
        self.keys = list(keys)
        self.num_partitions = num_partitions
        self.child = child

    @property
    def children(self):
        return [self.child]

    def simple_string(self) -> str:
        return (f"Exchange hashpartitioning({', '.join(self.keys)}, "
                f"{self.num_partitions})")

    def partition(self, batch: columnar.ColumnBatch):
        """(batch grouped by partition id, per-partition int64 lengths)."""
        if batch.num_rows == 0:
            return batch, np.zeros(self.num_partitions, dtype=np.int64)
        if batch.is_host:
            from hyperspace_tpu_torch.ops.host_hash import (
                host_column_hash_lanes, host_flat_hash32)
            lanes = []
            for k in self.keys:
                lanes.extend(host_column_hash_lanes(batch.column(k)))
            ids = (host_flat_hash32(lanes)
                   % np.uint32(self.num_partitions)).astype(np.int32)
            perm = np.argsort(ids, kind="stable")
            lengths = np.bincount(ids, minlength=self.num_partitions)
            return batch.take(perm), lengths.astype(np.int64)
        import torch

        from hyperspace_tpu_torch.ops.cuda import partition_kernel
        from hyperspace_tpu_torch.ops.cuda.hash_kernel import (
            hash_lanes_to_buckets)
        lanes = partition_kernel.batch_lanes(batch, self.keys)
        if self.num_partitions <= partition_kernel.MAX_KERNEL_BUCKETS:
            # Fused kernel: ids + histogram in ONE pass over the lanes.
            ids, lengths = partition_kernel.partition_ids_and_histogram(
                lanes, self.num_partitions)
        else:
            ids = hash_lanes_to_buckets(lanes, self.num_partitions)
            lengths = torch.bincount(ids, minlength=self.num_partitions)
        perm = torch.sort(ids, stable=True).indices
        with telemetry.span("sync:exchange.lengths", "device_wait"):
            lengths = lengths.cpu().numpy().astype(np.int64)
        return batch.take(perm), lengths

    def execute_partitioned(self):
        """(batch grouped by partition id, per-partition lengths)."""
        return self.partition(self.child.execute())

    def execute(self) -> columnar.ColumnBatch:
        return self.execute_partitioned()[0]

    def execute_bucketed(self, num_buckets: int):
        """An Exchange output satisfies the bucketed contract (batch in
        partition order + lengths) — it is how the planner re-buckets ONE
        side of a mismatched-bucket-count index join."""
        if num_buckets != self.num_partitions:
            raise HyperspaceException(
                f"Exchange partitions ({self.num_partitions}) != requested "
                f"buckets ({num_buckets}).")
        return self.execute_partitioned()

    def execute_sharded(self, num_buckets: int, mesh, align_plan=None):
        """The child's born-sharded layout at the CHILD's own bucket
        count: on a mesh the Exchange is not run, the SPMD join re-buckets
        the side's key lanes between shards instead
        (`parallel/spmd._repartition_lanes`; payload never moves). The
        JAX package's Exchange has no sharded form, so its engine
        declines the lane for a mismatched pair and runs the
        single-device join; the rows are the same. None when the child
        is not a bucketed chain, for an aligned read, or when the child's
        footer lengths show hot-bucket skew (a split layout cannot meet
        a re-bucketed side), checked before any data is read."""
        from hyperspace_tpu_torch.parallel import spmd
        from hyperspace_tpu_torch.parallel.mesh import total_shards

        scan = _chain_scan(self.child)
        if (num_buckets != self.num_partitions or align_plan is not None
                or scan is None):
            return None
        native = scan.scan.bucket_spec.num_buckets
        if native == num_buckets:
            return None
        lengths = scan._guard_index_read(
            lambda: scan._bucket_layout(native)[-1])
        if spmd.pad_blowup(lengths, total_shards(mesh)):
            return None
        return self.child.execute_sharded(native, mesh)


def _chain_scan(node: PhysicalNode) -> Optional["ScanExec"]:
    """The bucketed index scan under a Filter/Project chain, or None."""
    while isinstance(node, (FilterExec, ProjectExec)):
        node = node.child
    if isinstance(node, ScanExec) and node.scan.bucket_spec is not None:
        return node
    return None


def _annotate_lane(batch: columnar.ColumnBatch) -> None:
    """The lane an operator's input ran on, on its operator record."""
    telemetry.annotate(lane="host" if batch.is_host else "device")


class WindowExec(PhysicalNode):
    """Window functions (`ops/window.window_compute`): one column per spec
    appended to the child's rows, in the child's row order, on the lane
    the child's batch is on."""

    name = "Window"

    def __init__(self, partition_by, order_by, specs, out_schema: Schema,
                 child: PhysicalNode):
        self.partition_by = list(partition_by)
        self.order_by = list(order_by)
        self.specs = list(specs)
        self.out_schema = out_schema
        self.child = child

    @property
    def children(self):
        return [self.child]

    def simple_string(self) -> str:
        parts = [f"{s.func}({s.column}) AS {s.alias}" for s in self.specs]
        return (f"Window [{', '.join(parts)}] PARTITION BY "
                f"[{', '.join(self.partition_by)}]")

    def execute(self) -> columnar.ColumnBatch:
        from hyperspace_tpu_torch.ops.window import window_compute
        batch = self.child.execute()
        _annotate_lane(batch)
        return window_compute(batch, self.partition_by, self.order_by,
                              self.specs, self.out_schema)


class SortExec(PhysicalNode):
    """ORDER BY `keys` ("-name" descending; ascending nulls first,
    descending nulls last), stable (`ops/sort.sort_batch`). It is also the
    wrapper the general join path emits over each side's Exchange (the
    Spark-shaped plan); the join unwraps it, since the counting join
    matches unsorted rows."""

    name = "Sort"

    def __init__(self, keys: Sequence[str], child: PhysicalNode):
        self.keys = list(keys)
        self.child = child

    @property
    def children(self):
        return [self.child]

    def simple_string(self) -> str:
        return f"Sort [{', '.join(self.keys)}]"

    def execute(self) -> columnar.ColumnBatch:
        from hyperspace_tpu_torch.ops.sort import sort_batch
        batch = self.child.execute()
        if batch.num_rows == 0:
            return batch
        _annotate_lane(batch)
        return sort_batch(batch, self.keys)


class TopKExec(PhysicalNode):
    """Sort+Limit collapsed (`ops/sort.topk_batch`): ORDER BY + LIMIT n
    computes the exact first n rows via a packed-prefix threshold pass
    plus a small candidate sort, instead of fully sorting millions of rows
    that the limit immediately discards. A device input comes out on the
    host unless the candidate cap forced the full sort."""

    name = "TopK"

    def __init__(self, n: int, keys: Sequence[str], child: PhysicalNode):
        self.n = n
        self.keys = list(keys)
        self.child = child

    @property
    def children(self):
        return [self.child]

    def simple_string(self) -> str:
        return f"TopK {self.n} [{', '.join(self.keys)}]"

    def execute(self) -> columnar.ColumnBatch:
        from hyperspace_tpu_torch.ops.sort import topk_batch
        batch = self.child.execute()
        if batch.num_rows == 0:
            return batch
        _annotate_lane(batch)
        return topk_batch(batch, self.keys, self.n)


class AggregateExec(PhysicalNode):
    name = "Aggregate"

    def __init__(self, group_columns: Sequence[str], aggregates,
                 out_schema: Schema, child: PhysicalNode, conf=None):
        self.group_columns = list(group_columns)
        self.aggregates = list(aggregates)
        self.out_schema = out_schema
        self.child = child
        self.conf = conf

    @property
    def children(self):
        return [self.child]

    def simple_string(self) -> str:
        aggs = ", ".join(f"{a.func}({a.column})" for a in self.aggregates)
        return f"Aggregate [{', '.join(self.group_columns)}] [{aggs}]"

    def _materialize_inputs(self, batch: columnar.ColumnBatch):
        """Evaluate expression aggregation inputs (sum(x*y)) into temp
        columns so the segment reducers see plain columns; returns
        (augmented batch, rewritten specs)."""
        from hyperspace_tpu_torch.plan.nodes import AggSpec
        if not any(s.is_expression for s in self.aggregates):
            return batch, self.aggregates
        from hyperspace_tpu_torch.engine.compiler import ExpressionCompiler
        from hyperspace_tpu_torch.plan.expr import infer_dtype
        from hyperspace_tpu_torch.plan.schema import Field
        compiler = ExpressionCompiler(batch)
        fields = list(batch.schema.fields)
        columns = dict(batch.columns)
        specs = []
        for i, spec in enumerate(self.aggregates):
            if not spec.is_expression:
                specs.append(spec)
                continue
            dtype = infer_dtype(spec.column, batch.schema)
            name = f"__agg_in_{i}"
            columns[name] = compiler.value_column(spec.column, dtype)
            fields.append(Field(name, dtype, True))
            specs.append(AggSpec(spec.func, name, spec.alias))
        return columnar.ColumnBatch(Schema(fields), columns), specs

    def execute(self) -> columnar.ColumnBatch:
        from hyperspace_tpu_torch.ops.aggregate import group_aggregate
        from hyperspace_tpu_torch.parallel.context import should_distribute
        batch = self.child.execute()
        _annotate_lane(batch)
        batch, specs = self._materialize_inputs(batch)
        mesh = None
        if (self.group_columns and batch.num_rows > 0 and specs
                # count_distinct is not decomposable into mergeable
                # per-shard partials (a value present on two shards must
                # not count twice); it — and pure DISTINCT (no aggregate
                # lanes) — stay on the single-device lane.
                and not any(s.func == "count_distinct" for s in specs)):
            mesh = should_distribute(self.conf, batch.num_rows,
                                     host_batch=batch.is_host)
        if mesh is not None:
            from hyperspace_tpu_torch.parallel.aggregate import (
                distributed_group_aggregate)
            return distributed_group_aggregate(batch, self.group_columns,
                                               specs, self.out_schema,
                                               mesh)
        return group_aggregate(batch, self.group_columns, specs,
                               self.out_schema)


class LimitExec(PhysicalNode):
    name = "Limit"

    def __init__(self, n: int, child: PhysicalNode):
        self.n = n
        self.child = child

    @property
    def children(self):
        return [self.child]

    def simple_string(self) -> str:
        return f"Limit {self.n}"

    def execute(self) -> columnar.ColumnBatch:
        import torch
        batch = self.child.execute()
        if batch.num_rows <= self.n:
            return batch
        if batch.is_host:
            return batch.take(np.arange(self.n, dtype=np.int32))
        return batch.take(torch.arange(self.n, device=batch.device))


class CrossJoinExec(PhysicalNode):
    """Cartesian product (CROSS JOIN). Exists for the scalar-assembly
    idiom — TPC-H q11 and q22 cross a one-row aggregate with a larger side
    — so it is guarded against accidental blow-ups rather than optimized
    for scale. Output naming matches the equi-join: right-side duplicates
    get a `_r` suffix."""

    name = "CrossJoin"
    MAX_ROWS = 50_000_000

    def __init__(self, left: PhysicalNode, right: PhysicalNode):
        self.left = left
        self.right = right

    @property
    def children(self):
        return [self.left, self.right]

    def simple_string(self) -> str:
        return "CrossJoin"

    def execute(self) -> columnar.ColumnBatch:
        import torch

        from hyperspace_tpu_torch.plan.schema import Field

        lbatch, rbatch = _one_lane(self.left.execute(), self.right.execute())
        n_left, n_right = lbatch.num_rows, rbatch.num_rows
        if n_left * n_right > self.MAX_ROWS:
            raise HyperspaceException(
                f"Cross join would produce {n_left * n_right} rows "
                f"({n_left} x {n_right}); refusing.")
        if lbatch.is_host:
            li = np.repeat(np.arange(n_left, dtype=np.int64), n_right)
            ri = np.tile(np.arange(n_right, dtype=np.int64), n_left)
        else:
            li = torch.arange(n_left, device=lbatch.device
                              ).repeat_interleave(n_right)
            ri = torch.arange(n_right, device=lbatch.device).repeat(n_left)
        lt, rt = lbatch.take(li), rbatch.take(ri)
        fields = list(lt.schema.fields)
        columns = dict(lt.columns)
        left_names = {f.name.lower() for f in fields}
        for f in rt.schema.fields:
            name = (f.name if f.name.lower() not in left_names
                    else f.name + "_r")
            fields.append(Field(name, f.dtype, f.nullable))
            columns[name] = rt.columns[f.name]
        return columnar.ColumnBatch(Schema(fields), columns)


class ReusedExec(PhysicalNode):
    """Common-subplan reuse (Spark's ReuseExchange/ReuseSubquery analog):
    the planner routes every occurrence of an identical logical subtree
    (same serialization, same required columns) through ONE shared node
    that memoizes its executed batch, so a view used twice (TPC-H q15's
    revenue aggregate, a join distributed over a hybrid Union) computes
    once. Physical plans are built fresh per query, so the memo's lifetime
    is a single execution."""

    name = "ReusedSubplan"

    def __init__(self, child: PhysicalNode):
        self.child = child
        self._memo = None
        self._memo_bucketed = {}

    @property
    def children(self):
        return [self.child]

    def simple_string(self) -> str:
        return "ReusedSubplan"

    def execute(self) -> columnar.ColumnBatch:
        if self._memo is None:
            self._memo = self.child.execute()
        else:
            telemetry.annotate(reused=True)
        return self._memo

    def execute_bucketed(self, num_buckets: int):
        if num_buckets not in self._memo_bucketed:
            self._memo_bucketed[num_buckets] = \
                self.child.execute_bucketed(num_buckets)
        else:
            telemetry.annotate(reused=True)
        return self._memo_bucketed[num_buckets]


@contextlib.contextmanager
def _bucketed_match(lbatch, rbatch):
    """The co-bucketed match of SortMergeJoinExec's single-device bucketed
    lane: a `join:bucketed` span of the `operators` layer, and the
    counters `join.bucketed.calls`, `.rows_in` (both sides' rows) and
    `.s` (the span's wall)."""
    with telemetry.span("join:bucketed", "operators") as sp:
        yield
    reg = telemetry.get_registry()
    reg.counter("join.bucketed.calls").inc()
    reg.counter("join.bucketed.rows_in").inc(lbatch.num_rows
                                             + rbatch.num_rows)
    reg.counter("join.bucketed.s").inc(sp.wall_s)


class SortMergeJoinExec(PhysicalNode):
    name = "SortMergeJoin"

    def __init__(self, left: PhysicalNode, right: PhysicalNode,
                 left_keys: Sequence[str], right_keys: Sequence[str],
                 bucketed: bool, num_buckets: int = 0, how: str = "inner",
                 out_columns: Optional[Set[str]] = None, conf=None):
        self.left = left
        self.right = right
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.bucketed = bucketed
        self.num_buckets = num_buckets
        self.how = how
        self.conf = conf
        # Late projection: lowered OUTPUT column names the consumer needs;
        # assembly gathers only these.
        self.out_columns = out_columns

    @property
    def children(self):
        return [self.left, self.right]

    def simple_string(self) -> str:
        keys = ", ".join(f"{l}={r}"
                         for l, r in zip(self.left_keys, self.right_keys))
        mode = f"bucketed({self.num_buckets})" if self.bucketed else "global"
        return f"SortMergeJoin {self.how} [{keys}] {mode}"

    def execute(self) -> columnar.ColumnBatch:
        from hyperspace_tpu_torch.ops.join import sort_merge_join
        if self.bucketed:
            # The born-sharded SPMD lane first: both sides resident per
            # shard by bucket range, a per-shard counting match. None =
            # a precondition failed (counted as `spmd.fallbacks` when a
            # mesh was available); the single-device paths below follow.
            out = self._try_spmd()
            if out is not None:
                return out
        if self.how in ("left_semi", "left_anti"):
            # Membership joins: no expansion, no output from the right —
            # membership flags, then a single left-side gather.
            from hyperspace_tpu_torch.ops.join import semi_anti_indices
            if self.bucketed:
                lbatch, rbatch, _, _ = self._bucketed_inputs()
            else:
                lbatch, rbatch = _one_lane(self.left.execute(),
                                           self.right.execute())
            _annotate_lane(lbatch)
            with (_bucketed_match(lbatch, rbatch) if self.bucketed
                  else contextlib.nullcontext()):
                idx = semi_anti_indices(lbatch, rbatch, self.left_keys,
                                        self.right_keys,
                                        anti=self.how == "left_anti")
            return lbatch.take(idx)
        if self.bucketed:
            # Co-partitioned sides: zero shuffle, one global counting
            # match (`ops/bucketed_join.py`).
            from hyperspace_tpu_torch.ops.bucketed_join import (
                bucketed_sort_merge_join)
            lbatch, rbatch, l_lengths, r_lengths = self._bucketed_inputs()
            _annotate_lane(lbatch)
            with _bucketed_match(lbatch, rbatch):
                return bucketed_sort_merge_join(
                    lbatch, rbatch, l_lengths, r_lengths, self.left_keys,
                    self.right_keys, how=self.how, columns=self.out_columns)
        # General path: the planner wrapped each side in
        # Sort(Exchange(...)) — the Spark-shaped plan. Both wrappers are
        # unwrapped and elided at execution: the counting join matches in
        # ORIGINAL row space with one flat sort, so a hash repartition and
        # a per-side sort would be pure extra work.
        def unwrap(node):
            if isinstance(node, SortExec):
                node = node.child
            if isinstance(node, ExchangeExec):
                node = node.child
            return node

        lbatch, rbatch = _one_lane(unwrap(self.left).execute(),
                                   unwrap(self.right).execute())
        _annotate_lane(lbatch)
        return sort_merge_join(lbatch, rbatch, self.left_keys,
                               self.right_keys, how=self.how,
                               columns=self.out_columns)

    def _try_spmd(self) -> Optional[columnar.ColumnBatch]:
        """The born-sharded SPMD join (`parallel/spmd.py`), or None when
        a precondition fails: SPMD disabled, no mesh, a join type or a
        bucket count the lane does not take, or a side that is not
        shardable. Every decline with a mesh available is counted as
        `spmd.fallbacks` with its reason. Nothing here catches an error
        of the lane itself."""
        from hyperspace_tpu_torch.parallel import spmd
        from hyperspace_tpu_torch.parallel.context import (distribution_mesh,
                                                           mesh_size)

        if self.num_buckets <= 0:
            return None
        if self.conf is not None and not self.conf.distribution_spmd:
            return None  # the operational escape hatch: single-device
        mesh = distribution_mesh(self.conf)
        if mesh is None:
            return None
        if self.how not in ("inner", "left_outer", "right_outer",
                            "full_outer", "left_semi", "left_anti"):
            spmd.spmd_fallback("join-type")
            return None
        if self.num_buckets % mesh_size(mesh) != 0:
            spmd.spmd_fallback("bucket-count-indivisible")
            return None
        # One dispatch scope for the whole join (reads, match, output
        # assembly): concurrent queries do not interleave shard lists.
        with spmd.dispatch_guard(mesh):
            return self._run_spmd(mesh)

    def _run_spmd(self, mesh) -> Optional[columnar.ColumnBatch]:
        from hyperspace_tpu_torch.ops.bucketed_join import (
            assemble_join_output)
        from hyperspace_tpu_torch.parallel import spmd

        lsh = self.left.execute_sharded(self.num_buckets, mesh)
        if lsh is None:
            spmd.spmd_fallback("left-not-shardable")
            return None
        align = lsh.split_plan
        if align is not None:
            # Hot-bucket skew on the left: the right side reads ALIGNED
            # to the split. Replication breaks unmatched-right
            # uniqueness, so full and right outer joins leave the lane.
            if self.how == "full_outer":
                spmd.spmd_fallback("subshard-join-type")
                return None
            if self.how == "right_outer":
                spmd.spmd_fallback("subshard-right-outer")
                return None
            rsh = self.right.execute_sharded(self.num_buckets, mesh,
                                             align_plan=align)
        else:
            rsh = self.right.execute_sharded(self.num_buckets, mesh)
        if rsh is None:
            spmd.spmd_fallback("right-not-shardable")
            return None
        if align is None and rsh.split_plan is not None:
            # Right-side-only skew: replicating the LEFT would break
            # unmatched-left uniqueness (outer) and duplicate membership
            # indices (semi / anti). INNER has no unmatched rows, so the
            # roles swap: the left is read again ALIGNED to the right's
            # split and the right becomes the preserved side.
            if self.how != "inner":
                spmd.spmd_fallback("subshard-right")
                return None
            lsh = self.left.execute_sharded(self.num_buckets, mesh,
                                            align_plan=rsh.split_plan)
            if lsh is None:
                spmd.spmd_fallback("subshard-right")
                return None
            telemetry.get_registry().counter("mesh.spmd.side_swapped").inc()
            telemetry.annotate(lane="spmd")
            ri, li = spmd.sharded_join_indices(
                rsh, lsh, self.right_keys, self.left_keys, how="inner",
                conf=self.conf)
            return assemble_join_output(lsh.batch, rsh.batch, li, ri,
                                        how="inner",
                                        columns=self.out_columns)
        telemetry.annotate(lane="spmd")
        if self.how in ("left_semi", "left_anti"):
            idx = spmd.sharded_semi_anti_indices(
                lsh, rsh, self.left_keys, self.right_keys,
                anti=self.how == "left_anti", conf=self.conf)
            return lsh.batch.take(idx)
        if self.how == "right_outer":
            ri, li = spmd.sharded_join_indices(
                rsh, lsh, self.right_keys, self.left_keys,
                how="left_outer", conf=self.conf)
        else:
            li, ri = spmd.sharded_join_indices(
                lsh, rsh, self.left_keys, self.right_keys, how=self.how,
                conf=self.conf)
        return assemble_join_output(lsh.batch, rsh.batch, li, ri,
                                    how=self.how, columns=self.out_columns)

    def _bucketed_inputs(self):
        """Both sides in bucket order, on one lane, with their per-bucket
        lengths. (The sides read one after the other; each side's files
        already read concurrently on the shared IO pool.)"""
        lbatch, l_lengths = self.left.execute_bucketed(self.num_buckets)
        rbatch, r_lengths = self.right.execute_bucketed(self.num_buckets)
        lbatch, rbatch = _one_lane(lbatch, rbatch)
        return lbatch, rbatch, l_lengths, r_lengths


class BroadcastHashJoinExec(PhysicalNode):
    """Small-side join with NO Exchange/Sort on either side — the analog of
    Spark's BroadcastHashJoin. The planner routes a join here when one
    side's estimated size is under `spark.hyperspace.broadcast.threshold`;
    execution replicates that side as a direct-address lookup table and
    matches probe rows with one gather (`ops/broadcast_join.py`). When the
    keys are ineligible at run time (strings/floats/duplicates/wide
    ranges), the counting join runs on the bare batches instead."""

    name = "BroadcastHashJoin"

    def __init__(self, left: PhysicalNode, right: PhysicalNode,
                 left_keys: Sequence[str], right_keys: Sequence[str],
                 build_side: str, how: str = "inner",
                 out_columns: Optional[Set[str]] = None):
        self.left = left
        self.right = right
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.build_side = build_side  # "left" | "right"
        self.how = how
        self.out_columns = out_columns

    @property
    def children(self):
        return [self.left, self.right]

    def simple_string(self) -> str:
        keys = ", ".join(f"{l}={r}"
                         for l, r in zip(self.left_keys, self.right_keys))
        return (f"BroadcastHashJoin {self.how} [{keys}] "
                f"build={self.build_side}")

    def execute(self) -> columnar.ColumnBatch:
        from hyperspace_tpu_torch.ops.broadcast_join import (
            broadcast_join_indices, broadcast_membership)
        from hyperspace_tpu_torch.ops.bucketed_join import (
            assemble_join_output)
        from hyperspace_tpu_torch.ops.join import (semi_anti_indices,
                                                   sort_merge_join)

        lbatch, rbatch = _one_lane(self.left.execute(), self.right.execute())
        _annotate_lane(lbatch)
        # `join.broadcast.calls` counts every eager execution (a fused
        # stage counts its own), `join.broadcast.fallbacks` those whose
        # keys left the direct-address table for the counting join.
        reg = telemetry.get_registry()
        reg.counter("join.broadcast.calls").inc()
        if self.how in ("left_semi", "left_anti"):
            anti = self.how == "left_anti"
            idx = broadcast_membership(lbatch, rbatch, self.left_keys,
                                       self.right_keys, anti=anti)
            if idx is None:
                reg.counter("join.broadcast.fallbacks").inc()
                idx = semi_anti_indices(lbatch, rbatch, self.left_keys,
                                        self.right_keys, anti=anti)
            return lbatch.take(idx)
        if self.build_side == "right":
            pair = broadcast_join_indices(lbatch, rbatch, self.left_keys,
                                          self.right_keys, self.how)
        else:
            pair = broadcast_join_indices(
                rbatch, lbatch, self.right_keys, self.left_keys,
                "left_outer" if self.how == "right_outer" else "inner")
            if pair is not None:
                pair = pair[::-1]
        if pair is not None:
            li, ri = pair
            return assemble_join_output(lbatch, rbatch, li, ri, how=self.how,
                                        columns=self.out_columns)
        reg.counter("join.broadcast.fallbacks").inc()
        return sort_merge_join(lbatch, rbatch, self.left_keys,
                               self.right_keys, how=self.how,
                               columns=self.out_columns)


class UnionExec(PhysicalNode):
    name = "Union"

    def __init__(self, children: Sequence[PhysicalNode]):
        self._children = list(children)

    @property
    def children(self):
        return list(self._children)

    def simple_string(self) -> str:
        return f"Union ({len(self._children)})"

    def execute(self) -> columnar.ColumnBatch:
        batches = [c.execute() for c in self._children]
        non_empty = [b for b in batches if b.num_rows > 0]
        if not non_empty:
            return batches[0]
        return columnar.concat_batches(non_empty)

    def execute_bucketed(self, num_buckets: int):
        """Hybrid scan as a bucketed source: each child produces the
        (batch, lengths) contract — the index side from its on-disk
        layout, the appended side through the ExchangeExec the planner
        wrapped it in — and the parts are interleaved bucket-major so the
        combined batch satisfies the layout the bucketed join expects:
        one stable sort keyed by (bucket, part) over the concatenation,
        which keeps each part's rows of a bucket in their order."""
        import torch

        parts = [c.execute_bucketed(num_buckets) for c in self._children]
        if len(parts) == 1:
            return parts[0]
        lengths = [np.asarray(l, dtype=np.int64) for _, l in parts]
        total_lengths = np.sum(lengths, axis=0)
        non_empty = [i for i, (b, _) in enumerate(parts) if b.num_rows > 0]
        if len(non_empty) <= 1:
            return parts[non_empty[0] if non_empty else 0][0], total_lengths
        combined = columnar.concat_batches([parts[i][0] for i in non_empty])
        n_parts = len(non_empty)
        if combined.is_host:
            key = np.concatenate([
                np.repeat(np.arange(num_buckets, dtype=np.int64) * n_parts
                          + j, lengths[i])
                for j, i in enumerate(non_empty)])
            return (combined.take(np.argsort(key, kind="stable")),
                    total_lengths)
        device = combined.device
        base = torch.arange(num_buckets, dtype=torch.int64,
                            device=device) * n_parts
        key = torch.cat([
            torch.repeat_interleave(
                base + j, torch.from_numpy(lengths[i]).to(device),
                output_size=int(lengths[i].sum()))
            for j, i in enumerate(non_empty)])
        return (combined.take(torch.sort(key, stable=True).indices),
                total_lengths)


class SetOpExec(PhysicalNode):
    """INTERSECT / EXCEPT (DISTINCT set semantics, NULL == NULL — see
    `ops/setops.py`). Output rows come from the left side in
    first-occurrence order; columns align across sides by name. A host
    side meeting a device side runs on the device."""

    def __init__(self, left: PhysicalNode, right: PhysicalNode,
                 names: Sequence[str], anti: bool):
        self.left = left
        self.right = right
        self.names = list(names)
        self.anti = anti
        self.name = "Except" if anti else "Intersect"

    @property
    def children(self):
        return [self.left, self.right]

    def simple_string(self) -> str:
        return f"{self.name} [{', '.join(self.names)}]"

    def execute(self) -> columnar.ColumnBatch:
        from hyperspace_tpu_torch.ops.setops import set_op_indices
        lbatch = self.left.execute()
        rbatch = self.right.execute()
        host = lbatch.is_host and rbatch.is_host
        telemetry.annotate(lane="host" if host else "device")
        idx = set_op_indices(lbatch, rbatch, self.names, self.anti)
        if lbatch.is_host and not host:
            lbatch = columnar.host_batch_to_device(lbatch, rbatch.device)
        return lbatch.select(self.names).take(idx)


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------


_PRUNE_MAX_COMBOS = 64


def _literal_values_for(column: str, conjuncts) -> Optional[List]:
    """Literal values `column` may take under the conjunction, from the
    narrowest `col = lit` / `col IN (lits)` constraint; None if
    unconstrained (or only constrained through nulls, where pruning is
    skipped — `x = NULL` is never true, so correctness never depends on
    pruning)."""
    best: Optional[List] = None
    for c in conjuncts:
        values = None
        if isinstance(c, E.EqualTo):
            a, b = c.left, c.right
            if isinstance(a, E.Column) and isinstance(b, E.Literal):
                values = [b.value] if a.name.lower() == column else None
            elif isinstance(b, E.Column) and isinstance(a, E.Literal):
                values = [a.value] if b.name.lower() == column else None
        elif (isinstance(c, E.In) and isinstance(c.child, E.Column)
              and c.child.name.lower() == column):
            values = [v.value for v in c.values]
        if values is None or any(v is None for v in values):
            continue
        if best is None or len(values) < len(best):
            best = values
    return best


def _prune_buckets(condition: E.Expression,
                   scan: Scan) -> Optional[Set[int]]:
    """Bucket ids that can contain rows satisfying `condition`, or None
    when pruning does not apply. Sound because every bucket column must be
    pinned to literals by top-level conjuncts: any matching row hashes to
    one of the returned buckets. The literal tuples are hashed with the
    host mirror of THE build hash (`ops/host_hash.host_bucket_ids`) so the
    computed ids match the on-disk layout exactly."""
    spec = scan.bucket_spec
    if spec is None:
        return None
    conjuncts = E.split_conjunctive(condition)
    per_column: List[List] = []
    for c in spec.bucket_columns:
        values = _literal_values_for(c.lower(), conjuncts)
        if values is None:
            return None
        per_column.append(values)
    combos = list(itertools.product(*per_column))
    if not combos or len(combos) > _PRUNE_MAX_COMBOS:
        return None

    from hyperspace_tpu_torch.ops.host_hash import host_bucket_ids

    key_schema = scan.schema.select(list(spec.bucket_columns))
    np_of = {"int64": np.int64, "int32": np.int32, "int16": np.int16,
             "int8": np.int8, "bool": np.bool_, "float64": np.float64,
             "float32": np.float32, "date32": np.int32,
             "timestamp": np.int64, "string": None}
    try:
        columns = []
        for i, f in enumerate(key_schema.fields):
            vals = [combo[i] for combo in combos]
            dt = np_of[f.dtype]
            columns.append(np.asarray(vals, dtype=str) if dt is None
                           else np.asarray(vals).astype(dt))
        ids = host_bucket_ids(columns, [f.dtype for f in key_schema.fields],
                              spec.num_buckets)
    except (ValueError, TypeError, OverflowError, HyperspaceException):
        return None  # literal not representable in the key type -> no prune
    return set(int(b) for b in ids)


def _apply_bucket_pruning(condition: E.Expression, child: PhysicalNode):
    """Descend Project/Filter chains — and Union fan-outs (hybrid scan:
    index UNION appended files) — to each ScanExec and attach the allowed
    bucket set derived from the filter condition (no-op on unbucketed
    scans). Descending through an intermediate Filter (e.g. the hybrid
    lineage exclusion) is sound: pruning only drops buckets no row of
    which can satisfy the OUTER condition, and inner filters only remove
    more rows."""
    node = child
    while isinstance(node, (ProjectExec, FilterExec)):
        node = node.child
    if isinstance(node, UnionExec):
        for c in node.children:
            _apply_bucket_pruning(condition, c)
    elif isinstance(node, ScanExec) and node.allowed_buckets is None:
        node.allowed_buckets = _prune_buckets(condition, node.scan)
    return child


def _hoist_union(plan: LogicalPlan) -> LogicalPlan:
    """Pull a Union above Filter/Project wrappers (both distribute over
    union row-wise) so join-over-union distribution can see it."""
    if isinstance(plan, (Project, Filter)):
        child = _hoist_union(plan.child)
        if isinstance(child, Union):
            return Union([plan.with_children([c])
                          for c in child.children])
    return plan


def _chain_has_bucketed_scan(node: PhysicalNode) -> bool:
    while isinstance(node, (ProjectExec, FilterExec, ReusedExec)):
        node = node.child
    return isinstance(node, ScanExec) and node.scan.bucket_spec is not None


def _bucketize_union_children(node: PhysicalNode, keys: List[str],
                              num_buckets: int) -> None:
    """Descend a join side's Project/Filter chain; if it feeds a UnionExec
    (hybrid scan), wrap each child that does NOT ride a bucketed layout in
    an ExchangeExec over the join keys — the appended slice then arrives
    co-partitioned with the index buckets. Idempotent (a shared union may
    be visited by both sides of a self-join)."""
    while isinstance(node, (ProjectExec, FilterExec, ReusedExec)):
        node = node.child
    if not isinstance(node, UnionExec):
        return
    node._children = [
        c if _chain_has_bucketed_scan(c) or (
            isinstance(c, ExchangeExec) and c.num_partitions == num_buckets)
        else ExchangeExec(keys, num_buckets, c)
        for c in node._children]


def _split_join_required(required: Set[str], left_schema: Schema,
                         right_schema: Schema, left_keys=(), right_keys=()):
    """Split a join's required OUTPUT names into per-side input column
    sets. A required `<name>_r` maps back to the right-side source AND
    keeps the left-side copy alive — the output renames the right column
    only when the left batch still carries the collision, so pruning the
    left copy would silently un-suffix the output."""
    left_req = ({n for n in required if left_schema.contains(n)}
                | set(left_keys))
    right_req = ({n for n in required if right_schema.contains(n)}
                 | set(right_keys))
    for n in required:
        base = n[:-2] if n.lower().endswith("_r") else None
        if (base and right_schema.contains(base)
                and left_schema.contains(base)):
            right_req.add(base)
            left_req.add(base)
    return left_req, right_req


def _join_keys(condition: E.Expression, left_schema: Schema,
               right_schema: Schema) -> Tuple[List[str], List[str]]:
    """Extract equi-join key pairs from an AND-of-equalities condition
    (reference applicability: `JoinIndexRule.scala:179-185,278-317`)."""
    left_keys: List[str] = []
    right_keys: List[str] = []
    for conjunct in E.split_conjunctive(condition):
        if not isinstance(conjunct, E.EqualTo):
            raise HyperspaceException(
                f"Only equi-join conditions are supported; got {conjunct!r}")
        a, b = conjunct.left, conjunct.right
        if not isinstance(a, E.Column) or not isinstance(b, E.Column):
            raise HyperspaceException(
                "Join condition must compare columns directly.")
        if left_schema.contains(a.name) and right_schema.contains(b.name):
            left_keys.append(a.name)
            right_keys.append(b.name)
        elif left_schema.contains(b.name) and right_schema.contains(a.name):
            left_keys.append(b.name)
            right_keys.append(a.name)
        else:
            raise HyperspaceException(
                f"Join columns not found on both sides: {conjunct!r}")
    return left_keys, right_keys


def _underlying_bucket_spec(plan: LogicalPlan) -> Optional[BucketSpec]:
    """The bucket spec of the scan feeding a linear Filter/Project chain —
    filters and projections preserve bucketing and intra-bucket order. A
    Union whose FIRST child rides a bucketed layout (hybrid scan: index
    data UNION appended files) reports that spec; the planner re-buckets
    the remaining children through ExchangeExec."""
    node = plan
    while isinstance(node, (Filter, Project)):
        node = node.child
    if isinstance(node, Union):
        return _underlying_bucket_spec(node.children[0])
    return node.bucket_spec if isinstance(node, Scan) else None


# Approximate in-memory bytes per value; strings budget code + a share of
# the dictionary. Only relative accuracy vs the broadcast threshold
# matters (Spark's estimate — raw file size — is no finer).
_DTYPE_WIDTH = {"bool": 1, "int8": 1, "int16": 2, "int32": 4, "date32": 4,
                "float32": 4, "int64": 8, "float64": 8, "timestamp": 8,
                "string": 16}


def _estimated_plan_bytes(plan: LogicalPlan,
                          required: Set[str]) -> Optional[int]:
    """Upper-bound decoded bytes of `plan`'s output restricted to
    `required`, from Parquet footer row counts (no data read). None when
    the subtree's cardinality is not bounded by its scans (aggregates and
    joins can shrink OR grow), so such a side never qualifies for
    broadcast. Mirrors what
    Spark's `autoBroadcastJoinThreshold` keys on (leaf statistics
    propagated through Filter/Project)."""
    if isinstance(plan, Scan):
        files = plan.files()
        if not files:
            return 0
        try:
            rows = sum(parquet.file_row_counts(files))
        except Exception:
            return None
        lowered = {r.lower() for r in required}
        width = sum(_DTYPE_WIDTH.get(f.dtype, 8) for f in plan.schema.fields
                    if f.name.lower() in lowered)
        return rows * max(width, 1)
    if isinstance(plan, (Filter, Sort, Limit)):
        # Row count bounded by the child's (Filter/Limit only shrink).
        return _estimated_plan_bytes(plan.child, required)
    if isinstance(plan, Project):
        # Map required OUTPUT names back through the projection to child
        # columns: a renamed/computed column contributes its SOURCE
        # columns' width, so a side whose columns are all computed is
        # not underestimated past the threshold.
        lowered = {r.lower() for r in required}
        child_req: Set[str] = set()
        for c in plan.columns:
            if isinstance(c, str):
                if c.lower() in lowered:
                    child_req.add(c)
            elif c.name.lower() in lowered:
                child_req |= c.child.references()
        return _estimated_plan_bytes(plan.child, child_req)
    if isinstance(plan, Union):
        total = 0
        for c in plan.children:
            est = _estimated_plan_bytes(c, required)
            if est is None:
                return None
            total += est
        return total
    return None


def _required_for(plan: LogicalPlan, required: Set[str]) -> List[str]:
    """required column names resolved against plan schema, in schema order."""
    lowered = {r.lower() for r in required}
    return [f.name for f in plan.schema.fields if f.name.lower() in lowered]


def plan_physical(plan: LogicalPlan,
                  required: Optional[Set[str]] = None,
                  conf=None) -> PhysicalNode:
    """Logical -> physical with projection pushdown into scans. `conf`
    carries the session's lane thresholds, device and broadcast threshold
    to the operators. Identical logical subtrees (by fingerprint + required
    columns) compile to ONE shared `ReusedExec`, so a repeated subquery
    executes once."""
    counts: dict = {}
    keys: dict = {}

    def _count(node):
        key = _subtree_key(node, keys)
        counts[key] = counts.get(key, 0) + 1
        for c in node.children:
            _count(c)

    _count(plan)
    return _plan_physical(plan, required, conf,
                          {"counts": counts, "keys": keys, "built": {}})


def _subtree_key(node: LogicalPlan, memo: dict) -> str:
    """Bottom-up md5 fingerprint of a subtree: each node hashes its LOCAL
    fields plus its children's fingerprints, so the whole walk is O(nodes)
    instead of re-serializing every subtree per ancestor. Memoized by node
    identity (nodes stay alive for the duration of planning)."""
    import hashlib
    import json

    k = memo.get(id(node))
    if k is not None:
        return k
    local = node.to_dict()
    for field in ("child", "children", "left", "right"):
        local.pop(field, None)
    payload = (type(node).__name__ + json.dumps(local, sort_keys=True)
               + "[" + ",".join(_subtree_key(c, memo)
                                for c in node.children) + "]")
    k = hashlib.md5(payload.encode()).hexdigest()
    memo[id(node)] = k
    return k


def _is_prunable_chain(plan: LogicalPlan) -> bool:
    """Project*/Scan chain over a bucketed scan with no Filter inside —
    the shape `_apply_bucket_pruning` prunes FROM ABOVE. Sharing it would
    either disable pruning or wrongly prune one consumer's rows with
    another's condition, so such chains are never reused."""
    node = plan
    while isinstance(node, Project):
        node = node.child
    return isinstance(node, Scan) and node.bucket_spec is not None


def _plan_physical(plan: LogicalPlan, required: Optional[Set[str]], conf,
                   ctx) -> PhysicalNode:
    if required is None:
        required = set(plan.schema.names)

    parent_count = ctx.get("parent_count", 1)
    reuse_key = None
    count = parent_count
    if plan.children and not _is_prunable_chain(plan):
        subtree = _subtree_key(plan, ctx["keys"])
        count = ctx["counts"].get(subtree, 0)
        # Only MAXIMAL shared subtrees get a ReusedExec: inside a shared
        # subtree every descendant repeats as often as its ancestor, and
        # the ancestor's memo already deduplicates the whole region. A
        # descendant shared MORE widely than its ancestor (used elsewhere
        # too) still gets its own wrapper. The enclosing share count scopes
        # through ctx (saved/restored around the subtree build).
        if count > parent_count:
            reuse_key = (subtree, frozenset(r.lower() for r in required))
            shared = ctx["built"].get(reuse_key)
            if shared is not None:
                return shared

    ctx["parent_count"] = max(parent_count, count)
    try:
        built = _plan_physical_node(plan, required, conf, ctx)
    finally:
        ctx["parent_count"] = parent_count
    if reuse_key is not None:
        built = ReusedExec(built)
        ctx["built"][reuse_key] = built
    return built


def _plan_physical_node(plan: LogicalPlan, required: Set[str], conf,
                        ctx) -> PhysicalNode:
    if isinstance(plan, Scan):
        return ScanExec(plan, _required_for(plan, required), conf=conf)

    if isinstance(plan, Filter):
        child_required = set(required) | plan.condition.references()
        child = _apply_bucket_pruning(
            plan.condition,
            _plan_physical(plan.child, child_required, conf, ctx))
        return FilterExec(plan.condition, child, conf=conf)

    if isinstance(plan, Project):
        child = _plan_physical(plan.child, plan.references(), conf, ctx)
        # Resolve names against the child schema but KEEP the declared
        # order; computed entries carry their expression.
        entries = []
        for c in plan.columns:
            if isinstance(c, str):
                f = plan.child.schema.field(c)
                entries.append((f.name, f.name))
            else:
                entries.append((c.name, c.child))
        return ProjectExec(entries, child)

    if isinstance(plan, Aggregate):
        child_required = set(plan.group_columns)
        for a in plan.aggregates:
            child_required |= a.references()
        if not child_required:
            # Bare count(*): a ColumnBatch carries its row count only
            # through its columns, so read at least one.
            child_required = {plan.child.schema.names[0]}
        return AggregateExec(plan.group_columns, plan.aggregates,
                             plan.schema,
                             _plan_physical(plan.child, child_required,
                                            conf, ctx),
                             conf=conf)

    if isinstance(plan, Window):
        aliases = {s.alias.lower() for s in plan.specs}
        child_required = ({n for n in required if n.lower() not in aliases
                           and plan.child.schema.contains(n)}
                          | set(plan.partition_by)
                          | {sort_direction(c)[0] for c in plan.order_by})
        for s in plan.specs:
            child_required |= s.references()
        if not child_required:
            child_required = {plan.child.schema.names[0]}
        # Output schema restricted to what survives pruning: child columns
        # actually read + every window column.
        child_phys = _plan_physical(plan.child, child_required, conf, ctx)
        kept = {n.lower() for n in child_required}
        fields = [f for f in plan.child.schema.fields
                  if f.name.lower() in kept]
        out_schema = Schema(fields + [plan.schema.field(s.alias)
                                      for s in plan.specs])
        return WindowExec(plan.partition_by, plan.order_by, plan.specs,
                          out_schema, child_phys)

    if isinstance(plan, Sort):
        child_required = (set(required)
                          | {sort_direction(c)[0] for c in plan.columns})
        return SortExec(plan.columns,
                        _plan_physical(plan.child, child_required, conf,
                                       ctx))

    if isinstance(plan, Limit):
        if isinstance(plan.child, Sort):
            child_required = (set(required) | {sort_direction(c)[0]
                                               for c in plan.child.columns})
            return TopKExec(plan.n, plan.child.columns,
                            _plan_physical(plan.child.child, child_required,
                                           conf, ctx))
        return LimitExec(plan.n,
                         _plan_physical(plan.child, required, conf, ctx))

    if isinstance(plan, Union):
        # Children may expose different column orders for the same names
        # (index schema vs source schema): normalize through a Project.
        wanted = _required_for(plan, required)
        return UnionExec([
            ProjectExec([(c.schema.field(n).name, c.schema.field(n).name)
                         for n in wanted],
                        _plan_physical(c, set(wanted), conf, ctx))
            for c in plan.children])

    if isinstance(plan, SetOp):
        # Set-op identity is over FULL rows of the node schema: children
        # must produce every column regardless of what the parent needs.
        names = [f.name for f in plan.left.schema.fields]
        left_phys = _plan_physical(plan.left, set(names), conf, ctx)
        right_phys = _plan_physical(
            plan.right, set(plan.right.schema.names), conf, ctx)
        return SetOpExec(left_phys, right_phys, names,
                         anti=isinstance(plan, Except))

    if isinstance(plan, Join):
        return _plan_join(plan, required, conf, ctx)

    raise HyperspaceException(f"Cannot plan node: {plan!r}")


def _plan_join(plan: Join, required: Set[str], conf, ctx) -> PhysicalNode:
    """The join branch: a cross product for a cross join; for an equi-join
    the bucketed sort-merge join when both sides ride compatible bucketed
    layouts (the coarser side re-bucketed through an Exchange when the
    counts differ), a broadcast join when one side is small, the general
    sort-merge join otherwise."""
    if plan.join_type == "cross":
        left_req, right_req = _split_join_required(
            set(required), plan.left.schema, plan.right.schema)
        # A side no output column resolves to must still read ONE column:
        # a zero-column batch reports num_rows == 0 and would collapse the
        # whole product (the floor the Aggregate branch applies for a bare
        # count(*)).
        if not left_req:
            left_req = {plan.left.schema.names[0]}
        if not right_req:
            right_req = {plan.right.schema.names[0]}
        return CrossJoinExec(_plan_physical(plan.left, left_req, conf, ctx),
                             _plan_physical(plan.right, right_req, conf,
                                            ctx))
    # Join-over-union distribution: (A UNION B) JOIN R executes as
    # (A JOIN R) UNION (B JOIN R) when the join type distributes over that
    # side. The hybrid-scan Union then keeps its index part on the
    # bucketed fast path while only the (small) appended part pays a
    # general join. R's share count rises by the extra branches, so a
    # non-prunable R plans as one ReusedExec and executes once. Filter and
    # Project distribute over Union, so the union is hoisted through them
    # first.
    left_h = _hoist_union(plan.left)
    right_h = _hoist_union(plan.right)
    if (isinstance(left_h, Union)
            and plan.join_type in ("inner", "left_outer", "left_semi",
                                   "left_anti")):
        k = _subtree_key(plan.right, ctx["keys"])
        ctx["counts"][k] = ctx["counts"].get(k, 0) + len(left_h.children) - 1
        return _plan_physical_node(
            Union([Join(c, plan.right, plan.condition, plan.join_type)
                   for c in left_h.children]), required, conf, ctx)
    if (isinstance(right_h, Union)
            and plan.join_type in ("inner", "right_outer")):
        k = _subtree_key(plan.left, ctx["keys"])
        ctx["counts"][k] = ctx["counts"].get(k, 0) + len(right_h.children) - 1
        return _plan_physical_node(
            Union([Join(plan.left, c, plan.condition, plan.join_type)
                   for c in right_h.children]), required, conf, ctx)
    left_keys, right_keys = _join_keys(plan.condition, plan.left.schema,
                                       plan.right.schema)
    membership = plan.join_type in ("left_semi", "left_anti")
    if membership:
        # Membership join: the right side contributes only its keys.
        out_columns = None
        left_required = ({n for n in required
                          if plan.left.schema.contains(n)} | set(left_keys))
        right_required = set(right_keys)
    else:
        out_columns = {n.lower() for n in required}
        left_required, right_required = _split_join_required(
            set(required), plan.left.schema, plan.right.schema,
            left_keys, right_keys)
    left_phys = _plan_physical(plan.left, left_required, conf, ctx)
    right_phys = _plan_physical(plan.right, right_required, conf, ctx)
    lspec = _underlying_bucket_spec(plan.left)
    rspec = _underlying_bucket_spec(plan.right)

    def _align_to_spec(spec: Optional[BucketSpec]):
        """Reorder the (left, right) key PAIRS so the left list matches
        `spec.bucket_columns` — each side hashes in its own indexed-column
        order, whatever the condition's conjunct order. None when the key
        set is not exactly the bucket column set."""
        if spec is None or len(spec.bucket_columns) != len(left_keys):
            return None
        lk_lower = [k.lower() for k in left_keys]
        order = []
        for bc in spec.bucket_columns:
            if bc.lower() not in lk_lower:
                return None
            order.append(lk_lower.index(bc.lower()))
        if len(set(order)) != len(order):
            return None
        return ([left_keys[i] for i in order],
                [right_keys[i] for i in order])

    def _key_dtypes_match() -> bool:
        # Co-partitioning assumes both layouts hashed with the SAME lane
        # decomposition; int32 vs int64 (or float32 vs float64) keys
        # bucket equal values differently, so a bucketed path would drop
        # matches — the general path promotes dtypes before matching.
        return all(plan.left.schema.field(lk).dtype
                   == plan.right.schema.field(rk).dtype
                   for lk, rk in zip(left_keys, right_keys))

    threshold = conf.broadcast_threshold if conf is not None else 0
    if membership and threshold > 0:
        # For MEMBERSHIP joins a small right side beats even an aligned
        # bucketed layout: the direct-address probe is one gather over the
        # left, no joint counting match.
        est = _estimated_plan_bytes(plan.right, right_required)
        if est is not None and est <= threshold:
            return BroadcastHashJoinExec(left_phys, right_phys, left_keys,
                                         right_keys, build_side="right",
                                         how=plan.join_type,
                                         out_columns=out_columns)

    aligned = _align_to_spec(lspec)
    # The right layout must hash the MAPPED columns in the same positions.
    if (aligned is None or rspec is None
            or [c.lower() for c in rspec.bucket_columns]
            != [k.lower() for k in aligned[1]]):
        aligned = None

    if aligned is not None and _key_dtypes_match():
        left_keys, right_keys = aligned
        # Bucketed SMJ — the indexed fast path. With mismatched bucket
        # counts (the ranker's fallback, reference
        # `JoinIndexRanker.scala:40-55`) ONLY the coarser side is
        # re-bucketed through an Exchange to the finer count; the Exchange
        # uses THE hash identity, so its output co-partitions with the
        # other side's on-disk buckets.
        target = max(lspec.num_buckets, rspec.num_buckets)
        if lspec.num_buckets != target:
            left_phys = ExchangeExec(left_keys, target, left_phys)
        elif rspec.num_buckets != target:
            right_phys = ExchangeExec(right_keys, target, right_phys)
        # Hybrid-scan sides: re-bucket the appended (unbucketed) Union
        # children through THE hash Exchange so they co-partition with the
        # index layout.
        _bucketize_union_children(left_phys, left_keys, target)
        _bucketize_union_children(right_phys, right_keys, target)
        return SortMergeJoinExec(left_phys, right_phys, left_keys,
                                 right_keys, bucketed=True,
                                 num_buckets=target, how=plan.join_type,
                                 out_columns=out_columns, conf=conf)
    # Broadcast path: one side estimated small (dimension tables) — no
    # Exchange/Sort on EITHER side. Disable with
    # `spark.hyperspace.broadcast.threshold = -1` (the analog of the
    # reference E2E suite pinning autoBroadcastJoinThreshold to -1). The
    # probe side must keep ALL its rows, so outer joins only broadcast
    # their inner side.
    if threshold > 0:
        build = None
        if plan.join_type in ("inner", "left_outer"):
            est = _estimated_plan_bytes(plan.right, right_required)
            if est is not None and est <= threshold:
                build = "right"
        if build is None and plan.join_type in ("inner", "right_outer"):
            est = _estimated_plan_bytes(plan.left, left_required)
            if est is not None and est <= threshold:
                build = "left"
        if build is not None:
            return BroadcastHashJoinExec(left_phys, right_phys, left_keys,
                                         right_keys, build_side=build,
                                         how=plan.join_type,
                                         out_columns=out_columns)
    if membership:
        # Bare membership probe: Exchange/Sort wrappers would be pure
        # overhead.
        return SortMergeJoinExec(left_phys, right_phys, left_keys,
                                 right_keys, bucketed=False,
                                 how=plan.join_type)
    # General path: hash exchange + sort on each side (elided at
    # execution, see SortMergeJoinExec).
    num_partitions = max(lspec.num_buckets if lspec else 0,
                         rspec.num_buckets if rspec else 0, 200)
    left_sorted = SortExec(left_keys, ExchangeExec(
        left_keys, num_partitions, left_phys))
    right_sorted = SortExec(right_keys, ExchangeExec(
        right_keys, num_partitions, right_phys))
    return SortMergeJoinExec(left_sorted, right_sorted, left_keys,
                             right_keys, bucketed=False, how=plan.join_type,
                             out_columns=out_columns)
