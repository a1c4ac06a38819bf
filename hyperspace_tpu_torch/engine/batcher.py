"""Inter-query batched execution: coalesce concurrent same-shape
point/filter queries into ONE batched predicate evaluation.

The segment cache dedupes the FILL (single-flight segment fills: K
concurrent queries over one cold bucket trigger one decode+H2D); this
module dedupes the EXECUTION. The `QueryScheduler` sees every in-flight plan,
so when K concurrent queries share an *execution signature* — same scan
identity (root paths + pinned index version + explicit-file restriction),
same scanned columns, same predicate SHAPE with only the literals free,
same projection — they collapse into one shared scan read plus one
`serve.batch` call through the device seam (`parallel/
spmd.batched_predicate_masks`, whose only caller is this module) that
evaluates all K predicates as stacked constant lanes and returns a
[K, N] mask matrix. The matrix stays where the scan's columns live —
on the card for a device-lane read — and each member's rows are sliced
out there (`nonzero` + one gather per member) and settled
individually: per-query deadlines, per-query `QueryMetrics` (a
`serve: batched` event with the cohort size), and the degradation /
breaker path are all preserved — a batch-lane failure falls back to
per-query execution (`serve.batch.fallbacks`), never fails the cohort,
and a cancelled member drops only its own slice.

Mechanics:

- **gather window**: the first query of a signature becomes the
  cohort LEADER and waits `spark.hyperspace.serve.batch.window.ms` for
  joiners (up to `serve.batch.max`). The window is skipped entirely
  when nothing else is in flight — serial latency is untouched — and a
  leader that gathers nobody falls back to the normal path
  (`serve.batch.solo`), so the lane only ever runs with a real cohort.
- **bucketed cohorts**: predicate constants ride [K_b, T] lanes with
  K_b the next power of two (padding replicates the first member's
  constants), so cohort size is a fixed bucket, not a new shape per K.
  The shared scan deliberately skips per-member bucket pruning: a
  signature's read shape (full scan N) stays stable across cohorts,
  which is what makes the warm-start (below) and the segment cache's
  version-keyed residency line up. (A solo point query on a bucketed
  index reads one bucket; its batched run reads them all.)
- **snapshot-pin safety**: the signature includes the scan's pinned
  index version and explicit file list, so two plans over different
  committed versions can NEVER share a cohort (a concurrent refresher
  splits the groups; each cohort reads exactly its pinned bytes).
- **warm-start**: the first time a signature is seen (and via the
  explicit `warmup(df)` API), the canonical cohort-size buckets are
  primed through `telemetry.compilation.aot_warmup` — keyed like the
  segment cache by (index root, version, shape, rows, bucket). Eager
  torch compiles nothing here: a warmup is one real dispatch of the
  batched program per bucket, which warms the caching allocator and
  the device seam for that shape.

Series: `serve.batch.{invocations,members,window_wait_s,fallbacks,
solo}`, plus `compile.aot.*` and the segment cache's
`cache.segments.shared.*` (one read serving K members).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch import telemetry
from hyperspace_tpu_torch.plan import expr as E
from hyperspace_tpu_torch.plan.nodes import Filter, Project, Scan

__all__ = ["QueryBatcher", "BatchSignature", "plan_signature",
           "get_batcher", "set_batcher", "reset_batcher", "warmup"]

# Member wait quantum: short enough that a cancelled member notices its
# deadline promptly, long enough not to spin (the scheduler's queue-wait
# discipline).
_WAIT_QUANTUM_S = 0.02

# Adaptive gather backoff (see QueryBatcher._solo_streak): empty
# gathers before a signature's window is skipped, and how often a
# skipped signature re-probes.
_SOLO_STREAK = 2
_SOLO_PROBE = 8

_CMP_OPS = {E.EqualTo: "eq", E.NotEqualTo: "ne", E.LessThan: "lt",
            E.LessThanOrEqual: "le", E.GreaterThan: "gt",
            E.GreaterThanOrEqual: "ge"}
_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le",
         "eq": "eq", "ne": "ne"}
_INT_DTYPES = ("int8", "int16", "int32", "int64", "date32", "timestamp")
_FLOAT_DTYPES = ("float32", "float64")


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


class BatchSignature:
    """One query's parsed batchable form. `key` is the grouping
    identity (queries batch iff their keys are equal); the constant
    vectors are this MEMBER's literals in shape order. String literals
    cannot ride the lanes directly — their code-space translation is
    per-dictionary state — so `strs` records (int-lane slot, column,
    op, value) resolutions the leader performs against the SHARED
    scan's dictionary at gather time; the resolved codes then ride the
    int lanes like any other constant."""

    __slots__ = ("key", "scan", "shape", "columns", "projection",
                 "needed", "ints", "floats", "strs")

    def __init__(self, key, scan, shape, columns, projection, needed,
                 ints, floats, strs=()):
        self.key = key
        self.scan = scan
        self.shape = shape            # static term tuple (spmd contract)
        self.columns = columns        # referenced column names, shape order
        self.projection = projection  # output column names, output order
        self.needed = needed          # columns the shared scan must read
        self.ints = ints              # this member's int-lane constants
        self.floats = floats          # this member's float-lane constants
        self.strs = strs              # deferred string resolutions


def _parse_terms(condition, schema):
    """Conjunction -> (shape, cols, ints, floats, strs) or None when any
    term falls outside the batched lane's exactly-mirrored subset (see
    `parallel/spmd.batched_predicate_masks`). String comparisons and
    string IN lists qualify: their constants ride the INT lanes as
    dictionary codes, resolved per member at gather time (`strs` —
    the dictionary is shared-scan state, so the translation mirrors the
    solo compiler's code-space tests exactly)."""
    cols: List[str] = []
    index: Dict[str, int] = {}

    def col_idx(name: str) -> int:
        f = schema.field(name)
        i = index.get(f.name)
        if i is None:
            i = index[f.name] = len(cols)
            cols.append(f.name)
        return i

    shape: List[tuple] = []
    ints: List[int] = []
    floats: List[float] = []
    strs: List[tuple] = []
    for term in E.split_conjunctive(condition):
        if type(term) in _CMP_OPS:
            op = _CMP_OPS[type(term)]
            left, right = term.left, term.right
            if isinstance(left, E.Literal) and isinstance(right, E.Column):
                left, right = right, left
                op = _FLIP[op]
            if not (isinstance(left, E.Column)
                    and isinstance(right, E.Literal)):
                return None
            if not schema.contains(left.name):
                return None
            dtype = schema.field(left.name).dtype
            v = right.value
            if type(v) is int and abs(v) < 2 ** 63 \
                    and dtype in _INT_DTYPES + _FLOAT_DTYPES:
                shape.append(("cmp", op, col_idx(left.name), "i"))
                ints.append(int(v))
            elif type(v) is float and dtype in _INT_DTYPES + _FLOAT_DTYPES:
                shape.append(("cmp", op, col_idx(left.name), "f"))
                floats.append(float(v))
            elif type(v) is str and dtype == "string":
                # Code-space translation deferred to gather time: the
                # resolved code occupies this int-lane slot.
                ci = col_idx(left.name)
                shape.append(("cmp", op, ci, "i"))
                strs.append(("cmp", len(ints), ci, op, v))
                ints.append(0)
            else:
                return None
        elif isinstance(term, E.In):
            # Mirror the solo engine's fast paths exactly: integer
            # column with an all-int literal list (one vectorized isin),
            # or string column with an all-string list (OR-fold of
            # code-space equalities — identical definite-truth mask).
            if not isinstance(term.child, E.Column) or not term.values:
                return None
            if not schema.contains(term.child.name):
                return None
            dtype = schema.field(term.child.name).dtype
            if dtype in _INT_DTYPES:
                vals = [v.value for v in term.values
                        if isinstance(v, E.Literal)
                        and type(v.value) is int]
                if len(vals) != len(term.values):
                    return None
                padded = _pow2(len(vals))
                shape.append(("in", col_idx(term.child.name), padded))
                # Padding repeats the last value — harmless for
                # membership.
                ints.extend(vals + [vals[-1]] * (padded - len(vals)))
            elif dtype == "string":
                svals = [v.value for v in term.values
                         if isinstance(v, E.Literal)
                         and type(v.value) is str]
                if len(svals) != len(term.values):
                    return None
                ci = col_idx(term.child.name)
                padded = _pow2(len(svals))
                shape.append(("in", ci, padded))
                strs.append(("in", len(ints), ci, padded, tuple(svals)))
                ints.extend([0] * padded)
            else:
                return None
        elif isinstance(term, (E.IsNull, E.IsNotNull)):
            if not isinstance(term.child, E.Column) \
                    or not schema.contains(term.child.name):
                return None
            kind = "isnull" if isinstance(term, E.IsNull) else "notnull"
            shape.append((kind, col_idx(term.child.name)))
        else:
            return None
    if not shape:
        return None
    return tuple(shape), tuple(cols), ints, floats, tuple(strs)


def plan_signature(plan, session_key) -> Optional[BatchSignature]:
    """The plan's batch signature, or None when its shape does not
    qualify: exactly `[Project(simple)] <- Filter <- Scan`, with every
    predicate term in the mirrored subset — numeric comparisons,
    int/string IN lists, null-ness, and string comparisons (constants
    resolved to dictionary codes per member at gather time)."""
    node = plan
    projection: Optional[Tuple[str, ...]] = None
    if isinstance(node, Project):
        if not node.is_simple():
            return None
        projection = tuple(node.columns)
        node = node.child
    if not isinstance(node, Filter):
        return None
    condition = node.condition
    node = node.child
    if not isinstance(node, Scan):
        return None
    scan = node
    parsed = _parse_terms(condition, scan.schema)
    if parsed is None:
        return None
    shape, cols, ints, floats, strs = parsed
    if projection is None:
        projection = tuple(scan.schema.names)
    else:
        projection = tuple(scan.schema.field(c).name for c in projection)
    wanted = set(projection) | set(cols)
    needed = tuple(n for n in scan.schema.names if n in wanted)
    files_tag = (tuple(scan.files()) if scan._explicit_files else None)
    key = (session_key, tuple(scan.root_paths), scan.pinned_version,
           scan.index_name, files_tag, shape, cols, projection, needed)
    return BatchSignature(key, scan, shape, cols, projection, needed,
                          ints, floats, strs)


# ---------------------------------------------------------------------------
# Cohorts
# ---------------------------------------------------------------------------

_WAITING, _DONE, _FAILED, _ABANDONED = range(4)


class _Member:
    __slots__ = ("sig", "deadline", "state", "result", "cohort_size",
                 "cohort_id", "tenant", "cohort_tenants")

    def __init__(self, sig: BatchSignature, deadline):
        self.sig = sig
        self.deadline = deadline
        self.state = _WAITING
        self.result = None
        self.cohort_size = 0
        self.cohort_id: Optional[str] = None
        # The member's serving tenant, captured on its OWN thread at
        # join time. Chargeback is leader-pays: `_execute` runs on the
        # leader's thread under the leader's tenant scope, so the whole
        # cohort's device dispatch bills the leader's tenant — the
        # exactness contract (per-tenant sums == global counters) holds
        # because every charge lands on exactly one tenant. The cohort
        # report records every member tenant so the subsidy is visible.
        self.tenant: str = telemetry.current_tenant()
        self.cohort_tenants: tuple = ()


class _Cohort:
    __slots__ = ("key", "members", "gathering", "ready")

    def __init__(self, key):
        self.key = key
        self.members: List[_Member] = []
        self.gathering = True
        # Early close: set by a joiner that observed every in-flight
        # query already inside this cohort — nobody else CAN join, so
        # the leader stops burning the rest of its gather window (a
        # closed loop would otherwise sleep whole windows with all its
        # clients parked in the cohort).
        self.ready = False


class QueryBatcher:
    """Process-wide batching lane (module docstring). Owns NO threads:
    the leader executes on its own caller thread, members wait on
    theirs — same discipline as the scheduler."""

    def __init__(self):
        self._cv = threading.Condition()
        self._cohorts: Dict[tuple, _Cohort] = {}
        # Convoy pipeline: the cohort currently EXECUTING per signature.
        # While one runs, the next cohort of the same signature gathers
        # — the predecessor's execution is the natural gather window, so
        # sustained same-shape traffic batches continuously without
        # sleeping out timers (the fixed window only pays off the FIRST
        # cohort of a burst).
        self._running: Dict[tuple, _Cohort] = {}
        # Adaptive gather: consecutive EMPTY gathers per signature.
        # After _SOLO_STREAK of them the lane stops paying the window
        # for that signature (a parked closed-loop client is lost
        # throughput), re-probing every _SOLO_PROBE-th candidate so a
        # traffic shift re-enables batching within a few queries.
        self._solo_streak: Dict[tuple, int] = {}
        self._warmed: set = set()
        # Cohort ids: one per batched invocation, stamped on every
        # member's QueryMetrics (`metrics.cohort`) so the flight ring
        # can group a cohort's members post-hoc.
        self._cohort_ids = itertools.count(1)

    # -- entry point (called by QueryScheduler.collect) -------------------

    def try_collect(self, df, plan, metrics, conf, deadline, scheduler):
        """Execute `plan` through the batched lane, or return None when
        the caller should run the normal per-query path (ineligible
        shape, nothing to coalesce with, or batch-lane failure — the
        fallback contract). Typed serving errors (this query's own
        deadline/cancel) propagate."""
        if scheduler.pressure()["inflight"] <= 1:
            # Nothing else in flight: no cohort can be gathering (its
            # leader would be in flight), so skip parsing the plan.
            return None
        session = df.session
        sig = plan_signature(plan, id(session) if session is not None
                             else 0)
        if sig is None:
            return None
        if sig.scan.index_name:
            # A not-closed breaker means the per-query resilient path
            # (short-circuit / probe bookkeeping) must see this query.
            root = sig.scan.root_paths[0] if sig.scan.root_paths else ""
            if scheduler.breakers.state(
                    f"{sig.scan.index_name}@{root}") != "closed":
                return None
        me = _Member(sig, deadline)
        max_members = max(2, conf.serve_batch_max)
        with self._cv:
            cohort = self._cohorts.get(sig.key)
            if cohort is not None and cohort.gathering \
                    and len(cohort.members) < max_members:
                cohort.members.append(me)
                if len(cohort.members) >= max_members or \
                        scheduler.pressure()["inflight"] \
                        <= len(cohort.members):
                    # Full, or every in-flight query is already HERE:
                    # wake the leader instead of letting the whole
                    # system sleep out the window.
                    cohort.ready = True
                    self._cv.notify_all()
                leader = False
            else:
                if scheduler.pressure()["inflight"] <= 1:
                    return None  # nothing to coalesce with: skip the lane
                streak = self._solo_streak.get(sig.key, 0)
                if streak >= _SOLO_STREAK and self._running.get(
                        sig.key) is None:
                    # This signature keeps gathering nobody: don't park
                    # another client in an empty window; probe again
                    # every _SOLO_PROBE-th candidate.
                    self._solo_streak[sig.key] = streak + 1
                    if (streak - _SOLO_STREAK) % _SOLO_PROBE:
                        return None
                cohort = _Cohort(sig.key)
                cohort.members.append(me)
                self._cohorts[sig.key] = cohort
                leader = True
        if leader:
            return self._lead(cohort, me, conf, max_members)
        return self._follow(me)

    # -- leader ------------------------------------------------------------

    def _lead(self, cohort: _Cohort, me: _Member, conf,
              max_members: int):
        reg = telemetry.get_registry()
        window_s = max(0.0, conf.serve_batch_window_ms) / 1000.0
        t0 = time.perf_counter()
        sig_key = cohort.key
        members: List[_Member] = [me]
        try:
            with self._cv:
                end = time.monotonic() + window_s
                # Convoy bound: while a predecessor cohort of this
                # signature is executing, keep gathering past the
                # window (its completion wakes us) — bounded so one
                # slow batch can never park its successors forever.
                hard_end = time.monotonic() + max(0.1, window_s * 25)
                while cohort.gathering and not cohort.ready \
                        and len(cohort.members) < max_members:
                    me.deadline.check("batch")
                    now = time.monotonic()
                    soft = (hard_end
                            if self._running.get(cohort.key) is not None
                            else end)
                    left = soft - now
                    if left <= 0:
                        break
                    self._cv.wait(timeout=min(left, _WAIT_QUANTUM_S))
                cohort.gathering = False
                if self._cohorts.get(cohort.key) is cohort:
                    del self._cohorts[cohort.key]
                members = list(cohort.members)
                self._running[cohort.key] = cohort
            gather_s = time.perf_counter() - t0
            reg.histogram("serve.batch.window_wait_s").observe(gather_s)
            # Critical-path source: the leader's gather window is wall
            # this query spent collecting its cohort
            # (`telemetry/critical_path.py` classifies it
            # `batch_window`).
            telemetry.add_seconds("serve.batch.window_s", gather_s)
            live = [m for m in members
                    if m.state == _WAITING and m is not me]
            if not live:
                reg.counter("serve.batch.solo").inc()
                with self._cv:
                    self._solo_streak[sig_key] = \
                        self._solo_streak.get(sig_key, 0) + 1
                return None  # no cohort formed: the normal path wins
            with self._cv:
                self._solo_streak.pop(sig_key, None)
            me.deadline.check("batch")
            results = self._execute(me.sig, [me] + live, conf)
        except BaseException as exc:
            self._fail(cohort, me)
            if isinstance(exc, Exception) \
                    and not _is_serving_error(exc):
                # Ordinary batch-lane failure: the LEADER falls back to
                # per-query execution too (never fails the cohort).
                reg.counter("serve.batch.fallbacks").inc()
                telemetry.event("serve", "batch_fallback",
                                reason=repr(exc))
                return None
            raise  # the leader's own typed cancel, or an injected crash
        finally:
            with self._cv:
                cohort.gathering = False
                if self._cohorts.get(cohort.key) is cohort:
                    del self._cohorts[cohort.key]
                if self._running.get(cohort.key) is cohort:
                    del self._running[cohort.key]
                self._cv.notify_all()  # wake the successor's leader
        cohort_id = f"c-{next(self._cohort_ids)}"
        cohort_tenants = tuple(sorted({m.tenant for m in results}))
        with self._cv:
            for m, out in results.items():
                if m.state == _WAITING:
                    m.result = out
                    m.cohort_size = len(results)
                    m.cohort_id = cohort_id
                    m.cohort_tenants = cohort_tenants
                    m.state = _DONE
            # Anyone not sliced (joined too late to matter): fall back.
            for m in members:
                if m.state == _WAITING and m not in results:
                    m.state = _FAILED
            self._cv.notify_all()
        telemetry.event("serve", "batched", cohort=len(results),
                        cohort_id=cohort_id, leader=True)
        telemetry.add_count("serve.batch.member")
        rec = telemetry.current()
        if rec is not None:
            rec.cohort = {"id": cohort_id, "size": len(results),
                          "leader": True,
                          "tenants": list(cohort_tenants),
                          "tenant_pays": me.tenant}
        return results[me]

    def _fail(self, cohort: _Cohort, me: _Member) -> None:
        # Read the member list UNDER the lock — the leader may be
        # failing out of the gather loop itself (its own deadline),
        # where any local snapshot predates late joiners; missing one
        # would leave it waiting forever.
        with self._cv:
            cohort.gathering = False
            for m in cohort.members:
                if m is not me and m.state == _WAITING:
                    m.state = _FAILED
            self._cv.notify_all()

    # -- member ------------------------------------------------------------

    def _follow(self, me: _Member):
        reg = telemetry.get_registry()
        # The member's side of the handoff is a REAL operator record:
        # its metric tree shows where the query's wall went (waiting on
        # the cohort) and how many rows its slice produced, so the
        # flight ring / differ treat batched queries like any other.
        rec = telemetry.current()
        op = rec.start_operator("BatchedQuery") if rec is not None \
            else None
        t_wait0 = time.perf_counter()
        try:
            with telemetry.span("serve.batch.member", "serving"):
                with self._cv:
                    while me.state == _WAITING:
                        try:
                            me.deadline.check("batch")
                        except BaseException:
                            # A cancelled member drops its slice —
                            # never the batch: the leader skips
                            # non-waiting members when it settles.
                            me.state = _ABANDONED
                            self._cv.notify_all()
                            raise
                        self._cv.wait(timeout=_WAIT_QUANTUM_S)
        except BaseException as exc:
            telemetry.add_seconds("serve.batch.window_s",
                                  time.perf_counter() - t_wait0)
            if op is not None:
                rec.finish_operator(op, error=repr(exc))
            raise
        # Critical-path source: a member's whole blocked-on-cohort wait
        # — gather window AND the shared execution — is classified
        # `batch_window` (the member can't tell the phases apart, and
        # from its side the distinction doesn't matter: it was parked).
        telemetry.add_seconds("serve.batch.window_s",
                              time.perf_counter() - t_wait0)
        if me.state == _DONE:
            if op is not None:
                op.detail["cohort"] = me.cohort_size
                rec.finish_operator(op, rows_out=me.result.num_rows)
            telemetry.event("serve", "batched", cohort=me.cohort_size,
                            cohort_id=me.cohort_id, leader=False)
            telemetry.add_count("serve.batch.member")
            if rec is not None:
                rec.cohort = {"id": me.cohort_id,
                              "size": me.cohort_size, "leader": False,
                              "tenants": list(me.cohort_tenants)}
            return me.result
        # Batch lane failed for this cohort: per-query fallback.
        if op is not None:
            rec.finish_operator(op, error="batch-lane fallback")
        reg.counter("serve.batch.fallbacks").inc()
        telemetry.event("serve", "batch_fallback", reason="cohort")
        return None

    # -- the batched execution ---------------------------------------------

    def _execute(self, sig: BatchSignature, live: List[_Member], conf):
        """ONE shared scan + ONE stacked-predicate evaluation + per-member
        slices. Runs on the leader's thread under the leader's recorder
        and deadline (its operator records and checkpoints fire here).
        The [K_b, N] mask stays on the scan's device: each member's
        `nonzero` and gather run there, so no mask crosses to the host
        on the device lane. Returns {member: ColumnBatch}."""
        from hyperspace_tpu_torch.engine.physical import ScanExec
        from hyperspace_tpu_torch.parallel import spmd
        from hyperspace_tpu_torch.utils import faults

        faults.fire("batch.execute")
        reg = telemetry.get_registry()
        K = len(live)
        with telemetry.span("serve.batch", "serving", members=K):
            scan_exec = ScanExec(sig.scan, list(sig.needed), conf=conf,
                                 shared_members=K)
            batch = scan_exec.execute()
            self._maybe_warm(sig, batch, conf)
            Kb = _pow2(K)
            iconst, fconst = _constant_lanes(
                [_resolve_string_constants(m.sig, batch)
                 for m in live],
                [m.sig.floats for m in live], Kb)
            datas = tuple(batch.column(c).data for c in sig.columns)
            valids = tuple(batch.column(c).validity
                           for c in sig.columns)
            masks = spmd.batched_predicate_masks(
                sig.shape, datas, valids, iconst, fconst)
            reg.counter("serve.batch.invocations").inc()
            reg.counter("serve.batch.members").inc(K)
            results: Dict[_Member, object] = {}
            host = batch.is_host
            if host:
                masks = masks.numpy()
            for k, m in enumerate(live):
                if m.state != _WAITING:
                    continue  # cancelled while the batch ran: drop slice
                if host:
                    idx = np.nonzero(masks[k])[0].astype(np.int32)
                else:
                    idx = torch.nonzero(masks[k]).squeeze(1)
                results[m] = batch.take(idx).select(
                    list(m.sig.projection))
            return results

    # -- AOT warm-start -----------------------------------------------------

    def _buckets(self, conf) -> List[int]:
        top = _pow2(max(2, conf.serve_batch_max))
        out, b = [], 2
        while b <= top:
            out.append(b)
            b <<= 1
        return out

    def _warm_key(self, sig: BatchSignature, n_rows: int):
        return (tuple(sig.scan.root_paths), sig.scan.pinned_version,
                sig.shape, n_rows)

    def _maybe_warm(self, sig: BatchSignature, batch, conf) -> None:
        """Index-open priming: the first time this signature executes,
        dispatch EVERY canonical cohort bucket for its shape once (zero
        arrays of the real columns' dtypes/validity presence, on the
        batch's device), so later cohorts of any size run warm."""
        if not conf.serve_batch_aot_warmup:
            return
        key0 = self._warm_key(sig, batch.num_rows)
        with self._cv:
            if key0 in self._warmed:
                return
            self._warmed.add(key0)
        dtypes = [_torch_dtype(batch.column(c).data.dtype)
                  for c in sig.columns]
        flags = [batch.column(c).validity is not None
                 for c in sig.columns]
        device = batch.device or torch.device("cpu")
        self._warm(sig, batch.num_rows, dtypes, flags, conf, device)

    def _warm(self, sig: BatchSignature, n_rows: int, dtypes, flags,
              conf, device, buckets: Optional[List[int]] = None) -> int:
        from hyperspace_tpu_torch.telemetry import compilation

        ti = sum(1 if t[0] == "cmp" and t[3] == "i" else
                 t[2] if t[0] == "in" else 0 for t in sig.shape)
        tf = sum(1 for t in sig.shape
                 if t[0] == "cmp" and t[3] == "f")
        ran = 0
        for kb in (buckets or self._buckets(conf)):
            def args(kb=kb):
                datas = [torch.zeros(n_rows, dtype=dt, device=device)
                         for dt in dtypes]
                valids = [torch.zeros(n_rows, dtype=torch.bool,
                                      device=device) if f else None
                          for f in flags]
                return (sig.shape, datas, valids,
                        np.zeros((kb, ti), dtype=np.int64),
                        np.zeros((kb, tf), dtype=np.float64))

            key = self._warm_key(sig, n_rows) + (
                kb, tuple(str(d) for d in dtypes), tuple(flags),
                str(device))
            if compilation.aot_warmup(key, _warm_masks, args):
                ran += 1
        return ran


def _warm_masks(*args):
    """The warmup body: one real dispatch of the batched program,
    waited for (the card runs it asynchronously)."""
    from hyperspace_tpu_torch.parallel import spmd

    out = spmd.batched_predicate_masks(*args)
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    return out


def _torch_dtype(dtype) -> "torch.dtype":
    """The torch dtype of a column payload's dtype (numpy or torch)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


def _string_code_constant(d, op: str, value: str) -> int:
    """One string literal -> one int-lane constant, mirroring the solo
    compiler's code-space tests (`_string_literal_compare`) as a plain
    integer comparison over codes: eq/ne use the value's code when
    present else -1 (no code equals -1, so eq is all-false and ne
    all-true — the absent-value semantics); lt/ge use the left
    insertion point, le/gt `right - 1` (`x <= right-1` == `x < right`
    on integer codes)."""
    left = int(np.searchsorted(d, value, side="left"))
    right = int(np.searchsorted(d, value, side="right"))
    if op in ("eq", "ne"):
        return left if left < right else -1
    if op in ("lt", "ge"):
        return left
    return right - 1  # le, gt


def _resolve_string_constants(sig: BatchSignature, batch):
    """This member's int-lane constants with every deferred string term
    translated against the SHARED scan's sorted dictionary (per-member,
    at gather time — counted as `spmd.strings.dict_lookups`)."""
    if not sig.strs:
        return sig.ints
    ints = list(sig.ints)
    lookups = 0
    for term in sig.strs:
        d = batch.column(sig.columns[term[2]]).dictionary
        if term[0] == "cmp":
            _kind, slot, _ci, op, value = term
            ints[slot] = _string_code_constant(d, op, value)
            lookups += 1
        else:  # ("in", start, ci, padded, values)
            _kind, start, _ci, padded, values = term
            codes = [_string_code_constant(d, "eq", v) for v in values]
            codes = codes + [codes[-1]] * (padded - len(codes))
            ints[start:start + padded] = codes
            lookups += len(values)
    telemetry.get_registry().counter(
        "spmd.strings.dict_lookups").inc(lookups)
    return ints


def _constant_lanes(ints: List[List[int]], floats: List[List[float]],
                    Kb: int):
    """[Kb, T] padded constant lanes; padding rows replicate member 0
    (any valid constants do — padded masks are never sliced)."""
    ti, tf = len(ints[0]), len(floats[0])
    iconst = np.zeros((Kb, ti), dtype=np.int64)
    fconst = np.zeros((Kb, tf), dtype=np.float64)
    for k in range(Kb):
        src = k if k < len(ints) else 0
        if ti:
            iconst[k] = ints[src]
        if tf:
            fconst[k] = floats[src]
    return iconst, fconst


def _is_serving_error(exc) -> bool:
    from hyperspace_tpu_torch.exceptions import QueryServingError
    return isinstance(exc, QueryServingError)


# ---------------------------------------------------------------------------
# Replica warm-start API
# ---------------------------------------------------------------------------


def warmup(df, cohort_sizes: Optional[List[int]] = None) -> int:
    """Warm the batched predicate program for this DataFrame's plan
    signature across the canonical cohort-size buckets, at index-open
    time: one real dispatch per bucket on the lane the signature's scan
    takes (the session's device at or above `execution.min.device.rows`
    rows, else the CPU), so the first real cohort finds the allocator
    and the seam warm. Eager torch builds no executable, so this counts
    `compile.aot.warmups` and no `compile.traces`. Returns how many
    buckets were dispatched (0 = plan not batchable, empty scan, or
    already warm). Assumes null-free referenced columns."""
    from hyperspace_tpu_torch.io import parquet
    from hyperspace_tpu_torch.io.columnar import HOST_NP_DTYPES

    session = df.session
    conf = session.conf if session is not None else None
    if conf is None or not conf.serve_batch_enabled:
        return 0
    plan = session.optimize(df.plan)
    sig = plan_signature(plan, id(session))
    if sig is None:
        return 0
    files = sig.scan.files()
    n_rows = int(sum(parquet.file_row_counts(files))) if files else 0
    if n_rows <= 0:
        return 0
    dtypes = [_torch_dtype(np.dtype(
        HOST_NP_DTYPES[sig.scan.schema.field(c).dtype]))
        for c in sig.columns]
    flags = [False] * len(sig.columns)
    device = (session.device if n_rows >= conf.min_device_rows
              else torch.device("cpu"))
    return get_batcher()._warm(sig, n_rows, dtypes, flags, conf, device,
                               buckets=cohort_sizes)


# ---------------------------------------------------------------------------
# Process-wide batcher
# ---------------------------------------------------------------------------

_batcher: Optional[QueryBatcher] = None
_batcher_lock = threading.Lock()


def get_batcher() -> QueryBatcher:
    global _batcher
    if _batcher is None:
        with _batcher_lock:
            if _batcher is None:
                _batcher = QueryBatcher()
    return _batcher


def set_batcher(batcher: QueryBatcher) -> QueryBatcher:
    """Install a specific batcher (tests: fresh cohorts/warm memo)."""
    global _batcher
    _batcher = batcher
    return batcher


def reset_batcher() -> None:
    global _batcher
    _batcher = None
