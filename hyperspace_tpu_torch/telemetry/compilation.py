"""The compile and launch seam: library builds and device calls of the
port's entry points, counted under the JAX package's names.

The JAX package routes every jitted entry point through
`instrumented_jit`, which counts XLA traces (`compile.*`) and charges
each warm dispatch's wall and XLA-modeled cost (`device.*`). Eager torch
has no trace, so the port's seam has two halves:

- **builds** — `record_build(name, seconds, cause)` is the port's
  "trace": the first-use build of a library (`ops/cuda/build.py` runs
  nvcc for `sm_90a`; `native/` runs g++). It counts `compile.traces`,
  `compile.seconds` and `compile.<name>.traces`, emits a `[compile]
  trace` decision event (`retrace` when a changed source forced the
  rebuild; the cause names the file) and a `compile <name>` span. A load
  from an already-built library is a `compile.cache_hits`
  (`record_cache_hit`). `configure_persistent_cache(conf)` points
  `spark.hyperspace.compile.cache.dir` at the directory the libraries
  are built into and loaded from.
- **device calls** — `instrumented_device(name, fn, cost=...)` wraps
  one entry point that runs on the device. Each call counts a dispatch
  (`device.dispatches`), charges its device seconds to
  `device.dispatch_s` (per query), `device.dispatch.seconds`
  (process-wide) and the active tenant, and charges the modeled
  `device.flops` / `device.bytes_accessed` of its cost function (the
  counterpart of XLA's `cost_analysis`, which torch has not got).

Device seconds on a CUDA tensor come from a pair of
`torch.cuda.Event(enable_timing=True)` (pooled) recorded on the current
stream around the call while a query recorder is active: the span of
stream time from the call's first queued work to its last. The seam
never synchronizes per call and charges nothing per call: the calls
queue on the recorder and are charged once, in `QueryMetrics.finish()`
(`resolve_query`). A call on a card with no recorder active (an index
build, a direct call) records no events — two records cost more host
time than a small kernel runs — and counts its dispatch and modeled
cost only, in batches (`resolve_pending`; the artifact digests and
`/metrics` call it first). On a CPU tensor the call is timed with
`perf_counter` — the CPU runs it synchronously, so its wall is its
device time — and charged at once.

The seam catches nothing: a call that raises, or a build that fails,
raises through it unchanged.
"""

from __future__ import annotations

import functools
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional, Tuple

from hyperspace_tpu_torch.telemetry import registry as _registry

__all__ = ["instrumented_device", "record_build", "record_cache_hit",
           "REGISTRY", "entry_point_costs", "configure_persistent_cache",
           "persistent_cache_dir", "resolve_query", "resolve_pending",
           "aot_warmup", "reset_aot_memo"]

# name -> instrumented wrapper.
REGISTRY: Dict[str, object] = {}

# name -> (flops, bytes_accessed) of the entry point's last call.
_costs: Dict[str, Tuple[float, float]] = {}
_costs_lock = threading.Lock()

# Calls on a card made with no query recorder active, oldest first:
# (name, None, tenant, cost), charged in batches of `_RESOLVE_BATCH`.
_pending: deque = deque()
_pending_lock = threading.Lock()
_RESOLVE_BATCH = 64

# Timing event pairs free for reuse.
_free_events: list = []

_tls = threading.local()

_persistent_dir: Optional[str] = None
_persistent_lock = threading.Lock()


def entry_point_costs() -> Dict[str, Tuple[float, float]]:
    """{entry point name: (flops, bytes_accessed)} of each instrumented
    entry point's last call."""
    with _costs_lock:
        return dict(_costs)


# ---------------------------------------------------------------------------
# Builds
# ---------------------------------------------------------------------------


def persistent_cache_dir() -> Optional[str]:
    """The configured build directory, or None (the package default)."""
    return _persistent_dir


def configure_persistent_cache(conf) -> bool:
    """Point `spark.hyperspace.compile.cache.dir` at the directory the
    nvcc and g++ builds are written to and loaded from (called at
    session init). Libraries are named by their source's content hash,
    so a fresh process pointed at a directory that already holds them
    loads them (`compile.cache_hits`) instead of building. Unset keeps
    the package's `_build/`. Returns True iff a directory is configured.
    Counted as `compile.persistent_cache.configured`."""
    global _persistent_dir
    path = conf.compile_cache_dir if conf is not None else None
    if not path:
        return _persistent_dir is not None
    with _persistent_lock:
        if _persistent_dir == path:
            return True
        from hyperspace_tpu_torch import native
        from hyperspace_tpu_torch.ops.cuda import build
        build.BUILD_DIR = str(path)
        native.BUILD_DIR = str(path)
        _persistent_dir = str(path)
        _registry.get_registry().counter(
            "compile.persistent_cache.configured").inc()
        return True


def record_build(name: str, seconds: float,
                 cause: str = "first build") -> None:
    """Count one library build (`name`, e.g. "hash_buckets"): registry
    and per-query `compile.*` counters, a `[compile] trace` event
    (`retrace` for any other cause than a first build), and a `compile
    <name>` span when tracing."""
    from hyperspace_tpu_torch import telemetry

    reg = _registry.get_registry()
    reg.counter("compile.traces").inc()
    reg.counter("compile.seconds").inc(seconds)
    reg.counter(f"compile.{name}.traces").inc()
    telemetry.memory.cache_miss("build")
    telemetry.add_count("compile.traces")
    telemetry.add_seconds("compile.seconds", seconds)
    telemetry.event("compile",
                    "trace" if cause == "first build" else "retrace",
                    target=name, cause=cause, seconds=round(seconds, 4))
    tracer = telemetry.tracer()
    if tracer is not None:
        end_ns = time.time_ns()
        tracer.complete(f"compile {name}", "compile",
                        end_ns - int(seconds * 1e9), end_ns,
                        args={"target": name, "cause": cause})


def record_cache_hit(name: str) -> None:
    """Count one load of an already-built library."""
    from hyperspace_tpu_torch import telemetry

    _registry.get_registry().counter("compile.cache_hits").inc()
    _registry.get_registry().counter(f"compile.{name}.cache_hits").inc()
    telemetry.memory.cache_hit("build")
    telemetry.add_count("compile.cache_hits")


def build_cause(build_dir: str, prefix: str, source: str) -> str:
    """Why a library is being built: "first build" when `build_dir`
    holds no library of that name, else "source changed: <source>" —
    an older build of the same library (another content hash) is
    there, so its source or flags changed."""
    try:
        older = [f for f in os.listdir(build_dir)
                 if f.startswith(prefix) and f.endswith(".so")]
    except OSError:
        older = []
    return f"source changed: {source}" if older else "first build"


# ---------------------------------------------------------------------------
# Device calls
# ---------------------------------------------------------------------------


def _tensor_device(args):
    """The device of the first tensor among `args` (one level into
    lists and tuples, and a batch's `.device`), or None."""
    import torch

    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
        if isinstance(a, (list, tuple)):
            for b in a:
                if isinstance(b, torch.Tensor):
                    return b.device
        dev = getattr(a, "device", None)
        if isinstance(dev, torch.device):
            return dev
    return None


def _event_pair():
    """A (start, end) pair of timing events, reused once its last call
    was charged (creating CUDA events per call costs host time)."""
    try:
        return _free_events.pop()
    except IndexError:
        import torch
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))


def _settle(calls, rec) -> None:
    """Charge a batch of finished calls, each (name, timing, tenant,
    cost): timing is seconds, an event pair, or None for an untimed
    call; cost is (flops, bytes) or None. One counter update per series:
    device seconds, dispatches and modeled cost, to the process, to each
    call's tenant and, with `rec`, to that query (which also gets each
    entry point's own seconds as `device.<name>.dispatch_s`).
    An event pair is waited for, read and returned to the pool."""
    from hyperspace_tpu_torch import telemetry

    seconds: Dict[str, float] = {}
    named_seconds: Dict[str, float] = {}
    costs: Dict[Tuple[str, str], list] = {}
    dispatches: Dict[str, int] = {}
    for name, timing, tenant, cost in calls:
        if isinstance(timing, tuple):
            start, end = timing
            end.synchronize()
            timing = start.elapsed_time(end) / 1e3
            _free_events.append((start, end))
        if timing is not None:
            seconds[tenant] = seconds.get(tenant, 0.0) + timing
            named_seconds[name] = named_seconds.get(name, 0.0) + timing
        dispatches[name] = dispatches.get(name, 0) + 1
        if cost is not None:
            acc = costs.setdefault((name, tenant), [0.0, 0.0])
            acc[0] += float(cost[0])
            acc[1] += float(cost[1])
            with _costs_lock:
                _costs[name] = (float(cost[0]), float(cost[1]))
    reg = _registry.get_registry()
    for tenant, sec in seconds.items():
        reg.counter("device.dispatch.seconds").inc(sec)
        telemetry.charge_tenant("device.dispatch.seconds", sec,
                                tenant=tenant)
    reg.counter("device.dispatches").inc(sum(dispatches.values()))
    for name, n in dispatches.items():
        reg.counter(f"device.{name}.dispatches").inc(n)
    for (name, tenant), (flops, nbytes) in costs.items():
        reg.counter("device.flops").inc(flops)
        reg.counter("device.bytes_accessed").inc(nbytes)
        telemetry.charge_tenant("device.flops", flops, tenant=tenant)
        telemetry.charge_tenant("device.bytes_accessed", nbytes,
                                tenant=tenant)
    if rec is None:
        return
    rec.add_seconds("device.dispatch_s", sum(seconds.values()))
    rec.add_count("device.dispatches", sum(dispatches.values()))
    for name, n in dispatches.items():
        rec.add_count(f"device.{name}.dispatches", n)
    for name, sec in named_seconds.items():
        rec.add_seconds(f"device.{name}.dispatch_s", sec)
    for (name, _tenant), (flops, nbytes) in costs.items():
        rec.add_seconds("device.flops", flops)
        rec.add_seconds("device.bytes_accessed", nbytes)
        rec.add_seconds(f"device.{name}.bytes_accessed", nbytes)


def resolve_query(rec) -> None:
    """Charge the calls queued on query recorder `rec` (its `finish()`
    calls this): one wait on the device for the query's last recorded
    work, then the seconds and costs to the query, the process and the
    tenants."""
    calls, rec._device_events = rec._device_events, []
    if calls:
        _settle(calls, rec)


def resolve_pending() -> None:
    """Charge the process counters for the calls made on a card with no
    query recorder active (their dispatches and modeled cost)."""
    with _pending_lock:
        calls = list(_pending)
        _pending.clear()
    if calls:
        _settle(calls, None)


# Warm-start keys already primed this process (one per (index root,
# version, predicate shape, rows, cohort bucket, dtypes, device) for the
# batched serve lane). The memo makes priming idempotent — a server
# warming on every index open never re-pays an executed warmup.
_aot_keys: set = set()
_aot_lock = threading.Lock()


def reset_aot_memo() -> None:
    """Forget which warmup keys ran (tests simulating a fresh
    process)."""
    with _aot_lock:
        _aot_keys.clear()


def aot_warmup(key: tuple, fn, args_fn) -> bool:
    """Prime an entry point for one canonical shape, once per `key`:
    call `fn(*args_fn())` now — at index-open time — instead of inside
    the first serving query. The JAX package's counterpart makes jax
    trace and compile the program here; eager torch has no program to
    compile, so the call is one real dispatch of the entry point on
    dummy arguments: it warms the CUDA caching allocator for the
    shape's [K, N] outputs and the device seam's timing events, and
    compiles nothing (it counts no `compile.traces`). Returns True iff
    the warmup ran (False: memo hit, or the attempt failed — warm-start
    is an optimization, never a failure). Counted under the JAX
    package's names as `compile.aot.{warmups,memo_hits,errors}`."""
    with _aot_lock:
        if key in _aot_keys:
            _registry.get_registry().counter("compile.aot.memo_hits").inc()
            return False
        _aot_keys.add(key)
    try:
        fn(*args_fn())
        _registry.get_registry().counter("compile.aot.warmups").inc()
        return True
    except Exception:
        import logging
        logging.getLogger(__name__).warning(
            "warmup failed for %r (serving proceeds; the first query of "
            "this shape runs cold)", key, exc_info=True)
        _registry.get_registry().counter("compile.aot.errors").inc()
        return False


def instrumented_device(name: str, fn: Optional[Callable] = None, *,
                        cost: Optional[Callable] = None):
    """Wrap `fn`, an entry point that runs on the device, in the seam
    (module docstring). `cost(*args, **kwargs)` returns the call's
    modeled (flops, bytes_accessed) from its arguments' shapes, without
    touching the device. Usable as `instrumented_device(name, fn,
    cost=...)` or as a decorator factory. A call made inside another
    instrumented call on the same thread runs unwrapped, so nested
    entry points are charged once. The per-call work on a card is a
    queue append (and two event records under a recorder); every
    counter is charged when the call is resolved."""
    if fn is None:
        return lambda f: instrumented_device(name, f, cost=cost)

    @functools.wraps(fn)
    def call(*args, **kwargs):
        if getattr(_tls, "active", False):
            return fn(*args, **kwargs)
        from hyperspace_tpu_torch import telemetry

        rec = telemetry.current()
        tenant = telemetry.current_tenant()
        device = _tensor_device(args)
        _tls.active = True
        try:
            if device is not None and device.type == "cuda":
                if rec is None:
                    out = fn(*args, **kwargs)
                    timing = None
                else:
                    import torch

                    stream = torch.cuda.current_stream(device)
                    timing = _event_pair()
                    timing[0].record(stream)
                    out = fn(*args, **kwargs)
                    timing[1].record(stream)
            else:
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                timing = time.perf_counter() - t0
        finally:
            _tls.active = False
        entry = (name, timing, tenant,
                 cost(*args, **kwargs) if cost is not None else None)
        if isinstance(timing, tuple):
            rec._device_events.append(entry)
        elif timing is not None:
            _settle([entry], rec)
        else:
            with _pending_lock:
                _pending.append(entry)
                due = len(_pending) >= _RESOLVE_BATCH
            if due:
                resolve_pending()
        return out

    call.__device_instrumented__ = True
    REGISTRY[name] = call
    return call
