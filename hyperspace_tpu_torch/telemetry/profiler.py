"""Continuous host profiling + triggered device-trace capture.

Two instruments, one discipline (in-process, pull-based, opt-in):

**Sampling profiler** — a daemon thread walks every live thread's
stack (`sys._current_frames()`) at `telemetry.profiler.hz` and
aggregates host time by collapsed stack. Cheap enough to leave on in
production: sampling costs one frame walk per thread per tick, no tracing hooks, no interpreter callbacks. Exports
the two standard shapes — collapsed stacks (`module:function;... N`,
the flamegraph.pl / speedscope input) and nested flamegraph JSON
(d3-flame-graph) — plus by-module/by-function host-time tables,
all served by the `/profile` ops endpoint.

**Triggered device capture** — the ONE `torch.profiler` seam of the
package. `device_trace(path)` wraps `torch.profiler.profile` (CPU and
CUDA activity on a machine with a card, CPU activity only elsewhere)
under a process lock (torch allows one active profiler per process)
and exports Chrome trace-event JSON to `<path>/trace.json`; the
executor's `trace.dir` per-query capture routes through it.
`request_capture()` fires a BACKGROUND capture — used by the flight
recorder when a slowlog dump lands and by an alert incident — writing a
`profile-*` directory next to the slow-query dumps with the same
atomic-rename + keep-N pruning, rate-limited by
`telemetry.profiler.capture.min.interval.seconds` so a burn storm
cannot turn the profiler into the incident.

Nothing here starts unless asked: `configure(conf)` starts the
sampler only when `telemetry.profiler.enabled` is true, and triggered
capture only arms when `telemetry.profiler.capture.seconds` > 0.
"""

from __future__ import annotations

import logging
import os
import shutil
import sys
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from hyperspace_tpu_torch.telemetry import registry as _registry

__all__ = ["SamplingProfiler", "get_profiler", "configure",
           "device_trace", "request_capture", "maybe_capture_on_burn",
           "recent_captures", "profile_doc"]

logger = logging.getLogger(__name__)

DEFAULT_HZ = 19.0  # off the 10/100Hz grid: avoids aliasing periodic work

# How many frames of each stack to keep (leaf-most). Bounds the key
# space: a deep recursive planner stack collapses to its hot suffix.
MAX_STACK_DEPTH = 48


def _frame_key(frame) -> Optional[Tuple[str, ...]]:
    """Collapse one thread's stack to a root-first tuple of
    `module:function` labels. None for frames inside this module
    (the sampler never profiles itself)."""
    labels: List[str] = []
    depth = 0
    f = frame
    while f is not None and depth < MAX_STACK_DEPTH * 2:
        code = f.f_code
        mod = f.f_globals.get("__name__", "?")
        if mod == __name__:
            return None
        labels.append(f"{mod}:{code.co_name}")
        f = f.f_back
        depth += 1
    labels.reverse()
    return tuple(labels[-MAX_STACK_DEPTH:])


class SamplingProfiler:
    """The always-on host profiler: one daemon thread, one dict of
    collapsed stacks -> sample counts. `start()`/`stop()` are
    idempotent; `drain()` waits for the loop to exit; `reset()` clears
    the aggregate without stopping (an A/B comparison uses it)."""

    def __init__(self, hz: float = DEFAULT_HZ):
        self.hz = max(float(hz), 0.1)
        self._stacks: Dict[Tuple[str, ...], int] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.started_at: Optional[float] = None
        self.samples = 0  # thread-stack samples folded in (all threads)
        self.ticks = 0    # sampling-loop iterations

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> "SamplingProfiler":
        if self.running:
            return self
        self._stop.clear()
        self.started_at = time.time()
        self._thread = threading.Thread(target=self._loop,
                                        name="hs-profiler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def drain(self, timeout: float = 5.0) -> None:
        """Stop and wait for the sampling thread to exit."""
        self.stop()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=timeout)
        self._thread = None

    def reset(self) -> None:
        with self._lock:
            self._stacks.clear()
            self.samples = 0
            self.ticks = 0
        self.started_at = time.time()

    # -- the sampling loop ----------------------------------------------

    def _loop(self) -> None:
        reg = _registry.get_registry()
        interval = 1.0 / self.hz
        me = threading.get_ident()
        while not self._stop.wait(interval):
            t0 = time.perf_counter()
            try:
                frames = sys._current_frames()
            except Exception:
                continue
            batch: List[Tuple[str, ...]] = []
            for tid, frame in frames.items():
                if tid == me:
                    continue
                key = _frame_key(frame)
                if key:
                    batch.append(key)
            with self._lock:
                for key in batch:
                    self._stacks[key] = self._stacks.get(key, 0) + 1
                self.samples += len(batch)
                self.ticks += 1
            reg.counter("profiler.samples").inc(len(batch))
            reg.counter("profiler.sample.seconds").inc(
                time.perf_counter() - t0)

    # -- aggregation + export -------------------------------------------

    def snapshot(self) -> Dict[Tuple[str, ...], int]:
        with self._lock:
            return dict(self._stacks)

    def by_module(self, top: int = 25) -> List[dict]:
        """Host time by the LEAF frame's module — where threads
        actually were, attributed to one module each (self time)."""
        agg: Dict[str, int] = {}
        total = 0
        for stack, n in self.snapshot().items():
            mod = stack[-1].split(":", 1)[0]
            agg[mod] = agg.get(mod, 0) + n
            total += n
        return [{"module": m, "samples": n,
                 "share": round(n / total, 4) if total else 0.0}
                for m, n in sorted(agg.items(),
                                   key=lambda kv: -kv[1])[:top]]

    def by_function(self, top: int = 25) -> List[dict]:
        agg: Dict[str, int] = {}
        total = 0
        for stack, n in self.snapshot().items():
            agg[stack[-1]] = agg.get(stack[-1], 0) + n
            total += n
        return [{"function": fn, "samples": n,
                 "share": round(n / total, 4) if total else 0.0}
                for fn, n in sorted(agg.items(),
                                    key=lambda kv: -kv[1])[:top]]

    def collapsed(self) -> str:
        """Collapsed-stack text (`a;b;c N` per line) — the input
        format of flamegraph.pl and speedscope."""
        lines = [f"{';'.join(stack)} {n}"
                 for stack, n in sorted(self.snapshot().items())]
        return "\n".join(lines) + ("\n" if lines else "")

    def flamegraph(self) -> dict:
        """Nested d3-flame-graph JSON: each node
        `{name, value, children}` where value counts samples in the
        whole subtree."""
        root = {"name": "all", "value": 0, "children": {}}
        for stack, n in self.snapshot().items():
            root["value"] += n
            node = root
            for label in stack:
                child = node["children"].get(label)
                if child is None:
                    child = {"name": label, "value": 0, "children": {}}
                    node["children"][label] = child
                child["value"] += n
                node = child

        def listify(node: dict) -> dict:
            out = {"name": node["name"], "value": node["value"]}
            kids = [listify(c) for c in node["children"].values()]
            if kids:
                out["children"] = sorted(kids,
                                         key=lambda c: -c["value"])
            return out

        return listify(root)


# ---------------------------------------------------------------------------
# Process-wide sampler
# ---------------------------------------------------------------------------

_profiler: Optional[SamplingProfiler] = None
_profiler_lock = threading.Lock()


def get_profiler() -> Optional[SamplingProfiler]:
    """The process sampling profiler, or None when never enabled."""
    return _profiler


def start_profiler(hz: float = DEFAULT_HZ) -> SamplingProfiler:
    """Start (or return) THE process sampler. Starting while already
    running keeps the running rate (the sampler is process-wide);
    restarting a stopped sampler adopts the new rate, keeping the
    accumulated stacks (`reset()` clears them)."""
    global _profiler
    with _profiler_lock:
        if _profiler is not None and _profiler.running:
            return _profiler
        if _profiler is None:
            _profiler = SamplingProfiler(hz=hz)
        else:
            _profiler.hz = max(float(hz), 0.1)
        return _profiler.start()


def stop_profiler() -> None:
    with _profiler_lock:
        p = _profiler
    if p is not None:
        p.drain()


def configure(conf) -> Optional[SamplingProfiler]:
    """Session-init wiring (called from `ops_server.configure` next to
    the sampler): starts the host sampler when
    `telemetry.profiler.enabled` is set. Failures degrade to a warning
    — profiling must never be a startup failure."""
    try:
        if conf is None or not conf.profiler_enabled:
            return _profiler
        return start_profiler(hz=conf.profiler_hz)
    except Exception:
        logger.warning("sampling profiler failed to start",
                       exc_info=True)
        return None


# ---------------------------------------------------------------------------
# Device-trace capture: the one torch.profiler seam
# ---------------------------------------------------------------------------

# torch supports one active profiler per process; concurrent captures
# (per-query trace.dir + a triggered capture) serialize here rather
# than erroring inside torch.
_trace_lock = threading.Lock()

_capture_lock = threading.Lock()
_capture_pool = None
_last_capture_t: Optional[float] = None
_capture_seq = 0
_recent_captures: List[dict] = []

_CAPTURE_PREFIX = "profile-"

# The file a capture directory holds: Chrome trace-event JSON
# (chrome://tracing, ui.perfetto.dev).
TRACE_FILE = "trace.json"

# The `record_function` a capture opens on its own thread with
# `time.time_ns()` read inside it: the middle of its event ties the
# program's span clock to the profiler's (to half the event's length).
ALIGN_MARK = "hyperspace:align"


@contextmanager
def device_trace(path: str):
    """Capture a `torch.profiler` trace of the enclosed block into
    `path` (a directory; the trace is `<path>/trace.json`). With a CUDA
    card present the capture records CPU and CUDA activity — every
    kernel the block ran, by symbol, as a device event; without one,
    CPU activity only. THE one place the package touches
    `torch.profiler`; everything else routes through here so captures
    serialize under one lock. The caller synchronizes the card inside
    the block when it wants all of its device work in the capture.

    The exported trace also holds the program's spans of the capture's
    interval (`telemetry/spans.py`), every thread's, shifted onto the
    profiler's clock by the alignment mark: tracing is on for the
    capture (and left as it was after), and the capturing query's own
    spans, open ones included, are added from its recorder. Each keeps
    the native thread id the profiler gives that thread's own events."""
    import torch
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    from hyperspace_tpu_torch import telemetry
    from hyperspace_tpu_torch.telemetry import trace as _trace

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with _trace_lock:
        os.makedirs(path, exist_ok=True)
        owned = not _trace.tracing_enabled()
        _trace.enable_tracing()
        try:
            with profile(activities=activities) as prof:
                # The first mark pays the profiler's cold start; the
                # second, warm and short, ties the clocks.
                for _ in range(2):
                    with record_function(ALIGN_MARK):
                        mark_ns = time.time_ns()
                start_ns = time.time_ns()
                yield
                end_ns = time.time_ns()
            out = os.path.join(path, TRACE_FILE)
            prof.export_chrome_trace(out)
            rec = telemetry.current()
            _trace.merge_into_capture(out, ALIGN_MARK, mark_ns, start_ns,
                                      end_ns,
                                      rec.spans if rec is not None else ())
        finally:
            if owned:
                _trace.disable_tracing()


def recent_captures(n: int = 10) -> List[dict]:
    """The newest triggered captures ({path, reason, requested_at,
    state}), newest last. State moves queued -> done | error."""
    with _capture_lock:
        return [dict(c) for c in _recent_captures[-n:]]


def _capture_dir(conf) -> str:
    # Captures live next to the slow-query dumps — a dump and the
    # device profile it triggered prune and ship together.
    return conf.slowlog_dir


def request_capture(conf, reason: str = "manual") -> Optional[str]:
    """Fire a background device-trace capture of the next
    `telemetry.profiler.capture.seconds` of device activity. Returns
    the capture directory the trace will land in, or None when
    triggered capture is disabled (`capture.seconds` <= 0) or the
    rate limit (`capture.min.interval.seconds`) says not yet. Never
    blocks and never raises into the caller: the capture itself rides
    a one-thread background lane; errors are counted
    (`profiler.capture_errors`) and logged."""
    global _capture_pool, _last_capture_t, _capture_seq
    try:
        seconds = float(conf.profiler_capture_seconds)
    except Exception:
        return None
    if seconds <= 0:
        return None
    now = time.monotonic()
    with _capture_lock:
        if _last_capture_t is not None and \
                now - _last_capture_t < conf.profiler_capture_min_interval_s:
            return None
        _last_capture_t = now
        _capture_seq += 1
        seq = _capture_seq
        if _capture_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            _capture_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="hs-profiler-capture")
        pool = _capture_pool
    target = os.path.join(
        _capture_dir(conf),
        f"{_CAPTURE_PREFIX}{int(time.time() * 1000)}-"
        f"{os.getpid()}-{seq:06d}")
    entry = {"path": target, "reason": reason,
             "requested_at": round(time.time(), 3), "state": "queued"}
    with _capture_lock:
        _recent_captures.append(entry)
        del _recent_captures[:-32]
    keep = conf.profiler_capture_keep
    pool.submit(_run_capture, target, seconds, keep, entry)
    return target


def _run_capture(target: str, seconds: float, keep: int,
                 entry: dict) -> None:
    """The background capture job: trace into `<target>.tmp`, sleep
    out the window, atomically rename, prune. A reader never sees a
    half-written capture directory."""
    reg = _registry.get_registry()
    tmp = target + ".tmp"
    try:
        os.makedirs(os.path.dirname(target), exist_ok=True)
        with device_trace(tmp):
            time.sleep(seconds)
        os.replace(tmp, target)
        _prune_captures(os.path.dirname(target), keep)
        reg.counter("profiler.captures").inc()
        with _capture_lock:
            entry["state"] = "done"
        logger.warning("device profile (%s) captured to %s",
                       entry.get("reason"), target)
    except Exception:
        reg.counter("profiler.capture_errors").inc()
        with _capture_lock:
            entry["state"] = "error"
        shutil.rmtree(tmp, ignore_errors=True)
        logger.warning("triggered device capture failed", exc_info=True)


def _prune_captures(capture_dir: str, keep: int) -> None:
    def order(fname: str):
        try:
            return (os.path.getmtime(os.path.join(capture_dir, fname)),
                    fname)
        except OSError:
            return (0.0, fname)

    try:
        caps = sorted((f for f in os.listdir(capture_dir)
                       if f.startswith(_CAPTURE_PREFIX)
                       and not f.endswith(".tmp")), key=order)
    except OSError:
        return
    for stale in caps[:max(len(caps) - max(keep, 1), 0)]:
        shutil.rmtree(os.path.join(capture_dir, stale),
                      ignore_errors=True)


def maybe_capture_on_burn(conf, burn_rate: float) -> Optional[str]:
    """The SLO hook: when the sliding-window burn rate crosses 1.0
    (eating error budget faster than earning it), grab a device profile
    of the incident while it is still happening. The rate limit in
    `request_capture` makes a sustained burn produce a trickle of
    captures, not a flood. The scheduler calls it at query finish
    (`engine/scheduler.py`)."""
    if burn_rate is None or burn_rate <= 1.0:
        return None
    return request_capture(conf, reason=f"slo-burn:{burn_rate:.2f}")


def profile_doc() -> dict:
    """The `/profile` JSON payload: sampler state + host-time tables +
    flamegraph + recent triggered captures. Renders a useful shape
    even with the sampler off (enabled=false, captures still listed)."""
    p = get_profiler()
    doc: dict = {"enabled": p is not None and p.running,
                 "captures": recent_captures()}
    if p is not None:
        doc.update({
            "hz": p.hz,
            "started_at": p.started_at,
            "samples": p.samples,
            "ticks": p.ticks,
            "by_module": p.by_module(),
            "by_function": p.by_function(),
            "flamegraph": p.flamegraph(),
        })
    return doc


def _atexit_stop() -> None:
    global _capture_pool
    try:
        stop_profiler()
    except Exception:
        pass
    with _capture_lock:
        pool, _capture_pool = _capture_pool, None
    if pool is not None:
        try:
            pool.shutdown(wait=True)
        except Exception:
            pass


import atexit  # noqa: E402

atexit.register(_atexit_stop)
