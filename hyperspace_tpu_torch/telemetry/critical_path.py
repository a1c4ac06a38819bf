"""Per-query critical-path extraction: where did this query's wall GO.

The recorder (`telemetry/__init__.py`) captures every timed fact about
one execution — queue wait, batch gather, cache-fill waits, library
builds, device seconds, link transfers — as a flat counter bag. This module turns that bag into a
LATENCY ANATOMY: every completed query's wall is decomposed into a
CLOSED set of segments (the same set as the JAX package's, so the two
packages' decompositions compare key for key),

    queue_wait       admission-queue wait before execution started
    admission        admission bookkeeping around the queue wait
    batch_window     batched-execution lane: the leader's gather
                     window, or a member's whole wait on its cohort
    cache_fill_wait  blocked on ANOTHER thread's segment-cache fill
    compile          library builds (nvcc / g++) this query caused
    device_dispatch  device seconds of the instrumented entry points
                     (CUDA events; `telemetry/compilation.py`)
    link_h2d/link_d2h  host<->device transfer walls (`io/transfer.py`)
    host_python      the residual: host orchestration the other
                     segments cannot claim (decode, planning, python)

The first three are fed by the serving plane (`engine/scheduler.py`,
`engine/batcher.py`). The segments sum EXACTLY to the
measured query wall, because the residual is defined as wall minus the
attributed segments. The residual is SIGNED — a query whose device
work overlaps its link transfers can attribute more seconds than its
wall, and a negative `host_python` says precisely that (the positive
overlap is also reported as `overlap_s`).

Three surfaces:

- **per query**: `stamp(metrics)` (called by the scheduler at query
  finish) attaches the decomposition as `metrics.critical_path`, so flight-ring entries, slow-query dumps,
  and `to_dict()` trees carry their own anatomy;
- **windowed**: each stamped query feeds `critpath.<segment>.seconds`
  registry counters (plus `critpath.wall.seconds`); the timeseries
  sampler selects the `critpath.` family into its ring, and
  `window_shares()` derives the trailing-window share of each segment
  — what `/critpath` serves;
- **timeline**: `span_timeline(metrics)` lists the query's span
  records (parent links, one query id, every thread) and classifies
  each span into the same closed set.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from hyperspace_tpu_torch.telemetry import registry as _registry

__all__ = ["SEGMENTS", "SEGMENT_SOURCES", "decompose", "stamp",
           "window_shares", "span_timeline", "SUM_EXACT_EPSILON_S"]

# The closed segment set, in blocking order (queue first, residual
# last). Every decomposition has exactly these keys.
SEGMENTS = (
    "queue_wait",
    "admission",
    "batch_window",
    "cache_fill_wait",
    "compile",
    "device_dispatch",
    "link_h2d",
    "link_d2h",
    "host_python",
)

# Segment -> the per-query counter that feeds it (`metrics.counters`).
# `host_python` has no source counter: it is DEFINED as the residual.
SEGMENT_SOURCES: Dict[str, str] = {
    "queue_wait": "serve.queue_wait_s",
    "admission": "serve.admission_s",
    "batch_window": "serve.batch.window_s",
    "cache_fill_wait": "cache.fill_wait_s",
    "compile": "compile.seconds",
    "device_dispatch": "device.dispatch_s",
    "link_h2d": "link.h2d_s",
    "link_d2h": "link.d2h_s",
}

# Tracer span category/name -> segment, for the timeline view. Spans
# in no mapped category are host work by definition.
_SPAN_SEGMENTS = (
    ("compile", "compile"),
    ("link", None),            # direction decided by the span name
    ("cache", "cache_fill_wait"),
    ("serve.batch", "batch_window"),
    ("device_wait", "device_dispatch"),   # the host blocked on the card
)

# `link` spans that move data to the host: the d2h copies, and the
# result's conversion to Arrow that holds them.
_D2H_SPANS = ("d2h", "result:to_arrow")

# |sum(segments) - wall| tolerance: the residual makes the sum exact
# by construction, so only float rounding (segments are rounded to
# 1 µs for serialization) can open a gap.
SUM_EXACT_EPSILON_S = 1e-4


def decompose(metrics) -> Optional[dict]:
    """The closed-set decomposition of one FINISHED query's wall.
    Returns None for an unfinished recorder (no wall to decompose).

    The sum contract: `sum(segments.values()) == wall_s` to within
    float rounding, because `host_python` is wall minus the rest —
    negative when pool-thread overlap attributed more than the wall
    (the overlap is then also reported positively as `overlap_s`)."""
    wall = metrics.wall_s
    if wall is None:
        return None
    wall = round(float(wall), 6)
    segments: Dict[str, float] = {}
    for name, source in SEGMENT_SOURCES.items():
        segments[name] = round(
            max(float(metrics.counters.get(source, 0.0)), 0.0), 6)
    attributed = sum(segments.values())
    segments["host_python"] = round(wall - attributed, 6)
    dominant = max(SEGMENTS, key=lambda s: segments[s])
    return {
        "wall_s": wall,
        "segments": segments,
        "dominant": dominant,
        "overlap_s": round(max(attributed - wall, 0.0), 6),
        "sum_s": round(sum(segments.values()), 6),
    }


def stamp(metrics, publish: bool = True) -> Optional[dict]:
    """Decompose one finished query and attach the result as
    `metrics.critical_path` (rides `to_dict()`/`summary()`, the flight
    ring, and slow-query dumps). With `publish` (the default), each
    segment also feeds the process-wide `critpath.<segment>.seconds`
    counters — the sampler's raw material for windowed shares. The
    negative part of the residual never decrements a counter (counters
    are monotonic); it lands in `critpath.overlap.seconds` instead."""
    cp = decompose(metrics)
    if cp is None:
        return None
    metrics.critical_path = cp
    if publish:
        reg = _registry.get_registry()
        for name, seconds in cp["segments"].items():
            if seconds > 0:
                reg.counter(f"critpath.{name}.seconds").inc(seconds)
        if cp["overlap_s"] > 0:
            reg.counter("critpath.overlap.seconds").inc(cp["overlap_s"])
        reg.counter("critpath.wall.seconds").inc(cp["wall_s"])
        reg.counter("critpath.queries").inc()
    return cp


def window_shares(window_s: Optional[float] = None,
                  since_t: Optional[float] = None) -> dict:
    """Trailing-window segment shares from the sampler ring: for each
    segment, (windowed `critpath.<segment>.seconds` rate) / (windowed
    `critpath.wall.seconds` rate). Shares can sum slightly above 1.0
    when queries overlapped their own segments (`overlap` reports the
    windowed overlap share). Returns zeroed shares with `queries == 0`
    when the window saw no stamped queries — a caller can always
    render the shape."""
    from hyperspace_tpu_torch.telemetry import timeseries as _timeseries
    sampler = _timeseries.get_sampler()
    wall_rate = sampler.window_rate("critpath.wall.seconds",
                                    window_s=window_s, since_t=since_t)
    q_rate = sampler.window_rate("critpath.queries",
                                 window_s=window_s, since_t=since_t)
    out = {"queries_per_s": round(q_rate or 0.0, 4),
           "wall_seconds_per_s": round(wall_rate or 0.0, 6),
           "shares": {}, "dominant": None}
    reg = _registry.get_registry()
    for name in SEGMENTS:
        rate = sampler.window_rate(f"critpath.{name}.seconds",
                                   window_s=window_s,
                                   since_t=since_t) or 0.0
        share = (rate / wall_rate) if wall_rate else 0.0
        out["shares"][name] = round(share, 4)
        reg.gauge(f"window.critpath.{name}.share").set(round(share, 6))
    overlap_rate = sampler.window_rate("critpath.overlap.seconds",
                                       window_s=window_s,
                                       since_t=since_t) or 0.0
    out["overlap"] = round((overlap_rate / wall_rate)
                           if wall_rate else 0.0, 4)
    if wall_rate:
        out["dominant"] = max(SEGMENTS, key=lambda s: out["shares"][s])
    return out


def _classify_span(cat: str, name: str) -> Optional[str]:
    for prefix, segment in _SPAN_SEGMENTS:
        if cat == prefix or cat.startswith(prefix + "."):
            if segment is not None:
                return segment
            return ("link_d2h" if name.startswith(_D2H_SPANS)
                    else "link_h2d")
    return None


def _span_category(sp) -> str:
    """The trace category a span record classifies under: its layer,
    with the segment cache's and the batch lane's spans under the
    categories the classification reads."""
    if sp.name.startswith("serve.batch"):
        return "serve.batch"
    return {"segcache": "cache"}.get(sp.layer, sp.layer)


def span_timeline(metrics) -> Optional[dict]:
    """The span-DAG view of one FINISHED query: its span records
    (`metrics.spans`, every thread, one query id), classified into the
    closed segment set and ordered by start time — the blocking chain a
    dump viewer renders. Each carries its `span_id` and `parent_id`;
    unclassified spans are host work (`host_python`). None for an
    unfinished recorder. The counter-based `decompose` is the sum-exact
    source of truth; this is the visual companion."""
    if metrics.wall_s is None:
        return None
    t0 = metrics.root.start_ns
    spans: List[dict] = []
    for sp in sorted(metrics.spans, key=lambda sp: sp.start_ns):
        if sp is metrics.root or sp.end_ns is None:
            continue
        cat = _span_category(sp)
        segment = _classify_span(cat, sp.name)
        spans.append({
            "t_rel_s": round((sp.start_ns - t0) / 1e9, 6),
            "dur_s": round(sp.wall_s, 6),
            "name": sp.name,
            "cat": cat,
            "tid": sp.tid,
            "span_id": sp.span_id,
            "parent_id": sp.parent_id,
            "segment": segment or "host_python",
        })
    return {"wall_s": round(metrics.wall_s, 6), "spans": spans}
