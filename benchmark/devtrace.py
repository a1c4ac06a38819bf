"""The device's timeline from `torch.profiler`, reduced to what the
per-layer metrics and the breakdown read.

A capture runs the profiler (CPU and CUDA activities) over a stretch of
the run and exports its Chrome trace. The device intervals are its
kernel, memcpy and memset events. The benchmark's own spans are kept on
the host clock (`time.time_ns`); a `record_function` marker opened on
the capturing thread ties that clock to the trace's, so each span can be
placed on the device's timeline.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, List, Optional, Tuple

DEVICE_CATEGORIES = {"kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset"}
ALIGN_MARK = "bench:align"

Interval = Tuple[float, float]                 # (start_us, end_us)
Span = Tuple[str, float, float]                # (name, start_us, end_us)


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of intervals as sorted, disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def length(intervals: Iterable[Interval]) -> float:
    return sum(e - s for s, e in intervals)


@dataclass
class Trace:
    """One capture: its stretch [t0_us, t1_us), the device's events and the
    benchmark's spans, all on the trace's clock."""
    t0_us: float
    t1_us: float
    device: List[Span] = field(default_factory=list)
    spans: List[Span] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.t1_us - self.t0_us) / 1e6

    def busy(self, match: Optional[Callable[[str], bool]] = None
             ) -> List[Interval]:
        return merge(clip(((s, e) for n, s, e in self.device
                           if match is None or match(n)),
                          self.t0_us, self.t1_us))

    @property
    def busy_s(self) -> float:
        return length(self.busy()) / 1e6

    def top_ops(self, k: int = 10) -> List[list]:
        total: dict = {}
        for n, s, e in self.device:
            for cs, ce in clip([(s, e)], self.t0_us, self.t1_us):
                total[n] = total.get(n, 0.0) + (ce - cs) / 1e6
        return [[n, v] for n, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:k]]

    def open_spans(self, t_us: float) -> str:
        names = sorted({n for n, s, e in self.spans if s <= t_us < e})
        return "+".join(names) if names else "no span open"

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The k longest stretches in which no device operation ran, each
        named by the benchmark's spans open at its middle."""
        edges = [self.t0_us]
        for s, e in self.busy():
            edges.extend((s, e))
        edges.append(self.t1_us)
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[f"{self.open_spans((s + e) / 2)} "
                 f"@{(s - self.t0_us) / 1e6:.3f}s", (e - s) / 1e6]
                for s, e in gaps[:k]]

    def within(self, span: Span) -> List[Span]:
        _, s0, e0 = span
        return [(n, s, e) for n, s, e in self.device if s >= s0 and e <= e0]


class Capture:
    """`start()` ... `stop()` around a stretch, then `export()`; `trace(spans)`
    reads it."""

    def __init__(self, path: str):
        self.path = path
        self._prof = None
        self._mark_ns: Optional[int] = None
        self._t0_ns = self._t1_ns = 0

    def start(self) -> None:
        from torch.autograd.profiler import record_function
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        with record_function(ALIGN_MARK):
            self._mark_ns = time.time_ns()
        self._t0_ns = time.time_ns()

    def begin_stretch(self) -> None:
        """Start the stretch the trace reads here rather than at `start`,
        leaving out the profiler's own first moments."""
        self._t0_ns = time.time_ns()

    def stop(self) -> None:
        self._t1_ns = time.time_ns()
        self._prof.stop()

    def export(self) -> None:
        """Write the trace; kept apart from `stop` so that a capture of the
        window writes nothing while the clients still run."""
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        self._prof = None

    def trace(self, spans: Iterable[Tuple[str, int, int]]) -> Trace:
        """The capture's events; `spans` are (name, start_ns, end_ns) on
        the host clock."""
        with open(self.path) as f:
            events = json.load(f).get("traceEvents", [])
        offset_us = None
        device: List[Span] = []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = str(ev.get("cat", "")).lower()
            if cat in DEVICE_CATEGORIES:
                s = float(ev["ts"])
                device.append((ev.get("name", "?"), s, s + float(ev.get("dur", 0))))
            elif cat == "user_annotation" and ev.get("name") == ALIGN_MARK:
                offset_us = float(ev["ts"]) - self._mark_ns / 1e3
        if offset_us is None:
            raise RuntimeError("the profiler's trace lacks the alignment mark")

        def host(ns: int) -> float:
            return ns / 1e3 + offset_us
        return Trace(t0_us=host(self._t0_ns), t1_us=host(self._t1_ns),
                     device=device,
                     spans=[(n, host(s), host(e)) for n, s, e in spans])
