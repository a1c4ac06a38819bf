"""Device-memory accountant + byte-aware cache instrumentation.

- **Device memory**: per-device live/peak bytes, sampled at every
  instrumented H2D/D2H link transfer. On a CUDA card the numbers come
  from the caching allocator (`torch.cuda.memory_stats(device)`:
  `allocated_bytes.all.current` and `.peak`); where no CUDA device is
  visible — the CPU tests — an accounting fallback sums the storages of
  the live torch tensors per device. Samples land as registry gauges
  (`memory.<dev>.bytes_in_use` / `.peak_bytes`), per-query peak
  watermarks on the active `QueryMetrics` (`peak_hbm_bytes` +
  per-device), and — when tracing — Chrome counter-track events, one
  track per device.

- **Caches**: every cache in the package reports
  `cache.<name>.{hits,misses,evictions}` counters and
  `cache.<name>.{bytes_held,entries}` gauges through the helpers here
  (the parquet read / host-batch / footer-count caches, the device
  segment cache, and fusion's promotion, broadcast-table and
  stage-program caches `fusion_promote`/`fusion_bcast`/`fusion_trace`),
  so cache thrash is a scrape-able series instead of a
  guess.

Sampling discipline: `maybe_sample()` is a no-op unless a per-query
recorder is active or tracing is enabled, and throttles to
`SAMPLE_MIN_INTERVAL_S` between allocator reads (`FALLBACK_MIN_INTERVAL_S`
between live-tensor walks) so sampling cannot dominate a tight loop;
`sample(force=True)` bypasses the throttle.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

from hyperspace_tpu_torch.telemetry import registry as _registry

__all__ = ["DeviceMemoryAccountant", "get_accountant", "maybe_sample",
           "sample", "snapshot", "artifact_section", "cache_hit",
           "cache_miss", "cache_eviction", "cache_stats"]

# Minimum seconds between throttled samples; the live-tensor fallback
# walks every object the garbage collector tracks (tens of ms in a large
# process), so its throttled samples are a second apart.
SAMPLE_MIN_INTERVAL_S = 0.01
FALLBACK_MIN_INTERVAL_S = 1.0


def _stats_sample() -> Optional[Dict[str, Tuple[int, int]]]:
    """{device: (bytes_in_use, peak_bytes)} from the CUDA caching
    allocator, or None when no CUDA device is visible."""
    import torch

    if not torch.cuda.is_available():
        return None
    out: Dict[str, Tuple[int, int]] = {}
    initialized = torch.cuda.is_initialized()
    for i in range(torch.cuda.device_count()):
        # The allocator's nested counters, read directly: this runs up to
        # every SAMPLE_MIN_INTERVAL_S under a query recorder, and
        # `torch.cuda.memory_stats` flattens every counter in Python
        # first, several times the cost of the read itself. Its values
        # are these (`allocated_bytes.all.current` / `.peak`); like it,
        # an uninitialized CUDA context reads as empty.
        st = (torch._C._cuda_memoryStats(i)["allocated_bytes"]["all"]
              if initialized else {})
        in_use = int(st.get("current", 0))
        out[f"cuda:{i}"] = (in_use, int(st.get("peak", in_use)))
    return out or None


# One walk at a time: the walk switches the collector off and back on,
# which two walks in turn would undo under each other.
_WALK_LOCK = threading.Lock()


def _live_tensors() -> list:
    """Every live tensor the collector tracks.

    `gc.get_objects()` also returns objects other threads are still
    building: a tuple that `tuple(<generator>)` fills and resizes in
    place is tracked from its first item, and while a walk holds a
    second reference to it the resize raises `SystemError`. So no list
    of every object may outlive the C call that made it. Per generation,
    ONE call (`list.extend`) asks for the generation twice — once for
    the objects, once for their types, which `itertools.compress` pairs
    up — keeps the tensors, and drains both asks, so both lists die
    inside that call (an undrained ask would keep its list alive, in the
    youngest generation even in a cycle with its own iterator). No
    bytecode, so no other thread, runs in between. With the collector
    off no collection moves objects between the two asks; the second
    ask of the youngest generation sees the same objects with the first
    list and its iterator behind them."""
    import gc
    import itertools

    import torch

    def ask(gen):
        return itertools.chain.from_iterable(map(gc.get_objects, (gen,)))

    is_tensor_type = torch.Tensor.__subclasscheck__
    never = itertools.repeat(False)
    tensors: list = []
    with _WALK_LOCK:
        enabled = gc.isenabled()
        gc.disable()
        try:
            for gen in range(3):
                objs = ask(gen)
                kinds = map(is_tensor_type, map(type, ask(gen)))
                tensors.extend(itertools.chain(
                    itertools.compress(objs, kinds),
                    itertools.compress(kinds, never)))
        finally:
            if enabled:
                gc.enable()
    return tensors


def _live_tensors_sample() -> Dict[str, Tuple[int, int]]:
    """Accounting fallback: the bytes of every live tensor storage per
    device, each storage counted once however many views share it. Peak
    is tracked by the accountant, not the walk."""
    seen = set()
    live: Dict[str, int] = {}
    for obj in _live_tensors():
        try:
            storage = obj.untyped_storage()
            key = (str(obj.device), storage.data_ptr())
            nbytes = int(storage.nbytes())
        except (RuntimeError, NotImplementedError):
            continue
        if key in seen:
            continue
        seen.add(key)
        live[key[0]] = live.get(key[0], 0) + nbytes
    return {label: (b, b) for label, b in live.items()}


class DeviceMemoryAccountant:
    """Tracks per-device live and peak bytes for the process, and
    attributes per-query peak watermarks to the active recorder."""

    def __init__(self):
        self._lock = threading.Lock()
        self._last_sample_t = 0.0
        self.live: Dict[str, int] = {}
        self.peak: Dict[str, int] = {}
        self.backend: Optional[str] = None  # "memory_stats"|"live_tensors"
        self.samples = 0

    def sample(self, force: bool = True) -> Optional[Dict[str, int]]:
        """Take one sample: update gauges, process peaks, the active
        recorder's watermarks, and (when tracing) the per-device counter
        tracks. Returns {device: bytes_in_use} or None when throttled."""
        now = time.monotonic()
        with self._lock:
            interval = (SAMPLE_MIN_INTERVAL_S
                        if self.backend != "live_tensors"
                        else FALLBACK_MIN_INTERVAL_S)
            if not force and now - self._last_sample_t < interval:
                return None
            self._last_sample_t = now
        per_dev = _stats_sample()
        if per_dev is not None:
            backend = "memory_stats"
        else:
            per_dev = _live_tensors_sample()
            backend = "live_tensors"
        reg = _registry.get_registry()
        live: Dict[str, int] = {}
        with self._lock:
            self.backend = backend
            self.samples += 1
            for dev, (in_use, dev_peak) in per_dev.items():
                self.live[dev] = in_use
                self.peak[dev] = max(self.peak.get(dev, 0), dev_peak,
                                     in_use)
                live[dev] = in_use
            peaks = dict(self.peak)
        for dev, in_use in live.items():
            reg.gauge(f"memory.{dev}.bytes_in_use").set(in_use)
            reg.gauge(f"memory.{dev}.peak_bytes").set(peaks[dev])
        from hyperspace_tpu_torch import telemetry
        rec = telemetry.current()
        if rec is not None:
            rec.observe_hbm(live)
        tracer = telemetry.tracer()
        if tracer is not None:
            for dev, in_use in live.items():
                tracer.counter(f"Memory {dev}", {"bytes_in_use": in_use})
        return live

    def maybe_sample(self) -> None:
        """Throttled sample, and only when someone is listening (active
        recorder or tracer)."""
        from hyperspace_tpu_torch import telemetry
        if telemetry.current() is None and telemetry.tracer() is None:
            return
        self.sample(force=False)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "backend": self.backend,
                "samples": self.samples,
                "devices": {dev: {"bytes_in_use": self.live.get(dev, 0),
                                  "peak_bytes": peak}
                            for dev, peak in sorted(self.peak.items())},
                "peak_hbm_bytes": sum(self.peak.values()),
            }


_ACCOUNTANT = DeviceMemoryAccountant()


def get_accountant() -> DeviceMemoryAccountant:
    """THE process-wide device-memory accountant."""
    return _ACCOUNTANT


def maybe_sample() -> None:
    _ACCOUNTANT.maybe_sample()


def sample(force: bool = True):
    return _ACCOUNTANT.sample(force=force)


def snapshot() -> dict:
    return _ACCOUNTANT.snapshot()


# ---------------------------------------------------------------------------
# Byte-aware cache instrumentation: one naming scheme for every cache.
# ---------------------------------------------------------------------------


def cache_hit(name: str, n: int = 1) -> None:
    _registry.get_registry().counter(f"cache.{name}.hits").inc(n)
    _query_cache_count(f"cache.{name}.hits", n)


def cache_miss(name: str, n: int = 1) -> None:
    _registry.get_registry().counter(f"cache.{name}.misses").inc(n)
    _query_cache_count(f"cache.{name}.misses", n)


def cache_eviction(name: str, n: int = 1) -> None:
    if n:
        _registry.get_registry().counter(f"cache.{name}.evictions").inc(n)
        _query_cache_count(f"cache.{name}.evictions", n)


def _query_cache_count(counter: str, n: int) -> None:
    """Mirror a cache event onto the active per-query recorder (no-op
    without one), so WHICH query thrashed a cache is attributable."""
    from hyperspace_tpu_torch import telemetry
    telemetry.add_count(counter, n)


def cache_stats(name: str, bytes_held: Optional[int],
                entries: Optional[int]) -> None:
    """Post-mutation residency gauges; pass None to leave one unset."""
    reg = _registry.get_registry()
    if bytes_held is not None:
        reg.gauge(f"cache.{name}.bytes_held").set(bytes_held)
    if entries is not None:
        reg.gauge(f"cache.{name}.entries").set(entries)


def artifact_section() -> dict:
    """The memory block a run report embeds: per-device peak bytes and
    the per-cache hit/miss/eviction/bytes-held series."""
    snap = _ACCOUNTANT.snapshot()
    reg = _registry.get_registry().to_dict()
    caches: Dict[str, dict] = {}
    for kind in ("counters", "gauges"):
        for name, value in reg[kind].items():
            parts = name.split(".", 2)
            # `cache.invalidations` counts sweeps across every cache: it
            # is no one cache's series.
            if parts[0] != "cache" or len(parts) < 3:
                continue
            caches.setdefault(parts[1], {})[parts[2]] = value
    # Every cache reports the full shape, zeros included, so consumers
    # diff like for like.
    for series in ("hits", "misses", "evictions"):
        for stats in caches.values():
            stats.setdefault(series, 0)
    snap["caches"] = caches
    return snap
