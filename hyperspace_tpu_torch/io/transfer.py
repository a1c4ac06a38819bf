"""Pipelined host<->device transfer engine — THE link seam.

Every Scan that lands on the device, every string-dictionary hash and
every build's key staging crosses the host<->device link here. The
engine keeps it a streaming recipe, not a blocking copy:

- **chunked, double-buffered staging**: large host arrays ship as
  byte-budgeted row chunks; chunk i+1 is converted (dtype cast / copy)
  on a staging thread into a REUSED pinned host buffer while chunk i's
  copy is in flight, under a bounded in-flight byte window so a wide
  table can't balloon pinned host memory;
- **async multi-column placement**: `put_group` decodes columns on the
  staging pool and issues every column's copies before anything
  blocks, so Arrow decode overlaps the link for the whole batch
  (`io/columnar.from_arrow`'s device path);
- **one observable link**: every transfer lands in the
  `link.{h2d,d2h}.{bytes,seconds,chunks}` counters plus the
  `transfer.overlap_saved_seconds` estimate (serial sum of stage walls
  minus pipelined wall) — the overlap is measured, not assumed.

On a CUDA device each chunk is copied from a pinned staging buffer
(`torch.empty(..., pin_memory=True)`) with `non_blocking=True` on a side
stream of that device; a CUDA event recorded after the copy gates both
the reuse of the staging buffer and the consumer: the caller's current
stream waits on the event, and the destination records that stream
(`record_stream`) so the caching allocator never hands its memory out
early. On the CPU the same code runs with synchronous copies, and
staging reuse is off: a CPU "device" tensor may alias the host buffer it
came from (`torch.from_numpy`), so rewriting a reused buffer would
corrupt it.

Knobs (session conf, `TransferEngine.configure` / `transfer.configure`):
`spark.hyperspace.io.transfer.chunk.bytes` (chunk granularity),
`...inflight.bytes` (in-flight byte window), `...threads` (staging pool
width), `...acquire.timeout.ms` (bound on a window wait). The engine is
process-wide (`get_engine()`); sessions sharing a process should agree
on the knobs, same caveat as the parquet cache budgets.
"""

from __future__ import annotations

import logging
import threading
import time
import warnings
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from hyperspace_tpu_torch import constants

__all__ = ["TransferEngine", "HostCast", "Host", "get_engine",
           "set_engine", "reset_engine", "configure",
           "TransferAcquireTimeoutError", "shutdown"]

logger = logging.getLogger(__name__)


class TransferAcquireTimeoutError(TimeoutError):
    """Waiting for in-flight-window headroom exceeded
    `spark.hyperspace.io.transfer.acquire.timeout.ms`. A copy that never
    completes would otherwise block every later caller FOREVER on a
    window that can never drain. Counted as
    `io.transfer.acquire_timeouts`."""


# Staging below this size skips the buffer pool: the copy-into-buffer
# bookkeeping costs more than the fresh allocation it avoids.
_STAGING_MIN_BYTES = 1 << 16

# Upper bound on D2H chunking (`d2h_chunk_count`): a few concurrent
# copies keep the link busy while the host consumes earlier chunks.
_MAX_D2H_CHUNKS = 8


class HostCast:
    """A deferred host-side conversion: `src` cast to `dtype` lazily,
    chunk by chunk, into a reused staging buffer at put time — instead
    of a fresh full-size `astype` materialisation per column."""

    __slots__ = ("src", "dtype")

    def __init__(self, src: np.ndarray, dtype):
        self.src = np.asarray(src)
        self.dtype = np.dtype(dtype)

    @property
    def shape(self):
        return self.src.shape

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.src.shape, dtype=np.int64)) \
            * self.dtype.itemsize


class Host:
    """Marker for `put_group` payload values that must STAY host-resident
    (string dictionaries); the engine passes `value` through unplaced."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


class _Staging:
    """One reusable host staging buffer: a pinned uint8 tensor on CUDA
    (a plain one for fake links) and its numpy view."""

    __slots__ = ("tensor", "array")

    def __init__(self, nbytes: int, pinned: bool):
        self.tensor = torch.empty(nbytes, dtype=torch.uint8,
                                  pin_memory=pinned)
        self.array = self.tensor.numpy()

    @property
    def nbytes(self) -> int:
        return self.array.nbytes


class _CudaDone:
    """Completion handle of one CUDA copy: the event recorded after it."""

    __slots__ = ("event",)

    def __init__(self, event):
        self.event = event

    def is_ready(self) -> bool:
        return self.event.query()

    def block_until_ready(self):
        self.event.synchronize()
        return self


class _WindowEntry:
    __slots__ = ("done", "nbytes", "buf")

    def __init__(self, done, nbytes: int, buf):
        self.done = done
        self.nbytes = nbytes
        self.buf = buf


def _block_ready(done) -> None:
    fn = getattr(done, "block_until_ready", None)
    if fn is not None:
        fn()


def _source_tensor(arr: np.ndarray) -> torch.Tensor:
    """A torch view of a host array for a copy that only reads it
    (read-only Arrow-owned arrays included)."""
    arr = np.ascontiguousarray(arr)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(arr)


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


class TransferEngine:
    """Process-wide pipelined host<->device transfer engine. See module
    docstring; `put_fn` is the test seam for a fake link (signature
    `(host_array, device) -> fake device array`, whose
    `block_until_ready()` waits for the copy and `np.asarray()` reads
    it back)."""

    def __init__(self, chunk_bytes: Optional[int] = None,
                 inflight_bytes: Optional[int] = None,
                 threads: Optional[int] = None,
                 put_fn: Optional[Callable] = None,
                 acquire_timeout_s: Optional[float] = None):
        self.chunk_bytes = int(
            chunk_bytes or constants.IO_TRANSFER_CHUNK_BYTES_DEFAULT)
        self.inflight_bytes = int(
            inflight_bytes or constants.IO_TRANSFER_INFLIGHT_BYTES_DEFAULT)
        self.threads = int(threads or constants.IO_TRANSFER_THREADS_DEFAULT)
        self.acquire_timeout_s = (
            acquire_timeout_s if acquire_timeout_s is not None
            else constants.IO_TRANSFER_ACQUIRE_TIMEOUT_MS_DEFAULT / 1000.0)
        self._put_fn = put_fn
        self._lock = threading.RLock()
        self._pool = None
        # Side streams per CUDA device index: H2D copies and D2H
        # prefetches each get their own, off the compute stream.
        self._h2d_streams: Dict[int, object] = {}
        self._d2h_streams: Dict[int, object] = {}
        # In-flight window: copies issued but not known complete. Shared
        # across calls so concurrent callers honor ONE byte budget.
        self._window: deque = deque()
        self._window_bytes = 0
        # Staging buffer pool: [_Staging, gate|None]. A gated buffer's
        # last copy may still be in flight; acquisition waits on the gate
        # before reuse.
        self._staging_free: List[list] = []
        self.stats: Dict[str, int] = {
            "puts": 0, "chunks": 0, "groups": 0,
            "staging_allocated": 0, "staging_reused": 0,
            "window_waits": 0,
        }

    # -- configuration ----------------------------------------------------

    def configure(self, conf) -> None:
        """Refresh the knobs from a session conf (process-wide engine;
        co-resident sessions should agree)."""
        if conf is None:
            return
        self.chunk_bytes = max(1, conf.io_transfer_chunk_bytes)
        self.inflight_bytes = max(self.chunk_bytes,
                                  conf.io_transfer_inflight_bytes)
        self.threads = max(1, conf.io_transfer_threads)
        self.acquire_timeout_s = conf.io_transfer_acquire_timeout_ms / 1000.0

    def _staging_pool(self):
        if self._pool is None:
            with self._lock:
                if self._pool is None:
                    from concurrent.futures import ThreadPoolExecutor
                    self._pool = ThreadPoolExecutor(
                        max_workers=max(1, self.threads),
                        thread_name_prefix="hs-transfer")
        return self._pool

    def _stream(self, streams: dict, device: torch.device):
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        with self._lock:
            stream = streams.get(index)
            if stream is None:
                stream = torch.cuda.Stream(device=index)
                streams[index] = stream
        return stream

    # -- the raw copy -----------------------------------------------------

    def _raw_put(self, view: np.ndarray, device, staging=None, out=None):
        """ONE guarded host->device copy of `view` (or of its staging
        buffer): fault-injectable at the `transfer.put` seam and
        transiently retried (a retried attempt re-copies the same host
        view into the same destination, so chunk order cannot be
        corrupted). Returns (device array, completion handle or None
        when the copy already completed). `out`, when given, is the
        destination."""
        from hyperspace_tpu_torch.utils import faults, retry

        def attempt():
            faults.fire("transfer.put")
            return self._copy(view, device, staging, out)

        return retry.call(attempt, operation="transfer.put")

    def _copy(self, view: np.ndarray, device, staging, out):
        if self._put_fn is not None:
            dev = self._put_fn(view, device)
            return dev, dev
        device = torch.device(device)
        if staging is not None:
            src = staging.tensor[:view.nbytes].view(
                _torch_dtype(view.dtype)).reshape(view.shape)
        else:
            src = _source_tensor(view)
        if device.type != "cuda":
            if out is not None:
                out.copy_(src)
                return out, None
            if staging is None and view.flags.writeable:
                return src, None  # CPU: the host array IS the tensor
            return src.clone(), None
        stream = self._stream(self._h2d_streams, device)
        consumer = torch.cuda.current_stream(device)
        with torch.cuda.stream(stream):
            dst = out if out is not None else torch.empty(
                src.shape, dtype=src.dtype, device=device)
            dst.copy_(src, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        consumer.wait_event(event)
        dst.record_stream(consumer)
        return dst, _CudaDone(event)

    # -- in-flight byte window -------------------------------------------

    def _sweep(self) -> None:
        """Drop window entries whose copies already completed
        (non-blocking probe), releasing their bytes and staging
        buffers."""
        released = []
        with self._lock:
            keep: deque = deque()
            while self._window:
                ent = self._window.popleft()
                probe = getattr(ent.done, "is_ready", None)
                done = False
                if probe is not None:
                    try:
                        done = bool(probe())
                    except RuntimeError:
                        done = False
                if done:
                    self._window_bytes -= ent.nbytes
                    if ent.buf is not None:
                        released.append(ent.buf)
                else:
                    keep.append(ent)
            self._window = keep
        for buf in released:
            self._release_staging(buf, gate=None)

    def _wait_entry_ready(self, ent: _WindowEntry,
                          t_end: Optional[float]) -> None:
        """Block until `ent`'s copy lands, bounded by `t_end`
        (monotonic). With an `is_ready` probe the wait polls (with a
        backoff from 20 µs to 2 ms) so it CAN time out; without one it
        falls back to the unbounded blocking wait. Timeout raises
        `TransferAcquireTimeoutError` with the entry untouched — the
        caller must re-queue it before propagating."""
        probe = getattr(ent.done, "is_ready", None)
        if probe is None or t_end is None:
            _block_ready(ent.done)
            return
        pause = 2e-5
        while True:
            try:
                if probe():
                    return
            except RuntimeError:
                return  # a failed copy holds nothing any more
            if time.monotonic() >= t_end:
                raise TransferAcquireTimeoutError(
                    f"in-flight window acquisition timed out after "
                    f"{self.acquire_timeout_s:.1f}s "
                    f"({self._window_bytes} B held, "
                    f"{self.inflight_bytes} B window)")
            time.sleep(pause)
            pause = min(pause * 2, 2e-3)

    def _admit(self, nbytes: int) -> None:
        """Reserve `nbytes` of in-flight budget, blocking on the OLDEST
        outstanding copies until the window fits (their completion also
        releases their staging buffers). The wait is BOUNDED by the
        acquire timeout."""
        self._sweep()
        t_end = (time.monotonic() + self.acquire_timeout_s
                 if self.acquire_timeout_s > 0 else None)
        while True:
            with self._lock:
                if (self._window_bytes + nbytes <= self.inflight_bytes
                        or not self._window):
                    self._window_bytes += nbytes
                    return
                ent = self._window.popleft()
                self.stats["window_waits"] += 1
            from hyperspace_tpu_torch import telemetry
            try:
                with telemetry.span("sync:h2d.window", "device_wait"):
                    self._wait_entry_ready(ent, t_end)
            except TransferAcquireTimeoutError:
                with self._lock:
                    # Still outstanding: its bytes stay accounted, back
                    # at the window head.
                    self._window.appendleft(ent)
                telemetry.get_registry().counter(
                    "io.transfer.acquire_timeouts").inc()
                raise
            with self._lock:
                self._window_bytes -= ent.nbytes
            if ent.buf is not None:
                self._release_staging(ent.buf, gate=None)

    def _windowed_put(self, view, device, buf=None, out=None):
        nbytes = int(view.nbytes)
        self._admit(nbytes)
        try:
            dev, done = self._raw_put(view, device, staging=buf, out=out)
        except BaseException:
            # A copy that dies must RELEASE its reservation (and its
            # staging buffer), or the window shrinks for every later
            # caller.
            with self._lock:
                self._window_bytes -= nbytes
            if buf is not None:
                self._release_staging(buf, gate=None)
            raise
        with self._lock:
            if done is None:
                self._window_bytes -= nbytes
            else:
                self._window.append(_WindowEntry(done, nbytes, buf))
            self.stats["chunks"] += 1
        if done is None and buf is not None:
            self._release_staging(buf, gate=None)
        return dev

    # -- staging buffers --------------------------------------------------

    def _staging_ok(self, device=None) -> bool:
        """Staging reuse is only safe when the copy does not alias the
        host buffer: true for a CUDA device (and for fake links, which
        copy by contract), false for the CPU, where a "device" tensor
        may BE the host array."""
        if self._put_fn is not None:
            return True
        return device is not None and torch.device(device).type == "cuda"

    def _acquire_staging(self, nbytes: int, device) -> Optional[_Staging]:
        """A host staging buffer of capacity >= nbytes (reused when one
        is free), or None when staging is disabled/pointless."""
        if nbytes < _STAGING_MIN_BYTES or not self._staging_ok(device):
            return None
        buf = gate = None
        with self._lock:
            for i, ent in enumerate(self._staging_free):
                if ent[0].nbytes >= nbytes:
                    buf, gate = ent
                    del self._staging_free[i]
                    break
        if buf is not None:
            if gate is not None:
                _block_ready(gate)  # its last copy must have landed
            with self._lock:
                self.stats["staging_reused"] += 1
            return buf
        buf = _Staging(max(nbytes, self.chunk_bytes),
                       pinned=self._put_fn is None)
        with self._lock:
            self.stats["staging_allocated"] += 1
        return buf

    def _release_staging(self, buf: _Staging, gate) -> None:
        with self._lock:
            if len(self._staging_free) < 2 * max(1, self.threads) + 2:
                self._staging_free.append([buf, gate])

    def _convert(self, entry, start: int, stop: int, device):
        """Rows [start, stop) of an ndarray or HostCast into a staging
        buffer (or a fresh array / a plain view when staging is off).
        Runs on the staging pool. Returns (view, staging, seconds)."""
        t0 = time.perf_counter()
        cast = isinstance(entry, HostCast)
        src = (entry.src if cast else entry)[start:stop]
        dtype = entry.dtype if cast else src.dtype
        nbytes = int(np.prod(src.shape, dtype=np.int64)) * dtype.itemsize
        buf = self._acquire_staging(nbytes, device)
        if buf is None:
            view = (np.ascontiguousarray(src).astype(dtype) if cast
                    else src)
        else:
            view = buf.array[:nbytes].view(dtype).reshape(src.shape)
            np.copyto(view, src, casting="unsafe")
        return view, buf, time.perf_counter() - t0

    # -- chunk planning ---------------------------------------------------

    def _chunk_bounds(self, shape, itemsize: int):
        """[(start, stop)) row ranges of <= chunk_bytes each, or None for
        a single-chunk transfer."""
        if not shape:
            return None
        rows = shape[0]
        row_bytes = itemsize
        for d in shape[1:]:
            row_bytes *= d
        if row_bytes <= 0:
            return None
        per = max(1, self.chunk_bytes // row_bytes)
        if rows <= per:
            return None
        return [(i, min(rows, i + per)) for i in range(0, rows, per)]

    def d2h_chunk_count(self, nbytes: int) -> int:
        """How many concurrent D2H copies a fetch of `nbytes` should
        split into (the build's permutation fetch)."""
        if nbytes < self.chunk_bytes:
            return 1
        return int(min(_MAX_D2H_CHUNKS, -(-nbytes // self.chunk_bytes)))

    # -- entry placement --------------------------------------------------

    def _destination(self, entry, device):
        """The one device tensor a chunked real-device put writes its
        chunks into (None on a fake link, whose parts are assembled)."""
        if self._put_fn is not None:
            return None
        dtype = entry.dtype
        device = torch.device(device)
        if device.type == "cuda":
            with torch.cuda.stream(self._stream(self._h2d_streams, device)):
                dst = torch.empty(entry.shape, dtype=_torch_dtype(dtype),
                                  device=device)
            dst.record_stream(torch.cuda.current_stream(device))
            return dst
        return torch.empty(entry.shape, dtype=_torch_dtype(dtype))

    def _put_parts(self, entry, device, timings):
        """Place one logical array (ndarray or HostCast) as windowed
        device chunk(s); conversions run on the staging pool ahead of
        the copies. Returns (ordered chunk list, whole) — on a real
        device the chunks are views of `whole`, the one destination
        tensor; on a fake link `whole` is None. Sub-chunk arrays are one
        chunk, which is also `whole`."""
        bounds = self._chunk_bounds(entry.shape, entry.dtype.itemsize)
        if bounds is None:
            rows = entry.shape[0] if entry.shape else 0
            view, buf, conv_s = self._convert(entry, 0, rows, device)
            timings["convert_s"] += conv_s
            t0 = time.perf_counter()
            dev = self._windowed_put(view, device, buf=buf)
            timings["put_s"] += time.perf_counter() - t0
            timings["chunks"] += 1
            return [dev], dev

        dest = self._destination(entry, device)
        parts = [None] * len(bounds)
        pending: deque = deque()
        lookahead = max(1, self.threads) + 1
        pool = self._staging_pool()

        from hyperspace_tpu_torch import telemetry

        def emit():
            # Chunk-boundary cancellation checkpoint: a cancelled query
            # stops shipping chunks here; already-issued copies complete
            # and release through the window sweep.
            telemetry.check_deadline("transfer")
            idx, fut = pending.popleft()
            view, buf, conv_s = fut.result()
            timings["convert_s"] += conv_s
            s, e = bounds[idx]
            t0 = time.perf_counter()
            parts[idx] = self._windowed_put(
                view, device, buf=buf,
                out=dest[s:e] if dest is not None else None)
            timings["put_s"] += time.perf_counter() - t0
            timings["chunks"] += 1

        try:
            for idx, (s, e) in enumerate(bounds):
                while len(pending) >= lookahead:
                    emit()
                pending.append((idx, pool.submit(self._convert, entry, s,
                                                 e, device)))
            while pending:
                emit()
        except BaseException:
            # Conversions already submitted hold pooled buffers their
            # copy will now never consume: drain and return them.
            while pending:
                _idx, fut = pending.popleft()
                try:
                    _view, buf, _s = fut.result()
                except Exception:
                    continue
                if buf is not None:
                    self._release_staging(buf, gate=None)
            raise
        return parts, dest

    def _put_entry(self, entry, device, timings):
        """As `_put_parts`, as ONE device array (a fake link's chunks
        are concatenated back on the host)."""
        parts, whole = self._put_parts(entry, device, timings)
        if whole is not None:
            return whole
        return np.concatenate([np.asarray(p) for p in parts])

    # -- public API -------------------------------------------------------

    def put(self, arr, device=None):
        """Place one host array (ndarray or HostCast) on `device`: it
        crosses the link chunked + windowed and lands in the h2d
        telemetry. With a `parallel.mesh.Mesh` as `device` the array is
        placed ROW-SHARDED and a list of per-shard tensors comes back
        (`_put_sharded`)."""
        from hyperspace_tpu_torch import telemetry
        from hyperspace_tpu_torch.parallel.mesh import Mesh

        if not isinstance(arr, HostCast):
            arr = np.asarray(arr)
        if isinstance(device, Mesh):
            return self._put_sharded(arr, device)
        timings = {"convert_s": 0.0, "put_s": 0.0, "chunks": 0}
        with telemetry.link_transfer("h2d", int(arr.nbytes)) as link:
            dev = self._put_entry(arr, device, timings)
            link["chunks"] = timings["chunks"]
        with self._lock:
            self.stats["puts"] += 1
        self._sweep()
        return dev

    def _put_sharded(self, arr, mesh) -> List:
        """Shard s's row slice `[s*L, (s+1)*L)` (L = rows / shards; the
        caller pads to a multiple) onto `mesh.devices[s]`. Each shard's
        copy is queued asynchronously on its device's side stream, so
        every shard's copy is issued before the first wait; one h2d
        record covers the whole array."""
        from hyperspace_tpu_torch import telemetry

        n_shards = len(mesh.devices)
        rows = int(arr.shape[0])
        if rows % n_shards:
            raise ValueError(f"{rows} rows do not split into {n_shards} "
                             "equal shards; pad first")
        local = rows // n_shards
        timings = {"convert_s": 0.0, "put_s": 0.0, "chunks": 0}
        parts = []
        with telemetry.link_transfer("h2d", int(arr.nbytes)) as link:
            for s, dev in enumerate(mesh.devices):
                lo, hi = s * local, (s + 1) * local
                piece = (HostCast(arr.src[lo:hi], arr.dtype)
                         if isinstance(arr, HostCast) else arr[lo:hi])
                parts.append(self._put_entry(piece, dev, timings))
            link["chunks"] = max(timings["chunks"], 1)
        with self._lock:
            self.stats["puts"] += 1
        self._sweep()
        return parts

    def put_chunks(self, arr, device=None):
        """Place a host array (ndarray or HostCast) as a TUPLE of device
        row-chunks without reassembly."""
        from hyperspace_tpu_torch import telemetry

        if not isinstance(arr, HostCast):
            arr = np.asarray(arr)
        timings = {"convert_s": 0.0, "put_s": 0.0, "chunks": 0}
        with telemetry.link_transfer("h2d", int(arr.nbytes)) as link:
            parts = tuple(self._put_parts(arr, device, timings)[0])
            link["chunks"] = len(parts)
        with self._lock:
            self.stats["puts"] += 1
        self._sweep()
        return parts

    def put_group(self, jobs: Sequence[Callable[[], dict]], device=None,
                  tag: Optional[str] = None) -> List[dict]:
        """Pipelined multi-column placement. Each job runs on the
        staging pool and returns {name: value} where ndarray / HostCast
        values get placed on `device` (chunked + windowed), `Host(v)`
        unwraps to v, and anything else passes through. Decode of column
        i+1 overlaps column i's copies; one h2d telemetry record covers
        the group, and the measured overlap (serial stage sum minus
        pipelined wall) accumulates in `transfer.overlap_saved_seconds`.

        `tag` names the LANE for attribution: segment-cache fills pass
        `tag="fill"`, which lands the group in `transfer.fill.{bytes,
        seconds,chunks}` counters alongside the shared `link.h2d.*`
        series (fills share the link, the window and the staging pool
        with live queries' transfers — only the accounting is split). The
        cancellation checkpoints carry the `transfer.fill` phase then,
        so an interrupted fill is distinguishable from an interrupted
        query transfer in `serve.interrupted.*`."""
        if not jobs:
            return []
        from hyperspace_tpu_torch import telemetry
        pool = self._staging_pool()
        phase = f"transfer.{tag}" if tag else "transfer"
        t0 = time.perf_counter()

        def timed(job):
            j0 = time.perf_counter()
            out = job()
            return out, time.perf_counter() - j0

        futs = [pool.submit(timed, job) for job in jobs]
        timings = {"convert_s": 0.0, "put_s": 0.0, "chunks": 0}
        decode_s = 0.0
        total_bytes = 0
        results: List[dict] = []
        with telemetry.link_transfer("h2d") as link:
            for fut in futs:
                # Per-column checkpoint: remaining decodes still run on
                # the pool (futures are not revoked) but their results
                # are plain host arrays — nothing device-side leaks.
                telemetry.check_deadline(phase)
                produced, job_s = fut.result()
                decode_s += job_s
                placed = {}
                for key, value in produced.items():
                    if isinstance(value, Host):
                        placed[key] = value.value
                    elif isinstance(value, (np.ndarray, HostCast)):
                        total_bytes += int(value.nbytes)
                        placed[key] = self._put_entry(value, device,
                                                      timings)
                    else:
                        placed[key] = value
                results.append(placed)
            link["bytes"] = total_bytes or None
            link["chunks"] = max(timings["chunks"], 1)
        wall = time.perf_counter() - t0
        serial_s = decode_s + timings["convert_s"] + timings["put_s"]
        saved = max(serial_s - wall, 0.0)
        with self._lock:
            self.stats["groups"] += 1
        if total_bytes:
            reg = telemetry.get_registry()
            reg.counter("transfer.overlap_saved_seconds").inc(saved)
            if tag:
                reg.counter(f"transfer.{tag}.bytes").inc(total_bytes)
                reg.counter(f"transfer.{tag}.seconds").inc(wall)
                reg.counter(f"transfer.{tag}.chunks").inc(
                    max(timings["chunks"], 1))
        self._sweep()
        return results

    # -- lifecycle --------------------------------------------------------

    def sweep(self) -> None:
        """Public probe-and-release pass over the in-flight window:
        completed copies give back their bytes and staging buffers NOW
        (the scheduler calls this after a cancellation so a dead
        query's window share does not wait for the next caller's
        put)."""
        self._sweep()

    def drain(self) -> None:
        """Block (bounded by the acquire timeout per entry) until every
        outstanding copy lands and its resources are released."""
        while True:
            with self._lock:
                if not self._window:
                    return
                ent = self._window.popleft()
            t_end = (time.monotonic() + self.acquire_timeout_s
                     if self.acquire_timeout_s > 0 else None)
            try:
                self._wait_entry_ready(ent, t_end)
            except TransferAcquireTimeoutError:
                logger.warning("drain: abandoning a copy that never "
                               "completed (%d B)", ent.nbytes)
            with self._lock:
                self._window_bytes -= ent.nbytes
            if ent.buf is not None:
                self._release_staging(ent.buf, gate=None)

    def shutdown(self) -> None:
        """Drain the window and stop the staging pool (idempotent;
        registered atexit)."""
        try:
            self.drain()
        except RuntimeError as exc:
            logger.warning("transfer engine shutdown: %r", exc)
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    # -- device -> host ---------------------------------------------------

    def fetch(self, arr) -> np.ndarray:
        """One device->host fetch with d2h telemetry; host-resident
        inputs pass through uncounted. A CPU tensor's array SHARES its
        memory. A tensor prefetched earlier (`prefetch`) waits for its
        copy and returns the landed bytes."""
        if isinstance(arr, np.ndarray):
            return arr
        if not isinstance(arr, torch.Tensor):
            return np.asarray(arr)  # fake device arrays
        from hyperspace_tpu_torch import telemetry
        nbytes = arr.numel() * arr.element_size()
        with telemetry.link_transfer("d2h", nbytes):
            landed = getattr(arr, "_hs_prefetch", None)
            if landed is not None:
                host, event = landed
                del arr._hs_prefetch
                with telemetry.span("sync:d2h.landed", "device_wait"):
                    event.synchronize()
                return host.numpy()
            with telemetry.span("sync:d2h.copy", "device_wait"):
                return arr.cpu().numpy()

    def _prefetch_one(self, arr) -> None:
        if not isinstance(arr, torch.Tensor) or arr.device.type != "cuda":
            return
        host = torch.empty(arr.shape, dtype=arr.dtype, pin_memory=True)
        stream = self._stream(self._d2h_streams, arr.device)
        stream.wait_stream(torch.cuda.current_stream(arr.device))
        with torch.cuda.stream(stream):
            host.copy_(arr, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        arr.record_stream(stream)
        arr._hs_prefetch = (host, event)

    def prefetch(self, *arrs) -> None:
        """Issue async D2H copies (into pinned host memory, on a side
        stream that waits for the work producing them) so later
        `fetch`es find landed bytes. A failing prefetch degrades to the
        serial fetch — so it is COUNTED (`link.d2h.prefetch_errors`)
        and debug-logged instead of swallowed invisibly."""
        from hyperspace_tpu_torch import telemetry
        for arr in arrs:
            try:
                self._prefetch_one(arr)
            except Exception as exc:
                telemetry.get_registry().counter(
                    "link.d2h.prefetch_errors").inc()
                logger.debug("d2h prefetch failed (serial fallback): %r",
                             exc)


# -- process-wide engine ---------------------------------------------------

_engine: Optional[TransferEngine] = None
_engine_lock = threading.Lock()


def get_engine() -> TransferEngine:
    global _engine
    if _engine is None:
        with _engine_lock:
            if _engine is None:
                _engine = TransferEngine()
    return _engine


def set_engine(engine: TransferEngine) -> TransferEngine:
    """Install a specific engine (tests: tiny chunk sizes, fake links)."""
    global _engine
    _engine = engine
    return engine


def reset_engine() -> None:
    global _engine
    _engine = None


def configure(conf) -> None:
    """Refresh the process engine's knobs from a session conf."""
    get_engine().configure(conf)


def shutdown() -> None:
    """Shut the process engine down (atexit hook; idempotent — a new
    engine lazily re-creates on the next put)."""
    engine = _engine
    if engine is not None:
        engine.shutdown()


import atexit  # noqa: E402

atexit.register(shutdown)
