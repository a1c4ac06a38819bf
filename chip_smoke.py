#!/usr/bin/env python3
"""Smoke run of `hyperspace_tpu_torch` on one CUDA card.

    python3 chip_smoke.py

Builds the package's CUDA kernels from the sources in this checkout (one
`nvcc` per source, all at once), holds each kernel against its plain
PyTorch version on the card (the run-bounds kernel of the counting join
also timed at the sizes of TPC-H q13's and q5's joins), then drives the
main path through the public entry points:

- the Quick Start loop at the size of `bench.py`'s filter rung: a
  16,777,216-row Parquet source (key, k2, id, score; 512 MB in 4 files),
  `Hyperspace.create_index` at the default 200 buckets, and two
  index-served filters (a bucket-pruned point lookup on the host lane and
  a full-index range on the device lane);
- the shuffle-free join on `bench.py`'s join schema: two 8,388,608-row
  right sources (key, val), indexed at 200 and at 64 buckets, each joined
  with the left index — query A with equal bucket counts (no Exchange,
  bench.py's rung 3) and query B with 64 buckets (the right side
  re-bucketed to 200 through the Exchange and its partition kernel);
- hybrid scan (`bench.py`'s rungs 4 and 4b): an index over hard links to
  the filter source, then one appended 4,194,304-row file — as many rows
  as `min.device.rows`, so the appended branch runs on the device lane —
  and three queries served as index UNION appended file: H1 a point
  filter, H2 an inner join with the 200-bucket right index (distributed
  over the Union), H3 a left_outer join with the hybrid side on the right
  (its appended branch re-bucketed through the Exchange's partition
  kernel); then an incremental refresh (the delta built with the hash
  kernel) after which the same queries plan without a Union;
- index maintenance (`bench.py`'s rung 5): over a fresh 4,194,304-row
  source, three rounds of append + incremental refresh + optimize (the
  host merge lane), two full refreshes, the last optimize byte-equal to
  the first full refresh; a composite-key index whose optimize sorts on
  the device, byte-equal to its full refresh; then delete, restore,
  delete and vacuum;
- TPC-H at SF1's row counts (6,753,260 `lineitem` rows, the port's seeded
  generator at scale 100): the five covering indexes of its query module
  at 200 buckets, then all 22 queries with `min.device.rows` = 0, so every
  operator (aggregates, sorts, top-k, cross joins, reused subplans) runs
  on the card — rules on (a warm-up, then two timed runs) and rules off,
  each against the pandas oracle; q1 must give the same bytes twice;
- TPC-DS at about SF1's fact-table row counts (2.9M `store_sales`, 1.8M
  `catalog_sales`, 1.2M `web_sales`: the port's seeded generator at scale
  10): the 13 covering indexes of its query module at 200 buckets, then
  all 99 queries with `min.device.rows` = 0 (windows, set operations and
  scalar subqueries among them) — rules on (a warm-up, then one timed run)
  and rules off, each against the pandas oracle, each rules-on plan on the
  indexes the JAX package's plan reads;
- data skipping (`bench.py`'s rung 5b) over 16 key-clustered files of
  1,048,576 rows: the sketch build on the device lane (`min.device.rows`
  = 0) and on the host lane, their blobs byte-equal; the point, 1 % and
  25 % key ranges pruned in place and one `k2 == 7 AND key in range`
  query served from a Z-order copy, each against the unpruned scan, cold
  and warm, rules on and off, each against numpy; one appended file, an
  incremental refresh that sketches only it and a full refresh, each
  followed by a point lookup on the newest blob; and hybrid scan over a
  stale covering index whose appended branch the sketches prune away.

- the serving plane (`phase_serve`): bench_serve.py's data and mix at
  16,777,216 `facts` rows with a 200-bucket covering index on `g`, every
  collect through the scheduler — a warm-up lap of the batch lane, closed
  loops at 1 and 8 clients (QPS, percentiles, batch occupancy, each
  cohort's `serve.batch` device ms), admission under a budget and a
  rejected burst, an open-loop Poisson sweep, a tenants lap with join B
  as the greedy tenant, an ingest lap with an incremental refresh, and a
  chaos lap with injected faults; each result against its serial run,
  itself against numpy.

- device-side telemetry, over the filter index and the two right indexes
  of the join rung: the compile seam's counts of the nvcc and g++ builds
  and of the later loads; the range filter and joins A and B with their
  recorders' `roofline` (CUDA-event device seconds of the instrumented
  entry points, modeled bytes, the gathers' bytes held against this
  script's own formula) and critical paths; the range filter and join A
  with their recorders and without, in turns (181 and 21), the ratio of
  the medians printed beside its 5 % limit (a reading, not a gate); join
  B captured
  by `torch.profiler` under `spark.hyperspace.trace.dir`, with the
  trace's device-busy share; a slow-query dump read back; the ops
  server's endpoints; and a cold and a warm pass of the three queries
  as canonical artifacts with their diff.

- whole-stage fusion (`engine/fusion.py`, on by default as in the JAX
  package, so every phase above runs fused): the warm range filter,
  joins A and B, hybrid H3 and all 22 TPC-H and 99 TPC-DS queries also
  run rules on with `execution.fusion.enabled` true and false, in
  turns (twice each side, ABBA; the joins and H3 once), each against
  its phase's oracle and fused against unfused
  (one `fusion_query` line each: ms both ways, the stage count, fusion
  lanes, stage-sync seconds, `fusion.run_stage` device seconds), summed
  per rung on the `fusion` line — a record, not a speed gate;
- the device mesh (`phase_mesh`, last): a virtual 4-shard mesh on the
  one card, the born-sharded 200-bucket build of the filter rung's source
  on the flat mesh and on a 2 x 2 (dcn, shard) mesh — every bucket file
  byte-equal to a single-device build, the `_shard_layout.json` record
  and the log entry's `shardLayout` checked — then, through the rules,
  the point and full-range filters on the mesh index and a group
  aggregate over the source on the mesh, each against numpy and against
  distribution off; then the SPMD join through the rules: the join
  rung's 8,388,608-row right source indexed on the mesh at 64 buckets
  (join B, its right side re-bucketed between shards through the hash
  kernel, one launch per shard; then a left_outer join), and at 200
  (join A; then a left_semi join), a string-key join at 1,048,576 rows,
  and join A on the 2 x 2 mesh — each against numpy and against
  `distribution.spmd.enabled=false`, with no `spmd.fallbacks`, and the
  hash kernel held against its plain version at the re-bucket's
  per-shard shape. On one card the shards' exchanges are moves within
  one device: the `mesh` line shows that the port distributes and gives
  the same bytes, not a multi-GPU speed;
- the self-driving index advisor (`phase_advisor`): bench_advisor.py's
  workload at 16,777,216 `facts` rows (its 40,000, scaled up; 2,097,152
  `dims` rows), the filter and the join 4 times with no index,
  `advisor().run_once()`, then 4 times again: at least one index built
  (through the hash kernel), rules applied after, strictly fewer bytes
  scanned, every result equal before and after and to numpy.

Around the main path it also drives the host I/O layer: the native host
library (built with `g++` from `hyperspace_tpu_torch/native/`; a `native`
line with its build time and the time to hash TPC-H `o_comment`'s
dictionary with it and with the pure-Python loop), the transfer engine (a
`transfer` line: its H2D and D2H rates for 512 MB against one plain
`.to()` and `.cpu()`), the build's native-host against device
permutations on the 16,777,216-row source, and the read caches: the
`tpch` and `tpcds` phases run every query cold (after
`parquet.clear_read_cache()` and `segcache.clear()`) and warm, rules on
and off, with the `cache.*` and `link.h2d.*` counters of each pass, and
the maintenance phase queries the index after every refresh, optimize,
delete, restore and vacuum. The caches keep their default budgets.

Every result is checked against numpy (TPC-H, TPC-DS: pandas) over the
sources. Every phase prints one JSON line, with the kernel launches counted from
zero over it; any mismatch or error ends the run with a non-zero exit. The
last lines are the kernel table, the card's name and power limit as
`nvidia-smi` reports them, and `{"ok": true, "device": {...}}`.

Needs one CUDA card; exits non-zero without one, or without the package
beside it. Scratch data lives under `_smoke/` in the checkout and is
removed at the end.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N_ROWS = 1 << 24
N_FILES = 4
N_RIGHT = 1 << 23               # rows of each join right source
N_APPEND = 1 << 22              # the hybrid phase's appended file
N_MAINT = 1 << 22               # the maintenance phase's base source
N_MAINT_APPEND = N_MAINT // 20  # each maintenance round's appended slice
TPCH_SCALE = 100                # the generator's scale for SF1 row counts
TPCDS_SCALE = 10                # ~SF1 fact-table rows (2.9M store_sales)
EXCHANGE_BUCKETS = 200          # the left index's count: B's Exchange target
TRANSFER_BYTES = 512 << 20      # each way, in the transfer phase
N_SKIP_FILES = 16               # the skipping phase's key-clustered files
N_SKIP_PER_FILE = 1 << 20       # rows per file: 16,777,216 in all
SEED = 42
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
INT_OPS_PER_S = 67e12           # H100 SXM non-tensor 32-bit rate
HASH_OPS_PER_LANE = 20          # fmix32 + hash_combine, 32-bit ops


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(message):
    print(f"chip_smoke: FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, message):
    if not cond:
        fail(message)


def counter_deltas(before, after, prefixes=("cache.", "link.h2d.")):
    """The registry counters under `prefixes` that moved between two
    `counters_dict()` snapshots."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if k.startswith(prefixes) and v != before.get(k, 0)}


def add_deltas(total, deltas):
    for k, v in deltas.items():
        total[k] = total.get(k, 0) + v


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# -- a self-contained numpy copy of THE bucket hash identity ---------------

def _np_fmix32(h):
    import numpy as np
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def np_bucket_ids_int64(key, num_buckets):
    """Bucket ids of an int64 key column: fmix32(hi) hash-combined with
    fmix32(lo), modulo the bucket count."""
    import numpy as np
    with np.errstate(over="ignore"):
        h1 = _np_fmix32((key >> 32).astype(np.uint32))
        h2 = _np_fmix32((key & 0xFFFFFFFF).astype(np.uint32))
        h = h1 ^ (h2 + np.uint32(0x9E3779B9) + (h1 << np.uint32(6))
                  + (h1 >> np.uint32(2)))
    return (h % np.uint32(num_buckets)).astype(np.int32)


# -- timing on the card ------------------------------------------------------

def cuda_ms(fn, iters=20, repeats=5):
    """Milliseconds per call of `fn` on the card: CUDA events around
    `iters` back-to-back calls (so the host's enqueue runs ahead of the
    card), median over `repeats` such runs, after one warm call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    times.sort()
    return times[len(times) // 2]


def wall_ms(fn, iters=3):
    """Median host milliseconds of `fn` (which ends in a host copy)."""
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


# -- phases ------------------------------------------------------------------

def phase_kernel_hash(hash_kernel):
    """The hash kernel against its plain version at every size/lane/bucket
    case, with tolerance 0 (the on-disk layout needs identical bucket ids);
    timed at the build's shape."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = 0
    worst = 0
    # N_ROWS // MESH_SHARDS: each shard's ids in the mesh phase's build.
    for n in (1, 127, 129, 4097, 70_000, N_ROWS // MESH_SHARDS, N_ROWS):
        for n_lanes in (1, 2, 4, 6):
            lanes = torch.randint(-2**31, 2**31, (n_lanes, n),
                                  dtype=torch.int32, device="cuda",
                                  generator=gen)
            if n >= 4:
                lanes[:, 0] = 0    # an all-zero row
                lanes[:, 1] = -1   # an all-0xFFFFFFFF row
            for num_buckets in (8, 64, 200, 1024):
                got = hash_kernel.hash_lanes_to_buckets(lanes, num_buckets)
                torch.cuda.synchronize()
                want = hash_kernel.hash_lanes_to_buckets_reference(
                    lanes, num_buckets)
                err = int((got.long() - want.long()).abs().max().item()) \
                    if n else 0
                worst = max(worst, err)
                check(err == 0 and got.dtype == torch.int32,
                      f"kernel != plain at n={n} L={n_lanes} "
                      f"B={num_buckets}")
                cases += 1
    # The build's shape: an int64 key -> 2 lanes, 200 buckets.
    n, n_lanes, num_buckets = N_ROWS, 2, 200
    lanes = torch.randint(-2**31, 2**31, (n_lanes, n), dtype=torch.int32,
                          device="cuda", generator=gen)
    ms = cuda_ms(lambda: hash_kernel.hash_lanes_to_buckets(lanes,
                                                            num_buckets))
    plain_ms = cuda_ms(lambda: hash_kernel.hash_lanes_to_buckets_reference(
        lanes, num_buckets), iters=5, repeats=3)
    nbytes = 4 * n * (n_lanes + 1)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = HASH_OPS_PER_LANE * n * n_lanes / INT_OPS_PER_S * 1e3
    row = {"name": "hash_lanes_to_buckets", "route": "cuda",
           "source": "hyperspace_tpu_torch/csrc/hash_buckets.cu",
           "replaces": "hyperspace_tpu/ops/pallas/hash_kernel.py:56",
           "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": None}
    emit("kernel_hash", cases=cases, max_abs_err=worst, tolerance=0, n=n,
         lanes=n_lanes, num_buckets=num_buckets, bytes=nbytes, ms=ms,
         bound_ms=row["bound_ms"], plain_ms=plain_ms)
    return row


def phase_kernel_partition(partition_kernel, hash_kernel):
    """The partition kernel against its plain version at every size/lane/
    bucket case, with tolerance 0 (integer ids and counts); timed at the
    Exchange's shape beside the two-pass path (hash kernel + bincount)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    cases = 0
    worst = 0
    for n in (1, 127, 129, 4097, 70_000, N_RIGHT):
        for n_lanes in (1, 2, 4, 6):
            lanes = torch.randint(-2**31, 2**31, (n_lanes, n),
                                  dtype=torch.int32, device="cuda",
                                  generator=gen)
            if n >= 4:
                lanes[:, 0] = 0    # an all-zero row
                lanes[:, 1] = -1   # an all-0xFFFFFFFF row
            for num_buckets in (8, 64, 200, 1024):
                ids, lengths = partition_kernel.partition_ids_and_histogram(
                    lanes, num_buckets)
                torch.cuda.synchronize()
                want = hash_kernel.hash_lanes_to_buckets_reference(
                    lanes, num_buckets)
                want_lengths = torch.bincount(want, minlength=num_buckets)
                err = max(int((ids.long() - want.long()).abs().max()),
                          int((lengths - want_lengths).abs().max()))
                worst = max(worst, err)
                check(err == 0 and ids.dtype == torch.int32
                      and lengths.dtype == torch.int64
                      and int(lengths.sum()) == n,
                      f"partition kernel != plain at n={n} L={n_lanes} "
                      f"B={num_buckets}")
                cases += 1
    # The Exchange's shape: the 8,388,608-row right side, an int64 key
    # (2 lanes), re-bucketed to the left index's 200 buckets.
    n, n_lanes, num_buckets = N_RIGHT, 2, EXCHANGE_BUCKETS
    lanes = torch.randint(-2**31, 2**31, (n_lanes, n), dtype=torch.int32,
                          device="cuda", generator=gen)
    ms = cuda_ms(lambda: partition_kernel.partition_ids_and_histogram(
        lanes, num_buckets))
    plain_ms = cuda_ms(
        lambda: partition_kernel.partition_ids_and_histogram_reference(
            lanes, num_buckets), iters=5, repeats=3)
    two_pass_ms = cuda_ms(lambda: torch.bincount(
        hash_kernel.hash_lanes_to_buckets(lanes, num_buckets),
        minlength=num_buckets))
    nbytes = 4 * n * n_lanes + 4 * n + 8 * num_buckets
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = HASH_OPS_PER_LANE * n * n_lanes / INT_OPS_PER_S * 1e3
    row = {"name": "partition_ids_and_histogram", "route": "cuda",
           "source": "hyperspace_tpu_torch/csrc/partition_histogram.cu",
           "replaces": "hyperspace_tpu/ops/pallas/partition_kernel.py:84",
           "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": None}
    emit("kernel_partition", cases=cases, max_abs_err=worst, tolerance=0,
         n=n, lanes=n_lanes, num_buckets=num_buckets, bytes=nbytes, ms=ms,
         bound_ms=row["bound_ms"], plain_ms=plain_ms,
         two_pass_ms=two_pass_ms)
    return row


def _run_flags(lengths):
    """The T-1 difference flags (bool, on the card) of a sorted sequence
    with runs `lengths`."""
    import numpy as np
    import torch
    starts = np.zeros(int(np.sum(lengths)), dtype=bool)
    starts[np.cumsum(lengths)[:-1]] = True
    return torch.from_numpy(starts[1:]).to("cuda")


def _order_runs(total, seed):
    """Run lengths of 1-7 (TPC-H's lines an order) summing to `total`."""
    import numpy as np
    lengths = np.random.default_rng(seed).integers(1, 8, total // 3)
    lengths = lengths[np.cumsum(lengths) < total]
    return np.r_[lengths, total - lengths.sum()]


def phase_kernel_run_bounds(run_bounds_kernel):
    """The run-bounds kernel against its plain version (on the card) at
    edge and tile-crossing cases, with tolerance 0 (integer positions);
    timed at the counting joins of q13 and q5 in the TPC-H benchmark
    (T = 1,513,636 and 6,226,893, runs of 1-7)."""
    import numpy as np
    import torch

    def err(differs):
        got = run_bounds_kernel.run_bounds(differs)
        want = run_bounds_kernel.run_bounds_reference(differs)
        check(all(g.dtype == torch.int64 for g in got),
              "run-bounds kernel: outputs not int64")
        return max(int((g - w).abs().max()) for g, w in zip(got, want))

    tile = 4096  # the kernel's tile (`csrc/run_bounds.cu`)
    rng = np.random.default_rng(SEED)
    cases = [_run_flags(lengths) for lengths in (
        [1], [2], [1, 1], [3 * tile], [1] * (2 * tile + 5),
        [tile - 10, 25, tile, 7], [3, 3 * tile + 100, 2, 40],
        [5, 40 * tile, 3, 33 * tile, 9], _order_runs(1_000_003, SEED))]
    cases += [torch.from_numpy(rng.random(T - 1) < 0.3).to("cuda")
              for T in (4097, 70_001, 1 << 20)]
    worst = 0
    for differs in cases:
        worst = max(worst, err(differs))
        check(worst == 0,
              f"run-bounds kernel != plain at T={differs.shape[0] + 1}")
    shapes = []
    for T in (1_513_636, 6_226_893):
        differs = _run_flags(_order_runs(T, SEED + T))
        worst = max(worst, err(differs))
        check(worst == 0, f"run-bounds kernel != plain at T={T}")
        # The kernel's time: its C entry point on buffers made once, so
        # the launches queue faster than the card runs them. The wrapper
        # (checks, allocation, the device seam) costs tens of
        # microseconds of host time a call beside it.
        tiles, launch = run_bounds_kernel._kernel_fns()
        buf = torch.empty(2 * T + 2 * tiles(T), dtype=torch.int64,
                          device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        check(launch(differs.data_ptr(), T, buf.data_ptr(), stream) == 0,
              "run-bounds kernel refused its launch")
        ms = cuda_ms(lambda: launch(differs.data_ptr(), T, buf.data_ptr(),
                                    stream))
        wrapper_ms = cuda_ms(lambda: run_bounds_kernel.run_bounds(differs))
        plain_ms = cuda_ms(
            lambda: run_bounds_kernel.run_bounds_reference(differs),
            iters=5, repeats=3)
        nbytes = run_bounds_kernel.BYTES_PER_ELEMENT * T
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        shapes.append({"T": T, "bytes": nbytes, "ms": ms,
                       "wrapper_ms": wrapper_ms, "bound_ms": bound_ms,
                       "plain_ms": plain_ms,
                       "roofline_pct": 100.0 * bound_ms / ms})
    row = {"name": "run_bounds", "route": "cuda",
           "source": "hyperspace_tpu_torch/csrc/run_bounds.cu",
           "replaces": "none (jax.lax.cummax/cummin, "
                       "hyperspace_tpu/ops/join.py:311-314)",
           "max_abs_err": worst, "ms": shapes[-1]["ms"],
           "plain_ms": shapes[-1]["plain_ms"],
           "bound_ms": shapes[-1]["bound_ms"], "bound_by": "bytes",
           "library_ms": None}
    emit("kernel_run_bounds", cases=len(cases) + len(shapes),
         max_abs_err=worst, tolerance=0, shapes=shapes)
    return row


def phase_transfer(card):
    """The transfer engine against one plain PyTorch copy, 512 MB each
    way: H2D from a pageable numpy array (the engine stages it through
    reused pinned buffers in 4 MiB chunks on a side stream) and D2H of a
    card tensor (the engine's prefetch into pinned memory, then fetch).
    GB/s from the median of 3 after one warm-up, each timed between
    synchronizes."""
    import statistics

    import numpy as np
    import torch

    from hyperspace_tpu_torch.io import transfer

    engine = transfer.get_engine()
    host = np.random.default_rng(SEED).integers(0, 1 << 62,
                                                TRANSFER_BYTES // 8)
    nbytes = host.nbytes

    def rate(fn):
        seconds, out = [], None
        for i in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            if i:
                seconds.append(time.perf_counter() - t0)
        return nbytes / statistics.median(seconds) / 1e9, out

    out = {"bytes": nbytes,
           "chunk_bytes": engine.chunk_bytes,
           "inflight_bytes": engine.inflight_bytes}
    out["engine_h2d_gbps"], dev = rate(lambda: engine.put(host, card))
    check(torch.equal(dev, torch.from_numpy(host).to(card)),
          "transfer: the engine's H2D copy differs")
    out["plain_h2d_gbps"], _ = rate(lambda: torch.from_numpy(host).to(card))

    def engine_d2h():
        engine.prefetch(dev)
        return engine.fetch(dev)

    out["engine_d2h_gbps"], back = rate(engine_d2h)
    check(np.array_equal(back, host), "transfer: the engine's D2H differs")
    out["plain_d2h_gbps"], _ = rate(lambda: dev.cpu())
    out["staging"] = {k: engine.stats[k] for k in (
        "staging_allocated", "staging_reused", "window_waits")}
    return out


def native_line(orders_dir):
    """The native library's build time, and the FNV-1a hash of TPC-H
    `o_comment`'s dictionary with the library and with the pure-Python
    loop, equal bit for bit."""
    import numpy as np
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import native
    from hyperspace_tpu_torch.io import columnar

    check(native.get_lib() is not None,
          "the native host library did not load")
    comments = pq.read_table(os.path.join(orders_dir, "part-0.parquet"),
                             columns=["o_comment"]).column("o_comment")
    dictionary = pc.unique(comments.combine_chunks())
    values = np.asarray(dictionary.to_numpy(zero_copy_only=False), dtype=str)
    t0 = time.perf_counter()
    fast = native.arrow_string_hash64(dictionary)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    slow = columnar.string_hash64_python(values)
    python_s = time.perf_counter() - t0
    check(np.array_equal(fast, slow),
          "native: o_comment hashes differ from the Python loop")
    return {"loaded": True, "library": native.library_path(),
            "build_s": native.build_seconds,
            "o_comment_dictionary": len(values),
            "native_hash_s": native_s, "python_hash_s": python_s}


def write_source(src_dir, n_rows=None):
    """bench.py's filter-rung schema at `n_rows` (default N_ROWS) rows,
    in N_FILES files."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    n_rows = N_ROWS if n_rows is None else n_rows
    rng = np.random.default_rng(SEED)
    cols = {
        "key": rng.integers(0, n_rows // 4, n_rows).astype(np.int64),
        "k2": rng.integers(0, 100, n_rows).astype(np.int64),
        "id": np.arange(n_rows, dtype=np.int64),
        "score": rng.random(n_rows).astype(np.float64),
    }
    os.makedirs(src_dir)
    step = -(-n_rows // N_FILES)
    for i in range(N_FILES):
        part = pa.table({k: v[i * step:(i + 1) * step]
                         for k, v in cols.items()})
        pq.write_table(part, os.path.join(src_dir, f"part-{i}.parquet"))
    return cols


def phase_build(hs, sess, src_dir, cols):
    import numpy as np
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import IndexConfig
    from hyperspace_tpu_torch.io.builder import BUILD_PHASES, build_lane

    registry = hs.metrics_registry()
    before = registry.counters_dict()
    df = sess.read_parquet(src_dir)
    t0 = time.perf_counter()
    hs.create_index(df, IndexConfig("smokeIdx", ["key"],
                                    ["k2", "id", "score"]))
    build_s = time.perf_counter() - t0
    after = registry.counters_dict()
    phases = {p: after.get(f"build.phase.{p}_s", 0.0)
              - before.get(f"build.phase.{p}_s", 0.0) for p in BUILD_PHASES}

    catalog = hs.indexes()
    (root,) = catalog[catalog["name"] == "smokeIdx"]["indexLocation"]
    files = sorted(f for f in os.listdir(root) if f.endswith(".parquet"))
    rows = 0
    for name in files:
        bucket = int(name[len("part-"):len("part-") + 5])
        key = pq.read_table(os.path.join(root, name),
                            columns=["key"]).column("key").to_numpy()
        rows += len(key)
        check((np_bucket_ids_int64(key, 200) == bucket).all(),
              f"{name}: a row hashes to another bucket")
        check((np.diff(key) >= 0).all(), f"{name}: keys not sorted")
    check(rows == len(cols["key"]), f"index holds {rows} rows")
    # The phases are walls on the calling thread: `decode` is the key
    # decode plus the wait for the payload-decode thread, `write` the
    # gathers plus the waits for the writer thread.
    emit("build", rows=rows, files=len(files), num_buckets=200,
         lane=build_lane(rows, sess.device), seconds=build_s,
         phase_seconds=phases, root=root)
    return df, root


def build_lanes(src_dir, card):
    """The build's two permutation engines on the filter rung's
    16,777,216 keys, 200 buckets: the native-host lane (the C++ radix
    sort; the JAX package's choice once its library loads) and the device
    lane (key H2D through the transfer engine, the hash kernel, the torch
    sort, the permutation's D2H). Both permutations must be equal; each
    lane is timed twice, in turns, after one warm-up each, best kept.
    Runs outside the counted phases: its launches are not the main
    path's."""
    import numpy as np
    import pyarrow.parquet as pq
    import torch

    from hyperspace_tpu_torch.io.builder import (_host_build_permutation,
                                                 _stage_key_tree)
    from hyperspace_tpu_torch.ops.build import permutation_from_tree

    keys = pq.read_table(sorted(
        os.path.join(src_dir, f) for f in os.listdir(src_dir)),
        columns=["key"])

    def native_lane():
        return _host_build_permutation(keys, ["key"], 200)[0]

    def device_lane():
        tree = _stage_key_tree(keys, ["key"], card)
        return permutation_from_tree(tree, ["key"], 200)[0].cpu().numpy()

    seconds = {"native-host": [], "device": []}
    perms = {}
    for lane in ("native-host", "device", "device", "native-host",
                 "native-host", "device"):
        fn = native_lane if lane == "native-host" else device_lane
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        perms[lane] = fn()
        torch.cuda.synchronize()
        seconds[lane].append(time.perf_counter() - t0)
    check(np.array_equal(perms["native-host"], perms["device"]),
          "build lanes: the native-host and device permutations differ")
    best = {lane: min(s[1:]) for lane, s in seconds.items()}
    return {"rows": keys.num_rows, "seconds": seconds, "best_s": best,
            "faster": min(best, key=best.get)}


# -- whole-stage fusion: every rung's queries fused and unfused -------------

FUSION_KEY = "spark.hyperspace.execution.fusion.enabled"
# One record per query the phases ran both ways (`fusion_turns`), by rung;
# the `fusion` line sums them.
FUSION = []


def same_result(a, b):
    """(equal, identical): two result tables hold the same rows — floats
    at rtol 1e-9, the port's float64 parity tolerance — and whether they
    are the same table byte for byte, row order included."""
    import pandas as pd

    if a.equals(b):
        return True, True
    if a.schema.names != b.schema.names or a.num_rows != b.num_rows:
        return False, False
    names = list(a.schema.names)

    def norm(t):
        return (t.to_pandas().sort_values(names, na_position="last")
                .reset_index(drop=True))

    try:
        pd.testing.assert_frame_equal(norm(a), norm(b), check_dtype=False,
                                      check_exact=False, rtol=1e-9,
                                      atol=0.0)
    except AssertionError:
        return False, False
    return True, False


def fusion_turns(rung, name, sess, frame, check_result, turn, rounds=2):
    """Run `frame` rules on with whole-stage fusion on and off, in turns:
    `rounds` runs each, ABBA (which side leads alternates with `turn`);
    each result goes through the phase's own oracle check
    `check_result(table, tag)`, and fused and unfused must hold the same
    rows. Prints one `fusion_query` line: each side's runs and its
    fastest, the fused run's stage count, fusion lanes, stage-sync
    seconds and `fusion.run_stage` / `fusion.finalize_lazy` device
    seconds."""
    sess.enable_hyperspace()
    lead = turn % 2 == 0
    order = [lead, not lead, not lead, lead][:2 * rounds]
    runs = {True: [], False: []}
    for fused in order:
        sess.conf.set(FUSION_KEY, "true" if fused else "false")
        try:
            t0 = time.perf_counter()
            table, metrics = frame.collect(with_metrics=True)
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            sess.conf.unset(FUSION_KEY)
        check_result(table, f"{rung} {name} fusion={'on' if fused else 'off'}")
        runs[fused].append((ms, table, metrics))
    equal, identical = same_result(runs[True][0][1], runs[False][0][1])
    check(equal, f"{rung} {name}: fused and unfused results differ")
    m = runs[True][-1][2]
    c = m.counters
    line = {"rung": rung, "name": name,
            "fused_ms": min(r[0] for r in runs[True]),
            "unfused_ms": min(r[0] for r in runs[False]),
            "fused_runs_ms": [r[0] for r in runs[True]],
            "unfused_runs_ms": [r[0] for r in runs[False]],
            "rows": runs[True][0][1].num_rows,
            "stages": sum(o.name == "FusedStage" for o in m.operators),
            "fusion_lanes": m.summary()["fusion_lanes"],
            "sync_s": c.get("fusion.sync_s", 0.0),
            "run_stage_s": c.get("device.fusion.run_stage.dispatch_s", 0.0),
            "finalize_s": c.get("device.fusion.finalize_lazy.dispatch_s",
                                0.0),
            "unfused_stages": sum(o.name == "FusedStage"
                                  for o in runs[False][-1][2].operators),
            "identical": identical}
    check(line["unfused_stages"] == 0,
          f"{rung} {name}: fusion off still ran fused stages")
    emit("fusion_query", **line)
    FUSION.append(line)
    return line


def fusion_summary():
    """The `fusion` line: per rung, the fused and unfused sums and how
    many queries got faster and slower fused. A record, not a speed
    gate; it fails only if a rung is missing or no stage ran masked."""
    rungs = {}
    for q in FUSION:
        r = rungs.setdefault(q["rung"], {
            "queries": 0, "fused_ms": 0.0, "unfused_ms": 0.0, "faster": 0,
            "slower": 0, "identical": 0, "stages": 0, "masked_device": 0,
            "sync_s": 0.0, "run_stage_s": 0.0})
        r["queries"] += 1
        r["fused_ms"] += q["fused_ms"]
        r["unfused_ms"] += q["unfused_ms"]
        r["faster"] += q["fused_ms"] < q["unfused_ms"]
        r["slower"] += q["fused_ms"] > q["unfused_ms"]
        r["identical"] += q["identical"]
        r["stages"] += q["stages"]
        r["masked_device"] += q["fusion_lanes"].get("masked-device", 0)
        r["sync_s"] += q["sync_s"]
        r["run_stage_s"] += q["run_stage_s"]
    check(rungs.get("tpch", {}).get("queries") == 22
          and rungs.get("tpcds", {}).get("queries") == 99
          and {"filter", "join", "hybrid"} <= set(rungs),
          f"fusion: rungs {sorted((k, v['queries']) for k, v in rungs.items())}")
    masked = sum(r["masked_device"] for r in rungs.values())
    check(masked > 0, "fusion: no stage ran on the masked device lane")
    return {"rungs": rungs, "queries": len(FUSION),
            "faster": sum(r["faster"] for r in rungs.values()),
            "slower": sum(r["slower"] for r in rungs.values()),
            "masked_device_stages": masked}


def phase_query(sess, df, root, cols):
    import numpy as np

    from hyperspace_tpu_torch import col, lit

    sess.enable_hyperspace()
    key_hit = int(cols["key"][0])
    point = (df.filter((col("key") == lit(key_hit)) & (col("k2") < lit(50)))
             .select("id", "score"))
    scan = (df.filter((col("key") >= lit(0)) & (col("k2") < lit(50)))
            .select("id", "score"))
    out = {}
    for name, frame, mask in (
            ("point", point, (cols["key"] == key_hit) & (cols["k2"] < 50)),
            ("range", scan, cols["k2"] < 50)):
        roots = [p for leaf in sess.optimize(frame.plan).collect_leaves()
                 for p in leaf.root_paths]
        check(roots and all(r.startswith(root) and "v__=" in r
                            for r in roots),
              f"{name} query not index-served: {roots}")
        table, metrics = frame.collect(with_metrics=True)
        (op,) = [o for o in metrics.operators if o.name == "Scan"]
        want = np.nonzero(mask)[0]

        def check_rows(table, tag, want=want):
            ids = table.column("id").to_numpy()
            order = np.argsort(ids)
            check(np.array_equal(ids[order], want), f"{tag}: wrong rows")
            check(np.array_equal(table.column("score").to_numpy()[order],
                                 cols["score"][want]), f"{tag}: wrong scores")

        check_rows(table, name)
        ids = table.column("id").to_numpy()
        warm = wall_ms(frame.collect)
        if name == "range":
            fusion_turns("filter", name, sess, frame, check_rows, 0)
        out[name] = {"rows": len(ids), "lane": op.detail.get("lane"),
                     "buckets_scanned": op.detail.get("buckets_scanned"),
                     "warm_ms": warm}
    check(out["point"]["lane"] == "host" and out["range"]["lane"] == "device",
          f"unexpected lanes: {out}")
    emit("query", **out)


def right_columns(seed, n_rows=N_ROWS):
    """bench.py's join right side for a left side of `n_rows` rows:
    `key` int64 uniform in [0, n_rows/4) (the left key's range), `val`
    float64; n_rows/2 rows (N_RIGHT at the default)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {"key": rng.integers(0, n_rows // 4, n_rows // 2)
            .astype(np.int64), "val": rng.random(n_rows // 2)}


def write_right_source(src_dir, seed, n_rows=N_ROWS):
    """`right_columns(seed, n_rows)` in N_FILES files."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    cols = right_columns(seed, n_rows)
    os.makedirs(src_dir)
    step = -(-len(cols["key"]) // N_FILES)
    for i in range(N_FILES):
        pq.write_table(pa.table({k: v[i * step:(i + 1) * step]
                                 for k, v in cols.items()}),
                       os.path.join(src_dir, f"part-{i}.parquet"))
    return cols


def np_join(left, right):
    """numpy oracle of `left JOIN right USING (key)` -> (id, val): the
    right rows grouped by key (a stable argsort), each key's run found by
    direct address (keys are small and non-negative), runs expanded per
    left row."""
    import numpy as np

    counts = np.bincount(right["key"],
                         minlength=int(left["key"].max()) + 1)
    starts = np.cumsum(counts) - counts
    order = np.argsort(right["key"], kind="stable")
    per_left = counts[left["key"]]
    li = np.repeat(np.arange(len(per_left)), per_left)
    first = np.cumsum(per_left) - per_left
    pos = starts[left["key"]][li] + np.arange(len(li)) - first[li]
    return left["id"][li], right["val"][order[pos]]


def canonical(ids, vals, device="cuda"):
    """(id, val) pairs in one order — sorted by id, then val — as tensors
    on `device` (two stable sorts of ~33.5M rows)."""
    import torch

    import numpy as np

    ids = torch.from_numpy(np.require(ids, requirements="W")).to(device)
    vals = torch.from_numpy(np.require(vals, requirements="W")).to(device)
    perm = torch.sort(vals, stable=True).indices
    perm = perm[torch.sort(ids[perm], stable=True).indices]
    return ids[perm], vals[perm]


def operator_ms(metrics):
    """Each operator of one collect, in plan pre-order: its wall ms on the
    recorder's host clock (children included), its own ms (children's
    walls subtracted), rows out and lane."""
    children_s = {}
    for o in metrics.operators:
        children_s[o.parent_id] = children_s.get(o.parent_id, 0.0) + o.wall_s
    return [{"op": o.name, "ms": o.wall_s * 1e3,
             "self_ms": (o.wall_s - children_s.get(o.op_id, 0.0)) * 1e3,
             "rows": o.rows_out,
             **({"lane": o.detail["lane"]} if "lane" in o.detail else {})}
            for o in metrics.operators]


def phase_join(hs, sess, df, work, cols):
    """Queries A (equal bucket counts) and B (64 vs 200 buckets: the right
    side re-bucketed through the Exchange), each against the numpy oracle
    and against the same query with Hyperspace disabled."""
    import torch

    from hyperspace_tpu_torch import IndexConfig
    from hyperspace_tpu_torch.engine.physical import plan_physical
    from hyperspace_tpu_torch.ops.cuda import partition_kernel

    left = {"key": cols["key"], "id": cols["id"]}
    out = {}
    rights = {}
    for name, buckets, seed in (("A", 200, SEED + 2), ("B", 64, SEED + 3)):
        t0 = time.perf_counter()
        src = os.path.join(work, f"right{buckets}")
        right = write_right_source(src, seed)
        source_s = time.perf_counter() - t0
        rdf = sess.read_parquet(src)
        rights[buckets] = (rdf, right)
        sess.conf.set("spark.hyperspace.index.num.buckets", str(buckets))
        t0 = time.perf_counter()
        hs.create_index(rdf, IndexConfig(f"smokeRight{buckets}", ["key"],
                                         ["val"]))
        build_s = time.perf_counter() - t0
        frame = (df.select("key", "id")
                 .join(rdf.select("key", "val"), on="key")
                 .select("id", "val"))

        sess.enable_hyperspace()
        plan = sess.optimize(frame.plan)
        roots = [p for leaf in plan.collect_leaves() for p in leaf.root_paths]
        check(len(roots) == 2 and all("v__=" in r for r in roots),
              f"query {name} not index-served: {roots}")
        tree = plan_physical(plan, conf=sess.conf).tree_string()
        exchange = f"Exchange hashpartitioning(key, {EXCHANGE_BUCKETS})"
        check(exchange in tree if buckets != EXCHANGE_BUCKETS
              else "Exchange" not in tree,
              f"query {name}: unexpected plan\n{tree}")
        launches = partition_kernel.partition_ids_and_histogram.launches
        warm = wall_ms(frame.collect)
        # Operator times of a warm run (the recorder's host clock).
        table, metrics = frame.collect(with_metrics=True)
        launched = (partition_kernel.partition_ids_and_histogram.launches
                    - launches)
        check((launched > 0) == (buckets != EXCHANGE_BUCKETS),
              f"query {name}: partition kernel launched {launched} times")
        got = canonical(table.column("id").to_numpy(),
                        table.column("val").to_numpy())
        t0 = time.perf_counter()
        want = canonical(*np_join(left, right))
        oracle_s = time.perf_counter() - t0
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"query {name}: rows differ from numpy")
        ops = operator_ms(metrics)

        def check_rows(table, tag, want=want):
            check(all(torch.equal(a, b) for a, b in zip(
                canonical(table.column("id").to_numpy(),
                          table.column("val").to_numpy()), want)),
                  f"{tag}: rows differ from numpy")

        fusion_turns("join", name, sess, frame, check_rows,
                     buckets == EXCHANGE_BUCKETS, rounds=1)

        sess.disable_hyperspace()
        plain = frame.collect()
        check(all(torch.equal(a, b) for a, b in zip(
            canonical(plain.column("id").to_numpy(),
                      plain.column("val").to_numpy()), got)),
              f"query {name}: rows differ with Hyperspace disabled")
        lanes = [o["lane"] for o in ops if o["op"] == "Scan"]
        check(lanes == ["device", "device"], f"query {name}: lanes {lanes}")
        out[name] = {"right_buckets": buckets, "rows": table.num_rows,
                     "wall_ms": warm, "scan_lanes": lanes,
                     "partition_launches": launched, "operators": ops,
                     "right_source_s": source_s, "right_build_s": build_s,
                     "oracle_s": oracle_s}
    sess.conf.set("spark.hyperspace.index.num.buckets", "200")
    return out, rights[EXCHANGE_BUCKETS]


def plan_unions(plan):
    from hyperspace_tpu_torch.plan.nodes import Union

    found = []
    plan.transform_up(lambda n: (found.append(n), n)[1]
                      if isinstance(n, Union) else n)
    return len(found)


def pairs(table):
    """(id, val) of a join result, a null id (an outer join's unmatched
    row) as -1."""
    import pyarrow.compute as pc

    return (pc.fill_null(table.column("id"), -1).to_numpy(),
            table.column("val").to_numpy())


def left_outer_oracle(inner, right, hyb):
    """numpy oracle of `right LEFT OUTER JOIN hyb USING (key)` ->
    (id, val): the `inner` join's pairs, then each right row whose key no
    hyb row holds, with id -1."""
    import numpy as np

    ids, vals = inner
    held = np.bincount(hyb["key"], minlength=N_ROWS // 4) > 0
    lone = ~held[right["key"]]
    return (np.concatenate([ids, np.full(int(lone.sum()), -1)]),
            np.concatenate([vals, right["val"][lone]]))


def phase_hybrid(hs, sess, work, cols, right_df, right):
    """Hybrid scan over an index whose source grew by one 4,194,304-row
    file, then the incremental refresh that catches it up."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq
    import torch

    from hyperspace_tpu_torch import IndexConfig, col, lit
    from hyperspace_tpu_torch.engine.physical import plan_physical
    from hyperspace_tpu_torch.ops.cuda import (hash_kernel, partition_kernel,
                                               run_bounds_kernel)

    src = os.path.join(work, "hyb_src")
    os.makedirs(src)
    for name in sorted(os.listdir(os.path.join(work, "src"))):
        os.link(os.path.join(work, "src", name), os.path.join(src, name))
    t0 = time.perf_counter()
    hs.create_index(sess.read_parquet(src),
                    IndexConfig("hyb", ["key"], ["k2", "id", "score"]))
    build_s = time.perf_counter() - t0
    # bench.py's rung-4 append (schema and distributions), at N_APPEND rows.
    rng = np.random.default_rng(SEED + 4)
    app = {"key": rng.integers(0, N_ROWS // 4, N_APPEND).astype(np.int64),
           "k2": rng.integers(0, 100, N_APPEND).astype(np.int64),
           "id": np.arange(N_ROWS, N_ROWS + N_APPEND, dtype=np.int64),
           "score": rng.random(N_APPEND)}
    pq.write_table(pa.table(app), os.path.join(src, "part-append.parquet"))
    sess.conf.set("spark.hyperspace.index.hybridscan.enabled", "true")
    hyb = {k: np.concatenate([cols[k], app[k]]) for k in app}

    key_hit = int(cols["key"][0])
    hdf = sess.read_parquet(src)
    frames = {
        "H1": hdf.filter(col("key") == lit(key_hit)).select("id", "score"),
        "H2": (hdf.select("key", "id")
               .join(right_df.select("key", "val"), on="key")
               .select("id", "val")),
        "H3": (right_df.select("key", "val")
               .join(hdf.select("key", "id"), on="key", how="left_outer")
               .select("id", "val")),
    }
    t0 = time.perf_counter()
    mask = hyb["key"] == key_hit
    inner = np_join(hyb, right)
    want = {"H1": (hyb["id"][mask], hyb["score"][mask]),
            "H2": canonical(*inner),
            "H3": canonical(*left_outer_oracle(inner, right, hyb))}
    oracle_s = time.perf_counter() - t0

    def check_rows(name, table):
        if name == "H1":
            ids = table.column("id").to_numpy()
            order = np.argsort(ids)
            ok = (np.array_equal(ids[order], np.sort(want[name][0]))
                  and np.array_equal(
                      table.column("score").to_numpy()[order],
                      want[name][1][np.argsort(want[name][0])]))
        else:
            ok = all(torch.equal(a, b) for a, b in zip(
                canonical(*pairs(table)), want[name]))
        check(ok, f"hybrid {name}: rows differ from numpy")

    out = {"hyb_build_s": build_s, "appended_rows": N_APPEND,
           "oracle_s": oracle_s}
    for name, frame in frames.items():
        sess.enable_hyperspace()
        plan = sess.optimize(frame.plan)
        check(plan_unions(plan) == 1, f"hybrid {name}: no Union in the plan")
        tree = plan_physical(plan, conf=sess.conf).tree_string()
        launches = partition_kernel.partition_ids_and_histogram.launches
        warm = wall_ms(frame.collect)
        table, metrics = frame.collect(with_metrics=True)
        launched = (partition_kernel.partition_ids_and_histogram.launches
                    - launches)
        check((launched > 0) == (name == "H3"),
              f"hybrid {name}: partition kernel launched {launched} times")
        check_rows(name, table)
        if name == "H3":
            fusion_turns("hybrid", name, sess, frame,
                         lambda t, _tag: check_rows("H3", t), 0, rounds=1)
        if name != "H1":
            sess.disable_hyperspace()
            check(all(torch.equal(a, b) for a, b in zip(
                canonical(*pairs(frame.collect())), want[name])),
                  f"hybrid {name}: rows differ with Hyperspace disabled")
        out[name] = {"rows": table.num_rows, "wall_ms": warm,
                     "collect_ms": metrics.wall_s * 1e3,
                     "partition_launches": launched,
                     "exchanges": tree.count("Exchange"),
                     "operators": operator_ms(metrics)}

    sess.enable_hyperspace()
    hashes = hash_kernel.hash_lanes_to_buckets
    hash_before = hashes.launches
    t0 = time.perf_counter()
    hs.refresh_index("hyb", mode="incremental")
    out["incremental_refresh_s"] = time.perf_counter() - t0
    out["refresh_hash_launches"] = hashes.launches - hash_before
    check(out["refresh_hash_launches"] > 0,
          "the incremental refresh's delta did not launch the hash kernel")
    v1 = os.path.join(sess.conf.system_path, "hyb", "v__=1")
    deltas = [f for f in os.listdir(v1) if "-delta1" in f]
    check(deltas, "the incremental refresh wrote no -delta files")
    out["delta_files"] = len(deltas)
    for name, frame in frames.items():
        plan = sess.optimize(frame.plan)
        check(plan_unions(plan) == 0,
              f"hybrid {name}: a Union after the refresh")
        table, metrics = frame.collect(with_metrics=True)
        check_rows(name, table)
        out[name]["after_refresh_ms"] = metrics.wall_s * 1e3
    return out


def _same_bytes(dir_a, dir_b):
    """Every parquet file of two version dirs, name for name and byte for
    byte; returns the file count."""
    names = sorted(f for f in os.listdir(dir_a) if f.endswith(".parquet"))
    check(names and names == sorted(f for f in os.listdir(dir_b)
                                    if f.endswith(".parquet")),
          f"{dir_a} and {dir_b} hold different files")
    for f in names:
        with open(os.path.join(dir_a, f), "rb") as a, \
                open(os.path.join(dir_b, f), "rb") as b:
            check(a.read() == b.read(), f"{f}: {dir_a} != {dir_b}")
    return len(names)


def phase_maintenance(hs, sess, work):
    """bench.py's rung 5 at half its size: incremental refresh, optimize
    and full refresh of a 4,194,304-row index, then the lifecycle verbs.
    After every verb a point lookup (host lane, then device lane) must
    read the newest committed version — or the source, once the index is
    gone — and equal numpy over the source; the FSM's cache-invalidation
    counter must have moved (restore writes no data, so it moves none)."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import IndexConfig, col, lit
    from hyperspace_tpu_torch import telemetry

    src = os.path.join(work, "maint_src")
    os.makedirs(src)
    rng = np.random.default_rng(SEED + 5)
    written = {}

    def write(name, n):
        key = rng.integers(0, N_MAINT // 4, n).astype(np.int64)
        score = rng.random(n)
        written[name] = (key, score)
        pq.write_table(pa.table({"key": key, "score": score}),
                       os.path.join(src, name))

    write("part-0.parquet", N_MAINT)
    root = os.path.join(sess.conf.system_path, "bench_opt")
    registry = telemetry.get_registry()
    checks = []

    def timed(fn, *args, **kwargs):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        return time.perf_counter() - t0

    def point_check(verb, before):
        """The newest rows of one key through the rules, against numpy."""
        newest = sorted(written)[-1]
        probe = int(written[newest][0][0])
        want = np.sort(np.concatenate(
            [score[key == probe] for key, score in written.values()]))
        catalog = hs.indexes()
        live = ({loc for loc, state in zip(catalog["indexLocation"],
                                           catalog["state"])
                 if state == "ACTIVE"} if len(catalog) else set())
        moved = registry.counter("cache.invalidations").value - before
        check(moved > 0 or verb in ("create", "restore"),
              f"maintenance {verb}: no cache invalidation")
        sess.enable_hyperspace()
        roots = []
        for min_rows in (None, "0"):
            if min_rows is not None:
                sess.conf.set(
                    "spark.hyperspace.execution.min.device.rows", min_rows)
            frame = (sess.read_parquet(src)
                     .filter(col("key") == lit(probe)).select("score"))
            roots = [r for leaf in sess.optimize(frame.plan)
                     .collect_leaves() for r in leaf.root_paths]
            got = np.sort(frame.collect().column("score").to_numpy())
            check(np.array_equal(got, want),
                  f"maintenance {verb}: {len(got)} rows, want {len(want)}")
        sess.conf.unset("spark.hyperspace.execution.min.device.rows")
        index_roots = [r for r in roots if "v__=" in r]
        check(all(r.rstrip("/") in live for r in index_roots),
              f"maintenance {verb}: read {index_roots}, newest {live}")
        checks.append({"verb": verb, "rows": len(want),
                       "index": bool(index_roots),
                       "invalidations": moved})

    def verb(name, fn, *args, **kwargs):
        before = registry.counter("cache.invalidations").value
        seconds = timed(fn, *args, **kwargs)
        point_check(name, before)
        return seconds

    out = {"create_s": verb("create", hs.create_index,
                            sess.read_parquet(src),
                            IndexConfig("bench_opt", ["key"], ["score"]))}
    inc, opt = [], []
    for i in range(3):
        write(f"part-extra{i}.parquet", N_MAINT_APPEND)
        inc.append(verb("incremental refresh", hs.refresh_index,
                        "bench_opt", mode="incremental"))
        opt.append(verb("optimize", hs.optimize_index, "bench_opt"))
        lane = registry.last_action_report()["detail"]["lane"]
        check(lane == "merge", f"optimize {i} took the {lane} lane")
    full = [verb("full refresh", hs.refresh_index, "bench_opt", mode="full")
            for _ in range(2)]
    # v__=0 create; v__=1..6 three (incremental, optimize) rounds;
    # v__=7, v__=8 the full refreshes over the same source.
    files = _same_bytes(os.path.join(root, "v__=6"),
                        os.path.join(root, "v__=7"))
    out.update(incremental_s=inc, optimize_merge_s=opt, full_refresh_s=full,
               best_incremental_s=min(inc), best_optimize_merge_s=min(opt),
               best_full_refresh_s=min(full), byte_equal_files=files)

    # The composite key takes no merge fast path: its optimize sorts every
    # bucket on the device.
    out["composite_create_s"] = timed(
        hs.create_index, sess.read_parquet(src),
        IndexConfig("bench_opt2", ["key", "score"], []))
    write("part-extra3.parquet", N_MAINT_APPEND)
    out["composite_incremental_s"] = timed(
        hs.refresh_index, "bench_opt2", mode="incremental")
    out["optimize_device_s"] = timed(hs.optimize_index, "bench_opt2")
    lane = registry.last_action_report()["detail"]["lane"]
    check(lane == "device", f"the composite optimize took the {lane} lane")
    out["composite_full_refresh_s"] = timed(hs.refresh_index, "bench_opt2",
                                            mode="full")
    root2 = os.path.join(sess.conf.system_path, "bench_opt2")
    out["composite_byte_equal_files"] = _same_bytes(
        os.path.join(root2, "v__=2"), os.path.join(root2, "v__=3"))
    hs.delete_index("bench_opt2")
    hs.vacuum_index("bench_opt2")

    # bench_opt catches up with the composite rounds' append, so the
    # restored index serves again.
    verb("full refresh", hs.refresh_index, "bench_opt", mode="full")
    for name in ("delete", "restore", "delete", "vacuum"):
        verb(name, getattr(hs, f"{name}_index"), "bench_opt")
    left = ([d for d in os.listdir(root) if d.startswith("v__=")]
            if os.path.isdir(root) else [])
    check(not left, f"vacuum left version dirs of bench_opt: {left}")
    catalog = hs.indexes()
    check("bench_opt" not in list(catalog.get("name", [])),
          "bench_opt is still listed after vacuum")
    check([c["index"] for c in checks[-4:]] == [False, True, False, False],
          f"maintenance: lifecycle reads {checks[-4:]}")
    out["checks"] = checks
    return out


# The covering indexes each TPC-H rules-on plan reads, as in the JAX
# package: the joins whose two sides are linear and covered. The other
# queries join a non-linear side, or need a lineitem column that no index
# includes (q1/q6's bare Filter(Scan) under their aggregate is judged on
# every lineitem column, which no index covers).
TPCH_INDEXES_READ = {
    "q10": ["tpch_li_ord", "tpch_ord_key"],
    "q18": ["tpch_li_ord", "tpch_ord_key"],
    "q14": ["tpch_li_part", "tpch_part_key"],
    "q17": ["tpch_li_part", "tpch_part_key"],
    "q19": ["tpch_li_part", "tpch_part_key"],
}


def _ipc_bytes(table):
    import pyarrow as pa

    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as writer:
        writer.write_table(table)
    return sink.getvalue().to_pybytes()


def phase_tpch(hs, sess, work):
    """The 22 TPC-H queries at SF1 row counts on the card, rules on and
    off, against the pandas oracle. Returns the phase summary; prints one
    line per query."""
    import statistics

    import pandas as pd
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch.tpch import QUERIES, generate
    from hyperspace_tpu_torch.tpch.queries import (create_indexes,
                                                   normalize_result)

    t0 = time.perf_counter()
    paths = generate(os.path.join(work, "tpch"), scale=TPCH_SCALE)
    generate_s = time.perf_counter() - t0
    emit("native", **native_line(paths["orders"]))
    out = {"generate_s": generate_s,
           "table_rows": {name: pq.ParquetFile(
               os.path.join(p, "part-0.parquet")).metadata.num_rows
               for name, p in paths.items()}}
    sess.conf.set("spark.hyperspace.execution.min.device.rows", "0")
    dfs = {name: sess.read_parquet(path) for name, path in paths.items()}
    t0 = time.perf_counter()
    create_indexes(hs, dfs)
    out["create_indexes_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pdfs = {name: pq.read_table(os.path.join(p, "part-0.parquet"))
            .to_pandas() for name, p in paths.items()}
    out["pandas_load_s"] = time.perf_counter() - t0

    def same(got, want, tag):
        check(list(got.columns) == list(want.columns),
              f"{tag}: columns {list(got.columns)}")
        try:
            pd.testing.assert_frame_equal(
                normalize_result(got), normalize_result(want),
                check_dtype=False, check_exact=False, rtol=1e-6, atol=1e-9)
        except AssertionError as exc:
            fail(f"{tag}: differs from the pandas oracle: {exc}")

    oracle_s = 0.0
    queries = {}
    passes = {p: {} for p in PASSES}
    for turn, (name, (build, oracle)) in enumerate(QUERIES.items()):
        t0 = time.perf_counter()
        expected = oracle(pdfs)
        oracle_s += time.perf_counter() - t0
        check(len(expected) > 0, f"tpch {name}: the oracle returned no rows")
        run = pass_runner(hs, sess, passes, f"tpch {name}",
                          lambda table, tag: same(table.to_pandas(),
                                                  expected, tag))
        cold_on_ms, _, _ = run("cold_on", build(dfs))
        cold_off_ms, _, _ = run("cold_off", build(dfs))
        off_ms, _, _ = run("warm_off", build(dfs))

        sess.enable_hyperspace()
        frame = build(dfs)
        read = sorted({leaf.index_name for leaf in
                       sess.optimize(frame.plan).collect_leaves()
                       if leaf.index_name})
        check(read == TPCH_INDEXES_READ.get(name, []),
              f"tpch {name}: the rules-on plan reads {read}")
        run("warm_up", frame)
        runs = [run("warm_on", frame) for _ in range(2)]
        on_ms = statistics.median(ms for ms, _, _ in runs)
        _, table, metrics = runs[-1]
        host_ops = sorted({o.name for o in metrics.operators
                           if o.name in ("Aggregate", "SortMergeJoin")
                           and o.detail.get("lane") == "host"})
        check(not host_ops, f"tpch {name}: {host_ops} ran on a host batch")
        if name == "q1":
            check(_ipc_bytes(runs[0][1]) == _ipc_bytes(runs[1][1]),
                  "tpch q1: two rules-on runs gave different bytes")
        fusion_turns("tpch", name, sess, frame,
                     lambda table, tag: same(table.to_pandas(), expected,
                                             tag), turn)

        ops = sorted(operator_ms(metrics), key=lambda o: -o["self_ms"])
        line = {"name": name, "rows": table.num_rows, "on_ms": on_ms,
                "off_ms": off_ms, "cold_on_ms": cold_on_ms,
                "cold_off_ms": cold_off_ms, "indexes": read,
                "device_share": metrics.roofline["device_share"],
                "dominant": metrics.critical_path["dominant"],
                "top_operators": [{"op": o["op"], "self_ms": o["self_ms"]}
                                  for o in ops[:3]]}
        emit("tpch_query", **line)
        queries[name] = line
    sess.conf.unset("spark.hyperspace.execution.min.device.rows")
    out.update(oracle_s=oracle_s, passes=passes,
               **totals(queries, ("on_ms", "off_ms", "cold_on_ms",
                                  "cold_off_ms")),
               slowest_on=sorted(queries,
                                 key=lambda q: -queries[q]["on_ms"])[:5])
    return out


# The four timed passes over each TPC query (and the warm-up, which fills
# the caches for the warm rules-on pass): cold passes start from empty
# caches; warm passes find what the same query's previous run left.
PASSES = ("cold_on", "cold_off", "warm_off", "warm_up", "warm_on")


def pass_runner(hs, sess, passes, tag, same):
    """A function that runs one frame in one pass — emptying every read
    cache first for a cold pass, rules on or off as the pass names —
    checks its result with `same(table, tag)` and adds the pass's `cache.*`
    and `link.h2d.*` counter deltas to `passes`. Returns (ms, table,
    metrics)."""
    from hyperspace_tpu_torch.io import parquet, segcache

    registry = hs.metrics_registry()

    def run(pass_name, frame):
        if pass_name.startswith("cold"):
            parquet.clear_read_cache()
            segcache.clear()
        if pass_name.endswith("_off"):
            sess.disable_hyperspace()
        else:
            sess.enable_hyperspace()
        before = registry.counters_dict()
        t0 = time.perf_counter()
        table, metrics = frame.collect(with_metrics=True)
        ms = (time.perf_counter() - t0) * 1e3
        add_deltas(passes[pass_name],
                   counter_deltas(before, registry.counters_dict()))
        same(table, f"{tag} {pass_name}")
        return ms, table, metrics

    return run


def totals(queries, keys):
    return {f"{k}_total": sum(q[k] for q in queries.values()) for k in keys}


# The covering indexes each TPC-DS rules-on plan reads (its scalar
# subqueries' plans included), as the JAX package's optimized plans read
# them; a CPU test (`tests/test_torch_tpcds_base.py`) holds this table
# against them. Queries not listed read no index.
_DD_SS = ["idx_dd_datesk", "idx_ss_date"]
_CS_DD = ["idx_cs_date", "idx_dd_datesk"]
_CS_DD_SS = ["idx_cs_date", "idx_dd_datesk", "idx_ss_date"]
_RET = ["idx_sr_ret", "idx_ss_ret"]
_HD = ["idx_hd_demo", "idx_ss_hdemo"]
TPCDS_INDEXES_READ = {
    **{q: _DD_SS for q in (
        "q3", "q6", "q7", "q8", "q11", "q13", "q19", "q23", "q31", "q33",
        "q34", "q36", "q42", "q43", "q46", "q48", "q52", "q53", "q55", "q56",
        "q60", "q61", "q63", "q65", "q67", "q68", "q70", "q73", "q74", "q79",
        "q89", "q98")},
    **{q: _CS_DD for q in ("q15", "q20", "q26", "q32")},
    **{q: _CS_DD_SS for q in ("q10", "q35", "q69", "q97")},
    **{q: _RET for q in ("q25", "q29", "q50")},
    "q17": ["idx_dd_quarter", "idx_sr_ret", "idx_ss_ret"],
    "q64": ["idx_cr_order", "idx_cs_order"],
    **{q: _HD for q in ("q88", "q96")},
    **{q: ["idx_dd_datesk"] for q in (
        "q5", "q16", "q21", "q37", "q40", "q77", "q80", "q82", "q94",
        "q95")},
}
# Queries whose pandas oracle returns no rows at TPCDS_SCALE: q75 keeps
# the item groups whose sales shrank by over 10 % from 1999 to 2000, and
# at 2.9M `store_sales` rows the generator's yearly totals no longer vary
# that much (at the tests' scale 0.05 they do). The port must return no
# rows too, rules on and off.
TPCDS_EMPTY_AT_SCALE = {"q75"}
# Operators that must run on the card in the tpcds phase.
TPCDS_DEVICE_OPERATORS = ("Window", "Intersect", "Except", "Aggregate",
                          "SortMergeJoin")


def indexes_read(plan):
    """Names of the indexes a logical plan reads, its scalar subqueries'
    plans included."""
    from hyperspace_tpu_torch.engine.executor import _scalar_subqueries

    names = {leaf.index_name for leaf in plan.collect_leaves()
             if leaf.index_name}
    for sub in _scalar_subqueries(plan):
        names |= indexes_read(sub.execution_plan())
    return names


def phase_tpcds(hs, sess, work):
    """The 99 TPC-DS queries at SF1 fact-table row counts on the card,
    rules on and off, against the pandas oracle. Returns the phase
    summary; prints one line per query."""
    import pandas as pd
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch.tpcds import QUERIES, generate
    from hyperspace_tpu_torch.tpcds.queries import create_indexes

    phase_t0 = t0 = time.perf_counter()
    paths = generate(os.path.join(work, "tpcds"), scale=TPCDS_SCALE)
    out = {"scale": TPCDS_SCALE, "generate_s": time.perf_counter() - t0,
           "table_rows": {name: pq.ParquetFile(
               os.path.join(p, "part-0.parquet")).metadata.num_rows
               for name, p in paths.items()}}
    sess.conf.set("spark.hyperspace.execution.min.device.rows", "0")
    dfs = {name: sess.read_parquet(path) for name, path in paths.items()}
    t0 = time.perf_counter()
    create_indexes(hs, dfs)
    out["create_indexes_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pdfs = {name: pq.read_table(os.path.join(p, "part-0.parquet"))
            .to_pandas() for name, p in paths.items()}
    out["pandas_load_s"] = time.perf_counter() - t0

    def norm(df):
        df = df.sort_values(list(df.columns)).reset_index(drop=True)
        return df.astype({c: "float64" for c in df.columns
                          if df[c].dtype.kind in "fi"})

    def same(got, want, tag):
        check(list(got.columns) == list(want.columns),
              f"{tag}: columns {list(got.columns)}")
        try:
            pd.testing.assert_frame_equal(
                norm(got), norm(want), check_dtype=False,
                check_exact=False, rtol=1e-6, atol=1e-9)
        except AssertionError as exc:
            fail(f"{tag}: differs from the pandas oracle: {exc}")

    oracle_s = 0.0
    queries = {}
    passes = {p: {} for p in PASSES}
    for turn, (name, (build, oracle)) in enumerate(QUERIES.items()):
        t0 = time.perf_counter()
        expected = oracle(pdfs)
        oracle_s += time.perf_counter() - t0
        check((len(expected) > 0) != (name in TPCDS_EMPTY_AT_SCALE),
              f"tpcds {name}: the oracle returned {len(expected)} rows")
        run = pass_runner(hs, sess, passes, f"tpcds {name}",
                          lambda table, tag: same(table.to_pandas(),
                                                  expected, tag))
        cold_on_ms, _, _ = run("cold_on", build(dfs))
        cold_off_ms, _, _ = run("cold_off", build(dfs))
        off_ms, _, _ = run("warm_off", build(dfs))

        sess.enable_hyperspace()
        run("warm_up", build(dfs))
        frame = build(dfs)
        read = sorted(indexes_read(sess.optimize(frame.plan)))
        check(read == TPCDS_INDEXES_READ.get(name, []),
              f"tpcds {name}: the rules-on plan reads {read}")
        hits0 = passes["warm_on"].get("cache.segments.hits", 0)
        on_ms, table, metrics = run("warm_on", frame)
        host_ops = sorted({o.name for o in metrics.operators
                           if o.name in TPCDS_DEVICE_OPERATORS
                           and o.detail.get("lane") == "host"})
        check(not host_ops, f"tpcds {name}: {host_ops} ran on a host batch")
        fusion_turns("tpcds", name, sess, frame,
                     lambda table, tag: same(table.to_pandas(), expected,
                                             tag), turn)

        ops = sorted(operator_ms(metrics), key=lambda o: -o["self_ms"])
        line = {"name": name, "rows": table.num_rows, "on_ms": on_ms,
                "off_ms": off_ms, "cold_on_ms": cold_on_ms,
                "cold_off_ms": cold_off_ms, "indexes": read,
                "warm_segment_hits": passes["warm_on"].get(
                    "cache.segments.hits", 0) - hits0,
                "device_share": metrics.roofline["device_share"],
                "dominant": metrics.critical_path["dominant"],
                "top_operators": [{"op": o["op"], "self_ms": o["self_ms"]}
                                  for o in ops[:3]]}
        emit("tpcds_query", **line)
        queries[name] = line
    sess.conf.unset("spark.hyperspace.execution.min.device.rows")
    check(passes["warm_on"].get("cache.segments.hits", 0) > 0,
          "tpcds: the warm rules-on pass hit no cached segment")
    served = [q for q in queries if queries[q]["indexes"]]
    out.update(queries=len(queries), oracle_s=oracle_s, passes=passes,
               phase_s=time.perf_counter() - phase_t0,
               **totals(queries, ("on_ms", "off_ms", "cold_on_ms",
                                  "cold_off_ms")),
               index_served=len(served),
               index_served_on_ms=sum(queries[q]["on_ms"] for q in served),
               index_served_off_ms=sum(queries[q]["off_ms"]
                                       for q in served),
               slower_on=sum(queries[q]["on_ms"] > queries[q]["off_ms"]
                             for q in queries),
               slowest_on=sorted(queries,
                                 key=lambda q: -queries[q]["on_ms"])[:5])
    return out


# -- data skipping (bench.py's rung 5b) --------------------------------------

def write_skip_source(src_dir, first_file, n_files):
    """bench.py's rung-5b source: key-clustered files of N_SKIP_PER_FILE
    rows (`key` an int64 arange per file, `k2` int64 in [0, 100), `score`
    float64), seeded per file. Returns the columns."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(src_dir, exist_ok=True)
    parts = []
    for i in range(first_file, first_file + n_files):
        rng = np.random.default_rng([SEED, 5, i])
        part = {"key": np.arange(i * N_SKIP_PER_FILE,
                                 (i + 1) * N_SKIP_PER_FILE, dtype=np.int64),
                "k2": rng.integers(0, 100, N_SKIP_PER_FILE).astype(np.int64),
                "score": rng.random(N_SKIP_PER_FILE)}
        pq.write_table(pa.table(part),
                       os.path.join(src_dir, f"part-x{i:02d}.parquet"))
        parts.append(part)
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def sketch_lanes_ms(src_dir, nbits, card):
    """The sketch's device work on one source file's `key` column — zone
    reductions and the bloom build (flat bit positions, bincount, pack)
    — on the card and on the host lane, each the median of 5 after one
    warm-up. Runs outside the counted phases."""
    import numpy as np
    import pyarrow.parquet as pq
    import torch

    from hyperspace_tpu_torch.io import columnar
    from hyperspace_tpu_torch.ops import sketch
    from hyperspace_tpu_torch.plan.schema import Schema

    table = pq.read_table(os.path.join(src_dir, "part-x00.parquet"),
                          columns=["key"])
    schema = Schema.from_arrow(table.schema)
    out = {"rows": table.num_rows, "nbits": nbits}
    for lane, device in (("device", card), ("host", None)):
        column = columnar.from_arrow(table, schema,
                                     device=device).column("key")
        for name, fn in (("zones", lambda: sketch.zones(column)),
                         ("bloom", lambda: sketch.bloom_build(column,
                                                              nbits))):
            times = []
            for _ in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            out[f"{lane}_{name}_ms"] = float(np.median(times[1:]))
    return out


def phase_skipping(work, card):
    """Data-skipping indexes at the filter rung's row count: 16
    key-clustered files of 1,048,576 rows. The sketch build on the
    device lane and on the host lane (byte-equal blobs), three pruned
    selectivities and a Z-order query against the unpruned scan (cold
    and warm, rules on and off, in turns), an incremental and a full
    refresh, and hybrid scan's appended branch thinned by the sketches.
    Every result equals numpy and the rules-off result."""
    import numpy as np

    from hyperspace_tpu_torch import (DataSkippingIndexConfig, Hyperspace,
                                      HyperspaceConf, HyperspaceSession,
                                      IndexConfig, col, lit)
    from hyperspace_tpu_torch.index.sketch import SKETCH_BLOB, load_sketches
    from hyperspace_tpu_torch.io import parquet, segcache

    src = os.path.join(work, "skip_src")
    t0 = time.perf_counter()
    cols = write_skip_source(src, 0, N_SKIP_FILES)
    source_s = time.perf_counter() - t0
    n = len(cols["key"])
    min_rows = "spark.hyperspace.execution.min.device.rows"

    def session(name):
        sess = HyperspaceSession(HyperspaceConf({
            "spark.hyperspace.warehouse.dir": os.path.join(work, name)}),
            device=card)
        return sess, Hyperspace(sess)

    def cold():
        parquet.clear_read_cache()
        segcache.clear()

    sess, hs = session("skip_wh")
    registry = hs.metrics_registry()
    out = {"rows": n, "files": N_SKIP_FILES, "source_s": source_s}

    # The build, on the device lane and at the default conf (the host
    # lane: each file is below min.device.rows), in turns.
    blobs, builds = [], {"device": [], "host": []}
    for rep, lane in enumerate(("device", "host", "host", "device")):
        bsess, bhs = (sess, hs) if rep == 0 else session(f"skip_wh_{rep}")
        if lane == "device":
            bsess.conf.set(min_rows, "0")
        cold()
        h2d0 = registry.counters_dict().get("link.h2d.bytes", 0)
        t0 = time.perf_counter()
        bhs.create_index(bsess.read_parquet(src),
                         DataSkippingIndexConfig("bench_skip", ["key"]))
        builds[lane].append(time.perf_counter() - t0)
        h2d = registry.counters_dict().get("link.h2d.bytes", 0) - h2d0
        check((h2d >= n * 8) == (lane == "device"),
              f"skipping {lane} build moved {h2d} bytes to the card")
        bsess.conf.unset(min_rows)
        root = os.path.join(bsess.conf.system_path, "bench_skip", "v__=0")
        with open(os.path.join(root, SKETCH_BLOB), "rb") as f:
            blobs.append(f.read())
    check(all(b == blobs[0] for b in blobs),
          "skipping: the device-lane and host-lane blobs differ")
    sketches = load_sketches(os.path.join(sess.conf.system_path,
                                          "bench_skip", "v__=0"))
    words = np.concatenate([fs.columns["key"].bloom
                            for fs in sketches.files.values()])
    nbits = len(sketches.files[os.path.join(
        src, "part-x00.parquet")].columns["key"].bloom) * 32
    out["build"] = {"device_s": builds["device"], "host_s": builds["host"],
                    "blob_bytes": len(blobs[0]),
                    "bloom_bits_per_file": nbits,
                    "bloom_fill": float(np.unpackbits(
                        words.view(np.uint8)).mean())}
    out["sketch_lanes"] = sketch_lanes_ms(src, nbits, card)

    sdf = sess.read_parquet(src)
    files = sorted(sdf.plan.files())

    def rows_of(table):
        keys = table.column("key").to_numpy()
        order = np.argsort(keys)
        return keys[order], table.column("score").to_numpy()[order]

    def timed_pair(name, frame, mask, want_files, served):
        """Rules on and off, cold and then warm, in turns; every result
        held against numpy; the rules-on plan's file list checked."""
        want = (cols["key"][mask], cols["score"][mask])
        sess.enable_hyperspace()
        (leaf,) = sess.optimize(frame.plan).collect_leaves()
        check(leaf._explicit_files and sorted(leaf.files()) == want_files,
              f"skipping {name}: the plan reads {leaf.files()}")
        passes = ("cold_on", "warm_on", "cold_off", "warm_off")
        times = {p: [] for p in passes}
        record = {}
        for rep in range(2):
            for p in passes:
                if p.startswith("cold"):
                    cold()
                if p.endswith("on"):
                    sess.enable_hyperspace()
                else:
                    sess.disable_hyperspace()
                t0 = time.perf_counter()
                table, metrics = frame.collect(with_metrics=True)
                times[p].append((time.perf_counter() - t0) * 1e3)
                got = rows_of(table)
                check(all(np.array_equal(a, b) for a, b in zip(got, want)),
                      f"skipping {name} {p}: rows differ from numpy")
                if p == "cold_on" and rep == 0:
                    (use,) = [u for u in metrics.index_usage()
                              if u.get("side") == "skipping"]
                    check(use["served"] == served,
                          f"skipping {name}: served {use['served']}")
                    record = {
                        "files_pruned": metrics.counters.get(
                            "skipping.files_pruned", 0),
                        "bytes_pruned": metrics.counters.get(
                            "skipping.bytes_pruned", 0),
                        "files_read": len(want_files)}
        sess.disable_hyperspace()
        record.update({"rows_out": int(mask.sum()), "ms": times,
                       **{f"{p}_ms": min(t) for p, t in times.items()}})
        return record

    point = n // 2
    preds = {
        "point": (col("key") == lit(point), cols["key"] == point,
                  point, point + 1),
        "narrow_1pct": ((col("key") >= lit(point))
                        & (col("key") < lit(point + n // 100)),
                        (cols["key"] >= point)
                        & (cols["key"] < point + n // 100),
                        point, point + n // 100),
        "broad_25pct": ((col("key") >= lit(point))
                        & (col("key") < lit(point + n // 4)),
                        (cols["key"] >= point)
                        & (cols["key"] < point + n // 4),
                        point, point + n // 4),
    }
    queries = {}
    for name, (pred, mask, lo, hi) in preds.items():
        want_files = [f for i, f in enumerate(files)
                      if i * N_SKIP_PER_FILE < hi
                      and (i + 1) * N_SKIP_PER_FILE > lo]
        queries[name] = timed_pair(name, sdf.filter(pred).select(
            "key", "score"), mask, want_files, "source")
        check(queries[name]["files_pruned"] == N_SKIP_FILES - len(
            want_files), f"skipping {name}: {queries[name]}")
    check(queries["point"]["files_pruned"] > 0
          and queries["narrow_1pct"]["files_pruned"] > 0,
          "skipping: point or narrow_1pct pruned no file")

    # The Z-order copy, clustered by (key, k2); its sketches on the card.
    sess.conf.set(min_rows, "0")
    t0 = time.perf_counter()
    hs.create_index(sdf, DataSkippingIndexConfig(
        "bench_z", ["key", "k2"], zorder_by=["key", "k2"]))
    zorder_s = time.perf_counter() - t0
    sess.conf.unset(min_rows)
    zroot = os.path.join(sess.conf.system_path, "bench_z", "v__=0")
    zsk = load_sketches(zroot)
    zfilter = ((col("k2") == lit(7)) & (col("key") >= lit(point))
               & (col("key") < lit(point + n // 100)))
    zmask = ((cols["k2"] == 7) & (cols["key"] >= point)
             & (cols["key"] < point + n // 100))
    from hyperspace_tpu_torch.plan.rules.skipping import prune_files
    zsurvivors = sorted(prune_files(zfilter, sorted(zsk.files), zsk)[0])
    queries["zorder"] = timed_pair("zorder", sdf.filter(zfilter).select(
        "key", "score"), zmask, zsurvivors, "zorder-copy")
    queries["zorder"]["build_s"] = zorder_s
    queries["zorder"]["copy_files"] = len(zsk.files)
    check(queries["zorder"]["files_pruned"] > 0,
          "skipping: the Z-order query pruned no copy file")
    out["queries"] = queries

    # A covering index over the same source, stale after the append
    # below: hybrid scan's appended branch.
    t0 = time.perf_counter()
    hs.create_index(sdf, IndexConfig("bench_cov", ["key"], ["score"]))
    cov_s = time.perf_counter() - t0

    # Maintenance: append one file, refresh incrementally, then fully.
    app = write_skip_source(src, N_SKIP_FILES, 1)
    allc = {k: np.concatenate([cols[k], app[k]]) for k in cols}

    def lookup(version):
        key = int(app["key"][123])
        frame = sess.read_parquet(src).filter(
            col("key") == lit(key)).select("key", "score")
        sess.enable_hyperspace()
        table, metrics = frame.collect(with_metrics=True)
        sess.disable_hyperspace()
        mask = allc["key"] == key
        check(all(np.array_equal(a, b) for a, b in zip(
            rows_of(table), (allc["key"][mask], allc["score"][mask]))),
              f"skipping lookup after v__={version}: rows differ")
        (use,) = [u for u in metrics.index_usage()
                  if u.get("side") == "skipping"]
        check(use["name"] == "bench_skip"
              and use["index_root"].endswith(f"v__={version}")
              and use["files_pruned"] == N_SKIP_FILES,
              f"skipping lookup after v__={version}: {use}")

    sess.conf.set(min_rows, "0")
    maintenance = {}
    for version, mode in ((1, "incremental"), (2, "full")):
        cold()
        t0 = time.perf_counter()
        hs.refresh_index("bench_skip", mode=mode)
        seconds = time.perf_counter() - t0
        detail = registry.last_action_report()["detail"]
        maintenance[mode] = {"seconds": seconds,
                             "files_sketched": detail["files_sketched"],
                             "files_carried": detail.get("files_carried")}
        if mode == "incremental":
            check(detail["files_sketched"] == 1
                  and detail["files_carried"] == N_SKIP_FILES,
                  f"skipping incremental refresh: {detail}")
        lookup(version)
    sess.conf.unset(min_rows)
    out["maintenance"] = maintenance

    # Hybrid scan: the stale covering index serves key == n/2; the
    # appended file is refuted by the refreshed sketches.
    sess.conf.set("spark.hyperspace.index.hybridscan.enabled", "true")
    sess.enable_hyperspace()
    frame = sess.read_parquet(src).filter(
        col("key") == lit(point)).select("key", "score")
    plan = sess.optimize(frame.plan)
    check(plan_unions(plan) == 0
          and any(leaf.index_name == "bench_cov"
                  for leaf in plan.collect_leaves()),
          "skipping hybrid: the appended branch was not pruned away")
    table, metrics = frame.collect(with_metrics=True)
    warm = wall_ms(frame.collect)
    sess.disable_hyperspace()
    sess.conf.unset("spark.hyperspace.index.hybridscan.enabled")
    mask = allc["key"] == point
    check(all(np.array_equal(a, b) for a, b in zip(
        rows_of(table), (allc["key"][mask], allc["score"][mask]))),
          "skipping hybrid: rows differ from numpy")
    pruned = metrics.counters.get("skipping.files_pruned", 0)
    check(pruned > 0, "skipping hybrid: no appended file pruned")
    out["hybrid"] = {"cov_build_s": cov_s, "files_pruned": pruned,
                     "rows_out": table.num_rows, "warm_ms": warm}
    return out


def _trace_kernels(trace_dir):
    """{kernel symbol: summed device microseconds} of a `torch.profiler`
    capture directory's `trace.json`."""
    from hyperspace_tpu_torch.telemetry.profiler import TRACE_FILE

    with open(os.path.join(trace_dir, TRACE_FILE)) as f:
        events = json.load(f).get("traceEvents", [])
    out = {}
    for e in events:
        if e.get("cat") == "kernel":
            out[e["name"]] = out.get(e["name"], 0.0) + float(e.get("dur", 0))
    return out


def _symbol(kernels, fragment):
    return [k for k in kernels if fragment in k]


def gather_bytes(rows, widths):
    """Bytes one row gather of `rows` rows moves, computed here apart
    from the seam's cost functions: the int64 index read once, and each
    gathered row of each column (byte widths `widths`) read and written
    once."""
    return rows * (8 + 2 * sum(widths))


# The recorder's cost: warm runs of each side, in turns (the order
# flips every turn); the reading is the ratio of the medians of all the
# turns, beside OVERHEAD_LIMIT, and each block of seven turns is shown.
# The range filter's runs spread wider than the limit (host work over
# 200 files), so it takes more.
OVERHEAD_TURNS = {"range": 181, "join_A": 21}
OVERHEAD_LIMIT = 1.05


def phase_telemetry(hs, sess, df, work, fresh):
    """The device-side telemetry of the port over the join rung's indexes:
    build counts, per-query roofline and critical path for the range
    filter and joins A and B, the seam's overhead, a torch.profiler
    capture of join B, the flight recorder, the ops server, and a cold
    and a warm artifact with their diff. `fresh` names the libraries that
    were not built when the run started."""
    import urllib.request

    import torch

    from hyperspace_tpu_torch import col, lit, native, telemetry
    from hyperspace_tpu_torch.engine.executor import execute_plan
    from hyperspace_tpu_torch.io import parquet, segcache
    from hyperspace_tpu_torch.io.columnar import to_arrow
    from hyperspace_tpu_torch.ops.cuda import build as kbuild
    from hyperspace_tpu_torch.ops.cuda import (hash_kernel, partition_kernel,
                                               run_bounds_kernel)
    from hyperspace_tpu_torch.telemetry import (artifact, critical_path,
                                                diff, flight, ops_server,
                                                profiler)

    phase_t0 = time.perf_counter()
    reg = telemetry.get_registry()
    out = {}

    # Builds: the first use of each library was counted as a trace (it
    # was built in this run) or a cache hit (it was there); a later load
    # of the kernels is a cache hit.
    c = reg.counters_dict()
    builds = {}
    for lib in (*kbuild.SOURCES, "hyperspace_host"):
        traces = int(c.get(f"compile.{lib}.traces", 0))
        hits = int(c.get(f"compile.{lib}.cache_hits", 0))
        check(traces == (1 if fresh[lib] else 0) and traces + hits >= 1,
              f"telemetry: {lib} counted {traces} builds, {hits} loads "
              f"(fresh: {fresh[lib]})")
        builds[lib] = {"traces": traces, "cache_hits": hits}
    check(native.get_lib() is not None, "telemetry: no native library")
    kbuild.build_all()
    c2 = reg.counters_dict()
    for lib in kbuild.SOURCES:
        check(c2.get(f"compile.{lib}.cache_hits", 0)
              == builds[lib]["cache_hits"] + 1,
              f"telemetry: a later load of {lib} was not a cache hit")
    out["builds"] = builds
    out["compile"] = {"traces": int(c2.get("compile.traces", 0)),
                      "cache_hits": int(c2.get("compile.cache_hits", 0)),
                      "seconds": c2.get("compile.seconds", 0.0)}

    sess.enable_hyperspace()
    frames = {
        "range": (df.filter((col("key") >= lit(0)) & (col("k2") < lit(50)))
                  .select("id", "score")),
    }
    for name, buckets in (("join_A", 200), ("join_B", 64)):
        rdf = sess.read_parquet(os.path.join(work, f"right{buckets}"))
        frames[name] = (df.select("key", "id")
                        .join(rdf.select("key", "val"), on="key")
                        .select("id", "val"))
    seq0 = flight.get_recorder().last_seq

    # Queries: one warm run each with its recorder and tracing on.
    telemetry.enable_tracing()
    queries = {}
    try:
        for name, frame in frames.items():
            frame.collect()
            table, m = frame.collect(with_metrics=True)
            roof, cp = m.roofline, m.critical_path
            # The unclamped seconds: `device_share` is capped at 1.
            check(0 < roof["dispatch_s"] <= m.wall_s
                  and roof["device_share"] > 0,
                  f"telemetry {name}: roofline {roof} over {m.wall_s} s")
            modeled = sum(v for k, v in m.counters.items()
                          if k.startswith("device.")
                          and k.endswith(".bytes_accessed")
                          and k != "device.bytes_accessed")
            check(m.counters["device.bytes_accessed"] == modeled,
                  f"telemetry {name}: bytes_accessed "
                  f"{m.counters['device.bytes_accessed']} != {modeled}")
            # The gathers against this script's own formula (every
            # column is int64 or float64): the range filter's fused stage
            # (its Filter a mask, its Project a selection, one
            # compaction) gathers its survivors of the two projected
            # columns; each join gathers the left `id` and the right
            # `val` of every output row, and join B's Exchange reorders
            # the right side's `key` and `val`.
            want = {"range": gather_bytes(table.num_rows, [8] * 2),
                    "join_A": 2 * gather_bytes(table.num_rows, [8]),
                    "join_B": 2 * gather_bytes(table.num_rows, [8])
                    + gather_bytes(N_RIGHT, [8, 8])}[name]
            took = m.counters.get("device.columnar.fused_take.bytes_accessed")
            check(took == want,
                  f"telemetry {name}: gathers moved {took} B, not {want}")
            check(abs(sum(cp["segments"].values()) - m.wall_s)
                  <= critical_path.SUM_EXACT_EPSILON_S,
                  f"telemetry {name}: critical path {cp} vs {m.wall_s}")
            entry = {
                "rows": table.num_rows, "wall_ms": m.wall_s * 1e3,
                "dispatch_ms": roof["dispatch_s"] * 1e3,
                "device_share": roof["device_share"],
                "bytes_accessed": roof["bytes_accessed"],
                "dominant": cp["dominant"],
                "segments_ms": {k: v * 1e3
                                for k, v in cp["segments"].items()},
                "dispatches": {k[len("device."):-len(".dispatches")]: v
                               for k, v in m.counters.items()
                               if k.endswith(".dispatches")
                               and k != "device.dispatches"}}
            queries[name] = entry
            emit("telemetry_query", name=name, **entry)
    finally:
        telemetry.disable_tracing()
    part = m.counters.get(
        "device.cuda.partition_ids_and_histogram.dispatches", 0)
    per_launch = partition_kernel.partition_cost(
        torch.empty((2, N_RIGHT), dtype=torch.int32, device="meta"),
        EXCHANGE_BUCKETS)[1]
    check(part > 0 and m.counters[
        "device.cuda.partition_ids_and_histogram.bytes_accessed"]
        == part * per_launch == part * (N_RIGHT * 12 + 8 * 200),
        f"telemetry join_B: partition bytes {m.counters}")
    out["queries"] = queries
    out["modeled_bytes_per_launch"] = {
        "hash_lanes_to_buckets": hash_kernel.hash_cost(torch.empty(
            (2, N_ROWS), dtype=torch.int32, device="meta"), 200)[1],
        "partition_ids_and_histogram": per_launch}

    # The seam's cost: each warm query through `collect` (its recorder,
    # the device events queued and resolved at finish, the critical path
    # and the flight ring) against the same optimized plan executed with
    # no recorder active (OVERHEAD_TURNS).
    # What one `stat` costs on this host: the source projection every
    # collect makes re-stats its files at most every
    # `footprint.SCAN_BYTES_REVALIDATE_S`.
    part = os.path.join(work, "src", "part-0.parquet")
    t0 = time.perf_counter()
    for _ in range(1000):
        os.stat(part)
    stat_us = (time.perf_counter() - t0) * 1e3
    overhead = {}
    for name, turns in OVERHEAD_TURNS.items():
        frame = frames[name]
        runs = {"recorder": [], "none": []}
        for turn in range(turns):
            order = ("recorder", "none") if turn % 2 == 0 else (
                "none", "recorder")
            for side in order:
                t0 = time.perf_counter()
                if side == "recorder":
                    frame.collect()
                else:
                    to_arrow(execute_plan(sess.optimize(frame.plan),
                                          conf=sess.conf))
                runs[side].append((time.perf_counter() - t0) * 1e3)
        med = {k: statistics.median(v) for k, v in runs.items()}
        blocks = [statistics.median(runs["recorder"][i:i + 7])
                  / statistics.median(runs["none"][i:i + 7])
                  for i in range(0, turns - 6, 7)]
        ratio = med["recorder"] / med["none"]
        # A reading, not a gate: two host-bound medians spread by about
        # as much as the limit between calls; the benchmark is where a
        # speed ratio can fail a run.
        overhead[name] = {"turns": turns, "recorder_ms": med["recorder"],
                          "none_ms": med["none"], "ratio": ratio,
                          "within_limit": ratio <= OVERHEAD_LIMIT,
                          "block_ratios": blocks,
                          "runs_ms": runs}
    out["overhead"] = overhead
    out["stat_us"] = stat_us
    emit("telemetry_overhead", limit=OVERHEAD_LIMIT, stat_us=stat_us,
         **{k: {x: v[x] for x in ("turns", "recorder_ms", "none_ms",
                                  "ratio", "within_limit", "block_ratios")}
            for k, v in overhead.items()})

    # torch.profiler. The hash kernel is not on join B's path: one launch
    # at the build's shape, captured on its own (which also starts the
    # profiler's CUDA tracing before the query's capture).
    trace_root = os.path.join(work, "traces")
    lanes = torch.randint(-2**31, 2**31 - 1, (2, N_ROWS),
                          dtype=torch.int32, device=sess.device)
    with profiler.device_trace(os.path.join(trace_root, "hash")):
        hash_kernel.hash_lanes_to_buckets(lanes, 200)
        torch.cuda.synchronize()
    hash_kernels = _trace_kernels(os.path.join(trace_root, "hash"))
    check(_symbol(hash_kernels, "hash_lanes_to_buckets_kernel"),
          f"telemetry: the hash capture names no hash kernel: "
          f"{sorted(hash_kernels)}")
    # Join B captured by the executor under trace.dir.
    sess.conf.set("spark.hyperspace.trace.dir", trace_root)
    try:
        _table, m = frames["join_B"].collect(with_metrics=True)
    finally:
        sess.conf.unset("spark.hyperspace.trace.dir")
    (capture,) = [e["path"] for e in m.events_of("profiler", "capture")]
    kernels = _trace_kernels(capture)
    check(_symbol(kernels, "partition_histogram_kernel"),
          f"telemetry: join B's trace names no partition kernel: "
          f"{sorted(kernels)}")
    busy_ms = sum(kernels.values()) / 1e3
    warm_ms = queries["join_B"]["wall_ms"]
    out["profiler"] = {
        "captured_wall_ms": m.wall_s * 1e3,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / (m.wall_s * 1e3),
        "device_busy_share_of_warm_wall": busy_ms / warm_ms,
        "seam_device_share": queries["join_B"]["device_share"],
        "kernels": len(kernels),
        "top_kernels_ms": {k[:80]: v / 1e3 for k, v in sorted(
            kernels.items(), key=lambda kv: -kv[1])[:6]},
        "partition_kernel_us": sum(kernels[k] for k in _symbol(
            kernels, "partition_histogram_kernel")),
        "hash_kernel_us": sum(hash_kernels[k] for k in _symbol(
            hash_kernels, "hash_lanes_to_buckets_kernel")),
        "note": "busy: every kernel in the trace (the captured run's wall "
                "includes the profiler's own cost; also shown over the "
                "unprofiled warm wall); seam: only the instrumented entry "
                "points' event spans"}
    emit("telemetry_profiler", **out["profiler"])

    # Flight recorder: one slow-query dump, read back.
    dump_dir = os.path.join(work, "slowlog")
    sess.conf.set("spark.hyperspace.telemetry.slowlog.seconds", "0.000001")
    sess.conf.set("spark.hyperspace.telemetry.slowlog.dir", dump_dir)
    try:
        _table, m = frames["range"].collect(with_metrics=True)
    finally:
        sess.conf.unset("spark.hyperspace.telemetry.slowlog.seconds")
        sess.conf.unset("spark.hyperspace.telemetry.slowlog.dir")
    sess.flight_recorder().drain()  # the dump lands off the query's thread
    dumps = sorted(f for f in os.listdir(dump_dir) if f.startswith("slow-"))
    check(len(dumps) == 1, f"telemetry: slow-query dumps {dumps}")
    doc = flight.load_dump(os.path.join(dump_dir, dumps[0]))
    check(doc["metrics"]["critical_path"] == m.critical_path
          and doc["wall_s"] == m.wall_s,
          "telemetry: the slow-query dump does not round-trip")
    fresh_q, last = flight.get_recorder().snapshot(seq0)
    # 6 query runs, the timed runs with a recorder, the capture, the dump;
    # the ring keeps the newest of them.
    recorded = 6 + sum(OVERHEAD_TURNS.values()) + 2
    check(last - seq0 == recorded
          and [q.flight_seq for q in fresh_q] == list(range(
              last - min(recorded, flight.CAPACITY) + 1, last + 1))
          and all(q.critical_path for q in fresh_q),
          f"telemetry: the flight ring holds {len(fresh_q)} of "
          f"{last - seq0} phase queries")
    out["flight"] = {"dump": dumps[0], "recorded": last - seq0,
                     "ring_queries": len(fresh_q)}

    # Ops server on an ephemeral port.
    server = ops_server.start_server(port=0)
    try:
        status = {}
        for path in ("/metrics", "/healthz", "/critpath", "/timeseries"):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{server.port}{path}",
                    timeout=30) as r:
                status[path] = r.status
                r.read()
    finally:
        ops_server.stop_server()
    check(all(v == 200 for v in status.values()),
          f"telemetry: ops server answered {status}")
    out["ops_server"] = status

    # Artifacts: a cold and a warm pass of the three queries, and their
    # diff.
    docs = {}
    for tag in ("cold", "warm"):
        if tag == "cold":
            parquet.clear_read_cache()
            segcache.clear()
        entries = {}
        for name, frame in frames.items():
            _table, m = frame.collect(with_metrics=True)
            entries[name] = {"wall_s": m.wall_s,
                             **artifact.query_metrics_block(m)}
        docs[tag] = artifact.make_artifact(
            driver="chip_smoke.telemetry", metric="wall_s",
            value=sum(e["wall_s"] for e in entries.values()), unit="s",
            vs_baseline=None, queries=entries, device=sess.device)
        check(artifact.validate(docs[tag]) == [],
              f"telemetry: the {tag} artifact is not canonical")
    card = docs["warm"]
    check(card["platform"] == "gpu"
          and card["device_kind"] == torch.cuda.get_device_name(0)
          and card["power_limit"],
          f"telemetry: artifact device {card['platform']}, "
          f"{card['device_kind']}, {card['power_limit']}")
    delta = diff.diff_artifacts(docs["cold"], docs["warm"], "cold", "warm")
    out["artifact"] = {
        "platform": card["platform"], "device_kind": card["device_kind"],
        "power_limit": card["power_limit"],
        "cold_s": docs["cold"]["value"], "warm_s": card["value"],
        "diff": [{"query": q.name, "delta_s": q.delta,
                  "top": [(b.name, b.seconds) for b in q.ranked()[:3]]}
                 for q in delta.ranked_queries()]}
    out["phase_s"] = time.perf_counter() - phase_t0
    return out


# -- the serving plane ---------------------------------------------------------

SERVE_ROWS = 1 << 24            # facts rows (bench_serve.py's 50,000, scaled up)
SERVE_FILES = 8
SERVE_DIMS = SERVE_ROWS // 50   # 335,544 dims rows, bench_serve.py's ratio
SERVE_QUERIES = 800             # per closed loop (1 client, then 8)
SERVE_CLIENTS = 8
SERVE_BURST = 16                # threads of the warm-up lap's burst
SERVE_RATES = (0.5, 0.75, 1.0, 1.25, 1.5)   # x the serial QPS
SERVE_OPEN_S = 6.0
SERVE_OPEN_WORKERS = 64
SERVE_SLO_MS = 150.0
SERVE_TENANT_QUERIES = 240      # the victim tenant's point queries per lap
SERVE_INGEST_FILES = 4
SERVE_INGEST_ROWS = 1 << 20
SERVE_CHAOS_QUERIES = 96


def write_serve_source(work, seed=SEED + 9):
    """bench_serve.py's `generate` at SERVE_ROWS: `facts` (k int64 in
    [0, SERVE_DIMS), g int64 in [0, 32), v float64) in SERVE_FILES files
    and `dims` (k, w float64, label string). Returns the columns."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    facts = {"k": rng.integers(0, SERVE_DIMS, SERVE_ROWS).astype(np.int64),
             "g": rng.integers(0, 32, SERVE_ROWS).astype(np.int64),
             "v": rng.random(SERVE_ROWS)}
    dims = {"k": np.arange(SERVE_DIMS, dtype=np.int64),
            "w": rng.random(SERVE_DIMS)}
    os.makedirs(os.path.join(work, "facts"))
    os.makedirs(os.path.join(work, "dims"))
    step = SERVE_ROWS // SERVE_FILES
    for i in range(SERVE_FILES):
        pq.write_table(pa.table({c: v[i * step:(i + 1) * step]
                                 for c, v in facts.items()}),
                       os.path.join(work, "facts", f"part-{i}.parquet"))
    pq.write_table(pa.table({
        **dims, "label": pa.array([f"d{i % 100}"
                                   for i in range(SERVE_DIMS)])}),
        os.path.join(work, "dims", "part-0.parquet"))
    return facts, dims


def serve_mix(sess, work):
    """bench_serve.py's `build_workload`: 8 point lookups on `g`, two `v`
    ranges and two `g` IN lists (one batch signature each, literals
    free), an aggregate and a join."""
    from hyperspace_tpu_torch import col, lit

    facts = sess.read_parquet(os.path.join(work, "facts"))
    dims = sess.read_parquet(os.path.join(work, "dims"))
    mix = [(f"point_g{g}", facts.filter(col("g") == lit(g))
            .select("k", "g", "v")) for g in range(8)]
    for i, (lo, hi) in enumerate(((0.90, 0.95), (0.40, 0.45))):
        mix.append((f"range_v{i}", facts.filter(
            (col("v") > lit(lo)) & (col("v") <= lit(hi))).select("k", "v")))
    mix.append(("in_g0", facts.filter(col("g").isin(3, 11, 19))
                .select("k", "g")))
    mix.append(("in_g1", facts.filter(col("g").isin(5, 21))
                .select("k", "g")))
    mix.append(("agg", facts.group_by("g").agg(("sum", "v", "total"),
                                               cnt=("count", "*"))))
    mix.append(("join", facts.join(dims, on="k").filter(col("w") > lit(0.5))
                .group_by("g").agg(("avg", "v", "avg_v"))))
    return mix


def serve_oracle(name, facts, dims):
    """numpy answer of one mix entry as {column: array}, rows in any
    order (aggregates: one row per `g`, ascending)."""
    import numpy as np

    g, v = facts["g"], facts["v"]
    if name.startswith("point_g"):
        m = g == int(name[len("point_g"):])
        return {"k": facts["k"][m], "g": g[m], "v": v[m]}
    if name.startswith("range_v"):
        lo, hi = ((0.90, 0.95), (0.40, 0.45))[int(name[-1])]
        m = (v > lo) & (v <= hi)
        return {"k": facts["k"][m], "v": v[m]}
    if name.startswith("in_g"):
        m = np.isin(g, (3, 11, 19) if name == "in_g0" else (5, 21))
        return {"k": facts["k"][m], "g": g[m]}
    if name == "agg":
        keys = np.unique(g)
        return {"g": keys,
                "total": np.bincount(g, weights=v, minlength=32)[keys],
                "cnt": np.bincount(g, minlength=32)[keys]}
    m = dims["w"][facts["k"]] > 0.5
    keys = np.unique(g[m])
    return {"g": keys,
            "avg_v": (np.bincount(g[m], weights=v[m], minlength=32)[keys]
                      / np.bincount(g[m], minlength=32)[keys])}


def table_digest(table):
    """An order-insensitive exact digest of an Arrow table: its columns,
    its row count, and two wrapping uint64 sums over per-row hashes of
    the values' bits (so rows of equal values in any order digest
    equal, and a changed, lost or re-paired value does not)."""
    import numpy as np

    cols = {n: table.column(n).to_numpy() for n in table.column_names}
    return array_digest(cols)


def array_digest(cols):
    import numpy as np

    names = list(cols)
    n = len(cols[names[0]]) if names else 0
    h = np.zeros(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for i, name in enumerate(names):
            a = np.ascontiguousarray(cols[name])
            # No copy for a column already 8 bytes wide: a 33.5M-row
            # join result digests in a fraction of a second.
            a = (a.astype(np.float64, copy=False) if a.dtype.kind == "f"
                 else a.astype(np.int64, copy=False)).view(np.uint64)
            h *= np.uint64(0x100000001B3)
            h ^= a * np.uint64(0x9E3779B97F4A7C15 + 2 * i)
        return (tuple(names), n, int(h.sum(dtype=np.uint64)),
                int((h * h).sum(dtype=np.uint64)))


def percentiles(lats_s):
    import numpy as np

    if not lats_s:
        return {"p50_ms": None, "p95_ms": None, "p99_ms": None}
    a = np.asarray(lats_s) * 1e3
    return {f"p{q}_ms": float(np.percentile(a, q)) for q in (50, 95, 99)}


def closed_loop(mix, clients, total, tenant=None, metrics_out=None):
    """`clients` threads drain `total` queries of `mix` round-robin, each
    issuing its next the moment the previous returns. Returns (latencies,
    [(name, table)], errors, wall seconds)."""
    import threading

    lats, produced, errors = [], [], []
    nxt = [0]
    lock = threading.Lock()
    start = threading.Barrier(clients)

    def client():
        start.wait()  # every client's first query arrives together
        while True:
            with lock:
                if nxt[0] >= total:
                    return
                qi = nxt[0]
                nxt[0] += 1
            name, frame = mix[qi % len(mix)]
            t0 = time.perf_counter()
            try:
                table, m = frame.collect(with_metrics=True, tenant=tenant)
            except Exception as exc:
                with lock:
                    errors.append(f"{name}: {exc!r}")
                continue
            wall = time.perf_counter() - t0
            with lock:
                lats.append(wall)
                produced.append((name, table))
                if metrics_out is not None:
                    metrics_out.append(m)

    threads = [threading.Thread(target=client, name=f"serve-{c}")
               for c in range(clients)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    check(not any(th.is_alive() for th in threads),
          "serve: a closed-loop client hung")
    return lats, produced, errors, time.perf_counter() - t0


def check_results(tag, produced, expected):
    bad = [name for name, table in produced
           if table_digest(table) != expected[name]]
    check(not bad, f"serve {tag}: {len(bad)} results differ from their "
                   f"serial runs ({sorted(set(bad))[:4]})")


def open_loop(mix, qps, seconds, workers, seed):
    """Poisson arrivals at `qps` for `seconds`, dispatched on schedule to
    `workers` logical clients; latency counts from the SCHEDULED arrival.
    Returns (latencies, produced, errors, achieved QPS)."""
    import queue
    import threading

    import numpy as np

    rng = np.random.default_rng(seed)
    n = max(1, int(qps * seconds))
    arrivals = np.cumsum(rng.exponential(1.0 / qps, n))
    q = queue.Queue()
    lats, produced, errors = [], [], []
    lock = threading.Lock()

    def worker():
        while True:
            item = q.get()
            if item is None:
                return
            i, t_sched = item
            name, frame = mix[i % len(mix)]
            try:
                table = frame.collect()
            except Exception as exc:
                with lock:
                    errors.append(f"{name}: {exc!r}")
                continue
            done = time.perf_counter()
            with lock:
                lats.append(done - t_sched)
                produced.append((name, table))

    threads = [threading.Thread(target=worker) for _ in range(workers)]
    for th in threads:
        th.start()
    t0 = time.perf_counter()
    for i, at in enumerate(arrivals):
        delay = t0 + at - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        q.put((i, t0 + at))
    for _ in threads:
        q.put(None)
    for th in threads:
        th.join(timeout=600)
    check(not any(th.is_alive() for th in threads),
          "serve: an open-loop client hung")
    wall = time.perf_counter() - t0
    return lats, produced, errors, len(lats) / wall


def phase_serve(hs, sess, work, df, left_cols):
    """The serving plane on the card, bench_serve.py's data and mix at
    SERVE_ROWS = 16,777,216 `facts` rows (bench_serve.py generates
    50,000 by default; this is a scale-up, its shapes unchanged) in
    SERVE_FILES files, 335,544 `dims` rows, and one covering index
    `facts_g` (indexed `g`, included `k, v`, 200 buckets: the hash
    kernel builds it), so the point and IN entries are index-served
    through pinned-version signatures. Every collect goes through the
    scheduler. Seven laps, each result against the serial run of the
    same query, itself checked against numpy once:

    1. warm-up: `batcher.warmup(df)` on the batchable shapes, then a
       SERVE_BURST-thread burst adding no library build and no
       `compile.aot.errors`;
    2. closed loop, 1 and then SERVE_CLIENTS clients, SERVE_QUERIES each:
       QPS, percentiles, batch occupancy, each cohort's `serve.batch`
       CUDA-event ms from the leaders' recorders, solo and batched Scan
       bytes; no batch-lane or degradation fallback;
    3. admission: a budget of twice the mix's largest projected footprint
       (plus the idle baseline) queues without rejecting; a queue.depth+1
       burst behind a held budget rejects with the typed error;
    4. open loop: Poisson arrivals at SERVE_RATES x the serial QPS,
       SERVE_OPEN_S each, SERVE_OPEN_WORKERS logical clients, latency
       from the scheduled arrival; the highest rate with p99 <=
       SERVE_SLO_MS;
    5. tenants (bench_serve.py's `tenants_phase` shape): a victim's point
       queries solo, then beside a greedy tenant running the join rung's
       query B (the partition kernel) at `hbm.fraction` 0.25 and a tenant
       with a 1 ms deadline; `tenant_report()` exact;
    6. ingest: SERVE_INGEST_FILES files of SERVE_INGEST_ROWS rows land
       while 4 clients query; `run_once()` refreshes `facts_g`
       incrementally (the hash kernel); every query then equals numpy
       over all files;
    7. chaos: `tests/torch_chaos.py`'s `run_chaos` with transient
       `parquet.read` and `transfer.put` faults: each query equals its
       serial run or raises a typed serving error, no thread outlives
       the lap."""
    import threading

    import numpy as np
    import torch

    from hyperspace_tpu_torch import IndexConfig, telemetry
    from hyperspace_tpu_torch.engine import batcher as batcher_mod
    from hyperspace_tpu_torch.engine import scheduler as sched_mod
    from hyperspace_tpu_torch.exceptions import (QueryDeadlineExceededError,
                                                 QueryRejectedError)
    from hyperspace_tpu_torch.plan import footprint
    from hyperspace_tpu_torch.utils import faults

    reg = telemetry.get_registry()
    phase_t0 = time.perf_counter()
    out = {"facts_rows": SERVE_ROWS, "facts_files": SERVE_FILES,
           "dims_rows": SERVE_DIMS,
           "cut": None if SERVE_ROWS == 1 << 24 else
           f"facts cut to {SERVE_ROWS} rows from 16777216"}
    swork = os.path.join(work, "serve")
    t0 = time.perf_counter()
    facts, dims = write_serve_source(swork)
    out["source_s"] = time.perf_counter() - t0
    sess.conf.set("spark.hyperspace.index.num.buckets", "200")
    t0 = time.perf_counter()
    hs.create_index(sess.read_parquet(os.path.join(swork, "facts")),
                    IndexConfig("facts_g", ["g"], ["k", "v"]))
    out["index_build_s"] = time.perf_counter() - t0
    was_enabled = sess.is_hyperspace_enabled
    sess.enable_hyperspace()
    mix = serve_mix(sess, swork)
    names = [n for n, _ in mix]
    sched = sched_mod.get_scheduler()

    def counters(*keys):
        c = reg.series_snapshot()["counters"]
        return {k: c.get(k, 0) for k in keys}

    # Serial runs: each against numpy (aggregates at rtol 1e-9: a
    # device sum's order is not numpy's), then the digest every later
    # run is held to.
    expected, frames = {}, dict(mix)
    solo_scan_bytes = {}
    for name, frame in mix:
        table, m = frame.collect(with_metrics=True)
        want = serve_oracle(name, facts, dims)
        if name in ("agg", "join"):
            got = table.sort_by("g")
            for c, w in want.items():
                a = got.column(c).to_numpy()
                check(len(a) == len(w) and (np.array_equal(a, w) if
                                            a.dtype.kind in "iu" else
                                            np.allclose(a, w, rtol=1e-9)),
                      f"serve {name}: column {c} differs from numpy")
        else:
            check(table_digest(table) == array_digest(want),
                  f"serve {name}: rows differ from numpy")
        expected[name] = table_digest(table)
        solo_scan_bytes[name] = sum(o.detail.get("bytes_scanned", 0)
                                    for o in m.operators if o.name == "Scan")
        if name.startswith(("point_", "in_")):
            idx = [u["name"] for u in m.index_usage()]
            check(idx == ["facts_g"], f"serve {name}: index usage {idx}")
    out["solo_scan_bytes"] = solo_scan_bytes

    # 1. Warm-up lap.
    batchable = [frames[n] for n in ("point_g0", "range_v0", "in_g0")]
    w0 = counters("compile.aot.warmups", "compile.aot.errors",
                  "compile.traces")
    t0 = time.perf_counter()
    warmed = [batcher_mod.warmup(f) for f in batchable]
    warm_s = time.perf_counter() - t0
    burst_mix = [(n, frames[n]) for n in names
                 if n.startswith(("point_", "range_", "in_"))]
    b0 = counters("compile.traces", "compile.aot.errors",
                  "serve.batch.invocations")
    lats, produced, errors, _w = closed_loop(burst_mix, SERVE_BURST,
                                             SERVE_BURST)
    b1 = counters("compile.traces", "compile.aot.errors",
                  "serve.batch.invocations", "compile.aot.warmups")
    check(not errors, f"serve warm-up burst: {errors[:3]}")
    check_results("warm-up burst", produced, expected)
    check(b1["compile.traces"] == b0["compile.traces"]
          and b1["compile.aot.errors"] == w0["compile.aot.errors"],
          f"serve warm-up: builds {b1['compile.traces'] - b0['compile.traces']}"
          f", aot errors {b1['compile.aot.errors'] - w0['compile.aot.errors']}")
    out["warmup"] = {
        "buckets_dispatched": warmed, "seconds": warm_s,
        "aot_warmups": b1["compile.aot.warmups"]
        - w0["compile.aot.warmups"],
        "burst_invocations": b1["serve.batch.invocations"]
        - b0["serve.batch.invocations"], **percentiles(lats)}

    # 2. Closed loop.
    loops = {}
    keys = ("serve.batch.invocations", "serve.batch.members",
            "serve.batch.fallbacks", "serve.batch.solo",
            "resilience.fallbacks", "cache.segments.shared.reads")
    for clients in (1, SERVE_CLIENTS):
        c0 = counters(*keys)
        ms = []
        lats, produced, errors, wall = closed_loop(
            mix, clients, SERVE_QUERIES, metrics_out=ms)
        c1 = counters(*keys)
        check(not errors, f"serve closed loop x{clients}: {errors[:3]}")
        check_results(f"closed loop x{clients}", produced, expected)
        delta = {k: c1[k] - c0[k] for k in keys}
        cohorts = [m for m in ms if m.cohort and m.cohort.get("leader")]
        loops[clients] = {
            "qps": len(lats) / wall, "wall_s": wall, **percentiles(lats),
            **delta,
            "occupancy": (delta["serve.batch.members"]
                          / delta["serve.batch.invocations"]
                          if delta["serve.batch.invocations"] else None),
            "cohorts": [{"size": m.cohort["size"],
                         "serve_batch_ms": m.counters.get(
                             "device.serve.batch.dispatch_s", 0.0) * 1e3,
                         "scan_bytes": sum(
                             o.detail.get("bytes_scanned", 0)
                             for o in m.operators if o.name == "Scan")}
                        for m in cohorts],
            "dispatch_within_wall": all(
                0 < m.counters.get("device.dispatch_s", 1e-9) <= m.wall_s
                for m in ms if m.counters.get("device.dispatch_s"))}
        check(delta["serve.batch.fallbacks"] == 0
              and delta["resilience.fallbacks"] == 0,
              f"serve closed loop x{clients}: fallbacks {delta}")
        check(loops[clients]["dispatch_within_wall"],
              f"serve closed loop x{clients}: a query's device seconds "
              "exceed its wall")
    multi = loops[SERVE_CLIENTS]
    check(multi["occupancy"] is not None and multi["occupancy"] > 1,
          f"serve: batch occupancy {multi['occupancy']}")
    serial_qps = loops[1]["qps"]
    out["closed_loop"] = {
        "serial": loops[1], "concurrent": multi,
        "clients": SERVE_CLIENTS, "queries": SERVE_QUERIES,
        "ratio": multi["qps"] / serial_qps}

    # 3. Admission.
    fps = {n: footprint.projected_bytes(f.plan) for n, f in mix}
    telemetry.memory.sample()
    baseline = sched._idle_baseline
    budget = 2 * max(fps.values()) + baseline
    sess.conf.set("spark.hyperspace.serve.hbm.budget.bytes", str(budget))
    try:
        a0 = counters("serve.queued", "serve.rejected")
        lats, produced, errors, wall = closed_loop(mix, SERVE_CLIENTS,
                                                   2 * len(mix))
        a1 = counters("serve.queued", "serve.rejected")
        check(not errors, f"serve admission: {errors[:3]}")
        check_results("admission", produced, expected)
        check(a1["serve.queued"] > a0["serve.queued"]
              and a1["serve.rejected"] == a0["serve.rejected"],
              f"serve admission: queued "
              f"{a1['serve.queued'] - a0['serve.queued']}, rejected "
              f"{a1['serve.rejected'] - a0['serve.rejected']} (budget "
              f"{budget}, baseline {baseline}, footprints {fps})")
        # A budget that admits one query, held: depth + 1 arrivals.
        depth = 4
        sess.conf.set("spark.hyperspace.serve.hbm.budget.bytes",
                      str(max(fps.values())))
        sess.conf.set("spark.hyperspace.serve.queue.depth", str(depth))
        holder = sched_mod._QueryEntry("serve-holder",
                                       sched_mod.Deadline("serve-holder"),
                                       max(fps.values()), None)
        with sched._cv:
            sched._active["serve-holder"] = holder
            sched._grant(holder, reg)
        outcomes = []
        lock = threading.Lock()

        def arrive(i):
            name, frame = mix[i % 8]
            try:
                table = frame.collect()
                r = ("ok", name, table)
            except QueryRejectedError as exc:
                r = ("rejected", exc.phase, None)
            except Exception as exc:
                r = ("error", repr(exc), None)
            with lock:
                outcomes.append(r)

        threads = [threading.Thread(target=arrive, args=(i,))
                   for i in range(depth + 1)]
        for th in threads:
            th.start()
        for _ in range(2000):
            with lock:
                if outcomes:
                    break
            time.sleep(0.005)
        sched._release(holder)
        for th in threads:
            th.join(timeout=300)
        kinds = sorted(o[0] for o in outcomes)
        check(kinds == ["ok"] * depth + ["rejected"]
              and all(o[1] == "queue" for o in outcomes
                      if o[0] == "rejected"),
              f"serve admission burst: {[o[:2] for o in outcomes]}")
        check_results("admission burst", [(o[1], o[2]) for o in outcomes
                                          if o[0] == "ok"], expected)
        out["admission"] = {
            "budget_bytes": budget, "idle_baseline_bytes": baseline,
            "largest_footprint_bytes": max(fps.values()),
            "queued": a1["serve.queued"] - a0["serve.queued"],
            "rejected": 0, "wall_s": wall, **percentiles(lats),
            "burst": {"depth": depth, "outcomes": kinds}}
    finally:
        sess.conf.unset("spark.hyperspace.serve.hbm.budget.bytes")
        sess.conf.unset("spark.hyperspace.serve.queue.depth")

    # 4. Open loop.
    rates = []
    for i, frac in enumerate(SERVE_RATES):
        qps = frac * serial_qps
        lats, produced, errors, achieved = open_loop(
            mix, qps, SERVE_OPEN_S, SERVE_OPEN_WORKERS, SEED + 100 + i)
        check(not errors, f"serve open loop {frac}: {errors[:3]}")
        check_results(f"open loop {frac}", produced, expected)
        rates.append({"fraction": frac, "offered_qps": qps,
                      "achieved_qps": achieved, "queries": len(lats),
                      **percentiles(lats)})
    within = [r for r in rates if r["p99_ms"] is not None
              and r["p99_ms"] <= SERVE_SLO_MS]
    out["open_loop"] = {
        "rates": rates, "slo_ms": SERVE_SLO_MS,
        "knee_qps": max((r["achieved_qps"] for r in within), default=None)}

    # 5. Tenants.
    hot = [(n, f) for n, f in mix if n.startswith("point_")]
    # The join rung's query B: its 64-bucket right index re-bucketed to
    # 200 through the Exchange (the partition kernel).
    right = right_columns(SEED + 3)
    join_b = (df.select("key", "id")
              .join(sess.read_parquet(os.path.join(work, "right64"))
                    .select("key", "val"), on="key")
              .select("id", "val"))
    from hyperspace_tpu_torch.engine.physical import plan_physical
    tree = plan_physical(sess.optimize(join_b.plan),
                         conf=sess.conf).tree_string()
    check(f"Exchange hashpartitioning(key, {EXCHANGE_BUCKETS})" in tree,
          f"serve tenants: join B without its Exchange\n{tree}")
    b_table = join_b.collect()
    b_want = canonical(*np_join({"key": left_cols["key"],
                                 "id": left_cols["id"]}, right))
    b_got = canonical(b_table.column("id").to_numpy(),
                      b_table.column("val").to_numpy())
    check(all(torch.equal(a, b) for a, b in zip(b_got, b_want)),
          "serve tenants: join B differs from numpy")
    b_digest = table_digest(b_table)
    del b_table, b_want, b_got
    lats_solo, produced, errors, _w = closed_loop(
        hot, 2, SERVE_TENANT_QUERIES, tenant="hot")
    check(not errors, f"serve tenants solo: {errors[:3]}")
    check_results("tenants solo", produced, expected)
    budget = 4 * footprint.projected_bytes(join_b.plan) + sched._idle_baseline
    sess.conf.set("spark.hyperspace.serve.hbm.budget.bytes", str(budget))
    sess.conf.set("spark.hyperspace.serve.tenant.cold.hbm.fraction", "0.25")
    stop = threading.Event()
    side = {"cold": [], "doomed": [], "errors": []}
    lock = threading.Lock()

    def greedy():
        while not stop.is_set():
            try:
                table = join_b.collect(tenant="cold")
                ok = table_digest(table) == b_digest
                with lock:
                    side["cold"].append(ok)
            except Exception as exc:
                with lock:
                    side["errors"].append(f"cold: {exc!r}")

    def doomed():
        i = 0
        while not stop.is_set():
            name, frame = hot[i % len(hot)]
            i += 1
            try:
                frame.collect(tenant="doomed", timeout=0.001)
                kind = "finished"
            except QueryDeadlineExceededError:
                kind = "deadline"
            except Exception as exc:
                kind = f"error: {exc!r}"
            with lock:
                side["doomed"].append(kind)

    try:
        side_threads = ([threading.Thread(target=greedy) for _ in range(2)]
                        + [threading.Thread(target=doomed)])
        p0 = counters("serve.tenant.cold.queued")
        for th in side_threads:
            th.start()
        lats_co, produced, errors, _w = closed_loop(
            hot, 2, SERVE_TENANT_QUERIES, tenant="hot")
        stop.set()
        for th in side_threads:
            th.join(timeout=300)
        check(not any(th.is_alive() for th in side_threads),
              "serve tenants: a side tenant hung")
        p1 = counters("serve.tenant.cold.queued")
    finally:
        sess.conf.unset("spark.hyperspace.serve.hbm.budget.bytes")
        sess.conf.unset("spark.hyperspace.serve.tenant.cold.hbm.fraction")
    check(not errors and not side["errors"],
          f"serve tenants: {(errors + side['errors'])[:3]}")
    check_results("tenants co-located", produced, expected)
    check(side["cold"] and all(side["cold"]),
          f"serve tenants: join B ran {len(side['cold'])} times, "
          f"{side['cold'].count(False)} wrong")
    check(side["doomed"] and all(k in ("deadline", "finished")
                                 for k in side["doomed"]),
          f"serve tenants: doomed outcomes {side['doomed'][:3]}")
    report = hs.tenant_report()
    check(report["exact"], f"serve tenants: tenant_report not exact "
                           f"{report['totals']} vs {report['global']}")
    out["tenants"] = {
        "victim_solo": percentiles(lats_solo),
        "victim_colocated": percentiles(lats_co),
        "greedy_join_b_runs": len(side["cold"]),
        "greedy_queued": p1["serve.tenant.cold.queued"]
        - p0["serve.tenant.cold.queued"],
        "doomed": {k: side["doomed"].count(k)
                   for k in sorted(set(side["doomed"]))},
        "exact": report["exact"],
        "usage": {t: v["usage"] for t, v in report["tenants"].items()
                  if t in ("hot", "cold", "doomed")}}

    # 6. Ingest.
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(SEED + 11)
    new = {c: [] for c in facts}
    coord = hs.ingest(indexes=["facts_g"])
    stop = threading.Event()
    ing = {"n": 0, "errors": []}

    def reader(c):
        i = c
        while not stop.is_set():
            name, frame = hot[i % len(hot)]
            i += 4
            try:
                frame.collect()
                with lock:
                    ing["n"] += 1
            except Exception as exc:
                with lock:
                    ing["errors"].append(f"{name}: {exc!r}")

    readers = [threading.Thread(target=reader, args=(c,)) for c in range(4)]
    for th in readers:
        th.start()
    try:
        t0 = time.perf_counter()
        for i in range(SERVE_INGEST_FILES):
            part = {"k": rng.integers(0, SERVE_DIMS, SERVE_INGEST_ROWS
                                      ).astype(np.int64),
                    "g": rng.integers(0, 32, SERVE_INGEST_ROWS
                                      ).astype(np.int64),
                    "v": rng.random(SERVE_INGEST_ROWS)}
            path = os.path.join(swork, "facts", f"append-{i}.parquet")
            pq.write_table(pa.table(part), path)
            coord.record_append([path])
            for c in facts:
                new[c].append(part[c])
        append_s = time.perf_counter() - t0
        first_append = time.time() - append_s
        stale_before = coord.staleness_s()
        t0 = time.perf_counter()
        decision = coord.run_once()
        refresh_s = time.perf_counter() - t0
        append_to_commit = time.time() - first_append
    finally:
        stop.set()
        for th in readers:
            th.join(timeout=300)
    check(not ing["errors"], f"serve ingest: {ing['errors'][:3]}")
    check(decision["action"] == "refreshed"
          and decision["refreshes"][0]["action"] == "refreshed",
          f"serve ingest: {decision}")
    facts = {c: np.concatenate([facts[c]] + new[c]) for c in facts}
    # A Scan lists its files once: new frames see the appended files.
    mix = serve_mix(sess, swork)
    frames = dict(mix)
    for name, frame in mix:
        table = frame.collect()
        if name in ("agg", "join"):
            got = table.sort_by("g")
            want = serve_oracle(name, facts, dims)
            ok = all(np.allclose(got.column(c).to_numpy(), w, rtol=1e-9)
                     for c, w in want.items())
        else:
            ok = table_digest(table) == array_digest(
                serve_oracle(name, facts, dims))
        check(ok, f"serve ingest: {name} differs from numpy over all files")
        expected[name] = table_digest(table)
    m = frames["point_g0"].collect(with_metrics=True)[1]
    usage = m.index_usage()
    check([u["name"] for u in usage] == ["facts_g"],
          f"serve ingest: refreshed index not used {m.events}")
    out["ingest"] = {
        "files": SERVE_INGEST_FILES, "rows": SERVE_INGEST_FILES
        * SERVE_INGEST_ROWS, "append_s": append_s, "refresh_s": refresh_s,
        "staleness_at_refresh_s": stale_before,
        "first_append_to_commit_s": append_to_commit,
        "staleness_gauge_s": reg.gauge("ingest.staleness.seconds").value,
        "staleness_after_s": coord.staleness_s(),
        "queries_during": ing["n"]}

    # 7. Chaos.
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_chaos

    chaos_expected = {}
    for name, frame in mix:
        chaos_expected[name] = torch_chaos.canonical(frame.collect())
    keys = ("resilience.breaker.opened", "resilience.breaker.closed",
            "resilience.breaker.half_open", "faults.injected",
            "serve.rejected", "serve.deadline_exceeded", "serve.cancelled")
    c0 = counters(*keys)
    faults.install(faults.FaultInjector([
        faults.FaultRule("parquet.read", kind="transient", times=-1,
                         probability=0.05),
        faults.FaultRule("transfer.put", kind="transient", times=-1,
                         probability=0.02)], seed=SEED))
    try:
        report = torch_chaos.run_chaos(
            mix, chaos_expected, clients=SERVE_CLIENTS,
            total_queries=SERVE_CHAOS_QUERIES,
            timeout_for=lambda i: 0.002 if i % 9 == 0 else None,
            join_timeout_s=600.0)
    finally:
        faults.uninstall()
    c1 = counters(*keys)
    left = [t.name for t in threading.enumerate()
            if t.name.startswith("chaos-")]
    check(not report.stuck_threads and not left,
          f"serve chaos: threads left {report.stuck_threads or left}")
    check(report.outcomes["error"] == 0 and not report.mismatches,
          f"serve chaos: {report.summary()} {report.errors[:3]}")
    out["chaos"] = {"outcomes": report.outcomes, "wall_s": report.wall_s,
                    **{k: c1[k] - c0[k] for k in keys}}

    if not was_enabled:
        sess.disable_hyperspace()
    hs.delete_index("facts_g")
    hs.vacuum_index("facts_g")
    shutil.rmtree(swork, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - phase_t0
    return out


# -- the self-driving index advisor (bench_advisor.py's workload) -----------

ADVISOR_ROWS = 1 << 24          # facts rows (bench_advisor.py's 40,000, scaled up)
ADVISOR_REPEATS = 4             # workload passes before and after the advisor
ADVISOR_BUCKETS = 8
ADVISOR_MAX_BUILDS = 6


def write_advisor_source(work, seed=SEED + 11):
    """bench_advisor.py's tables at ADVISOR_ROWS: facts(k int64 in
    [0, ROWS/8), v float64, tag int32 in [0, 50)) and dims(k = 0..ROWS/8-1,
    label int64 in [0, 9)), one file each."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    facts = {"k": rng.integers(0, ADVISOR_ROWS // 8,
                               ADVISOR_ROWS).astype(np.int64),
             "v": rng.random(ADVISOR_ROWS),
             "tag": rng.integers(0, 50, ADVISOR_ROWS).astype(np.int32)}
    dims = {"k": np.arange(ADVISOR_ROWS // 8, dtype=np.int64),
            "label": rng.integers(0, 9, ADVISOR_ROWS // 8).astype(np.int64)}
    paths = {}
    for name, cols in (("facts", facts), ("dims", dims)):
        paths[name] = os.path.join(work, "advisor", name)
        os.makedirs(paths[name])
        pq.write_table(pa.table(cols),
                       os.path.join(paths[name], "part-0.parquet"))
    return paths, facts, dims


def sorted_columns(table, names):
    """`table`'s columns `names` on the card, rows ordered by the first
    two (two stable sorts): the canonical form results compare in."""
    import numpy as np
    import torch

    cols = [torch.from_numpy(np.require(table.column(n).to_numpy(),
                                        requirements="W")).cuda()
            for n in names]
    perm = torch.sort(cols[1], stable=True).indices
    perm = perm[torch.sort(cols[0][perm], stable=True).indices]
    return [c[perm] for c in cols]


def phase_advisor(work):
    """bench_advisor.py's workload at ADVISOR_ROWS on the card: the
    filter (`tag == 7` -> k, v, tag) and the join (facts JOIN dims ON k
    -> k, v, label) ADVISOR_REPEATS times with no index, one
    `advisor().run_once()`, then the workload again. Gates: an index
    built, rules applied after, strictly fewer bytes scanned after,
    every result equal before and after and to numpy."""
    import numpy as np
    import torch

    from hyperspace_tpu_torch import (Hyperspace, HyperspaceConf,
                                      HyperspaceSession, col, telemetry)

    t0 = time.perf_counter()
    paths, facts, dims = write_advisor_source(work)
    out = {"rows": ADVISOR_ROWS, "dims_rows": ADVISOR_ROWS // 8,
           "repeats": ADVISOR_REPEATS, "source_s": time.perf_counter() - t0}
    sess = HyperspaceSession(HyperspaceConf({
        "spark.hyperspace.warehouse.dir": os.path.join(work, "advisor",
                                                       "wh"),
        "spark.hyperspace.index.num.buckets": str(ADVISOR_BUCKETS),
        "spark.hyperspace.advisor.max.builds": str(ADVISOR_MAX_BUILDS)}))
    sess.enable_hyperspace()
    hs = Hyperspace(sess)
    # The advisor mines the process flight ring: only this workload.
    telemetry.get_recorder().clear()
    f = sess.read_parquet(paths["facts"])
    d = sess.read_parquet(paths["dims"])
    queries = {"filter": (f.filter(col("tag") == 7).select("k", "v", "tag"),
                          ["k", "v", "tag"]),
               "join": (f.join(d, on="k").select("k", "v", "label"),
                        ["k", "v", "label"])}
    sel = facts["tag"] == 7
    oracle = {"filter": {"k": facts["k"][sel], "v": facts["v"][sel],
                         "tag": facts["tag"][sel]},
              "join": {"k": facts["k"], "v": facts["v"],
                       "label": dims["label"][facts["k"]]}}

    def workload():
        wall, nbytes, applied, results = 0.0, 0, 0, {}
        for name, (frame, names) in queries.items():
            t0 = time.perf_counter()
            table, m = frame.collect(with_metrics=True)
            wall += time.perf_counter() - t0
            nbytes += sum(o.detail.get("bytes_scanned", 0)
                          for o in m.operators if o.name == "Scan")
            applied += sum(1 for e in m.events
                           if e.get("category") == "rule"
                           and e.get("action") == "applied")
            results[name] = sorted_columns(table, names)
        return wall, nbytes, applied, results

    def passes():
        wall = nbytes = applied = 0
        results = None
        for _ in range(ADVISOR_REPEATS):
            w, b, a, r = workload()
            if results is not None:
                check(all(all(torch.equal(x, y) for x, y in
                              zip(r[q], results[q])) for q in r),
                      "advisor: a repeat gave different rows")
            results = r
            wall, nbytes, applied = wall + w, nbytes + b, applied + a
        return wall, nbytes, applied, results

    before_wall, before_bytes, before_applied, before = passes()
    for name, (_frame, names) in queries.items():
        want = sorted_columns(pa_table(oracle[name]), names)
        check(all(torch.equal(x, y) for x, y in zip(before[name], want)),
              f"advisor {name}: rows differ from numpy")
    check(before_applied == 0, "advisor: an index served before any build")

    advisor = hs.advisor()
    builds = []
    build_one = advisor.executor._build_one

    def timed_build(config, scan):
        t0 = time.perf_counter()
        build_one(config, scan)
        builds.append({"index": config.index_name,
                       "kind": type(config).__name__,
                       "seconds": time.perf_counter() - t0})

    advisor.executor._build_one = timed_build
    t0 = time.perf_counter()
    summary = advisor.run_once()
    out["advise_s"] = time.perf_counter() - t0
    built = [dec for dec in summary["decisions"]
             if dec.get("action") == "built"]
    check(built, f"advisor: nothing built: {summary['decisions']}")

    after_wall, after_bytes, after_applied, after = passes()
    check(after_applied > 0, "advisor: no rule applied after the builds")
    check(after_bytes < before_bytes,
          f"advisor: {after_bytes} bytes scanned after, {before_bytes} "
          "before")
    check(all(all(torch.equal(x, y) for x, y in zip(after[q], before[q]))
              for q in queries),
          "advisor: results differ before and after the builds")
    out.update(
        signatures=len(summary["signatures"]),
        recommended=len(summary["recommendations"]),
        built=sum(len(dec.get("indexes", ())) for dec in built),
        builds=builds, build_s=sum(b["seconds"] for b in builds),
        bytes_before=before_bytes, bytes_after=after_bytes,
        wall_before_s=before_wall, wall_after_s=after_wall,
        rules_applied_after=after_applied,
        decisions=[{k: dec.get(k) for k in ("name", "kind", "action",
                                            "score", "est_index_bytes",
                                            "indexes", "reason")}
                   for dec in summary["decisions"]])
    return out


MESH_SHARDS = 4                 # the virtual mesh on the one card
MESH_BUCKETS = 200
MESH_ROW_BYTES = 32             # routed per row: key, id, score, bucket id
MESH_RIGHT_BUCKETS = 64         # join B's right index on the mesh
MESH_STRING_ROWS = 1 << 20      # the string-key join's left rows (right: half)
SPMD_KEY = "spark.hyperspace.distribution.spmd.enabled"


def _shard_tags(root):
    """{bucket: shard} of a born-sharded version dir's files."""
    tags = {}
    for name in os.listdir(root):
        if name.endswith(".parquet"):
            bucket, shard = name[len("part-"):-len(".parquet")].split("-s")
            tags[int(bucket)] = int(shard)
    return tags


def _routed_rows(owner, n_ici, n_dcn):
    """Rows that change shard in the build exchange: one stage on a flat
    mesh (to the owner), two on a (dcn, shard) grid (to the owner's
    position within the source's slice, then to the owner's slice)."""
    import numpy as np

    n_total = n_ici * n_dcn
    local = -(-len(owner) // n_total)
    src = np.arange(len(owner)) // local
    stage1 = owner % n_ici != src % n_ici
    if n_dcn == 1:
        return int(stage1.sum())
    after1 = (src // n_ici) * n_ici + owner % n_ici
    return int(stage1.sum() + (owner // n_ici != after1 // n_ici).sum())


def phase_mesh(work, device, n_rows=N_ROWS):
    """Distribution on a virtual MESH_SHARDS-shard mesh of `device` (one
    card holds every shard): the born-sharded build of a MESH_BUCKETS
    index over the filter rung's source (`key`; `id`, `score`) on the
    flat mesh and on a 2 x 2 (dcn, shard) mesh, each bucket file
    byte-equal to a single-device build; then, through the rules, the
    point and full-range filters on the mesh index and a group aggregate
    over the source, each against numpy and against the same query with
    distribution off. Runs last: nothing distributed before it, and the
    virtual mesh is reset on the way out."""
    import json

    import numpy as np
    import pyarrow.parquet as pq
    import torch

    from hyperspace_tpu_torch import (Hyperspace, HyperspaceConf,
                                      HyperspaceSession, IndexConfig, col,
                                      lit, telemetry)
    from hyperspace_tpu_torch.io import builder
    from hyperspace_tpu_torch.ops.cuda import hash_kernel
    from hyperspace_tpu_torch.parallel import virtual
    from hyperspace_tpu_torch.parallel.mesh import bucket_ranges

    reg = telemetry.get_registry()
    kinds = ("build", "filter", "aggregate")

    def execs():
        return {k: reg.counter(f"mesh.{k}.execs").value for k in kinds}

    earlier = execs()
    check(not any(earlier.values()),
          f"mesh: the earlier phases distributed on one card: {earlier}")

    root = os.path.join(work, "mesh")
    t0 = time.perf_counter()
    src = os.path.join(root, "src")
    cols = write_source(src, n_rows)
    out = {"rows": n_rows, "shards": MESH_SHARDS, "buckets": MESH_BUCKETS,
           "virtual": True, "device": str(device),
           "device_count": (torch.cuda.device_count()
                            if device.type == "cuda" else 0),
           "source_s": time.perf_counter() - t0}

    def session(tag, **conf):
        settings = {"spark.hyperspace.warehouse.dir":
                    os.path.join(root, tag, "wh"),
                    "spark.hyperspace.index.num.buckets": str(MESH_BUCKETS),
                    "spark.hyperspace.execution.min.device.rows": "0"}
        settings.update(conf)
        sess = HyperspaceSession(HyperspaceConf(settings), device=device)
        return sess, Hyperspace(sess)

    def build(tag, **conf):
        sess, hs = session(tag, **conf)
        df = sess.read_parquet(src)
        launches = hash_kernel.hash_lanes_to_buckets.launches
        t0 = time.perf_counter()
        hs.create_index(df, IndexConfig("meshIdx", ["key"], ["id", "score"]))
        seconds = time.perf_counter() - t0
        (entry,) = Hyperspace.get_context(
            sess).index_collection_manager.get_indexes(["ACTIVE"])
        return (sess, df, entry, seconds,
                hash_kernel.hash_lanes_to_buckets.launches - launches)

    def file_bytes(root_dir):
        out = {}
        for name in os.listdir(root_dir):
            if name.endswith(".parquet"):
                with open(os.path.join(root_dir, name), "rb") as f:
                    out[int(name[len("part-"):len("part-") + 5])] = f.read()
        return out

    single_sess, single_df, single, single_s, single_launches = build(
        "single", **{"spark.hyperspace.distribution.enabled": "false"})
    check(single.shard_layout is None, "mesh: a single-device build "
          "recorded a shard layout")
    single_files = file_bytes(single.content.root)
    key = cols["key"]
    owner = (np_bucket_ids_int64(key, MESH_BUCKETS).astype(np.int64)
             * MESH_SHARDS // MESH_BUCKETS)

    virtual.ensure_devices(MESH_SHARDS, device=device)
    try:
        builds = {}
        for tag, slices in (("flat", 1), ("grid", 2)):
            sess, df, entry, seconds, launches = build(tag, **{
                "spark.hyperspace.distribution.enabled": "true",
                "spark.hyperspace.distribution.slices": str(slices)})
            data = entry.content.root
            tags = _shard_tags(data)
            check(sorted(set(tags.values())) == list(range(MESH_SHARDS)),
                  f"mesh {tag}: files carry shards {sorted(set(tags.values()))}")
            ranges = bucket_ranges(MESH_BUCKETS, MESH_SHARDS)
            check(all(ranges[s][0] <= b < ranges[s][1]
                      for b, s in tags.items()),
                  f"mesh {tag}: a bucket file names another shard")
            ref = os.path.join(root, tag, "layout_ref")
            builder.write_shard_layout(ref, MESH_BUCKETS, MESH_SHARDS,
                                       n_slices=slices)
            with open(os.path.join(ref, builder.SHARD_LAYOUT_FILE),
                      "rb") as f:
                want_layout = f.read()
            with open(os.path.join(data, builder.SHARD_LAYOUT_FILE),
                      "rb") as f:
                got_layout = f.read()
            check(got_layout == want_layout,
                  f"mesh {tag}: _shard_layout.json differs from the record "
                  f"of bucket_ranges({MESH_BUCKETS}, {MESH_SHARDS})")
            layout = json.loads(got_layout)
            check(layout["numSlices"] == slices,
                  f"mesh {tag}: numSlices {layout['numSlices']}")
            check(entry.shard_layout == builder.summarize_shard_layout(
                layout), f"mesh {tag}: the log entry's shardLayout is "
                f"{entry.shard_layout}")
            files = file_bytes(data)
            check(set(files) == set(single_files),
                  f"mesh {tag}: buckets differ from the single-device build")
            same = sum(files[b] == single_files[b] for b in files)
            check(same == len(files),
                  f"mesh {tag}: {len(files) - same} bucket files differ "
                  "from the single-device build")
            if device.type == "cuda":
                check(launches >= MESH_SHARDS,
                      f"mesh {tag}: the build launched the hash kernel "
                      f"{launches} times")
            shard_rows = [0] * MESH_SHARDS
            for name in os.listdir(data):
                if name.endswith(".parquet"):
                    shard_rows[int(name[-10:-8])] += pq.ParquetFile(
                        os.path.join(data, name)).metadata.num_rows
            check(shard_rows == np.bincount(
                owner, minlength=MESH_SHARDS).tolist(),
                f"mesh {tag}: shard rows {shard_rows}")
            builds[tag] = {
                "seconds": seconds, "launches": launches,
                "shard_rows": shard_rows, "files": len(files),
                "routed_bytes": MESH_ROW_BYTES * _routed_rows(
                    owner, MESH_SHARDS // slices, slices)}
            if tag == "flat":
                flat_sess, flat_df, flat_root = sess, df, data
            else:
                grid_sess = sess
        out["build"] = {"single_s": single_s,
                        "single_launches": single_launches, **builds}

        # Filters through the rules on the mesh index; distribution off on
        # the same index and lake for the other side.
        off_sess, _off_hs = session("flat", **{
            "spark.hyperspace.distribution.enabled": "false"})
        off_df = off_sess.read_parquet(src)
        key_hit = int(key[0])
        queries = {
            "point": (lambda d: d.filter(col("key") == lit(key_hit))
                      .select("id", "score"), key == key_hit),
            "range": (lambda d: d.filter(col("key") >= lit(0))
                      .select("id", "score"), np.ones(n_rows, bool))}
        filters = {}
        sync = {}
        for name, (make, mask) in queries.items():
            results = {}
            for side, sess, d in (("mesh", flat_sess, flat_df),
                                  ("single", off_sess, off_df)):
                sess.enable_hyperspace()
                frame = make(d)
                roots = [p for leaf in sess.optimize(frame.plan)
                         .collect_leaves() for p in leaf.root_paths]
                check(roots and all(r.startswith(flat_root)
                                    for r in roots),
                      f"mesh {name}/{side}: not served by the mesh index: "
                      f"{roots}")
                before = execs()["filter"]
                table, m = frame.collect(with_metrics=True)
                moved = execs()["filter"] - before
                check((moved > 0) == (side == "mesh"),
                      f"mesh {name}/{side}: mesh.filter.execs moved {moved}")
                if side == "mesh":
                    sync[name] = m.counters.get("mesh.sync_s", 0.0)
                    triggers = {e.get("trigger")
                                for e in m.events_of("fusion", "lane")}
                    check("mesh-distribution" in triggers,
                          f"mesh {name}: fused stage triggers {triggers}")
                ids = table.column("id").to_numpy()
                order = np.argsort(ids)
                want = np.nonzero(mask)[0]
                check(np.array_equal(ids[order], want),
                      f"mesh {name}/{side}: wrong rows")
                check(np.array_equal(
                    table.column("score").to_numpy()[order],
                    cols["score"][want]), f"mesh {name}/{side}: wrong scores")
                results[side] = (table, wall_ms(frame.collect))
            check(results["mesh"][0].equals(results["single"][0]),
                  f"mesh {name}: distribution on and off differ")
            filters[name] = {"rows": results["mesh"][0].num_rows,
                             "mesh_ms": results["mesh"][1],
                             "single_ms": results["single"][1]}
        out["filter"] = filters

        # The group aggregate over the source.
        k2 = cols["k2"]
        n_groups = int(k2.max()) + 1
        count = np.bincount(k2, minlength=n_groups)
        sum_id = np.zeros(n_groups, np.int64)
        np.add.at(sum_id, k2, cols["id"])
        min_id = np.full(n_groups, np.iinfo(np.int64).max)
        np.minimum.at(min_id, k2, cols["id"])
        max_id = np.full(n_groups, np.iinfo(np.int64).min)
        np.maximum.at(max_id, k2, cols["id"])
        score = cols["score"]
        mean = np.bincount(k2, weights=score, minlength=n_groups) / count
        dev = score - mean[k2]
        sd = np.sqrt(np.bincount(k2, weights=dev * dev, minlength=n_groups)
                     / (count - 1))
        specs = (("count", "*", "n"), ("sum", "id", "sum_id"),
                 ("min", "id", "min_id"), ("max", "id", "max_id"),
                 ("avg", "score", "avg_score"), ("stddev", "score", "sd"))
        aggs = {}
        for side, sess, d in (("mesh", flat_sess, flat_df),
                              ("single", off_sess, off_df)):
            frame = d.group_by("k2").agg(*specs)
            before = execs()["aggregate"]
            table, m = frame.collect(with_metrics=True)
            moved = execs()["aggregate"] - before
            check((moved > 0) == (side == "mesh"),
                  f"mesh aggregate/{side}: mesh.aggregate.execs moved "
                  f"{moved}")
            if side == "mesh":
                sync["aggregate"] = m.counters.get("mesh.sync_s", 0.0)
            t = table.sort_by("k2")
            check(np.array_equal(t.column("k2").to_numpy(),
                                 np.nonzero(count)[0]),
                  f"mesh aggregate/{side}: wrong groups")
            for name, want in (("n", count), ("sum_id", sum_id),
                               ("min_id", min_id), ("max_id", max_id)):
                check(np.array_equal(t.column(name).to_numpy(), want),
                      f"mesh aggregate/{side}: {name} differs from numpy")
            for name, want in (("avg_score", mean), ("sd", sd)):
                check(np.allclose(t.column(name).to_numpy(), want,
                                  rtol=1e-9, atol=0),
                      f"mesh aggregate/{side}: {name} differs from numpy")
            aggs[side] = (t, wall_ms(frame.collect))
        on, off = aggs["mesh"][0], aggs["single"][0]
        for name in on.column_names:
            a, b = on.column(name).to_numpy(), off.column(name).to_numpy()
            check(np.array_equal(a, b) if a.dtype.kind in "iub"
                  else np.allclose(a, b, rtol=1e-9, atol=0),
                  f"mesh aggregate: {name} differs with distribution off")
        out["aggregate"] = {"groups": on.num_rows,
                            "mesh_ms": aggs["mesh"][1],
                            "single_ms": aggs["single"][1]}
        out["sync_s"] = sync
        out["spmd"], right_src, want = _mesh_joins(
            root, device, n_rows, cols, flat_sess, grid_sess)
        out["replica"] = _replica_block(root, device, n_rows, cols,
                                        right_src, want)
        after = execs()
        out["execs"] = {k: after[k] - earlier[k] for k in kinds}
    finally:
        virtual.reset()
    out["card"] = card_line() if device.type == "cuda" else "cpu"
    return out


def _mesh_joins(root, device, n_rows, cols, flat_sess, grid_sess):
    """The SPMD join on the virtual mesh, through the rules, each query
    against numpy and against the same query with
    `distribution.spmd.enabled=false` (the single-device join over the
    same born-sharded indexes), with `spmd.fallbacks` unchanged and the
    join's lane `spmd`:

    - join B: the mesh index (`meshIdx`, MESH_BUCKETS buckets) with the
      join rung's right source (n_rows/2 rows) indexed at
      MESH_RIGHT_BUCKETS on the flat mesh — the right side re-buckets
      between shards, one hash-kernel launch per shard — then a
      left_outer join over the same pair;
    - join A: the same source indexed at MESH_BUCKETS (co-bucketed), then
      a left_semi join over that pair;
    - a string-key join of two small sources (MESH_STRING_ROWS and half
      that), both at MESH_BUCKETS;
    - join A on the 2 x 2 (dcn, shard) mesh.

    The hash kernel is also held against its plain version at join B's
    per-shard re-bucket shape (those launches are taken back out of the
    count). Returns the section's record."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq
    import torch

    from hyperspace_tpu_torch import Hyperspace, IndexConfig, telemetry
    from hyperspace_tpu_torch.engine.physical import (SortMergeJoinExec,
                                                      plan_physical)
    from hyperspace_tpu_torch.ops.cuda import hash_kernel
    from hyperspace_tpu_torch.parallel import spmd
    from hyperspace_tpu_torch.parallel.context import distribution_mesh

    reg = telemetry.get_registry()
    t_section = time.perf_counter()
    launches0 = hash_kernel.hash_lanes_to_buckets.launches
    links = ("ici", "dcn")
    bytes0 = {k: reg.counter(f"spmd.repartition.{k}.bytes").value
              for k in links}
    right_src = os.path.join(root, "right")
    right = write_right_source(right_src, SEED + 2, n_rows)
    left = {"key": cols["key"], "id": cols["id"]}
    t0 = time.perf_counter()
    inner = np_join(left, right)
    want = canonical(*inner, device=device)
    counts = np.bincount(right["key"], minlength=int(left["key"].max()) + 1)
    matched = counts[left["key"]] > 0
    out = {"right_rows": len(right["key"]),
           "oracle_s": time.perf_counter() - t0, "joins": {}}

    def build(sess, src, name, key, include, buckets):
        sess.conf.set("spark.hyperspace.index.num.buckets", str(buckets))
        df = sess.read_parquet(src)
        t0 = time.perf_counter()
        Hyperspace(sess).create_index(df, IndexConfig(name, [key], include))
        sess.conf.set("spark.hyperspace.index.num.buckets",
                      str(MESH_BUCKETS))
        return df, time.perf_counter() - t0

    def same_pairs(table, expect, tag):
        got = canonical(table.column("id").to_numpy(),
                        table.column("val").to_numpy(), device=device)
        check(all(torch.equal(a, b) for a, b in zip(got, expect)),
              f"{tag}: rows differ from numpy")

    def run(name, sess, frame, check_rows, rebucket, iters):
        """One query: its rows, lane, fallbacks and launches, then warm
        ms on the lane and with the lane off."""
        sess.enable_hyperspace()
        f0 = reg.counter("spmd.fallbacks").value
        j0 = reg.counter("mesh.spmd.join_execs").value
        h0 = hash_kernel.hash_lanes_to_buckets.launches
        table, metrics = frame.collect(with_metrics=True)
        launched = hash_kernel.hash_lanes_to_buckets.launches - h0
        check(reg.counter("spmd.fallbacks").value == f0,
              f"spmd {name}: spmd.fallbacks moved")
        check(reg.counter("mesh.spmd.join_execs").value == j0 + 1,
              f"spmd {name}: the join did not run the SPMD lane")
        lanes = [o.detail.get("lane") for o in metrics.operators
                 if o.name == "SortMergeJoin"]
        check(lanes == ["spmd"], f"spmd {name}: join lanes {lanes}")
        if device.type == "cuda":
            check(launched >= MESH_SHARDS if rebucket else launched == 0,
                  f"spmd {name}: the hash kernel launched {launched} "
                  "times in one query")
        check_rows(table, f"spmd {name}")
        on_ms = wall_ms(frame.collect, iters)
        sess.conf.set(SPMD_KEY, "false")
        try:
            j0 = reg.counter("mesh.spmd.join_execs").value
            off = frame.collect()
            check(reg.counter("mesh.spmd.join_execs").value == j0,
                  f"spmd {name}: the lane ran with spmd disabled")
            check_rows(off, f"spmd {name} (spmd off)")
            off_ms = wall_ms(frame.collect, iters)
        finally:
            sess.conf.set(SPMD_KEY, "true")
        out["joins"][name] = {"rows": table.num_rows, "lane": lanes[0],
                              "hash_launches": launched, "spmd_ms": on_ms,
                              "single_device_ms": off_ms}

    # Sort-merge joins only: a small side (the membership join's keys,
    # the string join) would otherwise plan as a broadcast join.
    for sess in (flat_sess, grid_sess):
        sess.conf.set("spark.hyperspace.broadcast.threshold", "-1")
    flat_left = flat_sess.read_parquet(os.path.join(root, "src"))
    # Join B first, while the 64-bucket index is the right side's only one.
    right_df, out["right_build_s"] = build(
        flat_sess, right_src, "meshRight64", "key", ["val"],
        MESH_RIGHT_BUCKETS)
    frame_b = (flat_left.select("key", "id")
               .join(right_df.select("key", "val"), on="key")
               .select("id", "val"))
    run("B", flat_sess, frame_b,
        lambda t, tag: same_pairs(t, want, tag), True, 3)

    # The kernel at the re-bucket's shape: join B's right side, shard by
    # shard, against the plain version.
    mesh = distribution_mesh(flat_sess.conf)
    node = next(n for n in plan_physical(
        flat_sess.optimize(frame_b.plan), conf=flat_sess.conf).collect()
        if isinstance(n, SortMergeJoinExec))
    rsh = node.right.execute_sharded(node.num_buckets, mesh)
    check(rsh is not None and rsh.num_buckets == MESH_RIGHT_BUCKETS,
          "spmd: join B's right side is not born sharded")
    n0 = hash_kernel.hash_lanes_to_buckets.launches
    worst = 0
    shapes = []
    for lanes in spmd.routing_lanes(rsh, ["key"]):
        got = hash_kernel.hash_lanes_to_buckets(lanes, MESH_BUCKETS)
        plain = hash_kernel.hash_lanes_to_buckets_reference(lanes,
                                                            MESH_BUCKETS)
        worst = max(worst, int((got.long() - plain.long()).abs().max()))
        shapes.append(list(lanes.shape))
    hash_kernel.hash_lanes_to_buckets.launches = n0
    check(worst == 0, "spmd: the hash kernel differs from its plain "
          "version at the re-bucket's shape")
    out["kernel"] = {"shapes": shapes, "num_buckets": MESH_BUCKETS,
                     "max_abs_err": worst, "tolerance": 0}

    def left_outer_rows(table, tag):
        val = table.column("val").to_numpy(zero_copy_only=False)
        ids = table.column("id").to_numpy()
        hit = ~np.isnan(val)
        same_pairs(pa.table({"id": ids[hit], "val": val[hit]}), want, tag)
        check(np.array_equal(np.sort(ids[~hit]), left["id"][~matched]),
              f"{tag}: unmatched left rows differ from numpy")

    run("left_outer", flat_sess,
        flat_left.select("key", "id")
        .join(right_df.select("key", "val"), on="key", how="left_outer")
        .select("id", "val"), left_outer_rows, True, 1)

    _df, out["right200_build_s"] = build(
        flat_sess, right_src, "meshRight200", "key", ["val"], MESH_BUCKETS)
    run("A", flat_sess, frame_b, lambda t, tag: same_pairs(t, want, tag),
        False, 3)

    def semi_rows(table, tag):
        check(np.array_equal(np.sort(table.column("id").to_numpy()),
                             left["id"][matched]),
              f"{tag}: rows differ from numpy")

    run("left_semi", flat_sess,
        flat_left.select("key", "id")
        .join(right_df.select("key"), on="key", how="left_semi")
        .select("id"), semi_rows, False, 1)

    # String keys: s<key> over the same key ranges, at a small size.
    n_str = min(MESH_STRING_ROWS, n_rows)
    rng = np.random.default_rng(SEED + 4)
    skeys = {"l": rng.integers(0, n_str // 4, n_str),
             "r": rng.integers(0, n_str // 4, n_str // 2)}
    sides = {}
    for tag, payload in (("l", "id"), ("r", "val")):
        src = os.path.join(root, f"str_{tag}")
        os.makedirs(src)
        n = len(skeys[tag])
        values = (np.arange(n, dtype=np.int64) if tag == "l"
                  else rng.random(n))
        pq.write_table(pa.table({
            "skey": pa.array([f"s{k}" for k in skeys[tag].tolist()]),
            payload: values}), os.path.join(src, "part-0.parquet"))
        df, _s = build(flat_sess, src, f"meshStr_{tag}", "skey", [payload],
                       MESH_BUCKETS)
        sides[tag] = (df.select("skey", payload), values)
    str_want = canonical(*np_join(
        {"key": skeys["l"], "id": sides["l"][1]},
        {"key": skeys["r"], "val": sides["r"][1]}), device=device)
    run("string", flat_sess,
        sides["l"][0].join(sides["r"][0], on="skey").select("id", "val"),
        lambda t, tag: same_pairs(t, str_want, tag), False, 1)

    # Join A on the 2 x 2 mesh: that mesh's index and a right index
    # built there. Replication off, so the join runs over the whole
    # (dcn, shard) mesh and not on one replica slice.
    grid_sess.conf.set(REPLICATION_KEY, "false")
    grid_left = grid_sess.read_parquet(os.path.join(root, "src"))
    grid_right, _s = build(grid_sess, right_src, "meshRight200", "key",
                           ["val"], MESH_BUCKETS)
    run("A_grid", grid_sess,
        grid_left.select("key", "id")
        .join(grid_right.select("key", "val"), on="key")
        .select("id", "val"), lambda t, tag: same_pairs(t, want, tag),
        False, 1)

    out["repartition_bytes"] = {
        k: reg.counter(f"spmd.repartition.{k}.bytes").value - bytes0[k]
        for k in links}
    check(out["repartition_bytes"]["ici"] > 0,
          "spmd: no row was re-bucketed between shards")
    out["hash_launches"] = (hash_kernel.hash_lanes_to_buckets.launches
                            - launches0)
    out["seconds"] = time.perf_counter() - t_section
    return out, right_src, want


REPLICATION_KEY = "spark.hyperspace.distribution.replication.enabled"
REPLICA_CLIENTS = 8
REPLICA_COLLECTS = 8            # per client and pass
REPLICA_JOIN_SLOTS = (2, 6)     # a client's collects that run join B
REPLICA_APPEND_ROWS = 1 << 12   # the committed append's rows (no key matches)


def _replica_block(root, device, n_rows, cols, right_src, want):
    """Read replicas on the 2 x 2 topology with replication on: the 2 x 2
    mesh index (`meshIdx`, MESH_BUCKETS buckets) and the join rung's
    right source indexed there at MESH_RIGHT_BUCKETS, then 8 client
    threads x 8 collects through the scheduler, each mixing point filters
    on `key` with join B (the right side re-buckets on the routed slice's
    2 shards: 2 hash launches a join). A warm-up pass fills both
    replicas; a timed pass, and one with `replication.enabled=false` (a
    record: both slices share one card). Every result equals its query's
    serial run (an order-insensitive digest), whose rows equal numpy.
    Then the segment cache's residency per slice, a committed append
    (which sweeps both slices' entries; the reads after it equal the
    reads before), and a cold-range pin: after the point filters made
    their buckets hot, a filter confined to a never-read bucket of the
    other slice routes to its home slice. Returns the block's record."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq
    import torch

    from hyperspace_tpu_torch import (Hyperspace, HyperspaceConf,
                                      HyperspaceSession, IndexConfig, col,
                                      lit, telemetry)
    from hyperspace_tpu_torch.engine.scheduler import get_scheduler
    from hyperspace_tpu_torch.io import segcache
    from hyperspace_tpu_torch.ops.cuda import hash_kernel
    from hyperspace_tpu_torch.parallel import replica
    from hyperspace_tpu_torch.parallel.mesh import bucket_owner

    reg = telemetry.get_registry()
    t_block = time.perf_counter()
    f0 = reg.counter("spmd.fallbacks").value
    replica.reset_router()
    router = replica.get_router()
    on_card = device.type == "cuda"

    def launches():
        return hash_kernel.hash_lanes_to_buckets.launches

    def routed():
        return [reg.counter(f"serve.replica.{i}.routed").value
                for i in (0, 1)]

    # The block's own hard-linked copy of the right source: its append
    # touches no other phase's source.
    rep_src = os.path.join(root, "replica_right")
    os.makedirs(rep_src)
    for name in sorted(os.listdir(right_src)):
        os.link(os.path.join(right_src, name), os.path.join(rep_src, name))
    sess = HyperspaceSession(HyperspaceConf({
        "spark.hyperspace.warehouse.dir": os.path.join(root, "grid", "wh"),
        "spark.hyperspace.index.num.buckets": str(MESH_RIGHT_BUCKETS),
        "spark.hyperspace.execution.min.device.rows": "0",
        "spark.hyperspace.broadcast.threshold": "-1",
        "spark.hyperspace.distribution.enabled": "true",
        "spark.hyperspace.distribution.slices": "2",
        REPLICATION_KEY: "true"}), device=device)
    hs = Hyperspace(sess)
    t0 = time.perf_counter()
    right_df = sess.read_parquet(rep_src)
    hs.create_index(right_df, IndexConfig("replicaRight", ["key"], ["val"]))
    out = {"build_s": time.perf_counter() - t0, "clients": REPLICA_CLIENTS,
           "collects_per_client": REPLICA_COLLECTS}
    (entry,) = [e for e in Hyperspace.get_context(sess)
                .index_collection_manager.get_indexes(["ACTIVE"])
                if e.name == "replicaRight"]
    right_root = os.path.dirname(entry.content.root.rstrip("/"))
    sess.enable_hyperspace()
    left_df = sess.read_parquet(os.path.join(root, "src"))
    key = cols["key"]
    # Two hot keys whose buckets both lie in one slice's range.
    all_buckets = np_bucket_ids_int64(key, MESH_BUCKETS)
    owners = all_buckets.astype(np.int64) * 2 // MESH_BUCKETS
    hot_keys = [int(key[0]), int(key[np.nonzero(
        (owners == owners[0]) & (all_buckets != all_buckets[0]))[0][0]])]
    mix = {"B": (left_df.select("key", "id")
                 .join(right_df.select("key", "val"), on="key")
                 .select("id", "val"))}
    for k in hot_keys:
        mix[f"p{k}"] = (left_df.filter(col("key") == lit(k))
                        .select("id", "score"))
    schedule = [["B" if j in REPLICA_JOIN_SLOTS
                 else f"p{hot_keys[(c + j) % len(hot_keys)]}"
                 for j in range(REPLICA_COLLECTS)]
                for c in range(REPLICA_CLIENTS)]
    joins_per_pass = sum(row.count("B") for row in schedule)

    # Serial runs: each against numpy; their digests are the reference.
    serial = {}
    for name, frame in mix.items():
        h0 = launches()
        table, m = frame.collect(with_metrics=True)
        check(m.replica in (0, 1), f"replica {name}: not routed "
              f"({m.replica})")
        if name == "B":
            got = canonical(table.column("id").to_numpy(),
                            table.column("val").to_numpy(), device=device)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  "replica B: rows differ from numpy")
            if on_card:
                check(launches() - h0 == 2, "replica B: the routed join "
                      f"launched the hash kernel {launches() - h0} times")
        else:
            k = int(name[1:])
            ids = table.column("id").to_numpy()
            order = np.argsort(ids)
            hit = np.nonzero(key == k)[0]
            check(np.array_equal(ids[order], hit)
                  and np.array_equal(table.column("score").to_numpy()[order],
                                     cols["score"][hit]),
                  f"replica {name}: rows differ from numpy")
        serial[name] = table_digest(table)
    # The same join with the SPMD lane off: the Exchange's partition
    # kernel, the rows unchanged.
    sess.conf.set(SPMD_KEY, "false")
    try:
        check(table_digest(mix["B"].collect()) == serial["B"],
              "replica B: the lane-off join differs")
    finally:
        sess.conf.set(SPMD_KEY, "true")

    pool = ThreadPoolExecutor(8)

    def run_pass(tag, peaks=None):
        results, errors = [], []
        lock = threading.Lock()
        start = threading.Barrier(REPLICA_CLIENTS)
        h0, r0 = launches(), routed()

        def client(c):
            start.wait()
            for name in schedule[c]:
                try:
                    table = mix[name].collect()
                except Exception as exc:
                    with lock:
                        errors.append(f"{name}: {exc!r}")
                    continue
                with lock:
                    results.append((name, table))

        stop = threading.Event()

        def poll():
            while not stop.is_set():
                for i in (0, 1):
                    v = reg.gauge(f"serve.replica.{i}.admitted_bytes").value
                    peaks[i] = max(peaks[i], v)
                time.sleep(0.001)

        threads = [threading.Thread(target=client, args=(c,),
                                    name=f"replica-{c}")
                   for c in range(REPLICA_CLIENTS)]
        poller = (threading.Thread(target=poll) if peaks is not None
                  else None)
        t0 = time.perf_counter()
        if poller is not None:
            poller.start()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        stop.set()
        if poller is not None:
            poller.join()
        check(not any(th.is_alive() for th in threads),
              f"replica {tag}: a client hung")
        check(not errors, f"replica {tag}: {errors[:3]}")
        n = REPLICA_CLIENTS * REPLICA_COLLECTS
        check(len(results) == n, f"replica {tag}: {len(results)} results")
        digests = list(pool.map(lambda nt: (nt[0], table_digest(nt[1])),
                                results))
        del results
        bad = [name for name, d in digests if d != serial[name]]
        check(not bad, f"replica {tag}: {len(bad)} results differ from "
              f"their serial runs ({sorted(set(bad))})")
        moved = [b - a for a, b in zip(r0, routed())]
        return {"qps": n / wall, "wall_s": wall, "routed": moved,
                "hash_launches": launches() - h0}

    try:
        warm = run_pass("warm-up")
        peaks = [0, 0]
        timed = run_pass("timed", peaks)
        for tag, rec in (("warm-up", warm), ("timed", timed)):
            n = REPLICA_CLIENTS * REPLICA_COLLECTS
            check(all(r > 0 for r in rec["routed"])
                  and sum(rec["routed"]) == n,
                  f"replica {tag}: routed {rec['routed']} of {n} collects")
            if on_card:
                check(rec["hash_launches"] == 2 * joins_per_pass,
                      f"replica {tag}: {rec['hash_launches']} hash launches "
                      f"for {joins_per_pass} routed joins")
        residency = segcache.get_cache().replica_residency(right_root)
        check(residency == {(0, 1): 2, (2, 3): 2},
              f"replica: residency of the right index {residency}")
        sess.conf.set(REPLICATION_KEY, "false")
        try:
            off = run_pass("replication off")
        finally:
            sess.conf.set(REPLICATION_KEY, "true")
        check(off["routed"] == [0, 0], f"replica off: routed {off['routed']}")
    finally:
        pool.shutdown()
    out.update({
        "joins_per_pass": joins_per_pass, "warm_up": warm, "timed": timed,
        "replication_off": off,
        "replica_max_share": max(timed["routed"]) / sum(timed["routed"]),
        "admitted_bytes_peak": {str(i): peaks[i] for i in (0, 1)},
        "residency": {",".join(map(str, t)): n
                      for t, n in residency.items()},
        "routed_counts": {str(i): n
                          for i, n in router.routed_counts().items()}})

    # A committed append: rows whose keys match no left row. The version
    # hooks sweep both slices' entries; the reads after it equal the
    # reads before.
    rng = np.random.default_rng(SEED + 6)
    pq.write_table(pa.table({
        "key": (n_rows + np.arange(REPLICA_APPEND_ROWS)).astype(np.int64),
        "val": rng.random(REPLICA_APPEND_ROWS)}),
        os.path.join(rep_src, "part-append.parquet"))
    t0 = time.perf_counter()
    hs.refresh_index("replicaRight", mode="full")
    out["refresh_s"] = time.perf_counter() - t0
    swept = segcache.get_cache().replica_residency(right_root)
    check(swept == {}, f"replica: the commit left entries {swept}")
    right_df = sess.read_parquet(rep_src)
    frame = (left_df.select("key", "id")
             .join(right_df.select("key", "val"), on="key")
             .select("id", "val"))
    # Idle slices tie-break on the router's routed counts: from a reset
    # two sequential collects go to slices 0 and 1.
    router.reset()
    seen = []
    while len(set(seen)) < 2 and len(seen) < 16:
        table, m = frame.collect(with_metrics=True)
        check(table_digest(table) == serial["B"],
              f"replica: a read after the commit (slice {m.replica}) "
              "differs")
        seen.append(m.replica)
    check(set(seen) == {0, 1}, f"replica: the re-reads went to {seen}")
    out["reads_after_commit"] = seen
    residency = segcache.get_cache().replica_residency(right_root)
    check(len(residency) == 2, f"replica: after the commit {residency}")

    # Cold-range pin. The scheduler routes a query's source plan, which
    # has no bucket spec; the optimized plan names the index's buckets.
    hot = {int(b) for b in np_bucket_ids_int64(
        np.asarray(hot_keys, dtype=np.int64), MESH_BUCKETS)}
    other = 1 - int(owners[0])
    cold_key = next(int(k) for k, b in zip(key.tolist(), all_buckets.tolist())
                    if b not in hot
                    and int(bucket_owner(b, MESH_BUCKETS, 2)) == other)
    cold_bucket = int(np_bucket_ids_int64(
        np.asarray([cold_key], dtype=np.int64), MESH_BUCKETS)[0])
    # The router was reset above, so this route mines the ring afresh.
    pins0 = reg.counter("serve.replica.cold_pinned").value
    plan = sess.optimize(left_df.filter(col("key") == lit(cold_key))
                         .select("id", "score").plan)
    choice = router.route(plan, sess.conf, get_scheduler())
    mined_hot = sorted(router.hot_buckets(
        plan.collect_leaves()[0].root_paths[0], 0.5))
    check(choice == other and reg.counter(
        "serve.replica.cold_pinned").value == pins0 + 1,
        f"replica: the cold bucket {cold_bucket} routed to {choice}, not "
        f"its home slice {other} (hot {mined_hot})")
    out["cold_pin"] = {"bucket": cold_bucket, "home": other,
                       "routed": choice, "hot_buckets": mined_hot}
    check(reg.counter("spmd.fallbacks").value == f0,
          "replica: spmd.fallbacks moved")
    out["seconds"] = time.perf_counter() - t_block
    return out


def pa_table(cols):
    import pyarrow as pa
    return pa.table(cols)


def counted(counters, fn, *args):
    """Run one phase of the main path with every kernel's launch count
    set to 0 just before it; returns (result, launches per kernel)."""
    for c in counters:
        c.launches = 0
    result = fn(*args)
    return result, [c.launches for c in counters]


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one card")
    sys.path.insert(0, REPO)
    try:
        import hyperspace_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(f"hyperspace_tpu_torch is not beside this script ({exc})")

    import pyarrow  # the lake phases need it

    from hyperspace_tpu_torch import (Hyperspace, HyperspaceConf,
                                      HyperspaceSession)
    from hyperspace_tpu_torch.ops.cuda import build as kbuild
    from hyperspace_tpu_torch.ops.cuda import (hash_kernel, partition_kernel,
                                               run_bounds_kernel)

    card = card_line()
    emit("env", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         pyarrow=pyarrow.__version__,
         device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    from hyperspace_tpu_torch import native, telemetry

    # Which libraries this run builds (the telemetry phase holds the
    # compile seam's counts against it).
    fresh = {name: not os.path.exists(kbuild.library_path(name))
             for name in kbuild.SOURCES}
    fresh["hyperspace_host"] = not os.path.exists(native.library_path())
    t0 = time.perf_counter()
    seconds = kbuild.build_all()
    emit("build_kernels", seconds=time.perf_counter() - t0,
         per_library=seconds)

    t0 = time.perf_counter()
    check(native.get_lib() is not None,
          "the native host library did not build or load")
    emit("build_native", seconds=time.perf_counter() - t0,
         library=native.library_path())
    emit("transfer", **phase_transfer(torch.device("cuda")))

    rows = [phase_kernel_hash(hash_kernel),
            phase_kernel_partition(partition_kernel, hash_kernel),
            phase_kernel_run_bounds(run_bounds_kernel)]
    counters = (hash_kernel.hash_lanes_to_buckets,
                partition_kernel.partition_ids_and_histogram,
                run_bounds_kernel.run_bounds)

    work = os.path.join(REPO, "_smoke")
    shutil.rmtree(work, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        cols = write_source(os.path.join(work, "src"))
        emit("source", rows=N_ROWS, files=N_FILES,
             seconds=time.perf_counter() - t0)
        sess = HyperspaceSession(HyperspaceConf(
            {"spark.hyperspace.warehouse.dir": os.path.join(work, "wh")}))
        hs = Hyperspace(sess)
        # The main path, one phase after another: each phase's counts
        # from zero, read right after it.
        launches = [0] * len(counters)

        def tally(phase, counts):
            emit("launches", of=phase, **{
                row["name"]: n for row, n in zip(rows, counts)})
            for i, n in enumerate(counts):
                launches[i] += n
            return counts

        (df, root), n = counted(counters, phase_build, hs, sess,
                                os.path.join(work, "src"), cols)
        tally("build", n)
        emit("build_lanes", **build_lanes(os.path.join(work, "src"),
                                          torch.device("cuda")))
        _, n = counted(counters, phase_query, sess, df, root, cols)
        tally("query", n)
        (out, (right_df, right)), n = counted(counters, phase_join, hs,
                                             sess, df, work, cols)
        emit("join", **out)
        tally("join", n)
        out, n = counted(counters, phase_telemetry, hs, sess, df, work,
                         fresh)
        emit("telemetry", **out)
        check(tally("telemetry", n)[1] > 0,
              "the telemetry phase never launched the partition kernel")
        out, n = counted(counters, phase_serve, hs, sess, work, df, cols)
        emit("serve", **out)
        hash_n, partition_n, _ = tally("serve", n)
        check(hash_n > 0 and partition_n > 0,
              f"the serve phase launched hash {hash_n}, "
              f"partition {partition_n} times")
        out, n = counted(counters, phase_hybrid, hs, sess, work, cols,
                         right_df, right)
        emit("hybrid", **out)
        hash_n, partition_n, _ = tally("hybrid", n)
        check(hash_n > 0 and partition_n > 0,
              f"the hybrid phase launched hash {hash_n}, "
              f"partition {partition_n} times")
        out, n = counted(counters, phase_maintenance, hs, sess, work)
        emit("maintenance", **out)
        check(tally("maintenance", n)[0] > 0,
              "the maintenance phase never launched the hash kernel")
        out, n = counted(counters, phase_tpch, hs, sess, work)
        emit("tpch", **out)
        hash_n, _, run_bounds_n = tally("tpch", n)
        check(hash_n > 0 and run_bounds_n > 0,
              f"the tpch phase launched hash {hash_n}, "
              f"run bounds {run_bounds_n} times")
        out, n = counted(counters, phase_tpcds, hs, sess, work)
        emit("tpcds", **out)
        check(tally("tpcds", n)[0] > 0,
              "the tpcds phase never launched the hash kernel")
        out, n = counted(counters, phase_skipping, work,
                         torch.device("cuda"))
        emit("skipping", **out)
        tally("skipping", n)
        out, n = counted(counters, phase_advisor, work)
        emit("advisor", **out)
        check(tally("advisor", n)[0] > 0,
              "the advisor's builds never launched the hash kernel")
        emit("fusion", **fusion_summary())
        # Last: the virtual mesh must not touch any phase above.
        out, n = counted(counters, phase_mesh, work, torch.device("cuda"))
        emit("mesh", **out)
        rows[0]["max_abs_err"] = max(rows[0]["max_abs_err"],
                                     out["spmd"]["kernel"]["max_abs_err"])
        check(tally("mesh", n)[0] > 0,
              "the mesh phase never launched the hash kernel")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for row, count in zip(rows, launches):
        check(count > 0, f"the main path never launched {row['name']}")
        row["launches"] = count
    unavailable = telemetry.get_registry().counter(
        "native.unavailable").value
    check(unavailable == 0,
          f"{unavailable} calls fell back from the native host library")
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
