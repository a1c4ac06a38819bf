"""Framework-wide constants: config keys, op-log layout, lifecycle states.

Parity: reference `index/IndexConstants.scala:21-50` and
`actions/Constants.scala:19-33`. Config keys keep the reference's
`spark.hyperspace.*` spelling (so existing user configs translate 1:1) and the
`hyperspace.*` short form is accepted as an alias (see `config.py`).
"""

INDEXES_DIR = "indexes"

# Config keys (reference `index/IndexConstants.scala:24-35`).
INDEX_SYSTEM_PATH = "spark.hyperspace.system.path"
INDEX_CREATION_PATH = "spark.hyperspace.index.creation.path"
INDEX_SEARCH_PATHS = "spark.hyperspace.index.search.paths"
INDEX_NUM_BUCKETS = "spark.hyperspace.index.num.buckets"
# The reference defaults numBuckets to spark.sql.shuffle.partitions (= 200);
# 200 is kept for drop-in config parity.
INDEX_NUM_BUCKETS_DEFAULT = 200

INDEX_CACHE_EXPIRY_DURATION_SECONDS = (
    "spark.hyperspace.index.cache.expiryDurationInSeconds")
INDEX_CACHE_EXPIRY_DURATION_SECONDS_DEFAULT = 300

# Decoded-batch cache budgets (no reference analog — Spark's block manager
# owns executor memory there). Session-conf keys; when unset, the
# HYPERSPACE_READ_CACHE_BYTES / HYPERSPACE_DEVICE_CACHE_BYTES env vars
# (read at `io/parquet.py` import) provide the process-wide defaults.
# The device budget shares device memory with join/sort working sets —
# size it against the largest query, not the card.
READ_CACHE_BYTES_KEY = "spark.hyperspace.cache.read.bytes"
DEVICE_CACHE_BYTES_KEY = "spark.hyperspace.cache.device.bytes"

# Device segment cache (`io/segcache.py`): byte budget for
# device-resident index segments (falls back to the legacy
# `cache.device.bytes` key, then the HYPERSPACE_SEGMENT_CACHE_BYTES /
# HYPERSPACE_DEVICE_CACHE_BYTES env defaults), and a comma-separated list
# of index names whose segments are PINNED — never evicted by byte
# pressure (invalidation on refresh/optimize/vacuum still drops them).
SEGMENT_CACHE_BYTES_KEY = "spark.hyperspace.cache.segments.bytes"
SEGMENT_CACHE_PIN_INDEXES = "spark.hyperspace.cache.segments.pin.indexes"

# Tiered segment cache: host-RAM tier below the device tier
# (`io/segcache.py`). When > 0, a segment evicted from the device tier by
# byte pressure is DEMOTED into a host-resident copy (decoded columns
# fetched D2H once) instead of dropped outright, up to this many host
# bytes. A later read of a demoted key re-promotes through the
# TransferEngine fill lane — H2D paid, parquet decode skipped. 0 (the
# default) disables the tier. Invalidation sweeps both tiers.
SEGMENT_CACHE_HOST_BYTES_KEY = "spark.hyperspace.cache.segments.host.bytes"
SEGMENT_CACHE_HOST_BYTES_DEFAULT = 0

# Object-store OCC: backends with no create precondition (neither GCS
# generation match nor S3 conditional put nor atomic exclusive create)
# make write_log RAISE, because check-then-create corrupts the op log
# under concurrency — unless this conf explicitly accepts single-writer
# semantics.
SINGLE_WRITER = "spark.hyperspace.single.writer"

# Storage-IO retry policy (`utils/retry.py`, the ONE backoff point in the
# package — the metrics-coverage lint fails any ad-hoc sleep-in-except
# loop elsewhere). Exponential backoff with deterministic per-operation
# jitter; transient errors (connection resets, timeouts, HTTP 429/5xx,
# torn reads of in-flight publishes) retry up to `attempts` total tries,
# permanent errors (not-found, permission, 4xx) fail immediately.
IO_RETRY_ATTEMPTS = "spark.hyperspace.io.retry.attempts"
IO_RETRY_ATTEMPTS_DEFAULT = 5
IO_RETRY_BASE_MS = "spark.hyperspace.io.retry.base.ms"
IO_RETRY_BASE_MS_DEFAULT = 20
IO_RETRY_MAX_MS = "spark.hyperspace.io.retry.max.ms"
IO_RETRY_MAX_MS_DEFAULT = 2000

# Pipelined transfer engine (`io/transfer.py`, THE host<->device link
# seam): chunk granularity of large H2D stagings, the bounded in-flight
# byte window across all outstanding puts, and the staging-thread pool
# width (decode/convert of chunk i+1 overlaps chunk i's transfer).
# Tune chunk.bytes against the link: small enough that several chunks
# pipeline, large enough that the per-copy launch latency amortizes.
IO_TRANSFER_CHUNK_BYTES = "spark.hyperspace.io.transfer.chunk.bytes"
IO_TRANSFER_CHUNK_BYTES_DEFAULT = 4 * 1024 * 1024
IO_TRANSFER_INFLIGHT_BYTES = "spark.hyperspace.io.transfer.inflight.bytes"
IO_TRANSFER_INFLIGHT_BYTES_DEFAULT = 64 * 1024 * 1024
IO_TRANSFER_THREADS = "spark.hyperspace.io.transfer.threads"
IO_TRANSFER_THREADS_DEFAULT = 2
# Bound on how long a put may wait for in-flight-window headroom. A copy
# that never completes would otherwise block every later caller forever;
# past the timeout the waiter raises a TYPED transient error
# (`TransferAcquireTimeoutError`, a TimeoutError) and counts
# `io.transfer.acquire_timeouts`. <= 0 disables the bound.
IO_TRANSFER_ACQUIRE_TIMEOUT_MS = \
    "spark.hyperspace.io.transfer.acquire.timeout.ms"
IO_TRANSFER_ACQUIRE_TIMEOUT_MS_DEFAULT = 30_000

# Crash recovery lease: a maintenance action that finds the op log's
# latest entry in a TRANSIENT state (CREATING/REFRESHING/...) treats the
# in-flight writer as crashed once the entry is older than this many
# seconds, and runs the Cancel FSM transition back to the last stable
# state before proceeding (`Hyperspace.recover_index` forces the same
# recovery immediately). Size it above the longest expected build.
MAINTENANCE_LEASE_SECONDS = "spark.hyperspace.maintenance.lease.seconds"
MAINTENANCE_LEASE_SECONDS_DEFAULT = 600

# Per-row lineage (extension; the reference's v0.2 direction): when enabled
# at build time, every index row carries the id of the source file it came
# from (`LINEAGE_COLUMN`, internal — never surfaced in query results) and
# the log entry stores per-file (size, stamp, id) records. Hybrid scan can
# then serve queries over a source with DELETED files by excluding those
# rows, and incremental refresh handles deletions as a per-bucket lineage
# filter instead of a full rebuild.
LINEAGE_ENABLED = "spark.hyperspace.index.lineage.enabled"
LINEAGE_COLUMN = "_hs_file_id"

# Hybrid scan: an index over a source that changed since its build still
# serves filters and joins — its data UNION the appended files, minus the
# rows of deleted files (lineage-enabled indexes). Off by default.
HYBRID_SCAN_ENABLED = "spark.hyperspace.index.hybridscan.enabled"

# Data-skipping indexes (`index/sketch.py`, `actions/skipping.py`,
# `plan/rules/skipping.py`): a second index kind flowing through the same
# log/action FSM — per-source-file min/max zone maps + blocked bloom
# filters persisted as a compact parquet sketch blob under the index
# root, consulted at plan time by FilterIndexRule to drop files whose
# zones/blooms refute the predicate. `skipping.enabled` gates the
# QUERY-side consult only (build verbs always work); the bloom knobs
# size the per-file split-block filter (bits from the standard
# -n*ln(p)/ln(2)^2 estimate, rounded up to whole 256-bit blocks and
# capped at `max.bytes` per file per column); `zorder.files` is how
# many clustered output files the optional build-time Z-order rewrite
# produces (more files = tighter zones = finer pruning, at small-file
# cost).
SKIPPING_ENABLED = "spark.hyperspace.index.skipping.enabled"
SKIPPING_ENABLED_DEFAULT = "true"
SKIPPING_BLOOM_FPP = "spark.hyperspace.index.skipping.bloom.fpp"
SKIPPING_BLOOM_FPP_DEFAULT = 0.01
SKIPPING_BLOOM_MAX_BYTES = "spark.hyperspace.index.skipping.bloom.max.bytes"
SKIPPING_BLOOM_MAX_BYTES_DEFAULT = 64 * 1024
SKIPPING_ZORDER_FILES = "spark.hyperspace.index.skipping.zorder.files"
SKIPPING_ZORDER_FILES_DEFAULT = 16

# Where the device lane runs: "cuda" (the default; a CUDA card must be
# present) or "cpu". `HyperspaceSession(device=...)` sets it.
DEVICE = "spark.hyperspace.device"

# Adaptive host/device execution lane: reads below this row count are
# evaluated with host numpy, larger ones run on the device. The default is
# the JAX package's, so both packages take the same lane decisions; 0
# forces everything onto the device.
MIN_DEVICE_ROWS = "spark.hyperspace.execution.min.device.rows"
MIN_DEVICE_ROWS_DEFAULT = 4_194_304

# Whole-stage fusion: run Filter/Project/BroadcastHashJoin chains as one
# masked stage with one host sync (`engine/fusion.py`). "false" restores
# eager per-operator execution.
FUSION_ENABLED = "spark.hyperspace.execution.fusion.enabled"
FUSION_ENABLED_DEFAULT = "true"

# Mesh distribution of the data plane (`parallel/`). Values: "auto"
# (the default: distribute when more than one device is visible and the
# batch is large and device-resident), "true", "false". The names and
# defaults are the JAX package's.
DISTRIBUTION_ENABLED = "spark.hyperspace.distribution.enabled"
DISTRIBUTION_ENABLED_DEFAULT = "auto"
# Minimum row count before the sharded filter scan pays for itself.
DISTRIBUTION_MIN_ROWS = "spark.hyperspace.distribution.min.rows"
DISTRIBUTION_MIN_ROWS_DEFAULT = 4096
# Topology: number of slices (the outer `dcn` axis) in the mesh. 1 (the
# default) is a flat single-axis mesh; >1 builds a 2-axis (dcn, shard)
# mesh whose build exchange routes hierarchically, one stage per axis.
# `distribution.slices` is the canonical knob; `distribution.dcn.size`
# is honored as the legacy spelling.
DISTRIBUTION_SLICES = "spark.hyperspace.distribution.slices"
DISTRIBUTION_DCN_SIZE = "spark.hyperspace.distribution.dcn.size"
DISTRIBUTION_DCN_SIZE_DEFAULT = 1
# Read replication across slices (`parallel/replica.py`): on a 2-slice
# topology each slice is a read replica the scheduler routes to.
DISTRIBUTION_REPLICATION = \
    "spark.hyperspace.distribution.replication.enabled"
DISTRIBUTION_REPLICATION_DEFAULT = "true"
DISTRIBUTION_REPLICATION_MIN_SLICES = \
    "spark.hyperspace.distribution.replication.min.slices"
DISTRIBUTION_REPLICATION_MIN_SLICES_DEFAULT = 2
DISTRIBUTION_REPLICATION_HOT_FRACTION = \
    "spark.hyperspace.distribution.replication.hot.fraction"
DISTRIBUTION_REPLICATION_HOT_FRACTION_DEFAULT = 0.5
# Born-sharded SPMD execution (the JAX package's `parallel/spmd.py` join
# and scan programs, not ported yet; the port runs the single-device
# join, which is that package's "false" path).
DISTRIBUTION_SPMD = "spark.hyperspace.distribution.spmd.enabled"
DISTRIBUTION_SPMD_DEFAULT = "true"
# The JAX package's first-attempt per-peer capacity factor of its fixed-
# shape exchanges. Torch sizes every slab at run time, so the port never
# overflows; the value is read and recorded on the build's span.
DISTRIBUTION_CAPACITY_FACTOR = \
    "spark.hyperspace.distribution.capacity.factor"
DISTRIBUTION_CAPACITY_FACTOR_DEFAULT = 2.0
# Born-sharded string layout: a mesh build records each device range's
# sorted local string dictionary in `_shard_layout.json`. A range whose
# dictionary exceeds this entry cap is recorded as null (readers derive
# it from the files). <= 0 disables recording.
DISTRIBUTION_DICT_MAX_ENTRIES = \
    "spark.hyperspace.distribution.dictionary.max.entries"
DISTRIBUTION_DICT_MAX_ENTRIES_DEFAULT = 65536

# Fusion caches: the promotion cache (host source columns held on the
# device, keyed by host-array identity) and the broadcast-table cache
# (direct-address join tables, keyed by build-column identity) evict
# dead-source entries first, then oldest-inserted, until held bytes fit
# the budget. Both hold device memory; their residency reads as
# `cache.fusion_promote.*` / `cache.fusion_bcast.*` in the registry.
FUSION_PROMOTE_CACHE_BYTES = "spark.hyperspace.fusion.cache.promote.bytes"
FUSION_PROMOTE_CACHE_BYTES_DEFAULT = 1 * 1024 ** 3
FUSION_BCAST_CACHE_BYTES = "spark.hyperspace.fusion.cache.broadcast.bytes"
FUSION_BCAST_CACHE_BYTES_DEFAULT = 256 * 1024 * 1024

# Broadcast-join size threshold in estimated decoded bytes; <= 0 disables
# (the analog of Spark's `spark.sql.autoBroadcastJoinThreshold`, which
# the reference leans on for dimension joins and its E2E suite pins to
# -1 to force the SMJ path, `E2EHyperspaceRulesTests.scala:42`). Default
# matches Spark's 10 MB.
BROADCAST_THRESHOLD = "spark.hyperspace.broadcast.threshold"
BROADCAST_THRESHOLD_DEFAULT = 10 * 1024 * 1024

WAREHOUSE_PATH = "spark.hyperspace.warehouse.dir"
WAREHOUSE_PATH_DEFAULT = "warehouse"

# Operation log layout (reference `index/IndexConstants.scala:38-39`).
HYPERSPACE_LOG = "_hyperspace_log"
INDEX_VERSION_DIRECTORY_PREFIX = "v__"
LATEST_STABLE_LOG = "latestStable"

# Commit marker written LAST into every `v__=N` data dir (the Delta-style
# finalize): readers (`IndexDataManager.get_latest_version_id`, optimize/
# incremental refresh picking the "current" version) only see versions
# carrying it, so a crashed build's partially-written dir is invisible —
# it is skipped for the next version number and hard-deleted by vacuum.
# The leading underscore keeps it out of every parquet file listing.
INDEX_DATA_COMMIT_MARKER = "_committed"

# Telemetry (`telemetry/`): the JAX package's keys and defaults.
#
# Operations plane (`telemetry/timeseries.py`, `telemetry/ops_server.py`):
# the background sampler snapshots selected registry series every
# `timeseries.interval.seconds` into a ring of `timeseries.capacity`
# samples. Setting `ops.port` starts the in-process HTTP server (and the
# sampler with it); it binds `ops.host`, 127.0.0.1 by default — the
# endpoints are unauthenticated. Port 0 binds an ephemeral port (read it
# back from `ops_server.get_server().port`); unset = no server.
TELEMETRY_OPS_PORT = "spark.hyperspace.telemetry.ops.port"
TELEMETRY_OPS_HOST = "spark.hyperspace.telemetry.ops.host"
TELEMETRY_OPS_HOST_DEFAULT = "127.0.0.1"
TELEMETRY_TIMESERIES_INTERVAL_SECONDS = \
    "spark.hyperspace.telemetry.timeseries.interval.seconds"
TELEMETRY_TIMESERIES_INTERVAL_SECONDS_DEFAULT = 1.0
TELEMETRY_TIMESERIES_CAPACITY = \
    "spark.hyperspace.telemetry.timeseries.capacity"
TELEMETRY_TIMESERIES_CAPACITY_DEFAULT = 600

# Serving plane (`engine/scheduler.py`): every DataFrame.collect routes
# through the process-wide QueryScheduler. Admission control budgets
# concurrent queries' projected HBM footprints against
# `serve.hbm.budget.bytes` (0, the default, disables budgeting — every
# query admits immediately); queries that do not fit wait in a bounded
# FIFO queue of depth `serve.queue.depth`, and when the queue is full
# the caller gets a typed QueryRejectedError at once — backpressure,
# not silent pile-up. `serve.deadline.seconds` gives every query a
# default deadline (0 = none; `collect(timeout=...)` overrides per
# call), enforced cooperatively at operator / transfer-chunk /
# segment-fill / sorted-run-write boundaries.
SERVE_HBM_BUDGET_BYTES = "spark.hyperspace.serve.hbm.budget.bytes"
SERVE_HBM_BUDGET_BYTES_DEFAULT = 0
SERVE_QUEUE_DEPTH = "spark.hyperspace.serve.queue.depth"
SERVE_QUEUE_DEPTH_DEFAULT = 32
SERVE_DEADLINE_SECONDS = "spark.hyperspace.serve.deadline.seconds"
SERVE_DEADLINE_SECONDS_DEFAULT = 0.0

# Inter-query batched execution (`engine/batcher.py`): concurrent
# point/filter queries sharing one execution signature (same scan
# identity + pinned index version + predicate SHAPE, literals free)
# coalesce into ONE batched predicate evaluation over the shared
# resident segments — the segment cache's single-flight fills dedupe the
# cache FILL, this dedupes the EXECUTION. The first query of a signature gathers joiners for
# `batch.window.ms` (skipped entirely when nothing else is in flight,
# so serial latency is untouched), up to `batch.max` cohort members per
# invocation; predicate constants ride padded power-of-two lanes so the
# cohort size is a fixed bucket, not a new shape per K.
# `batch.aot.warmup` warms the canonical cohort-size buckets (one real
# dispatch each) the first time a signature is seen (and via the
# explicit `engine.batcher.warmup(df)` API).
SERVE_BATCH_ENABLED = "spark.hyperspace.serve.batch.enabled"
SERVE_BATCH_ENABLED_DEFAULT = "true"
SERVE_BATCH_WINDOW_MS = "spark.hyperspace.serve.batch.window.ms"
SERVE_BATCH_WINDOW_MS_DEFAULT = 2.0
SERVE_BATCH_MAX = "spark.hyperspace.serve.batch.max"
SERVE_BATCH_MAX_DEFAULT = 16
SERVE_BATCH_AOT_WARMUP = "spark.hyperspace.serve.batch.aot.warmup"
SERVE_BATCH_AOT_WARMUP_DEFAULT = "true"

# Degradation circuit breaker (per index): after `breaker.failures`
# IndexDataUnavailableError fallbacks within `breaker.window.seconds`,
# the breaker OPENS and queries selecting that index skip straight to
# the source plan without re-paying the failed index scan. After
# `breaker.cooldown.seconds` one probe query is allowed through
# (half-open); success closes the breaker, failure re-opens it.
SERVE_BREAKER_FAILURES = "spark.hyperspace.serve.breaker.failures"
SERVE_BREAKER_FAILURES_DEFAULT = 3
SERVE_BREAKER_WINDOW_SECONDS = "spark.hyperspace.serve.breaker.window.seconds"
SERVE_BREAKER_WINDOW_SECONDS_DEFAULT = 60.0
SERVE_BREAKER_COOLDOWN_SECONDS = \
    "spark.hyperspace.serve.breaker.cooldown.seconds"
SERVE_BREAKER_COOLDOWN_SECONDS_DEFAULT = 30.0

# Sliding-window SLO tracking (`engine/scheduler.py`): when
# `slo.p99.seconds` > 0, every completed query's wall is folded into a
# sliding window of `slo.window.seconds`, queries over the target count
# as `serve.slo.violations`, and the `serve.slo.burn_rate` gauge is the
# observed violation fraction over the 1% a p99 objective allows
# (burn 1.0 = burning the error budget exactly as fast as allowed; > 1
# = the SLO is failing). `slo.shed.enabled` (OFF by default) arms the
# shedding hook: while the burn rate exceeds 1.0, the admission wait
# queue is tightened to half its configured depth, and each query
# rejected by the tightened (rather than the configured) depth counts
# `serve.slo.shed` — controlled load shedding at the admission door
# instead of queue collapse under sustained overload.
SERVE_SLO_P99_SECONDS = "spark.hyperspace.serve.slo.p99.seconds"
SERVE_SLO_P99_SECONDS_DEFAULT = 0.0
SERVE_SLO_WINDOW_SECONDS = "spark.hyperspace.serve.slo.window.seconds"
SERVE_SLO_WINDOW_SECONDS_DEFAULT = 60.0
SERVE_SLO_SHED_ENABLED = "spark.hyperspace.serve.slo.shed.enabled"
SERVE_SLO_SHED_ENABLED_DEFAULT = "false"

# Multi-tenant serving (`engine/scheduler.py`): tenant-keyed knobs
# embed the tenant id in the conf key —
# `serve.tenant.<id>.weight` (float, default 1.0) is the tenant's
# deficit-round-robin share of the admission dequeue; a tenant with
# weight 2 drains its wait queue twice as fast as a weight-1 tenant
# under contention. `serve.tenant.<id>.hbm.fraction` (float in (0, 1],
# default 0 = unlimited) caps the tenant's concurrently-admitted
# footprint at that fraction of `serve.hbm.budget.bytes`;
# `serve.tenant.<id>.queue.depth` (int, default 0 = share the global
# depth) caps how many of the tenant's queries may WAIT at once. The
# default tenant is unlimited unless explicitly configured — existing
# single-tenant deployments see no behavior change.
SERVE_TENANT_PREFIX = "spark.hyperspace.serve.tenant."
SERVE_TENANT_WEIGHT_DEFAULT = 1.0
SERVE_TENANT_HBM_FRACTION_DEFAULT = 0.0
SERVE_TENANT_QUEUE_DEPTH_DEFAULT = 0
# `advisor.tenant.<id>.budget.bytes` (default 0 = share the global
# advisor budget) caps auto-built index bytes attributed to that
# tenant's mined candidates.
ADVISOR_TENANT_PREFIX = "spark.hyperspace.advisor.tenant."
ADVISOR_TENANT_BUDGET_BYTES_DEFAULT = 0

# Continuous-ingest coordinator (`engine/ingest.py`): cadence between
# micro-batch ticks when the caller drives `run_once` on a timer. The
# coordinator itself never spawns threads; this is the interval the
# owning loop should sleep between ticks.
INGEST_INTERVAL_SECONDS = "spark.hyperspace.ingest.interval.seconds"
INGEST_INTERVAL_SECONDS_DEFAULT = 5.0
# Serving-pressure gate, same shape as the advisor's: refresh work is
# deferred while queries wait for admission, or while admitted bytes
# exceed this fraction of `serve.hbm.budget.bytes`. Appends still land
# (the source is append-only either way); only index refresh yields.
INGEST_SERVE_HEADROOM = "spark.hyperspace.ingest.serve.headroom"
INGEST_SERVE_HEADROOM_DEFAULT = 0.5
# Total tries the coordinator makes when a refresh loses the op-log
# race to a manual refresher (typed conflict → bounded jittered backoff
# via `utils/retry.py`, then a clean concession — never an error).
INGEST_CONFLICT_ATTEMPTS = "spark.hyperspace.ingest.conflict.attempts"
INGEST_CONFLICT_ATTEMPTS_DEFAULT = 3

# Where the built libraries go (`telemetry/compilation.
# configure_persistent_cache`): the nvcc and g++ builds of
# `ops/cuda/build.py` and `native/`. Empty (default) = the package's
# `_build/` directory.
COMPILE_CACHE_DIR = "spark.hyperspace.compile.cache.dir"

# Self-driving index advisor (`hyperspace_tpu_torch/advisor/`): mines the
# query flight ring for recurring un-indexed filter/join signatures,
# what-if scores hypothetical covering and data-skipping indexes by
# replaying recorded plans through the real rewrite rules, and builds
# the winners through the normal Create path (lease, OCC, reports).
ADVISOR_ENABLED = "spark.hyperspace.advisor.enabled"
ADVISOR_ENABLED_DEFAULT = "true"
# Per-run ceiling on the summed ESTIMATED on-disk bytes of indexes the
# advisor may build; candidates past it are recorded as rejected.
ADVISOR_BUILD_BUDGET_BYTES = "spark.hyperspace.advisor.build.budget.bytes"
ADVISOR_BUILD_BUDGET_BYTES_DEFAULT = 1 * 1024 ** 3
# How many index builds one advisor run may start.
ADVISOR_MAX_BUILDS = "spark.hyperspace.advisor.max.builds"
ADVISOR_MAX_BUILDS_DEFAULT = 2
# Serving-pressure gate: builds defer while queries wait in the
# scheduler queue, or while admitted bytes exceed this fraction of
# `serve.hbm.budget.bytes`.
ADVISOR_SERVE_HEADROOM = "spark.hyperspace.advisor.serve.headroom"
ADVISOR_SERVE_HEADROOM_DEFAULT = 0.5
# Minimum estimated bytes avoided (amortized over the observed repeat
# count) before a candidate is recommended at all.
ADVISOR_MIN_BENEFIT_BYTES = "spark.hyperspace.advisor.min.benefit.bytes"
ADVISOR_MIN_BENEFIT_BYTES_DEFAULT = 0
# Assumed fraction of scan bytes a hypothetical data-skipping index
# prunes, used until the filter rule has measured one.
ADVISOR_SKIPPING_PRUNE_FRACTION = \
    "spark.hyperspace.advisor.skipping.prune.fraction"
ADVISOR_SKIPPING_PRUNE_FRACTION_DEFAULT = 0.5
# Observed repeat count before a workload signature counts as recurring.
ADVISOR_MIN_REPEATS = "spark.hyperspace.advisor.min.repeats"
ADVISOR_MIN_REPEATS_DEFAULT = 2

# Device profiler integration: when set to a directory, every executed
# query is captured as a `torch.profiler` trace under it (one
# subdirectory per query, `trace.json` inside), viewable in Perfetto.
# Empty (default) = off.
TRACE_DIR = "spark.hyperspace.trace.dir"

# Query flight recorder (`telemetry/flight.py`): the ring of the last-K
# completed QueryMetrics is ALWAYS on; a query whose wall exceeds
# `slowlog.seconds` (0, the default, disables dumping) persists its metric
# tree + registry snapshot + trace slice under `slowlog.dir` (default
# `<warehouse>/slowlog`); only the newest `slowlog.keep` dumps are kept.
TELEMETRY_SLOWLOG_SECONDS = "spark.hyperspace.telemetry.slowlog.seconds"
TELEMETRY_SLOWLOG_SECONDS_DEFAULT = 0.0
TELEMETRY_SLOWLOG_DIR = "spark.hyperspace.telemetry.slowlog.dir"
TELEMETRY_SLOWLOG_KEEP = "spark.hyperspace.telemetry.slowlog.keep"
TELEMETRY_SLOWLOG_KEEP_DEFAULT = 20

# Critical-path decomposition (`telemetry/critical_path.py`): "false"
# skips the per-query stamp (the source counters still record).
TELEMETRY_CRITPATH_ENABLED = "spark.hyperspace.telemetry.critpath.enabled"
TELEMETRY_CRITPATH_ENABLED_DEFAULT = "true"

# Sampling profiler (`telemetry/profiler.py`): a daemon thread samples
# every live thread's stack at `profiler.hz` (off by default). Triggered
# device capture: when `capture.seconds` > 0, a slowlog dump or an
# incident fires a background `torch.profiler` capture of that many
# seconds, written as a `profile-*` directory next to the slow-query
# dumps (newest `capture.keep` retained; at most one per
# `capture.min.interval.seconds`).
TELEMETRY_PROFILER_ENABLED = "spark.hyperspace.telemetry.profiler.enabled"
TELEMETRY_PROFILER_ENABLED_DEFAULT = "false"
TELEMETRY_PROFILER_HZ = "spark.hyperspace.telemetry.profiler.hz"
TELEMETRY_PROFILER_HZ_DEFAULT = 19.0
TELEMETRY_PROFILER_CAPTURE_SECONDS = \
    "spark.hyperspace.telemetry.profiler.capture.seconds"
TELEMETRY_PROFILER_CAPTURE_SECONDS_DEFAULT = 0.0
TELEMETRY_PROFILER_CAPTURE_KEEP = \
    "spark.hyperspace.telemetry.profiler.capture.keep"
TELEMETRY_PROFILER_CAPTURE_KEEP_DEFAULT = 4
TELEMETRY_PROFILER_CAPTURE_MIN_INTERVAL_SECONDS = \
    "spark.hyperspace.telemetry.profiler.capture.min.interval.seconds"
TELEMETRY_PROFILER_CAPTURE_MIN_INTERVAL_SECONDS_DEFAULT = 30.0

# Durable on-lake telemetry history (`telemetry/history.py`): when
# enabled, the sampler's tick hook flushes segment files under
# `history.dir` (default `<warehouse>/.hyperspace_telemetry`), pruned by
# age (`keep.seconds`) and total bytes (`keep.bytes`).
TELEMETRY_HISTORY_ENABLED = "spark.hyperspace.telemetry.history.enabled"
TELEMETRY_HISTORY_ENABLED_DEFAULT = "false"
TELEMETRY_HISTORY_DIR = "spark.hyperspace.telemetry.history.dir"
TELEMETRY_HISTORY_DIRNAME = ".hyperspace_telemetry"
TELEMETRY_HISTORY_INTERVAL_SECONDS = \
    "spark.hyperspace.telemetry.history.interval.seconds"
TELEMETRY_HISTORY_INTERVAL_SECONDS_DEFAULT = 60.0
TELEMETRY_HISTORY_KEEP_SECONDS = \
    "spark.hyperspace.telemetry.history.keep.seconds"
TELEMETRY_HISTORY_KEEP_SECONDS_DEFAULT = 7 * 24 * 3600.0
TELEMETRY_HISTORY_KEEP_BYTES = \
    "spark.hyperspace.telemetry.history.keep.bytes"
TELEMETRY_HISTORY_KEEP_BYTES_DEFAULT = 64 * 1024 * 1024

# Rule-driven alerting (`telemetry/alerts.py`): rules over the sampler's
# windowed series, evaluated on every tick. Per-rule overrides live under
# `alerts.rule.<name>.{enabled,threshold,clear,sustain.seconds,
# window.seconds}`; `alerts.enabled=false` disables evaluation.
TELEMETRY_ALERTS_ENABLED = "spark.hyperspace.telemetry.alerts.enabled"
TELEMETRY_ALERTS_ENABLED_DEFAULT = "true"
TELEMETRY_ALERTS_RULE_PREFIX = "spark.hyperspace.telemetry.alerts.rule."

# Explain display mode (reference `index/IndexConstants.scala:42-49`).
DISPLAY_MODE = "spark.hyperspace.explain.displayMode"
HIGHLIGHT_BEGIN_TAG = "spark.hyperspace.explain.displayMode.highlight.beginTag"
HIGHLIGHT_END_TAG = "spark.hyperspace.explain.displayMode.highlight.endTag"


class DisplayModeNames:
    CONSOLE = "console"
    PLAIN_TEXT = "plaintext"
    HTML = "html"


class States:
    """Index lifecycle states (reference `actions/Constants.scala:20-30`)."""

    ACTIVE = "ACTIVE"
    CREATING = "CREATING"
    DELETING = "DELETING"
    DELETED = "DELETED"
    REFRESHING = "REFRESHING"
    VACUUMING = "VACUUMING"
    RESTORING = "RESTORING"
    DOESNOTEXIST = "DOESNOTEXIST"
    CANCELLING = "CANCELLING"
    OPTIMIZING = "OPTIMIZING"  # extension: incremental merge-compaction

STABLE_STATES = (States.ACTIVE, States.DELETED, States.DOESNOTEXIST)
