"""Config keys, defaults, and naming constants.

The keys and on-disk names are the same strings ``hyperspace_tpu`` uses,
so a conf dict and an index tree mean the same thing to both packages.
Only the keys this package reads are here.
"""

# --- system layout -----------------------------------------------------------
INDEX_SYSTEM_PATH = "hyperspace.system.path"
INDEX_SYSTEM_PATH_DEFAULT = "indexes"  # resolved relative to workspace root

# Operation-log directory name inside every index directory
HYPERSPACE_LOG = "_hyperspace_log"
# Versioned index-data directory prefix
INDEX_VERSION_DIRECTORY_PREFIX = "v__"

# --- index build -------------------------------------------------------------
INDEX_NUM_BUCKETS = "hyperspace.index.numBuckets"
INDEX_NUM_BUCKETS_DEFAULT = 200
INDEX_NUM_BUCKETS_LEGACY = "hyperspace.num.buckets"  # legacy fallback key

# Build mode: "inmemory" materializes the source and sorts it in one pass;
# "streaming" runs the out-of-core pipeline (index/stream_builder.py):
# fixed-capacity chunks bucketized and sorted on the device, spilled as
# bucket-grouped runs, merged per bucket (or kept as run files); "auto"
# streams when the source's bytes exceed the threshold below.
BUILD_MODE = "hyperspace.index.build.mode"
BUILD_MODE_AUTO = "auto"
BUILD_MODE_INMEMORY = "inmemory"
BUILD_MODE_STREAMING = "streaming"
BUILD_MODES = (BUILD_MODE_AUTO, BUILD_MODE_INMEMORY, BUILD_MODE_STREAMING)
BUILD_MODE_DEFAULT = BUILD_MODE_AUTO
BUILD_CHUNK_ROWS = "hyperspace.index.build.chunkRows"
BUILD_CHUNK_ROWS_DEFAULT = 1 << 21  # rows per streamed chunk
# What the streamed build does with its spilled sorted runs:
#   merge — merge the runs into one file per bucket at finalize;
#   runs  — promote the runs themselves to final multi-bucket data files
#           (footer bucketCounts give each bucket's row range); queries
#           read bucket segments, and optimize or the compactor later
#           rewrite them as per-bucket files.
BUILD_FINALIZE_MODE = "hyperspace.index.build.finalizeMode"
BUILD_FINALIZE_MERGE = "merge"
BUILD_FINALIZE_RUNS = "runs"
BUILD_FINALIZE_MODES = (BUILD_FINALIZE_MERGE, BUILD_FINALIZE_RUNS)
BUILD_FINALIZE_MODE_DEFAULT = BUILD_FINALIZE_MERGE
# auto mode streams when the source files exceed this many bytes on disk
BUILD_STREAMING_THRESHOLD_BYTES = "hyperspace.index.build.streamingThresholdBytes"
BUILD_STREAMING_THRESHOLD_BYTES_DEFAULT = 256 * 1024 * 1024
# The streaming build's chunk engine: device (bucketize + sort on the
# card), host (the numpy twin), or auto (both timed on early chunks, the
# rest routed to the measured winner; the verdict is cached per machine).
BUILD_ENGINE = "hyperspace.index.build.engine"
BUILD_ENGINE_AUTO = "auto"
BUILD_ENGINE_DEVICE = "device"
BUILD_ENGINE_HOST = "host"
BUILD_ENGINES = (BUILD_ENGINE_AUTO, BUILD_ENGINE_DEVICE, BUILD_ENGINE_HOST)
BUILD_ENGINE_DEFAULT = BUILD_ENGINE_AUTO
# The pipelined build's worker counts and queue depths (ingest decode →
# dispatch → spill compute → spill write → per-bucket merge). pipeline=off
# runs every stage inline on the caller's thread. Worker counts take an
# int or "auto" (derived from the host's core count).
BUILD_PIPELINE = "hyperspace.index.build.pipeline"
BUILD_PIPELINE_ON = "on"
BUILD_PIPELINE_OFF = "off"
BUILD_PIPELINE_MODES = (BUILD_PIPELINE_ON, BUILD_PIPELINE_OFF)
BUILD_PIPELINE_DEFAULT = BUILD_PIPELINE_ON
# The device engine's streaming shape: doubleBuffer rotates a fixed pair
# of pinned host staging slabs under the H2D copy; runChunks (R) keeps R
# sorted chunks on the card and merges them into one spill run there
# (one D2H per run). runChunks=1 is the per-chunk round trip.
BUILD_DEVICE_DOUBLE_BUFFER = "hyperspace.index.build.device.doubleBuffer"
BUILD_DEVICE_DOUBLE_BUFFER_DEFAULT = True
BUILD_DEVICE_RUN_CHUNKS = "hyperspace.index.build.device.runChunks"
BUILD_DEVICE_RUN_CHUNKS_DEFAULT = 4
BUILD_INGEST_WORKERS = "hyperspace.index.build.ingestWorkers"
BUILD_SPILL_COMPUTE_WORKERS = "hyperspace.index.build.spillComputeWorkers"
BUILD_SPILL_WRITE_WORKERS = "hyperspace.index.build.spillWriteWorkers"
BUILD_MERGE_WORKERS = "hyperspace.index.build.mergeWorkers"
BUILD_QUEUE_DEPTH = "hyperspace.index.build.queueDepth"
BUILD_WORKERS_AUTO = "auto"

# Lineage
INDEX_LINEAGE_ENABLED = "hyperspace.index.lineage.enabled"
INDEX_LINEAGE_ENABLED_DEFAULT = False
DATA_FILE_NAME_ID = "_data_file_id"
UNKNOWN_FILE_ID = -1

# --- index collection cache (CachingIndexCollectionManager) ------------------
INDEX_CACHE_EXPIRY_DURATION_SECONDS = "hyperspace.index.cache.expiryDurationInSeconds"
INDEX_CACHE_EXPIRY_DURATION_SECONDS_DEFAULT = 300

# --- lifecycle modes ---------------------------------------------------------
# optimize(quick) merges a bucket's files below the size threshold; full
# merges every bucket holding more than one file
OPTIMIZE_FILE_SIZE_THRESHOLD = "hyperspace.index.optimize.fileSizeThreshold"
OPTIMIZE_FILE_SIZE_THRESHOLD_DEFAULT = 256 * 1024 * 1024  # 256 MB
OPTIMIZE_MODE_QUICK = "quick"
OPTIMIZE_MODE_FULL = "full"
OPTIMIZE_MODES = (OPTIMIZE_MODE_QUICK, OPTIMIZE_MODE_FULL)

# --- background compaction of runs-layout indexes (index/compactor.py) -------
# "auto" lets a QueryServer host timed sweeps (serve/server.py); "off" (the
# default) keeps compaction an explicit verb
INDEX_COMPACTION = "hyperspace.index.compaction.enabled"
INDEX_COMPACTION_AUTO = "auto"
INDEX_COMPACTION_OFF = "off"
INDEX_COMPACTION_MODES = (INDEX_COMPACTION_AUTO, INDEX_COMPACTION_OFF)
INDEX_COMPACTION_DEFAULT = INDEX_COMPACTION_OFF
# how often a hosting server's submit path may start a sweep; <= 0 disables
INDEX_COMPACTION_INTERVAL_SECONDS = "hyperspace.index.compaction.intervalSeconds"
INDEX_COMPACTION_INTERVAL_SECONDS_DEFAULT = 30.0
# buckets compacted per committed step (also the step's host-memory bound)
INDEX_COMPACTION_BUCKETS_PER_STEP = "hyperspace.index.compaction.bucketsPerStep"
INDEX_COMPACTION_BUCKETS_PER_STEP_DEFAULT = 64
INDEX_COMPACTION_MAX_STEPS_PER_SWEEP = (
    "hyperspace.index.compaction.maxStepsPerSweep"
)
INDEX_COMPACTION_MAX_STEPS_PER_SWEEP_DEFAULT = 1

# --- segment IO (storage/layout.py planner) ----------------------------------
# How (run file, bucket) segment reads execute: "planned" merges adjacent
# and near-adjacent ranges into one ordered sweep per run file; "naive"
# issues one ranged read per segment. HYPERSPACE_TPU_TORCH_SEGMENT_IO
# overrides both.
STORAGE_SEGMENT_IO = "hyperspace.storage.segmentIo"
STORAGE_SEGMENT_IO_PLANNED = "planned"
STORAGE_SEGMENT_IO_NAIVE = "naive"
STORAGE_SEGMENT_IO_MODES = (STORAGE_SEGMENT_IO_PLANNED, STORAGE_SEGMENT_IO_NAIVE)
STORAGE_SEGMENT_IO_DEFAULT = STORAGE_SEGMENT_IO_PLANNED

REFRESH_MODE_INCREMENTAL = "incremental"
REFRESH_MODE_FULL = "full"
REFRESH_MODE_QUICK = "quick"
REFRESH_MODES = (REFRESH_MODE_INCREMENTAL, REFRESH_MODE_FULL, REFRESH_MODE_QUICK)

# --- hybrid scan -------------------------------------------------------------
# (reference: IndexConstants.scala:34-48)
INDEX_HYBRID_SCAN_ENABLED = "hyperspace.index.hybridscan.enabled"
INDEX_HYBRID_SCAN_ENABLED_DEFAULT = False
INDEX_HYBRID_SCAN_APPENDED_RATIO_THRESHOLD = (
    "hyperspace.index.hybridscan.maxAppendedRatio"
)
INDEX_HYBRID_SCAN_APPENDED_RATIO_THRESHOLD_DEFAULT = 0.3
INDEX_HYBRID_SCAN_DELETED_RATIO_THRESHOLD = (
    "hyperspace.index.hybridscan.maxDeletedRatio"
)
INDEX_HYBRID_SCAN_DELETED_RATIO_THRESHOLD_DEFAULT = 0.2

# --- sources -----------------------------------------------------------------
FILE_BASED_SOURCE_BUILDERS = "hyperspace.index.sources.fileBasedBuilders"
# the reference's six-format allowlist: avro through this package's own
# OCF reader; csv, json, orc and parquet through pyarrow, imported only on
# their paths; text through plain file reads
DEFAULT_SUPPORTED_FORMATS = ("avro", "csv", "json", "orc", "parquet", "text")
GLOBBING_PATTERN_KEY = "hyperspace.source.globbingPattern"
# Hive-style partition discovery toggle (source option, default on)
PARTITION_INFERENCE_KEY = "hyperspace.source.partitionInference"
# Relation option recording the discovered partition column names (a JSON
# list, in directory order), logged with the relation so a refresh rebuilds
# the same spec instead of re-guessing the layout
PARTITION_COLUMNS_META = "hyperspace.source.partitionColumns"

# --- explain display ---------------------------------------------------------
DISPLAY_MODE = "hyperspace.explain.displayMode"
HIGHLIGHT_BEGIN_TAG = "hyperspace.explain.displayMode.highlight.beginTag"
HIGHLIGHT_END_TAG = "hyperspace.explain.displayMode.highlight.endTag"
DISPLAY_MODE_PLAIN_TEXT = "plaintext"
DISPLAY_MODE_HTML = "html"
DISPLAY_MODE_CONSOLE = "console"
DISPLAY_MODE_DEFAULT = DISPLAY_MODE_PLAIN_TEXT

# --- reliability -------------------------------------------------------------
# Crash-consistent lifecycle knobs (reliability/).
# Writer-lease directory name inside every index directory (next to the
# operation log)
HYPERSPACE_LEASE = "_hyperspace_lease"
# How long a writer's lease lives between heartbeats before an expired,
# unreleased lease counts as a dead writer and triggers auto-rollback
RELIABILITY_LEASE_DURATION_SECONDS = "hyperspace.reliability.lease.durationSeconds"
RELIABILITY_LEASE_DURATION_SECONDS_DEFAULT = 60.0
# Master toggle for automatic rollback of abandoned transient states
RELIABILITY_AUTO_RECOVERY = "hyperspace.reliability.autoRecovery"
RELIABILITY_AUTO_RECOVERY_DEFAULT = True
# Storage retry policy on the FileSystem seam (bounded exponential
# backoff with deterministic jitter; transient errors only)
RELIABILITY_RETRY_MAX_ATTEMPTS = "hyperspace.reliability.retry.maxAttempts"
RELIABILITY_RETRY_MAX_ATTEMPTS_DEFAULT = 4
RELIABILITY_RETRY_BASE_DELAY_SECONDS = "hyperspace.reliability.retry.baseDelaySeconds"
RELIABILITY_RETRY_BASE_DELAY_SECONDS_DEFAULT = 0.05
RELIABILITY_RETRY_MAX_DELAY_SECONDS = "hyperspace.reliability.retry.maxDelaySeconds"
RELIABILITY_RETRY_MAX_DELAY_SECONDS_DEFAULT = 2.0

# --- telemetry ---------------------------------------------------------------
EVENT_LOGGER_CLASS = "hyperspace.eventLoggerClass"

# --- signature provider ------------------------------------------------------
SIGNATURE_PROVIDER = "hyperspace.index.signatureProvider"

# --- storage -----------------------------------------------------------------
STORAGE_BLOCK_ALIGN = 128  # bytes; alignment of TCB column buffers

# --- device ------------------------------------------------------------------
# The torch device every engine entry point runs on: "cuda" (default) or
# "cpu". Asking for cuda where there is none raises.
TORCH_DEVICE = "hyperspace.torch.device"
TORCH_DEVICE_DEFAULT = "cuda"

# --- the bucket mesh (parallel/mesh.py) ---------------------------------------
# Bucket b lives on shard b % D. Below minRows total rows a mesh query
# executes on the host: the fixed dispatch and transfer cost of a
# per-shard program cannot win on small data (the reference's key, under
# its name).
TPU_DISTRIBUTED_MIN_ROWS = "hyperspace.tpu.distributedQuery.minRows"
TPU_DISTRIBUTED_MIN_ROWS_DEFAULT = 1_000_000
# When set to a directory, each query's execution runs under
# torch.profiler (CPU activity, and CUDA activity on a CUDA session) and
# its Chrome trace lands there: the per-kernel view beside the engine's
# metrics registry (the reference's key, under its name, where it starts
# jax.profiler.trace).
TPU_PROFILE_DIR = "hyperspace.tpu.profile.dir"

# --- HBM residency (exec/hbm_cache.py) ---------------------------------------
# The reference reads these from environment variables (HYPERSPACE_TPU_HBM,
# _BUDGET_MB, _MIN_ROWS, _MAX_BLOCK_FRAC); here they are session conf.
# mode: "auto" populates on first touch when the session's device is cuda;
# "force" on any device (the CPU tests); "off" neither populates nor serves.
HBM_MODE = "hyperspace.torch.hbm.mode"
HBM_MODES = ("auto", "off", "force")
HBM_MODE_DEFAULT = "auto"
HBM_BUDGET_MB = "hyperspace.torch.hbm.budgetMB"
HBM_BUDGET_MB_DEFAULT = 4096
HBM_MIN_ROWS = "hyperspace.torch.hbm.minRows"  # first-touch floor
HBM_MIN_ROWS_DEFAULT = 1 << 21
# zone-gate threshold: a predicate whose blocks could match above this
# fraction routes to the host before any device work; 1.0 disables the gate
HBM_MAX_BLOCK_FRAC = "hyperspace.torch.hbm.maxBlockFrac"
HBM_MAX_BLOCK_FRAC_DEFAULT = 0.9

# --- residency tier ladder (exec/hbm_cache.py, residency/) --------------------
# The reference's keys under their names (hyperspace_tpu/constants.py); the
# reference lets HYPERSPACE_TPU_RESIDENCY_* environment variables override
# them, this package reads session conf only.
# compression: "auto" bit-packs narrow planes when the raw table exceeds the
# budget; "force" packs every packable column; "off" never packs.
RESIDENCY_COMPRESSION = "hyperspace.residency.compression"
RESIDENCY_COMPRESSION_MODES = ("auto", "force", "off")
RESIDENCY_COMPRESSION_DEFAULT = "auto"
# streaming: "auto" stages oversubscribed tables through a pair of device
# slabs, window by window; "off" refuses them (host path).
RESIDENCY_STREAMING = "hyperspace.residency.streaming"
RESIDENCY_STREAMING_MODES = ("auto", "off")
RESIDENCY_STREAMING_DEFAULT = "auto"
# rows per streamed window (padded up to 8192); two windows' device bytes
# are charged against the budget
RESIDENCY_STREAMING_WINDOW_ROWS = "hyperspace.residency.streaming.windowRows"
RESIDENCY_STREAMING_WINDOW_ROWS_DEFAULT = 1 << 20
# forDelta: the resident join regions' globally sorted right codes are
# FoR-delta packed (ops/bitpack.py:for_spec) when the codec wins, and the
# region's queries run K2p over the packed words; "off", "false", "0" or
# "no" keep them raw (K2)
RESIDENCY_FOR_DELTA = "hyperspace.residency.forDelta"
RESIDENCY_FOR_DELTA_DEFAULT = "on"
RESIDENCY_FOR_DELTA_OFF = ("off", "false", "0", "no")

# --- whole-plan compilation (compile/) ----------------------------------------
# "auto" runs every executed plan through the compiled-pipeline cache (the
# interpreter stays the fallback leg); "off" interprets per operator
COMPILE_MODE = "hyperspace.compile.mode"
COMPILE_MODE_AUTO = "auto"
COMPILE_MODE_OFF = "off"
COMPILE_MODES = (COMPILE_MODE_AUTO, COMPILE_MODE_OFF)
COMPILE_MODE_DEFAULT = COMPILE_MODE_AUTO
# pipelines the cache keeps (routing state, a few hundred bytes each)
COMPILE_CACHE_ENTRIES = "hyperspace.compile.cacheEntries"
COMPILE_CACHE_ENTRIES_DEFAULT = 256
# the serve tier's result cache (compile/result_cache.py): off by default
COMPILE_RESULT_CACHE = "hyperspace.compile.resultCache"
COMPILE_RESULT_CACHE_ON = "on"
COMPILE_RESULT_CACHE_OFF = "off"
COMPILE_RESULT_CACHE_MODES = (COMPILE_RESULT_CACHE_ON, COMPILE_RESULT_CACHE_OFF)
COMPILE_RESULT_CACHE_DEFAULT = COMPILE_RESULT_CACHE_OFF
COMPILE_RESULT_CACHE_ENTRIES = "hyperspace.compile.resultCache.entries"
COMPILE_RESULT_CACHE_ENTRIES_DEFAULT = 64
# a result larger than this never enters the cache
COMPILE_RESULT_CACHE_MAX_BYTES = "hyperspace.compile.resultCache.maxResultBytes"
COMPILE_RESULT_CACHE_MAX_BYTES_DEFAULT = 8 * 1024 * 1024
# admission (serve/cache_policy.py): the repeat-rate window, and the rate
# that turns seconds saved into bytes worth keeping
COMPILE_RESULT_CACHE_WINDOW = "hyperspace.compile.resultCache.windowSize"
COMPILE_RESULT_CACHE_WINDOW_DEFAULT = 512
COMPILE_RESULT_CACHE_BYTE_RATE = "hyperspace.compile.resultCache.byteRatePerSec"
COMPILE_RESULT_CACHE_BYTE_RATE_DEFAULT = 64 * 1024 * 1024
# share of the residency budget the cache may hold (clamped to [0, 0.5])
COMPILE_RESULT_CACHE_BUDGET_SHARE = "hyperspace.compile.resultCache.budgetShare"
COMPILE_RESULT_CACHE_BUDGET_SHARE_DEFAULT = 0.05

# --- multi-tenant serving (serve/) ----------------------------------------------
# per-tenant overrides are the runtime-built family
# f"{SERVE_TENANT_PREFIX}.<tenant>.weight" / ".maxQueue" / ".maxInflight"
SERVE_TENANT_PREFIX = "hyperspace.serve.tenant"
SERVE_TENANT_DEFAULT_WEIGHT = "hyperspace.serve.tenant.defaultWeight"
SERVE_TENANT_DEFAULT_WEIGHT_DEFAULT = 1.0
SERVE_TENANT_DEFAULT_MAX_QUEUE = "hyperspace.serve.tenant.defaultMaxQueue"
SERVE_TENANT_DEFAULT_MAX_QUEUE_DEFAULT = 32
# 0 or negative: no in-flight cap
SERVE_TENANT_DEFAULT_MAX_INFLIGHT = "hyperspace.serve.tenant.defaultMaxInflight"
SERVE_TENANT_DEFAULT_MAX_INFLIGHT_DEFAULT = 0
# consecutive deadline misses that open a tenant's circuit, and its cooldown
SERVE_BREAKER_MISS_THRESHOLD = "hyperspace.serve.tenant.breaker.missThreshold"
SERVE_BREAKER_MISS_THRESHOLD_DEFAULT = 5
SERVE_BREAKER_OPEN_SECONDS = "hyperspace.serve.tenant.breaker.openSeconds"
SERVE_BREAKER_OPEN_SECONDS_DEFAULT = 5.0
# the shed ladder: above highWater the lowest-weight tenants shed, above
# batchOff micro-batch widening stops
SERVE_SHED_HIGHWATER_FRACTION = "hyperspace.serve.shed.highWaterFraction"
SERVE_SHED_HIGHWATER_FRACTION_DEFAULT = 0.75
SERVE_SHED_BATCH_OFF_FRACTION = "hyperspace.serve.shed.batchOffFraction"
SERVE_SHED_BATCH_OFF_FRACTION_DEFAULT = 0.9
# the window the drain rate behind retry-after is measured over
SERVE_DRAIN_RATE_WINDOW_SECONDS = "hyperspace.serve.retryAfter.windowSeconds"
SERVE_DRAIN_RATE_WINDOW_SECONDS_DEFAULT = 10.0

# --- tracing and export (telemetry/) ----------------------------------------------
TELEMETRY_TRACING = "hyperspace.telemetry.tracing"
TELEMETRY_TRACING_ON = "on"
TELEMETRY_TRACING_OFF = "off"
TELEMETRY_TRACING_MODES = (TELEMETRY_TRACING_ON, TELEMETRY_TRACING_OFF)
TELEMETRY_TRACING_DEFAULT = TELEMETRY_TRACING_ON
TELEMETRY_RECORDER_ENTRIES = "hyperspace.telemetry.recorder.entries"
TELEMETRY_RECORDER_ENTRIES_DEFAULT = 64
TELEMETRY_RECORDER_SNAPSHOTS = "hyperspace.telemetry.recorder.snapshots"
TELEMETRY_RECORDER_SNAPSHOTS_DEFAULT = 8
# unset: off; "auto": <system path>/_hyperspace_metrics
TELEMETRY_EXPORT_DIR = "hyperspace.telemetry.export.dir"
TELEMETRY_EXPORT_DIR_AUTO = "auto"
TELEMETRY_METRICS_DIRNAME = "_hyperspace_metrics"
TELEMETRY_EXPORT_ROTATE_BYTES = "hyperspace.telemetry.export.rotateBytes"
TELEMETRY_EXPORT_ROTATE_BYTES_DEFAULT = 4 * 1024 * 1024
TELEMETRY_EXPORT_KEEP = "hyperspace.telemetry.export.keep"
TELEMETRY_EXPORT_KEEP_DEFAULT = 4
