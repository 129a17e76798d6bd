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

# Build mode: only the in-memory build is ported; "auto" resolves to it and
# "streaming" raises.
BUILD_MODE = "hyperspace.index.build.mode"
BUILD_MODE_AUTO = "auto"
BUILD_MODE_INMEMORY = "inmemory"
BUILD_MODE_STREAMING = "streaming"
BUILD_MODES = (BUILD_MODE_AUTO, BUILD_MODE_INMEMORY, BUILD_MODE_STREAMING)
BUILD_MODE_DEFAULT = BUILD_MODE_AUTO

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
