"""Session configuration: a typed key/value store with defaults.

Same keys and coercion rules as ``hyperspace_tpu.config``; only the
accessors this package reads are here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

from . import constants as C
from .exceptions import HyperspaceException


class HyperspaceConf:
    """Mutable string-keyed configuration with typed getters. Values are
    stored as provided and coerced on read."""

    def __init__(self, values: Optional[Dict[str, Any]] = None):
        self._values: Dict[str, Any] = dict(values or {})
        # bumped by every set/unset: the pipeline cache memoizes its conf
        # token per (conf, generation) instead of sorting the dict per query
        self.generation = 0

    # -- generic access ------------------------------------------------------
    def set(self, key: str, value: Any) -> "HyperspaceConf":
        self._values[key] = value
        self.generation += 1
        return self

    def unset(self, key: str) -> "HyperspaceConf":
        self._values.pop(key, None)
        self.generation += 1
        return self

    def get(self, key: str, default: Any = None) -> Any:
        return self._values.get(key, default)

    def contains(self, key: str) -> bool:
        return key in self._values

    def copy(self) -> "HyperspaceConf":
        return HyperspaceConf(self._values)

    def as_dict(self) -> Dict[str, Any]:
        return dict(self._values)

    @staticmethod
    def _to_bool(v: Any) -> bool:
        if isinstance(v, bool):
            return v
        return str(v).strip().lower() in ("true", "1", "yes")

    # -- typed accessors -----------------------------------------------------
    def system_path(self) -> str:
        return str(self.get(C.INDEX_SYSTEM_PATH, C.INDEX_SYSTEM_PATH_DEFAULT))

    def num_buckets(self) -> int:
        v = self.get(
            C.INDEX_NUM_BUCKETS,
            self.get(C.INDEX_NUM_BUCKETS_LEGACY, C.INDEX_NUM_BUCKETS_DEFAULT),
        )
        return int(v)

    def lineage_enabled(self) -> bool:
        return self._to_bool(
            self.get(C.INDEX_LINEAGE_ENABLED, C.INDEX_LINEAGE_ENABLED_DEFAULT)
        )

    def hybrid_scan_enabled(self) -> bool:
        return self._to_bool(
            self.get(C.INDEX_HYBRID_SCAN_ENABLED, C.INDEX_HYBRID_SCAN_ENABLED_DEFAULT)
        )

    def hybrid_scan_appended_ratio_threshold(self) -> float:
        return float(
            self.get(
                C.INDEX_HYBRID_SCAN_APPENDED_RATIO_THRESHOLD,
                C.INDEX_HYBRID_SCAN_APPENDED_RATIO_THRESHOLD_DEFAULT,
            )
        )

    def hybrid_scan_deleted_ratio_threshold(self) -> float:
        return float(
            self.get(
                C.INDEX_HYBRID_SCAN_DELETED_RATIO_THRESHOLD,
                C.INDEX_HYBRID_SCAN_DELETED_RATIO_THRESHOLD_DEFAULT,
            )
        )

    def cache_expiry_seconds(self) -> int:
        return int(
            self.get(
                C.INDEX_CACHE_EXPIRY_DURATION_SECONDS,
                C.INDEX_CACHE_EXPIRY_DURATION_SECONDS_DEFAULT,
            )
        )

    def optimize_file_size_threshold(self) -> int:
        return int(
            self.get(
                C.OPTIMIZE_FILE_SIZE_THRESHOLD, C.OPTIMIZE_FILE_SIZE_THRESHOLD_DEFAULT
            )
        )

    def lease_duration_seconds(self) -> float:
        return float(
            self.get(
                C.RELIABILITY_LEASE_DURATION_SECONDS,
                C.RELIABILITY_LEASE_DURATION_SECONDS_DEFAULT,
            )
        )

    def auto_recovery_enabled(self) -> bool:
        return self._to_bool(
            self.get(
                C.RELIABILITY_AUTO_RECOVERY, C.RELIABILITY_AUTO_RECOVERY_DEFAULT
            )
        )

    def retry_policy(self):
        """The storage RetryPolicy built from conf (reliability/retry.py)."""
        from .reliability.retry import RetryPolicy

        return RetryPolicy(
            max_attempts=int(
                self.get(
                    C.RELIABILITY_RETRY_MAX_ATTEMPTS,
                    C.RELIABILITY_RETRY_MAX_ATTEMPTS_DEFAULT,
                )
            ),
            base_delay_s=float(
                self.get(
                    C.RELIABILITY_RETRY_BASE_DELAY_SECONDS,
                    C.RELIABILITY_RETRY_BASE_DELAY_SECONDS_DEFAULT,
                )
            ),
            max_delay_s=float(
                self.get(
                    C.RELIABILITY_RETRY_MAX_DELAY_SECONDS,
                    C.RELIABILITY_RETRY_MAX_DELAY_SECONDS_DEFAULT,
                )
            ),
        )

    def event_logger_class(self) -> Optional[str]:
        v = self.get(C.EVENT_LOGGER_CLASS)
        return str(v) if v else None

    def signature_provider(self) -> Optional[str]:
        v = self.get(C.SIGNATURE_PROVIDER)
        return str(v) if v else None

    def file_based_source_builders(self) -> Optional[str]:
        v = self.get(C.FILE_BASED_SOURCE_BUILDERS)
        return str(v) if v else None

    def build_mode(self) -> str:
        v = str(self.get(C.BUILD_MODE, C.BUILD_MODE_DEFAULT)).lower()
        if v not in C.BUILD_MODES:
            raise HyperspaceException(
                f"Unknown build mode {v!r}; expected one of {C.BUILD_MODES}."
            )
        return v

    def build_chunk_rows(self) -> int:
        return int(self.get(C.BUILD_CHUNK_ROWS, C.BUILD_CHUNK_ROWS_DEFAULT))

    def build_finalize_mode(self) -> str:
        v = str(
            self.get(C.BUILD_FINALIZE_MODE, C.BUILD_FINALIZE_MODE_DEFAULT)
        ).lower()
        if v not in C.BUILD_FINALIZE_MODES:
            raise HyperspaceException(
                f"Unsupported {C.BUILD_FINALIZE_MODE}={v!r}; supported: "
                f"{C.BUILD_FINALIZE_MODES}."
            )
        return v

    def build_streaming_threshold_bytes(self) -> int:
        return int(
            self.get(
                C.BUILD_STREAMING_THRESHOLD_BYTES,
                C.BUILD_STREAMING_THRESHOLD_BYTES_DEFAULT,
            )
        )

    def build_engine(self) -> str:
        v = str(self.get(C.BUILD_ENGINE, C.BUILD_ENGINE_DEFAULT)).lower()
        if v not in C.BUILD_ENGINES:
            raise HyperspaceException(
                f"Unknown build engine {v!r}; expected one of {C.BUILD_ENGINES}."
            )
        return v

    def build_pipeline(self):
        """The BuildPipelineConfig from the ``hyperspace.index.build.*``
        pipeline knobs: worker counts take an int or "auto" (the machine's
        default); ``pipeline=off`` gives the zero-thread serial config."""
        from .index.stream_builder import BuildPipelineConfig

        mode = str(self.get(C.BUILD_PIPELINE, C.BUILD_PIPELINE_DEFAULT)).lower()
        if mode not in C.BUILD_PIPELINE_MODES:
            raise HyperspaceException(
                f"Unknown {C.BUILD_PIPELINE}={mode!r}; expected one of "
                f"{C.BUILD_PIPELINE_MODES}."
            )
        if mode == C.BUILD_PIPELINE_OFF:
            return BuildPipelineConfig.serial()
        auto = BuildPipelineConfig.default()

        def _workers(key: str, fallback: int) -> int:
            v = self.get(key, C.BUILD_WORKERS_AUTO)
            if str(v).strip().lower() == C.BUILD_WORKERS_AUTO:
                return fallback
            return max(1, int(v))

        return BuildPipelineConfig(
            enabled=True,
            ingest_workers=_workers(C.BUILD_INGEST_WORKERS, auto.ingest_workers),
            spill_compute_workers=_workers(
                C.BUILD_SPILL_COMPUTE_WORKERS, auto.spill_compute_workers
            ),
            spill_write_workers=_workers(
                C.BUILD_SPILL_WRITE_WORKERS, auto.spill_write_workers
            ),
            merge_workers=_workers(C.BUILD_MERGE_WORKERS, auto.merge_workers),
            queue_depth=max(1, int(self.get(C.BUILD_QUEUE_DEPTH, auto.queue_depth))),
        )

    def build_device(self):
        """The DeviceBuildConfig from the ``hyperspace.index.build.device.*``
        knobs: ``doubleBuffer`` rotates the pinned host slab pair under the
        H2D copy, ``runChunks`` sets how many sorted chunks stay on the card
        before they merge into one run (below 1 clamps to 1, the per-chunk
        round trip). The staged runs borrow from the residency budget
        (``hyperspace.torch.hbm.budgetMB``)."""
        from .index.stream_builder import DeviceBuildConfig

        return DeviceBuildConfig(
            double_buffer=self._to_bool(
                self.get(
                    C.BUILD_DEVICE_DOUBLE_BUFFER,
                    C.BUILD_DEVICE_DOUBLE_BUFFER_DEFAULT,
                )
            ),
            run_chunks=max(
                1,
                int(
                    self.get(
                        C.BUILD_DEVICE_RUN_CHUNKS,
                        C.BUILD_DEVICE_RUN_CHUNKS_DEFAULT,
                    )
                ),
            ),
            hbm_budget_bytes=self.residency().budget_bytes,
        )

    def compaction_buckets_per_step(self) -> int:
        return max(
            1,
            int(
                self.get(
                    C.INDEX_COMPACTION_BUCKETS_PER_STEP,
                    C.INDEX_COMPACTION_BUCKETS_PER_STEP_DEFAULT,
                )
            ),
        )

    def compaction_max_steps_per_sweep(self) -> int:
        return max(
            1,
            int(
                self.get(
                    C.INDEX_COMPACTION_MAX_STEPS_PER_SWEEP,
                    C.INDEX_COMPACTION_MAX_STEPS_PER_SWEEP_DEFAULT,
                )
            ),
        )

    def _choice(self, key: str, default: str, modes) -> str:
        v = str(self.get(key, default)).lower()
        if v not in modes:
            raise HyperspaceException(f"Unknown {key}={v!r}; expected one of {modes}.")
        return v

    def compaction_enabled(self) -> bool:
        return self._choice(C.INDEX_COMPACTION, C.INDEX_COMPACTION_DEFAULT,
                            C.INDEX_COMPACTION_MODES) == C.INDEX_COMPACTION_AUTO

    def compaction_interval_seconds(self) -> float:
        return float(self.get(C.INDEX_COMPACTION_INTERVAL_SECONDS,
                              C.INDEX_COMPACTION_INTERVAL_SECONDS_DEFAULT))

    # -- whole-plan compilation ------------------------------------------------
    def compile_mode(self) -> str:
        return self._choice(C.COMPILE_MODE, C.COMPILE_MODE_DEFAULT, C.COMPILE_MODES)

    def compile_cache_entries(self) -> int:
        return int(self.get(C.COMPILE_CACHE_ENTRIES, C.COMPILE_CACHE_ENTRIES_DEFAULT))

    def compile_result_cache_enabled(self) -> bool:
        return self._choice(C.COMPILE_RESULT_CACHE, C.COMPILE_RESULT_CACHE_DEFAULT,
                            C.COMPILE_RESULT_CACHE_MODES) == C.COMPILE_RESULT_CACHE_ON

    def compile_result_cache_entries(self) -> int:
        return int(self.get(C.COMPILE_RESULT_CACHE_ENTRIES,
                            C.COMPILE_RESULT_CACHE_ENTRIES_DEFAULT))

    def compile_result_cache_max_bytes(self) -> int:
        return int(self.get(C.COMPILE_RESULT_CACHE_MAX_BYTES,
                            C.COMPILE_RESULT_CACHE_MAX_BYTES_DEFAULT))

    def compile_result_cache_window(self) -> int:
        return max(int(self.get(C.COMPILE_RESULT_CACHE_WINDOW,
                                C.COMPILE_RESULT_CACHE_WINDOW_DEFAULT)), 1)

    def compile_result_cache_byte_rate(self) -> int:
        return max(int(self.get(C.COMPILE_RESULT_CACHE_BYTE_RATE,
                                C.COMPILE_RESULT_CACHE_BYTE_RATE_DEFAULT)), 1)

    def compile_result_cache_budget_share(self) -> float:
        v = float(self.get(C.COMPILE_RESULT_CACHE_BUDGET_SHARE,
                           C.COMPILE_RESULT_CACHE_BUDGET_SHARE_DEFAULT))
        return min(max(v, 0.0), 0.5)

    # -- serving ----------------------------------------------------------------
    def serve_tenant_policy(self, tenant: str):
        """The TenantPolicy for ``tenant``: the per-tenant keys
        (``hyperspace.serve.tenant.<name>.weight`` / ``.maxQueue`` /
        ``.maxInflight``) over the defaults, resolved at the tenant's first
        submit on a server."""
        from .serve.tenancy import TenantPolicy

        def over(field: str, key: str, default):
            return self.get(f"{C.SERVE_TENANT_PREFIX}.{tenant}.{field}", self.get(key, default))

        weight = float(over("weight", C.SERVE_TENANT_DEFAULT_WEIGHT,
                            C.SERVE_TENANT_DEFAULT_WEIGHT_DEFAULT))
        if weight <= 0:
            raise HyperspaceException(f"tenant {tenant!r}: weight must be > 0, got {weight}.")
        return TenantPolicy(
            weight=weight,
            max_queue=int(over("maxQueue", C.SERVE_TENANT_DEFAULT_MAX_QUEUE,
                               C.SERVE_TENANT_DEFAULT_MAX_QUEUE_DEFAULT)),
            max_inflight=int(over("maxInflight", C.SERVE_TENANT_DEFAULT_MAX_INFLIGHT,
                                  C.SERVE_TENANT_DEFAULT_MAX_INFLIGHT_DEFAULT)),
        )

    def serve_breaker_miss_threshold(self) -> int:
        return int(self.get(C.SERVE_BREAKER_MISS_THRESHOLD,
                            C.SERVE_BREAKER_MISS_THRESHOLD_DEFAULT))

    def serve_breaker_open_seconds(self) -> float:
        return float(self.get(C.SERVE_BREAKER_OPEN_SECONDS,
                              C.SERVE_BREAKER_OPEN_SECONDS_DEFAULT))

    def serve_shed_highwater_fraction(self) -> float:
        return float(self.get(C.SERVE_SHED_HIGHWATER_FRACTION,
                              C.SERVE_SHED_HIGHWATER_FRACTION_DEFAULT))

    def serve_shed_batch_off_fraction(self) -> float:
        return float(self.get(C.SERVE_SHED_BATCH_OFF_FRACTION,
                              C.SERVE_SHED_BATCH_OFF_FRACTION_DEFAULT))

    def serve_drain_rate_window_seconds(self) -> float:
        return float(self.get(C.SERVE_DRAIN_RATE_WINDOW_SECONDS,
                              C.SERVE_DRAIN_RATE_WINDOW_SECONDS_DEFAULT))

    # -- tracing and export -------------------------------------------------------
    def telemetry_tracing_enabled(self) -> bool:
        return self._choice(C.TELEMETRY_TRACING, C.TELEMETRY_TRACING_DEFAULT,
                            C.TELEMETRY_TRACING_MODES) == C.TELEMETRY_TRACING_ON

    def telemetry_recorder_entries(self) -> int:
        return int(self.get(C.TELEMETRY_RECORDER_ENTRIES, C.TELEMETRY_RECORDER_ENTRIES_DEFAULT))

    def telemetry_recorder_snapshots(self) -> int:
        return int(self.get(C.TELEMETRY_RECORDER_SNAPSHOTS,
                            C.TELEMETRY_RECORDER_SNAPSHOTS_DEFAULT))

    def telemetry_export_dir(self) -> Optional[str]:
        """The metrics-rotation directory, or None (off). "auto" resolves
        next to the operation log under the system path."""
        v = self.get(C.TELEMETRY_EXPORT_DIR)
        if not v:
            return None
        if str(v).lower() == C.TELEMETRY_EXPORT_DIR_AUTO:
            from pathlib import Path

            return str(Path(self.system_path()) / C.TELEMETRY_METRICS_DIRNAME)
        return str(v)

    def telemetry_export_rotate_bytes(self) -> int:
        return int(self.get(C.TELEMETRY_EXPORT_ROTATE_BYTES,
                            C.TELEMETRY_EXPORT_ROTATE_BYTES_DEFAULT))

    def telemetry_export_keep(self) -> int:
        return int(self.get(C.TELEMETRY_EXPORT_KEEP, C.TELEMETRY_EXPORT_KEEP_DEFAULT))

    def segment_io_mode(self) -> str:
        v = str(
            self.get(C.STORAGE_SEGMENT_IO, C.STORAGE_SEGMENT_IO_DEFAULT)
        ).lower()
        if v not in C.STORAGE_SEGMENT_IO_MODES:
            raise HyperspaceException(
                f"Unknown {C.STORAGE_SEGMENT_IO}={v!r}; expected one of "
                f"{C.STORAGE_SEGMENT_IO_MODES}."
            )
        return v

    def torch_device(self) -> str:
        return str(self.get(C.TORCH_DEVICE, C.TORCH_DEVICE_DEFAULT))

    def distributed_min_rows(self) -> int:
        return int(self.get(C.TPU_DISTRIBUTED_MIN_ROWS, C.TPU_DISTRIBUTED_MIN_ROWS_DEFAULT))

    def profile_dir(self) -> Optional[str]:
        v = self.get(C.TPU_PROFILE_DIR)
        return str(v) if v else None

    def residency(self) -> "ResidencyConf":
        """The HBM-residency knobs, parsed as the reference parses its
        environment knobs: a malformed value falls back to its default."""

        def num(key, default, cast):
            try:
                return cast(self.get(key, default))
            except (TypeError, ValueError):
                return default

        def choice(key, default, modes):
            v = str(self.get(key, default)).lower()
            if v not in modes:
                raise HyperspaceException(
                    f"Unknown {key}={v!r}; expected one of {modes}."
                )
            return v

        mode = str(self.get(C.HBM_MODE, C.HBM_MODE_DEFAULT)).lower()
        frac = num(C.HBM_MAX_BLOCK_FRAC, C.HBM_MAX_BLOCK_FRAC_DEFAULT, float)
        window = num(
            C.RESIDENCY_STREAMING_WINDOW_ROWS,
            C.RESIDENCY_STREAMING_WINDOW_ROWS_DEFAULT,
            int,
        )
        return ResidencyConf(
            mode=mode if mode in C.HBM_MODES else C.HBM_MODE_DEFAULT,
            budget_mb=num(C.HBM_BUDGET_MB, C.HBM_BUDGET_MB_DEFAULT, int),
            min_rows=num(C.HBM_MIN_ROWS, C.HBM_MIN_ROWS_DEFAULT, int),
            max_block_frac=(
                frac if 0.0 < frac <= 1.0 else C.HBM_MAX_BLOCK_FRAC_DEFAULT
            ),
            compression=choice(
                C.RESIDENCY_COMPRESSION,
                C.RESIDENCY_COMPRESSION_DEFAULT,
                C.RESIDENCY_COMPRESSION_MODES,
            ),
            streaming=choice(
                C.RESIDENCY_STREAMING,
                C.RESIDENCY_STREAMING_DEFAULT,
                C.RESIDENCY_STREAMING_MODES,
            ),
            window_rows=(
                window if window > 0 else C.RESIDENCY_STREAMING_WINDOW_ROWS_DEFAULT
            ),
            for_delta=str(
                self.get(C.RESIDENCY_FOR_DELTA, C.RESIDENCY_FOR_DELTA_DEFAULT)
            ).lower() not in C.RESIDENCY_FOR_DELTA_OFF,
        )


@dataclass(frozen=True)
class ResidencyConf:
    """Where and how much of an index the scan keeps resident on the
    device (``exec/hbm_cache.py``). A residency policy, not a kernel
    switch: with residency off or declined, the scan still evaluates its
    predicate through the mask kernel, file by file."""

    mode: str = C.HBM_MODE_DEFAULT
    budget_mb: int = C.HBM_BUDGET_MB_DEFAULT
    min_rows: int = C.HBM_MIN_ROWS_DEFAULT
    max_block_frac: float = C.HBM_MAX_BLOCK_FRAC_DEFAULT
    # the tier ladder past the raw planes (residency/tiers.py)
    compression: str = C.RESIDENCY_COMPRESSION_DEFAULT
    streaming: str = C.RESIDENCY_STREAMING_DEFAULT
    window_rows: int = C.RESIDENCY_STREAMING_WINDOW_ROWS_DEFAULT
    # resident join regions FoR-pack their sorted right codes (K2p)
    for_delta: bool = True

    @property
    def budget_bytes(self) -> int:
        return self.budget_mb << 20
