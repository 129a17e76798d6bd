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

    # -- generic access ------------------------------------------------------
    def set(self, key: str, value: Any) -> "HyperspaceConf":
        self._values[key] = value
        return self

    def unset(self, key: str) -> "HyperspaceConf":
        self._values.pop(key, None)
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

    @property
    def budget_bytes(self) -> int:
        return self.budget_mb << 20
