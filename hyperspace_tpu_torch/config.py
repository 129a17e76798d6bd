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
        """The build mode; this package builds in memory only, so "auto"
        resolves to "inmemory" and "streaming" raises."""
        v = str(self.get(C.BUILD_MODE, C.BUILD_MODE_DEFAULT)).lower()
        if v not in C.BUILD_MODES:
            raise HyperspaceException(
                f"Unknown build mode {v!r}; expected one of {C.BUILD_MODES}."
            )
        if v == C.BUILD_MODE_STREAMING:
            raise HyperspaceException(
                f"{C.BUILD_MODE}=streaming is not yet ported to "
                "hyperspace_tpu_torch; use inmemory."
            )
        return C.BUILD_MODE_INMEMORY

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

        mode = str(self.get(C.HBM_MODE, C.HBM_MODE_DEFAULT)).lower()
        frac = num(C.HBM_MAX_BLOCK_FRAC, C.HBM_MAX_BLOCK_FRAC_DEFAULT, float)
        return ResidencyConf(
            mode=mode if mode in C.HBM_MODES else C.HBM_MODE_DEFAULT,
            budget_mb=num(C.HBM_BUDGET_MB, C.HBM_BUDGET_MB_DEFAULT, int),
            min_rows=num(C.HBM_MIN_ROWS, C.HBM_MIN_ROWS_DEFAULT, int),
            max_block_frac=(
                frac if 0.0 < frac <= 1.0 else C.HBM_MAX_BLOCK_FRAC_DEFAULT
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

    @property
    def budget_bytes(self) -> int:
        return self.budget_mb << 20
