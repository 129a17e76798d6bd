"""Session configuration: a typed key/value store with defaults.

Same keys and coercion rules as ``hyperspace_tpu.config``; only the
accessors this package reads are here.
"""

from __future__ import annotations

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

    def get(self, key: str, default: Any = None) -> Any:
        return self._values.get(key, default)

    def contains(self, key: str) -> bool:
        return key in self._values

    def copy(self) -> "HyperspaceConf":
        return HyperspaceConf(self._values)

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
