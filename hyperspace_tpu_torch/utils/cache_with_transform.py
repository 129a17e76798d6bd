"""A memo cache keyed by a config-derived value.

Parity: com/microsoft/hyperspace/util/CacheWithTransform.scala:31-44 — the
cached result is invalidated whenever the key function's output changes,
which is how conf-driven pluggables (source builders, providers) reload on
config change without an explicit invalidation hook.
"""

from __future__ import annotations

from typing import Callable, Generic, Optional, Tuple, TypeVar

K = TypeVar("K")
V = TypeVar("V")


class CacheWithTransform(Generic[K, V]):
    def __init__(self, key_fn: Callable[[], K], transform: Callable[[K], V]):
        self._key_fn = key_fn
        self._transform = transform
        self._cached: Optional[Tuple[K, V]] = None

    def load(self) -> V:
        key = self._key_fn()
        if self._cached is not None and self._cached[0] == key:
            return self._cached[1]
        value = self._transform(key)
        self._cached = (key, value)
        return value
