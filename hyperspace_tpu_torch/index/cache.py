"""Generic cache + creation-time-based implementation.

Parity: ``hyperspace_tpu.index.cache`` (Cache.scala:23-40 and the
CreationTimeBasedIndexCache of CachingIndexCollectionManager.scala:124-170;
expiry via ``hyperspace.index.cache.expiryDurationInSeconds``, default
300 s).
"""

from __future__ import annotations

import time
from typing import Generic, Optional, TypeVar

T = TypeVar("T")


class Cache(Generic[T]):
    def get(self) -> Optional[T]:
        raise NotImplementedError

    def set(self, entry: T) -> None:
        raise NotImplementedError

    def clear(self) -> None:
        raise NotImplementedError


class CreationTimeBasedCache(Cache[T]):
    def __init__(self, expiry_seconds_fn):
        self._expiry_fn = expiry_seconds_fn
        self._entry: Optional[T] = None
        self._created_at: float = 0.0

    def get(self) -> Optional[T]:
        if self._entry is None:
            return None
        if time.time() - self._created_at > self._expiry_fn():
            self._entry = None
            return None
        return self._entry

    def set(self, entry: T) -> None:
        self._entry = entry
        self._created_at = time.time()

    def clear(self) -> None:
        self._entry = None
