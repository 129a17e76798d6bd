"""The byte-capped LRU behind the cross-query join caches, and the one
byte heuristic every host-memory account reads.

Counterpart of ``hyperspace_tpu.exec.bytecache``. The executor's bucket
groups and the join layer's setup and ranges caches (``exec/executor.py``,
``exec/joins.py``) share one implementation of the eviction and
accounting, and the residency budget accounts (``exec/hbm_cache.py``)
share ``vocab_heap_bytes`` and ``batch_nbytes``.

The caches are process-wide, as in the reference, so their budget is an
environment knob, not session conf: ``HYPERSPACE_TPU_TORCH_JOIN_CACHE_MB``
(the reference's ``HYPERSPACE_TPU_JOIN_CACHE_MB``; 512, 0 disables).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Optional

JOIN_CACHE_MB_ENV = "HYPERSPACE_TPU_TORCH_JOIN_CACHE_MB"
JOIN_CACHE_MB_DEFAULT = 512


def env_int(name: str, default: int) -> int:
    """An integer environment knob; a malformed value falls back to the
    default instead of failing the query that touched the cache."""
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def env_mb(name: str, default_mb: int) -> int:
    """A byte budget from an environment variable holding megabytes."""
    return env_int(name, default_mb) << 20


def join_cache_budget() -> int:
    """The byte budget of each cross-query join cache (groups; setups and
    ranges), re-read on every put so a change applies live."""
    return env_mb(JOIN_CACHE_MB_ENV, JOIN_CACHE_MB_DEFAULT)


def vocab_heap_bytes(vocab) -> int:
    """Host-heap estimate of one string dictionary (bytes objects + ~50 B
    of Python overhead per entry); None counts as zero."""
    if vocab is None:
        return 0
    return sum(len(v) + 50 for v in vocab)


def batch_nbytes(batch) -> int:
    """Host bytes of a ColumnarBatch, its string dictionaries included."""
    return sum(c.data.nbytes + vocab_heap_bytes(c.vocab) for c in batch.columns.values())


class ByteCappedLru:
    """Thread-safe LRU bounded by a byte budget (re-read per put) and
    optionally an entry cap. An entry larger than the budget is refused
    rather than evicting everything."""

    def __init__(self, budget_fn, entry_cap: Optional[int] = None):
        self._budget_fn = budget_fn
        self._entry_cap = entry_cap
        self._d: "OrderedDict[object, tuple]" = OrderedDict()
        self._nbytes = 0
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            hit = self._d.get(key)
            if hit is None:
                return None
            self._d.move_to_end(key)
            return hit[0]

    def put(self, key, value, nbytes: int):
        """Insert (an existing key wins and is returned); returns the
        stored value, or None when refused (zero or over-budget size, or a
        zero budget)."""
        budget = self._budget_fn()
        if budget <= 0 or nbytes <= 0 or nbytes > budget:
            return None
        with self._lock:
            existing = self._d.get(key)
            if existing is not None:
                return existing[0]
            while self._d and (
                self._nbytes + nbytes > budget
                or (self._entry_cap and len(self._d) >= self._entry_cap)
            ):
                _, (_, old) = self._d.popitem(last=False)
                self._nbytes -= old
            self._d[key] = (value, nbytes)
            self._nbytes += nbytes
            return value

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._d

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def reset(self) -> None:
        with self._lock:
            self._d.clear()
            self._nbytes = 0
