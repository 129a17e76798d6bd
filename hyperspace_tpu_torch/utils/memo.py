"""Bounded-FIFO memo insert shared by the metadata caches.

Four hot-path memos (source snapshots, inferred schemas, partition specs,
parquet footers) bound themselves the same way; this is the one copy of
the eviction logic, written to survive concurrent callers — union sides
of a query execute on separate threads, so two inserts can race. Eviction
uses ``pop(k, None)`` (a racing evictor cannot raise KeyError) and
tolerates the iterator invalidation a concurrent mutation causes (worst
case the memo briefly holds a few extra entries).
"""

from __future__ import annotations


def bounded_memo_put(memo: dict, key, value, cap: int) -> None:
    """Insert ``key → value``, evicting oldest-inserted entries to keep
    ``len(memo)`` at or under ``cap``."""
    while len(memo) >= cap:
        try:
            oldest = next(iter(memo))
        except (StopIteration, RuntimeError):
            break  # emptied or resized under us: stop evicting
        memo.pop(oldest, None)
    memo[key] = value
