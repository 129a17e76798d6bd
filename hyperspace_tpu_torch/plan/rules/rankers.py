"""Candidate-index rankers.

Parity: rankers/FilterIndexRanker.scala:43-59 and
rankers/JoinIndexRanker.scala:52-90.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ...index.log_entry import IndexLogEntry
from ...plan.ir import LogicalPlan
from .rule_utils import TAG_COMMON_SOURCE_SIZE_IN_BYTES


def _common_bytes(entry: IndexLogEntry, plan: LogicalPlan) -> int:
    v = entry.get_tag_value(plan, TAG_COMMON_SOURCE_SIZE_IN_BYTES)
    return v if v is not None else 0


def rank_filter_indexes(
    candidates: List[IndexLogEntry],
    plan: LogicalPlan,
    hybrid_scan_enabled: bool,
) -> Optional[IndexLogEntry]:
    """Head candidate; under Hybrid Scan the one with most common source
    bytes (FilterIndexRanker.scala:43-59)."""
    if not candidates:
        return None
    if hybrid_scan_enabled:
        return max(candidates, key=lambda e: _common_bytes(e, plan))
    return candidates[0]


def rank_join_index_pairs(
    pairs: List[Tuple[IndexLogEntry, IndexLogEntry]],
    left_plan: LogicalPlan,
    right_plan: LogicalPlan,
    hybrid_scan_enabled: bool,
) -> Optional[Tuple[IndexLogEntry, IndexLogEntry]]:
    """Prefer equal-bucket pairs (zero shuffle), then more buckets (more
    parallelism), then most common source bytes under Hybrid Scan
    (JoinIndexRanker.scala:52-90)."""
    if not pairs:
        return None

    def key(pair):
        l, r = pair
        equal = 1 if l.num_buckets == r.num_buckets else 0
        buckets = min(l.num_buckets, r.num_buckets)
        common = (
            _common_bytes(l, left_plan) + _common_bytes(r, right_plan)
            if hybrid_scan_enabled
            else 0
        )
        return (equal, buckets, common)

    return max(pairs, key=key)
