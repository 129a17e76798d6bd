"""Rewrite-rule batch: JoinIndexRule before FilterIndexRule, matching the
registration order and its rationale in the reference (package.scala:25-35:
join rewrites are strictly more constrained, so they get first claim on
scans; filter rewrites then pick up what's left), then
DataSkippingFilterRule, which prunes the file lists of the filtered scans
the covering rules left alone.
"""

from __future__ import annotations

from typing import List, Tuple

from ...config import HyperspaceConf
from ...index.log_entry import IndexLogEntry
from ..ir import LogicalPlan
from .filter_rule import FilterIndexRule
from .join_rule import JoinIndexRule


def apply_hyperspace_rules(
    plan: LogicalPlan,
    indexes: List[IndexLogEntry],
    conf: HyperspaceConf,
) -> Tuple[LogicalPlan, List[IndexLogEntry]]:
    """Returns (rewritten plan, applied index entries). Covering rules run
    first; the data-skipping rule then prunes any scans they left alone."""
    from .data_skipping_rule import DataSkippingFilterRule

    applied: List[IndexLogEntry] = []
    plan, a = JoinIndexRule().apply(plan, indexes, conf)
    applied.extend(a)
    plan, a = FilterIndexRule().apply(plan, indexes, conf)
    applied.extend(a)
    plan, a = DataSkippingFilterRule().apply(plan, indexes, conf)
    applied.extend(a)
    return plan, applied
