"""FilterIndexRule: swap a filtered table scan for a covering-index scan.

Parity: com/microsoft/hyperspace/index/rules/FilterIndexRule.scala (191
LoC). Pattern: Scan → Filter [→ Project] (ExtractFilterNode, :155-191).
Applicability (:141-152):

  * the index covers all output + filter columns, and
  * the FIRST indexed column appears in the filter condition (the index is
    sorted/bucketed by it, so a predicate not touching it gains nothing).

Errors never break the query: any exception returns the original plan
(:79-83).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional, Set, Tuple

from ...config import HyperspaceConf
from ...exceptions import HyperspaceException
from ...index.log_entry import IndexLogEntry
from ...utils import resolver
from ..ir import Filter, LogicalPlan, Project, Scan
from . import rule_utils
from .rankers import rank_filter_indexes

logger = logging.getLogger(__name__)


@dataclass
class ExtractedFilter:
    """The matched Scan→Filter[→Project] shape (ExtractFilterNode)."""

    scan: Scan
    filter: Filter
    project: Optional[Project]

    @property
    def filter_columns(self) -> Set[str]:
        return set(self.filter.condition.columns())

    @property
    def output_columns(self) -> List[str]:
        if self.project is not None:
            return list(self.project.columns)
        return self.scan.output_columns()


def extract_filter_node(plan: LogicalPlan) -> Optional[ExtractedFilter]:
    """(FilterIndexRule.scala:155-191)."""
    if isinstance(plan, Project) and isinstance(plan.child, Filter):
        f = plan.child
        if isinstance(f.child, Scan):
            return ExtractedFilter(f.child, f, plan)
    if isinstance(plan, Filter) and isinstance(plan.child, Scan):
        return ExtractedFilter(plan.child, plan, None)
    return None


def _index_covers_plan(
    entry: IndexLogEntry, output_cols: List[str], filter_cols: Set[str]
) -> bool:
    """Coverage + head-indexed-column test (FilterIndexRule.scala:141-152)."""
    required = set(output_cols) | filter_cols
    if not rule_utils.index_covers(entry, required):
        return False
    head = entry.indexed_columns[0]
    return resolver.resolve(head, sorted(filter_cols)) is not None


def find_covering_indexes(
    extracted: ExtractedFilter,
    indexes: List[IndexLogEntry],
    conf: HyperspaceConf,
) -> List[IndexLogEntry]:
    """(FilterIndexRule.scala:96-126)."""
    sub_plan: LogicalPlan = (
        extracted.project if extracted.project is not None else extracted.filter
    )
    candidates = rule_utils.get_candidate_indexes(indexes, sub_plan, conf)
    return [
        e
        for e in candidates
        if _index_covers_plan(e, extracted.output_columns, extracted.filter_columns)
    ]


class FilterIndexRule:
    """Apply with ``rule.apply(plan, indexes, conf)``; returns the
    (possibly) rewritten plan and the list of applied entries."""

    def apply(
        self,
        plan: LogicalPlan,
        indexes: List[IndexLogEntry],
        conf: HyperspaceConf,
    ) -> Tuple[LogicalPlan, List[IndexLogEntry]]:
        applied: List[IndexLogEntry] = []

        def rewrite(node: LogicalPlan) -> Optional[LogicalPlan]:
            try:
                extracted = extract_filter_node(node)
                if extracted is None or rule_utils.is_index_applied(node):
                    return None
                covering = find_covering_indexes(extracted, indexes, conf)
                sub_plan = (
                    extracted.project
                    if extracted.project is not None
                    else extracted.filter
                )
                best = rank_filter_indexes(
                    covering, sub_plan, conf.hybrid_scan_enabled()
                )
                if best is None:
                    return None
                # Filter path keeps useBucketSpec=False to not cap scan
                # parallelism (FilterIndexRule.scala:58-65).
                new_plan = rule_utils.transform_plan_to_use_index(
                    best, node, use_bucket_spec=False, conf=conf
                )
                applied.append(best)
                return new_plan
            except HyperspaceException as e:  # never break the query (:79-83)
                logger.warning("FilterIndexRule skipped: %s", e)
                return None

        # Walk top-down so Project(Filter(Scan)) wins over its inner
        # Filter(Scan) — project-aware coverage is stricter and must be
        # checked first (the reference's transformDown has the same effect).
        result = self._transform_down(plan, rewrite)
        return result, applied

    @staticmethod
    def _transform_down(plan: LogicalPlan, fn) -> LogicalPlan:
        replaced = fn(plan)
        node = replaced if replaced is not None else plan
        new_children = tuple(
            FilterIndexRule._transform_down(c, fn) for c in node.children
        )
        if new_children != node.children:
            node = node.with_children(new_children)
        return node
