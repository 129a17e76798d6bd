"""Shared rewrite-rule machinery: candidate-index selection and plan
transformation.

Parity: com/microsoft/hyperspace/index/rules/RuleUtils.scala (579 LoC).
Candidate selection requires an exact signature match
(RuleUtils.scala:61-76); the Hybrid Scan file-overlap test is not ported.
Results are memoized on
the entry's tag scratch space keyed by the plan node, exactly like the
reference's tag system.
"""

from __future__ import annotations

from typing import List, Optional, Set, Tuple

from ...config import HyperspaceConf
from ...index.log_entry import IndexLogEntry
from ...index.signatures import create_signature_provider
from ...plan.ir import IndexScan, LogicalPlan, Scan

# Tag names (IndexLogEntryTags.scala:20-55)
TAG_SIGNATURE_MATCHED = "SIGNATURE_MATCHED"
TAG_IS_HYBRIDSCAN_CANDIDATE = "IS_HYBRIDSCAN_CANDIDATE"
TAG_HYBRIDSCAN_REQUIRED = "HYBRIDSCAN_REQUIRED"
TAG_COMMON_SOURCE_SIZE_IN_BYTES = "COMMON_SOURCE_SIZE_IN_BYTES"


def is_index_applied(plan: LogicalPlan) -> bool:
    """True if the subtree already scans an index — rewritten plans are
    never rewritten again (RuleUtils.scala:186-188, via the relation
    options marker INDEX_RELATION_IDENTIFIER)."""
    return bool(plan.collect(lambda n: isinstance(n, IndexScan)))


def single_scan(plan: LogicalPlan) -> Optional[Scan]:
    scans = plan.collect(lambda n: isinstance(n, Scan))
    return scans[0] if len(scans) == 1 else None


def is_linear(plan: LogicalPlan) -> bool:
    """Every node has at most one child (JoinIndexRule.scala:149-150)."""
    node = plan
    while True:
        kids = node.children
        if len(kids) > 1:
            return False
        if not kids:
            return True
        node = kids[0]


def _signature_valid(
    entry: IndexLogEntry, plan: LogicalPlan, conf: HyperspaceConf
) -> bool:
    """Recompute the signature over the plan's *relation* (its Scan node)
    and compare with the stored fingerprint (RuleUtils.scala:61-76 — the
    reference fingerprints the relation's logical plan, which is why an
    index created over ``read.parquet(...)`` matches any Filter/Project
    above the same relation). Memoized per (entry, scan) via tags."""
    scan = single_scan(plan)
    if scan is None:
        return False

    def compute() -> bool:
        stored = entry.signature()
        provider = create_signature_provider(stored.provider)
        current = provider.signature(scan)
        return current is not None and current == stored.value

    return entry.with_cached_tag(scan, TAG_SIGNATURE_MATCHED, compute)


def get_candidate_indexes(
    entries: List[IndexLogEntry],
    plan: LogicalPlan,
    conf: HyperspaceConf,
    kind: str = "CoveringIndex",
) -> List[IndexLogEntry]:
    """(RuleUtils.scala:51-177): exact signature match. Hybrid Scan
    candidacy (file-overlap with appended/deleted ratios) is not ported,
    so with hybrid scan enabled no index is a candidate."""
    entries = [e for e in entries if e.derived_dataset.kind == kind]
    if conf.hybrid_scan_enabled():
        return []
    return [e for e in entries if _signature_valid(e, plan, conf)]


def index_covers(entry: IndexLogEntry, required: Set[str]) -> bool:
    """All required columns present in indexed ∪ included (case-insensitive
    resolution happens before this is called)."""
    cols = {c.lower() for c in entry.derived_dataset.all_columns()}
    return {c.lower() for c in required} <= cols


def transform_plan_to_use_index(
    entry: IndexLogEntry,
    plan: LogicalPlan,
    use_bucket_spec: bool,
    conf: HyperspaceConf,
) -> LogicalPlan:
    """(RuleUtils.scala:207-234). Hybrid Scan is not ported: an entry that
    carries a recorded source update (quick refresh) would need the hybrid
    transformation to stay correct, so it is refused here and the rule
    leaves the plan alone."""
    scan = single_scan(plan)
    if scan is not None:
        upd = entry.source_update()
        if upd is not None and (upd.appended_files or upd.deleted_files):
            from ...exceptions import HyperspaceException

            raise HyperspaceException(
                f"Index {entry.name} needs Hybrid Scan, which is not yet "
                "ported to hyperspace_tpu_torch."
            )
    return transform_plan_to_use_index_only_scan(entry, plan, use_bucket_spec)


def transform_plan_to_use_index_only_scan(
    entry: IndexLogEntry,
    plan: LogicalPlan,
    use_bucket_spec: bool,
) -> LogicalPlan:
    """Swap the single Scan for an IndexScan over the index data
    (RuleUtils.scala:264-292). The IndexScan outputs the index's user
    columns (indexed + included); projection/filter nodes above survive
    unchanged."""
    cols: Tuple[str, ...] = tuple(entry.derived_dataset.all_columns())

    def fn(node: LogicalPlan) -> Optional[LogicalPlan]:
        if isinstance(node, Scan):
            return IndexScan(
                entry=entry, required_columns=cols, use_bucket_spec=use_bucket_spec
            )
        return None

    return plan.transform_up(fn)
