"""Shared rewrite-rule machinery: candidate-index selection and plan
transformation.

Parity: com/microsoft/hyperspace/index/rules/RuleUtils.scala (579 LoC).
Candidate selection either requires an exact signature match
(RuleUtils.scala:61-76) or, with Hybrid Scan on, a file-overlap test with
appended/deleted byte-ratio thresholds (:78-176). Results are memoized on
the entry's tag scratch space keyed by the plan node, exactly like the
reference's tag system.
"""

from __future__ import annotations

from typing import List, Optional, Set, Tuple

from ...config import HyperspaceConf
from ...index.log_entry import FileInfo, IndexLogEntry
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


def _hybrid_scan_candidate(
    entry: IndexLogEntry, plan: LogicalPlan, conf: HyperspaceConf
) -> bool:
    """File-overlap candidacy under Hybrid Scan (RuleUtils.scala:78-145):

    * common files = entry's source snapshot ∩ the plan's current files;
    * no common data → not a candidate;
    * deleted files require lineage;
    * appended-bytes / current-total   <= maxAppendedRatio (0.3 default);
    * deleted-bytes  / indexed-total   <= maxDeletedRatio  (0.2 default).
    """

    def compute() -> bool:
        scan = single_scan(plan)
        if scan is None:
            return False
        current: Set[FileInfo] = set(scan.relation.files)
        indexed: Set[FileInfo] = set(entry.source_file_infos())
        common = current & indexed
        if not common:
            return False
        appended = current - indexed
        deleted = indexed - common
        if not appended and not deleted:
            entry.set_tag_value(plan, TAG_HYBRIDSCAN_REQUIRED, False)
            entry.set_tag_value(
                plan,
                TAG_COMMON_SOURCE_SIZE_IN_BYTES,
                sum(f.size for f in common),
            )
            return True
        if deleted and not entry.has_lineage_column():
            return False
        current_bytes = sum(f.size for f in current)
        indexed_bytes = sum(f.size for f in indexed)
        appended_bytes = sum(f.size for f in appended)
        deleted_bytes = sum(f.size for f in deleted)
        if current_bytes and appended_bytes / current_bytes > conf.hybrid_scan_appended_ratio_threshold():
            return False
        if indexed_bytes and deleted_bytes / indexed_bytes > conf.hybrid_scan_deleted_ratio_threshold():
            return False
        entry.set_tag_value(plan, TAG_HYBRIDSCAN_REQUIRED, True)
        entry.set_tag_value(
            plan, TAG_COMMON_SOURCE_SIZE_IN_BYTES, sum(f.size for f in common)
        )
        return True

    return entry.with_cached_tag(plan, TAG_IS_HYBRIDSCAN_CANDIDATE, compute)


def get_candidate_indexes(
    entries: List[IndexLogEntry],
    plan: LogicalPlan,
    conf: HyperspaceConf,
    kind: str = "CoveringIndex",
) -> List[IndexLogEntry]:
    """(RuleUtils.scala:51-177). ``kind`` keeps each rule family on its own
    index kind — a data-skipping entry's sketch columns must never satisfy
    a covering rule's coverage test."""
    entries = [e for e in entries if e.derived_dataset.kind == kind]
    if conf.hybrid_scan_enabled():
        return [e for e in entries if _hybrid_scan_candidate(e, plan, conf)]
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
    """(RuleUtils.scala:207-234): dispatch to the clean index-only scan or,
    when the candidate was selected with a source delta under Hybrid Scan,
    the hybrid transformation."""
    scan = single_scan(plan)
    hybrid_required = (
        scan is not None and entry.get_tag_value(scan, TAG_HYBRIDSCAN_REQUIRED)
    ) or entry.get_tag_value(plan, TAG_HYBRIDSCAN_REQUIRED)
    # A quick-refreshed entry carries a recorded source Update: its
    # fingerprint matches the *current* files, so it is selected via the
    # signature path even with Hybrid Scan disabled — but using it without
    # the hybrid transformation would drop appended rows / resurrect
    # deleted ones (RefreshQuickAction.scala:70-79 semantics).
    has_recorded_update = False
    if scan is not None:
        upd = entry.source_update()
        if upd is not None and (upd.appended_files or upd.deleted_files):
            from .hybrid_scan import source_delta

            appended, deleted = source_delta(entry, scan)
            has_recorded_update = bool(appended or deleted)
    if (conf.hybrid_scan_enabled() and hybrid_required) or has_recorded_update:
        from .hybrid_scan import transform_plan_to_use_hybrid_scan

        return transform_plan_to_use_hybrid_scan(entry, plan, use_bucket_spec, conf)
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
