"""Hybrid Scan: use an index whose source has since gained or lost files.

Parity: RuleUtils.transformPlanToUseHybridScan
(rules/RuleUtils.scala:307-450):

  * appended/deleted computed as the set-diff between the plan's current
    file snapshot and the entry's logged snapshot (:325-354) — a
    quick-refresh entry's recorded Update produces the same diff;
  * deletes: the index side gains a lineage filter
    ``NOT _data_file_id IN deleted_ids`` and a Project dropping the lineage
    column (:406-415) — lineage is mandatory for deletes (enforced at
    candidate selection);
  * appends: a separate subplan scans ONLY the appended files and projects
    to the index's user columns (transformPlanToReadAppendedFiles
    :464-507);
  * merge: for bucket-spec (join) rewrites, BucketUnion of the index side
    with an on-the-fly Repartition of the appended side to the index's
    bucketing (:519-578) — only the (small) appended data shuffles; for
    filter rewrites, a plain Union (:443-446).

Divergence from the reference: no "inline read" fast path (:356-377) — the
reference can list appended parquet files into the same scan as index
parquet; here index data is TCB, not the source format, so appended data
always goes through its own scan node. Same results, one extra plan node.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Set, Tuple

from ...config import HyperspaceConf
from ...exceptions import HyperspaceException
from ...index.log_entry import FileInfo, IndexLogEntry
from ... import constants as C
from ...sources.relation import FileRelation
from ..expr import Col, In, Not, col, is_in
from ..ir import (
    BucketUnion,
    Filter,
    IndexScan,
    LogicalPlan,
    Project,
    Repartition,
    Scan,
    Union,
)


def source_delta(entry: IndexLogEntry, scan: Scan):
    """(appended, deleted) FileInfo lists: current plan snapshot vs the
    entry's logged snapshot (RuleUtils.scala:325-354)."""
    current: Set[FileInfo] = set(scan.relation.files)
    logged: Set[FileInfo] = set(entry.source_file_infos())
    appended = sorted(current - logged, key=lambda f: f.name)
    deleted = sorted(logged - current, key=lambda f: f.name)
    return appended, deleted


def deleted_file_ids(entry: IndexLogEntry, deleted: List[FileInfo]) -> List[int]:
    """Lineage ids of deleted files, from the entry's logged snapshot (ids
    were assigned at index build)."""
    by_key = {
        (f.name, f.size, f.modified_time): f.id for f in entry.source_file_infos()
    }
    out = []
    for f in deleted:
        fid = by_key.get((f.name, f.size, f.modified_time))
        if fid is None:
            raise HyperspaceException(
                f"Deleted file {f.name} not found in the index's snapshot."
            )
        out.append(fid)
    return sorted(out)


def transform_plan_to_use_hybrid_scan(
    entry: IndexLogEntry,
    plan: LogicalPlan,
    use_bucket_spec: bool,
    conf: HyperspaceConf,
) -> LogicalPlan:
    """Replace the plan's Scan with (index side ∪ appended side)."""

    def build_replacement(scan: Scan) -> LogicalPlan:
        appended, deleted = source_delta(entry, scan)
        user_cols = tuple(entry.derived_dataset.all_columns())

        # --- index side -----------------------------------------------------
        if deleted:
            if not entry.has_lineage_column():
                raise HyperspaceException(
                    "Hybrid Scan over deleted files requires lineage."
                )
            ids = deleted_file_ids(entry, deleted)
            index_side: LogicalPlan = Project(
                user_cols,
                Filter(
                    Not(is_in(col(C.DATA_FILE_NAME_ID), ids)),
                    IndexScan(
                        entry=entry,
                        required_columns=user_cols + (C.DATA_FILE_NAME_ID,),
                        use_bucket_spec=use_bucket_spec,
                    ),
                ),
            )
        else:
            index_side = IndexScan(
                entry=entry,
                required_columns=user_cols,
                use_bucket_spec=use_bucket_spec,
            )

        if not appended:
            return index_side

        # --- appended side (transformPlanToReadAppendedFiles) --------------
        appended_rel = FileRelation(
            root_paths=list(scan.relation.root_paths),
            file_format=scan.relation.file_format,
            schema=dict(scan.relation.schema),
            files=list(appended),
            options=dict(scan.relation.options),
            internal_format=scan.relation.internal_format,
            partition_spec=scan.relation.partition_spec,
        )
        appended_side: LogicalPlan = Project(user_cols, Scan(appended_rel))

        # --- merge ----------------------------------------------------------
        if use_bucket_spec:
            bucket_cols = tuple(entry.indexed_columns)
            return BucketUnion(
                (
                    index_side,
                    Repartition(bucket_cols, entry.num_buckets, appended_side),
                ),
                bucket_spec=(bucket_cols, entry.num_buckets),
            )
        return Union((index_side, appended_side))

    def fn(node: LogicalPlan) -> Optional[LogicalPlan]:
        if isinstance(node, Scan):
            return build_replacement(node)
        return None

    return plan.transform_up(fn)


# ---------------------------------------------------------------------------
# Delta-residency plumbing: expose the hybrid union's appended/deleted file
# sets to the scan layer. The rule above OWNS the union's shape, so the one
# recognizer lives here beside it; the executor's delta-resident arm
# (exec/executor.py:_try_resident_hybrid) reads it.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HybridUnionInfo:
    """Everything the delta-resident fast path needs from a hybrid union:
    which index the plan reads, which source files were appended since its
    snapshot (and their relation, for the one-time delta decode), and
    which logged files were deleted (as lineage ids for the deletion
    bitmask / host NOT-IN re-evaluation)."""

    entry: IndexLogEntry
    scan_node: IndexScan
    user_cols: Tuple[str, ...]  # the union's output schema (both sides)
    appended: Tuple[FileInfo, ...]  # appended source files, name-sorted
    relation: FileRelation  # appended-files-only relation (for reads)
    deleted_ids: Tuple[int, ...]  # lineage ids of deleted logged files


def parse_hybrid_union(plan: LogicalPlan) -> Optional[HybridUnionInfo]:
    """The HybridUnionInfo of a filter-shape hybrid union built by
    ``transform_plan_to_use_hybrid_scan`` — Union(index side, appended
    side) with an optional lineage NOT-IN filter on the index side — or
    None for any other plan. Never raises: an unrecognized shape is a
    routing decision (callers execute the union per-side)."""
    if not isinstance(plan, Union) or len(plan.children) != 2:
        return None

    def has_index_scan(node: LogicalPlan) -> bool:
        if isinstance(node, IndexScan):
            return True
        return any(has_index_scan(c) for c in node.children)

    idx_side = next((c for c in plan.children if has_index_scan(c)), None)
    src_side = next(
        (c for c in plan.children if not has_index_scan(c)), None
    )
    if idx_side is None or src_side is None:
        return None
    # index side: IndexScan | Project(user_cols, Filter(NOT-IN, IndexScan))
    node = idx_side
    user_cols: Optional[Tuple[str, ...]] = None
    deleted_ids: Tuple[int, ...] = ()
    if isinstance(node, Project):
        user_cols = tuple(node.columns)
        node = node.child
    if isinstance(node, Filter):
        cond = node.condition
        if not (
            isinstance(cond, Not)
            and isinstance(cond.child, In)
            and isinstance(cond.child.child, Col)
            and cond.child.child.name == C.DATA_FILE_NAME_ID
        ):
            return None
        deleted_ids = tuple(sorted(int(v) for v in cond.child.values))
        node = node.child
    if not isinstance(node, IndexScan):
        return None
    if user_cols is None:
        user_cols = tuple(node.required_columns)
    # appended side: [Project(user_cols)] Scan(appended-only relation)
    s = src_side
    if isinstance(s, Project):
        s = s.child
    if not isinstance(s, Scan) or not s.relation.files:
        return None
    src_cols = tuple(src_side.output_columns())
    if tuple(c.lower() for c in src_cols) != tuple(
        c.lower() for c in user_cols
    ):
        return None
    return HybridUnionInfo(
        node.entry,
        node,
        user_cols,
        tuple(s.relation.files),
        s.relation,
        deleted_ids,
    )
