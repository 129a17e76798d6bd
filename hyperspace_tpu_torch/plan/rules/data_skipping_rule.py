"""DataSkippingFilterRule: prune a filtered scan's file list via sketches.

Unlike the covering-index rules, this rule never replaces the scan — it
narrows ``relation.files`` to the files whose sketches might satisfy the
predicate (conservative: bloom has no false negatives, min/max bounds are
exact), so results are bit-identical with the index on or off. Runs after
Join/FilterIndexRule so covering rewrites get first claim on scans
(package.scala:25-35 ordering rationale extended to the sketch kind).
"""

from __future__ import annotations

import logging
from dataclasses import replace as dc_replace
from typing import List, Optional, Tuple

from ... import constants as C
from ...config import HyperspaceConf
from ...index.log_entry import IndexLogEntry
from ...index.sketches import load_sketch_table, sketch_from_json_dict, sketch_key
from ..expr import bounds_for_column, pinned_values
from ..ir import Filter, LogicalPlan, Project, Scan
from . import rule_utils
from .filter_rule import extract_filter_node

logger = logging.getLogger(__name__)


def prune_files(entry: IndexLogEntry, scan: Scan, predicate) -> Optional[List]:
    """Files of ``scan`` that might match ``predicate``, or None when the
    sketches cannot prune (missing table / no applicable sketch)."""
    table = load_sketch_table(entry.content.files())
    if table is None:
        return None
    specs = [sketch_from_json_dict(s) for s in entry.derived_dataset.sketches]
    dtypes = entry.derived_dataset.schema
    # The predicate's own column spelling drives bounds/pins extraction —
    # sketch columns carry the source schema's case, which may differ.
    pred_col_by_lower = {c.lower(): c for c in predicate.columns()}
    # (key, prepared test) — bounds/pin extraction, literal normalization,
    # and bloom pin-hashing are all loop-invariant per file (prepare_test)
    active = []
    for spec in specs:
        qcol = pred_col_by_lower.get(spec.column.lower())
        if qcol is None:
            continue
        bounds = bounds_for_column(predicate, qcol)
        if bounds == (None, None):
            bounds = None
        pins = pinned_values(predicate, qcol)
        if bounds is None and pins is None:
            continue  # predicate gives this sketch nothing to test
        test = spec.prepare_test(dtypes[spec.column], bounds, pins)
        active.append((sketch_key(spec.to_json_dict()), test))
    if not active:
        return None
    kept = []
    for f in scan.relation.files:
        data = table.get(f.name)
        if data is None:
            kept.append(f)  # unsketched file (e.g. appended): cannot prune
            continue
        might = True
        for key, test in active:
            sk = data.get(key)
            if sk is not None and not test(sk):
                might = False
                break
        if might:
            kept.append(f)
    return kept


class DataSkippingFilterRule:
    """Apply with ``rule.apply(plan, indexes, conf)``."""

    def apply(
        self,
        plan: LogicalPlan,
        indexes: List[IndexLogEntry],
        conf: HyperspaceConf,
    ) -> Tuple[LogicalPlan, List[IndexLogEntry]]:
        skipping = [
            e for e in indexes if e.derived_dataset.kind == "DataSkippingIndex"
        ]
        if not skipping:
            return plan, []
        applied: List[IndexLogEntry] = []
        # Sketch indexes match on exact signature only, as the covering
        # rules do with hybrid scan off (files the table never saw would be
        # kept anyway).
        no_hybrid = conf.copy().set(C.INDEX_HYBRID_SCAN_ENABLED, False)

        def rewrite(node: LogicalPlan) -> Optional[LogicalPlan]:
            try:
                extracted = extract_filter_node(node)
                if extracted is None or rule_utils.is_index_applied(node):
                    return None
                sub_plan = (
                    extracted.project
                    if extracted.project is not None
                    else extracted.filter
                )
                candidates = rule_utils.get_candidate_indexes(
                    skipping, sub_plan, no_hybrid, kind="DataSkippingIndex"
                )
                scan = extracted.scan
                predicate = extracted.filter.condition
                for entry in candidates:
                    kept = prune_files(entry, scan, predicate)
                    if kept is None or len(kept) == len(scan.relation.files):
                        continue
                    from ...telemetry.metrics import metrics

                    metrics.incr(
                        "scan.sketch_pruned", len(scan.relation.files) - len(kept)
                    )
                    new_rel = dc_replace(scan.relation, files=kept)
                    new_scan = Scan(new_rel)
                    new_node: LogicalPlan = Filter(predicate, new_scan)
                    if extracted.project is not None:
                        new_node = Project(extracted.project.columns, new_node)
                    applied.append(entry)
                    return new_node
                return None
            except Exception as e:
                # never break the query (FilterIndexRule.scala:79-83): a
                # vacuumed or corrupt sketches.json leaves the scan unpruned
                logger.warning("DataSkippingFilterRule skipped: %s", e)
                return None

        from .filter_rule import FilterIndexRule

        result = FilterIndexRule._transform_down(plan, rewrite)
        return result, applied
