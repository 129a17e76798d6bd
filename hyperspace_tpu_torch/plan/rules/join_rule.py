"""JoinIndexRule: rewrite an equi-join to scan two bucket-compatible
covering indexes, enabling a shuffle-free sort-merge join.

Parity: com/microsoft/hyperspace/index/rules/JoinIndexRule.scala (534 LoC).
Applicability:

  * inner equi-join whose condition is a conjunction of Col == Col
    (:118-124);
  * both sides are linear single-relation plans (:149-150);
  * neither side already index-rewritten (:159-165);
  * every condition column maps 1:1 between left and right (:232-271);
  * a *usable* index per side: indexed columns == that side's join keys
    (as a set), and all referenced columns covered (:451-463);
  * a *compatible* pair: the two indexes list their indexed columns in the
    same order under the left↔right column mapping (:486-533) — same order
    means same hash-bucket layout per key tuple, hence no shuffle.

The rewrite swaps both children's Scans for IndexScans with
``use_bucket_spec=True`` (:62-69).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

from ...config import HyperspaceConf
from ...exceptions import HyperspaceException
from ...index.log_entry import IndexLogEntry
from ...utils import resolver
from ..expr import And, Cmp, Col, Expr
from ..ir import Filter, Join, LogicalPlan
from . import rule_utils
from .rankers import rank_join_index_pairs

logger = logging.getLogger(__name__)


def extract_equi_condition(cond: Expr) -> Optional[List[Tuple[str, str]]]:
    """Flatten an AND-tree of Col == Col into (left, right) name pairs;
    None if any conjunct has another shape (JoinIndexRule.scala:118-124)."""
    pairs: List[Tuple[str, str]] = []

    def walk(e: Expr) -> bool:
        if isinstance(e, And):
            return walk(e.left) and walk(e.right)
        if (
            isinstance(e, Cmp)
            and e.op == "eq"
            and isinstance(e.left, Col)
            and isinstance(e.right, Col)
        ):
            pairs.append((e.left.name, e.right.name))
            return True
        return False

    return pairs if walk(cond) else None


def align_condition_sides(
    pairs: List[Tuple[str, str]],
    left_cols: List[str],
    right_cols: List[str],
) -> Optional[List[Tuple[str, str]]]:
    """Orient each pair as (left-side column, right-side column); None if a
    column belongs to neither or both sides ambiguously
    (JoinIndexRule.scala:168-231)."""
    out: List[Tuple[str, str]] = []
    for a, b in pairs:
        a_left = resolver.resolve(a, left_cols) is not None
        a_right = resolver.resolve(a, right_cols) is not None
        b_left = resolver.resolve(b, left_cols) is not None
        b_right = resolver.resolve(b, right_cols) is not None
        if a_left and b_right and not (a_right and b_left):
            out.append((resolver.resolve(a, left_cols), resolver.resolve(b, right_cols)))
        elif a_right and b_left and not (a_left and b_right):
            out.append((resolver.resolve(b, left_cols), resolver.resolve(a, right_cols)))
        else:
            return None
    return out


def ensure_one_to_one(pairs: List[Tuple[str, str]]) -> Optional[Dict[str, str]]:
    """Each left key equates to exactly one right key and vice versa
    (JoinIndexRule.scala:232-271)."""
    l2r: Dict[str, str] = {}
    r2l: Dict[str, str] = {}
    for l, r in pairs:
        if l2r.get(l, r) != r or r2l.get(r, l) != l:
            return None
        l2r[l] = r
        r2l[r] = l
    return l2r


def _side_required_columns(side: LogicalPlan, keys: List[str]) -> List[str]:
    """Every column a join side references: its output, the join keys, and
    any Filter condition columns inside the (linear) side — those survive
    the rewrite as Filter nodes above the IndexScan, so the index must
    carry them (JoinIndexRule.scala:451-463 allRequiredCols)."""
    cols = list(side.output_columns()) + list(keys)
    for f in side.collect(lambda n: isinstance(n, Filter)):
        cols += sorted(f.condition.columns())
    return list(dict.fromkeys(cols))


def usable_indexes(
    entries: List[IndexLogEntry], keys: List[str], required: List[str]
) -> List[IndexLogEntry]:
    """indexed == keys (set equality) and coverage (JoinIndexRule.scala:451-463)."""
    out = []
    key_set = {k.lower() for k in keys}
    for e in entries:
        if {c.lower() for c in e.indexed_columns} != key_set:
            continue
        if rule_utils.index_covers(e, set(required)):
            out.append(e)
    return out


def compatible_pairs(
    lefts: List[IndexLogEntry],
    rights: List[IndexLogEntry],
    l2r: Dict[str, str],
) -> List[Tuple[IndexLogEntry, IndexLogEntry]]:
    """Indexed-column order must align under the l↔r mapping
    (JoinIndexRule.scala:486-533)."""
    l2r_low = {l.lower(): r.lower() for l, r in l2r.items()}
    out = []
    for le in lefts:
        mapped = [l2r_low.get(c.lower()) for c in le.indexed_columns]
        for re_ in rights:
            if [c.lower() for c in re_.indexed_columns] == mapped:
                out.append((le, re_))
    return out


class JoinIndexRule:
    def apply(
        self,
        plan: LogicalPlan,
        indexes: List[IndexLogEntry],
        conf: HyperspaceConf,
    ) -> Tuple[LogicalPlan, List[IndexLogEntry]]:
        applied: List[IndexLogEntry] = []

        def rewrite(node: LogicalPlan) -> Optional[LogicalPlan]:
            if not isinstance(node, Join) or node.join_type != "inner":
                return None
            try:
                return self._try_rewrite(node, indexes, conf, applied)
            except HyperspaceException as e:  # never break the query (:85-89)
                logger.warning("JoinIndexRule skipped: %s", e)
                return None

        return plan.transform_up(rewrite), applied

    def _try_rewrite(
        self,
        join: Join,
        indexes: List[IndexLogEntry],
        conf: HyperspaceConf,
        applied: List[IndexLogEntry],
    ) -> Optional[LogicalPlan]:
        left, right = join.left, join.right
        if rule_utils.is_index_applied(left) or rule_utils.is_index_applied(right):
            return None
        if not (rule_utils.is_linear(left) and rule_utils.is_linear(right)):
            return None
        if rule_utils.single_scan(left) is None or rule_utils.single_scan(right) is None:
            return None
        raw_pairs = extract_equi_condition(join.condition)
        if not raw_pairs:
            return None
        oriented = align_condition_sides(
            raw_pairs, left.output_columns(), right.output_columns()
        )
        if oriented is None:
            return None
        l2r = ensure_one_to_one(oriented)
        if l2r is None:
            return None
        l_keys = list(dict.fromkeys(l for l, _ in oriented))
        r_keys = list(dict.fromkeys(r for _, r in oriented))

        # ALL referenced columns must be covered, not just the side's
        # output: a Filter inside a linear side (Project above Filter)
        # references columns the projection drops, and a rewrite whose
        # index lacks them would crash (or silently mis-filter) at exec —
        # the reference's allRequiredCols walks every reference
        # (JoinIndexRule.scala:451-463)
        l_required = _side_required_columns(left, l_keys)
        r_required = _side_required_columns(right, r_keys)

        l_candidates = rule_utils.get_candidate_indexes(indexes, left, conf)
        r_candidates = rule_utils.get_candidate_indexes(indexes, right, conf)
        pairs = compatible_pairs(
            usable_indexes(l_candidates, l_keys, l_required),
            usable_indexes(r_candidates, r_keys, r_required),
            l2r,
        )
        best = rank_join_index_pairs(pairs, left, right, conf.hybrid_scan_enabled())
        if best is None:
            return None
        le, re_ = best
        new_left = rule_utils.transform_plan_to_use_index(
            le, left, use_bucket_spec=True, conf=conf
        )
        new_right = rule_utils.transform_plan_to_use_index(
            re_, right, use_bucket_spec=True, conf=conf
        )
        applied.extend([le, re_])
        return Join(new_left, new_right, join.condition, join.join_type)
