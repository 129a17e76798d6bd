"""Predicate pushdown through inner joins.

Catalyst runs PushPredicateThroughJoin before the reference's rules ever
see a plan, so `join(...).filter(side_pred)` reaches JoinIndexRule with
the side predicate already inside the (still linear) join child. This
framework owns its optimizer, so the same normalization lives here and
runs with column pruning on every collect() (dataframe.optimized_plan):

* the filter condition splits into top-level conjuncts;
* a conjunct whose columns all come from one side moves into that side
  (sound for INNER joins only: rows a side-filter drops cannot produce
  output rows);
* mixed conjuncts (referencing both sides) stay above the join.

Besides executing less data, this is what lets FilterIndexRule /
JoinIndexRule fire on filtered-join shapes: the pushed-down Filter sits
directly over the side's Scan where the rules' linear-plan matching and
(filter-aware) coverage checks apply.
"""

from __future__ import annotations

from typing import List, Optional

from ..expr import And, Expr
from ..ir import Filter, Join, LogicalPlan, Project


def split_conjuncts(cond: Expr) -> List[Expr]:
    if isinstance(cond, And):
        return split_conjuncts(cond.left) + split_conjuncts(cond.right)
    return [cond]


def conjoin(conjuncts: List[Expr]) -> Expr:
    out = conjuncts[0]
    for c in conjuncts[1:]:
        out = And(out, c)
    return out


def push_filters_through_joins(plan: LogicalPlan) -> LogicalPlan:
    """Runs to FIXPOINT: one bottom-up pass moves a predicate a single
    level (transform_up never revisits the subtree it just built), so a
    3-table join chain — Filter above Join above Join — needs one pass per
    level for the predicate to reach its scan. Filters also commute with
    Project (pure column selection, and a well-formed Filter above a
    Project references only projected columns), which un-sticks the
    ``join(...).select(...).filter(...)`` shape."""

    def rewrite(node: LogicalPlan) -> Optional[LogicalPlan]:
        if not isinstance(node, Filter):
            return None
        if isinstance(node.child, Filter):
            # CombineFilters: stacked .filter() calls merge so a pushable
            # conjunct above a retained mixed conjunct still descends
            return Filter(And(node.condition, node.child.condition), node.child.child)
        if isinstance(node.child, Project):
            pr = node.child
            return Project(pr.columns, Filter(node.condition, pr.child))
        if not isinstance(node.child, Join):
            return None
        join = node.child
        if join.join_type != "inner":
            return None  # side filters are only sound under inner joins
        l_cols = {c.lower() for c in join.left.output_columns()}
        r_cols = {c.lower() for c in join.right.output_columns()}
        to_left: List[Expr] = []
        to_right: List[Expr] = []
        keep: List[Expr] = []
        for c in split_conjuncts(node.condition):
            refs = {x.lower() for x in c.columns()}
            if refs and refs <= l_cols:
                to_left.append(c)
            elif refs and refs <= r_cols:
                to_right.append(c)
            else:
                keep.append(c)
        if not to_left and not to_right:
            return None
        left = Filter(conjoin(to_left), join.left) if to_left else join.left
        right = Filter(conjoin(to_right), join.right) if to_right else join.right
        new_join = Join(left, right, join.condition, join.join_type)
        return Filter(conjoin(keep), new_join) if keep else new_join

    current = plan
    for _ in range(32):  # bound >= any sane plan depth; each pass strictly
        nxt = current.transform_up(rewrite)  # lowers some Filter or fixes
        if nxt is current:
            break
        current = nxt
    return current
