"""The orientation rule of the aggregate-over-join fusion.

Counterpart of ``orient_join_aggregate`` in
``hyperspace_tpu.exec.join_residency``, the one rule that puts the group
keys of an ``Aggregate([Project](Join))`` on the join's left side. The
rest of that module (device-resident join regions, ``_core_agg``,
``join_agg_fn`` and the mesh variant) is not ported yet; it lands with
join residency.
"""

from __future__ import annotations

from ..plan.ir import Join, Project


def orient_join_aggregate(agg):
    """(left_plan, right_plan, l_keys, r_keys, group_by, aggs) for an
    ``Aggregate([Project](Join))`` plan, oriented so the group keys live
    on the LEFT side (the inner join is symmetric). None when the shape or
    condition doesn't qualify, or the group keys span both sides."""
    from ..plan.rules.join_rule import (
        align_condition_sides,
        extract_equi_condition,
    )

    node = agg.child
    if isinstance(node, Project):
        node = node.child
    if not isinstance(node, Join):
        return None
    pairs = extract_equi_condition(node.condition)
    if pairs is None:
        return None
    oriented = align_condition_sides(
        pairs, node.left.output_columns(), node.right.output_columns()
    )
    if oriented is None:
        return None
    l_keys = [l for l, _ in oriented]
    r_keys = [r for _, r in oriented]
    group_by = list(agg.group_by)
    left_cols = {c.lower() for c in node.left.output_columns()}
    sides = (node.left, node.right, l_keys, r_keys)
    if not all(g.lower() in left_cols for g in group_by):
        right_cols = {c.lower() for c in node.right.output_columns()}
        if not all(g.lower() in right_cols for g in group_by):
            return None  # group keys span both sides: not fusable
        sides = (node.right, node.left, r_keys, l_keys)
    return (*sides, group_by, list(agg.aggs))
