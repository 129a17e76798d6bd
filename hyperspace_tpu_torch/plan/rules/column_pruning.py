"""Column pruning (projection pushdown) for the logical-plan IR.

The reference never implements this — it registers its index rules as
``extraOptimizations``, which Catalyst runs *after* its own ColumnPruning
batch, so JoinIndexRule always sees join children that carry only the
columns the query needs (the coverage checks at JoinIndexRule.scala:451-463
depend on it). This rule restores that precondition here: at every Join it
narrows each child to (columns required above ∪ that side's join-condition
columns), inserting a Project when that is narrower than the child's
output. It runs before the Hyperspace rule batch and also benefits plain
execution (scans read fewer columns).
"""

from __future__ import annotations

from typing import List, Optional

from ...utils import resolver
from ..ir import Aggregate, Filter, Join, LogicalPlan, Project, Scan


def _resolve_needed(needed: List[str], available: List[str]) -> List[str]:
    """Map needed names onto this child's columns, case-insensitively,
    keeping the child's spelling and dropping names from the other side."""
    out = []
    for n in needed:
        r = resolver.resolve(n, available)
        if r is not None and r not in out:
            out.append(r)
    return out


def prune_columns(plan: LogicalPlan) -> LogicalPlan:
    """Rewrite ``plan`` so every Join child exposes only the columns
    referenced above it plus its join keys. The plan's own output columns
    are unchanged."""
    return _prune(plan, needed=None)


def _prune(node: LogicalPlan, needed: Optional[List[str]]) -> LogicalPlan:
    if isinstance(node, Project):
        child = _prune(node.child, list(node.columns))
        return node.with_children((child,)) if child is not node.child else node
    if isinstance(node, Filter):
        child_needed = None
        if needed is not None:
            child_needed = list(
                dict.fromkeys(list(needed) + sorted(node.condition.columns()))
            )
        child = _prune(node.child, child_needed)
        return node.with_children((child,)) if child is not node.child else node
    if isinstance(node, Aggregate):
        # the child must expose exactly the group keys + aggregate inputs,
        # regardless of what the plan above needs (agg outputs are derived)
        child_needed = node.input_columns()
        child = _prune(node.child, child_needed)
        # passing `needed` down narrows Join children (they insert their
        # own Projects), but a Filter/Scan chain has no insertion point —
        # without a Project here a projection-free
        # ``df.filter(p).group_by(g).agg(...)`` carries every source
        # column and no covering index can match the filter subtree
        child_cols = child.output_columns()
        resolved = _resolve_needed(child_needed, child_cols)
        if (
            child_needed
            and len(resolved) == len(child_needed)
            and len(resolved) < len(child_cols)
            and not isinstance(child, Project)
        ):
            child = Project(tuple(resolved), child)
        return node.with_children((child,)) if child is not node.child else node
    if isinstance(node, Join):
        want = list(needed) if needed is not None else node.output_columns()
        want = list(dict.fromkeys(want + sorted(node.condition.columns())))
        new_children = []
        changed = False
        for child in node.children:
            child_cols = child.output_columns()
            child_needed = _resolve_needed(want, child_cols)
            pruned = _prune(child, child_needed)
            if len(child_needed) < len(child_cols) and not (
                isinstance(pruned, Project)
                and list(pruned.columns) == child_needed
            ):
                pruned = Project(tuple(child_needed), pruned)
            changed = changed or pruned is not child
            new_children.append(pruned)
        return node.with_children(tuple(new_children)) if changed else node
    # leaves (Scan, IndexScan) and other nodes: recursion stops — a Project
    # wrapper above them (inserted by the Join case) carries the pruning.
    if isinstance(node, Scan) or not node.children:
        return node
    new_children = tuple(_prune(c, None) for c in node.children)
    if any(a is not b for a, b in zip(new_children, node.children)):
        return node.with_children(new_children)
    return node
