"""Structural pipeline fingerprints: the compiled-pipeline cache key.

Counterpart of ``hyperspace_tpu.compile.fingerprint``. A fingerprint
captures everything that decides HOW a plan executes (operator shapes,
predicate STRUCTURE, projections, each index leaf's logged version, each
source leaf's file snapshot) and masks literal values out, so two queries
that differ only in literals share a fingerprint and a pipeline.

Residency is not part of the walk for scan and hybrid shapes: the
pipeline's arms resolve residency per run through the same procedures the
interpreter uses, so a populate or evict changes the tier served without
invalidating the pipeline. Join shapes are the exception: the fingerprint
folds the join regions' generation, so a region registered or evicted
re-lowers instead of serving a stale routing decision.
"""

from __future__ import annotations

from typing import Tuple

from ..plan.expr import And, Cmp, Col, Expr, In, Lit, Not, Or
from ..plan.ir import (
    Aggregate,
    BucketUnion,
    Filter,
    IndexScan,
    Join,
    LogicalPlan,
    Project,
    Repartition,
    Scan,
    Union,
)


def expr_structure(e: Expr) -> str:
    """Canonical structure string of a user predicate with literal values
    masked. IN keeps its value COUNT (narrowing expands it into one
    compare per value, so two INs of different arity lower differently);
    unknown nodes fingerprint by ``repr`` (literals included, so they
    never falsely share)."""
    if isinstance(e, (And, Or)):
        tag = "&" if isinstance(e, And) else "|"
        return f"({expr_structure(e.left)}{tag}{expr_structure(e.right)})"
    if isinstance(e, Not):
        return f"~({expr_structure(e.child)})"
    if isinstance(e, Cmp):
        return f"({expr_structure(e.left)} {e.op} {expr_structure(e.right)})"
    if isinstance(e, In):
        return f"in({expr_structure(e.child)},#{len(e.values)})"
    if isinstance(e, Col):
        return f"col({e.name})"
    if isinstance(e, Lit):
        return "?"
    return repr(e)


def _node_sig(n: LogicalPlan) -> Tuple:
    if isinstance(n, Filter):
        return ("F", expr_structure(n.condition))
    if isinstance(n, Project):
        return ("P", tuple(n.columns))
    if isinstance(n, IndexScan):
        # (name, log id) is the leaf's index-log version: a refresh or
        # optimize bumps the id, so a pipeline never outlives its generation
        return ("I", n.entry.name, n.entry.id, tuple(n.required_columns), n.use_bucket_spec)
    if isinstance(n, Scan):
        rel = n.relation
        return ("S", rel.file_format, tuple(rel.root_paths),
                tuple((f.name, f.size, f.modified_time) for f in rel.files))
    if isinstance(n, Join):
        return ("J", expr_structure(n.condition), n.join_type)
    if isinstance(n, Aggregate):
        return ("A", tuple(n.group_by), tuple((a.fn, a.column, a.name) for a in n.aggs))
    if isinstance(n, BucketUnion):
        cols, nb = n.bucket_spec
        return ("BU", tuple(cols), nb)
    if isinstance(n, Repartition):
        return ("R", tuple(n.columns), n.num_buckets)
    if isinstance(n, Union):
        return ("U",)
    return (n.node_name,)


def _walk(n: LogicalPlan) -> Tuple:
    return (_node_sig(n), tuple(_walk(c) for c in n.children))


def plan_fingerprint(plan: LogicalPlan) -> Tuple:
    """The structural fingerprint of an optimized plan, with the join
    regions' generation for plans that hold a Join. (The reference also
    folds its mesh's size; the port has one device.)"""
    parts: list = [_walk(plan)]
    if plan.collect(lambda n: isinstance(n, Join)):
        from ..exec.hbm_cache import hbm_cache

        parts.append(("join_regions", hbm_cache.join_region_version()))
    return tuple(parts)


def index_roots(plan: LogicalPlan) -> Tuple[str, ...]:
    """One sample data-file path per index leaf: the scoped-invalidation
    anchors of both compile caches (the collection manager drops entries
    whose anchors lie under a rewritten index's directory). A join
    pipeline carries both sides' leaves, so either side's change drops it."""
    roots = []
    for n in plan.collect(lambda n: isinstance(n, IndexScan)):
        files = n.entry.content.files()
        if files:
            roots.append(str(files[0]))
    return tuple(roots)


def batch_fingerprint(plan: LogicalPlan) -> Tuple:
    """The COARSE fingerprint the serve micro-batcher folds into its batch
    keys: each index leaf's version, the predicates' and the projection's
    column sets. Coarser than ``plan_fingerprint``: two predicate
    structures over the same resident columns may share one launch (K1b
    takes one program per query)."""
    leaves = tuple(("I", n.entry.name, n.entry.id)
                   for n in plan.collect(lambda n: isinstance(n, IndexScan)))
    preds = tuple(frozenset(n.condition.columns())
                  for n in plan.collect(lambda n: isinstance(n, Filter)))
    return (leaves, preds, frozenset(plan.output_columns()))
