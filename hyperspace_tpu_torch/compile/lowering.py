"""Plan -> CompiledPipeline lowering.

Counterpart of ``hyperspace_tpu.compile.lowering`` (single device). The
lowering walks an optimized plan and decides which arm serves it fused,
routing through the eligibility procedures the interpreter already has
(``exec/scan.py``'s resident arm, ``exec/delta.py:resolve_hybrid_
residency``, ``exec/join_residency.py:resolve_join_residency``); the
interpreter (``Executor._exec``) is the fallback leg of every pipeline,
with the same results.

Shapes:

* ``scan``      ``[Project]* Filter IndexScan``: one count launch over the
  resident table (K1c, K1p, or the window loop), exact host legs;
* ``agg_scan``  ``[Project]* Aggregate([Project]* Filter IndexScan)``: the
  group-by on the card when the resident table covers the group and
  aggregate columns (``exec/scan_agg.py``), else the scan plus the host
  hash aggregate, each decline counted ``compile.agg.declined.<reason>``;
* ``hybrid``    ``[Project]* Filter Union(...)``: the delta-resident arm
  (K1h over base and delta), the per-side host union as fallback;
* ``join_agg``  ``[Project]* Aggregate([Project](Join))``: the resident
  aggregate-join arm (K2 or K2p and the epilogue), the host range fusion
  as fallback;
* ``join_shuffle`` ``[Project]* Join`` over bucketed sides with
  MISMATCHED bucket counts, mesh only: the executor's join procedure (the
  planner, the all_to_all shuffle, the co-partitioned arms; the exact
  join on every decline);
* ``interpret`` everything else.

A mesh session (the executor's ``mesh``) classifies a hybrid filter as
``interpret`` (the reference keeps mesh hybrids on its interpreter's
fused arm, K1h once a shard); its ``scan`` and ``agg_scan`` arms route the
executor's mesh procedures and the mesh cache (compile/pipeline.py). Lowering is cheap and never raises: an
internal error lowers to ``interpret``, counted ``compile.lower_error``.
"""

from __future__ import annotations

from typing import List, Optional

from ..plan.ir import Aggregate, Filter, IndexScan, Join, LogicalPlan, Project, Union
from ..telemetry.metrics import metrics
from .pipeline import CompiledPipeline


class Shape:
    """A plan's classified shape: the pipeline kind, and the per-query
    operands ``CompiledPipeline.run`` re-binds from each concrete plan
    (projects, filter condition, leaf nodes)."""

    __slots__ = ("kind", "projects", "condition", "scan", "union", "agg", "inner_projects",
                 "join")

    def __init__(self, kind: str, projects: Optional[List[Project]] = None, condition=None,
                 scan: Optional[IndexScan] = None, union: Optional[Union] = None,
                 agg: Optional[Aggregate] = None,
                 inner_projects: Optional[List[Project]] = None,
                 join: Optional[Join] = None):
        self.kind = kind
        self.projects = projects or []
        self.condition = condition
        self.scan = scan
        self.union = union
        self.agg = agg
        self.inner_projects = inner_projects or []
        self.join = join


def classify_shape(plan: LogicalPlan, mesh=None) -> Shape:
    """Structural classification: pure, no IO, no counters. Two plans with
    equal fingerprints classify alike (the fingerprint folds the mesh's
    size), so re-binding a query can never route it differently from its
    pipeline."""
    projects: List[Project] = []
    node = plan
    while isinstance(node, Project):
        projects.append(node)
        node = node.child
    if isinstance(node, Aggregate):
        inner = node.child
        inner_projects: List[Project] = []
        while isinstance(inner, Project):
            inner_projects.append(inner)
            inner = inner.child
        if isinstance(inner, Join):
            return Shape("join_agg", projects, agg=node)
        if isinstance(inner, Filter) and isinstance(inner.child, IndexScan):
            return Shape("agg_scan", projects, inner.condition, inner.child, agg=node,
                         inner_projects=inner_projects)
        return Shape("interpret")
    if isinstance(node, Filter):
        if isinstance(node.child, IndexScan):
            return Shape("scan", projects, node.condition, node.child)
        if isinstance(node.child, Union) and mesh is None:
            return Shape("hybrid", projects, node.condition, union=node.child)
    if isinstance(node, Join) and mesh is not None:
        # bucketed sides with MISMATCHED bucket counts: the shuffle join.
        # Metadata only; the executor's arm re-checks the keys and the
        # planner's economics per query and declines to the exact join
        from ..exec.executor import bucketed_meta

        lm, rm = bucketed_meta(node.left), bucketed_meta(node.right)
        if lm is not None and rm is not None and lm.entry.num_buckets != rm.entry.num_buckets:
            return Shape("join_shuffle", projects, join=node)
    return Shape("interpret")


def _tier_label(shape: Shape, executor) -> str:
    """Which rung the fused arm would serve on right now (explain only):
    a registry lookup (``hbm_cache.tier_of``, ``mesh_cache.tier_of`` on a
    mesh), never the counting eligibility procedures."""
    from ..exec.hbm_cache import hbm_cache
    from ..exec.mesh_cache import mesh_cache

    if shape.kind == "join_shuffle":
        # the mesh is the classification's gate; the planner may still
        # decline to the host per query
        return "mesh"
    if executor.residency.mode == "off":
        return "host"
    if shape.kind in ("scan", "agg_scan"):
        cols = set(shape.condition.columns())
        if shape.kind == "agg_scan":
            # the device aggregate needs the group and agg columns too
            cols |= set(shape.agg.group_by) | {a.column for a in shape.agg.aggs if a.column}
        files = shape.scan.entry.content.files()
    elif shape.kind == "hybrid":
        from ..plan.rules.hybrid_scan import parse_hybrid_union

        info = parse_hybrid_union(shape.union)
        if info is None:
            return "host"
        cols, files = set(shape.condition.columns()), info.entry.content.files()
    elif shape.kind == "join_agg":
        cache = hbm_cache if executor.mesh is None else mesh_cache
        return "join_region" if cache.snapshot_joins()["regions"] else "host"
    else:
        return "host"
    if executor.mesh is not None:
        return mesh_cache.tier_of(files, sorted(cols), executor.mesh) or "host"
    return hbm_cache.tier_of(files, sorted(cols), executor.device) or "host"


# explain's words for each fused subtree (the reference's, so both
# packages print the same boundary)
_FUSED = {
    "scan": "Filter→IndexScan (one mask+count dispatch)",
    "agg_scan": "Aggregate→Filter→IndexScan (one dispatch: device segment-agg, host hash tail "
                "on decline)",
    "hybrid": "Filter→Union base+delta (one fused dispatch)",
    "join_agg": "Aggregate→Join (resident region dispatch)",
    "join_shuffle": "Join (ICI all-to-all repartition → co-partitioned SMJ; planner may "
                    "decline to host)",
}


def _boundary(plan: LogicalPlan, shape: Shape) -> tuple:
    """The fused subtree's boundary for explain(verbose): which operators
    ride the fused launch and where the host legs begin."""
    if shape.kind == "interpret":
        return ("interpret: " + plan.node_name + " (per-operator)",)
    return (f"fused[{shape.kind}]:", "  device: " + _FUSED[shape.kind],
            "  host legs: candidate-block reads + exact predicates")


def lower(plan: LogicalPlan, executor, fingerprint: Optional[tuple] = None) -> CompiledPipeline:
    """Lower ``plan`` to a CompiledPipeline. Never raises: an internal
    error lowers to the interpreter pipeline (counted)."""
    from .fingerprint import index_roots

    try:
        with metrics.timer("compile.lower"):
            shape = classify_shape(plan, executor.mesh)
            pipeline = CompiledPipeline(kind=shape.kind, fingerprint=fingerprint,
                                        tier=_tier_label(shape, executor),
                                        index_roots=index_roots(plan),
                                        boundary=_boundary(plan, shape))
        metrics.incr("compile.lowered")
        metrics.incr(f"compile.lowered.{shape.kind}")
        return pipeline
    except Exception:  # noqa: BLE001 - lowering must never fail a query
        metrics.incr("compile.lower_error")
        return CompiledPipeline(kind="interpret", fingerprint=fingerprint, tier="host",
                                index_roots=(), boundary=("interpret: lowering error",))
