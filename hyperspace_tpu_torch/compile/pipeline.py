"""CompiledPipeline: one lowered plan subtree, runnable against any
literal binding that shares its structural fingerprint.

Counterpart of ``hyperspace_tpu.compile.pipeline`` (single device and the
mesh's per-query arms). A pipeline stores ROUTING, not values: which fused arm serves the subtree
and how to re-bind each query's operands (predicate literals, projection
order) from the concrete plan a run receives. The fused arms call the
same resolution and host-leg code as the interpreter, which is the
fallback leg of every eligibility miss, so results are the same on either.

A device error in a fused arm degrades as the reference's does: the arm
drops its table or region, counts it (``_DEVICE_FAIL_COUNTERS``) and
answers through the per-file route on the card; a run that moved one of
those counters evicts its own pipeline, so the next query of the
structure lowers against what is resident after the loss.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Optional, Tuple

from ..storage.columnar import ColumnarBatch
from ..telemetry.metrics import metrics
from ..telemetry.trace import span

# the device-failure counters every fused arm's degrade bumps (exec/scan,
# exec/executor, residency/streaming through exec/scan), read from the
# run's scoped registry so a concurrent query's loss never evicts this one
_DEVICE_FAIL_COUNTERS = (
    "scan.resident.device_failed",
    "scan.resident_join.device_failed",
)


class CompiledPipeline:
    """One lowered subtree. ``run(plan, executor)`` executes a concrete
    plan whose fingerprint equals this pipeline's."""

    def __init__(self, kind: str, fingerprint: Optional[tuple], tier: str,
                 index_roots: Tuple[str, ...], boundary: tuple):
        self.kind = kind
        self.fingerprint = fingerprint
        self.tier = tier
        self.index_roots = index_roots
        self.boundary = boundary
        # a short stable id of the fingerprint: the label spans and
        # describe() carry (the tuple itself is unwieldy)
        self.fingerprint_id = (
            hashlib.blake2s(repr(fingerprint).encode("utf-8"), digest_size=4).hexdigest()
            if fingerprint is not None else None
        )
        # tallies mutated by concurrent runs (serve workers share a pipeline)
        self._stats_lock = threading.Lock()
        self.runs = 0
        self.fused_dispatches = 0
        # set by PipelineCache when it caches this pipeline: forget-on-
        # device-loss evicts exactly this entry
        self.cache = None
        self.cache_key = None

    # -- observability -------------------------------------------------------
    def describe(self) -> dict:
        return {
            "kind": self.kind,
            "tier": self.tier,
            "fingerprint": self.fingerprint_id,
            "boundary": list(self.boundary),
            "runs": self.runs,
            "fused_dispatches": self.fused_dispatches,
        }

    def matches_root(self, prefix: str) -> bool:
        return any(p.startswith(prefix) for p in self.index_roots)

    # -- execution -----------------------------------------------------------
    def run(self, plan, executor) -> ColumnarBatch:
        with self._stats_lock:
            self.runs += 1
        metrics.incr(f"compile.run.{self.kind}")
        # a scoped child registry attributes THIS run's launches (global
        # deltas would mix concurrent queries)
        with metrics.scoped() as run_metrics:
            try:
                with span("compile.pipeline_run", kind=self.kind, tier=self.tier,
                          fingerprint=self.fingerprint_id), \
                        metrics.timer("compile.pipeline_run"):
                    return self._run_kind(plan, executor)
            finally:
                with self._stats_lock:
                    self.fused_dispatches += run_metrics.get("compile.fused.dispatches")
                if any(run_metrics.get(c) for c in _DEVICE_FAIL_COUNTERS):
                    metrics.incr("compile.pipeline.dropped_on_device_loss")
                    if self.cache is not None:
                        self.cache.forget(self)

    def _run_kind(self, plan, executor) -> ColumnarBatch:
        from .lowering import classify_shape

        if self.kind == "interpret":
            return executor._exec(plan, predicate=None)
        shape = classify_shape(plan, executor.mesh)
        if shape.kind != self.kind:
            # cannot happen for equal fingerprints; guards a future change
            # of the structural walk: interpret exactly
            metrics.incr("compile.shape_drift")
            return executor._exec(plan, predicate=None)
        run = {"scan": self._run_scan, "agg_scan": self._run_agg_scan,
               "hybrid": self._run_hybrid, "join_agg": self._run_join_agg,
               "join_shuffle": self._run_join_shuffle}[self.kind]
        return _apply_projects(run(shape, executor), shape.projects)

    def _run_scan(self, shape, executor) -> ColumnarBatch:
        """The scan arm: ``index_scan`` with ``structure_keyed`` (the count
        goes through ``block_counts_batch`` as a single, counted under
        ``compile.fused.*``): the interpreter's procedure otherwise. A mesh
        session takes the interpreter's distributed scan (the mesh's
        resident tables, which the reference looks up first, are not
        ported yet)."""
        from ..exec.scan import index_scan

        if executor.mesh is not None:
            return executor._exec_index_scan_distributed(shape.scan, shape.condition)
        entry = shape.scan.entry
        return index_scan(
            entry.content.files(),
            list(shape.scan.required_columns),
            shape.condition,
            device=executor.device,
            indexed_columns=entry.indexed_columns,
            dtypes=entry.schema,
            num_buckets=entry.num_buckets,
            residency=executor.residency,
            structure_keyed=True,
        )

    def _run_agg_scan(self, shape, executor) -> ColumnarBatch:
        """The agg_scan arm: the group-by on the card first (one K1 mask
        launch and the segment epilogue, the finished group table home);
        a decline runs the scan arm and the host hash aggregate, counted
        ``compile.agg.declined.<reason>``."""
        from ..exec.aggregate import hash_aggregate

        fused = self._try_device_agg(shape, executor)
        if fused is not None:
            return fused
        if executor.mesh is not None:
            # the interpreter's whole Aggregate procedure: a decline must
            # not demote the mesh's two-phase aggregate to gather-then-hash
            return executor._exec_aggregate(shape.agg, None)
        out = _apply_projects(self._run_scan(shape, executor), shape.inner_projects)
        return hash_aggregate(out, list(shape.agg.group_by), list(shape.agg.aggs))

    def _try_device_agg(self, shape, executor) -> Optional[ColumnarBatch]:
        """The device aggregate, or None with its decline counted. A
        ``no_table`` miss schedules the population of the predicate AND
        group/agg columns, so a later query of this structure aggregates
        on the card. No selectivity gate: the host reads nothing here."""
        from ..exec.hbm_cache import hbm_cache

        group_by = list(shape.agg.group_by)
        aggs = list(shape.agg.aggs)

        def decline(reason: str):
            metrics.incr(f"compile.agg.declined.{reason}")
            return None

        if not group_by:
            # the global aggregate's empty-input row belongs to the host tail
            return decline("shape")
        need = list(dict.fromkeys(group_by + [a.column for a in aggs if a.column]))
        # an inner projection that starves the aggregate must raise on the
        # host path, not aggregate on the card
        for p in shape.inner_projects:
            if not set(need) <= set(p.columns):
                return decline("shape")
        entry = shape.scan.entry
        if any(c not in entry.schema for c in need):
            return decline("column")
        all_files = entry.content.files()
        if not all_files or executor.mesh is not None:
            # (a mesh has no resident tables yet: never a table to serve)
            return decline("no_table")
        want = sorted(set(shape.condition.columns()) | set(need))
        table = hbm_cache.resident_for(all_files, want, executor.device, executor.residency)
        if table is None:
            if hbm_cache.auto_enabled(executor.residency, executor.device):
                hbm_cache.note_touch(all_files, want, executor.device, executor.residency)
            return decline("no_table")
        try:
            out, reason = hbm_cache.agg_scan(table, shape.condition, group_by, aggs)
        except RuntimeError:
            # device loss: drop the table, and the scan plus the host
            # aggregate tail answer this query (the per-file route)
            hbm_cache.drop(table)
            metrics.incr("scan.resident.device_failed")
            return decline("device")
        if out is None:
            return decline(reason)
        metrics.incr("compile.fused.dispatches")
        metrics.incr("compile.agg.device")
        return out

    def _run_hybrid(self, shape, executor) -> ColumnarBatch:
        """The hybrid arm: the delta-resident union with its count as a
        single through ``hybrid_block_counts_batch`` (K1h, counted under
        ``compile.fused.*``), else the per-side host union; the split entry
        points keep the fallback from resolving residency twice."""
        fused = executor._try_resident_hybrid(shape.union, shape.condition,
                                              structure_keyed=True)
        if fused is not None:
            return fused
        columns = list(shape.projects[-1].columns) if shape.projects else None
        return executor._exec_union_host(shape.union, shape.condition, columns)

    def _run_join_agg(self, shape, executor) -> ColumnarBatch:
        """The aggregate-join arm: the executor's Aggregate procedure
        (resident region launch first, then the host range fusion). Whether
        THIS run launched on the region is read from a scoped registry."""
        with metrics.scoped() as jm:
            out = executor._exec_aggregate(shape.agg, None)
        if jm.get("scan.path.resident_join_agg") > 0:
            metrics.incr("compile.fused.dispatches")
        return out

    def _run_join_shuffle(self, shape, executor) -> ColumnarBatch:
        """The shuffle-join arm: the executor's whole join procedure (the
        planner, the exchange, the exact join on every decline). Whether
        THIS run rode the exchange is read from a scoped registry."""
        with metrics.scoped() as jm:
            out = executor._exec_join(shape.join)
        if jm.get("scan.path.resident_join_shuffle") > 0:
            metrics.incr("compile.fused.dispatches")
        return out


def _apply_projects(batch: ColumnarBatch, projects) -> ColumnarBatch:
    """Apply a Project stack innermost first (``projects`` is outermost
    first, as classify_shape collects it)."""
    for p in reversed(projects):
        batch = batch.select(list(p.columns))
    return batch
