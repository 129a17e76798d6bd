"""The plan executor: interprets a logical plan into columnar execution.

Counterpart of the single-device arms of ``hyperspace_tpu.exec.executor``
for Scan, IndexScan, Filter, Project, Join and Hybrid Scan's Union,
BucketUnion and Repartition:

* ``Filter(IndexScan)`` fuses into one index_scan call — bucket pruning +
  zone maps + the device mask (exec.scan.index_scan), or the resident
  scan when the session's residency policy has the index on the device;
* ``Join(IndexScan, IndexScan)`` with matching bucket specs executes as
  the shuffle-free bucketed sort-merge join (exec.joins.bucketed_join_pairs);
* a Scan of a hive-partitioned source prunes its files on the predicate's
  partition-column conjuncts before reading any (``scan.partition_pruned``);
* a hybrid ``Union(index side, appended side)`` whose base and appended
  delta are resident counts both in one K1h launch
  (``scan.path.resident_hybrid``, delta residency: exec/delta.py);
  otherwise it runs its two sides at once on two threads
  (``union.side.index`` / ``union.side.source``); a
  join side ``BucketUnion(index side, Repartition(appended side))`` hashes
  the appended rows into the index's buckets on the host and merges them
  into the bucket groups the bucketed join reads;
* ``Aggregate([Project](Join))`` over two bucketed index sides fuses the
  join's match ranges into the aggregate (exec.aggregate.
  aggregate_join_ranges: no pair arrays, no joined batch); every other
  Aggregate runs its child, then exec.aggregate.hash_aggregate;
* everything else evaluates bottom-up over ColumnarBatches.

The compiled-pipeline, join residency and mesh arms are not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import ResidencyConf
from ..exceptions import HyperspaceException
from ..ops import DeviceLike
from ..plan.expr import Expr, eval_mask
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
from ..plan.rules.join_rule import align_condition_sides, extract_equi_condition
from ..storage import layout, parquet_io
from ..storage.columnar import ColumnarBatch
from ..telemetry.metrics import metrics
from .joins import bucketed_join_pairs, bucketed_join_ranges, inner_join
from .scan import empty_batch_for, index_scan


def bucketed_meta(plan: LogicalPlan) -> Optional[IndexScan]:
    """The bucketed IndexScan a join side would load — metadata only, no
    I/O. None when the shape isn't bucket-aligned."""
    node = plan
    while isinstance(node, (Project, Filter)):
        node = node.children[0]
    if isinstance(node, IndexScan) and node.use_bucket_spec:
        return node
    if isinstance(node, BucketUnion):
        for c in node.children:
            idx = bucketed_meta(c)
            if idx is not None:
                return idx
    return None


def _co_bucketed(left: LogicalPlan, right: LogicalPlan, l_keys, r_keys) -> bool:
    """Whether both join sides are bucket-spec index scans with the same
    numBuckets, keyed exactly on their indexed (bucketing) columns — so
    equal keys share a bucket id on both sides (the hash is value-stable,
    ops.hashing). Metadata only, no I/O."""
    l_meta, r_meta = bucketed_meta(left), bucketed_meta(right)
    if l_meta is None or r_meta is None:
        return False
    if l_meta.entry.num_buckets != r_meta.entry.num_buckets:
        return False
    return {c.lower() for c in l_meta.entry.indexed_columns} == {
        k.lower() for k in l_keys
    } and {c.lower() for c in r_meta.entry.indexed_columns} == {
        k.lower() for k in r_keys
    }


def _has_index_scan(plan: LogicalPlan) -> bool:
    """Whether an IndexScan sits anywhere under ``plan`` — distinguishes
    the hybrid union's index side from its appended-source side."""
    if isinstance(plan, IndexScan):
        return True
    return any(_has_index_scan(c) for c in plan.children)


class Executor:
    def __init__(
        self, device: DeviceLike = None, residency: ResidencyConf = ResidencyConf()
    ):
        self.device = device
        self.residency = residency

    def execute(self, plan: LogicalPlan) -> ColumnarBatch:
        return self._exec(plan, predicate=None)

    # -- dispatch ------------------------------------------------------------
    def _exec(
        self,
        plan: LogicalPlan,
        predicate: Optional[Expr],
        columns: Optional[List[str]] = None,
    ) -> ColumnarBatch:
        """``columns``: projection pushed down from an enclosing Project —
        leaf scans read only these (plus predicate columns)."""
        if isinstance(plan, Filter):
            # push the predicate into the child scan; row-wise predicates
            # also distribute over unions, and Project is transparent to
            # pushdown (pure column selection): the Hybrid Scan delete
            # shape Filter(Project(Filter(NOT-IN, IndexScan))) must still
            # deliver the user predicate to the scan for bucket/zone pruning
            child = plan.child
            if isinstance(child, (IndexScan, Scan, Union, BucketUnion, Project)):
                return self._exec(
                    child,
                    predicate=self._conjoin(predicate, plan.condition),
                    columns=columns,
                )
            need = None
            if columns is not None:
                need = list(
                    dict.fromkeys(columns + sorted(plan.condition.columns()))
                )
            batch = self._exec(child, None, need)
            return self._apply_predicate(batch, self._conjoin(predicate, plan.condition))
        if isinstance(plan, Project):
            batch = self._exec(plan.child, predicate, list(plan.columns))
            return batch.select(list(plan.columns))
        if isinstance(plan, Scan):
            if not plan.relation.files:
                # zero-file scan (e.g. every file sketch-pruned): empty
                # result with the relation's schema
                return ColumnarBatch.empty(dict(plan.relation.schema))
            need = None
            if columns is not None:
                need = list(dict.fromkeys(columns))
                if predicate is not None:
                    need = list(
                        dict.fromkeys(need + sorted(predicate.columns()))
                    )
                avail = set(plan.relation.schema)
                need = [c for c in need if c in avail]
            files = plan.relation.files
            spec = plan.relation.partition_spec
            pred_for_reader = predicate
            if spec is not None and predicate is not None:
                # split once: conjuncts over partition columns only are
                # decidable from directory names (→ file pruning, before
                # any byte is read — the win Spark's PartitioningAwareFile-
                # Index provides the reference for free); conjuncts free of
                # partition columns can still reach the file reader; mixed
                # conjuncts do neither (the full predicate is re-applied
                # after the read regardless)
                from ..plan.rules.predicate_pushdown import (
                    conjoin,
                    split_conjuncts,
                )
                from ..storage import partitions as P
                from ..telemetry.metrics import metrics

                part_names = set(spec.names)
                part_conjs, file_conjs = [], []
                for c in split_conjuncts(predicate):
                    refs = set(c.columns())
                    if refs and refs <= part_names:
                        part_conjs.append(c)
                    elif not (refs & part_names):
                        file_conjs.append(c)
                pred_for_reader = conjoin(file_conjs) if file_conjs else None
                if part_conjs:
                    before = len(files)
                    files = P.prune_files(files, spec, conjoin(part_conjs))
                    metrics.incr("scan.partition_pruned", before - len(files))
                    if not files:
                        out = ColumnarBatch.empty(dict(plan.relation.schema))
                        return out.select(need) if need is not None else out
            arrow_filter = None
            if pred_for_reader is not None and plan.relation.read_format == "parquet":
                from ..plan.expr import to_arrow_filter

                arrow_filter = to_arrow_filter(pred_for_reader)
            batch = parquet_io.read_relation(
                plan.relation,
                paths=[f.name for f in files],
                columns=need,
                arrow_filter=arrow_filter,
            )
            # the full predicate is ALWAYS re-applied: the pushed filter is
            # best-effort (partial conjunctions, reader fallback)
            return self._apply_predicate(batch, predicate)
        if isinstance(plan, IndexScan):
            entry = plan.entry
            return index_scan(
                entry.content.files(),
                list(plan.required_columns),
                predicate,
                device=self.device,
                indexed_columns=entry.indexed_columns,
                dtypes=entry.schema,
                num_buckets=entry.num_buckets,
                residency=self.residency,
            )
        if isinstance(plan, Join):
            batch = self._exec_join(plan)
            return self._apply_predicate(batch, predicate)
        if isinstance(plan, Aggregate):
            return self._exec_aggregate(plan, predicate)
        if isinstance(plan, Union):
            return self._exec_union(plan, predicate, columns)
        if isinstance(plan, Repartition):
            # outside a bucketed join a repartition is a plain row pass
            return self._exec(plan.child, predicate, columns)
        if isinstance(plan, BucketUnion):
            parts = [self._exec(c, predicate, columns) for c in plan.children]
            return ColumnarBatch.concat(parts)
        raise HyperspaceException(
            f"Cannot execute node {plan.node_name} (not yet ported to "
            "hyperspace_tpu_torch)."
        )

    def _exec_aggregate(
        self, plan: Aggregate, predicate: Optional[Expr]
    ) -> ColumnarBatch:
        """The fused aggregate-over-join arm first, then the child
        gathered + hash_aggregate. A predicate above the aggregate (the
        HAVING shape) applies to the aggregated rows, never the child's.
        (The reference tries its mesh two-phase aggregate,
        ``_try_distributed_aggregate``, before the fused arm; it lands
        with multi-device.)"""
        from .aggregate import hash_aggregate

        fused = self._try_join_aggregate(plan)
        if fused is not None:
            return self._apply_predicate(fused, predicate)
        child = self._exec(plan.child, None, plan.input_columns())
        result = hash_aggregate(child, list(plan.group_by), list(plan.aggs))
        return self._apply_predicate(result, predicate)

    def _exec_union(
        self,
        plan: Union,
        predicate: Optional[Expr],
        columns: Optional[List[str]],
    ) -> ColumnarBatch:
        """The Hybrid Scan merge Union(index side, appended side). When the
        base and the appended delta are resident, one K1h launch serves it
        (``_try_resident_hybrid``). Otherwise the sides run at once, the
        appended side's host read and filter overlapping the index side's
        read and mask, each timed under ``union.side.index`` /
        ``union.side.source``. A single-child union skips the thread."""
        if predicate is not None:
            fused = self._try_resident_hybrid(plan, predicate)
            if fused is not None:
                return fused
        import contextvars
        import time
        from concurrent.futures import ThreadPoolExecutor

        def run_child(c):
            t0 = time.perf_counter()
            out = self._exec(c, predicate, columns)
            side = "index" if _has_index_scan(c) else "source"
            metrics.record_time(f"union.side.{side}", time.perf_counter() - t0)
            return out

        children = list(plan.children)
        if len(children) < 2:
            parts = [run_child(c) for c in children]
        else:
            # each side runs in a copy of the query thread's context
            ctxs = [contextvars.copy_context() for _ in children]
            with ThreadPoolExecutor(
                max_workers=len(children), thread_name_prefix="union-side"
            ) as pool:
                parts = list(
                    pool.map(
                        lambda pair: pair[0].run(run_child, pair[1]),
                        zip(ctxs, children),
                    )
                )
        return ColumnarBatch.concat(parts)

    def _try_resident_hybrid(self, plan: Union, predicate: Expr) -> Optional[ColumnarBatch]:
        """The delta-resident hybrid path: when ``plan`` is a hybrid union
        whose base table and appended delta are resident, one K1h launch
        counts base and delta (deleted base rows masked out on the
        device), then the exact host legs run: base blocks from the index
        files with the lineage NOT IN re-applied, delta blocks from the
        decoded appended rows. None routes the host union, which, with a
        resident base and no delta yet, schedules the delta's background
        population so the next query lands here. Rows equal the host
        union's: the host re-evaluates every candidate block exactly."""
        from ..plan.rules.hybrid_scan import parse_hybrid_union
        from .delta import resolve_hybrid_residency
        from .hbm_cache import hbm_cache
        from .scan import _resident_parts

        info = parse_hybrid_union(plan)
        if info is None:
            return None
        res = resolve_hybrid_residency(info, predicate, self.device, self.residency)
        if res.status == "gated":
            # its own name: the host union's index side counts
            # scan.gate.resident_selectivity for its own gate
            metrics.incr("scan.gate.resident_hybrid_selectivity")
            return None
        if res.status == "no_delta":
            if hbm_cache.auto_enabled(self.residency, self.device):
                hbm_cache.note_touch_delta(res.table, info.appended, info.relation,
                                           list(info.user_cols), info.deleted_ids,
                                           self.residency)
            return None
        if res.status != "ok":
            return None  # the union's index side schedules note_touch
        out_cols = list(info.user_cols)
        counts = hbm_cache.hybrid_block_counts(res.table, res.delta, predicate)
        if counts is None:
            return None
        base_counts, delta_counts = counts
        parts = _resident_parts(res.table, res.files, out_cols, res.host_predicate,
                                base_counts, path_metric=None)
        parts += hbm_cache.delta_parts(res.delta, predicate, out_cols, delta_counts)
        metrics.incr("scan.path.resident_hybrid")
        if parts:
            return ColumnarBatch.concat(parts)
        empty = empty_batch_for(out_cols, info.entry.schema)
        if empty is not None:
            return empty
        return layout.read_batch(res.files[0], columns=out_cols).take(
            np.array([], dtype=np.int64))

    @staticmethod
    def _conjoin(a: Optional[Expr], b: Expr) -> Expr:
        return b if a is None else (a & b)

    @staticmethod
    def _apply_predicate(
        batch: ColumnarBatch, predicate: Optional[Expr]
    ) -> ColumnarBatch:
        if predicate is None or batch.num_rows == 0:
            return batch
        return batch.take(np.flatnonzero(eval_mask(predicate, batch)))

    # -- joins ---------------------------------------------------------------
    def _exec_join(self, join: Join) -> ColumnarBatch:
        pairs = extract_equi_condition(join.condition)
        if pairs is None:
            raise HyperspaceException("Only equi-joins are executable.")
        oriented = align_condition_sides(
            pairs, join.left.output_columns(), join.right.output_columns()
        )
        if oriented is None:
            raise HyperspaceException("Join condition references unknown columns.")
        l_keys = [l for l, _ in oriented]
        r_keys = [r for _, r in oriented]
        bucketed = self._try_bucketed_join(join, l_keys, r_keys)
        if bucketed is not None:
            return bucketed
        left = self._exec(join.left, None)
        right = self._exec(join.right, None)
        return inner_join(left, right, l_keys, r_keys, self.device)

    def _load_index_by_bucket(
        self, node: IndexScan, predicate: Optional[Expr]
    ) -> Dict[int, ColumnarBatch]:
        """Read a bucketed index side grouped by bucket (parts in log order
        within a bucket); the side's predicate applies per bucket after
        grouping."""
        groups = self._read_groups_by_bucket(
            node.entry.content.files(), list(node.required_columns)
        )
        out: Dict[int, ColumnarBatch] = {}
        for b, v in groups.items():
            v = self._apply_predicate(v, predicate)
            if v.num_rows:
                out[b] = v
        return out

    @staticmethod
    def _read_groups_by_bucket(files, columns) -> Dict[int, ColumnarBatch]:
        """Read a bucketed side grouped by bucket: per-bucket files whole,
        multi-bucket RUN files as per-bucket segments through the coalesced
        segment planner (one ordered sweep per run file). Part order within
        a bucket keeps ``files`` order, so merge tie order is unchanged. A
        bucket whose rows span several runs arrives as piecewise-sorted
        segments; the join re-sorts it, as it does the multi-file buckets
        an incremental refresh leaves."""
        run_files = [f for f in files if layout.is_run_file(f)]
        plain = [f for f in files if not layout.is_run_file(f)]
        bmap = dict(zip(plain, layout.read_batches(plain, columns=columns)))
        seg_map: Dict = {}
        sweep_segments: Dict[str, List] = {}
        if run_files:
            plan = layout.plan_segment_reads(run_files)
            seg_map = layout.execute_segment_reads(plan, columns=columns)
            for sw in plan:
                sweep_segments[sw.path] = sw.segments
        groups: Dict[int, List[ColumnarBatch]] = {}
        for f in files:
            if layout.is_run_file(f):
                for b, _lo, _hi in sweep_segments.get(str(f), ()):
                    part = seg_map[(str(f), b)]
                    if part.num_rows:
                        groups.setdefault(b, []).append(part)
                continue
            batch = bmap[f]
            if batch is None or batch.num_rows == 0:
                continue
            groups.setdefault(layout.bucket_of_file(f), []).append(batch)
        return {
            b: parts[0] if len(parts) == 1 else ColumnarBatch.concat(parts)
            for b, parts in groups.items()
        }

    def _repartition_by_bucket(
        self, node: Repartition, predicate: Optional[Expr]
    ) -> Dict[int, ColumnarBatch]:
        """Execute the child and hash its rows into the index's buckets —
        the on-the-fly shuffle of the (small) appended side under Hybrid
        Scan (RuleUtils.scala:519-578), with the hash the build used, so
        each row lands in the bucket its key has in the index."""
        from ..ops.hashing import bucket_ids_host, key_repr

        batch = self._exec(node.child, predicate)
        if batch.num_rows == 0:
            return {}
        metrics.incr("union.repartition.rows", batch.num_rows)
        buckets = bucket_ids_host(
            [key_repr(batch.columns[c]) for c in node.columns], node.num_buckets
        )
        out: Dict[int, ColumnarBatch] = {}
        for b in np.unique(buckets):
            out[int(b)] = batch.take(np.flatnonzero(buckets == b))
        return out

    def _bucketed_source(
        self, plan: LogicalPlan, predicate: Optional[Expr]
    ) -> Optional[Tuple[Dict[int, ColumnarBatch], Optional[IndexScan]]]:
        """Recognize the bucket-aligned shapes and load data grouped by
        bucket: [Filter?][Project?]IndexScan(bucketed), Repartition(plan)
        (no IndexScan: the second item is None), or BucketUnion of such
        (the Hybrid Scan merge)."""
        node = plan
        if isinstance(node, Filter):
            predicate = self._conjoin(predicate, node.condition)
            node = node.child
        if isinstance(node, IndexScan) and node.use_bucket_spec:
            return self._load_index_by_bucket(node, predicate), node
        if isinstance(node, Project):
            inner = self._bucketed_source(node.child, predicate)
            if inner is None:
                return None
            by_bucket, idx = inner
            return {b: v.select(list(node.columns)) for b, v in by_bucket.items()}, idx
        if isinstance(node, Repartition):
            return self._repartition_by_bucket(node, predicate), None
        if isinstance(node, BucketUnion):
            merged: Dict[int, ColumnarBatch] = {}
            idx: Optional[IndexScan] = None
            for c in node.children:
                part = self._bucketed_source(c, predicate)
                if part is None:
                    return None
                child_buckets, child_idx = part
                idx = idx or child_idx
                for b, v in child_buckets.items():
                    if b in merged:
                        merged[b] = ColumnarBatch.concat([merged[b], v])
                    else:
                        merged[b] = v
            if idx is None:
                return None
            return merged, idx
        return None

    def _try_bucketed_join(
        self, join: Join, l_keys: List[str], r_keys: List[str]
    ) -> Optional[ColumnarBatch]:
        """The shuffle-free bucketed SMJ over two co-bucketed sides; None
        otherwise (the exact unbucketed join serves)."""
        if not _co_bucketed(join.left, join.right, l_keys, r_keys):
            return None
        left = self._side_by_bucket(join.left)
        right = self._side_by_bucket(join.right)
        if left is None or right is None:
            return None
        l_by_bucket, l_node = left
        r_by_bucket, r_node = right
        # merge in the index's key order so both sides hash and compare the
        # same tuple order
        l2r = {l.lower(): r for l, r in zip(l_keys, r_keys)}
        l_keys = list(l_node.entry.indexed_columns)
        r_keys = [l2r[k.lower()] for k in l_keys]
        parts = bucketed_join_pairs(
            l_by_bucket, r_by_bucket, l_keys, r_keys, self.device
        )
        if not parts:
            return inner_join(
                self._empty_side(join.left, l_by_bucket, l_node),
                self._empty_side(join.right, r_by_bucket, r_node),
                l_keys,
                r_keys,
                self.device,
            )
        return ColumnarBatch.concat(parts)

    def _try_join_aggregate(self, plan: Aggregate) -> Optional[ColumnarBatch]:
        """Fuse Aggregate([Project](Join)) over the bucketed SMJ: the
        join's match ranges (lo, counts) feed aggregate_join_ranges' range
        arithmetic, so the expanded pair arrays and the joined batch are
        never built. Falls back (None) whenever the shapes, key columns or
        aggregate functions don't qualify; results are those of
        materialize + hash_aggregate."""
        from .aggregate import aggregate_join_ranges
        from .join_residency import orient_join_aggregate

        oriented = orient_join_aggregate(plan)
        if oriented is None:
            return None
        left_plan, right_plan, lk, rk, group_by, aggs = oriented
        if not _co_bucketed(left_plan, right_plan, lk, rk):
            return None
        # (the reference tries its device-resident fused aggregate-join,
        # ``_try_resident_join_agg``, here; it lands with join residency)
        # decidable before any bucket I/O: an ineligible shape would load
        # both sides, decline, then load everything again on the fallback
        if any(a.fn not in ("count", "sum", "avg") for a in aggs):
            return None
        left = self._side_by_bucket(left_plan)
        right = self._side_by_bucket(right_plan)
        if left is None or right is None:
            return None
        l_by_bucket, l_node = left
        r_by_bucket, _r_node = right
        # merge in the left index's key order, as _try_bucketed_join does
        k2k = {a.lower(): b for a, b in zip(lk, rk)}
        lk = list(l_node.entry.indexed_columns)
        rk = [k2k[k.lower()] for k in lk]
        ranges = bucketed_join_ranges(l_by_bucket, r_by_bucket, lk, rk, self.device)
        if ranges is None:
            return None
        l_all, r_all, lo, counts, r_order = ranges
        return aggregate_join_ranges(l_all, r_all, group_by, aggs, lo, counts, r_order)

    def _side_by_bucket(self, plan: LogicalPlan):
        """[Project?] over a bucketed source (index scan / hybrid union),
        the Project applied: the reference's ``_scan_side_by_bucket``
        followed by ``_project_groups``, in one helper."""
        project: Optional[Project] = None
        node = plan
        if isinstance(node, Project):
            project, node = node, node.child
        inner = self._bucketed_source(node, None)
        if inner is None or inner[1] is None:
            return None
        by_bucket, idx_node = inner
        if project is not None:
            by_bucket = {b: v.select(list(project.columns)) for b, v in by_bucket.items()}
        return by_bucket, idx_node

    @staticmethod
    def _empty_side(
        side_plan: LogicalPlan,
        by_bucket: Dict[int, ColumnarBatch],
        idx_node: IndexScan,
    ) -> ColumnarBatch:
        """A 0-row batch with a join side's output schema."""
        if by_bucket:
            any_batch = next(iter(by_bucket.values()))
            return any_batch.take(np.array([], dtype=np.int64))
        empty = empty_batch_for(side_plan.output_columns(), idx_node.entry.schema)
        if empty is None:
            raise HyperspaceException(
                f"Join side outputs {side_plan.output_columns()} not covered "
                f"by index {idx_node.entry.name}'s schema."
            )
        return empty
