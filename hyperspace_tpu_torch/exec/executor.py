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

Join residency (exec/join_residency.py): a bucketed join or aggregate
over two pristine index sides whose join region is resident on the card
is served there — the aggregate in one K2/K2p launch and a torch epilogue
(``scan.path.resident_join_agg``), the materializing join by K2/K2p's
match ranges and a host gather from the cached groups
(``scan.path.resident_join``); a miss schedules the region's background
build. A device error (a ``RuntimeError``) in these arms, the resident
hybrid arm's included, drops the region or table and the query answers
through the bucketed join on K2 (``scan.resident_join.device_failed``,
``scan.resident.device_failed``), as the reference answers on its host.

A join side's bucket groups are cached across queries (the groups cache
below): keyed by file identities and projection, carrying a cache token
that the join layer's setup and ranges caches key on; a filtered side
derives its token from the predicate's ``repr``, a hybrid merge carries
none (``join.cache.optout.*``).

``execute`` runs a plan through the whole-plan compiler (``compile/``)
unless conf ``hyperspace.compile.mode`` is ``off``: the plan's structural
fingerprint finds a compiled pipeline in the process cache (lowered on a
miss), and the pipeline runs with this interpreter as its fallback leg.

Over a mesh of more than one shard (``mesh``, the session's), with at
least ``dist_min_rows`` rows (conf ``hyperspace.tpu.distributedQuery.
minRows``): a filtered index scan masks each shard's buckets on its device
(``scan.path.distributed``), an Aggregate over one aggregates in two
phases (``aggregate.path.distributed``), and a co-partitioned join joins
each shard's buckets there (``join.path.distributed``); two bucketed sides
with different numBuckets join after the smaller moves into the other's
bucket space in one all_to_all round (``scan.path.resident_join_shuffle``,
the planner's decision recorded for explain). Every bucketed join records
its movement decision. The mesh's resident arms are not ported yet: a
mesh executor ships each query's rows, whatever the residency mode.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import HyperspaceConf, ResidencyConf
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


def _keys_are_indexed(l_meta: IndexScan, r_meta: IndexScan, l_keys, r_keys) -> bool:
    """Whether the join keys are exactly each side's indexed (bucketing)
    columns, as sets."""
    return {c.lower() for c in l_meta.entry.indexed_columns} == {
        k.lower() for k in l_keys
    } and {c.lower() for c in r_meta.entry.indexed_columns} == {
        k.lower() for k in r_keys
    }


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
    return _keys_are_indexed(l_meta, r_meta, l_keys, r_keys)


def _has_index_scan(plan: LogicalPlan) -> bool:
    """Whether an IndexScan sits anywhere under ``plan`` — distinguishes
    the hybrid union's index side from its appended-source side."""
    if isinstance(plan, IndexScan):
        return True
    return any(_has_index_scan(c) for c in plan.children)


class Executor:
    def __init__(
        self,
        device: DeviceLike = None,
        residency: ResidencyConf = ResidencyConf(),
        conf: Optional[HyperspaceConf] = None,
        mesh=None,
        dist_min_rows: Optional[int] = None,
    ):
        self.device = device
        self.residency = residency
        self.conf = conf if conf is not None else HyperspaceConf()
        # a mesh of more than one shard routes bucketed filters, aggregates
        # and joins through the per-shard programs (exec/distributed.py);
        # below dist_min_rows total rows a query stays on the host (the
        # fixed per-shard dispatch and transfer cannot win on small data)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.dist_min_rows = (
            dist_min_rows if dist_min_rows is not None else self.conf.distributed_min_rows()
        )
        # the CompiledPipeline the last execute() ran (None when the
        # interpreter served directly): explain(verbose) attribution
        self.last_pipeline = None

    def execute(
        self, plan: LogicalPlan, version_token: Optional[tuple] = None
    ) -> ColumnarBatch:
        """Execute ``plan``, through the whole-plan compiler unless the
        conf turns it off. ``version_token`` is the serve tier's pinned
        index-log snapshot, folded into the pipeline cache's key (None
        outside serving: the fingerprint already pins every leaf)."""
        if self.conf.compile_mode() != "off":
            from ..compile.cache import pipeline_cache

            pipeline = pipeline_cache.get_or_lower(plan, self, version_token)
            if pipeline is not None:
                self.last_pipeline = pipeline
                return pipeline.run(plan, self)
        from ..telemetry.trace import span

        with span("query.interpret"):
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
            if self.mesh is not None and predicate is not None:
                return self._exec_index_scan_distributed(plan, predicate)
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
        """The fused arms first (the mesh's two-phase aggregate, then the
        aggregate over a join), then the child gathered + hash_aggregate. A
        predicate above the aggregate (the HAVING shape) applies to the
        aggregated rows, never the child's. One entry point for the
        interpreter and the compiled pipelines, so the arms' order is one."""
        from .aggregate import hash_aggregate

        if self.mesh is not None:
            fused = self._try_distributed_aggregate(plan)
            if fused is not None:
                return self._apply_predicate(fused, predicate)
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
        return self._exec_union_host(plan, predicate, columns)

    def _exec_union_host(
        self,
        plan: Union,
        predicate: Optional[Expr],
        columns: Optional[List[str]],
    ) -> ColumnarBatch:
        """The union's two sides at once (``_exec_union``'s host arm): split
        out so that the compiled hybrid pipeline's fallback never resolves
        residency a second time."""
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

    def _try_resident_hybrid(
        self, plan: Union, predicate: Expr, structure_keyed: bool = False
    ) -> Optional[ColumnarBatch]:
        """The delta-resident hybrid path: when ``plan`` is a hybrid union
        whose base table and appended delta are resident, one K1h launch
        counts base and delta (deleted base rows masked out on the
        device), then the exact host legs run: base blocks from the index
        files with the lineage NOT IN re-applied, delta blocks from the
        decoded appended rows. None routes the host union, which, with a
        resident base and no delta yet, schedules the delta's background
        population so the next query lands here. Rows equal the host
        union's: the host re-evaluates every candidate block exactly.
        ``structure_keyed`` (the compiled hybrid pipeline): the count goes
        through ``hybrid_block_counts_batch`` as a single, the same K1h
        launch, counted under ``compile.fused.*``."""
        from ..plan.rules.hybrid_scan import parse_hybrid_union
        from .delta import resolve_hybrid_residency
        from .hbm_cache import hbm_cache
        from .scan import _resident_parts

        if self.mesh is not None:
            return None  # the mesh's resident deltas are not ported yet
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
        try:
            if structure_keyed:
                pairs = hbm_cache.hybrid_block_counts_batch(res.table, res.delta, [predicate],
                                                            metric_ns="compile.fused")
                counts = None if pairs is None else pairs[0]
            else:
                counts = hbm_cache.hybrid_block_counts(res.table, res.delta, predicate)
        except RuntimeError:
            # device loss: drop the base (its deltas go with it) and let
            # the host union answer, its index side on the per-file route
            hbm_cache.drop(res.table)
            metrics.incr("scan.resident.device_failed")
            return None
        if counts is None:
            return None
        base_counts, delta_counts = counts
        parts = _resident_parts(res.table, res.files, out_cols, res.host_predicate,
                                base_counts, path_metric=None)
        parts += hbm_cache.delta_parts(res.delta, predicate, out_cols, delta_counts)
        metrics.incr("scan.path.resident_hybrid")
        from .scan_gate import scan_gate

        scan_gate.note_resident_bypass("hybrid")
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
        grouping. The PRE-predicate groups are cached across queries by
        file identity and projection (index files are immutable): a repeat
        join skips the read, the concat and the dictionary unification.
        The predicate builds fresh batches, so cached groups never change;
        a filtered side carries a DERIVED token ``(token, ("pred",
        repr(predicate)))`` so its joins hit the setup and ranges caches
        too."""
        files = node.entry.content.files()
        columns = list(node.required_columns)
        cache_key = _groups_key(files, columns)
        groups = _cached_bucket_groups(cache_key)
        if groups is None:
            groups = self._read_groups_by_bucket(files, columns)
            groups = _store_bucket_groups(cache_key, groups) or groups
        if predicate is None:
            return groups
        out: Dict[int, ColumnarBatch] = {}
        for b, v in groups.items():
            v = self._apply_predicate(v, predicate)
            if v.num_rows:
                out[b] = v
        tok = getattr(groups, "cache_token", None)
        if tok is None:
            # never cached (budget 0, an unstat-able file): the filtered
            # side cannot derive a token and opts out of the join caches
            metrics.incr("join.cache.optout.filtered")
            return out
        tagged = BucketGroups(out)
        tagged.cache_token = (tok, ("pred", repr(predicate)))
        return tagged

    @staticmethod
    def _read_groups_by_bucket(files, columns, buckets=None) -> Dict[int, ColumnarBatch]:
        """Read a bucketed side grouped by bucket: per-bucket files whole,
        multi-bucket RUN files as per-bucket segments through the coalesced
        segment planner (one ordered sweep per run file). Part order within
        a bucket keeps ``files`` order, so merge tie order is unchanged. A
        bucket whose rows span several runs arrives as piecewise-sorted
        segments; the join re-sorts it, as it does the multi-file buckets
        an incremental refresh leaves. ``buckets`` (None: all) keeps only
        those buckets' files and run segments, per-bucket files' parts
        first (the reference mesh scan's order for pinned buckets)."""
        run_files = [f for f in files if layout.is_run_file(f)]
        plain = [f for f in files if not layout.is_run_file(f)]
        if buckets is not None:
            plain = [f for f in plain if layout.bucket_of_file(f) in buckets]
            files = plain + run_files
        bmap = dict(zip(plain, layout.read_batches(plain, columns=columns)))
        seg_map: Dict = {}
        sweep_segments: Dict[str, List] = {}
        if run_files:
            from .scan_gate import note_bucket_heat

            plan = layout.plan_segment_reads(
                run_files, None if buckets is None else set(buckets))
            seg_map = layout.execute_segment_reads(plan, columns=columns)
            for sw in plan:
                sweep_segments[sw.path] = sw.segments
            # the compactor's priority signal: these buckets are hot
            note_bucket_heat(layout.index_root_of(run_files[0]), {b for (_p, b) in seg_map})
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
            return _project_groups(by_bucket, list(node.columns)), idx
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
            # the merge folds appended data in: a plain dict, which opts
            # out of every cross-query join cache (BucketGroups)
            metrics.incr("join.cache.optout.hybrid")
            return merged, idx
        return None

    def _try_bucketed_join(
        self, join: Join, l_keys: List[str], r_keys: List[str]
    ) -> Optional[ColumnarBatch]:
        """The shuffle-free bucketed SMJ over two bucketed sides keyed on
        their indexed columns: co-partitioned (equal numBuckets) on K2, per
        shard over a mesh above ``dist_min_rows``; with different
        numBuckets, the shuffle join (``_try_shuffle_join``). None otherwise
        (the exact unbucketed join serves)."""
        l_meta, r_meta = bucketed_meta(join.left), bucketed_meta(join.right)
        if l_meta is None or r_meta is None:
            return None
        if not _keys_are_indexed(l_meta, r_meta, l_keys, r_keys):
            return None
        if l_meta.entry.num_buckets != r_meta.entry.num_buckets:
            # no shared bucket space: over a mesh the smaller side moves
            # into the other's (distributed/shuffle.py); otherwise, and on
            # every decline, the exact join in _exec_join serves
            return self._try_shuffle_join(join, l_keys, r_keys, l_meta, r_meta)
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
        # the movement decision (here always "direct"), recorded so that
        # explain(verbose) shows the same plan table for every bucketed join
        from ..distributed.planner import plan_movement

        plan_movement(
            {b: v.num_rows for b, v in l_by_bucket.items()},
            {b: v.num_rows for b, v in r_by_bucket.items()},
            l_meta.entry.num_buckets,
            r_meta.entry.num_buckets,
            self.mesh.size if self.mesh is not None else 1,
            self.dist_min_rows,
        )
        if self.mesh is None:
            # the resident materializing join: match ranges on the card
            # over the region's codes, the gather from the cached groups
            from .join_residency import resolve_join_residency

            res = resolve_join_residency(join.left, join.right, l_keys, r_keys,
                                         self.residency, self.device)
            if res.status == "ok":
                served = self._resident_join_pairs(
                    res.region, l_by_bucket, r_by_bucket, list(res.l_keys), list(res.r_keys)
                )
                if served is not None:
                    return served
            elif res.status == "no_region":
                self._note_join_touch(res, join.left, join.right, ())
        total_rows = sum(b.num_rows for b in l_by_bucket.values()) + sum(
            b.num_rows for b in r_by_bucket.values()
        )
        if self.mesh is not None and total_rows >= self.dist_min_rows:
            from .distributed import distributed_bucketed_join

            parts = distributed_bucketed_join(
                l_by_bucket, r_by_bucket, l_keys, r_keys, self.mesh
            )
        else:
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
        if self.mesh is not None:
            # the mesh has its own distributed join and two-phase
            # aggregate, and its resident regions are not ported yet: the
            # host fusion must not take the query from them
            return None
        # the resident fused aggregate-join first: one K2/K2p launch and a
        # torch epilogue over the region ship the group table home
        fused = self._try_resident_join_agg(left_plan, right_plan, lk, rk, group_by, aggs)
        if fused is not None:
            return fused
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

    def _try_resident_join_agg(
        self, left_plan, right_plan, l_keys, r_keys, group_by, aggs
    ) -> Optional[ColumnarBatch]:
        """The resident fused aggregate-join arm: eligibility is
        ``resolve_join_residency`` (shared with the materializing arm); a
        miss schedules the region with the aggregate's payload columns.
        None routes the host fusion (no region, or a spec the device
        cannot serve exactly: ``hbm.join.declined.dtype``)."""
        from .hbm_cache import hbm_cache
        from .join_residency import resolve_join_residency
        from .scan_gate import scan_gate

        need = list(dict.fromkeys(list(group_by) + [a.column for a in aggs if a.column]))
        res = resolve_join_residency(left_plan, right_plan, l_keys, r_keys, self.residency,
                                     self.device, payload_columns=need)
        if res.status == "no_region":
            self._note_join_touch(res, left_plan, right_plan, need)
            return None
        if res.status != "ok":
            return None
        try:
            out = hbm_cache.join_agg(res.region, group_by, aggs)
        except RuntimeError:
            # device loss: drop the region, and the fusion over K2's
            # ranges answers
            hbm_cache.drop(res.region)
            metrics.incr("scan.resident_join.device_failed")
            return None
        if out is None:
            return None
        metrics.incr("scan.path.resident_join_agg")
        scan_gate.note_resident_bypass("join")
        return out

    def _note_join_touch(self, res, left_plan, right_plan, payload) -> None:
        """Schedule the join region's background build for the NEXT query
        (never blocks). The loader re-derives both sides' bucket groups on
        the background thread, from the groups cache on a warm repeat."""
        from .hbm_cache import hbm_cache

        if not hbm_cache.auto_enabled(self.residency, self.device):
            return

        def loader():
            lload = self._side_by_bucket(left_plan)
            rload = self._side_by_bucket(right_plan)
            if lload is None or rload is None:
                return None
            return lload[0], rload[0]

        hbm_cache.note_touch_join(
            res.l_node.entry.content.files(), res.r_node.entry.content.files(),
            res.l_keys, res.r_keys, payload, loader, self.device, self.residency,
        )

    def _resident_join_pairs(
        self, region, l_by_bucket, r_by_bucket, l_keys, r_keys
    ) -> Optional[ColumnarBatch]:
        """The materializing resident join: K2/K2p's match ranges over the
        region's resident codes (one launch, no upload; the (lo, counts)
        vectors come home), expanded through the region's ``r_order`` and
        gathered on the host from the (cached) setup. None when the groups
        drifted from the region (the host join serves)."""
        from .hbm_cache import hbm_cache
        from .joins import _bucketed_join_setup, _expand_ranges
        from .scan_gate import scan_gate

        setup, _ck = _bucketed_join_setup(l_by_bucket, r_by_bucket, list(l_keys), list(r_keys))
        if setup is None:
            return None
        l_all, r_all = setup[0], setup[1]
        if l_all.num_rows != region.n_l or r_all.num_rows != region.n_r:
            return None
        try:
            lo, counts = hbm_cache.join_ranges(region)
        except RuntimeError:
            # device loss: drop the region, and the bucketed join answers
            # through K2 over the groups
            hbm_cache.drop(region)
            metrics.incr("scan.resident_join.device_failed")
            return None
        l_idx, r_idx = _expand_ranges(lo, counts, region.r_order)
        out: Dict[str, object] = {}
        out.update(l_all.take(l_idx).columns)
        out.update(r_all.take(r_idx).columns)
        metrics.incr("scan.path.resident_join")
        scan_gate.note_resident_bypass("join")
        return ColumnarBatch(out)

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
            by_bucket = _project_groups(by_bucket, list(project.columns))
        return by_bucket, idx_node

    def _try_shuffle_join(
        self,
        join: Join,
        l_keys: List[str],
        r_keys: List[str],
        l_meta: IndexScan,
        r_meta: IndexScan,
    ) -> Optional[ColumnarBatch]:
        """The join of two bucketed sides with different numBuckets through
        the all_to_all shuffle (distributed/shuffle.py): the planner picks
        the side to move into the other's bucket space; after the one
        exchange round both sides are co-partitioned and the mesh's join
        (or the bucketed join below ``dist_min_rows``) serves. None, the
        exact join in _exec_join serving, when there is no mesh, the planner
        votes host, or the exchange fails on the device, each counted
        ``shuffle.declined.<reason>``."""
        from ..distributed.planner import plan_movement

        left = self._side_by_bucket(join.left)
        right = self._side_by_bucket(join.right)
        if left is None or right is None:
            metrics.incr("shuffle.declined.side_shape")
            return None
        l_by_bucket, l_node = left
        r_by_bucket, r_node = right
        l_rows = sum(b.num_rows for b in l_by_bucket.values())
        r_rows = sum(b.num_rows for b in r_by_bucket.values())
        smaller = l_by_bucket if l_rows <= r_rows else r_by_bucket
        n_planes = len(next(iter(smaller.values())).columns) if smaller else 0
        decision = plan_movement(
            {b: v.num_rows for b, v in l_by_bucket.items()},
            {b: v.num_rows for b, v in r_by_bucket.items()},
            l_meta.entry.num_buckets,
            r_meta.entry.num_buckets,
            self.mesh.size if self.mesh is not None else 1,
            self.dist_min_rows,
            n_payload_planes=max(n_planes, 1),
        )
        if decision.path != "shuffle":
            metrics.incr(f"shuffle.declined.{decision.reason}")
            return None
        # the keys in the UNMOVED side's index order: that side keeps its
        # build-time buckets, so the moved side hashes the same key tuple
        if decision.moved_side == "right":
            l2r = {l.lower(): r for l, r in zip(l_keys, r_keys)}
            l_keys = list(l_node.entry.indexed_columns)
            r_keys = [l2r[k.lower()] for k in l_keys]
        else:
            r2l = {r.lower(): l for l, r in zip(l_keys, r_keys)}
            r_keys = list(r_node.entry.indexed_columns)
            l_keys = [r2l[k.lower()] for k in r_keys]
        from ..distributed.shuffle import try_shuffle_join

        parts = try_shuffle_join(
            l_by_bucket, r_by_bucket, l_keys, r_keys, decision.moved_side,
            decision.target_num_buckets, self.mesh, self.dist_min_rows,
        )
        if parts is None:
            # the exchange failed on the device: the exact join answers
            metrics.incr("shuffle.declined.device_failed")
            return None
        if not parts:
            return inner_join(
                self._empty_side(join.left, l_by_bucket, l_node),
                self._empty_side(join.right, r_by_bucket, r_node),
                l_keys,
                r_keys,
                self.device,
            )
        return ColumnarBatch.concat(parts)

    # -- the mesh's filter and aggregate -------------------------------------
    def _exec_index_scan_distributed(
        self, node: IndexScan, predicate: Expr
    ) -> ColumnarBatch:
        """The mesh's filter scan: prune files (buckets, zone maps), read
        the survivors grouped by bucket (a pinned bucket's rows only, out of
        run files), and mask each shard's buckets on its device
        (exec.distributed.distributed_filter). Below ``dist_min_rows`` total
        rows the host masks and compacts. The mesh's resident tables are
        not ported yet: every query ships its rows."""
        from pathlib import Path

        from .distributed import distributed_filter
        from .scan import buckets_for_predicate, prune_index_files

        entry = node.entry
        pinned = buckets_for_predicate(
            predicate, entry.indexed_columns, entry.schema, entry.num_buckets
        )
        files = prune_index_files(
            [Path(p) for p in entry.content.files()],
            predicate,
            entry.indexed_columns,
            entry.schema,
            entry.num_buckets,
            pinned_buckets=pinned,
        )
        metrics.incr("scan.files_read", len(files))
        need = list(dict.fromkeys(list(node.required_columns) + sorted(predicate.columns())))
        # a pinned-bucket equality over run files reads only those
        # buckets' row ranges, all runs in one coalesced segment plan
        by_bucket = self._read_groups_by_bucket(
            files, need, None if pinned is None else set(pinned))
        out_cols = list(node.required_columns)
        if not by_bucket:
            empty = empty_batch_for(out_cols, entry.schema)
            if empty is not None:
                return empty
            if not files:
                raise HyperspaceException("distributed scan over zero files with no schema.")
            return layout.read_batch(files[0], columns=out_cols).take(
                np.array([], dtype=np.int64))
        total_rows = sum(b.num_rows for b in by_bucket.values())
        if total_rows < self.dist_min_rows:
            # too small for the mesh: the host masks and compacts
            whole = ColumnarBatch.concat([by_bucket[b] for b in sorted(by_bucket)])
            return self._apply_predicate(whole, predicate).select(out_cols)
        return distributed_filter(by_bucket, predicate, out_cols, self.mesh)

    def _try_distributed_aggregate(self, plan: Aggregate) -> Optional[ColumnarBatch]:
        """Aggregate([Project][Filter](IndexScan)) over the mesh: each
        shard's K1 mask and PARTIAL aggregate, merged on the host
        (exec.distributed.distributed_filter_aggregate); only partial
        tables leave the devices. None when the shape or dtypes do not
        qualify (the caller gathers and aggregates); the host aggregates the
        rows already read below ``dist_min_rows`` or when the mesh's
        aggregate declines."""
        from pathlib import Path

        from .aggregate import hash_aggregate
        from .distributed import distributed_filter_aggregate
        from .scan import prune_index_files

        node = plan.child
        pred = None
        if isinstance(node, Project):
            node = node.child
        if isinstance(node, Filter):
            pred = node.condition
            node = node.child
            if isinstance(node, Project):
                node = node.child
        if not isinstance(node, IndexScan):
            return None
        entry = node.entry
        group_by = list(plan.group_by)
        aggs = list(plan.aggs)
        need = list(dict.fromkeys(
            plan.input_columns() + (sorted(pred.columns()) if pred is not None else [])
        ))
        # decidable from the logged schema before any IO: string aggregate
        # inputs need vocab-order min/max; float64 predicates run on the host
        if not group_by or any(c not in entry.schema for c in need):
            return None
        if any(entry.schema[a.column] == "string" for a in aggs if a.column):
            return None
        if pred is not None and any(entry.schema[c] == "float64" for c in pred.columns()):
            return None
        files = [Path(p) for p in entry.content.files()]
        if pred is not None:
            files = prune_index_files(
                files, pred, entry.indexed_columns, entry.schema, entry.num_buckets
            )
        if not files:
            empty = empty_batch_for(need, entry.schema)
            if empty is None:
                return None
            return hash_aggregate(empty, group_by, aggs)
        metrics.incr("scan.files_read", len(files))
        by_bucket = self._read_groups_by_bucket(files, need)

        def host_finish() -> ColumnarBatch:
            # the rows are in hand: never read them again because the mesh
            # declined
            if not by_bucket:
                return hash_aggregate(
                    ColumnarBatch.empty({c: entry.schema[c] for c in need}), group_by, aggs)
            whole = ColumnarBatch.concat([by_bucket[b] for b in sorted(by_bucket)])
            return hash_aggregate(self._apply_predicate(whole, pred), group_by, aggs)

        if not by_bucket:
            return host_finish()
        if sum(b.num_rows for b in by_bucket.values()) < self.dist_min_rows:
            return host_finish()
        fused = distributed_filter_aggregate(by_bucket, pred, group_by, aggs, self.mesh)
        return fused if fused is not None else host_finish()

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


# ---------------------------------------------------------------------------
# the cross-query bucket-groups cache (join sides)
# ---------------------------------------------------------------------------
# Index files are immutable, so the bucket-grouped, dictionary-unified
# arrays a join side loads are a pure function of (file identities,
# projection). This byte-capped LRU (HYPERSPACE_TPU_TORCH_JOIN_CACHE_MB,
# 0 disables; exec/bytecache.py) keeps the PRE-predicate groups.
from .bytecache import ByteCappedLru, batch_nbytes, join_cache_budget  # noqa: E402


def _groups_cache_cap() -> int:
    return join_cache_budget()


_GROUPS_CACHE = ByteCappedLru(_groups_cache_cap)


class BucketGroups(dict):
    """A bucket -> batch dict carrying the identity it was cached under,
    which the join layer's setup and ranges caches key on. The token is
    sound only while the groups are a pure function of it: pristine loads
    carry (file identities, projection); a projection extends it with the
    column list; a predicate with its ``repr``. A transform not derivable
    from the token (a hybrid merge with appended rows) builds a plain
    dict, which opts out (``join.cache.optout.{hybrid,filtered}``)."""

    cache_token: tuple = None


def _groups_key(files, columns) -> Optional[tuple]:
    # the one file-identity rule of every cross-query cache (hbm_cache's)
    from .hbm_cache import _file_identity

    try:
        idents = [_file_identity(f) for f in files]
    except OSError:
        return None
    return (tuple(sorted(idents)), tuple(columns))


def _cached_bucket_groups(key):
    if key is None:
        return None
    hit = _GROUPS_CACHE.get(key)
    metrics.incr("join.cache.hit" if hit is not None else "join.cache.miss")
    return hit


def _store_bucket_groups(key, groups):
    """Cache and return the tagged groups (None when not cached), so the
    FIRST query's join already runs over the token-carrying object."""
    if key is None or key in _GROUPS_CACHE:
        return _GROUPS_CACHE.get(key) if key is not None else None
    nbytes = sum(batch_nbytes(g) for g in groups.values())
    tagged = BucketGroups(groups)
    tagged.cache_token = key
    return _GROUPS_CACHE.put(key, tagged, nbytes)


def reset_groups_cache() -> None:
    _GROUPS_CACHE.reset()


def _project_groups(by_bucket, columns):
    """``columns`` selected in every bucket batch, the cache token kept
    (extended with the column list): a projection of immutable cached
    groups is still a pure function of the files."""
    out = {b: v.select(columns) for b, v in by_bucket.items()}
    tok = getattr(by_bucket, "cache_token", None)
    if tok is not None:
        tagged = BucketGroups(out)
        tagged.cache_token = (tok, tuple(columns))
        return tagged
    return out
