"""Micro-batcher: coalesce compatible queued resident scans into ONE
launch.

Counterpart of ``hyperspace_tpu.serve.batcher`` (single device). Every
resident-scan query pays a launch and a count-vector copy home; N
concurrent point lookups served one by one pay N of each. Queries are
COMPATIBLE when they hit the same resident table (same index version:
the table's key carries file identities) with predicates over the same
resident plane set; a batch of them launches K1b once (N programs over
planes read once; ``hbm_cache.block_counts_batch``) and brings home one
``(N, n_blocks)`` count matrix. The host leg stays per query and exact:
each reads only ITS candidate blocks and re-evaluates ITS predicate, so
batched results equal the serial ones.

Classification runs against the optimized plan (the server's plan cache
makes that cheap): ``[Project] Filter IndexScan`` qualifies; so does the
filter-shape hybrid union when the base table and its delta are resident
(one K1hb launch over base, delta and the deletion mask); so does an
``Aggregate([Project](Join))`` whose join region is resident (one region
launch serves the whole batch). Everything else, and predicates the zone
gate routes to the host, takes the normal executor path, as does every
query of a mesh session.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..plan.expr import Expr
from ..plan.ir import Aggregate, Filter, IndexScan, LogicalPlan, Project, Union
from ..storage.columnar import ColumnarBatch
from ..telemetry.metrics import metrics


@dataclass
class ResidentScanRequest:
    """One classified, batchable query: what the batched launch needs, and
    the key it coalesces under."""

    table: object  # ResidentTable | StreamingResidentTable | JoinRegion
    entry: object  # IndexLogEntry (schema for empty results)
    files: List[Path]  # the query's pruned file list (a subset of the table's)
    predicate: Expr
    output_columns: List[str]
    batch_key: Tuple
    # prepare_resident_predicate's result from classification, so the
    # launch does not narrow each predicate again
    prepared: object = None
    # hybrid requests: the base's delta region, and the base host leg's
    # exact predicate (the lineage NOT IN conjoined when files were deleted)
    delta: object = None
    host_predicate: Optional[Expr] = None
    # "join_agg" coalesces aggregate-joins under (region, aggregation spec)
    kind: str = "scan"
    group_by: Tuple = ()
    aggs: Tuple = ()


def classify(session, plan: LogicalPlan) -> Optional[ResidentScanRequest]:
    """A ResidentScanRequest when ``plan`` can ride a batched resident
    launch, else None (the caller executes it normally). Every key folds
    the plan's coarse fingerprint (``compile.fingerprint.batch_fingerprint``),
    so two structurally incompatible pipelines never share a launch."""
    from ..compile.fingerprint import batch_fingerprint
    from ..exec.hbm_cache import hbm_cache, prepare_resident_predicate, zone_block_fraction
    from ..exec.scan import prune_index_files

    if session.mesh is not None and session.mesh.size > 1:
        # a mesh session serves each query through the executor's mesh
        # arms; the mesh's resident tables, which a batch would read, are
        # not ported yet
        return None
    output_columns = list(plan.output_columns())
    node = plan
    while isinstance(node, Project):
        node = node.child
    if isinstance(node, Aggregate):
        return _classify_join_aggregate(session, node, output_columns, batch_fingerprint(plan))
    if not isinstance(node, Filter):
        return None
    if isinstance(node.child, Union):
        return _classify_hybrid(session, node.condition, node.child, output_columns,
                                batch_fingerprint(plan))
    if not isinstance(node.child, IndexScan):
        return None
    residency = session.conf.residency()
    if residency.mode == "off":
        return None
    fp = batch_fingerprint(plan)
    predicate = node.condition
    entry = node.child.entry
    files = prune_index_files([Path(p) for p in entry.content.files()], predicate,
                              entry.indexed_columns, entry.schema, entry.num_buckets)
    if not files:
        return None  # empty scans are cheap on the normal path
    table = hbm_cache.resident_for(files, sorted(predicate.columns()), session.device, residency)
    if table is None:
        return None
    # the single query's selectivity gate: a predicate that cannot prune
    # blocks reads nearly everything on the host anyway
    frac = zone_block_fraction(table, predicate)
    if frac is not None and residency.max_block_frac < 1.0 and frac >= residency.max_block_frac:
        return None
    prepared = prepare_resident_predicate(table.columns, predicate)
    if prepared is None:
        return None
    # a streaming table batches only within one window generation
    gen = getattr(table, "window_gen", None)
    batch_key = (fp, id(table), frozenset(prepared[1])) + ((gen,) if gen is not None else ())
    return ResidentScanRequest(table, entry, files, predicate, output_columns, batch_key,
                               prepared)


def _classify_hybrid(session, predicate: Expr, union: LogicalPlan,
                     output_columns: List[str], fp: Tuple) -> Optional[ResidentScanRequest]:
    """A filter-shape hybrid union for the batched hybrid launch: base
    table AND delta resident, the predicate on the shared encodings. The
    eligibility is ``exec/delta.py:resolve_hybrid_residency``, the
    procedure the executor's fused arm runs, so a query never routes
    differently served than collected."""
    from ..exec.delta import prepare_hybrid_predicate, resolve_hybrid_residency
    from ..plan.rules.hybrid_scan import parse_hybrid_union

    info = parse_hybrid_union(union)
    if info is None:
        return None
    res = resolve_hybrid_residency(info, predicate, session.device, session.conf.residency())
    if res.status != "ok":
        return None
    prepared = prepare_hybrid_predicate(res.table.columns, res.delta.oov, predicate)
    if prepared is None:
        return None
    if any(n.split("\x00", 1)[0] not in res.delta.columns for n in prepared[1]):
        return None
    return ResidentScanRequest(
        res.table, info.entry, res.files, predicate, output_columns,
        (fp, id(res.table), id(res.delta), frozenset(prepared[1])),
        prepared, res.delta, res.host_predicate)


def _classify_join_aggregate(session, agg: Aggregate, output_columns: List[str],
                             fp: Tuple) -> Optional[ResidentScanRequest]:
    """An ``Aggregate([Project](Join))`` for the batched resident
    aggregate-join: both sides pristine bucketed index scans with a
    registered region covering the group and aggregate columns, and a
    spec the card serves (``resolve_join_residency`` + ``region_agg_plan``,
    the executor's pair). Identical specs coalesce under (region, spec):
    one region launch serves the batch."""
    from ..exec.join_residency import orient_join_aggregate, region_agg_plan, \
        resolve_join_residency

    oriented = orient_join_aggregate(agg)
    if oriented is None:
        return None
    left_plan, right_plan, lk, rk, group_by, aggs = oriented
    need = list(dict.fromkeys(group_by + [a.column for a in aggs if a.column]))
    res = resolve_join_residency(left_plan, right_plan, lk, rk, session.conf.residency(),
                                 session.device, payload_columns=need)
    if res.status != "ok":
        return None
    if region_agg_plan(res.region, group_by, aggs) is None:
        return None
    spec = (tuple(group_by), tuple((a.fn, a.column, a.name) for a in aggs))
    return ResidentScanRequest(res.region, None, [], None, output_columns,
                               (fp, id(res.region), "join_agg", spec),
                               kind="join_agg", group_by=tuple(group_by), aggs=tuple(aggs))


def execute_batch(requests: List[ResidentScanRequest]) -> Optional[List[ColumnarBatch]]:
    """Results of a compatible batch: ONE launch, then each query's exact
    host leg over its own candidate blocks. None when the batched launch
    declines (the caller serves the queries one by one); a device error
    raises (the server fails the batch's tickets with it)."""
    from ..exec.hbm_cache import hbm_cache
    from ..exec.scan import _resident_parts

    head = requests[0]
    if head.kind == "join_agg":
        group = hbm_cache.join_agg(head.table, list(head.group_by), list(head.aggs))
        if group is None:
            return None  # the spec declined since classification
        metrics.incr("serve.batch.coalesced", len(requests))
        metrics.incr("scan.path.resident_join_agg", len(requests))
        return [group.select(list(r.output_columns)) for r in requests]
    table = head.table
    predicates = [r.predicate for r in requests]
    prepared = [r.prepared for r in requests]
    results = []
    if head.delta is not None:
        pairs = hbm_cache.hybrid_block_counts_batch(table, head.delta, predicates, prepared)
        if pairs is None:
            return None
        for r, (base_c, delta_c) in zip(requests, pairs):
            parts = _resident_parts(table, r.files, r.output_columns, r.host_predicate,
                                    base_c, path_metric=None)
            parts += hbm_cache.delta_parts(head.delta, r.predicate, r.output_columns, delta_c)
            metrics.incr("scan.path.resident_hybrid")
            results.append(_concat_or_empty(parts, r))
    else:
        counts = hbm_cache.block_counts_batch(table, predicates, prepared)
        if counts is None:
            return None
        for r, c in zip(requests, counts):
            results.append(_concat_or_empty(
                _resident_parts(table, r.files, r.output_columns, r.predicate, c), r))
    metrics.incr("serve.batch.coalesced", len(requests))
    return results


def _concat_or_empty(parts, r: ResidentScanRequest) -> ColumnarBatch:
    from ..exec.scan import empty_batch_for
    from ..storage import layout

    if parts:
        return ColumnarBatch.concat(parts)
    empty = empty_batch_for(r.output_columns, r.entry.schema)
    if empty is not None:
        return empty
    # no logged schema (covering indexes always log one): a 0-row read
    return layout.read_batch(r.files[0], columns=r.output_columns).take(
        np.array([], dtype=np.int64))
