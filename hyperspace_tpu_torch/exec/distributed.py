"""Query execution over the bucket mesh: the distributed filter, two-phase
aggregate and co-partitioned join, each shard running K1 or K2 over the
buckets it owns.

Counterpart of ``hyperspace_tpu.exec.distributed`` (the per-query, "ship
each query" route). Bucket b of every index lives on shard ``b % D``
(parallel/mesh.py), the rule the sharded build writes with, so none of
these touches a collective:

* **filter**: each shard's rows (its buckets, ascending) upload to its
  device and K1 masks them there: the bound predicate is narrowed to
  int32 and lowered ONCE over the whole input, then launched per shard
  (``ops.kernels.program_mask_tensor``); where narrowing declines, the
  same predicate in torch ops per shard (``scan.path.torch_mask``), and
  float64 predicates evaluate on the host, exactly
  (``scan.path.host_f64``). Rows come back shard-major, then bucket
  ascending, the reference's order;
* **aggregate**: per shard, the K1 mask, then partial tables by group
  code: a stable ``torch.sort`` of the masked codes, segment ids from the
  sorted run starts, and sums, counts, mins and maxs per segment through
  the join epilogue's helpers (``join_residency.segment_sum``,
  ``segment_reduce``), in float64 as the reference's partials are. Only
  the partial tables come home; the host merges them in the reference's
  order (two-phase aggregation);
* **join**: per shard, ``joins.merge_join_ranges`` on the shard's device
  over the codes of the buckets it owns: a stable sort of the right
  codes, then K2 and its fence build (host binary search only where K2's
  plan declines, ``join.path.host_searchsorted``). That is the
  reference's per-shard (lt, eq, r_order); pairs expand per shard on the
  host in the reference's order.

A mesh program issues every shard's work before it waits on any: the
uploads and launches are queued shard by shard, the results copied home
through pinned, non-blocking copies (``ops.build.DeviceFetch``), then
each is waited on once. ``dist.h2d_bytes`` counts the bytes the port
ships: narrowed int32 planes and K2's planned operands, with no pad rows
(the reference ships ``(D, cap)`` raw planes); ``dist.d2h_bytes`` what
comes home (masks, partial tables, K2's ranges).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..exceptions import HyperspaceException
from ..ops.build import DeviceFetch, _to_device
from ..parallel.mesh import owner_of_bucket
from ..plan.expr import Expr, bind_string_literals, eval_mask
from ..storage.columnar import Column, ColumnarBatch
from ..telemetry.metrics import metrics
from ..telemetry.trace import add_bytes as _trace_bytes

_I64_PAD = np.iinfo(np.int64).max


def group_by_owner(by_bucket: Dict[int, object], n_devices: int) -> List[List[int]]:
    """Owned bucket ids per shard, ascending: the placement rule shared
    with the sharded build."""
    owned: List[List[int]] = [[] for _ in range(n_devices)]
    for b in sorted(by_bucket):
        owned[owner_of_bucket(b, n_devices)].append(b)
    return owned


def _shard_rows(sizes: Dict[int, int], n_devices: int) -> List[np.ndarray]:
    """Per shard, the row indices (into the concatenation of the buckets
    in ascending order) of the buckets it owns, bucket ascending."""
    offsets, pos = {}, 0
    for b in sorted(sizes):
        offsets[b] = pos
        pos += sizes[b]
    out = []
    for dev in group_by_owner(sizes, n_devices):
        parts = [np.arange(offsets[b], offsets[b] + sizes[b]) for b in dev]
        out.append(np.concatenate(parts) if parts else np.array([], dtype=np.int64))
    return out


def _shard_masks(bound: Expr, whole: ColumnarBatch, names: List[str],
                 dev_idx: List[np.ndarray], mesh) -> Tuple[list, int]:
    """The predicate's mask over each shard's rows, as a device bool tensor
    on the shard's device (None for a shard without rows), issued without
    waiting; and the bytes uploaded. K1 where the predicate and data
    narrow to int32 (lowered once), torch ops otherwise."""
    from ..ops import kernels as K

    prep = K.prepare_predicate(bound, {n: whole.columns[n].data for n in names})
    masks: list = []
    h2d = 0
    if prep is not None:
        narrowed, pnames, i32 = prep
        program = K.lowered_predicate(narrowed, pnames)
        for ix, dev in zip(dev_idx, mesh.devices):
            if not len(ix):
                masks.append(None)
                continue
            with mesh.scope(dev):
                cols = [_to_device(np.ascontiguousarray(i32[n][ix]), dev) for n in pnames]
                h2d += sum(int(c.nbytes) for c in cols)
                masks.append(K.program_mask_tensor(program, cols))
        return masks, h2d
    from .scan import device_shim

    metrics.incr("scan.path.torch_mask")
    shim = device_shim(whole, names)
    sub = whole.select(names)
    for ix, dev in zip(dev_idx, mesh.devices):
        if not len(ix):
            masks.append(None)
            continue
        with mesh.scope(dev):
            arrays = sub.take(ix).device_arrays(device=dev)
            h2d += sum(int(a.nbytes) for a in arrays.values())
            masks.append(eval_mask(bound, shim, arrays))
    return masks, h2d


# ---------------------------------------------------------------------------
# distributed filter
# ---------------------------------------------------------------------------
def distributed_filter(
    by_bucket: Dict[int, ColumnarBatch],
    predicate: Optional[Expr],
    output_columns: List[str],
    mesh,
) -> ColumnarBatch:
    """Filter bucket-grouped rows with a mask per shard: each bucket's rows
    go to their owner shard, each shard masks its rows on its device, the
    host compacts the survivors, shard-major. float64 predicates evaluate
    on the host."""
    batches = [by_bucket[b] for b in sorted(by_bucket)]
    if not batches:
        raise HyperspaceException("distributed_filter over zero buckets.")
    whole = ColumnarBatch.concat(batches) if len(batches) > 1 else batches[0]
    if predicate is None:
        return whole.select(output_columns)
    names = sorted(predicate.columns())
    if any(whole.columns[n].dtype_str == "float64" for n in names):
        mask = np.asarray(eval_mask(predicate, whole))
        metrics.incr("scan.path.host_f64")
        return whole.take(np.flatnonzero(mask)).select(output_columns)
    dev_idx = _shard_rows({b: by_bucket[b].num_rows for b in by_bucket}, mesh.size)
    bound = bind_string_literals(predicate, whole)
    masks, h2d = _shard_masks(bound, whole, names, dev_idx, mesh)
    metrics.incr("dist.h2d_bytes", h2d)
    _trace_bytes("h2d_bytes", h2d)
    fetches = []
    for m, dev in zip(masks, mesh.devices):
        with mesh.scope(dev):
            fetches.append(None if m is None else DeviceFetch([m]))
    keep_parts = []
    d2h = 0
    for ix, f in zip(dev_idx, fetches):
        if f is None:
            continue
        mask = f.wait()[0]
        d2h += int(mask.nbytes)
        keep_parts.append(ix[np.flatnonzero(mask)])
    metrics.incr("dist.d2h_bytes", d2h)
    _trace_bytes("d2h_bytes", d2h)
    metrics.incr("scan.path.distributed")
    keep = np.concatenate(keep_parts) if keep_parts else np.array([], dtype=np.int64)
    return whole.take(keep).select(output_columns)


# ---------------------------------------------------------------------------
# distributed two-phase aggregate
# ---------------------------------------------------------------------------
def _partial_tables(codes: torch.Tensor, vals: torch.Tensor, mask: Optional[torch.Tensor],
                    n_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's PARTIAL aggregation (the reference's ``_dist_agg_fn``
    body): rows the mask drops take the pad code, a stable sort by code
    makes each code's rows a segment, and per segment the representative
    code, the row count and, per value column, the non-NULL count, sum,
    min and max (NaN is NULL). A shard holds at most ``n_groups`` codes,
    so ``n_out = min(m, n_groups + 1)`` slots hold every segment, the pad's
    last: that many come home, not the shard's row count. Returns ``(ints,
    floats)``: (2 + n_vals, n_out) int64 and (3 n_vals, n_out) float64."""
    from .join_residency import segment_reduce, segment_sum

    m = int(codes.shape[0])
    n_out = min(m, int(n_groups) + 1)
    dev = codes.device
    pad = torch.full((), _I64_PAD, dtype=torch.int64, device=dev)
    g = codes if mask is None else torch.where(mask, codes, pad)
    g_sorted, perm = torch.sort(g, stable=True)
    valid = g_sorted != pad
    first = torch.ones(m, dtype=torch.int64, device=dev)
    first[1:] = (g_sorted[1:] != g_sorted[:-1]).to(torch.int64)
    seg = torch.cumsum(first, 0) - 1
    rep = torch.full((n_out,), _I64_PAD, dtype=torch.int64, device=dev).scatter_(
        0, seg, g_sorted)
    ints = [rep, segment_sum(valid.to(torch.int64), seg, n_out)]
    floats = []
    for j in range(int(vals.shape[0])):
        v = vals[j][perm]
        ok = valid & ~torch.isnan(v)
        floats += [
            segment_sum(torch.where(ok, v, torch.zeros_like(v)), seg, n_out),
            segment_reduce(torch.where(ok, v, torch.full_like(v, float("inf"))), seg, n_out,
                           "amin", float("inf")),
            segment_reduce(torch.where(ok, v, torch.full_like(v, float("-inf"))), seg, n_out,
                           "amax", float("-inf")),
        ]
        ints.append(segment_sum(ok.to(torch.int64), seg, n_out))
    f = (torch.stack(floats) if floats
         else torch.zeros((0, n_out), dtype=torch.float64, device=dev))
    return torch.stack(ints), f


def distributed_filter_aggregate(
    by_bucket: Dict[int, ColumnarBatch],
    predicate: Optional[Expr],
    group_by: List[str],
    aggs,
    mesh,
) -> Optional[ColumnarBatch]:
    """Aggregate(Filter(bucketed scan)) over the mesh: each shard masks and
    PARTIALLY aggregates the buckets it owns; the host merges the partial
    tables (sum into sum, count into sum, min into min, max into max, avg
    as sum over count). None when the shape does not qualify (no group
    keys, no rows, a string aggregate input, an integer input whose
    len x max reaches 2^53, a float64 predicate): the caller aggregates on
    the host."""
    from ..plan.aggregates import AggSpec, output_dtype
    from ..storage.columnar import numpy_dtype
    from .aggregate import _group_codes, hash_aggregate

    batches = [by_bucket[b] for b in sorted(by_bucket)]
    if not batches:
        return None
    whole = ColumnarBatch.concat(batches) if len(batches) > 1 else batches[0]
    n = whole.num_rows
    if n == 0 or not group_by:
        return None
    val_cols = sorted({a.column for a in aggs if a.column is not None})
    for c in val_cols:
        if whole.columns[c].vocab is not None:
            return None  # string aggregate input: min/max need vocab order
        d = whole.columns[c].data
        if d.dtype.kind in "iu" and len(d):
            # Python ints: np.abs(int64 min) wraps negative
            bound = max(abs(int(d.min())), abs(int(d.max())))
            if len(d) * bound >= (1 << 53):
                # the partials and their merge ride float64: a sum that
                # could reach the mantissa would round (the host is exact)
                return None
    pred_names = sorted(predicate.columns()) if predicate is not None else []
    if any(whole.columns[c].dtype_str == "float64" for c in pred_names):
        return None  # float64 predicates evaluate on the host
    # group codes factorized on the host (exact, multi-key); shards reduce
    codes, n_groups, rep_idx = _group_codes(whole, group_by)
    dev_idx = _shard_rows({b: by_bucket[b].num_rows for b in by_bucket}, mesh.size)
    masks = [None] * mesh.size
    h2d = 0
    if predicate is not None:
        bound = bind_string_literals(predicate, whole)
        masks, h2d = _shard_masks(bound, whole, pred_names, dev_idx, mesh)
    vals_host = np.stack([whole.columns[c].data.astype(np.float64) for c in val_cols]) \
        if val_cols else np.zeros((0, n), dtype=np.float64)
    fetches = []
    for ix, dev, mask in zip(dev_idx, mesh.devices, masks):
        if not len(ix):
            fetches.append(None)
            continue
        with mesh.scope(dev):
            c_d = _to_device(np.ascontiguousarray(codes[ix]), dev)
            v_d = _to_device(np.ascontiguousarray(vals_host[:, ix]), dev)
            h2d += int(c_d.nbytes) + int(v_d.nbytes)
            fetches.append(DeviceFetch(list(_partial_tables(c_d, v_d, mask, n_groups))))
    metrics.incr("dist.h2d_bytes", h2d)
    _trace_bytes("h2d_bytes", h2d)
    ints_parts, float_parts = [], []
    for f in fetches:
        if f is None:
            continue
        i_h, f_h = f.wait()
        ints_parts.append(i_h)
        float_parts.append(f_h)
    d2h = sum(int(a.nbytes) for a in ints_parts + float_parts)
    metrics.incr("dist.d2h_bytes", d2h)
    _trace_bytes("d2h_bytes", d2h)
    metrics.incr("aggregate.path.distributed")
    # merge the partial tables on the host: a row per (shard, group),
    # shard-major, aggregated with merge semantics
    ints_out = np.concatenate(ints_parts, axis=1)
    floats_out = np.concatenate(float_parts, axis=1)
    keep = ints_out[0] != _I64_PAD
    partial_cols: Dict[str, Column] = {
        "__g": Column("int64", ints_out[0][keep]),
        "__cnt": Column("int64", ints_out[1][keep]),
    }
    for j, c in enumerate(val_cols):
        partial_cols[f"__sum_{c}"] = Column("float64", floats_out[3 * j][keep])
        nn = ints_out[2 + j][keep]
        # a partial is NULL iff its group had no non-NULL row on that shard
        # (deciding by isinf would null a genuine +-inf)
        partial_cols[f"__min_{c}"] = Column(
            "float64", np.where(nn == 0, np.nan, floats_out[3 * j + 1][keep]))
        partial_cols[f"__max_{c}"] = Column(
            "float64", np.where(nn == 0, np.nan, floats_out[3 * j + 2][keep]))
        partial_cols[f"__nn_{c}"] = Column("int64", nn)
    merge_specs = [AggSpec("sum", "__cnt", "__rows")]
    for c in val_cols:
        merge_specs += [
            AggSpec("sum", f"__sum_{c}", f"__S_{c}"),
            AggSpec("min", f"__min_{c}", f"__m_{c}"),
            AggSpec("max", f"__max_{c}", f"__M_{c}"),
            AggSpec("sum", f"__nn_{c}", f"__N_{c}"),
        ]
    merged = hash_aggregate(ColumnarBatch(partial_cols), ["__g"], merge_specs)
    # the final projection per requested spec, keyed back to each group's
    # representative row
    g_final = merged.columns["__g"].data
    key_batch = whole.select(list(group_by)).take(rep_idx[g_final])
    result: Dict[str, Column] = dict(key_batch.columns)
    schema = whole.schema()
    for a in aggs:
        dt = output_dtype(a, schema.get(a.column) if a.column else None)
        if a.fn == "count":
            src = (merged.columns["__rows"].data if a.column is None
                   else merged.columns[f"__N_{a.column}"].data)
            result[a.name] = Column("int64", src.astype(np.int64))
        elif a.fn == "sum":
            s = merged.columns[f"__S_{a.column}"].data.astype(numpy_dtype(dt))
            if dt.startswith("float"):
                # SQL NULL: the sum of an all-NULL group is NULL
                nn = merged.columns[f"__N_{a.column}"].data
                s = np.where(nn == 0, np.nan, s)
            result[a.name] = Column(dt, s)
        elif a.fn == "avg":
            s = merged.columns[f"__S_{a.column}"].data
            nn = merged.columns[f"__N_{a.column}"].data
            with np.errstate(invalid="ignore", divide="ignore"):
                result[a.name] = Column("float64", s / nn)
        else:
            col = merged.columns[f"__{'m' if a.fn == 'min' else 'M'}_{a.column}"]
            result[a.name] = Column(dt, col.data.astype(numpy_dtype(dt)))
    return ColumnarBatch(result)


# ---------------------------------------------------------------------------
# distributed co-partitioned join
# ---------------------------------------------------------------------------
def distributed_bucketed_join(
    left_by_bucket: Dict[int, ColumnarBatch],
    right_by_bucket: Dict[int, ColumnarBatch],
    l_keys: List[str],
    r_keys: List[str],
    mesh,
) -> List[ColumnarBatch]:
    """The shuffle-free join over the mesh: shard d joins the buckets it
    owns (b % D == d) with no movement between shards. Equal join codes
    never span buckets (the hash is value-stable), so per-shard joins over
    the concatenated owned buckets add no false or missing pairs."""
    from .joins import _expand_ranges, bucketed_join_pairs, join_codes, merge_join_ranges_deferred

    common = sorted(set(left_by_bucket) & set(right_by_bucket))
    if not common:
        return []
    l_batches = [left_by_bucket[b] for b in common]
    r_batches = [right_by_bucket[b] for b in common]
    # codes once over each side's whole concatenation (the dictionaries
    # unify globally), then each shard's rows
    l_all = ColumnarBatch.concat(l_batches)
    r_all = ColumnarBatch.concat(r_batches)
    overlap = set(l_all.column_names) & set(r_all.column_names)
    if overlap:
        raise HyperspaceException(f"Join output would duplicate columns {sorted(overlap)}.")
    l_codes, r_codes = join_codes(l_all, r_all, l_keys, r_keys)
    if (l_codes == _I64_PAD).any() or (r_codes == _I64_PAD).any():
        # a real code equals the reference's pad sentinel: it declines to
        # the bucketed join, and so does the port
        return bucketed_join_pairs(left_by_bucket, right_by_bucket, l_keys, r_keys,
                                   mesh.devices[0])
    l_dev_idx = _shard_rows({b: left_by_bucket[b].num_rows for b in common}, mesh.size)
    r_dev_idx = _shard_rows({b: right_by_bucket[b].num_rows for b in common}, mesh.size)
    finishes = []
    for li, ri, dev in zip(l_dev_idx, r_dev_idx, mesh.devices):
        if not len(li) or not len(ri):
            finishes.append(None)
            continue
        with mesh.scope(dev):
            finishes.append(merge_join_ranges_deferred(l_codes[li], r_codes[ri], dev))
    h2d = sum(f.h2d_bytes for f in finishes if f is not None)
    metrics.incr("dist.h2d_bytes", h2d)
    _trace_bytes("h2d_bytes", h2d)
    ranges = [None if f is None else f() for f in finishes]
    d2h = sum(f.d2h_bytes for f in finishes if f is not None)
    metrics.incr("dist.d2h_bytes", d2h)
    _trace_bytes("d2h_bytes", d2h)
    metrics.incr("join.path.distributed")
    # expand per shard: positions index the shard's sorted right codes,
    # through its r_order to the shard's rows, then to the side's rows
    parts: List[ColumnarBatch] = []
    for li, ri, rg in zip(l_dev_idx, r_dev_idx, ranges):
        if rg is None:
            continue
        lo, counts, r_order = rg
        l_local, r_local = _expand_ranges(lo, counts, r_order)
        if not len(l_local):
            continue
        out: Dict[str, Column] = {}
        out.update(l_all.take(li[l_local]).columns)
        out.update(r_all.take(ri[r_local]).columns)
        parts.append(ColumnarBatch(out))
    return parts
