"""Device aggregation over one resident table: the ``agg_scan`` pipeline's
group-by on the card.

Counterpart of the single-device part of ``hyperspace_tpu.exec.scan_agg``
(``scan_agg_fn`` over ``_core_scan_agg``). The predicate's mask comes
from K1 (``ops/kernels.py:predicate_mask_tensor``, the program lowered as
for every resident launch) over the table's planes, a packed plane
decoded first (``ops/bitpack.py:unpack_plain_torch``); pad rows are
cleared. Every row routes its group key into dense slots ``key - mn``
(a key out of the domain into a trash slot at ``span`` that the finish
drops) and the per-group count, sum, min and max reduce there with the
join epilogue's helpers (``exec/join_residency.py:segment_sum``,
``segment_reduce``: ``index_add_`` and ``scatter_reduce_``), a row the
mask drops adding the identity. One copy home
brings the span-sized group vectors, the finished group table: the host
reads no block, which is why the selectivity gate does not apply.

Exactness, as the reference's:

* int aggregates are exact: int32 resident codes keep their values and
  sums accumulate in int64 (wrapping as the host's int64 does);
* float32 and float64 decode from their order-preserving encodings
  (``ops/floatbits.py``, exact bit transforms) and sum in float64: equal
  to the host's sums up to summation order;
* resident numeric columns hold no NULL (NaN data never becomes
  resident), so count(col) == count(*);
* string columns group and take min/max through the table-global sorted
  vocab codes; NULL is code -1, its own group in slot 0, and min, max and
  count skip it.

Specs that cannot ride exactly decline with a reason (``tier``,
``shape``, ``column``, ``dtype``, ``span``) and the caller aggregates on
the host, counting ``compile.agg.declined.<reason>``.

The mesh twin (``mesh_scan_agg_outputs``, the reference's
``mesh_scan_agg_fn``) runs K1's mask and the epilogue once a shard, each
shard's pad rows past its ``dev_rows`` cleared, and merges the partial
slot vectors with ``parallel/mesh.py:all_reduce``; one copy of the merged
group vectors comes home.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops import kernels as K
from ..ops.bitpack import unpack_plain_torch
from ..plan.aggregates import output_dtype
from ..storage.columnar import Column, ColumnarBatch, numpy_dtype
from ..telemetry.metrics import metrics
from .join_residency import extreme, segment_reduce, segment_sum

# the dense-domain rule of aggregate._dense: span + 1 slots are allocated,
# so a wide key domain over few rows would cost more than host hashing
_SPAN_FLOOR = 1 << 16

_AGG_FNS = ("sum", "count", "min", "max", "avg")

# the epilogue's partial slots: at most this many in all, and this many
# copies of a group
_SPREAD_SLOTS = 1 << 16
_MAX_COPIES = 1024


@dataclass(frozen=True)
class ScanAggCol:
    """One aggregated column: its resident encoding, its planes (2 for
    f64) and the sorted device ops ('max'/'min'/'nn'/'sum') it needs."""

    name: str
    enc: str  # 'int' | 'float32' | 'f64' | 'string'
    arity: int
    ops: tuple


@dataclass(frozen=True)
class ScanAggPlan:
    group: str
    group_enc: str  # 'int' | 'string'
    mn: int  # group-key offset (-1 for strings: the NULL code goes to slot 0)
    span: int
    cols: tuple  # ScanAggCol, in name order


def column_value_bounds(table, name: str) -> Optional[Tuple[int, int]]:
    """(min, max) of an int-encoded resident column's values: from the
    zone vectors, else the bounds a mesh table records (its shards build
    no zones), else the pack spec's frame. None: unknown (decline)."""
    z = getattr(table, "zones", {}).get(name)
    if z is not None and z[0] == "value" and len(z[1]):
        return int(z[1].min()), int(z[2].max())
    col = table.columns[name]
    if getattr(col, "vmin", None) is not None:
        return int(col.vmin), int(col.vmax)
    pack = col.pack
    if pack is not None:
        return int(pack.ref0), int(pack.ref0) + (1 << pack.bits) - 1
    return None


def scan_agg_plan(table, group_by, aggs):
    """(ScanAggPlan, "ok") or (None, decline reason) for (group_by, aggs)
    over ``table``'s resident columns: 'tier' (a streaming table keeps the
    count-vector protocol), 'shape' (not exactly one group key), 'column'
    (not resident), 'dtype' (a float group key, whose codes are never
    dense, or a string sum), 'span' (a key domain that is not dense)."""
    if table.tier == "streaming":
        return None, "tier"
    if len(group_by) != 1:
        return None, "shape"
    g = group_by[0]
    gcol = table.columns.get(g)
    if gcol is None:
        return None, "column"
    limit = max(4 * int(table.n_rows), _SPAN_FLOOR)
    if gcol.enc == "string":
        mn, span = -1, len(gcol.vocab) + 1
        if span > limit:
            return None, "span"
    elif gcol.enc == "int":
        bounds = column_value_bounds(table, g)
        if bounds is None:
            return None, "dtype"
        mn, span = bounds[0], bounds[1] - bounds[0] + 1
        if span <= 0 or span > limit:
            return None, "span"
    else:
        return None, "dtype"
    wants: Dict[str, set] = {}
    for a in aggs:
        if a.fn not in _AGG_FNS:
            return None, "dtype"
        if a.column is None:
            continue  # count(*) is the rows vector
        pc = table.columns.get(a.column)
        if pc is None:
            return None, "column"
        need = wants.setdefault(a.column, set())
        if pc.enc == "string":
            if a.fn in ("sum", "avg"):
                return None, "dtype"
            need.add("nn")
            if a.fn in ("min", "max"):
                need.add(a.fn)
        elif a.fn in ("sum", "avg"):
            need.add("sum")
        elif a.fn in ("min", "max"):
            need.add(a.fn)
    cols = tuple(
        ScanAggCol(name, table.columns[name].enc, 2 if table.columns[name].enc == "f64" else 1,
                   tuple(sorted(ops)))
        for name, ops in sorted(wants.items())
    )
    return ScanAggPlan(g, gcol.enc, mn, span, cols), "ok"


def plan_plane_names(plan: ScanAggPlan) -> tuple:
    """The resident plane names the group and value operands ride, in
    (group, plan.cols) order (f64 as its hi and lo planes)."""
    names = [plan.group]
    for c in plan.cols:
        names += [c.name + "\x00hi", c.name + "\x00lo"] if c.enc == "f64" else [c.name]
    return tuple(names)


_TOP32 = -(1 << 31)
_TOP64 = -(1 << 63)


def decode_value(enc: str, planes) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(values, validity or None) of resident planes: the exact inverses
    of the host encodings (``ops/floatbits.py``)."""
    if enc == "int":
        return planes[0].to(torch.int64), None
    if enc == "float32":
        o = planes[0]
        bits = torch.where(o < 0, ~(o ^ _TOP32), o)
        return bits.view(torch.float32).to(torch.float64), None
    if enc == "f64":
        hi, lo = planes
        low = (lo ^ _TOP32).to(torch.int64) & 0xFFFFFFFF
        o = (hi.to(torch.int64) << 32) | low
        bits = torch.where(o < 0, ~(o ^ _TOP64), o)
        return bits.view(torch.float64), None
    codes = planes[0].to(torch.int64)  # string: global vocab codes, -1 NULL
    return codes, codes >= 0


def _raw_planes(table, names, shard: Optional[int] = None) -> list:
    """Int32 planes of ``n_pad`` rows for resident ``names`` (of a mesh
    table: shard ``shard``'s, ``cap`` rows): a packed plane decoded in
    torch."""
    from .hbm_cache import resident_arrays_for

    rows = table.n_pad if shard is None else table.cap
    out = []
    for n, t in zip(names, resident_arrays_for(table.columns, names)):
        t = t if shard is None else t[shard]
        spec = None if "\x00" in n else table.columns[n].pack
        out.append(t if spec is None else unpack_plain_torch(
            t, dataclasses.replace(spec, n=rows)))
    return out


def core_scan_agg(plan: ScanAggPlan, mask: torch.Tensor, gvals: torch.Tensor, flats) -> list:
    """The segment aggregates: every row goes to slot ``key - mn`` (a key
    out of the domain to the trash slot ``span``), and a row not set in
    ``mask`` adds the identity there (0, or the min/max fill). Returns
    span + 1 slot vectors: rows per group, then per column its ops'
    results. (The reference routes failing rows to the trash slot; here
    they stay on their own slot, so the atomics of the rows a filter
    drops spread over the groups instead of serializing on one address;
    and a domain of few groups sums into copies of each slot first.)"""
    n = plan.span + 1
    code = gvals.to(torch.int64) - plan.mn
    in_domain = (code >= 0) & (code < plan.span)
    slot = torch.where(in_domain, code, torch.full_like(code, plan.span))
    # a narrow domain takes ``copies`` partial slots per group (row i into
    # copy i % copies), reduced after: the atomics of many rows on one
    # group's address spread over many
    copies = max(1, min(_MAX_COPIES, _SPREAD_SLOTS // n))
    if copies > 1:
        slot = slot * copies + torch.arange(slot.numel(), device=slot.device) % copies
    m = n * copies
    take = mask & in_domain
    outs = [segment_sum(take.to(torch.int64), slot, m)]
    i = 0
    for c in plan.cols:
        v, valid = decode_value(c.enc, flats[i : i + c.arity])
        i += c.arity
        keep = take if valid is None else take & valid
        for op in c.ops:
            if op == "sum":
                outs.append(segment_sum(torch.where(take, v, torch.zeros_like(v)), slot, m))
            elif op == "nn":  # strings: non-NULL codes
                outs.append(segment_sum(keep.to(torch.int64), slot, m))
            else:
                fill = extreme(v.dtype, op == "min")
                vv = torch.where(keep, v, torch.full_like(v, fill))
                outs.append(segment_reduce(vv, slot, m, "a" + op, fill))
    if copies == 1:
        return outs
    kinds = ["sum"] + [op for c in plan.cols for op in c.ops]
    return [o.view(n, copies).sum(1) if k in ("sum", "nn") else
            o.view(n, copies).amin(1) if k == "min" else o.view(n, copies).amax(1)
            for o, k in zip(outs, kinds)]


def scan_agg_outputs(table, prepared, plan: ScanAggPlan) -> list:
    """The device aggregate of one filtered resident table: K1's mask of
    the prepared predicate (``prepare_resident_predicate``'s (narrowed,
    names)) with pad rows cleared, then ``core_scan_agg``. Returns the
    device vectors."""
    narrowed, names = prepared
    mask = K.predicate_mask_tensor(narrowed, names, _raw_planes(table, names))
    mask = mask & (torch.arange(table.n_pad, device=mask.device) < table.n_rows)
    planes = _raw_planes(table, plan_plane_names(plan))
    return core_scan_agg(plan, mask, planes[0], planes[1:])


def mesh_scan_agg_outputs(table, prepared, plan: ScanAggPlan) -> list:
    """The mesh device aggregate (the reference's ``mesh_scan_agg_fn``):
    per shard, K1's mask of the prepared predicate over the shard's planes
    with the rows past its ``dev_rows`` cleared, then ``core_scan_agg``
    over the full slot space, every shard issued with its device current;
    ``parallel/mesh.py:all_reduce`` merges the partials (sums and counts
    SUM, min MIN, max MAX) on the first shard's device. Returns the merged
    device vectors."""
    from ..parallel.mesh import all_reduce

    narrowed, names = prepared
    mesh = table.mesh
    parts = []
    for d, dev in enumerate(mesh.devices):
        with mesh.scope(dev):
            mask = K.predicate_mask_tensor(narrowed, names, _raw_planes(table, names, d))
            mask = mask & (torch.arange(table.cap, device=mask.device) < table.dev_rows[d])
            planes = _raw_planes(table, plan_plane_names(plan), d)
            parts.append(core_scan_agg(plan, mask, planes[0], planes[1:]))
    kinds = ["sum"] + ["sum" if op in ("sum", "nn") else op for c in plan.cols for op in c.ops]
    return [all_reduce([p[i] for p in parts], kind, mesh)[0] for i, kind in enumerate(kinds)]


def finish_scan_agg(table, plan: ScanAggPlan, group_by, aggs, outs) -> ColumnarBatch:
    """The group table from the span-sized vectors brought home: groups
    with no matching row do not appear; ascending group key order (the
    host hash aggregate's first-occurrence order differs: compare sorted,
    as for the join aggregate's finish)."""
    rows = outs[0][: plan.span]
    idx = 1
    per_col: Dict[str, tuple] = {}
    for c in plan.cols:
        got = {}
        for op in c.ops:
            got[op] = outs[idx][: plan.span]
            idx += 1
        per_col[c.name] = (c, got)
    keep = np.flatnonzero(rows > 0)
    rows_kept = rows[keep].astype(np.int64)
    g = group_by[0]
    gcol = table.columns[g]
    out: Dict[str, Column] = {}
    if plan.group_enc == "string":
        out[g] = Column(gcol.dtype_str, (keep + plan.mn).astype(np.int32), gcol.vocab)
    else:
        out[g] = Column(gcol.dtype_str, (keep + plan.mn).astype(numpy_dtype(gcol.dtype_str)))
    for a in aggs:
        if a.column is None:
            out[a.name] = Column("int64", rows_kept)
            continue
        c, got = per_col[a.column]
        pc = table.columns[a.column]
        dt = output_dtype(a, pc.dtype_str)
        nn_k = got["nn"][keep].astype(np.int64) if "nn" in got else rows_kept
        if a.fn == "count":
            out[a.name] = Column("int64", nn_k)
        elif a.fn == "avg":
            with np.errstate(invalid="ignore", divide="ignore"):
                out[a.name] = Column("float64", got["sum"][keep].astype(np.float64) / nn_k)
        elif a.fn == "sum":
            s = got["sum"][keep].astype(numpy_dtype(dt))
            if dt.startswith("float"):
                s = np.where(nn_k == 0, np.nan, s)  # SQL: an all-NULL group is NULL
            out[a.name] = Column(dt, s)
        else:  # min / max
            vals = got[a.fn][keep]
            if c.enc == "string":
                out[a.name] = Column(pc.dtype_str, np.where(nn_k == 0, -1, vals).astype(np.int32),
                                     pc.vocab)
            else:
                if dt.startswith("float"):
                    vals = np.where(nn_k == 0, np.nan, vals)
                out[a.name] = Column(dt, vals.astype(numpy_dtype(dt)))
    metrics.incr("aggregate.path.scan_fused")
    return ColumnarBatch(out)
