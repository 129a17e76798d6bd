"""Hash-aggregate execution over columnar batches.

Counterpart of ``hyperspace_tpu.exec.aggregate``. Grouping factorizes the
key tuple into dense int codes and reduces each aggregate with one
vectorized segment operation: bincount for count/sum, reduceat over the
grouped order for min/max. No Python loop touches rows.

NULL semantics (SQL): NULL group keys form their own group; count(col)
counts non-NULL values; sum/avg/min/max skip NULLs (string code -1, float
NaN); count(*) counts rows. Empty input yields zero groups.

Group order is the reference's, row for row: bounded-range integer keys
come out in ascending order, every other key in order of first
appearance. The reference factorizes the latter with pandas; the port
uses numpy alone (``_first_appearance_codes``), since the machine with the
card has no pandas.

``aggregate_join_ranges`` tries the reference's native single-pass arm
first (``_join_ranges_native``: one integer group key over a dense span,
right-side values; the C++ ``native.group_agg_ranges`` accumulates each
value column through the match ranges into interleaved slots,
``aggregate.path.join_fused_native``), then its generic arm (prefix
arithmetic and bincounts, ``aggregate.path.join_fused``). The native arm
sums float right columns directly, so it also serves them under duplicate
matches, which the generic arm declines. Both packages run the same C++
over the same ranges, so their float sums agree bit for bit.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from .. import native
from ..exceptions import HyperspaceException
from ..plan.aggregates import AggSpec, output_dtype
from ..storage.columnar import Column, ColumnarBatch, is_string, numpy_dtype
from ..telemetry.metrics import metrics


def _key_array(col: Column) -> np.ndarray:
    """int64 array whose equality ⟺ key equality. Strings use dictionary
    codes (NULL = -1 is just another value); floats ride the shared key
    normalization (ops.floatbits.float_key_codes: -0.0 equals 0.0, every
    NaN one bit pattern), so all NaNs form one group, as SQL groups them."""
    if is_string(col.dtype_str):
        return col.data.astype(np.int64)
    if col.data.dtype.kind == "f":
        from ..ops.floatbits import float_key_codes

        return float_key_codes(col.data)[0]
    return col.data.astype(np.int64)


def _first_appearance_codes(arr: np.ndarray) -> Tuple[np.ndarray, int]:
    """Dense codes numbered in order of first appearance — what
    ``pd.factorize(sort=False)`` returns — from one sort: the uniques'
    first indices rank them."""
    _, first, inverse = np.unique(arr, return_index=True, return_inverse=True)
    rank = np.empty(len(first), dtype=np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first), dtype=np.int64)
    return rank[inverse.reshape(-1)], len(first)


def _dense(arr: np.ndarray) -> Tuple[np.ndarray, int]:
    """Factorize to dense codes 0..k-1. Bounded-range integer keys (ids —
    the common case) go through offset arithmetic + one bincount
    compaction, in ascending order; everything else is numbered by first
    appearance."""
    n = len(arr)
    if n and arr.dtype.kind in "iu":
        mn = int(arr.min())
        mx = int(arr.max())
        span = mx - mn + 1
        # span must be O(n): the compaction scans span slots, so a wide id
        # domain over few rows would cost far more than a sort
        if 0 < span <= max(4 * n, 1 << 16):
            offset = (arr - mn).astype(np.int64)
            occupancy = np.bincount(offset, minlength=span)
            occupied = np.flatnonzero(occupancy)
            if len(occupied) == span:  # every value in range present
                return offset, span
            lookup = np.empty(span, dtype=np.int64)
            lookup[occupied] = np.arange(len(occupied), dtype=np.int64)
            return lookup[offset], len(occupied)
    return _first_appearance_codes(arr)


def _group_codes(
    batch: ColumnarBatch, group_by: Sequence[str]
) -> Tuple[np.ndarray, int, np.ndarray]:
    """(codes, n_groups, representative row index per group). Multi-key
    tuples pack pairwise — each pack re-densifies, so the product of
    cardinalities never exceeds n² and cannot overflow int64 for any
    realistic n. Representatives are the FIRST occurrence of each group:
    one reversed fancy-index store (last write wins ⇒ reversed order makes
    the first occurrence win) instead of a sort."""
    codes, card = _dense(_key_array(batch.columns[group_by[0]]))
    for name in group_by[1:]:
        nxt, nxt_card = _dense(_key_array(batch.columns[name]))
        codes, card = _dense(codes * np.int64(nxt_card) + nxt)
    n = len(codes)
    rep = np.empty(card, dtype=np.int64)
    rep[codes[::-1]] = np.arange(n - 1, -1, -1, dtype=np.int64)
    return codes, card, rep


def _valid_mask(col: Column) -> np.ndarray:
    if is_string(col.dtype_str):
        return col.data >= 0
    if col.data.dtype.kind == "f":
        return ~np.isnan(col.data)
    return np.ones(len(col.data), dtype=bool)


def _segment_minmax(
    codes: np.ndarray,
    col: Column,
    n_groups: int,
    want_max: bool,
    order: np.ndarray,
) -> Column:
    """Per-group min/max via reduceat over the (shared) grouped order,
    NULL-skipping. ``order`` is the stable argsort of ``codes``, computed
    once in hash_aggregate and reused by every min/max spec. Groups whose
    values are all NULL yield NULL (string) / NaN (float); all-NULL
    integer groups cannot occur (ints have no NULL)."""
    valid_sorted = _valid_mask(col)[order]
    seg_sorted = codes[order][valid_sorted]
    vals_sorted = col.data[order][valid_sorted]
    bounds = np.flatnonzero(np.diff(seg_sorted)) + 1
    starts = np.concatenate([[0], bounds]) if len(seg_sorted) else np.array([], dtype=np.int64)
    red = np.maximum if want_max else np.minimum
    if is_string(col.dtype_str):
        out_codes = np.full(n_groups, -1, dtype=col.data.dtype)
        if len(seg_sorted):
            # dictionary codes from one unified vocab are order-preserving
            out_codes[seg_sorted[starts]] = red.reduceat(vals_sorted, starts)
        return Column("string", out_codes, col.vocab)
    fill = np.nan if col.data.dtype.kind == "f" else 0
    out = np.full(n_groups, fill, dtype=col.data.dtype)
    if len(seg_sorted):
        out[seg_sorted[starts]] = red.reduceat(vals_sorted, starts)
    return Column(col.dtype_str, out)


def _exact_int_sum_needed(vals: np.ndarray) -> bool:
    """Whether a float64 accumulator could round an int64 sum of ``vals``:
    only when n · max|v| reaches 2^53. The bound is taken in Python ints
    (np.abs of int64 min wraps negative)."""
    if not len(vals):
        return False
    bound = max(abs(int(vals.min())), abs(int(vals.max())))
    return len(vals) * bound >= (1 << 53)


@metrics.timer("aggregate.total")
def hash_aggregate(
    batch: ColumnarBatch,
    group_by: Sequence[str],
    aggs: Sequence[AggSpec],
) -> ColumnarBatch:
    schema = batch.schema()
    missing = [c for c in list(group_by) + [a.column for a in aggs if a.column]
               if c not in schema]
    if missing:
        raise HyperspaceException(f"Aggregate references unknown columns {missing}.")
    n = batch.num_rows
    if not group_by:
        # global aggregate: one group covering every row (n=0 → one group
        # of zero rows, SQL's single-row global-aggregate result)
        codes = np.zeros(n, dtype=np.int64)
        n_groups, rep_idx = 1, None
    else:
        if n == 0:
            return ColumnarBatch.empty(
                {c: schema[c] for c in group_by}
                | {a.name: output_dtype(a, schema.get(a.column) if a.column else None)
                   for a in aggs}
            )
        codes, n_groups, rep_idx = _group_codes(batch, group_by)

    out = {}
    if group_by:
        rep = batch.select(list(group_by)).take(rep_idx)
        out.update(rep.columns)

    counts_all = np.bincount(codes, minlength=n_groups)
    minmax_order = None
    if any(a.fn in ("min", "max") for a in aggs):
        minmax_order = np.argsort(codes, kind="stable")  # shared by all specs

    # shared per-column work: sum/avg/count over one column compute its
    # mask, float cast and weighted bincount once
    col_cache: Dict[str, dict] = {}

    def col_work(name: str) -> dict:
        w = col_cache.get(name)
        if w is not None:
            return w
        col = batch.columns[name]
        valid = _valid_mask(col)
        all_valid = bool(valid.all())
        w = {
            "all_valid": all_valid,
            "vcodes": codes if all_valid else codes[valid],
            # values materialize lazily: a count-only aggregate never reads them
            "_data": col.data,
            "_valid": valid,
        }
        col_cache[name] = w
        return w

    def col_vals(w: dict) -> np.ndarray:
        if "vals" not in w:
            w["vals"] = w["_data"] if w["all_valid"] else w["_data"][w["_valid"]]
        return w["vals"]

    def col_counts(w: dict) -> np.ndarray:
        if "cnt" not in w:
            w["cnt"] = (
                counts_all
                if w["all_valid"]
                else np.bincount(w["vcodes"], minlength=n_groups)
            )
        return w["cnt"]

    def col_sums(w: dict) -> np.ndarray:
        if "sums" not in w:
            w["sums"] = np.bincount(
                w["vcodes"],
                weights=col_vals(w).astype(np.float64, copy=False),
                minlength=n_groups,
            )
        return w["sums"]

    for a in aggs:
        dt = output_dtype(a, schema.get(a.column) if a.column else None)
        if a.fn == "count":
            if a.column is None:
                out[a.name] = Column("int64", counts_all.astype(np.int64))
            else:
                out[a.name] = Column(
                    "int64", col_counts(col_work(a.column)).astype(np.int64)
                )
            continue
        col = batch.columns[a.column]
        if a.fn in ("sum", "avg"):
            if is_string(col.dtype_str):
                raise HyperspaceException(f"{a.fn} over string column {a.column}.")
            w = col_work(a.column)
            vals = col_vals(w)
            if a.fn == "sum" and not dt.startswith("float") and _exact_int_sum_needed(vals):
                # exact int64 segment sum: bincount accumulates in float64
                # and corrupts totals past 2^53 (large ids, ns timestamps)
                acc = np.zeros(n_groups, dtype=np.int64)
                np.add.at(acc, w["vcodes"], vals.astype(np.int64))
                out[a.name] = Column(dt, acc.astype(numpy_dtype(dt)))
                continue
            sums = col_sums(w)
            if a.fn == "sum":
                s = sums.astype(numpy_dtype(dt))
                if dt.startswith("float"):
                    # SQL NULL: sum of an all-NULL group is NULL (NaN),
                    # matching avg/min/max of the same group
                    s = np.where(col_counts(w) == 0, np.nan, s)
                out[a.name] = Column(dt, s)
            else:
                with np.errstate(invalid="ignore", divide="ignore"):
                    out[a.name] = Column("float64", sums / col_counts(w))
            continue
        out[a.name] = _segment_minmax(
            codes, col, n_groups, want_max=(a.fn == "max"), order=minmax_order
        )
    return ColumnarBatch(out)


def _join_ranges_native(l_all, r_all, group_by, aggs, lo, counts, r_order):
    """The native single-pass arm for the dense-int-key aggregate over a
    join (Q17's shape): one integer group key column over a span of at
    most ``max(4 * n_l, 2^16)``, aggregates over right-side numeric
    columns only. One ``native.group_agg_ranges`` pass per value column
    replaces the factorize, the per-aggregate bincounts and their
    full-width temporaries. None when the shape is not this one."""
    if len(group_by) != 1:
        return None
    kcol = l_all.columns[group_by[0]]
    if is_string(kcol.dtype_str) or kcol.data.dtype.kind not in "iu":
        return None
    rcols = []
    for a in aggs:
        if a.column is None:
            continue
        if a.column in l_all.column_names or a.column not in r_all.column_names:
            return None  # left-side values take the generic arm
        c = r_all.columns[a.column]
        if is_string(c.dtype_str) or c.data.dtype.kind not in "iuf":
            return None
        if a.column not in rcols:
            rcols.append(a.column)
    n_l = l_all.num_rows
    # int64 BEFORE the subtraction: a narrow key (int8, int16) would wrap
    # across the sign and hand the C++ negative slots
    keys = kcol.data.astype(np.int64, copy=False)
    mn = int(keys.min())
    span = int(keys.max()) - mn + 1
    if span <= 0 or span > max(4 * n_l, 1 << 16):  # _dense's rule
        return None
    offset_keys = keys - mn
    per_col = {}
    rows = None
    for name in rcols:
        vals = r_all.columns[name].data
        if r_order is not None:
            vals = vals[r_order]
        vals = vals.astype(np.float64 if vals.dtype.kind == "f" else np.int64, copy=False)
        per_col[name] = native.group_agg_ranges(offset_keys, lo, counts, vals, span)
        rows = per_col[name][2]
    if rows is None:  # count(*) only
        rows = np.bincount(offset_keys, weights=counts.astype(np.float64),
                           minlength=span).astype(np.int64)
    keep = np.flatnonzero(rows > 0)
    schema = r_all.schema()
    out: Dict[str, Column] = {
        group_by[0]: Column(kcol.dtype_str, (keep + mn).astype(kcol.data.dtype), kcol.vocab)
    }
    for a in aggs:
        if a.column is None:
            out[a.name] = Column("int64", rows[keep])
            continue
        sums, nn, _ = per_col[a.column]
        dt = output_dtype(a, schema[a.column])
        if a.fn == "count":
            out[a.name] = Column("int64", nn[keep])
        elif a.fn == "avg":
            with np.errstate(invalid="ignore", divide="ignore"):
                out[a.name] = Column("float64", sums[keep].astype(np.float64) / nn[keep])
        else:
            s = sums[keep].astype(numpy_dtype(dt))
            if dt.startswith("float"):
                # SQL NULL: sum of an all-NULL group is NULL
                s = np.where(nn[keep] == 0, np.nan, s)
            out[a.name] = Column(dt, s)
    return ColumnarBatch(out)


@metrics.timer("aggregate.join_ranges")
def aggregate_join_ranges(
    l_all: ColumnarBatch,
    r_all: ColumnarBatch,
    group_by: Sequence[str],
    aggs: Sequence[AggSpec],
    lo: np.ndarray,
    counts: np.ndarray,
    r_order,
):
    """Aggregate an inner join from its match ranges — no pair expansion.

    ``(lo, counts, r_order)`` come from joins.bucketed_join_ranges: left
    row i matches right rows ``r_order[lo[i]:lo[i]+counts[i]]`` (``r_order``
    None = identity). An output row of the join replicates left row i
    ``counts[i]`` times, so:

    * count(*) per group        = Σ counts over the group's left rows;
    * sum/count of a LEFT col   = Σ value·counts / Σ valid·counts;
    * sum/count of a RIGHT col  = per-left-row range sums by prefix
      differences over the right values in ``r_order`` (exact int64 —
      wraparound cancels in the difference), or a direct gather when
      every count ≤ 1 (the FK→PK join, where the right key is unique —
      Q17's shape);
    * groups whose total count is 0 do not appear (inner-join semantics).

    The native single-pass arm (``_join_ranges_native``) runs first where
    the shape is its own; it sums float right columns directly. Returns
    None when neither arm supports the shape (min/max, string values,
    float right columns under duplicate matches outside the native arm's
    shape — the float prefix-sum difference loses precision that bincount
    never does; the caller falls back to materialize + hash_aggregate).
    Supported combinations produce hash_aggregate's results, NULL
    semantics included.
    """
    lset = set(l_all.column_names)
    rset = set(r_all.column_names)
    if not group_by or not all(g in lset for g in group_by):
        return None
    n_l = l_all.num_rows
    if n_l == 0 or len(counts) != n_l:
        return None
    uniq_right = bool(counts.max() <= 1) if len(counts) else True
    for a in aggs:
        if a.fn not in ("count", "sum", "avg"):
            return None
    fast = _join_ranges_native(l_all, r_all, group_by, aggs, lo, counts, r_order)
    if fast is not None:
        metrics.incr("aggregate.path.join_fused_native")
        return fast
    for a in aggs:
        if a.column is None:
            continue
        if a.column in lset:
            col = l_all.columns[a.column]
            if a.fn != "count" and is_string(col.dtype_str):
                return None
        elif a.column in rset:
            col = r_all.columns[a.column]
            if is_string(col.dtype_str):
                return None
            if (
                col.data.dtype.kind == "f"
                and not uniq_right
                and a.fn in ("sum", "avg")
            ):
                return None
        else:
            return None

    codes, n_groups, rep = _group_codes(l_all, list(group_by))
    # rows per group: float64 bincount is exact below 2^53 rows — beyond
    # any materializable join
    rows_per_group = np.bincount(
        codes, weights=counts.astype(np.float64), minlength=n_groups
    )
    keep = rows_per_group > 0

    hi = lo + counts
    _range_cache: Dict[str, tuple] = {}
    _left_cache: Dict[tuple, np.ndarray] = {}

    def right_range_sums(name: str):
        """(per-left-row sum, per-left-row non-NULL count) of a right
        column over each match range, exactly. Memoized per column —
        sum+avg over the same column (the Q17 shape) share one pass."""
        if name in _range_cache:
            return _range_cache[name]
        col = r_all.columns[name]
        vals = col.data if r_order is None else col.data[r_order]
        if vals.dtype.kind == "f":
            valid = ~np.isnan(vals)
            v64 = np.where(valid, vals, 0.0).astype(np.float64)
        else:
            valid = np.ones(len(vals), dtype=bool)
            v64 = vals.astype(np.int64)
        if uniq_right:
            pos = np.where(counts > 0, lo, 0)
            hit = counts > 0
            s = np.where(hit, v64[pos], 0)
            nn = np.where(hit & valid[pos], 1, 0).astype(np.int64)
            if vals.dtype.kind == "f":
                s = np.where(nn > 0, s, 0.0)
            _range_cache[name] = (s, nn)
            return _range_cache[name]
        # prefix differences: int64 wraparound cancels exactly; floats
        # were excluded above
        cum = np.concatenate([[0], np.cumsum(v64, dtype=np.int64)])
        ncum = np.concatenate([[0], np.cumsum(valid.astype(np.int64))])
        _range_cache[name] = (cum[hi] - cum[lo], ncum[hi] - ncum[lo])
        return _range_cache[name]

    def group_accumulate(per_left, dt: str, cache_key) -> np.ndarray:
        """Σ per-left contributions per group, exact for int outputs;
        memoized by ``cache_key`` (a column's nn, or sum+avg over one
        column)."""
        if cache_key in _left_cache:
            return _left_cache[cache_key]
        if (not dt.startswith("float") and per_left.dtype.kind in "iu"
                and _exact_int_sum_needed(per_left)):
            acc = np.zeros(n_groups, dtype=np.int64)
            np.add.at(acc, codes, per_left)
        else:
            acc = np.bincount(
                codes, weights=per_left.astype(np.float64), minlength=n_groups
            )
        _left_cache[cache_key] = acc
        return acc

    schema = {**l_all.schema(), **r_all.schema()}
    out: Dict[str, Column] = {}
    key_batch = l_all.select(list(group_by)).take(rep)
    for name, col in key_batch.columns.items():
        out[name] = Column(col.dtype_str, col.data[keep], col.vocab)

    kidx = np.flatnonzero(keep)
    for a in aggs:
        dt = output_dtype(a, schema.get(a.column) if a.column else None)
        if a.column is None:
            out[a.name] = Column("int64", rows_per_group[kidx].astype(np.int64))
            continue
        if a.column in lset:
            col = l_all.columns[a.column]
            if is_string(col.dtype_str):
                valid_l = col.data >= 0
                nn = group_accumulate(
                    np.where(valid_l, counts, 0), "int64", ("nn_l", a.column)
                )
                out[a.name] = Column("int64", nn[kidx].astype(np.int64))
                continue
            if col.data.dtype.kind == "f":
                valid_l = ~np.isnan(col.data)
                v = np.where(valid_l, col.data, 0.0).astype(np.float64)
            else:
                valid_l = np.ones(n_l, dtype=bool)
                v = col.data.astype(np.int64)
            nn = group_accumulate(
                np.where(valid_l, counts, 0), "int64", ("nn_l", a.column)
            )
            if a.fn == "count":
                out[a.name] = Column("int64", nn[kidx].astype(np.int64))
                continue
            sums = group_accumulate(
                v * counts, dt, ("sum_l", a.column, dt.startswith("float"))
            )
        else:
            sums_pl, nn_pl = right_range_sums(a.column)
            nn = group_accumulate(nn_pl, "int64", ("nn_r", a.column))
            if a.fn == "count":
                out[a.name] = Column("int64", nn[kidx].astype(np.int64))
                continue
            sums = group_accumulate(
                sums_pl, dt, ("sum_r", a.column, dt.startswith("float"))
            )
        if a.fn == "avg":
            with np.errstate(invalid="ignore", divide="ignore"):
                out[a.name] = Column("float64", (sums / nn)[kidx])
            continue
        s = sums[kidx].astype(numpy_dtype(dt))
        if dt.startswith("float"):
            # SQL NULL: sum of an all-NULL group is NULL
            s = np.where(nn[kidx] == 0, np.nan, s)
        out[a.name] = Column(dt, s)
    metrics.incr("aggregate.path.join_fused")
    return ColumnarBatch(out)
