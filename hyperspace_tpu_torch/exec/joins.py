"""Inner equi-join execution over columnar batches.

Counterpart of ``hyperspace_tpu.exec.joins``. The bucketed sort-merge join
is the query-side payoff of the index design (JoinIndexRule.scala:39-50:
two indexes bucketed+sorted on the join keys need no shuffle): bucket b
of both indexes lives in its own TCB file, so equal keys never cross
buckets and the common buckets join in ONE merge.

Join keys reduce to exact int64 *join codes* (numerics through
value-preserving casts, strings through a unified dictionary). The match
ranges come from a stable argsort of the right codes and the
sorted-intersect kernel (ops.kernels.sorted_intersect_counts) on the
session's device. The reference routes presorted bucket segments to its
native C++ merge or host binary search instead; the pairs, and their
order, are the same (the argsort is stable and equal codes never cross
buckets).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..exceptions import HyperspaceException
from ..ops import DeviceLike
from ..storage.columnar import Column, ColumnarBatch, is_string, unify_dictionaries
from ..telemetry.metrics import metrics


def _exact_codes(l_col: Column, r_col: Column) -> Tuple[np.ndarray, np.ndarray]:
    """Map one key-column pair to exact int64 codes, comparable across the
    two sides."""
    if is_string(l_col.dtype_str) != is_string(r_col.dtype_str):
        raise HyperspaceException("Join key dtype mismatch (string vs non-string).")
    if is_string(l_col.dtype_str):
        lu, ru = unify_dictionaries([l_col, r_col])
        return lu.data.astype(np.int64), ru.data.astype(np.int64)
    l, r = l_col.data, r_col.data
    if (l.dtype.kind == "f") != (r.dtype.kind == "f"):
        int_side = r if l.dtype.kind == "f" else l
        if int_side.dtype.itemsize > 4:
            # 64-bit ints above 2^53 are not exactly representable in
            # float64; refusing beats silently collapsing distinct keys
            raise HyperspaceException(
                f"Join key dtype mismatch ({l.dtype} vs {r.dtype}): exact "
                "comparison between 64-bit integer and float keys is not "
                "supported."
            )
        l, r = l.astype(np.float64), r.astype(np.float64)
    if l.dtype.kind == "f":
        # SQL join semantics: NaN equals nothing, itself included, so each
        # side's NaN rows get a side-distinct sentinel
        from ..ops.floatbits import NAN_KEY_LEFT, NAN_KEY_RIGHT, float_key_codes

        lf, lnan = float_key_codes(l)
        rf, rnan = float_key_codes(r)
        if lnan.any():
            lf = np.where(lnan, NAN_KEY_LEFT, lf)
        if rnan.any():
            rf = np.where(rnan, NAN_KEY_RIGHT, rf)
        return lf, rf
    return l.astype(np.int64), r.astype(np.int64)


def join_codes(
    left: ColumnarBatch,
    right: ColumnarBatch,
    l_keys: List[str],
    r_keys: List[str],
) -> Tuple[np.ndarray, np.ndarray]:
    """Composite join codes: single key → its exact codes; multi-key →
    joint factorization of the stacked key tuples (exact, collision-free)."""
    pairs = [
        _exact_codes(left.columns[lk], right.columns[rk])
        for lk, rk in zip(l_keys, r_keys)
    ]
    if len(pairs) == 1:
        return pairs[0]
    l_stack = np.stack([p[0] for p in pairs], axis=1)
    r_stack = np.stack([p[1] for p in pairs], axis=1)
    both = np.concatenate([l_stack, r_stack], axis=0)
    _, inverse = np.unique(both, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    n_l = len(l_stack)
    return inverse[:n_l].astype(np.int64), inverse[n_l:].astype(np.int64)


def _expand_ranges(
    lo: np.ndarray, counts: np.ndarray, r_order: Optional[np.ndarray]
) -> Tuple[np.ndarray, np.ndarray]:
    """Expand per-left-row match ranges [lo, lo+count) into (l_idx, r_idx)
    pair arrays; ``r_order`` maps sorted-right positions back to original
    rows (None = right positions are already original row indices)."""
    total = int(counts.sum())
    if total == 0:
        return np.array([], dtype=np.int64), np.array([], dtype=np.int64)
    l_idx = np.repeat(np.arange(len(lo), dtype=np.int64), counts)
    offsets = np.cumsum(counts) - counts
    r_pos = np.arange(total, dtype=np.int64) + np.repeat(lo - offsets, counts)
    return l_idx, r_pos if r_order is None else r_order[r_pos]


def merge_join_ranges(
    l_codes: np.ndarray, r_codes: np.ndarray, device: DeviceLike = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Match ranges (lo, counts, r_order) for two (unsorted) code arrays:
    stable-sort the right side, then the sorted-intersect kernel on
    ``device``. Where the reference's plan declines (the joint key range
    overflows int32, or more than a quarter of the left tiles are wide)
    host binary search serves, as in the reference. The arm taken is
    counted under ``join.path.*``."""
    from ..ops import kernels

    r_order = np.argsort(r_codes, kind="stable")
    r_sorted = r_codes[r_order]
    res = kernels.sorted_intersect_counts(l_codes, r_sorted, device)
    if res is not None:
        metrics.incr("join.path.device_kernel")
        lo, counts = res
    else:
        metrics.incr("join.path.host_searchsorted")
        lo = np.searchsorted(r_sorted, l_codes, side="left")
        counts = np.searchsorted(r_sorted, l_codes, side="right") - lo
    return lo, counts, r_order


def merge_join_indices(
    l_codes: np.ndarray, r_codes: np.ndarray, device: DeviceLike = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Inner-join row indices for two (unsorted) code arrays — the
    expanded form of merge_join_ranges."""
    lo, counts, r_order = merge_join_ranges(l_codes, r_codes, device)
    return _expand_ranges(lo, counts, r_order)


def _check_no_overlap(left: ColumnarBatch, right: ColumnarBatch) -> None:
    overlap = set(left.column_names) & set(right.column_names)
    if overlap:
        raise HyperspaceException(
            f"Join output would duplicate columns {sorted(overlap)}; project "
            "them away or rename first."
        )


def inner_join(
    left: ColumnarBatch,
    right: ColumnarBatch,
    l_keys: List[str],
    r_keys: List[str],
    device: DeviceLike = None,
) -> ColumnarBatch:
    """Inner equi-join; output columns = left's then right's."""
    _check_no_overlap(left, right)
    l_codes, r_codes = join_codes(left, right, l_keys, r_keys)
    l_idx, r_idx = merge_join_indices(l_codes, r_codes, device)
    out: Dict[str, Column] = {}
    out.update(left.take(l_idx).columns)
    out.update(right.take(r_idx).columns)
    return ColumnarBatch(out)


def _bucketed_join_setup(
    left_by_bucket: Dict[int, ColumnarBatch],
    right_by_bucket: Dict[int, ColumnarBatch],
    l_keys: List[str],
    r_keys: List[str],
):
    """Common-bucket concat + join codes, shared by the materializing join
    and the range-only (aggregate-fused) join: (l_all, r_all, l_codes,
    r_codes), or None when no bucket is common. Only the common buckets
    join; they are concatenated per side in ascending bucket order, and
    hash partitioning guarantees equal keys share a bucket id, so the
    concatenation introduces no false matches. The reference keeps this
    setup in a cross-query cache, which is not ported."""
    common = sorted(set(left_by_bucket) & set(right_by_bucket))
    if not common:
        metrics.incr("join.path.no_common_buckets")
        return None
    l_all = ColumnarBatch.concat([left_by_bucket[b] for b in common])
    r_all = ColumnarBatch.concat([right_by_bucket[b] for b in common])
    _check_no_overlap(l_all, r_all)
    l_codes, r_codes = join_codes(l_all, r_all, l_keys, r_keys)
    return l_all, r_all, l_codes, r_codes


def bucketed_join_pairs(
    left_by_bucket: Dict[int, ColumnarBatch],
    right_by_bucket: Dict[int, ColumnarBatch],
    l_keys: List[str],
    r_keys: List[str],
    device: DeviceLike = None,
) -> List[ColumnarBatch]:
    """Bucket-batched inner join over bucket-aligned data — the
    shuffle-free SMJ: the common buckets merged in ONE kernel launch."""
    setup = _bucketed_join_setup(left_by_bucket, right_by_bucket, l_keys, r_keys)
    if setup is None:
        return []
    l_all, r_all, l_codes, r_codes = setup
    l_idx, r_idx = merge_join_indices(l_codes, r_codes, device)
    out: Dict[str, Column] = {}
    out.update(l_all.take(l_idx).columns)
    out.update(r_all.take(r_idx).columns)
    j = ColumnarBatch(out)
    return [j] if j.num_rows else []


@metrics.timer("join.bucketed_ranges")
def bucketed_join_ranges(
    left_by_bucket: Dict[int, ColumnarBatch],
    right_by_bucket: Dict[int, ColumnarBatch],
    l_keys: List[str],
    r_keys: List[str],
    device: DeviceLike = None,
):
    """Match RANGES of the bucketed inner join, never the pair arrays:
    (l_all, r_all, lo, counts, r_order) where left row i matches right
    rows ``r_order[lo[i]:lo[i]+counts[i]]``. The aggregate-over-join
    fusion consumes this: sums and counts over match ranges need only
    prefix arithmetic, not the expanded (l_idx, r_idx) pairs and the
    gathers they feed. The ranges come from merge_join_ranges (the
    sorted-intersect kernel on ``device``), so ``r_order`` is never None
    here, where the reference's native arm returns None for presorted
    segments. Returns None when there are no common buckets."""
    setup = _bucketed_join_setup(left_by_bucket, right_by_bucket, l_keys, r_keys)
    if setup is None:
        return None
    l_all, r_all, l_codes, r_codes = setup
    lo, counts, r_order = merge_join_ranges(l_codes, r_codes, device)
    return l_all, r_all, lo, counts, r_order
