"""Inner equi-join execution over columnar batches.

Counterpart of ``hyperspace_tpu.exec.joins``. The bucketed sort-merge join
is the query-side payoff of the index design (JoinIndexRule.scala:39-50:
two indexes bucketed+sorted on the join keys need no shuffle): bucket b
of both indexes lives in its own TCB file, so equal keys never cross
buckets and the common buckets join in ONE merge.

Join keys reduce to exact int64 *join codes* (numerics through
value-preserving casts, strings through a unified dictionary). The match
ranges come from ``segmented_join_ranges``, the reference's routing
ladder over the common buckets' segments:

* right segments ascending (index data is key-sorted per bucket by
  construction) and the flat remap fits int64: the codes remapped to
  ``segment * span + (code - min)`` are globally sorted, so ONE pass of
  the sorted-intersect kernel (ops.kernels.sorted_intersect_counts, K2 and
  its fence build) over them gives every range with no argsort
  (``join.path.presorted_merge_flat``). The reference walks them in C++
  instead: the route differs, not the result;
* where K2's plan declines (the flat codes span more than int32) or no
  flat remap fits, and both sides are ascending: the native two-pointer
  walk over the segments (``native.smj_ranges``,
  ``join.path.native_smj_ranges``);
* where K2 declines and only the right side is ascending: the host
  binary search over the flat codes (``join.path.host_searchsorted``),
  else one per segment (``join.path.presorted_merge``);
* right segments not ascending: a stable argsort of the right codes and
  K2 (``merge_join_ranges``: ``join.path.device_kernel``).

The ranges are expanded in C++ (``native``, the runtime of
``native/tcb_io.cc``): the materializing join over two presorted sides
fuses the expansion with the output gather (``native.smj_join_gather``,
``join.path.native_smj_gather``); elsewhere, wherever right positions
index the right side directly, ``native.expand_pairs``
(``join.path.native_expand_pairs``) writes the pair arrays. The argsort
route expands through ``_expand_ranges`` and ``r_order``. The pairs, and
their order, are the same on every arm (the argsort is stable and equal
codes never cross buckets).

Two cross-query caches keep a repeat join's host work: the setup (the
common buckets' concatenation, codes, segment bounds and sortedness) and
the presorted sides' ranges with their prefix, keyed by the sides' cache
tokens (``exec/executor.py:BucketGroups``) in one byte-capped LRU
(``exec/bytecache.py``, ``HYPERSPACE_TPU_TORCH_JOIN_CACHE_MB``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import native
from ..exceptions import HyperspaceException
from ..ops import DeviceLike
from ..storage.columnar import Column, ColumnarBatch, is_string, unify_dictionaries
from ..telemetry.metrics import metrics
from .bytecache import ByteCappedLru, batch_nbytes, join_cache_budget


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


def _k2_counts(l_codes: np.ndarray, r_sorted: np.ndarray, device: DeviceLike):
    """K2's ranges through ``ops.kernels.sorted_intersect_counts``."""
    finish = _k2_counts_deferred(l_codes, r_sorted, device)
    return None if finish is None else finish()


def _k2_counts_deferred(l_codes: np.ndarray, r_sorted: np.ndarray, device: DeviceLike):
    """K2 issued, its ``finish()`` (``ops.kernels.sorted_intersect_counts_
    deferred``), or None where its plan declines. Where the reference's
    kernel latch and device probe send K2 to the host's searchsorted, this
    raises: a card the probe found unreachable raises
    DeviceUnavailableError here, and a failed launch raises from K2."""
    from ..ops import kernels, resolve_device
    from ..utils.deviceprobe import latched_verdict, unavailable_reason

    if resolve_device(device).type == "cuda" and latched_verdict() is False:
        from ..exceptions import DeviceUnavailableError

        raise DeviceUnavailableError(unavailable_reason())
    return kernels.sorted_intersect_counts_deferred(l_codes, r_sorted, device)


def merge_join_ranges(
    l_codes: np.ndarray, r_codes: np.ndarray, device: DeviceLike = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Match ranges (lo, counts, r_order) for two (unsorted) code arrays:
    stable-sort the right side, then the sorted-intersect kernel on
    ``device``. Where the reference's plan declines (the joint key range
    overflows int32, or more than a quarter of the left tiles are wide)
    host binary search serves, as in the reference. The arm taken is
    counted under ``join.path.*``."""
    return merge_join_ranges_deferred(l_codes, r_codes, device)()


def merge_join_ranges_deferred(
    l_codes: np.ndarray, r_codes: np.ndarray, device: DeviceLike = None
):
    """``merge_join_ranges`` issued without waiting: the right side's
    stable argsort and K2's launch happen here, and the returned
    ``finish()`` waits and gives (lo, counts, r_order). The mesh's join
    issues every shard's before it waits on any. ``finish.h2d_bytes`` and
    ``finish.d2h_bytes`` are what K2's launch moved (0 where its plan
    declined)."""
    r_order = np.argsort(r_codes, kind="stable")
    r_sorted = r_codes[r_order]
    k2 = _k2_counts_deferred(l_codes, r_sorted, device)

    def finish():
        if k2 is not None:
            metrics.incr("join.path.device_kernel")
            lo, counts = k2()
        else:
            metrics.incr("join.path.host_searchsorted")
            lo = np.searchsorted(r_sorted, l_codes, side="left")
            counts = np.searchsorted(r_sorted, l_codes, side="right") - lo
        return lo, counts, r_order

    finish.h2d_bytes = 0 if k2 is None else k2.h2d_bytes
    finish.d2h_bytes = 0 if k2 is None else k2.d2h_bytes
    return finish


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


def _segments_sorted(codes: np.ndarray, bounds: np.ndarray) -> bool:
    """True when every [bounds[k], bounds[k+1]) slice of ``codes`` is
    ascending: descents are permitted only at segment boundaries."""
    if len(codes) < 2:
        return True
    descents = np.flatnonzero(np.diff(codes) < 0)
    if not len(descents):
        return True
    allowed = set((np.asarray(bounds[1:-1]) - 1).tolist())
    return all(int(d) in allowed for d in descents)


def merge_join_indices_segmented(
    l_codes: np.ndarray,
    r_codes: np.ndarray,
    l_bounds: np.ndarray,
    r_bounds: np.ndarray,
    presorted: Optional[Tuple[bool, bool]] = None,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Inner-join row indices for segment-aligned codes (segment k of the
    left joins only segment k of the right): the expanded form of
    ``segmented_join_ranges``, in C++ where right positions index the right
    side directly."""
    lo, counts, r_order = segmented_join_ranges(
        l_codes, r_codes, l_bounds, r_bounds, presorted=presorted, device=device
    )
    if r_order is None:
        metrics.incr("join.path.native_expand_pairs")
        return native.expand_pairs(lo, counts)
    return _expand_ranges(lo, counts, r_order)


def segmented_join_ranges(
    l_codes: np.ndarray,
    r_codes: np.ndarray,
    l_bounds: np.ndarray,
    r_bounds: np.ndarray,
    presorted: Optional[Tuple[bool, bool]] = None,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """The routing ladder (module docstring) producing (lo, counts,
    r_order) for segment-aligned codes, shared by the materializing join
    (which expands) and the aggregate fusion (which never does).
    ``presorted`` carries each side's already-computed sortedness;
    ``r_order`` is None where right positions index the right side
    directly (the presorted arms)."""
    if presorted is None:
        presorted = (
            _segments_sorted(l_codes, l_bounds),
            _segments_sorted(r_codes, r_bounds),
        )
    if not presorted[1]:
        return merge_join_ranges(l_codes, r_codes, device)
    flat = _flat_segment_remap(l_codes, r_codes, l_bounds, r_bounds)
    if flat is not None:
        l_flat, r_flat = flat
        res = _k2_counts(l_flat, r_flat, device)
        if res is not None:
            metrics.incr("join.path.presorted_merge_flat")
            return res[0], res[1], None
    if presorted[0]:
        metrics.incr("join.path.native_smj_ranges")
        lo, counts = native.smj_ranges(l_codes, r_codes, l_bounds, r_bounds)
        return lo, counts, None
    if flat is not None:
        metrics.incr("join.path.host_searchsorted")
        lo = np.searchsorted(r_flat, l_flat, side="left")
        counts = np.searchsorted(r_flat, l_flat, side="right") - lo
        return lo, counts, None
    metrics.incr("join.path.presorted_merge")
    lo = np.empty(len(l_codes), dtype=np.int64)
    counts = np.empty(len(l_codes), dtype=np.int64)
    for k in range(len(l_bounds) - 1):
        ls, le = int(l_bounds[k]), int(l_bounds[k + 1])
        rs, re = int(r_bounds[k]), int(r_bounds[k + 1])
        seg = r_codes[rs:re]
        q = l_codes[ls:le]
        left_pos = np.searchsorted(seg, q, side="left")
        lo[ls:le] = rs + left_pos
        counts[ls:le] = np.searchsorted(seg, q, side="right") - left_pos
    return lo, counts, None


def _flat_segment_remap(
    l_codes: np.ndarray,
    r_codes: np.ndarray,
    l_bounds: np.ndarray,
    r_bounds: np.ndarray,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Segment-aligned codes remapped into one global order,
    ``code -> segment * span + (code - min)``, or None when
    ``n_segments * span`` does not fit int64 (float bit patterns or
    factorized codes with huge spans) or a side is empty."""
    if len(l_codes) == 0 or len(r_codes) == 0:
        return None
    n_seg = len(l_bounds) - 1
    mn = int(min(l_codes.min(), r_codes.min()))
    mx = int(max(l_codes.max(), r_codes.max()))
    span = mx - mn + 1
    if span <= 0 or n_seg * span >= (1 << 62):
        return None
    l_seg = np.repeat(np.arange(n_seg, dtype=np.int64), np.diff(np.asarray(l_bounds)))
    r_seg = np.repeat(np.arange(n_seg, dtype=np.int64), np.diff(np.asarray(r_bounds)))
    sp = np.int64(span)
    return l_seg * sp + (l_codes - mn), r_seg * sp + (r_codes - mn)


# The setup of a join over cross-query-cached sides is a pure function of
# (the sides' file identities, projections, predicates, join keys): index
# files are immutable. Keyed by the sides' cache tokens; one budget
# (HYPERSPACE_TPU_TORCH_JOIN_CACHE_MB) bounds this LRU and, separately,
# the groups cache, so the join caches hold at most twice the knob. The
# entry cap covers setup and ranges entries (2 per join shape).
def _setup_cache_budget() -> int:
    return join_cache_budget()


_SETUP_CACHE = ByteCappedLru(_setup_cache_budget, entry_cap=24)


def _setup_nbytes(setup) -> int:
    l_all, r_all, l_codes, r_codes, _lb, _rb, _ps = setup
    return l_codes.nbytes + r_codes.nbytes + batch_nbytes(l_all) + batch_nbytes(r_all)


def reset_setup_cache() -> None:
    _SETUP_CACHE.reset()


def _cached_smj_ranges(cache_key, l_codes, r_codes, l_bounds, r_bounds, presorted,
                       device: DeviceLike = None):
    """``(lo, counts, off, total)`` of a setup whose sides are both
    presorted: from the ranges cache under ``(cache_key, "ranges")``
    (``join.ranges_cache.hit``: no kernel and no walk runs), or the ranges
    of ``segmented_join_ranges`` (K2, or the native walk where K2
    declines) made contiguous int64 once, with their prefix, and stored
    there, charged lo + counts + off bytes. The reference caches its
    native range walk under the same key."""
    rk = (cache_key, "ranges") if cache_key is not None else None
    if rk is not None:
        hit = _SETUP_CACHE.get(rk)
        if hit is not None:
            metrics.incr("join.ranges_cache.hit")
            return hit
    lo, counts, _ = segmented_join_ranges(
        l_codes, r_codes, l_bounds, r_bounds, presorted=presorted, device=device
    )
    lo, counts = native.as_int64(lo), native.as_int64(counts)
    off, total = native.range_offsets(counts)
    ranges = (lo, counts, off, total)
    if rk is not None:
        _SETUP_CACHE.put(rk, ranges, int(lo.nbytes + counts.nbytes + off.nbytes))
    return ranges


def _bucketed_join_setup(left_by_bucket, right_by_bucket, l_keys, r_keys):
    """(setup, cache_key): the common buckets' concatenation per side in
    ascending bucket order, their join codes, segment bounds and per-side
    sortedness — ``(l_all, r_all, l_codes, r_codes, l_bounds, r_bounds,
    presorted)`` — shared by the materializing join and the range-only
    (aggregate-fused) join; ``(None, None)`` when no bucket is common.
    Hash partitioning puts equal keys in one bucket, so the concatenation
    introduces no false matches. Every consumer treats the setup as
    immutable, which is what makes the cross-query cache sound: sides that
    carry cache tokens hit it (``join.setup_cache.hit``)."""
    l_token = getattr(left_by_bucket, "cache_token", None)
    r_token = getattr(right_by_bucket, "cache_token", None)
    cache_key = None
    if l_token is not None and r_token is not None:
        cache_key = (l_token, r_token, tuple(l_keys), tuple(r_keys))
        hit = _SETUP_CACHE.get(cache_key)
        if hit is not None:
            metrics.incr("join.setup_cache.hit")
            return hit, cache_key
    common = sorted(set(left_by_bucket) & set(right_by_bucket))
    if not common:
        metrics.incr("join.path.no_common_buckets")
        return None, None
    l_batches = [left_by_bucket[b] for b in common]
    r_batches = [right_by_bucket[b] for b in common]
    l_all = ColumnarBatch.concat(l_batches)
    r_all = ColumnarBatch.concat(r_batches)
    _check_no_overlap(l_all, r_all)
    l_codes, r_codes = join_codes(l_all, r_all, l_keys, r_keys)
    l_bounds = np.cumsum([0] + [b.num_rows for b in l_batches])
    r_bounds = np.cumsum([0] + [b.num_rows for b in r_batches])
    presorted = (
        _segments_sorted(l_codes, l_bounds),
        _segments_sorted(r_codes, r_bounds),
    )
    setup = (l_all, r_all, l_codes, r_codes, l_bounds, r_bounds, presorted)
    if cache_key is not None:
        if _SETUP_CACHE.put(cache_key, setup, _setup_nbytes(setup)) is setup:
            metrics.incr("join.setup_cache.stored")
    return setup, cache_key


@metrics.timer("join.bucketed")
def bucketed_join_pairs(
    left_by_bucket: Dict[int, ColumnarBatch],
    right_by_bucket: Dict[int, ColumnarBatch],
    l_keys: List[str],
    r_keys: List[str],
    device: DeviceLike = None,
) -> List[ColumnarBatch]:
    """Bucket-batched inner join over bucket-aligned data — the
    shuffle-free SMJ: the common buckets merged in ONE pass of the
    routing ladder (module docstring). Both sides presorted and every
    column 4 or 8 bytes wide: the ranges (from the ranges cache, or K2's)
    expand and gather the output in one C++ pass
    (``join.path.native_smj_gather``)."""
    setup, cache_key = _bucketed_join_setup(left_by_bucket, right_by_bucket, l_keys, r_keys)
    if setup is None:
        return []
    l_all, r_all, l_codes, r_codes, l_bounds, r_bounds, presorted = setup
    l_data = {n: c.data for n, c in l_all.columns.items()}
    r_data = {n: c.data for n, c in r_all.columns.items()}
    if presorted[0] and presorted[1] and native.smj_gather_supported(l_data, r_data):
        # the ranges (cached, or K2's) expand and gather in one C++ pass:
        # no pair arrays, no numpy gather
        ranges = _cached_smj_ranges(cache_key, l_codes, r_codes, l_bounds, r_bounds,
                                    presorted, device)
        l_out, r_out, total = native.smj_join_gather(
            l_codes, r_codes, l_bounds, r_bounds, l_data, r_data, ranges=ranges)
        metrics.incr("join.path.native_smj_gather")
        if total == 0:
            return []
        out: Dict[str, Column] = {}
        for n, c in l_all.columns.items():
            out[n] = Column(c.dtype_str, l_out[n], c.vocab)
        for n, c in r_all.columns.items():
            out[n] = Column(c.dtype_str, r_out[n], c.vocab)
        return [ColumnarBatch(out)]
    l_idx, r_idx = merge_join_indices_segmented(
        l_codes, r_codes, l_bounds, r_bounds, presorted=presorted, device=device
    )
    out = {}
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
    positions ``r_order[lo[i]:lo[i]+counts[i]]`` (``r_order`` None:
    positions index ``r_all`` directly). The aggregate-over-join fusion
    consumes this: sums and counts over match ranges need only prefix
    arithmetic. Both sides presorted: the ranges come from the ranges
    cache or the presorted route and are stored there. Returns None when
    there are no common buckets."""
    setup, cache_key = _bucketed_join_setup(left_by_bucket, right_by_bucket, l_keys, r_keys)
    if setup is None:
        return None
    l_all, r_all, l_codes, r_codes, l_bounds, r_bounds, presorted = setup
    if presorted[0] and presorted[1]:
        lo, counts, _off, _total = _cached_smj_ranges(cache_key, l_codes, r_codes, l_bounds,
                                                      r_bounds, presorted, device)
        return l_all, r_all, lo, counts, None
    lo, counts, r_order = segmented_join_ranges(
        l_codes, r_codes, l_bounds, r_bounds, presorted=presorted, device=device
    )
    return l_all, r_all, lo, counts, r_order
