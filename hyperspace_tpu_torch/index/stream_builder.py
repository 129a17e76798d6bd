"""Host helpers of the streaming build that optimize's per-bucket merge
uses: the sort encoding of a column and the merge of key-sorted runs.

Parity: ``hyperspace_tpu.index.stream_builder`` (``sort_encoding`` and
``merge_sorted_runs``). The streaming build itself is not ported yet.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..storage.columnar import Column, ColumnarBatch, is_string


def sort_encoding(col: Column) -> np.ndarray:
    """An integer array whose ascending order equals the index sort order
    of the column: strings by dictionary code (order-preserving within a
    shared vocab), float64 by the ordered-int64 encoding, float32 by the
    same bit trick in 32 bits (-0.0 and NaN included), everything else by
    raw value."""
    if is_string(col.dtype_str):
        return col.data
    d = col.data
    if d.dtype == np.float64:
        from ..ops.floatbits import f64_to_ordered_i64

        return f64_to_ordered_i64(d)
    if d.dtype == np.float32:
        from ..ops.floatbits import f32_to_ordered_i32

        return f32_to_ordered_i32(d)
    return d


def merge_sorted_runs(runs: List[ColumnarBatch], key_names: List[str]) -> ColumnarBatch:
    """Merge key-sorted batches into one key-sorted batch.
    ``ColumnarBatch.concat`` re-encodes string columns onto a shared sorted
    vocab (order-preserving, so each run stays sorted); the runs then merge
    by the stable searchsorted tournament (ops.build.merge_sorted_orders).
    Ties keep run order. Key shapes the int64 composite cannot express
    (63-bit overflow) take a stable lexsort instead."""
    if len(runs) == 1:
        return runs[0]
    merged = ColumnarBatch.concat(runs)
    if merged.num_rows <= 1:
        return merged
    keys = [sort_encoding(merged.columns[k]) for k in key_names]
    if len(keys) == 1:
        comp = keys[0]  # one key: its encoding is directly comparable
    else:
        from ..ops.build import _pack_sort_keys

        comp = _pack_sort_keys(keys, None, 0)
    if comp is None:
        order = np.lexsort(list(reversed(keys)))  # last key is primary
    else:
        from ..ops.build import merge_sorted_orders

        slices = []
        lo = 0
        for r in runs:
            hi = lo + r.num_rows
            slices.append((comp[lo:hi], np.arange(lo, hi, dtype=np.int64)))
            lo = hi
        order = merge_sorted_orders(slices)
    return merged.take(order)
