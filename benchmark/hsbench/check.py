"""The comparison that decides ``correct``: every answer the window
returned, held to the plain reference's answer to the same query.

An answer kept whole is compared column by column: the group keys, the
counts, integer sums, min and max exactly, float sums and averages by
their largest relative gap. Of an answer too large to keep (more groups
than ``whole_rows``, not picked by the seed's draw), its number of groups
and its total count are compared exactly. Three numbers come out, each
with its limit: ``failed`` (queries that raised or never returned),
``mismatch`` (answers with an exact part wrong) and ``float_rel_err``.
"""

from __future__ import annotations

import numpy as np


def as_columns(batch) -> dict:
    """A ColumnarBatch's columns as numpy arrays."""
    return {n: np.asarray(batch.columns[n].data) for n in batch.column_names}


def summary(cols: dict) -> tuple:
    return len(cols["count"]), int(np.asarray(cols["count"], dtype=np.int64).sum())


def compare(got: dict, want: dict, key: str):
    """(exact parts equal, largest relative gap of the float columns). An
    answer whose columns or groups differ, or with a float that is not
    finite, fails the exact parts and has no gap."""
    if sorted(got) != sorted(want) or len(got[key]) != len(want[key]):
        return False, 0.0
    order = np.argsort(got[key], kind="stable")
    exact, gap = True, 0.0
    for name, w in want.items():
        g = np.asarray(got[name])[order]
        w = np.asarray(w)
        if w.dtype.kind == "f":
            g = g.astype(np.float64)
            if not np.isfinite(g).all():
                return False, 0.0
            rel = np.abs(g - w) / np.maximum(np.abs(w), np.finfo(np.float64).tiny)
            gap = max(gap, float(rel.max(initial=0.0)))
        elif not np.array_equal(g.astype(np.int64), w.astype(np.int64)):
            exact = False
    return exact, gap


def judge(records, failed: int, reference, limits: dict) -> dict:
    """``records``: (query id, answer columns or None, summary, ...) of every
    answered query; ``reference(query id)``: the reference's columns and
    group key. Returns the numbers with their limits and ``correct``."""
    mismatch, gap, whole = 0, 0.0, 0
    for qid, cols, summ, *_times in records:
        want, key = reference(qid)
        if cols is None:
            ok = summ == summary(want)
        else:
            whole += 1
            ok, g = compare(cols, want, key)
            gap = max(gap, g)
        mismatch += 0 if ok else 1
    numbers = {"failed": failed, "mismatch": mismatch, "float_rel_err": gap}
    correct = all(numbers[k] <= limits[k] for k in numbers)
    return {"correct": correct, "numbers": numbers, "limits": dict(limits),
            "answers": len(records), "whole": whole}
