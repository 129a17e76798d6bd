"""The window's queries' least device time over the device's busy time.

A query's least time is the bytes its work needs at the cell's sizes
over the card's published memory rate (``hsbench/peaks.py``): each
column its predicate, group key and aggregates read, once, at its
resident size (int columns as 4-byte planes, or frame-of-reference packed
on the compressed tier; float64 as 8 bytes), plus the group table written
once (a slot for each key of the group column's domain, 8 bytes for the
count and each distinct sum, min and max). Operations bound nothing here:
a row costs a few compares and adds against 16 bytes read. The count is
of the work, not of the kernels that run it.
"""

from hsbench.peaks import bound_s, packed_plane_bytes


def column_bytes(ctx, name: str) -> int:
    n = ctx["rows"]["lineitem"]
    if name not in ctx["stats"]:  # float64
        return 8 * n
    if ctx["tier"] == "compressed":
        lo, hi = ctx["stats"][name]
        return packed_plane_bytes(n, lo, hi)
    return 4 * n


def query_bytes(ctx, shape) -> int:
    lo, hi = ctx["stats"][shape.group_by]
    vectors = 1 + len({(c, "sum" if fn in ("sum", "avg") else fn)
                       for fn, c in shape.aggs if c is not None})
    return (sum(column_bytes(ctx, c) for c in shape.columns())
            + 8 * vectors * (hi - lo + 1))


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["busy_s"] <= 0:
        return None
    shapes = ctx["mix"].shapes
    per_shape = [bound_s(query_bytes(ctx, s))[0] for s in shapes]
    least = sum(per_shape[qid[0]] for qid, *_rest in ctx["completed"])
    return least / tr["busy_s"] * 100.0
