"""The plain reference of a filtered group-by: what a scan of the source
rows answers, in plain PyTorch (numpy in, numpy out), independent of the
program under test.

``group_by(cols, where, key, aggs)`` filters the rows by the AND of
``where``'s ``(column, op, value)`` terms, groups them by ``key`` and
returns, for the groups that hold a row and in ascending key order, the
key, ``count`` and each aggregate under the name the program gives it
(``<fn>_<column>``). Counts, integer sums, min and max are exact; float
sums and averages accumulate in ``dtype`` (float64; the control passes
float32). Rows go in blocks, so the temporaries stay small beside the
columns.
"""

from __future__ import annotations

import numpy as np
import torch

_CMP = {
    "<": torch.lt, "<=": torch.le, ">": torch.gt, ">=": torch.ge, "==": torch.eq,
}


def output_name(fn: str, column) -> str:
    return "count" if column is None else f"{fn}_{column}"


class Table:
    """The source columns on ``device`` (ints as int64, floats as
    float64), with each column's (min, max)."""

    def __init__(self, columns: dict, device="cpu"):
        self.device = torch.device(device)
        self.cols = {}
        self.bounds = {}
        for name, a in columns.items():
            a = np.asarray(a)
            kind = torch.float64 if a.dtype.kind == "f" else torch.int64
            self.cols[name] = torch.from_numpy(a).to(self.device, kind)
            self.bounds[name] = (a.min().item(), a.max().item())
        self.n = len(next(iter(columns.values())))


def group_by(table: Table, where, key: str, aggs, dtype=torch.float64,
             block_rows: int = 1 << 24) -> dict:
    lo, hi = table.bounds[key]
    span = int(hi - lo + 1)
    dev = table.device
    count = torch.zeros(span, dtype=torch.int64, device=dev)
    acc = {}
    for fn, c in aggs:
        if c is None:
            continue
        floaty = table.cols[c].dtype.is_floating_point
        if fn in ("sum", "avg"):
            acc.setdefault((c, "sum"), torch.zeros(span, dtype=dtype if floaty else torch.int64,
                                                    device=dev))
        elif fn in ("min", "max"):
            t = table.cols[c].dtype
            fill = torch.finfo(t).max if floaty else torch.iinfo(t).max
            acc.setdefault((c, fn), torch.full((span,), fill if fn == "min" else -fill,
                                               dtype=t, device=dev))
    for s in range(0, table.n, block_rows):
        e = min(s + block_rows, table.n)
        keep = torch.ones(e - s, dtype=torch.bool, device=dev)
        for c, op, v in where:
            keep &= _CMP[op](table.cols[c][s:e], v)
        slot = table.cols[key][s:e][keep] - lo
        count += torch.bincount(slot, minlength=span)
        for (c, op), a in acc.items():
            vals = table.cols[c][s:e][keep]
            if op == "sum":
                a.index_add_(0, slot, vals.to(a.dtype))
            else:
                a.scatter_reduce_(0, slot, vals, "amin" if op == "min" else "amax")
    present = torch.nonzero(count > 0).flatten()
    n = count[present]
    out = {key: (present + lo).cpu().numpy(), "count": n.cpu().numpy()}
    for fn, c in aggs:
        if c is None:
            continue
        if fn == "avg":
            v = acc[(c, "sum")][present].to(dtype) / n
        else:
            v = acc[(c, "sum" if fn == "sum" else fn)][present]
        out[output_name(fn, c)] = v.cpu().numpy()
    return out
