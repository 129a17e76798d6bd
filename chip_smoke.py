#!/usr/bin/env python3
"""chip_smoke.py — the PyTorch/CUDA port's main path on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py [--seed 0] [--scale 1.0] [--phases kernels,main,...]

It needs a CUDA card and exits non-zero, printing no result, without one
(or without the ``hyperspace_tpu_torch`` package beside it).
``--phases`` takes a comma list of ``kernels``, ``main``, ``aggregate``,
``resident``, ``front_end``, ``lifecycle``, ``hybrid`` and ``streaming``
(default: all, in that order; aggregate, resident and front_end run in the
main path's session and bring ``main``). Phases:

1. header — the card's name and power limit (``nvidia-smi``); the CUDA
   kernels build from ``hyperspace_tpu_torch/csrc`` (timed as set-up),
   and ``ptxas -v``'s registers, stack frame and spills per kernel;
2. kernels — each kernel against its plain torch version on the card, at
   the main path's shapes, exact equality; times (median of repeats, CUDA
   events around the wrapper call; and the kernel's own device time from
   torch.profiler), the plain version's time, the library call's time
   where one exists, and the least time the card could take (its bound).
   Device times are taken after an L2 flush. K1 also runs at one index
   file's shape (30,006 rows), over a 599-instruction IN chain (staged in
   shared memory), a program 64 stack slots deep, and ragged lengths from
   1 to 200,003 rows (each on a random sample of the rows), under the
   range filter and under predicates over 5 and 18 columns (18: more
   addresses than the kernel's parameter block holds); at one file's
   shape the range filter's and the IN chain's host dispatch is timed
   step by step. K1c (block counts) also runs over the 18 columns and
   over a 3 GiB table made on the card (3 int32 columns x 2^28 rows). K2
   runs at the Q3 join's shapes (its device time holds the fence build
   its wrapper launches first; both are also timed alone), is held on
   every padded row against its span semantics as well, and runs K2's
   edge cases (``ops/k2_cases.py``: runs of 9 to 5,000 equal keys, keys
   on fences, spans of 64 and 1, shuffled tiles, ragged sides, pad rows);
   ``ptxas -v`` must show no stack frame and no spills. K1
   and K2 are also timed over operands uploaded once
   (``resident_mask_fn``, ``resident_sorted_intersect``,
   ``resident_smj_amortized``), and the fused aggregate-over-join is held
   against numpy. K1p (K1c over bit-packed planes) runs every width 1 to
   16 bits with negative frames, literals off the frame, packed, raw and
   f64 planes in one program, staged programs and rows ending mid-word,
   then the edges of its staged design (a 2^20-row window, one block, a
   block count off the persistent grid, sub-tile plans over 12 raw + 4
   packed, 40 raw and 18 planes, a 64-slot program, every sub-tile from
   8192 to 128 rows forced), and is timed at li_st's packed shape and at
   one streaming window, each beside K1c at the same rows raw;
   K1h (base and delta in one launch) runs no mask and masks of none, all
   and random rows, deltas of 1 row and several blocks, 1 to 9 columns,
   and is timed at li_hy's shape;
3. main path — TPC-H-shaped data at scale factor 1 (lineitem 6,001,215
   rows, orders 1,500,000, made with numpy from ``--seed`` and written as
   avro), two covering indexes with 200 buckets built in memory on the
   card, then a point lookup, a range filter and a Q3-shaped join with
   Hyperspace enabled and residency off (the per-file scan). Every result
   must equal a plain numpy evaluation of the same query, ``explain`` must
   show the index scans, and K1 and K2 must have launched; then, in the
   same session, the aggregates: Q17's shape (lineitem joined to orders,
   grouped by part: the join's match ranges from K2 fused into the
   aggregate), the Q3 join grouped by (order key, order date) as TPC-H Q3
   ends (keys on both sides: the join is materialized, then
   hash-aggregated), Q1's shape (the range filter's order-key and
   ship-date windows through K1, grouped by quantity, all five functions)
   with a HAVING filter, and Q6's shape (a global aggregate over the range
   filter). Each shows its index scans under the Aggregate in
   ``explain``, runs with launch counts from zero, and equals numpy;
4. resident path — in the same session, residency ``auto``:
   ``prefetch_index`` puts li_idx's four predicate columns on the card,
   then 20 point lookups, the range filter 5 times and a filter with a
   float64 bound 5 times run through K1c. Every result must equal numpy
   and the same query's per-file result; K1c must have launched once per
   query and K1 never;
5. front end — in the same session, residency off: Q3 written the
   natural way (``li.join(od, ...).filter(...).select(...)``, nothing
   under the join) must be rewritten to li_idx and ord_idx by predicate
   pushdown, column pruning and JoinIndexRule (``explain``'s "Indexes
   used"), launch K2 and its fence build once each, and equal numpy and
   the hand-placed Q3 (timed beside it); lineitem written again as a
   hive-partitioned source (``l_shipyear=YYYY/part-NNN.avro``, 7 years x 4
   files in order-key order, the partition column not in the files): with
   Hyperspace off ``l_shipyear == 1995 & l_quantity < 24`` reads 4 of the
   28 files; a covering index li_year_idx built on the card holds
   l_shipyear and serves a filter through K1; a data-skipping index
   li_year_skip (min/max on l_orderkey, bloom filter on l_partkey) keeps
   at most 14 of 28 files for a 2,000-key window, and a point filter on
   l_partkey equals numpy;
6. lifecycle — in a session of its own with lineage on: the same rows
   written anew as ``src/lineitem_lc`` (8 avro files) and ``src/orders_lc``
   (2), covering indexes li_lc and ord_lc (200 buckets), then TPC-H's
   refresh functions as files appended to and removed from the sources
   (RF1: 1,500 new orders a batch, 1 to 7 lineitems each, keys in
   dbgen's unused slots; RF2: a batch's file removed): two batches
   refreshed incrementally, RF2 through the lineage rewrite,
   ``optimize_index`` quick and full, the resident range filter through
   K1c, a quick refresh (hybrid scan off, the recorded delta served through
   the hybrid transformation), a full refresh, then delete, restore, a
   hand-written REFRESHING head and ``cancel``, delete and vacuum. At each
   step the range filter (and Q3) run with launch counts from zero: K1
   launches once per index file the scan reads, K2 and its fence build
   once per Q3, none while the index is deleted. Every step is timed and
   every result equals numpy over the source as it stands;
7. hybrid — in a session of its own with hybrid scan and lineage on: the
   same rows written anew as ``src/lineitem_hy`` (8 files) and
   ``src/orders_hy`` (2), covering indexes li_hy and ord_hy, served while
   the sources run ahead of them: H1 baseline (index only), H2 two RF1
   batches appended (the range filter a ``Union`` of the index and the 2
   appended files, Q3 a ``BucketUnion`` with the appended rows
   ``Repartition``-ed into the 200 buckets on both sides), H3 RF2 and a
   retention delete of one base lineitem file (the lineage ``NOT IN`` over
   its id in K1's program), then Q17's shape over the two BucketUnion
   sides (the fused aggregate reading the merged bucket groups, K2 once),
   H4 both indexes refreshed incrementally (index
   only again). Each step checks the plan's nodes in ``explain``, runs the
   range filter (K1 once per index file read) and Q3 (K2 and K2F once)
   with launch counts from zero, prints seconds, rows, files read, the
   ``union.side.*`` timers and the rows repartitioned, and holds every
   result against numpy. At H2 and H3 the delta arm follows, residency
   auto: li_hy's predicate planes prefetched, the first range filter
   takes the host union and populates the resident delta in the
   background, then 5 range filters each launch K1h once (no K1, no read
   of the appended files); after H4's refresh no delta is left;
8. streaming — in a session of its own with lineage on: TPC-H lineitem
   and orders at SF3 (18,003,645 and 4,500,000 rows, l_partkey in
   1..600,000) written as avro into ``src/lineitem_st`` (24 files, over
   the 256 MiB streaming threshold) and ``src/orders_st`` (6 files, under
   it). li_st is built with ``build.mode=auto``, which must stream it:
   2^21-row chunks bucketized and sorted on the card, 4 sorted chunks a
   run merged there with one D2H a run, the tail through the per-chunk
   program (counters), finalized as 200 per-bucket files; ord_st builds
   in memory. The auto engine probe's verdict on this machine is printed;
   one staged run's order is held exactly against the host engine's, and
   the staged programs are timed beside their bounds. li_runs is the same
   source with ``finalizeMode=runs`` (run files with ``bucketCounts``),
   queried through the segment planner and through K1c after
   ``prefetch_index``; one RF1 batch is appended and refreshed (run files
   plus per-bucket files), RF2 removes it through the lineage rewrite
   over the run files, and ``compact_index`` converges it to 200
   per-bucket files at 64 buckets a committed step. Each step runs the
   range filter (K1 once per index file read) and Q3 (K2 and its fence
   build once), each held against numpy. After S1 the ladder runs on
   li_st, residency auto, each tier from a fresh cache: budgetMB 4096
   (resident, K1c), 320 (compressed: l_quantity and l_shipdate packed,
   K1p) and 64 (streaming: 18 windows of 2^20 rows through a slab pair),
   each with the resident phase's 30 queries, one launch a query (a
   window a query when streaming), rows against numpy and block counts
   against the resident tier's;
9. one ``kernels`` JSON line (with the kernels phase; a kernel's
   launches are null where none of its paths ran), then the last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises: the script then exits non-zero without the last
line. ``--scale`` below 1 cuts both tables' row counts (printed).
"""

from __future__ import annotations

import argparse
import functools
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SF1_LINEITEM = 6_001_215
SF1_ORDERS = 1_500_000
NUM_BUCKETS = 200
# published peaks of one H100 SXM (NVIDIA data sheet), at a 700 W limit
H100_BYTES_PER_S = 3.35e12
H100_OPS_PER_S = 67e12  # 32-bit, outside the tensor cores
LARGE_ROWS = 1 << 28  # K1c's large case: 3 int32 columns, 3 GiB
LI_RESIDENT = ["l_orderkey", "l_quantity", "l_shipdate", "l_extendedprice"]
# the phases of a run, in order (--phases); aggregate, resident and
# front_end run in the main path's session and so need main
PHASES = ("kernels", "main", "aggregate", "resident", "front_end", "lifecycle", "hybrid",
          "streaming")
DAY_1992_01_01 = 8035  # days since 1970-01-01
DAY_1998_08_02 = 10440
DAY_1993_06_01 = 8552
DAY_1995_03_15 = 9204


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# data: TPC-H-shaped lineitem / orders (same types, key relationships and
# SF1 cardinalities as dbgen's tables; not dbgen's output)
# ---------------------------------------------------------------------------
def make_tables(seed: int, n_orders: int, n_lineitem: int, n_parts: int = 200_000):
    """``n_parts`` is dbgen's part count, 200,000 x SF."""
    rng = np.random.default_rng(seed)
    idx = np.arange(n_orders, dtype=np.int64)
    # dbgen's sparse keys: 8 used out of every 32
    o_orderkey = (idx // 8) * 32 + (idx % 8) + 1
    o_orderdate = rng.integers(DAY_1992_01_01, DAY_1998_08_02 - 151, n_orders).astype(np.int32)
    orders = {
        "o_orderkey": o_orderkey,
        "o_custkey": rng.integers(1, 150_001, n_orders).astype(np.int64),
        "o_orderdate": o_orderdate,
        "o_totalprice": np.round(rng.uniform(850.0, 560_000.0, n_orders), 2),
    }
    # 1..7 lines per order, adjusted to exactly n_lineitem lines
    counts = rng.integers(1, 8, n_orders)
    diff = n_lineitem - int(counts.sum())
    while diff:
        pick = np.flatnonzero(counts < 7) if diff > 0 else np.flatnonzero(counts > 1)
        take = rng.choice(pick, min(abs(diff), len(pick)), replace=False)
        counts[take] += 1 if diff > 0 else -1
        diff = n_lineitem - int(counts.sum())
    l_orderkey = np.repeat(o_orderkey, counts)
    l_quantity = rng.integers(1, 51, n_lineitem).astype(np.int64)
    lineitem = {
        "l_orderkey": l_orderkey,
        "l_partkey": rng.integers(1, n_parts + 1, n_lineitem).astype(np.int64),
        "l_quantity": l_quantity,
        "l_shipdate": (np.repeat(o_orderdate, counts) + rng.integers(1, 122, n_lineitem)).astype(np.int32),
        "l_extendedprice": np.round(l_quantity * rng.uniform(900.0, 2100.0, n_lineitem), 2),
    }
    return lineitem, orders


LINEITEM_SCHEMA = {
    "l_orderkey": "int64", "l_partkey": "int64", "l_quantity": "int64",
    "l_shipdate": "date32", "l_extendedprice": "float64",
}
ORDERS_SCHEMA = {
    "o_orderkey": "int64", "o_custkey": "int64", "o_orderdate": "date32",
    "o_totalprice": "float64",
}


def write_avro_dir(root: Path, table: dict, schema: dict, n_files: int) -> str:
    from hyperspace_tpu_torch.storage.avro_io import write_avro
    from hyperspace_tpu_torch.storage.columnar import ColumnarBatch

    root.mkdir(parents=True, exist_ok=True)
    n = len(next(iter(table.values())))
    bounds = np.linspace(0, n, n_files + 1).astype(np.int64)
    for i in range(n_files):
        s, e = int(bounds[i]), int(bounds[i + 1])
        part = ColumnarBatch.from_pydict({k: v[s:e] for k, v in table.items()}, schema=schema)
        write_avro(root / f"part-{i:03d}.avro", part)
    return str(root)


# ---------------------------------------------------------------------------
# timing helpers (CUDA events; the card must be idle around them)
# ---------------------------------------------------------------------------
def time_ms(fn, repeats: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(statistics.median(times))


_L2_FLUSH = []


def flush_l2() -> None:
    """Overwrite a buffer five times the card's L2 (50 MB on an H100), so
    that the next kernel reads its operands from device memory."""
    import torch

    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(256 << 20, dtype=torch.uint8, device="cuda"))
    _L2_FLUSH[0].zero_()


def time_pair_ms(fa, fb, repeats: int = 100, warmup: int = 3):
    """``time_ms`` of two calls taken in alternation, so that host and
    clock drift fall on both alike: (median of ``fa``, median of ``fb``)."""
    import torch

    for _ in range(warmup):
        fa()
        fb()
    torch.cuda.synchronize()
    times = ([], [])
    for _ in range(repeats):
        for fn, out in ((fa, times[0]), (fb, times[1])):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
    return float(statistics.median(times[0])), float(statistics.median(times[1]))


def device_ms(fn, kernels, calls: int = 20):
    """Mean device time (ms) per call of ``fn`` of the CUDA kernels whose
    name holds ``kernels`` (a name, or a tuple of names whose times add
    up: K2 with its fence build), over ``calls`` calls, each after an L2
    flush (cold L2), from torch.profiler: the kernels alone, where
    ``time_ms`` also holds the host's dispatch when it is the longer part,
    and reads operands that stay in L2 between its repeats. None when the
    profiler saw no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    names = (kernels,) if isinstance(kernels, str) else tuple(kernels)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush_l2()
            fn()
        torch.cuda.synchronize()
    # each named kernel runs once per call: its mean over the launches the
    # profiler kept (it may drop some), summed over the names
    per_name = {k: [0.0, 0] for k in names}
    for e in prof.key_averages():
        for k in names:
            if k in e.key:
                per_name[k][0] += getattr(e, "self_device_time_total", 0.0)
                per_name[k][1] += e.count
    if not all(n and us for us, n in per_name.values()):
        return None
    return sum(us / n for us, n in per_name.values()) / 1e3


def host_dispatch_us(narrowed, names, cols, calls: int = 200) -> dict:
    """Host microseconds (median of ``calls``) of the steps of one K1
    wrapper call: the lowering cache's key (``repr`` of the narrowed
    predicate), a cache miss (lowering plus the parameter template), a
    cache hit, packing the launch's parameter block, and the whole wrapper
    call, which returns once the kernel is queued."""
    import torch

    from hyperspace_tpu_torch.ops import kernels as tk

    def med(fn, k=calls):
        ts = []
        for _ in range(k):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts) * 1e6

    program = tk.lowered_predicate(narrowed, names)
    addrs = tk.k1_column_addrs(cols, tk.K1)
    staged = program.on_device(cols[0].device).data_ptr() if program.staged else 0
    out = torch.empty(int(cols[0].shape[0]), dtype=torch.uint8, device=cols[0].device)
    torch.cuda.synchronize()
    rec = dict(
        key_us=med(lambda: repr(narrowed)),
        miss_us=med(lambda: tk.K1Program(tk.lower_predicate(narrowed, names), len(names)),
                    k=max(5, calls // 20)),
        hit_us=med(lambda: tk.lowered_predicate(narrowed, names)),
        params_us=med(lambda: program.params(addrs, len(out), out.data_ptr(), staged)),
        wrapper_us=med(lambda: tk.predicate_mask_tensor(narrowed, names, cols)),
    )
    torch.cuda.synchronize()
    return rec


def _fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def ptxas_summary(report: str) -> dict:
    """Per kernel of a ``ptxas -v`` report: registers, stack frame and
    spill bytes (template arguments of the mask kernels spelled out)."""
    import re

    def name(mangled: str) -> str:
        m = re.search(r"([a-z_]+_kernel)(?:ILb([01])ELi(\d+)E)?", mangled)
        if not m:
            return mangled
        if m.group(2) is None:
            return m.group(1)
        flag = "staged" if m.group(2) == "1" else "params"
        return f"{m.group(1)}<{flag},{m.group(3)}>"

    out, current = {}, None
    for ln in report.splitlines():
        if "Function properties for" in ln:
            current = name(ln.split("for", 1)[1].strip())
            out.setdefault(current, {})
        elif "Compiling entry function" in ln:
            current = name(ln.split("'")[1])
            out.setdefault(current, {})
        elif current and "stack frame" in ln:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            out[current].update(stack_frame=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif current and "Used" in ln and "registers" in ln:
            out[current]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
    return {k: v for k, v in out.items() if v}


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k2_bound(span: np.ndarray, n_l_pad: int, n_r_pad: int):
    """K2's bound for a plan: its operands read once, (lt, eq) written
    once; the binary-search steps its spans need as operations."""
    from hyperspace_tpu_torch.ops.kernels import SMJ_TILE

    steps = np.where(span > 0, np.ceil(np.log2(span.astype(np.float64) * SMJ_TILE + 1)), 0)
    return bound(4 * n_l_pad + 4 * n_r_pad + 12 * len(span) + 8 * n_l_pad,
                 float(2 * SMJ_TILE * steps.sum()))


def k2_join_keys(lineitem: dict, orders: dict, dev):
    """K2's operands at the Q3 join's shapes: lineitem's order keys laid
    out as the index stores them (grouped by bucket, key-sorted within)
    and orders' keys stable-sorted. Returns (left keys, right keys, the
    left keys' buckets)."""
    import torch

    from hyperspace_tpu_torch.ops import build

    l_keys = lineitem["l_orderkey"]
    bucket = build.device_bucket_ids(
        {"k": torch.from_numpy(l_keys).to(dev)}, {"k": "int64"}, ["k"], {}, NUM_BUCKETS
    ).cpu().numpy()
    return l_keys[np.lexsort((l_keys, bucket))], np.sort(orders["o_orderkey"], kind="stable"), bucket


def searchsorted_pair(r, l):
    """The library yardstick of K2: torch.searchsorted left and right."""
    import torch

    return torch.searchsorted(r, l, side="left"), torch.searchsorted(r, l, side="right")


K2_DEVICE_KERNELS = ("sorted_intersect_kernel", "fence_build_kernel")


def k2_case(name: str, l: np.ndarray, r: np.ndarray, dev):
    """K2 over one input (left keys, ascending right keys), held exactly
    against its plain version on the tiles the plan does not mark wide,
    against its span semantics (``sorted_intersect_span_reference``) on
    every padded row, pad rows and wide tiles included, and, through
    ``sorted_intersect_counts`` (wide tiles fixed up on the host), against
    numpy. Returns (record, device operands, the plan's largest span)."""
    import torch

    from hyperspace_tpu_torch.ops import kernels as tk

    plan = tk._plan_sorted_intersect(l, r)
    if plan is None:
        raise AssertionError(f"K2 {name}: the plan declined")
    s_tile, span, base, l_p, r_p, _l32, _r32, wide_t = plan
    args = [torch.from_numpy(a).to(dev) for a in (s_tile, span, base, l_p, r_p)]
    max_span = int(span.max())
    n = len(l)
    lt, eq = tk.sorted_intersect_tensors(*args, max_span=max_span)
    lt_p, eq_p = tk.sorted_intersect_counts_reference(args[3], args[4])
    lt_s, eq_s = tk.sorted_intersect_span_reference(*args)
    keep = torch.from_numpy(np.repeat(~wide_t, tk.SMJ_TILE)).to(dev)[:n]
    err = max(int((lt[:n] - lt_p[:n]).abs()[keep].max().item()),
              int((eq[:n] - eq_p[:n]).abs()[keep].max().item()))
    span_err = max(int((lt - lt_s).abs().max().item()), int((eq - eq_s).abs().max().item()))
    full = tk.sorted_intersect_counts(l, r, device=dev)
    want = np.searchsorted(r, l, side="left")
    if err or span_err or not (np.array_equal(full[0], want) and np.array_equal(
            full[1], np.searchsorted(r, l, side="right") - want)):
        raise AssertionError(f"K2 {name}: kernel disagrees with plain version "
                             f"(err {err}, span semantics err {span_err})")
    rec = dict(max_abs_err=err, n_l=n, n_r=len(r), wide_tiles=int(wide_t.sum()),
               max_span=max_span, pad_rows=len(l_p) - n)
    log(f"K2 {name}: n_l={n} n_r={len(r)} max_span={max_span} "
        f"pad_rows={len(l_p) - n} exact=yes (plain version, span semantics on every padded "
        f"row, numpy)")
    return rec, args, max_span


def fence_case(r, fences) -> dict:
    """K2's fence build (every ``K2_FENCE``-th right key) held against its
    plain version, which is one PyTorch call (a strided copy), and timed."""
    from hyperspace_tpu_torch.ops import kernels as tk

    plain = tk.sorted_intersect_fences_reference(r)
    if fences.shape != plain.shape:
        raise AssertionError("K2 fences: wrong length")
    err = int((fences - plain).abs().max().item())
    if err:
        raise AssertionError("K2 fences: kernel disagrees with plain version")
    n_f = int(fences.shape[0])
    rec = dict(max_abs_err=err, n_fences=n_f,
               ms=time_ms(lambda: tk.sorted_intersect_fences(r)),
               device_ms=device_ms(lambda: tk.sorted_intersect_fences(r), "fence_build_kernel"),
               plain_ms=time_ms(lambda: tk.sorted_intersect_fences_reference(r)))
    rec["library_ms"] = rec["plain_ms"]
    rec["bound_ms"], rec["bound_by"] = bound(8 * n_f, 0.0)  # each fence read once, written once
    log(f"K2 fences: n_fences={n_f} ms={rec['ms']:.4f} device_ms={_fmt(rec['device_ms'])} "
        f"plain_ms={rec['plain_ms']:.4f} bound_ms={rec['bound_ms']:.4f} "
        f"({rec['bound_by']}) exact=yes")
    return rec


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------
FILE_ROWS = 30_006  # one index file's rows at SF1 (6,001,215 rows / 200 buckets)
RAGGED_ROWS = (1, 31, 4095, 4097, 30_006, 200_003)


def deep_program(depth: int, spans) -> np.ndarray:
    """A hand-written postfix program that fills ``depth`` stack slots:
    ``depth`` compares (one negated) of column ``i % len(spans)`` against a
    literal inside its (lo, hi) span, then alternating AND / OR."""
    from hyperspace_tpu_torch.ops import kernels as tk

    prog = []
    for i in range(depth):
        lo, hi = spans[i % len(spans)]
        prog.append((tk.OP_CMP_LIT, i % len(spans), i % 6, lo + (hi - lo) * (i * 37 % 100) // 100))
    prog.insert(3, (tk.OP_NOT, 0, 0, 0))
    prog += [(tk.OP_AND if i % 2 else tk.OP_OR, 0, 0, 0) for i in range(depth - 1)]
    return np.array(prog, dtype=np.int32)


def k1_shape_cases(arrays: dict, preds: dict, lineitem: dict, dev, seed: int) -> dict:
    """K1 beyond SF1's whole table, each held exactly against its plain
    version on the card: one index file's shape (timed), a 599-instruction
    IN chain (staged in shared memory; at the file's shape and at SF1,
    timed), a program 64 stack slots deep, and ragged lengths under the
    range filter, under a predicate over 5 columns (more than the kernel
    holds in registers) and under one over 18 (more addresses than its
    parameter block holds). The range filter and the IN chain at one
    file's shape also report their host dispatch step by step."""
    import torch

    from hyperspace_tpu_torch.ops import kernels as tk
    from hyperspace_tpu_torch.plan.expr import col, is_in

    out = {}
    n = len(arrays["l_orderkey"])
    rng = np.random.default_rng(seed + 2)
    keys = np.unique(lineitem["l_orderkey"])
    chain = is_in(col("l_orderkey"), [int(k) for k in keys[:: max(1, len(keys) // 300)][:300]])

    def case(name, pred, rows, timed=True, program=None, dispatch=False):
        # an index file holds one hash bucket, rows from across the key
        # range: each case takes a sorted random sample of the table's rows
        idx = np.sort(rng.choice(n, rows, replace=False)) if rows < n else slice(None)
        sub = {c: a[idx] for c, a in arrays.items()}
        narrowed, names, i32 = tk.prepare_predicate(pred, sub)
        cols = [torch.from_numpy(np.require(i32[c], requirements=["C", "W"])).to(dev)
                for c in names]
        lowered = program is None
        if lowered:
            program = tk.lowered_predicate(narrowed, names)
            plain = lambda: tk.predicate_mask_reference(narrowed, names, cols)  # noqa: E731
        else:  # a hand-written program over the predicate's columns
            plain = lambda: tk.run_postfix_reference(program.prog, cols)  # noqa: E731
        got = tk.program_mask_tensor(program, cols)
        want = plain()
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max().item())
        if err != 0 or got.shape != (rows,):
            raise AssertionError(f"K1 {name}: kernel disagrees with plain version")
        rec = dict(max_abs_err=err, rows=rows, cols=program.n_cols, instr=len(program.prog),
                   depth=program.depth, staged=program.staged,
                   matches=int(want.sum().item()))
        if timed:
            rec["ms"] = time_ms(lambda: tk.program_mask_tensor(program, cols))
            rec["device_ms"] = device_ms(lambda: tk.program_mask_tensor(program, cols),
                                         "predicate_mask_kernel")
            if lowered:
                rec["wrapper_ms"] = time_ms(lambda: tk.predicate_mask_tensor(narrowed, names, cols))
            rec["plain_ms"] = time_ms(plain, repeats=5)
            rec["bound_ms"], rec["bound_by"] = bound(
                rows * (4 * program.n_cols + 1), float(rows) * len(program.prog))
        if dispatch:
            rec["host_us"] = host_dispatch_us(narrowed, names, cols)
            log(f"K1 {name} host dispatch: " + " ".join(
                f"{k}={v:.1f}" for k, v in rec["host_us"].items()))
        out[name] = rec
        log(f"K1 {name}: rows={rows} cols={program.n_cols} instr={len(program.prog)} "
            f"depth={program.depth} staged={program.staged} matches={rec['matches']} "
            f"exact=yes" + (
                f" ms={rec['ms']:.4f} device_ms={_fmt(rec['device_ms'])} "
                f"wrapper_ms={rec.get('wrapper_ms', rec['ms']):.4f} "
                f"plain_ms={rec['plain_ms']:.4f} bound_ms={rec['bound_ms']:.4f} "
                f"({rec['bound_by']})" if timed else ""))

    case("file_range_3col", preds["range_3col"], min(FILE_ROWS, n), dispatch=True)
    case("file_in_chain_599", chain, min(FILE_ROWS, n), dispatch=True)
    case("file_wide_18col", preds["wide_18col"], min(FILE_ROWS, n))
    case("in_chain_599", chain, n)
    spans = [(int(arrays[c].min()), int(arrays[c].max()))
             for c in ("l_orderkey", "l_quantity", "l_shipdate")]  # the predicate's names
    case("deep64_3col", preds["range_3col"], min(200_003, n), timed=False,
         program=tk.K1Program(deep_program(64, spans), 3))
    for rows in RAGGED_ROWS:
        case(f"ragged_{rows}", preds["range_3col"], min(rows, n), timed=False)
        case(f"ragged_{rows}_wide_5col", preds["wide_5col"], min(rows, n), timed=False)
        case(f"ragged_{rows}_wide_18col", preds["wide_18col"], min(rows, n), timed=False)
    return out


LI_ST_ROWS = SF1_LINEITEM * 3  # the ladder phase's li_st (SF3)


def _held(name: str, got, want) -> int:
    """Exact agreement of a kernel's counts with its plain version's."""
    import torch

    torch.cuda.synchronize()
    err = int((got.cpu() - want.cpu()).abs().max().item()) if got.shape == want.shape else -1
    if err != 0:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return err


def _timed_counts(name: str, run, plain, kernel: str, nbytes: float, ops: float, **rec):
    """ms (CUDA events), device ms (profiler after an L2 flush), plain ms
    and the bound of one counts kernel call; logged, returned."""
    rec.update(ms=time_ms(run), device_ms=device_ms(run, kernel), plain_ms=time_ms(plain, repeats=5),
               library_ms=None)
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops)
    log(f"{name}: " + " ".join(f"{k}={v}" for k, v in rec.items()
                               if not isinstance(v, float) and k not in ("library_ms", "bound_by"))
        + f" ms={rec['ms']:.4f} device_ms={_fmt(rec['device_ms'])} plain_ms={rec['plain_ms']:.4f}"
        f" bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}) library_ms=null exact=yes")
    return rec


def li_st_planes(rng, n: int, top: int) -> dict:
    """li_st's three predicate planes over ``n`` rows as the compressed
    tier holds them: l_orderkey raw, l_quantity (1..50: 6 bits, vpw 4)
    and l_shipdate (1992-01-02..1998-07-02: 12 bits, vpw 2) packed."""
    from hyperspace_tpu_torch.ops import bitpack

    qty = rng.integers(1, 51, n).astype(np.int64)
    ship = rng.integers(8036, 10411, n).astype(np.int64)
    return {"l_orderkey": (rng.integers(1, top, n).astype(np.int64), None),
            "l_quantity": (qty, bitpack.pack_spec(int(qty.min()), int(qty.max()), n)),
            "l_shipdate": (ship, bitpack.pack_spec(int(ship.min()), int(ship.max()), n))}


def li_st_pred(top: int):
    """The range filter over li_st's planes (order keys below ``top``)."""
    from hyperspace_tpu_torch.plan.expr import col

    return ((col("l_orderkey") >= top // 6) & (col("l_orderkey") < top // 2)
            & (col("l_quantity") < 24) & (col("l_shipdate") >= DAY_1995_03_15 - 365)
            & (col("l_shipdate") < DAY_1995_03_15))


def residency_kernel_cases(lineitem: dict, seed: int, dev) -> dict:
    """K1p and K1h against their plain versions on the card, exactly.

    K1p: every width 1-16 (every vpw 32, 16, 8, 4, 2) with negative frames,
    literals below and above each frame, packed, raw and f64 planes in one
    program, a staged program of over 240 instructions, and a table whose
    real rows end mid-word (pad rows decode to ref0, as the compressed
    tier stores them); then the edges of its staged design: a 2^20-row
    window (128 blocks, fewer than the SMs), one block, a block count that
    is no multiple of the persistent grid, programs that fit two ring
    stages only as sub-tiles (12 raw + 4 packed planes, 64 stack slots, 40
    raw planes), 18 planes (a device address table), a staged IN chain,
    and every sub-tile from 8192 down to 128 rows forced; timed at li_st's
    packed shape (SF3: l_orderkey raw, l_quantity 6 bits, l_shipdate 12
    bits) and at one streaming window of it, each beside K1c at the same
    rows raw. K1h: no mask and masks of none,
    all and random rows, deltas of 1 row and of several blocks, 1 to 9
    columns (18 addresses: a device table); timed at li_hy's shape (SF1
    base, two RF1 batches of delta, one file of eight deleted)."""
    import torch

    from hyperspace_tpu_torch.ops import bitpack
    from hyperspace_tpu_torch.ops import kernels as tk
    from hyperspace_tpu_torch.ops.floatbits import (
        expand_f64_predicate,
        f64_to_ordered_i64,
        ordered_i64_planes,
    )
    from hyperspace_tpu_torch.plan.expr import col, is_in

    rng = np.random.default_rng(seed + 10)
    B = tk.BLOCK_ROWS
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    k1p, k1h = {}, {}

    def packed_case(name, planes, pred, n_pad):
        """``planes``: name -> (values over the real rows, PackSpec or None,
        or "f64"); the predicate over those names (f64 expanded)."""
        f64 = {nm for nm, (_v, sp) in planes.items() if sp == "f64"}
        bound_pred = expand_f64_predicate(pred, f64) if f64 else pred
        narrowed = tk.narrow_expr_to_i32(bound_pred)
        names = tuple(sorted(narrowed.columns()))
        cols, specs = [], []
        for nm in names:
            base, _, plane = nm.partition("\x00")
            v, sp = planes[base]
            if sp == "f64":
                hi, lo = ordered_i64_planes(f64_to_ordered_i64(v))
                a = np.zeros(n_pad, dtype=np.int32)
                a[: len(v)] = hi if plane == "hi" else lo
                sp = None
            elif sp is None:
                a = np.zeros(n_pad, dtype=np.int32)
                a[: len(v)] = v
            else:
                sp = bitpack.PackSpec(sp.bits, sp.vpw, n_pad, sp.ref0)
                padded = np.full(n_pad, sp.ref0, dtype=np.int64)
                padded[: len(v)] = v
                a = bitpack.pack_plain(padded, sp)
            cols.append(torch.from_numpy(a).to(dev))
            specs.append(sp)
        got = tk.predicate_block_counts_packed_tensor(narrowed, names, cols, specs, n_pad)
        want = tk.predicate_block_counts_packed_reference(narrowed, names, cols, specs, n_pad)
        err = _held(f"K1p {name}", got, want)
        prog = tk.packed_program(narrowed, names, specs)
        k1p[name] = dict(max_abs_err=err, rows=n_pad, cols=len(names),
                         packed=sum(s is not None for s in specs), instr=len(prog.prog),
                         staged=prog.staged, sub_rows=prog.plan.sub_rows,
                         matches=int(want.sum().item()))
        return narrowed, names, cols, specs, want

    # every width, negative frames, literals off the frame; rows end mid-word
    n_real, n_pad = 5 * B - 3, 5 * B
    for bits in range(1, 17):
        planes = {}
        for b in (bits, 1 + bits % 16, 9):
            lo = -int(rng.integers(1, 5000))
            v = rng.integers(lo, lo + (1 << b), n_real).astype(np.int64)
            planes[f"p{b:02d}"] = (v, bitpack.pack_spec(lo, lo + (1 << b) - 1, n_real))
        planes["r"] = (rng.integers(-10**6, 10**6, n_real).astype(np.int64), None)
        planes["x"] = (np.round(rng.uniform(-1000.0, 60_000.0, n_real), 2), "f64")
        first = f"p{bits:02d}"
        others = sorted(nm for nm in planes if nm.startswith("p") and nm != first)
        v0, sp0 = planes[first]
        mixed = ((col(first) >= int(np.median(v0))) | (col(first) < sp0.ref0 - 1)
                 | (col(first) > sp0.ref0 + (1 << sp0.bits))) & (col("r") < 0) & (
            col("x") > 30_000.0) & (col(others[0]) != int(planes[others[0]][0][2])) & (
            col(others[-1]) <= int(np.median(planes[others[-1]][0])))
        packed_case(f"width_{bits}_mixed_6col", planes, mixed, n_pad)
        chain = is_in(col(first), [int(x) for x in v0[:130]]) & (col("r") > 0)
        packed_case(f"width_{bits}_staged", planes, chain, n_pad)
    log(f"K1p: {len(k1p)} cases (widths 1-16, vpw 32/16/8/4/2, negative frames, literals off "
        f"the frame, packed + raw + f64 planes, staged programs of "
        f"{max(c['instr'] for c in k1p.values())} instructions, rows ending mid-word) exact=yes")

    # the staged design's edges: a streaming window (2^20 rows, 128
    # blocks: fewer than the SMs), one block, a block count that is no
    # multiple of the persistent grid, a staged program, and programs whose
    # slices fit two stages only as sub-tiles (12 raw + 4 packed planes; 64
    # stack slots; 40 raw planes: sub-tiles under 1024 rows, some warps
    # idle), over 16 planes (addresses in col_table)
    top = 18_000_000
    st_pred = li_st_pred(top)

    def li_st_case(name, n_real, pred=st_pred):
        return packed_case(name, li_st_planes(rng, n_real, top), pred, -(-n_real // B) * B)

    li_st_case("window_2p20", 1 << 20)
    li_st_case("one_block", B - 5)
    # the grid is the SMs times the 1 or 2 CTAs each holds: 2 * SMs + 3
    # blocks is a multiple of neither
    li_st_case(f"blocks_2x{sm}_plus_3", (2 * sm + 3) * B - 1)
    keys = [int(x) for x in rng.integers(1, top, 130)]
    li_st_case("staged_in_chain", 5 * B, is_in(col("l_orderkey"), keys) | (
        col("l_quantity") < 3) | ((col("l_shipdate") > 10_000) & (col("l_quantity") > 47)))

    def wide_planes(n_raw, packed_bits, n_real):
        planes = {f"r{i:02d}": (rng.integers(-10**6, 10**6, n_real).astype(np.int64), None)
                  for i in range(n_raw)}
        for i, b in enumerate(packed_bits):
            lo = -int(rng.integers(1, 5000))
            planes[f"q{i:02d}"] = (rng.integers(lo, lo + (1 << b), n_real).astype(np.int64),
                                   bitpack.pack_spec(lo, lo + (1 << b) - 1, n_real))
        pred = None
        for nm, (v, sp) in sorted(planes.items()):
            c = (col(nm) > -900_000) if sp is None else (col(nm) >= int(np.percentile(v, 15)))
            pred = c if pred is None else pred & c
        return planes, pred

    for name, n_raw, bits in (("subtile_12raw_4packed", 12, (3, 6, 12, 16)),
                              ("subtile_40raw", 40, ()),
                              ("cols_18_table", 9, (1, 2, 4, 5, 8, 9, 12, 15, 16))):
        planes, pred = wide_planes(n_raw, bits, 5 * B - 3)
        packed_case(name, planes, pred, 5 * B)

    # a hand-written program 64 stack slots deep over li_st's planes and a
    # fourth, raw one: its stack leaves room for two stages of 4096 rows
    planes = li_st_planes(rng, 5 * B, top)
    planes["l_extendedprice"] = (rng.integers(90_000, 10_500_000, 5 * B).astype(np.int64), None)
    names = ("l_orderkey", "l_quantity", "l_shipdate", "l_extendedprice")
    specs = [planes[nm][1] for nm in names]
    cols = [torch.from_numpy(planes[nm][0].astype(np.int32) if sp is None
                             else bitpack.pack_plain(planes[nm][0], sp)).to(dev)
            for nm, sp in zip(names, specs)]
    spans = [(int(planes[nm][0].min()), int(planes[nm][0].max())) for nm in names]
    deep = tk.K1Program(deep_program(64, spans), len(names), tk.packed_header(specs))
    want = tk.program_block_counts_packed_reference(deep, cols, specs, 5 * B)
    k1p["deep64_4col"] = dict(
        max_abs_err=_held("K1p deep64_4col",
                          tk.program_block_counts_packed_tensor(deep, cols, specs, 5 * B), want),
        rows=5 * B, cols=len(names), packed=2, instr=len(deep.prog), staged=deep.staged,
        sub_rows=deep.plan.sub_rows, matches=int(want.sum().item()))
    # every sub-tile the plan could choose, on this table under the deep
    # program and the range filter: KC 8, 4, 2, 1 and sub-tiles under 1024
    # rows (some warps idle)
    sweep = {}
    for label, program in (("deep64_4col", deep),
                           ("range_4col", tk.packed_program(st_pred, names, specs))):
        want = tk.program_block_counts_packed_reference(program, cols, specs, 5 * B)
        for rows in tk.K1P_SUB_ROWS:
            if rows <= program.plan.sub_rows:
                got = tk.program_block_counts_packed_tensor(program, cols, specs, 5 * B, rows)
                sweep[f"{label}_{rows}"] = _held(f"K1p {label} sub_rows={rows}", got, want)
    k1p["sub_rows_sweep"] = dict(max_abs_err=max(sweep.values()), cases=sorted(sweep))
    log(f"K1p: the staged design's edges exact=yes: " + ", ".join(
        f"{nm} (rows {r['rows']}, {r['cols']} planes, {r['instr']} instr, sub_rows "
        f"{r.get('sub_rows')})" for nm, r in k1p.items()
        if not nm.startswith("width_") and "rows" in r)
        + f"; {len(sweep)} forced sub-tiles (8192 down to 128 rows)")

    # timed: li_st's shape and one streaming window, packed (K1p) and raw
    # (K1c)
    for label, n in (("li_st", LI_ST_ROWS), ("window", 1 << 20)):
        n_pad = -(-n // B) * B
        planes = li_st_planes(rng, n, top)
        name = f"{label}_packed_3col"
        narrowed, names, cols, specs, _w = packed_case(name, planes, st_pred, n_pad)
        rec = k1p.pop(name)
        words = sum(int(c.numel()) for c in cols)
        n_instr = len(tk.lower_predicate(narrowed, names))
        k1p[name] = _timed_counts(
            f"K1p {name}",
            lambda: tk.predicate_block_counts_packed_tensor(narrowed, names, cols, specs, n_pad),
            lambda: tk.predicate_block_counts_packed_reference(narrowed, names, cols, specs,
                                                               n_pad),
            "predicate_block_counts_packed_kernel", 4 * words + 4 * (n_pad // B),
            float(n_pad) * n_instr,
            specs="/".join("raw" if s is None else f"{s.bits}b_vpw{s.vpw}" for s in specs),
            **rec)
        raw = [torch.zeros(n_pad, dtype=torch.int32, device=dev) for _ in names]
        for t, nm in zip(raw, names):
            t[:n] = torch.from_numpy(planes[nm][0].astype(np.int32)).to(dev)
        err = _held(f"K1c {label}_raw_3col", tk.predicate_block_counts_tensor(narrowed, names, raw),
                    tk.predicate_block_counts_reference(narrowed, names, raw))
        k1p[f"{label}_raw_3col_k1c"] = _timed_counts(
            f"K1c {label}_raw_3col (beside K1p)",
            lambda: tk.predicate_block_counts_tensor(narrowed, names, raw),
            lambda: tk.predicate_block_counts_reference(narrowed, names, raw),
            "predicate_block_counts_kernel", 4 * len(names) * n_pad + 4 * (n_pad // B),
            float(n_pad) * n_instr, max_abs_err=err, rows=n_pad)
        del cols, raw
        torch.cuda.empty_cache()

    # K1h: masks, delta sizes and column counts, exactly
    for n_cols in (1, 3, 9):
        names = tuple(f"c{i}" for i in range(n_cols))
        pred = col("c0") < 40
        for nm in names[1:]:
            pred = pred & (col(nm) > -40)
        for nb, nd, d_real in ((3, 1, 1), (2, 4, 4 * B - 100)):
            base = [torch.from_numpy(rng.integers(-99, 99, nb * B).astype(np.int32)).to(dev)
                    for _ in names]
            delta = [torch.zeros(nd * B, dtype=torch.int32, device=dev) for _ in names]
            for t in delta:
                t[:d_real] = torch.from_numpy(rng.integers(-99, 99, d_real).astype(np.int32))
            for label, rows in (("no_mask", None), ("none", np.zeros(nb * B, bool)),
                                ("all", np.ones(nb * B, bool)),
                                ("random", rng.random(nb * B) < 0.3)):
                mask = None if rows is None else torch.from_numpy(
                    tk.pack_row_bitmask(rows)).to(dev)
                got = tk.hybrid_block_counts_tensor(pred, names, base, delta, mask)
                want = tk.hybrid_block_counts_reference(pred, names, base, delta, mask)
                case = f"{n_cols}col_base{nb}_delta{d_real}_{label}"
                k1h[case] = dict(max_abs_err=_held(f"K1h {case}", got, want),
                                 matches=int(want.sum().item()))
    log(f"K1h: {len(k1h)} cases (no mask, masks of none, all and random rows; deltas of 1 row "
        f"and of several blocks; 1, 3 and 9 columns) exact=yes")

    # timed: li_hy's shape, the range filter's three planes
    n = len(lineitem["l_orderkey"])
    nb_pad = -(-n // B) * B
    d_rows = 11_891  # two RF1 batches at SF1 (hybrid phase, PR 7)
    nd_pad = -(-d_rows // B) * B
    names = ("l_orderkey", "l_quantity", "l_shipdate")
    topk = int(lineitem["l_orderkey"].max())
    pred = tk.narrow_expr_to_i32(
        (col("l_orderkey") >= topk // 6) & (col("l_orderkey") < topk // 2)
        & (col("l_quantity") < 24) & (col("l_shipdate") >= DAY_1995_03_15 - 365)
        & (col("l_shipdate") < DAY_1995_03_15))
    base, delta = [], []
    pick = rng.integers(0, n, d_rows)
    for c in names:
        t = torch.zeros(nb_pad, dtype=torch.int32, device=dev)
        t[:n] = torch.from_numpy(lineitem[c].astype(np.int32)).to(dev)
        base.append(t)
        t = torch.zeros(nd_pad, dtype=torch.int32, device=dev)
        t[:d_rows] = torch.from_numpy(lineitem[c][pick].astype(np.int32)).to(dev)
        delta.append(t)
    deleted = np.zeros(nb_pad, dtype=bool)
    deleted[2 * n // 8: 3 * n // 8] = True  # one base file of eight
    mask = torch.from_numpy(tk.pack_row_bitmask(deleted)).to(dev)
    err = _held("K1h li_hy", tk.hybrid_block_counts_tensor(pred, names, base, delta, mask),
                tk.hybrid_block_counts_reference(pred, names, base, delta, mask))
    k1h["li_hy_3col"] = _timed_counts(
        "K1h li_hy_3col",
        lambda: tk.hybrid_block_counts_tensor(pred, names, base, delta, mask),
        lambda: tk.hybrid_block_counts_reference(pred, names, base, delta, mask),
        "hybrid_block_counts_kernel",
        4 * len(names) * (nb_pad + nd_pad) + nb_pad // 8 + 4 * ((nb_pad + nd_pad) // B),
        float(nb_pad + nd_pad) * len(tk.lower_predicate(pred, names)),
        max_abs_err=err, base_rows=nb_pad, delta_rows=nd_pad)
    del base, delta
    torch.cuda.empty_cache()
    return {"k1p": k1p, "k1h": k1h}


def kernel_phase(lineitem: dict, orders: dict, seed: int) -> dict:
    import torch

    from hyperspace_tpu_torch.ops import kernels as tk
    from hyperspace_tpu_torch.ops.k2_cases import k2_edge_cases
    from hyperspace_tpu_torch.plan.expr import col, is_in

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 1)
    n = len(lineitem["l_orderkey"])
    arrays = {
        "l_orderkey": lineitem["l_orderkey"],  # int64, narrows to int32
        "l_quantity": lineitem["l_quantity"],
        "l_shipdate": lineitem["l_shipdate"],  # date32
        "l_receiptdate": (lineitem["l_shipdate"] + rng.integers(-3, 30, n)).astype(np.int32),
        "l_discount": (rng.integers(0, 11, n) / 100).astype(np.float32),
    }
    extra = [f"x{i:02d}" for i in range(13)]  # 18 columns with wide_5col's 5
    for name in extra:
        arrays[name] = rng.integers(0, 1000, n, dtype=np.int32)
    k = int(lineitem["l_orderkey"][n // 3])
    top = int(lineitem["l_orderkey"].max())
    preds = {
        "point_1col": col("l_orderkey") == k,
        "range_3col": (col("l_orderkey") >= top // 6) & (col("l_orderkey") < top // 2)
        & (col("l_quantity") < 24) & (col("l_shipdate") >= DAY_1995_03_15 - 365)
        & (col("l_shipdate") < DAY_1995_03_15),
        "in_not_f32_3col": is_in(col("l_quantity"), [1, 5, 10, 20, 40])
        | (~(col("l_shipdate") < DAY_1995_03_15) & (col("l_discount") > 0.0625)),
        "colcol_4col": (col("l_shipdate") < col("l_receiptdate")) & (col("l_quantity") > 2)
        & ~(col("l_discount") == 0.0) & (col("l_quantity") < 48),
        # 5 columns: more than K1 holds in registers, so it loads per compare
        "wide_5col": (col("l_shipdate") < col("l_receiptdate")) & (col("l_quantity") > 2)
        & ~(col("l_discount") == 0.0) & (col("l_orderkey") < top // 2),
    }
    # 18 columns: more addresses than K1's parameter block holds (16), so
    # they reach the kernel in a device array
    preds["wide_18col"] = preds["wide_5col"]
    for name in extra:
        preds["wide_18col"] = preds["wide_18col"] & (col(name) > 20)
    k1 = {}
    for name, p in preds.items():
        prep = tk.prepare_predicate(p, arrays)
        if prep is None:
            raise AssertionError(f"K1 {name}: predicate does not narrow to int32")
        narrowed, names, i32 = prep
        cols = [torch.from_numpy(np.require(i32[c], requirements=["C", "W"])).to(dev) for c in names]
        got = tk.predicate_mask_tensor(narrowed, names, cols)
        want = tk.predicate_mask_reference(narrowed, names, cols)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max().item())
        if err != 0 or got.shape != (n,):
            raise AssertionError(f"K1 {name}: kernel disagrees with plain version")
        ms = time_ms(lambda: tk.predicate_mask_tensor(narrowed, names, cols))
        plain = time_ms(lambda: tk.predicate_mask_reference(narrowed, names, cols), repeats=5)
        n_instr = len(tk.lower_predicate(narrowed, names))
        b_ms, b_by = bound(n * (4 * len(names) + 1), float(n) * n_instr)
        dev_ms = device_ms(lambda: tk.predicate_mask_tensor(narrowed, names, cols),
                           "predicate_mask_kernel")
        k1[name] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                        max_abs_err=err, cols=len(names), rows=n,
                        matches=int(want.sum().item()))
        log(f"K1 {name}: rows={n} cols={len(names)} ms={ms:.4f} device_ms={_fmt(dev_ms)} "
            f"plain_ms={plain:.4f} bound_ms={b_ms:.4f} ({b_by}) exact=yes")

    # K1 again over operands uploaded once and a program lowered once: the
    # gap to the wrapper's time, the two timed in alternation, is the
    # wrapper's per-call host work (the program rides in the launch's
    # parameters either way)
    dispatch, rcols = tk.resident_mask_fn(preds["range_3col"], arrays, device=dev)
    narrowed, names = tk.prepare_predicate(preds["range_3col"], arrays)[:2]
    if not torch.equal(dispatch(rcols), tk.predicate_mask_tensor(narrowed, names, rcols)):
        raise AssertionError("K1 resident_mask_fn disagrees with the wrapper")
    rec = k1["range_3col"]
    rec["wrapper_paired_ms"], rec["resident_ms"] = time_pair_ms(
        lambda: tk.predicate_mask_tensor(narrowed, names, rcols), lambda: dispatch(rcols))
    rec["resident_device_ms"] = device_ms(lambda: dispatch(rcols), "predicate_mask_kernel")
    log(f"K1 range_3col resident_mask_fn: ms={rec['resident_ms']:.4f} "
        f"device_ms={_fmt(rec['resident_device_ms'])} (wrapper in alternation "
        f"{rec['wrapper_paired_ms']:.4f}; alone {rec['ms']:.4f})")
    k1.update(k1_shape_cases(arrays, preds, lineitem, dev, seed))

    k1c = {}
    n_pad = -(-n // tk.BLOCK_ROWS) * tk.BLOCK_ROWS

    def padded(pred):  # zero-padded columns, as the resident table holds them
        narrowed, names, i32 = tk.prepare_predicate(pred, arrays)
        out = []
        for c in names:
            t = torch.zeros(n_pad, dtype=torch.int32, device=dev)
            t[:n] = torch.from_numpy(np.require(i32[c], requirements=["C", "W"])).to(dev)
            out.append(t)
        return narrowed, names, out

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    large = [  # the same predicate's columns over 2^28 rows, made on the card
        torch.randint(lo, hi, (LARGE_ROWS,), generator=gen, device=dev, dtype=torch.int32)
        for lo, hi in ((1, 6_000_000), (1, 51), (DAY_1992_01_01, DAY_1998_08_02))
    ]
    narrowed, names, range_cols = padded(preds["range_3col"])
    for name, narrowed, names, cols in (("range_3col", narrowed, names, range_cols),
                                        ("large_3col", narrowed, names, large),
                                        ("wide_18col", *padded(preds["wide_18col"]))):
        rows = int(cols[0].shape[0])
        got = tk.predicate_block_counts_tensor(narrowed, names, cols)
        want = tk.predicate_block_counts_reference(narrowed, names, cols)
        torch.cuda.synchronize()
        err = int((got - want).abs().max().item())
        if err != 0 or got.shape != (rows // tk.BLOCK_ROWS,):
            raise AssertionError(f"K1c {name}: kernel disagrees with plain version")
        ms = time_ms(lambda: tk.predicate_block_counts_tensor(narrowed, names, cols))
        plain = time_ms(lambda: tk.predicate_block_counts_reference(narrowed, names, cols),
                        repeats=5)
        n_instr = len(tk.lower_predicate(narrowed, names))
        b_ms, b_by = bound(4 * len(names) * rows + 4 * (rows // tk.BLOCK_ROWS),
                           float(rows) * n_instr)
        dev_ms = device_ms(lambda: tk.predicate_block_counts_tensor(narrowed, names, cols),
                           "predicate_block_counts_kernel")
        k1c[name] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                         max_abs_err=err, cols=len(names), rows_padded=rows,
                         matches=int(want.sum().item()))
        log(f"K1c {name}: rows_padded={rows} cols={len(names)} ms={ms:.4f} "
            f"device_ms={_fmt(dev_ms)} plain_ms={plain:.4f} bound_ms={b_ms:.4f} ({b_by}) "
            f"exact=yes")
    del large, range_cols, cols
    torch.cuda.empty_cache()

    # K2 at the join's shapes: left = lineitem keys laid out as the index
    # stores them (grouped by bucket, key-sorted within), right = orders
    # keys stable-sorted
    l_keys = lineitem["l_orderkey"]
    l_codes, r_sorted, bucket = k2_join_keys(lineitem, orders, dev)
    cases = {"index_layout": (l_codes, r_sorted)}
    wide = l_codes.copy()
    wide[:8192] = rng.permutation(wide[:8192])  # scattered tiles: host fix-up
    cases["with_wide_tiles"] = (wide, r_sorted)
    k2 = {}
    for name, (l, r) in cases.items():
        rec, args, max_span = k2_case(name, l, r, dev)
        run = lambda: tk.sorted_intersect_tensors(*args, max_span=max_span)  # noqa: E731
        # device time: K2 with the fence build its wrapper launches first
        rec.update(ms=time_ms(run), device_ms=device_ms(run, K2_DEVICE_KERNELS),
                   plain_ms=time_ms(lambda: tk.sorted_intersect_counts_reference(args[3], args[4])),
                   library_ms=time_ms(lambda: searchsorted_pair(args[4], args[3])))
        fences = tk.sorted_intersect_fences(args[4])
        rec["kernel_device_ms"] = device_ms(
            lambda: tk.sorted_intersect_tensors(*args, fences, max_span=max_span),
            "sorted_intersect_kernel")
        rec["fences_device_ms"] = device_ms(lambda: tk.sorted_intersect_fences(args[4]),
                                            "fence_build_kernel")
        rec["bound_ms"], rec["bound_by"] = k2_bound(args[1].cpu().numpy(), int(args[3].shape[0]),
                                                    int(args[4].shape[0]))
        k2[name] = rec
        log(f"K2 {name}: n_l={len(l)} n_r={len(r)} wide_tiles={rec['wide_tiles']} "
            f"max_span={rec['max_span']} ms={rec['ms']:.4f} device_ms={_fmt(rec['device_ms'])} "
            f"(K2 {_fmt(rec['kernel_device_ms'])} + fences {_fmt(rec['fences_device_ms'])}) "
            f"plain_ms={rec['plain_ms']:.4f} library_ms={rec['library_ms']:.4f} "
            f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}) exact=yes")
        if name == "index_layout":
            k2f = fence_case(args[4], fences)
    # K2's edge cases (runs of equal keys, keys on fences, spans of 64 and
    # 1, shuffled tiles, ragged sides, pad rows): the inputs the CPU parity
    # tests feed the reference's Pallas kernel
    for name, (l, r) in k2_edge_cases(seed).items():
        k2[f"edge_{name}"] = k2_case(f"edge {name}", l, r, dev)[0]
    # K2 over resident operands. At index_layout the 199 tiles that
    # straddle a bucket boundary are wide, and the resident entry points
    # decline them as the reference does; the same keys in key order (no
    # wide tile, the same sizes) time the kernel alone.
    if tk.resident_sorted_intersect(l_codes, r_sorted, device=dev) is not None:
        raise AssertionError("resident_sorted_intersect accepted wide tiles")
    l_sorted = np.sort(l_keys, kind="stable")
    run = tk.resident_sorted_intersect(l_sorted, r_sorted, device=dev)
    if run is None:
        raise AssertionError("resident_sorted_intersect declined key-sorted keys")
    lt, eq = run()
    want_lt = np.searchsorted(r_sorted, l_sorted, side="left")
    if not (np.array_equal(lt[: n].cpu().numpy(), want_lt) and np.array_equal(
            eq[: n].cpu().numpy(), np.searchsorted(r_sorted, l_sorted, side="right") - want_lt)):
        raise AssertionError("K2 resident_sorted_intersect disagrees with numpy")
    d = run.d_args
    b_ms, b_by = k2_bound(d[1].cpu().numpy(), int(d[3].shape[0]), int(d[4].shape[0]))
    k2["key_sorted"] = dict(
        max_abs_err=0,  # exact against numpy above
        resident_ms=time_ms(run),
        # the resident operands carry their fences: K2 alone
        device_ms=device_ms(run, "sorted_intersect_kernel"),
        amortized_ms=tk.resident_smj_amortized(l_sorted, r_sorted, 17, repeats=5,
                                               prepared=run) * 1e3,
        plain_ms=time_ms(lambda: tk.sorted_intersect_counts_reference(d[3], d[4])),
        library_ms=time_ms(lambda: searchsorted_pair(d[4], d[3])),
        bound_ms=b_ms, bound_by=b_by)
    ks = k2["key_sorted"]
    log(f"K2 key_sorted resident_sorted_intersect: ms={ks['resident_ms']:.4f} "
        f"device_ms={_fmt(ks['device_ms'])} "
        f"resident_smj_amortized ms={ks['amortized_ms']:.4f} plain_ms={ks['plain_ms']:.4f} "
        f"library_ms={ks['library_ms']:.4f} bound_ms={b_ms:.4f} ({b_by})")

    # fused aggregate-over-join: lineitem keys against sorted order keys,
    # o_totalprice in integer cents, groups l_quantity - 1 (50). Key order
    # takes the K2 arm; index layout (wide tiles) the torch arm.
    from hyperspace_tpu_torch.telemetry.metrics import metrics

    o_perm = np.argsort(orders["o_orderkey"], kind="stable")
    r_vals = np.round(orders["o_totalprice"][o_perm] * 100).astype(np.int64)
    li_order = np.lexsort((l_keys, bucket))
    agg = {}
    for name, order in (("key_sorted", np.argsort(l_keys, kind="stable")),
                        ("index_layout", li_order)):
        lk = l_keys[order]
        grp = (lineitem["l_quantity"][order] - 1).astype(np.int64)
        metrics.reset()
        run = tk.resident_fused_agg_over_join(lk, r_sorted, r_vals, grp, 50, device=dev)
        gc, gs = (t.cpu().numpy() for t in run())
        lo = np.searchsorted(r_sorted, lk, side="left")
        hi = np.searchsorted(r_sorted, lk, side="right")
        rvc = np.concatenate([[0], np.cumsum(r_vals)])
        want_c = np.zeros(50, dtype=np.int64)
        want_s = np.zeros(50, dtype=np.int64)
        np.add.at(want_c, grp, hi - lo)
        np.add.at(want_s, grp, rvc[hi] - rvc[lo])
        if not (np.array_equal(gc, want_c) and np.array_equal(gs, want_s)):
            raise AssertionError(f"fused agg {name}: disagrees with numpy")
        arm = "kernel" if metrics.get("fused_agg.path.kernel") else "torch"
        # plain: the same function in torch ops on the same device inputs
        l_d, r_d, g_d = (torch.from_numpy(a).to(dev) for a in (lk, r_sorted, grp))
        rvc_d = torch.from_numpy(rvc).to(dev)

        def plain():
            a, b = searchsorted_pair(r_d, l_d)
            gc = torch.zeros(50, dtype=torch.int64, device=dev).index_add_(0, g_d, b - a)
            return gc, torch.zeros(50, dtype=torch.int64, device=dev).index_add_(
                0, g_d, rvc_d[b] - rvc_d[a])

        # bytes: int32 keys of both sides, the int64 group permutation and
        # prefix sums read once, the two int64 group vectors written once
        b_ms, b_by = bound(4 * len(lk) + 4 * len(r_sorted) + 8 * len(lk)
                           + 8 * (len(r_sorted) + 1) + 16 * 50, 0.0)
        agg[name] = dict(ms=time_ms(run), plain_ms=time_ms(plain), arm=arm,
                         bound_ms=b_ms, bound_by=b_by)
        log(f"fused_agg {name}: arm={arm} ms={agg[name]['ms']:.4f} "
            f"plain_ms={agg[name]['plain_ms']:.4f} bound_ms={b_ms:.4f} ({b_by}) exact=yes")
    out = {"k1": k1, "k1c": k1c, "k2": k2, "k2f": k2f, "fused_agg": agg}
    out.update(residency_kernel_cases(lineitem, seed, dev))
    return out


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------
def _sorted_rows(arrays):
    order = np.lexsort(tuple(reversed(arrays)))
    return [a[order] for a in arrays]


def _check(name, batch, cols, want):
    got = [np.asarray(batch.columns[c].data) for c in cols]
    g, w = _sorted_rows(got), _sorted_rows(want)
    if len(g[0]) != len(w[0]) or not all(np.array_equal(a, b) for a, b in zip(g, w)):
        raise AssertionError(
            f"{name}: {len(g[0])} rows differ from the numpy reference ({len(w[0])} rows)"
        )


class _Profiled:
    """With ``--profile``: the host's top functions (cProfile) and the
    card's busy share (torch.profiler device time over wall time) of one
    main-path step, printed when the step ends. A no-op otherwise."""

    def __init__(self, label: str, enabled: bool):
        self.label, self.enabled = label, enabled

    def __enter__(self):
        if self.enabled:
            import cProfile

            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.tprof = torch.profiler.profile(activities=acts)
            self.cprof = cProfile.Profile()
            self.t0 = time.perf_counter()
            self.tprof.__enter__()
            self.cprof.enable()
        return self

    def __exit__(self, *exc):
        if not self.enabled:
            return False
        import io
        import pstats

        self.cprof.disable()
        self.tprof.__exit__(*exc)
        wall_ms = (time.perf_counter() - self.t0) * 1e3
        dev_us = 0.0
        for e in self.tprof.key_averages():
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                dev_us += getattr(e, "self_device_time_total", 0.0)
        log(f"profile {self.label}: wall_ms={wall_ms:.3f} device_ms={dev_us / 1e3:.3f} "
            f"device_busy_share={dev_us / 1e3 / wall_ms:.4f}")
        buf = io.StringIO()
        pstats.Stats(self.cprof, stream=buf).sort_stats("tottime").print_stats(12)
        lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()][-13:]
        for ln in lines:
            log(f"profile {self.label} host: {ln}")
        return False


def run_main_path(
    lineitem, orders, workdir: Path, device: str, seed: int, profile: bool = False,
    phases=PHASES,
) -> dict:
    """Build both indexes and run the three queries on ``device`` with
    residency off, then the aggregate, resident and front-end phases in the
    same session, then the lifecycle and hybrid phases, each in its own;
    every result is checked against numpy. ``phases`` (``PHASES``) names
    the ones to run: the same-session ones need "main", the lifecycle and
    hybrid phases run without it. Returns timings and counts."""
    out = {}
    if "main" in phases:
        out.update(_main_session(lineitem, orders, workdir, device, seed, profile, phases))
    if "lifecycle" in phases:
        out["lifecycle"] = lifecycle_phase(lineitem, orders, workdir, device, seed, profile)
    if "hybrid" in phases:
        out["hybrid"] = hybrid_phase(lineitem, orders, workdir, device, seed, profile)
    return out


def _main_session(lineitem, orders, workdir: Path, device: str, seed: int, profile: bool,
                  phases) -> dict:
    """The main path's session: both indexes, the three queries, then the
    aggregate, resident and front-end phases named in ``phases``."""
    import hyperspace_tpu_torch as hs
    from hyperspace_tpu_torch.ops import fence, launch_counts, reset_launch_counts
    from hyperspace_tpu_torch.plan.expr import col

    # the main path starts here: kernel launch counts from zero
    reset_launch_counts()
    t0 = time.perf_counter()
    li_dir = write_avro_dir(workdir / "src" / "lineitem", lineitem, LINEITEM_SCHEMA, 8)
    od_dir = write_avro_dir(workdir / "src" / "orders", orders, ORDERS_SCHEMA, 2)
    log(f"data: lineitem={len(lineitem['l_orderkey'])} orders={len(orders['o_orderkey'])} "
        f"rows written as avro in {time.perf_counter() - t0:.3f} s")
    conf = hs.HyperspaceConf({
        "hyperspace.system.path": str(workdir / "indexes"),
        "hyperspace.index.numBuckets": NUM_BUCKETS,
        "hyperspace.index.build.mode": "inmemory",
        "hyperspace.torch.device": device,
        # the per-file path first: with "auto" a first touch would start
        # a background upload in the middle of these queries
        "hyperspace.torch.hbm.mode": "off",
    })
    session = hs.HyperspaceSession(conf)
    hsp = hs.Hyperspace(session)
    out = {"build_s": {}, "query_s": {}, "rows": {}}
    for name, path, key, incl in (
        ("li_idx", li_dir, "l_orderkey", ["l_partkey", "l_quantity", "l_shipdate", "l_extendedprice"]),
        ("ord_idx", od_dir, "o_orderkey", ["o_custkey", "o_orderdate", "o_totalprice"]),
    ):
        t0 = time.perf_counter()
        with _Profiled(f"build {name}", profile):
            hsp.create_index(session.read.avro(path), hs.IndexConfig(name, [key], incl))
        fence(session.device)
        out["build_s"][name] = time.perf_counter() - t0
        log(f"build {name}: {out['build_s'][name]:.3f} s")

    session.enable_hyperspace()
    li, od = session.read.avro(li_dir), session.read.avro(od_dir)
    L, O = lineitem, orders
    k = int(L["l_orderkey"][len(L["l_orderkey"]) // 2])
    top = int(L["l_orderkey"].max())
    lo_k, hi_k, d_lo = top // 6, top // 2, DAY_1995_03_15 - 365
    queries = {
        "point_lookup": (
            li.filter(col("l_orderkey") == k).select(
                "l_orderkey", "l_quantity", "l_shipdate", "l_extendedprice"),
            ["l_orderkey", "l_quantity", "l_shipdate", "l_extendedprice"],
            L["l_orderkey"] == k,
        ),
        "range_filter": (
            li.filter((col("l_orderkey") >= lo_k) & (col("l_orderkey") < hi_k)
                      & (col("l_quantity") < 24) & (col("l_shipdate") >= d_lo)
                      & (col("l_shipdate") < DAY_1995_03_15)).select(
                "l_orderkey", "l_quantity", "l_shipdate", "l_extendedprice"),
            ["l_orderkey", "l_quantity", "l_shipdate", "l_extendedprice"],
            (L["l_orderkey"] >= lo_k) & (L["l_orderkey"] < hi_k) & (L["l_quantity"] < 24)
            & (L["l_shipdate"] >= d_lo) & (L["l_shipdate"] < DAY_1995_03_15),
        ),
    }
    # Q3-shaped: lineitem shipped after a date joined to orders placed
    # before another, on the order key
    q3 = li.filter(col("l_shipdate") > DAY_1993_06_01).select(
        "l_orderkey", "l_extendedprice", "l_shipdate"
    ).join(
        od.filter(col("o_orderdate") < DAY_1995_03_15).select(
            "o_orderkey", "o_orderdate", "o_totalprice"),
        col("l_orderkey") == col("o_orderkey"),
    )
    lm = L["l_shipdate"] > DAY_1993_06_01
    om = O["o_orderdate"] < DAY_1995_03_15
    pos = np.searchsorted(O["o_orderkey"], L["l_orderkey"][lm])  # orders keys ascend
    hit = om[pos]
    q3_want = [
        L["l_orderkey"][lm][hit], L["l_extendedprice"][lm][hit], L["l_shipdate"][lm][hit],
        O["o_orderkey"][pos[hit]], O["o_orderdate"][pos[hit]], O["o_totalprice"][pos[hit]],
    ]

    for q in list(queries) + ["q3_join"]:
        df = q3 if q == "q3_join" else queries[q][0]
        if "IndexScan Hyperspace(Type: CI" not in df.explain():
            raise AssertionError(f"{q}: explain shows no index scan")
    results = {}
    for q in list(queries) + ["q3_join"]:
        df = q3 if q == "q3_join" else queries[q][0]
        t0 = time.perf_counter()
        with _Profiled(f"query {q}", profile):
            results[q] = df.collect()
        fence(session.device)
        out["query_s"][q] = time.perf_counter() - t0
        out["rows"][q] = results[q].num_rows
    out["launches"] = launch_counts()
    for q, (_df, cols, mask) in queries.items():
        _check(q, results[q], cols, [L[c][mask] for c in cols])
    _check("q3_join", results["q3_join"],
           ["l_orderkey", "l_extendedprice", "l_shipdate", "o_orderkey", "o_orderdate", "o_totalprice"],
           q3_want)
    for q in out["query_s"]:
        log(f"query {q}: {out['query_s'][q]:.4f} s rows={out['rows'][q]} matches numpy reference")
    if "aggregate" in phases:
        out["aggregate"] = aggregate_phase(session, li, od, q3, L, O, profile)
    if "resident" in phases:
        out["resident"] = resident_phase(session, hsp, li, L, seed, profile)
    if "front_end" in phases:
        q3_cols = ["l_orderkey", "l_extendedprice", "l_shipdate", "o_orderkey", "o_orderdate",
                   "o_totalprice"]
        out["front_end"] = front_end_phase(
            session, hsp, li_dir, od_dir, q3, [np.asarray(results["q3_join"].columns[c].data)
                                               for c in q3_cols],
            q3_want, L, workdir, seed, profile)
    return out


# ---------------------------------------------------------------------------
# aggregate phase: TPC-H Q17/Q3/Q1/Q6 shapes over the main path's indexes
# ---------------------------------------------------------------------------
def _check_agg(name, batch, keys, want: dict):
    """Hold an aggregate's rows against numpy's: ``want`` maps each output
    column to its values in ascending order of the group keys (a single
    row for a global aggregate). Group sets and integer columns exact,
    float64 columns to rtol 1e-9 with NaN equal to NaN."""
    if batch.column_names != list(want):
        raise AssertionError(f"{name}: columns {batch.column_names}, want {list(want)}")
    n = len(next(iter(want.values())))
    if batch.num_rows != n:
        raise AssertionError(f"{name}: {batch.num_rows} groups, numpy has {n}")
    order = (np.lexsort(tuple(np.asarray(batch.columns[k].data) for k in reversed(keys)))
             if keys else np.arange(n))
    for c, w in want.items():
        g = np.asarray(batch.columns[c].data)[order]
        ok = (np.allclose(g, w, rtol=1e-9, atol=0.0, equal_nan=True) if w.dtype.kind == "f"
              else np.array_equal(g, w))
        if not ok:
            raise AssertionError(f"{name}: column {c} differs from the numpy reference")


def q17_shape(li, od):
    """The JAX package's Q17 shape (bench.py config 7): lineitem joined to
    orders, grouped by part."""
    import hyperspace_tpu_torch as hs
    from hyperspace_tpu_torch.plan.expr import col

    return li.join(od, col("l_orderkey") == col("o_orderkey")).group_by("l_partkey").agg(
        hs.agg_sum("o_totalprice", "rev"), hs.agg_avg("o_totalprice", "avg_rev"), hs.agg_count())


def q17_truth(L: dict, O: dict) -> dict:
    """numpy's answer to ``q17_shape``; every lineitem has its order."""
    o_ord = np.argsort(O["o_orderkey"], kind="stable")
    pos = o_ord[np.searchsorted(O["o_orderkey"], L["l_orderkey"], sorter=o_ord)]
    if not np.array_equal(O["o_orderkey"][pos], L["l_orderkey"]):
        raise AssertionError("q17 truth: a lineitem without its order")
    uniq, inv = np.unique(L["l_partkey"], return_inverse=True)
    rev = np.bincount(inv.reshape(-1), weights=O["o_totalprice"][pos], minlength=len(uniq))
    cnt = np.bincount(inv.reshape(-1), minlength=len(uniq)).astype(np.int64)
    return {"l_partkey": uniq, "rev": rev, "avg_rev": rev / cnt, "count": cnt}


def aggregate_phase(session, li, od, q3, L: dict, O: dict, profile: bool = False) -> dict:
    """Aggregates over li_idx and ord_idx at SF1, in the main path's
    session, residency off, each query with launch counts from zero:

    * A1 ``q17_shape``: Q17's aggregate over the join, 200,000 groups; the
      group key is on lineitem's side, so the executor fuses the join's
      match ranges (K2 and its fence build once) into the aggregate;
    * A2 ``q3_grouped``: the main path's Q3 ending as TPC-H Q3 ends,
      grouped by (l_orderkey, o_orderdate) — keys on both sides, so the
      join is materialized (K2 once) and hash-aggregated;
    * A3 ``q1_shape``: the range filter's order-key and ship-date windows
      through K1 (once per index file read), grouped by l_quantity (50
      groups) with all five functions, min/max over date32; then a HAVING
      filter on the count;
    * A4 ``q6_shape``: a global aggregate over the full range filter.

    Each query's explain must show the index scans under the Aggregate,
    and its result equal numpy's."""
    import hyperspace_tpu_torch as hs
    from hyperspace_tpu_torch.ops import kernels as tk
    from hyperspace_tpu_torch.plan.expr import col

    on_card = session.device.type == "cuda"
    lo_k, hi_k, d_lo = range_bounds(L)
    window = ((col("l_orderkey") >= lo_k) & (col("l_orderkey") < hi_k)
              & (col("l_shipdate") >= d_lo) & (col("l_shipdate") < DAY_1995_03_15))
    w_mask = ((L["l_orderkey"] >= lo_k) & (L["l_orderkey"] < hi_k)
              & (L["l_shipdate"] >= d_lo) & (L["l_shipdate"] < DAY_1995_03_15))
    q6_mask = w_mask & (L["l_quantity"] < 24)

    # numpy's answers
    want = {"q17_shape": q17_truth(L, O)}
    lm = L["l_shipdate"] > DAY_1993_06_01
    pos = np.searchsorted(O["o_orderkey"], L["l_orderkey"][lm])  # orders keys ascend
    hit = O["o_orderdate"][pos] < DAY_1995_03_15
    q3_key = L["l_orderkey"][lm][hit]
    uniq, first, inv = np.unique(q3_key, return_index=True, return_inverse=True)
    inv = inv.reshape(-1)
    want["q3_grouped"] = {
        "l_orderkey": uniq, "o_orderdate": O["o_orderdate"][pos[hit]][first],
        "revenue": np.bincount(inv, weights=L["l_extendedprice"][lm][hit], minlength=len(uniq)),
        "count": np.bincount(inv, minlength=len(uniq)).astype(np.int64)}
    qty, price, ship = L["l_quantity"][w_mask], L["l_extendedprice"][w_mask], L["l_shipdate"][w_mask]
    uniq, inv = np.unique(qty, return_inverse=True)
    inv = inv.reshape(-1)
    cnt = np.bincount(inv, minlength=len(uniq)).astype(np.int64)
    s = np.bincount(inv, weights=price, minlength=len(uniq))
    mins = np.full(len(uniq), np.iinfo(np.int32).max, dtype=np.int32)
    maxs = np.full(len(uniq), np.iinfo(np.int32).min, dtype=np.int32)
    np.minimum.at(mins, inv, ship)
    np.maximum.at(maxs, inv, ship)
    want["q1_shape"] = {"l_quantity": uniq, "sum_l_extendedprice": s,
                        "avg_l_extendedprice": s / cnt, "min_l_shipdate": mins,
                        "max_l_shipdate": maxs, "count": cnt}
    floor = int(np.median(cnt))
    keep = cnt > floor
    want["q1_having"] = {c: v[keep] for c, v in want["q1_shape"].items()}
    want["q6_shape"] = {"sum_l_extendedprice": np.array([L["l_extendedprice"][q6_mask].sum()]),
                        "count": np.array([int(q6_mask.sum())], dtype=np.int64)}

    q1 = li.filter(window).group_by("l_quantity").agg(
        hs.agg_sum("l_extendedprice"), hs.agg_avg("l_extendedprice"), hs.agg_min("l_shipdate"),
        hs.agg_max("l_shipdate"), hs.agg_count())
    queries = {
        # name: (DataFrame, group keys, index scans under the Aggregate, arm)
        "q17_shape": (q17_shape(li, od), ["l_partkey"], 2, "fused"),
        "q3_grouped": (q3.group_by("l_orderkey", "o_orderdate").agg(
            hs.agg_sum("l_extendedprice", "revenue"), hs.agg_count()),
            ["l_orderkey", "o_orderdate"], 2, "materialized"),
        "q1_shape": (q1, ["l_quantity"], 1, "scan"),
        "q1_having": (q1.filter(col("count") > floor), ["l_quantity"], 1, "scan"),
        "q6_shape": (li.filter(window & (col("l_quantity") < 24)).group_by().agg(
            hs.agg_sum("l_extendedprice"), hs.agg_count()), [], 1, "scan"),
    }
    out = {}
    for name, (df, keys, n_scans, arm) in queries.items():
        plan = plan_with_indexes(df)
        body = plan.split("Aggregate [", 1)
        if len(body) != 2 or body[1].count("IndexScan Hyperspace(Type: CI") != n_scans:
            raise AssertionError(f"aggregate {name}: explain shows no Aggregate over "
                                 f"{n_scans} index scans:\n{plan}")
        res, t_q, launches, m, _times = timed_query(session, f"aggregate {name}", profile, df)
        _check_agg(f"aggregate {name}", res, keys, want[name])
        fused = m.get("aggregate.path.join_fused", 0)
        join_arm = [k for k in ("join.path.device_kernel", "join.path.host_searchsorted")
                    if m.get(k, 0)]
        read = m.get("scan.files_read", 0)
        k2_want = (1 if on_card else 0) if arm != "scan" else 0
        if (launches.get(tk.K2, 0), launches.get(tk.K2F, 0)) != (k2_want, k2_want) or \
                fused != (1 if arm == "fused" else 0):
            raise AssertionError(f"aggregate {name}: launches {launches}, counters {m}")
        if arm == "scan" and (read <= 0 or launches.get(tk.K1, 0) != (read if on_card else 0)):
            raise AssertionError(f"aggregate {name}: K1 launches {launches}, files read {read}")
        out[name] = {"s": t_q, "groups": res.num_rows, "launches": launches, "arm": arm,
                     "join_fused": fused, "join_path": join_arm, "files_read": read,
                     "aggregate_total_s": _times.get("aggregate.total", (0.0, 0))[0],
                     "aggregate_join_ranges_s": _times.get("aggregate.join_ranges", (0.0, 0))[0],
                     "join_bucketed_ranges_s": _times.get("join.bucketed_ranges", (0.0, 0))[0]}
        log(f"aggregate {name}: {t_q:.4f} s groups={res.num_rows} arm={arm} "
            f"join_fused={fused} join path={join_arm} files read={read} launches={launches} "
            f"| timers aggregate.total={out[name]['aggregate_total_s']:.4f} s "
            f"aggregate.join_ranges={out[name]['aggregate_join_ranges_s']:.4f} s "
            f"join.bucketed_ranges={out[name]['join_bucketed_ranges_s']:.4f} s "
            f"| matches numpy")
    return out


def resident_phase(session, hsp, li, L, seed: int, profile: bool = False) -> dict:
    """The resident path, in the main path's session: prefetch li_idx's
    predicate columns, then point lookups, the range filter and a filter
    with a float64 bound through K1c. Launch and path counts start from
    zero here; each query is then repeated with residency off (the
    per-file path) and both results are held against numpy."""
    from hyperspace_tpu_torch.exec.hbm_cache import hbm_cache
    from hyperspace_tpu_torch.ops import fence, launch_counts, reset_launch_counts
    from hyperspace_tpu_torch.ops.kernels import K1, K1C
    from hyperspace_tpu_torch.plan.expr import col
    from hyperspace_tpu_torch.telemetry.metrics import metrics

    session.conf.set("hyperspace.torch.hbm.mode", "auto")
    t0 = time.perf_counter()
    if not hsp.prefetch_index("li_idx", LI_RESIDENT):
        raise AssertionError("prefetch_index(li_idx) did not make the index resident")
    hbm_cache.wait_background()
    fence(session.device)
    out = {"prefetch_s": time.perf_counter() - t0,
           "resident_mb": sum(t["mb"] for t in hbm_cache.snapshot_residency()["tables"])}
    log(f"resident: prefetch_index(li_idx, {len(LI_RESIDENT)} columns) "
        f"{out['prefetch_s']:.3f} s, {out['resident_mb']} MB on {session.device}")

    rng = np.random.default_rng(seed + 2)
    keys = rng.choice(np.unique(L["l_orderkey"]), 20, replace=False)
    top = int(L["l_orderkey"].max())
    lo_k, hi_k, d_lo = top // 6, top // 2, DAY_1995_03_15 - 365
    ok = L["l_orderkey"]
    shapes = {
        "point_lookup": [(col("l_orderkey") == int(k), ok == k) for k in keys],
        "range_filter": [(
            (col("l_orderkey") >= lo_k) & (col("l_orderkey") < hi_k) & (col("l_quantity") < 24)
            & (col("l_shipdate") >= d_lo) & (col("l_shipdate") < DAY_1995_03_15),
            (ok >= lo_k) & (ok < hi_k) & (L["l_quantity"] < 24)
            & (L["l_shipdate"] >= d_lo) & (L["l_shipdate"] < DAY_1995_03_15),
        )] * 5,
        "f64_filter": [(
            (col("l_orderkey") >= lo_k) & (col("l_orderkey") < hi_k)
            & (col("l_extendedprice") > 50000.0),
            (ok >= lo_k) & (ok < hi_k) & (L["l_extendedprice"] > 50000.0),
        )] * 5,
    }
    n_queries = sum(len(v) for v in shapes.values())

    def run(pred):
        t = time.perf_counter()
        res = li.filter(pred).select(*LI_RESIDENT).collect()
        fence(session.device)
        return res, time.perf_counter() - t

    # the resident path starts here: launch and path counts from zero
    reset_launch_counts()
    metrics.reset()
    resident, touched_by = {}, {}
    for q, qs in shapes.items():
        before = metrics.get("scan.resident.blocks_touched")
        with _Profiled(f"resident {q} x{len(qs)}", profile):
            resident[q] = [run(p) for p, _ in qs]
        touched_by[q] = metrics.get("scan.resident.blocks_touched") - before
    launches = launch_counts()
    served = metrics.get("scan.path.resident_device")
    touched = metrics.get("scan.resident.blocks_touched")
    total = metrics.get("scan.resident.blocks_total")
    # on the CPU (a rehearsal) the kernels' plain versions run: no launch
    k1c_want = n_queries if session.device.type == "cuda" else 0
    if served != n_queries or launches.get(K1C, 0) != k1c_want or launches.get(K1, 0):
        raise AssertionError(
            f"resident path: {served} of {n_queries} queries served resident, "
            f"launches {launches}"
        )
    session.conf.set("hyperspace.torch.hbm.mode", "off")
    per_file = {q: [run(p) for p, _ in qs] for q, qs in shapes.items()}
    for q, qs in shapes.items():
        for i, (_p, mask) in enumerate(qs):
            want = [L[c][mask] for c in LI_RESIDENT]
            _check(f"resident {q}[{i}]", resident[q][i][0], LI_RESIDENT, want)
            _check(f"per-file {q}[{i}]", per_file[q][i][0], LI_RESIDENT, want)
    out.update(launches=launches, queries=n_queries, blocks_touched=touched,
               blocks_total=total, shapes={})
    for q in shapes:
        rs = [t for _r, t in resident[q]]
        ps = [t for _r, t in per_file[q]]
        out["shapes"][q] = dict(
            n=len(rs), rows=resident[q][0][0].num_rows, blocks_touched=touched_by[q],
            resident_median_s=float(np.median(rs)), resident_p90_s=float(np.percentile(rs, 90)),
            per_file_median_s=float(np.median(ps)), per_file_p90_s=float(np.percentile(ps, 90)))
        sh = out["shapes"][q]
        log(f"resident {q}: n={sh['n']} blocks_touched={sh['blocks_touched']} "
            f"median={sh['resident_median_s']:.4f} s "
            f"p90={sh['resident_p90_s']:.4f} s | per-file median={sh['per_file_median_s']:.4f} s "
            f"p90={sh['per_file_p90_s']:.4f} s | results match numpy and per-file")
    log(f"resident: {n_queries} queries, {launches.get(K1C, 0)} K1c launches, "
        f"K1 launches {launches.get(K1, 0)}, blocks touched {touched} of {total}")
    return out


def _scan_files_kept(df) -> int:
    """The source files the optimized plan's one Scan still reads."""
    from hyperspace_tpu_torch.plan.ir import Scan

    scans = df.optimized_plan().collect(lambda n: isinstance(n, Scan))
    if len(scans) != 1:
        raise AssertionError(f"expected one source scan, found {len(scans)}")
    return len(scans[0].relation.files)


def _indexes_used(df) -> str:
    return df.explain().split("Indexes used:")[1]


def front_end_phase(session, hsp, li_dir, od_dir, q3_hand, q3_hand_rows, q3_want, L,
                    workdir: Path, seed: int, profile: bool = False) -> dict:
    """The query front end at SF1, after the resident phase, residency
    off. (1) Q3 written the natural way, a join with one filter and one
    select above it: pushdown and pruning must let JoinIndexRule rewrite
    it to li_idx and ord_idx, and it must run through K2. (2) lineitem
    again as a hive-partitioned source, ``l_shipyear=YYYY/part-NNN.avro``
    (7 years x 4 files in order-key order; the partition column is not in
    the files): a partition-pruned scan with Hyperspace off, then a
    covering index li_year_idx built on the card and a filter it serves
    through K1. (3) a data-skipping index li_year_skip (min/max on
    l_orderkey, a bloom filter on l_partkey) pruning the files of a
    2,000-key window and serving a point filter on l_partkey. Launch counts
    start from zero before each query that must launch a kernel; every
    result is held against numpy."""
    import hyperspace_tpu_torch as hs
    from hyperspace_tpu_torch.index.sketches import BloomFilterSketch, MinMaxSketch
    from hyperspace_tpu_torch.ops import fence, launch_counts, reset_launch_counts
    from hyperspace_tpu_torch.ops.kernels import K1, K2, K2F
    from hyperspace_tpu_torch.plan.expr import col
    from hyperspace_tpu_torch.telemetry.metrics import metrics

    on_card = session.device.type == "cuda"
    out = {}

    def timed(label, df):
        t = time.perf_counter()
        with _Profiled(f"front end {label}", profile):
            res = df.collect()
        fence(session.device)
        return res, time.perf_counter() - t

    # (1) Q3 as users write it: no select or filter under the join
    session.conf.set("hyperspace.torch.hbm.mode", "off")
    li, od = session.read.avro(li_dir), session.read.avro(od_dir)
    q3_cols = ["l_orderkey", "l_extendedprice", "l_shipdate", "o_orderkey", "o_orderdate",
               "o_totalprice"]
    natural = li.join(od, col("l_orderkey") == col("o_orderkey")).filter(
        (col("l_shipdate") > DAY_1993_06_01) & (col("o_orderdate") < DAY_1995_03_15)
    ).select(*q3_cols)
    used = _indexes_used(natural)
    if "li_idx:" not in used or "ord_idx:" not in used:
        raise AssertionError(f"natural Q3: explain's indexes used are {used.split()}")
    reset_launch_counts()
    metrics.reset()
    nat, t_nat = timed("natural Q3", natural)
    launches = launch_counts()
    want_k2 = 1 if on_card else 0
    if (launches.get(K2, 0), launches.get(K2F, 0)) != (want_k2, want_k2) or not (
        metrics.get("join.path.device_kernel") + metrics.get("join.path.host_searchsorted")
    ):
        raise AssertionError(f"natural Q3 did not run the bucketed join through K2: "
                             f"launches {launches}")
    _check("natural Q3", nat, q3_cols, q3_want)
    _check("natural Q3 against the hand-placed Q3", nat, q3_cols, q3_hand_rows)
    # then both in turns, so that the host's drift falls on both alike
    t_nats, t_hands = [t_nat], []
    for _ in range(3):
        t_hands.append(timed("hand-placed Q3", q3_hand)[1])
        t_nats.append(timed("natural Q3 again", natural)[1])
    out["q3"] = {"natural_s": t_nats, "hand_placed_s": t_hands,
                 "rows": nat.num_rows, "launches": launches}
    log(f"front end: natural Q3 median {np.median(t_nats):.4f} s {[round(t, 4) for t in t_nats]} "
        f"| hand-placed Q3 median {np.median(t_hands):.4f} s {[round(t, 4) for t in t_hands]} "
        f"| rows={nat.num_rows} | li_idx and ord_idx used | launches of the first natural run "
        f"{launches} | matches numpy and the hand-placed Q3")

    # (2) hive-partitioned lineitem: l_shipyear=YYYY/part-NNN.avro
    from hyperspace_tpu_torch.storage.avro_io import write_avro
    from hyperspace_tpu_torch.storage.columnar import ColumnarBatch

    t0 = time.perf_counter()
    years = (L["l_shipdate"].astype("datetime64[D]").astype("datetime64[Y]")
             .astype(np.int64) + 1970)
    part_dir = workdir / "src" / "lineitem_by_year"
    n_files = 0
    file_of_row = np.empty(len(years), dtype=np.int64)
    for y in np.unique(years):
        rows = np.flatnonzero(years == y)  # ascending l_orderkey
        for i, chunk in enumerate(np.array_split(rows, 4)):
            file_of_row[chunk] = n_files
            batch = ColumnarBatch.from_pydict({k: v[chunk] for k, v in L.items()},
                                              schema=LINEITEM_SCHEMA)
            write_avro(part_dir / f"l_shipyear={int(y)}" / f"part-{i:03d}.avro", batch)
            n_files += 1
    out["partitioned_write_s"] = time.perf_counter() - t0
    log(f"front end: lineitem written as {n_files} files under "
        f"{len(np.unique(years))} l_shipyear directories in {out['partitioned_write_s']:.3f} s")
    fe = hs.HyperspaceSession(hs.HyperspaceConf({
        "hyperspace.system.path": str(workdir / "indexes_partitioned"),
        "hyperspace.index.numBuckets": NUM_BUCKETS,
        "hyperspace.index.build.mode": "inmemory",
        "hyperspace.torch.device": session.device.type,
        "hyperspace.torch.hbm.mode": "off",
    }))
    fe_hs = hs.Hyperspace(fe)
    src = fe.read.avro(str(part_dir))
    spec = src.plan.relation.partition_spec
    if spec is None or spec.columns != (("l_shipyear", "int64"),):
        raise AssertionError(f"partition discovery: {spec}")
    cols4 = ["l_orderkey", "l_quantity", "l_shipyear", "l_extendedprice"]
    Ly = dict(L, l_shipyear=years)
    metrics.reset()
    pruned_q = src.filter((col("l_shipyear") == 1995) & (col("l_quantity") < 24)).select(*cols4)
    res, t_pruned = timed("partition-pruned scan", pruned_q)
    files_read = n_files - metrics.get("scan.partition_pruned")
    if files_read != 4:
        raise AssertionError(f"partition-pruned scan read {files_read} of {n_files} files")
    _check("partition-pruned scan", res, cols4,
           [Ly[c][(years == 1995) & (L["l_quantity"] < 24)] for c in cols4])
    out["partition_pruned"] = {"s": t_pruned, "files_read": files_read, "files": n_files,
                               "rows": res.num_rows}
    log(f"front end: Hyperspace off, l_shipyear == 1995 & l_quantity < 24: {t_pruned:.4f} s, "
        f"{files_read} of {n_files} files read, rows={res.num_rows}, matches numpy")

    t0 = time.perf_counter()
    fe_hs.create_index(src, hs.IndexConfig(
        "li_year_idx", ["l_orderkey"], ["l_shipyear", "l_quantity", "l_extendedprice"]))
    fence(fe.device)
    out["li_year_idx_build_s"] = time.perf_counter() - t0
    schema = fe.collection_manager.get_indexes()[0].derived_dataset.schema
    if schema.get("l_shipyear") != "int64":
        raise AssertionError(f"li_year_idx schema: {schema}")
    log(f"front end: build li_year_idx (over the partitioned source, l_shipyear held as "
        f"int64): {out['li_year_idx_build_s']:.3f} s")
    fe.enable_hyperspace()
    top = int(L["l_orderkey"].max())
    lo_k, hi_k = top // 3, top // 3 + top // 20
    ok = L["l_orderkey"]
    year_q = fe.read.avro(str(part_dir)).filter(
        (col("l_orderkey") >= lo_k) & (col("l_orderkey") < hi_k) & (col("l_shipyear") == 1995)
    ).select(*cols4)
    if "li_year_idx:" not in _indexes_used(year_q):
        raise AssertionError("the partitioned filter is not served by li_year_idx")
    reset_launch_counts()
    res, t_year = timed("li_year_idx filter", year_q)
    k1_launches = launch_counts().get(K1, 0)
    if on_card and k1_launches <= 0:
        raise AssertionError("the li_year_idx filter did not launch K1")
    _check("li_year_idx filter", res, cols4,
           [Ly[c][(ok >= lo_k) & (ok < hi_k) & (years == 1995)] for c in cols4])
    out["li_year_idx_filter"] = {"s": t_year, "rows": res.num_rows, "k1_launches": k1_launches}
    log(f"front end: li_year_idx filter {t_year:.4f} s rows={res.num_rows} "
        f"K1 launches={k1_launches}, matches numpy")

    # (3) data-skipping index over the partitioned source
    t0 = time.perf_counter()
    fe_hs.create_index(fe.read.avro(str(part_dir)), hs.DataSkippingIndexConfig(
        "li_year_skip", [MinMaxSketch("l_orderkey"), BloomFilterSketch("l_partkey")]))
    out["li_year_skip_build_s"] = time.perf_counter() - t0
    log(f"front end: build li_year_skip (min/max l_orderkey, bloom l_partkey, "
        f"{n_files} files): {out['li_year_skip_build_s']:.3f} s")
    rng = np.random.default_rng(seed + 3)
    w0 = int(rng.integers(0, top - 2000))
    window = fe.read.avro(str(part_dir)).filter(
        (col("l_orderkey") >= w0) & (col("l_orderkey") < w0 + 2000)
    ).select("l_orderkey", "l_partkey")
    if "li_year_skip:" not in _indexes_used(window):
        raise AssertionError("the order-key window is not pruned by li_year_skip")
    kept = _scan_files_kept(window)
    if kept > 14:
        raise AssertionError(f"li_year_skip kept {kept} of {n_files} files")
    res, t_window = timed("li_year_skip window", window)
    wmask = (ok >= w0) & (ok < w0 + 2000)
    _check("li_year_skip window", res, ["l_orderkey", "l_partkey"],
           [L["l_orderkey"][wmask], L["l_partkey"][wmask]])
    pk = int(L["l_partkey"][int(rng.integers(0, len(ok)))])
    point = fe.read.avro(str(part_dir)).filter(col("l_partkey") == pk).select(
        "l_orderkey", "l_partkey", "l_shipyear")
    kept_point = _scan_files_kept(point)
    res_p, t_point = timed("li_year_skip bloom point", point)
    pmask = L["l_partkey"] == pk
    _check("li_year_skip bloom point", res_p, ["l_orderkey", "l_partkey", "l_shipyear"],
           [L["l_orderkey"][pmask], L["l_partkey"][pmask], years[pmask]])
    out["skipping"] = {
        "window": {"s": t_window, "files_kept": kept, "rows": res.num_rows},
        "bloom_point": {"s": t_point, "files_kept": kept_point, "rows": res_p.num_rows,
                        "files_with_key": int(len(np.unique(file_of_row[pmask])))},
    }
    log(f"front end: li_year_skip order-key window [{w0}, {w0 + 2000}): {t_window:.4f} s, "
        f"{kept} of {n_files} files kept, rows={res.num_rows}, matches numpy")
    log(f"front end: li_year_skip l_partkey == {pk}: {t_point:.4f} s, {kept_point} of "
        f"{n_files} files kept ({out['skipping']['bloom_point']['files_with_key']} hold the "
        f"key), rows={res_p.num_rows}, matches numpy")
    return out


# ---------------------------------------------------------------------------
# lifecycle phase: TPC-H's refresh functions against two maintained indexes
# ---------------------------------------------------------------------------
def rf1_batches(orders: dict, seed: int, n_new: int, n_batches: int = 2,
                n_parts: int = 200_000):
    """TPC-H RF1 (specification clause 2.5): ``n_new`` new orders a batch
    (SF x 1,500), each with 1 to 7 lineitems. Their keys take dbgen's unused
    slots, offsets 8..31 of each 32-key block (``make_tables`` fills
    offsets 0..7), so new keys interleave with old ones in every bucket.
    Returns [(lineitem part, orders part)] per batch."""
    rng = np.random.default_rng(seed + 4)
    n_blocks = (len(orders["o_orderkey"]) + 7) // 8
    slots = rng.choice(n_blocks * 24, n_batches * n_new, replace=False)
    keys = (slots // 24) * 32 + (slots % 24) + 9
    out = []
    for b in range(n_batches):
        ok = np.sort(keys[b * n_new:(b + 1) * n_new]).astype(np.int64)
        o_orderdate = rng.integers(DAY_1992_01_01, DAY_1998_08_02 - 151, n_new).astype(np.int32)
        od = {"o_orderkey": ok,
              "o_custkey": rng.integers(1, 150_001, n_new).astype(np.int64),
              "o_orderdate": o_orderdate,
              "o_totalprice": np.round(rng.uniform(850.0, 560_000.0, n_new), 2)}
        counts = rng.integers(1, 8, n_new)
        n = int(counts.sum())
        qty = rng.integers(1, 51, n).astype(np.int64)
        li = {"l_orderkey": np.repeat(ok, counts),
              "l_partkey": rng.integers(1, n_parts + 1, n).astype(np.int64),
              "l_quantity": qty,
              "l_shipdate": (np.repeat(o_orderdate, counts)
                             + rng.integers(1, 122, n)).astype(np.int32),
              "l_extendedprice": np.round(qty * rng.uniform(900.0, 2100.0, n), 2)}
        out.append((li, od))
    return out


R_COLS = ["l_orderkey", "l_quantity", "l_shipdate", "l_extendedprice"]
Q3_COLS = ["l_orderkey", "l_extendedprice", "l_shipdate", "o_orderkey", "o_orderdate",
           "o_totalprice"]


def timed_verb(session, phase: str, profile: bool, fn, *args) -> float:
    """Seconds one verb takes, the card fenced after it."""
    from hyperspace_tpu_torch.ops import fence

    t = time.perf_counter()
    with _Profiled(f"{phase} {fn.__name__}{args}", profile):
        fn(*args)
    fence(session.device)
    return time.perf_counter() - t


def timed_query(session, label: str, profile: bool, df):
    """Collect ``df`` with launch counts and metrics from zero: (result,
    seconds, launches, counters, timers)."""
    from hyperspace_tpu_torch.ops import fence, launch_counts, reset_launch_counts
    from hyperspace_tpu_torch.telemetry.metrics import metrics

    reset_launch_counts()
    metrics.reset()
    t = time.perf_counter()
    with _Profiled(label, profile):
        res = df.collect()
    fence(session.device)
    return res, time.perf_counter() - t, launch_counts(), metrics.snapshot(), metrics.timings()


def plan_with_indexes(df) -> str:
    """The "Plan with indexes" section of ``explain()``."""
    return df.explain().split("Plan without indexes")[0]


def range_bounds(lineitem) -> tuple:
    """The range filter's order-key window and ship-date floor."""
    top = int(lineitem["l_orderkey"].max())
    return top // 6, top // 2, DAY_1995_03_15 - 365


def range_and_q3(session, li_dir, od_dir, bounds):
    """The range filter and Q3 over the sources as users write them."""
    from hyperspace_tpu_torch.plan.expr import col

    lo_k, hi_k, d_lo = bounds
    li, od = session.read.avro(str(li_dir)), session.read.avro(str(od_dir))
    rng_q = li.filter((col("l_orderkey") >= lo_k) & (col("l_orderkey") < hi_k)
                      & (col("l_quantity") < 24) & (col("l_shipdate") >= d_lo)
                      & (col("l_shipdate") < DAY_1995_03_15)).select(*R_COLS)
    q3 = li.filter(col("l_shipdate") > DAY_1993_06_01).select(
        "l_orderkey", "l_extendedprice", "l_shipdate").join(
        od.filter(col("o_orderdate") < DAY_1995_03_15).select(
            "o_orderkey", "o_orderdate", "o_totalprice"),
        col("l_orderkey") == col("o_orderkey"))
    return rng_q, q3


def range_and_q3_truth(L: dict, O: dict, bounds, where: str):
    """numpy's answers to ``range_and_q3`` over the rows ``L`` and ``O``."""
    lo_k, hi_k, d_lo = bounds
    m = ((L["l_orderkey"] >= lo_k) & (L["l_orderkey"] < hi_k) & (L["l_quantity"] < 24)
         & (L["l_shipdate"] >= d_lo) & (L["l_shipdate"] < DAY_1995_03_15))
    o_ord = np.argsort(O["o_orderkey"])
    lm = L["l_shipdate"] > DAY_1993_06_01
    pos = o_ord[np.searchsorted(O["o_orderkey"], L["l_orderkey"][lm], sorter=o_ord)]
    if not np.array_equal(O["o_orderkey"][pos], L["l_orderkey"][lm]):
        raise AssertionError(f"{where}: a lineitem without its order in the source")
    hit = O["o_orderdate"][pos] < DAY_1995_03_15
    q3 = [L["l_orderkey"][lm][hit], L["l_extendedprice"][lm][hit], L["l_shipdate"][lm][hit],
          O["o_orderkey"][pos[hit]], O["o_orderdate"][pos[hit]], O["o_totalprice"][pos[hit]]]
    return [L[c][m] for c in R_COLS], q3


def lifecycle_phase(lineitem, orders, workdir: Path, device: str, seed: int,
                    profile: bool = False) -> dict:
    """The index lifecycle after create, in its own session with lineage
    on: the SF1 rows written anew as ``src/lineitem_lc`` (8 avro files) and
    ``src/orders_lc`` (2), covering indexes li_lc and ord_lc (200 buckets),
    then TPC-H's refresh functions as a data lake sees them: RF1 appends
    one avro file of new orders and their lineitems to each source, RF2
    removes such a file. Steps: baseline; RF1 batch a appended (queries
    fall back to the source) and refreshed incrementally; batch b the same;
    RF2 of batch a through the lineage rewrite; optimize quick then full;
    the resident range filter through K1c; batch a appended again and
    refreshed quick (served through the hybrid transformation, hybrid scan
    off); a full refresh;
    delete, restore, a hand-written REFRESHING head and cancel, delete and
    vacuum. Every step is timed; launch counts start from zero before each
    query; every result is held against numpy over the source as it
    stands."""
    import hyperspace_tpu_torch as hs
    from hyperspace_tpu_torch.exec.hbm_cache import hbm_cache
    from hyperspace_tpu_torch.index.log_manager import IndexLogManagerImpl
    from hyperspace_tpu_torch.ops import fence
    from hyperspace_tpu_torch.ops.kernels import K1, K1C, K2, K2F
    from hyperspace_tpu_torch.plan.expr import col
    from hyperspace_tpu_torch.storage import layout
    from hyperspace_tpu_torch.storage.avro_io import write_avro
    from hyperspace_tpu_torch.storage.columnar import ColumnarBatch

    on_card = device == "cuda"
    n_new = max(1, int(round(1500 * len(orders["o_orderkey"]) / SF1_ORDERS)))
    batches = dict(zip(("rf1_a", "rf1_b"), rf1_batches(orders, seed, n_new)))
    t0 = time.perf_counter()
    li_dir = Path(write_avro_dir(workdir / "src" / "lineitem_lc", lineitem, LINEITEM_SCHEMA, 8))
    od_dir = Path(write_avro_dir(workdir / "src" / "orders_lc", orders, ORDERS_SCHEMA, 2))
    out = {"write_s": time.perf_counter() - t0, "rf1_orders": n_new,
           "rf1_lineitems": {k: len(li["l_orderkey"]) for k, (li, _od) in batches.items()},
           "steps": []}
    log(f"lifecycle: sources written anew in {out['write_s']:.3f} s; RF1 batches of {n_new} "
        f"orders ({out['rf1_lineitems']} lineitems)")
    present = {"base": (lineitem, orders)}  # the source as it stands, by file

    def append(name):
        li, od = batches[name]
        write_avro(li_dir / f"part-{name}.avro", ColumnarBatch.from_pydict(li, schema=LINEITEM_SCHEMA))
        write_avro(od_dir / f"part-{name}.avro", ColumnarBatch.from_pydict(od, schema=ORDERS_SCHEMA))
        present[name] = batches[name]

    def remove(name):
        (li_dir / f"part-{name}.avro").unlink()
        (od_dir / f"part-{name}.avro").unlink()
        del present[name]

    conf = {
        "hyperspace.system.path": str(workdir / "indexes_lifecycle"),
        "hyperspace.index.numBuckets": NUM_BUCKETS,
        "hyperspace.index.build.mode": "inmemory",
        "hyperspace.index.lineage.enabled": "true",
        "hyperspace.torch.device": device,
        "hyperspace.torch.hbm.mode": "off",
    }
    if not on_card:  # a rehearsal: below SF1 the zone gate would route away
        conf["hyperspace.torch.hbm.maxBlockFrac"] = 1.0
    session = hs.HyperspaceSession(hs.HyperspaceConf(conf))
    hsp = hs.Hyperspace(session)
    li_log = IndexLogManagerImpl(Path(conf["hyperspace.system.path"]) / "li_lc")
    od_log = IndexLogManagerImpl(Path(conf["hyperspace.system.path"]) / "ord_lc")

    def n_files(log_mgr) -> int:
        entry = log_mgr.get_latest_stable_log()
        return len(entry.content.files()) if entry is not None and entry.state == "ACTIVE" else 0

    verb = functools.partial(timed_verb, session, "lifecycle", profile)

    t_create = verb(hsp.create_index, session.read.avro(str(li_dir)), hs.IndexConfig(
        "li_lc", ["l_orderkey"], ["l_partkey", "l_quantity", "l_shipdate", "l_extendedprice"]))
    t_create += verb(hsp.create_index, session.read.avro(str(od_dir)), hs.IndexConfig(
        "ord_lc", ["o_orderkey"], ["o_custkey", "o_orderdate", "o_totalprice"]))
    session.enable_hyperspace()

    bounds = range_bounds(lineitem)
    lo_k, hi_k, _d_lo = bounds
    r_cols, q3_cols = R_COLS, Q3_COLS

    def queries():
        return range_and_q3(session, li_dir, od_dir, bounds)

    def truth():
        L = {c: np.concatenate([p[0][c] for p in present.values()]) for c in lineitem}
        O = {c: np.concatenate([p[1][c] for p in present.values()]) for c in orders}
        return range_and_q3_truth(L, O, bounds, "lifecycle")

    def run(label, df):
        return timed_query(session, f"lifecycle {label}", profile, df)[:4]

    def measure(step, verb_s, *, rewritten, q3=True, expect_files=None):
        """Run the range filter (and Q3) and hold them against numpy."""
        files, od_files = n_files(li_log), n_files(od_log)
        if expect_files is not None and files != expect_files:
            raise AssertionError(f"lifecycle {step}: {files} li_lc files, want {expect_files}")
        want_r, want_q3 = truth()
        rng_q, q3_q = queries()
        used = rng_q.explain().split("Indexes used:")[1]
        if ("li_lc:" in used) != rewritten:
            raise AssertionError(f"lifecycle {step}: range filter indexes used {used.split()}")
        res, t_r, launches, m = run(f"{step} range", rng_q)
        _check(f"lifecycle {step} range filter", res, r_cols, want_r)
        read = m.get("scan.files_read", 0)
        k1 = launches.get(K1, 0)
        if read > files:
            raise AssertionError(f"lifecycle {step}: the scan read {read} of {files} files")
        if k1 != (read if on_card and rewritten else 0):
            raise AssertionError(f"lifecycle {step}: K1 launches {k1}, index files read {read}")
        row = {"step": step, "verb_s": verb_s, "li_lc_files": files, "ord_lc_files": od_files,
               "range_s": t_r,
               "range_rows": res.num_rows, "range_files_read": read, "range_launches": launches,
               "rewritten": rewritten}
        text = (f"lifecycle {step}: verb {verb_s:.3f} s | li_lc files={files} ord_lc files="
                f"{od_files} | range filter "
                f"{t_r:.4f} s rows={res.num_rows} rewritten={rewritten} files read={read} "
                f"launches={launches}")
        if q3:
            used3 = q3_q.explain().split("Indexes used:")[1]
            if (("li_lc:" in used3) and ("ord_lc:" in used3)) != rewritten:
                raise AssertionError(f"lifecycle {step}: Q3 indexes used {used3.split()}")
            res3, t_q3, l3, m3 = run(f"{step} Q3", q3_q)
            _check(f"lifecycle {step} Q3", res3, q3_cols, want_q3)
            bucketed = rewritten and not (m3.get("join.path.device_kernel", 0)
                                          + m3.get("join.path.host_searchsorted", 0) == 0)
            want_k2 = 1 if on_card and rewritten else l3.get(K2, 0)
            if (l3.get(K2, 0), l3.get(K2F, 0)) != (want_k2, want_k2) or (rewritten and not bucketed):
                raise AssertionError(f"lifecycle {step}: Q3 launches {l3}, paths {m3}")
            row.update(q3_s=t_q3, q3_rows=res3.num_rows, q3_launches=l3,
                       q3_join_path={k: v for k, v in m3.items() if k.startswith("join.path")})
            text += f" | Q3 {t_q3:.4f} s rows={res3.num_rows} launches={l3}"
        out["steps"].append(row)
        log(text + " | matches numpy")
        return row

    measure("1 baseline", t_create, rewritten=True, expect_files=NUM_BUCKETS)

    append("rf1_a")
    measure("2 rf1_a appended, before refresh", 0.0, rewritten=False)
    t = verb(hsp.refresh_index, "li_lc", "incremental")
    t += verb(hsp.refresh_index, "ord_lc", "incremental")
    measure("2 rf1_a refreshed incrementally", t, rewritten=True)

    append("rf1_b")
    t = verb(hsp.refresh_index, "li_lc", "incremental")
    t += verb(hsp.refresh_index, "ord_lc", "incremental")
    measure("3 rf1_b refreshed incrementally", t, rewritten=True)

    gone = set(batches["rf1_a"][0]["l_orderkey"].tolist())
    remove("rf1_a")
    t = verb(hsp.refresh_index, "li_lc", "incremental")
    t += verb(hsp.refresh_index, "ord_lc", "incremental")
    row = measure("4 RF2 of rf1_a refreshed incrementally (lineage rewrite)", t, rewritten=True)
    res = session.read.avro(str(li_dir)).filter(
        (col("l_orderkey") >= lo_k) & (col("l_orderkey") < hi_k)).select("l_orderkey").collect()
    if gone & set(np.asarray(res.columns["l_orderkey"].data).tolist()):
        raise AssertionError("lifecycle: rows of the deleted RF1 file came back")

    for mode in ("quick", "full"):
        before_id = li_log.get_latest_id()
        entry = li_log.get_latest_stable_log()
        by_bucket = {}
        for f in entry.content.files():
            by_bucket.setdefault(layout.bucket_of_file(f), []).append(f)
        merged_rows = sum(layout.cached_reader(f).num_rows for fs in by_bucket.values()
                          if len(fs) > 1 for f in fs)
        t = verb(hsp.optimize_index, "li_lc", mode)
        noop = li_log.get_latest_id() == before_id
        out[f"optimize_{mode}"] = {"s": t, "rows_merged": 0 if noop else merged_rows,
                                   "buckets_merged": 0 if noop else sum(
                                       len(fs) > 1 for fs in by_bucket.values()),
                                   "no_op": noop}
        log(f"lifecycle 5 optimize_index(li_lc, {mode}): {t:.3f} s, "
            f"{out[f'optimize_{mode}']['rows_merged']} rows merged in "
            f"{out[f'optimize_{mode}']['buckets_merged']} buckets"
            + (" (a no-op: every bucket holds one file)" if noop else ""))
    measure("5 optimized", out["optimize_quick"]["s"] + out["optimize_full"]["s"],
            rewritten=True, expect_files=NUM_BUCKETS)

    # 6. the resident range filter over the optimized version
    session.conf.set("hyperspace.torch.hbm.mode", "auto" if on_card else "force")
    t = time.perf_counter()
    if not hsp.prefetch_index("li_lc", LI_RESIDENT):
        raise AssertionError("prefetch_index(li_lc) did not make the index resident")
    hbm_cache.wait_background()
    fence(session.device)
    t_pre = time.perf_counter() - t
    want_r, _ = truth()
    rng_q, _ = queries()
    res, t_res, launches, m = run("6 resident range", rng_q)
    session.conf.set("hyperspace.torch.hbm.mode", "off")
    per_file, _t, _l, _m = run("6 per-file range", rng_q)
    _check("lifecycle resident range filter", res, r_cols, want_r)
    _check("lifecycle per-file range filter", per_file, r_cols, want_r)
    if m.get("scan.path.resident_device", 0) != 1 or launches.get(K1C, 0) != (1 if on_card else 0) \
            or launches.get(K1, 0):
        raise AssertionError(f"lifecycle resident: launches {launches}, paths {m}")
    out["resident"] = {"prefetch_s": t_pre, "s": t_res, "rows": res.num_rows,
                       "launches": launches,
                       "blocks_touched": m.get("scan.resident.blocks_touched", 0),
                       "blocks_total": m.get("scan.resident.blocks_total", 0)}
    log(f"lifecycle 6 resident: prefetch_index(li_lc) {t_pre:.3f} s | range filter {t_res:.4f} s "
        f"rows={res.num_rows} launches={launches} blocks touched "
        f"{out['resident']['blocks_touched']} of {out['resident']['blocks_total']} | "
        f"matches numpy and the per-file result")

    append("rf1_a")
    t = verb(hsp.refresh_index, "li_lc", "quick")
    t += verb(hsp.refresh_index, "ord_lc", "quick")
    if li_log.get_latest_stable_log().source_update() is None:
        raise AssertionError("lifecycle: quick refresh recorded no source delta")
    # hybrid scan is off: the recorded delta is served through the hybrid
    # transformation all the same (the appended file's Union / BucketUnion)
    measure("7 rf1_a appended again, refreshed quick (served through Hybrid Scan)", t,
            rewritten=True)
    plans = [plan_with_indexes(df) for df in queries()]
    if "Union" not in plans[0] or "BucketUnion" not in plans[1]:
        raise AssertionError(f"lifecycle 7: plans {plans}")

    t = verb(hsp.refresh_index, "li_lc", "full")
    t += verb(hsp.refresh_index, "ord_lc", "full")
    measure("8 refreshed full", t, rewritten=True, expect_files=NUM_BUCKETS)

    # 9. delete, restore, a writer that died mid-refresh, cancel, vacuum
    t = verb(hsp.delete_index, "li_lc")
    measure("9 deleted", t, rewritten=False, q3=False)
    t = verb(hsp.restore_index, "li_lc")
    measure("9 restored", t, rewritten=True, q3=False, expect_files=NUM_BUCKETS)
    head = li_log.get_latest_log()
    head.id += 1
    head.state = "REFRESHING"
    if not li_log.write_log(head.id, head):
        raise AssertionError("lifecycle: could not write the REFRESHING head")
    session.collection_manager.clear_cache()  # written behind the session's back
    states = {s.name: s.state for s in hsp.indexes()}
    if states.get("li_lc") != "REFRESHING":
        raise AssertionError(f"lifecycle: states {states}")
    measure("9 REFRESHING head (served from the stable snapshot)", 0.0, rewritten=True,
            q3=False, expect_files=NUM_BUCKETS)
    t = verb(hsp.cancel, "li_lc")
    states = {s.name: s.state for s in hsp.indexes()}
    if states.get("li_lc") != "ACTIVE":
        raise AssertionError(f"lifecycle: after cancel, states {states}")
    measure("9 cancelled", t, rewritten=True, q3=False, expect_files=NUM_BUCKETS)
    t = verb(hsp.delete_index, "li_lc") + verb(hsp.vacuum_index, "li_lc")
    left = sorted(p.name for p in (Path(conf["hyperspace.system.path"]) / "li_lc").glob("v__=*"))
    names = [s.name for s in hsp.indexes()]
    if left or "li_lc" in names:
        raise AssertionError(f"lifecycle vacuum: version dirs {left} left, indexes {names}")
    measure("9 deleted and vacuumed", t, rewritten=False, q3=False)
    log(f"lifecycle: after vacuum no v__ directory is left and indexes() lists {names}")
    return out


# ---------------------------------------------------------------------------
# hybrid phase: indexes served while their sources gain and lose files
# ---------------------------------------------------------------------------
def hybrid_phase(lineitem, orders, workdir: Path, device: str, seed: int,
                 profile: bool = False) -> dict:
    """Hybrid Scan at SF1, in a session of its own (hybrid scan and lineage
    on, 200 buckets, residency off): the SF1 rows written anew as
    ``src/lineitem_hy`` (8 avro files) and ``src/orders_hy`` (2), covering
    indexes li_hy and ord_hy, then, never refreshing until the last step:

    * H1 baseline: the range filter and Q3 read the indexes only;
    * H2 appended: two TPC-H RF1 batches, one avro file per batch in each
      source. The range filter runs as Union(IndexScan, the 2 appended
      files read and filtered on the host); Q3 as a BucketUnion on each
      side, the appended rows hashed into the index's 200 buckets;
    * H3 RF2 and a retention delete: RF2 removes one batch from both
      sources, and one of the eight base lineitem files goes. The lineitem
      index side gains the lineage filter NOT IN over that file's id (in
      K1's program for the range filter, per bucket on the host for Q3);
    * H4 refreshed: both indexes refreshed incrementally, index only again.

    At each step the plan ``explain`` shows is checked for its nodes, the
    queries run with launch counts from zero (K1 once per index file read,
    the appended side none; K2 and its fence build once per Q3), and every
    result is held against numpy over the sources as they stand."""
    import hyperspace_tpu_torch as hs
    from hyperspace_tpu_torch.index.log_manager import IndexLogManagerImpl
    from hyperspace_tpu_torch.ops import fence
    from hyperspace_tpu_torch.ops import kernels as tk
    from hyperspace_tpu_torch.storage.avro_io import write_avro
    from hyperspace_tpu_torch.storage.columnar import ColumnarBatch

    on_card = device == "cuda"
    n_new = max(1, int(round(1500 * len(orders["o_orderkey"]) / SF1_ORDERS)))
    rf1 = dict(zip(("rf1_a", "rf1_b"), rf1_batches(orders, seed, n_new)))
    t_phase = t0 = time.perf_counter()
    li_dir = Path(write_avro_dir(workdir / "src" / "lineitem_hy", lineitem, LINEITEM_SCHEMA, 8))
    od_dir = Path(write_avro_dir(workdir / "src" / "orders_hy", orders, ORDERS_SCHEMA, 2))
    out = {"write_s": time.perf_counter() - t0, "steps": []}
    log(f"hybrid: sources written anew in {out['write_s']:.3f} s")
    # the sources as they stand, by file: the base lineitem rows as
    # write_avro_dir split them, the orders whole, and the RF1 batches
    cuts = np.linspace(0, len(lineitem["l_orderkey"]), 9).astype(np.int64)
    li_parts = {f"part-{i:03d}": {c: v[cuts[i]:cuts[i + 1]] for c, v in lineitem.items()}
                for i in range(8)}
    od_parts = {"base": orders}

    conf = {
        "hyperspace.system.path": str(workdir / "indexes_hybrid"),
        "hyperspace.index.numBuckets": NUM_BUCKETS,
        "hyperspace.index.build.mode": "inmemory",
        "hyperspace.index.lineage.enabled": "true",
        "hyperspace.index.hybridscan.enabled": "true",
        "hyperspace.torch.device": device,
        "hyperspace.torch.hbm.mode": "off",
    }
    if not on_card:  # a rehearsal: the zone gate would route small tables away
        conf["hyperspace.torch.hbm.maxBlockFrac"] = 1.0
    session = hs.HyperspaceSession(hs.HyperspaceConf(conf))
    hsp = hs.Hyperspace(session)
    logs = {name: IndexLogManagerImpl(Path(conf["hyperspace.system.path"]) / name)
            for name in ("li_hy", "ord_hy")}

    verb = functools.partial(timed_verb, session, "hybrid", profile)

    def byte_ratios(name, src):
        """(appended bytes / source bytes, deleted bytes / indexed bytes)."""
        entry = logs[name].get_latest_stable_log()
        indexed = {f.name: f.size for f in entry.source_file_infos()}
        current = {str(p): p.stat().st_size for p in Path(src).glob("*.avro")}
        appended = sum(v for k, v in current.items() if k not in indexed)
        deleted = sum(v for k, v in indexed.items() if k not in current)
        return appended / sum(current.values()), deleted / sum(indexed.values())

    bounds = range_bounds(lineitem)

    def truth():
        L = {c: np.concatenate([p[c] for p in li_parts.values()]) for c in lineitem}
        O = {c: np.concatenate([p[c] for p in od_parts.values()]) for c in orders}
        return range_and_q3_truth(L, O, bounds, "hybrid")

    def run(label, df):
        return timed_query(session, f"hybrid {label}", profile, df)

    def measure(step, verb_s, range_nodes, q3_nodes, absent=()):
        """Check both plans for their nodes (and for none of ``absent``),
        then run both queries and hold them against numpy."""
        want_r, want_q3 = truth()
        rng_q, q3_q = range_and_q3(session, li_dir, od_dir, bounds)
        plans = {"range": plan_with_indexes(rng_q), "Q3": plan_with_indexes(q3_q)}
        for q, need in (("range", range_nodes), ("Q3", q3_nodes)):
            missing = [n for n in need if n not in plans[q]]
            found = [n for n in absent if n in plans[q]]
            if missing or found:
                raise AssertionError(f"hybrid {step} {q}: plan lacks {missing} or shows "
                                     f"{found}:\n{plans[q]}")
        row = {"step": step, "verb_s": verb_s, "range_nodes": list(range_nodes),
               "q3_nodes": list(q3_nodes)}
        text = f"hybrid {step}: verb {verb_s:.3f} s"
        for q, df, cols, want in (("range", rng_q, R_COLS, want_r), ("Q3", q3_q, Q3_COLS, want_q3)):
            res, t_q, launches, m, times = run(f"{step} {q}", df)
            _check(f"hybrid {step} {q}", res, cols, want)
            read = m.get("scan.files_read", 0)
            sides = {k: v[0] for k, v in times.items() if k.startswith("union.side.")}
            moved = m.get("union.repartition.rows", 0)
            if q == "range":
                if read <= 0 or launches.get(tk.K1, 0) != (read if on_card else 0):
                    raise AssertionError(f"hybrid {step} range: K1 launches {launches}, "
                                         f"index files read {read}")
            else:
                want_k2 = 1 if on_card else 0
                if (launches.get(tk.K2, 0), launches.get(tk.K2F, 0)) != (want_k2, want_k2) or \
                        m.get("join.path.device_kernel", 0) + m.get("join.path.host_searchsorted",
                                                                     0) != 1:
                    raise AssertionError(f"hybrid {step} Q3: launches {launches}, paths {m}")
            key = "range" if q == "range" else "q3"
            row.update({f"{key}_s": t_q, f"{key}_rows": res.num_rows,
                        f"{key}_files_read": read, f"{key}_union_side_s": sides,
                        f"{key}_rows_repartitioned": moved, f"{key}_launches": launches})
            text += (f" | {q} {t_q:.4f} s rows={res.num_rows} files read={read} "
                     f"union sides={ {k: round(v, 4) for k, v in sides.items()} } "
                     f"rows repartitioned={moved} launches={launches}")
        out["steps"].append(row)
        log(text + f" | plan shows {list(range_nodes)} / {list(q3_nodes)} | matches numpy")
        return plans

    def delta_arm(step: str, repeats: int = 5) -> dict:
        """Delta residency on the range filter, residency auto (force on
        the CPU): li_hy's predicate planes resident, then the first query
        takes the host union and populates the delta in the background;
        the repeats each take ``scan.path.resident_hybrid``: one K1h
        launch, no K1, no read of the appended files (no
        ``union.side.source``). Rows against numpy and residency off."""
        from hyperspace_tpu_torch.exec.hbm_cache import hbm_cache
        from hyperspace_tpu_torch.telemetry.metrics import metrics

        want_r, _w = truth()
        rng_q = range_and_q3(session, li_dir, od_dir, bounds)[0]
        off, t_off, _l, _m, _t = run(f"{step} delta arm, residency off", rng_q)
        _check(f"hybrid {step} range (residency off)", off, R_COLS, want_r)
        session.conf.set("hyperspace.torch.hbm.mode", "auto" if on_card else "force")
        t = time.perf_counter()
        if not hsp.prefetch_index("li_hy", ["l_orderkey", "l_quantity", "l_shipdate"]):
            raise AssertionError(f"hybrid {step}: prefetch_index(li_hy) refused")
        fence(session.device)
        t_pre = time.perf_counter() - t
        first, t_first, l_first, m_first, tm_first = run(f"{step} delta arm first", rng_q)
        _check(f"hybrid {step} range (first, host union)", first, R_COLS, want_r)
        if m_first.get("scan.path.resident_hybrid", 0) or "union.side.source" not in tm_first:
            raise AssertionError(f"hybrid {step}: the first query did not take the host union")
        t = time.perf_counter()
        hbm_cache.wait_background()
        fence(session.device)
        t_pop = time.perf_counter() - t
        timers = metrics.timings()
        snap = hbm_cache.snapshot()
        if snap["deltas"] != 1:
            raise AssertionError(f"hybrid {step}: {snap['deltas']} deltas resident after the "
                                 f"first query")
        times, launches = [], {}
        for i in range(repeats):
            res, t_q, lq, mq, tq = run(f"{step} delta arm {i}", rng_q)
            _check(f"hybrid {step} range (resident hybrid {i})", res, R_COLS, want_r)
            if not np.array_equal(np.sort(res.columns["l_orderkey"].data),
                                  np.sort(off.columns["l_orderkey"].data)):
                raise AssertionError(f"hybrid {step}: rows differ from residency off")
            want_l = {tk.K1H: 1} if on_card else {}
            if mq.get("scan.path.resident_hybrid", 0) != 1 or lq != want_l or \
                    "union.side.source" in tq:
                raise AssertionError(f"hybrid {step} resident hybrid {i}: launches {lq}, "
                                     f"counters {mq}, timers {sorted(tq)}")
            times.append(t_q)
            for k, v in lq.items():
                launches[k] = launches.get(k, 0) + v
        session.conf.set("hyperspace.torch.hbm.mode", "off")
        rec = {"prefetch_s": t_pre, "first_s": t_first, "first_launches": l_first,
               "first_union_side_s": {k: v[0] for k, v in tm_first.items()
                                      if k.startswith("union.side.")},
               "populate_wait_s": t_pop,
               "delta_prefetch_s": timers.get("hbm.delta.prefetch", (0.0, 0))[0],
               "lineage_mask_s": timers.get("hbm.delta.lineage_mask", (0.0, 0))[0],
               "delta": snap["per_delta"][0], "resident_mb": snap["resident_mb"],
               "residency_off_s": t_off, "hybrid_s": times, "launches": launches,
               "hybrid_median_s": float(np.median(times))}
        log(f"hybrid {step} delta arm: residency off {t_off:.4f} s | prefetch_index(li_hy) "
            f"{t_pre:.3f} s | first query (host union, populates the delta) {t_first:.4f} s "
            f"union sides { {k: round(v, 4) for k, v in rec['first_union_side_s'].items()} } | "
            f"delta populated in {t_pop:.3f} s more (hbm.delta.prefetch "
            f"{rec['delta_prefetch_s']:.3f} s, lineage mask {rec['lineage_mask_s']:.3f} s): "
            f"{rec['delta']} | {repeats} resident-hybrid queries median "
            f"{rec['hybrid_median_s']:.4f} s ({', '.join(f'{x:.4f}' for x in times)}), launches "
            f"{launches}, no union.side.source | rows match numpy and residency off")
        return rec

    t_create = verb(hsp.create_index, session.read.avro(str(li_dir)), hs.IndexConfig(
        "li_hy", ["l_orderkey"], ["l_partkey", "l_quantity", "l_shipdate", "l_extendedprice"]))
    t_create += verb(hsp.create_index, session.read.avro(str(od_dir)), hs.IndexConfig(
        "ord_hy", ["o_orderkey"], ["o_custkey", "o_orderdate", "o_totalprice"]))
    session.enable_hyperspace()
    unions = ("Union", "Repartition", "_data_file_id")
    measure("H1 baseline", t_create, ["IndexScan"], ["IndexScan"], absent=unions)

    t = time.perf_counter()
    for name, (li, od) in rf1.items():
        write_avro(li_dir / f"part-{name}.avro", ColumnarBatch.from_pydict(li, schema=LINEITEM_SCHEMA))
        write_avro(od_dir / f"part-{name}.avro", ColumnarBatch.from_pydict(od, schema=ORDERS_SCHEMA))
        li_parts[name], od_parts[name] = li, od
    ratios = {"li_hy": byte_ratios("li_hy", li_dir), "ord_hy": byte_ratios("ord_hy", od_dir)}
    out["rf1_lineitems"] = {k: len(li["l_orderkey"]) for k, (li, _od) in rf1.items()}
    out["h2_byte_ratios"] = ratios
    log(f"hybrid H2: RF1 batches of {n_new} orders ({out['rf1_lineitems']} lineitems) appended "
        f"as one avro file each per source; (appended, deleted) byte ratios {ratios}")
    buckets = f"x{NUM_BUCKETS}"
    q3_hybrid = [f"BucketUnion [l_orderkey] {buckets}", f"BucketUnion [o_orderkey] {buckets}",
                 f"Repartition [l_orderkey] {buckets}", f"Repartition [o_orderkey] {buckets}"]
    measure("H2 two RF1 batches appended", time.perf_counter() - t,
            ["Union", "(2 files)"], q3_hybrid, absent=("_data_file_id in",))
    out["h2_delta"] = delta_arm("H2")

    t = time.perf_counter()
    for name in ("rf1_a",):  # RF2
        (li_dir / f"part-{name}.avro").unlink()
        (od_dir / f"part-{name}.avro").unlink()
        del li_parts[name], od_parts[name]
    (li_dir / "part-002.avro").unlink()  # the retention delete
    del li_parts["part-002"]
    entry = logs["li_hy"].get_latest_stable_log()
    gone_id = [f.id for f in entry.source_file_infos() if f.name.endswith("part-002.avro")]
    ratios = {"li_hy": byte_ratios("li_hy", li_dir), "ord_hy": byte_ratios("ord_hy", od_dir)}
    out["h3_byte_ratios"] = ratios
    out["deleted_file_id"] = gone_id
    log(f"hybrid H3: RF2 removed rf1_a from both sources, the retention delete removed "
        f"lineitem part-002.avro (lineage id {gone_id}); (appended, deleted) byte ratios {ratios}")
    lineage = f"~((col(_data_file_id) in ({gone_id[0]},)))"
    plans = measure("H3 RF2 and a retention delete", time.perf_counter() - t,
                    ["Union", "(1 files)", lineage], q3_hybrid + [lineage])
    if plans["Q3"].count("col(_data_file_id) in") != 1:
        raise AssertionError("hybrid H3 Q3: the lineage filter is not on the lineitem side only")
    out["h3_delta"] = delta_arm("H3")
    if on_card:
        # the range filter's K1 launches ran the lineage NOT IN in their program
        with tk._LOWERED_LOCK:
            lowered = [(len(p.prog), names) for (_k, names), p in tk._LOWERED.items()
                       if "_data_file_id" in names]
        if not lowered:
            raise AssertionError("hybrid H3: no K1 program over _data_file_id was lowered")
        out["h3_k1_programs"] = lowered
        log(f"hybrid H3: K1 programs over the lineage column (instructions, columns): {lowered}")

    # H-agg: Q17's shape over the hybrid join, each side a BucketUnion of
    # the index (less the deleted file) and the appended rows repartitioned
    L_now = {c: np.concatenate([p[c] for p in li_parts.values()]) for c in lineitem}
    O_now = {c: np.concatenate([p[c] for p in od_parts.values()]) for c in orders}
    agg_q = q17_shape(session.read.avro(str(li_dir)), session.read.avro(str(od_dir)))
    plan = plan_with_indexes(agg_q)
    if "<----Aggregate [l_partkey]" not in plan or plan.count("BucketUnion") != 2 or \
            plan.count("Repartition") != 2:
        raise AssertionError(f"hybrid H-agg: plan lacks the Aggregate over two BucketUnions:\n"
                             f"{plan}")
    res, t_q, launches, m, times = run("H-agg q17_shape", agg_q)
    _check_agg("hybrid H-agg", res, ["l_partkey"], q17_truth(L_now, O_now))
    want_k2 = 1 if on_card else 0
    if (launches.get(tk.K2, 0), launches.get(tk.K2F, 0)) != (want_k2, want_k2) or \
            m.get("aggregate.path.join_fused", 0) != 1:
        raise AssertionError(f"hybrid H-agg: launches {launches}, counters {m}")
    moved = m.get("union.repartition.rows", 0)
    out["h_agg"] = {"s": t_q, "groups": res.num_rows, "launches": launches,
                    "join_fused": m.get("aggregate.path.join_fused", 0),
                    "union_repartition_rows": moved,
                    "aggregate_join_ranges_s": times.get("aggregate.join_ranges", (0.0, 0))[0],
                    "join_bucketed_ranges_s": times.get("join.bucketed_ranges", (0.0, 0))[0]}
    log(f"hybrid H-agg q17_shape: {t_q:.4f} s groups={res.num_rows} join_fused=1 "
        f"union.repartition.rows={moved} launches={launches} | matches numpy")

    t = verb(hsp.refresh_index, "li_hy", "incremental")
    t += verb(hsp.refresh_index, "ord_hy", "incremental")
    from hyperspace_tpu_torch.exec.hbm_cache import hbm_cache

    if hbm_cache.snapshot()["deltas"] != 0:
        raise AssertionError("hybrid H4: the incremental refresh left a resident delta")
    log("hybrid H4: the incremental refresh invalidated li_hy's resident delta (deltas 0)")
    measure("H4 refreshed incrementally", t, ["IndexScan"], ["IndexScan"], absent=unions)
    hbm_cache.reset()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"hybrid: the phase took {out['phase_s']:.3f} s, the source write included")
    return out


# ---------------------------------------------------------------------------
# streaming phase: TPC-H lineitem at SF3 through the streaming build
# ---------------------------------------------------------------------------
STREAM_SF = 3
STREAM_THRESHOLD = 256 << 20  # hyperspace.index.build.streamingThresholdBytes' default
STREAM_RUN_CHUNKS = 4  # hyperspace.index.build.device.runChunks' default


def auto_probe(L: dict, cap: int, device: str, workdir: Path) -> dict:
    """What the streaming build's ``engine=auto`` probe chooses on this
    machine: a writer over lineitem's first three full chunks (host probe,
    link check, device chunk, timed device probe; the verdict published at
    finalize), its run files written to a scratch directory and removed."""
    from hyperspace_tpu_torch.index import stream_builder as sb
    from hyperspace_tpu_torch.storage.columnar import ColumnarBatch
    from hyperspace_tpu_torch.telemetry.metrics import metrics

    metrics.reset()
    sb._ENGINE_CACHE.clear()
    w = sb.StreamingIndexWriter(["l_orderkey"], NUM_BUCKETS, workdir / "probe", cap,
                                engine="auto", finalize_mode="runs", device=device)
    for i in range(3):
        w.add_chunk(ColumnarBatch.from_pydict(
            {c: L[c][i * cap:(i + 1) * cap] for c in LINEITEM_SCHEMA}, schema=LINEITEM_SCHEMA))
    w.finalize()
    shutil.rmtree(workdir / "probe", ignore_errors=True)
    t = metrics.timings()
    out = {"chose": "host" if metrics.get("build.engine.auto_chose_host") else "device",
           "by_link": bool(metrics.get("build.engine.auto_chose_host_by_link")),
           **{k.split(".")[-1] + "_s": t[k][0] for k in
              ("build.engine.probe_host", "build.engine.probe_device", "build.engine.probe_link")
              if k in t}}
    sb._ENGINE_CACHE.clear()
    log(f"streaming S1 auto probe on this machine ({cap}-row chunks): chooses {out['chose']}"
        + (" (the link check ruled the device out)" if out["by_link"] else "")
        + "".join(f" {k}={v:.4f}" for k, v in out.items() if k.endswith("_s")))
    return out


def staged_programs(L: dict, cap: int, run_chunks: int, device: str) -> dict:
    """One staged run — ``run_chunks`` chunks of lineitem's order keys
    staged on the card and merged there — held exactly against
    ``build_partition_host``'s order and counts for the same rows, both
    timed; then, on the card, CUDA-event times of each staged program at
    its real shape beside its bound (the bytes it reads and writes once at
    the card's memory rate), the ``torch.sort`` call alone, and the chunk's
    H2D from pinned memory."""
    import torch

    from hyperspace_tpu_torch.ops import build as tb
    from hyperspace_tpu_torch.ops import fence
    from hyperspace_tpu_torch.storage.columnar import ColumnarBatch

    key = "l_orderkey"
    n = run_chunks * cap
    keys = np.ascontiguousarray(L[key][:n])
    dtypes = {key: "int64"}
    chunks = [keys[i * cap:(i + 1) * cap] for i in range(run_chunks)]
    plans = [tb.run_pack_plan([(int(c.min()), int(c.max()))], NUM_BUCKETS) for c in chunks]
    run_plan = tb.run_pack_plan([(int(keys.min()), int(keys.max()))], NUM_BUCKETS)

    def stage_all():
        return [tb.stage_chunk_packed({key: c}, dtypes, [key], NUM_BUCKETS, pl, device=device)[0]
                for c, pl in zip(chunks, plans)]

    stage_all()  # warm the allocator and the sort's workspace
    fence(torch.device(device))
    t0 = time.perf_counter()
    order, counts = tb.merge_staged_chunks(stage_all(), run_plan, NUM_BUCKETS).wait()
    staged_s = time.perf_counter() - t0
    batch = ColumnarBatch.from_pydict({key: keys, "row": np.arange(n, dtype=np.int64)})
    t0 = time.perf_counter()
    host, host_counts = tb.build_partition_host(batch, [key], NUM_BUCKETS)
    host_s = time.perf_counter() - t0
    if not (np.array_equal(order.astype(np.int64), host.columns["row"].data)
            and np.array_equal(counts, host_counts)):
        raise AssertionError("streaming: a staged run's order differs from build_partition_host's")
    out = {"rows": n, "staged_run_s": staged_s, "host_s": host_s}
    log(f"streaming S1 staged run: {run_chunks} chunks x {cap} rows staged on the card and merged "
        f"there: order and counts equal build_partition_host's exactly; staged {staged_s:.4f} s "
        f"(uploads, programs, merge, D2H), host {host_s:.4f} s")
    if device != "cuda":
        return out
    dev = torch.device("cuda")
    pinned = torch.from_numpy(chunks[0]).pin_memory()
    resident = {key: pinned.to(dev)}
    staged = stage_all()
    packed = staged[0].packed.clone()
    b_stage = bound(8 * cap + 16 * cap + 8 * NUM_BUCKETS, 0)
    b_sort = bound(8 * cap + 16 * cap, 0)
    b_merge = bound(16 * n + 8 * run_chunks * NUM_BUCKETS + 4 * n + 8 * NUM_BUCKETS, 0)
    out.update(
        stage_ms=time_ms(lambda: tb._single_staged_kernel_packed(
            resident, dtypes, [key], NUM_BUCKETS, plans[0])),
        stage_bound_ms=b_stage[0],
        sort_ms=time_ms(lambda: torch.sort(packed, stable=True)),
        sort_bound_ms=b_sort[0],
        h2d_ms=time_ms(lambda: pinned.to(dev, non_blocking=True)),
        merge_ms=time_ms(lambda: tb.merge_staged_chunks(staged, run_plan, NUM_BUCKETS).wait(),
                         repeats=10),
        merge_bound_ms=b_merge[0],
    )
    out["h2d_gb_s"] = 8 * cap / out["h2d_ms"] / 1e6
    log(f"streaming program stage_chunk_packed: {out['stage_ms']:.4f} ms per {cap}-row chunk "
        f"(keys on the card) | bound {out['stage_bound_ms']:.4f} ms (bytes) | torch.sort alone "
        f"{out['sort_ms']:.4f} ms, bound {out['sort_bound_ms']:.4f} ms | the chunk's keys H2D "
        f"from pinned memory {out['h2d_ms']:.4f} ms ({out['h2d_gb_s']:.2f} GB/s)")
    log(f"streaming program merge_staged_chunks: {out['merge_ms']:.4f} ms per {run_chunks}-chunk "
        f"run with its D2H of {4 * n} bytes | bound {out['merge_bound_ms']:.4f} ms (bytes, the D2H "
        f"not counted)")
    return out


LADDER_BUDGETS_MB = (4096, 320, 64)  # L1 resident, L2 compressed, L3 streaming (SF3)
LADDER_TIERS = ("resident", "compressed", "streaming")


def ladder_phase(session, hsp, L: dict, li_dir: Path, seed: int, budgets=LADDER_BUDGETS_MB,
                 window_rows=None, profile: bool = False) -> dict:
    """The residency tier ladder on li_st (SF3), residency auto (force on
    the CPU), each tier from a fresh cache: L1 at ``budgets[0]`` MB holds
    the raw planes (K1c), L2 at ``budgets[1]`` the bit-packed ones (K1p
    where a query reads a packed plane, K1c otherwise), L3 at
    ``budgets[2]`` streams windows through a slab pair (K1c or K1p a
    window). In each: ``prefetch_index``, then the resident phase's 20
    point lookups, 5 range filters and 5 float64 filters, launch counts
    from zero. Checks: ``by_tier``, one launch a query (windows a query
    on L3), the tier's ``scan.path.resident_*`` metric, rows against
    numpy, and every query's block counts against L1's."""
    from hyperspace_tpu_torch.exec.hbm_cache import hbm_cache
    from hyperspace_tpu_torch.ops import bitpack, fence, launch_counts, reset_launch_counts
    from hyperspace_tpu_torch.ops.kernels import K1, K1C, K1P
    from hyperspace_tpu_torch.plan.expr import col
    from hyperspace_tpu_torch.residency import plan_tier
    from hyperspace_tpu_torch.telemetry.metrics import metrics, residency_snapshot

    on_card = session.device.type == "cuda"
    rng = np.random.default_rng(seed + 12)
    ok = L["l_orderkey"]
    keys = rng.choice(np.unique(ok), 20, replace=False)
    top = int(ok.max())
    lo_k, hi_k, d_lo = top // 6, top // 2, DAY_1995_03_15 - 365
    shapes = {
        "point_lookup": [(col("l_orderkey") == int(k), ok == k) for k in keys],
        "range_filter": [(
            (col("l_orderkey") >= lo_k) & (col("l_orderkey") < hi_k) & (col("l_quantity") < 24)
            & (col("l_shipdate") >= d_lo) & (col("l_shipdate") < DAY_1995_03_15),
            (ok >= lo_k) & (ok < hi_k) & (L["l_quantity"] < 24)
            & (L["l_shipdate"] >= d_lo) & (L["l_shipdate"] < DAY_1995_03_15))] * 5,
        "f64_filter": [(
            (col("l_orderkey") >= lo_k) & (col("l_orderkey") < hi_k)
            & (col("l_extendedprice") > 50000.0),
            (ok >= lo_k) & (ok < hi_k) & (L["l_extendedprice"] > 50000.0))] * 5,
    }
    n_queries = sum(len(v) for v in shapes.values())
    li = session.read.avro(str(li_dir))
    session.conf.set("hyperspace.torch.hbm.mode", "auto" if on_card else "force")
    if window_rows is not None:
        session.conf.set("hyperspace.residency.streaming.windowRows", int(window_rows))
    out, l1_counts = {"queries": n_queries, "tiers": {}}, {}
    for level, (budget, tier) in enumerate(zip(budgets, LADDER_TIERS), 1):
        label = f"L{level}"
        hbm_cache.reset()
        session.conf.set("hyperspace.torch.hbm.budgetMB", int(budget))
        metrics.reset()
        t0 = time.perf_counter()
        if not hsp.prefetch_index("li_st", LI_RESIDENT):
            raise AssertionError(f"ladder {label}: prefetch_index(li_st) refused at {budget} MB")
        hbm_cache.wait_background()
        fence(session.device)
        prefetch_s = time.perf_counter() - t0
        snap = hbm_cache.snapshot_residency()
        if snap["by_tier"] != {tier: 1}:
            raise AssertionError(f"ladder {label}: by_tier {snap['by_tier']}, want {tier}")
        table = hbm_cache._tables[0]
        row = snap["tables"][0]
        # the tier planner's own numbers for this table, from the data
        conf = session.conf.residency()
        n_pad = -(-len(ok) // 8192) * 8192
        raw = unpacked = 0
        specs = {}
        for c in LI_RESIDENT:
            planes = 2 if L[c].dtype == np.float64 else 1
            raw += planes * n_pad * 4
            sp = bitpack.pack_spec(int(L[c].min()), int(L[c].max()), n_pad) if planes == 1 else None
            if sp is None:
                unpacked += planes * n_pad * 4
            else:
                specs[c] = sp
        plan = plan_tier(raw, conf.budget_bytes, specs, unpacked, conf=conf)
        if plan.tier != tier:
            raise AssertionError(f"ladder {label}: plan_tier says {plan.tier}, the cache built {tier}")
        log(f"ladder {label} ({tier}, budgetMB {budget}): prefetch_index(li_st) {prefetch_s:.3f} s"
            f" | device MB {row['mb']} (raw {row.get('raw_mb', row['mb'])})"
            + (f" host MB {row['host_mb']}, {row['windows']} windows of {row['window_rows']} rows"
               if tier == "streaming" else "")
            + " | packable planes " + ", ".join(f"{c}: {sp.bits} bits, vpw {sp.vpw}, ref0 "
                                                f"{sp.ref0}" for c, sp in sorted(specs.items()))
            + f" | plan_tier: budget {conf.budget_bytes} B, raw planes {plan.raw_bytes} B, "
            f"packed planes {plan.packed_bytes} B -> {plan.tier}")
        reset_launch_counts()
        metrics.reset()
        times, results = {}, {}
        for q, qs in shapes.items():
            with _Profiled(f"ladder {label} {q} x{len(qs)}", profile):
                for i, (p, _m) in enumerate(qs):
                    t = time.perf_counter()
                    results[(q, i)] = li.filter(p).select(*LI_RESIDENT).collect()
                    fence(session.device)
                    times.setdefault(q, []).append(time.perf_counter() - t)
        launches = launch_counts()
        m = metrics.snapshot()
        path = {"resident": "scan.path.resident_device",
                "compressed": "scan.path.resident_compressed",
                "streaming": "scan.path.resident_streaming"}[tier]
        per_query = table.n_windows if tier == "streaming" else 1
        want_launches = n_queries * per_query if on_card else 0
        got_launches = launches.get(K1C, 0) + launches.get(K1P, 0)
        if m.get(path, 0) != n_queries or got_launches != want_launches or launches.get(K1, 0):
            raise AssertionError(f"ladder {label}: {m.get(path, 0)} of {n_queries} served by "
                                 f"{path}, launches {launches} (want {want_launches})")
        # K1p serves the queries that read a packed plane: the range filters
        want_k1p = len(shapes["range_filter"]) * per_query if on_card and tier != "resident" else 0
        if launches.get(K1P, 0) != want_k1p:
            raise AssertionError(f"ladder {label}: K1p launched {launches.get(K1P, 0)} times, "
                                 f"want {want_k1p}")
        for q, qs in shapes.items():
            for i, (_p, mask) in enumerate(qs):
                _check(f"ladder {label} {q}[{i}]", results[(q, i)], LI_RESIDENT,
                       [L[c][mask] for c in LI_RESIDENT])
        # the block counts of every distinct query against L1's
        for q, qs in shapes.items():
            for i, (p, _m) in enumerate(qs[:1] if q != "point_lookup" else qs[:3]):
                c = hbm_cache.block_counts(table, p)
                if level == 1:
                    l1_counts[(q, i)] = c
                elif not np.array_equal(c, l1_counts[(q, i)]):
                    raise AssertionError(f"ladder {label} {q}[{i}]: counts differ from L1's")
        stream = residency_snapshot(metrics) if tier == "streaming" else {}
        rec = {"tier": tier, "budget_mb": budget, "prefetch_s": prefetch_s, "mb": row["mb"],
               "raw_mb": row.get("raw_mb", row["mb"]), "launches": launches,
               "packed": {c: [sp.bits, sp.vpw, sp.ref0] for c, sp in plan.specs.items()},
               "plan_raw_bytes": plan.raw_bytes, "plan_packed_bytes": plan.packed_bytes,
               "shapes": {q: {"n": len(v), "median_s": float(np.median(v)),
                              "p90_s": float(np.percentile(v, 90))} for q, v in times.items()}}
        if tier == "streaming":
            rec.update(windows=table.n_windows, host_mb=row["host_mb"],
                       h2d_bytes_per_query=m.get("residency.stream.h2d_bytes", 0) / n_queries,
                       prefetch_hit=stream["stream_prefetch_hit"],
                       prefetch_stall=stream["stream_prefetch_stall"],
                       stall_s=metrics.timings().get("residency.stream.stall", (0.0, 0))[0])
        out["tiers"][label] = rec
        log(f"ladder {label} ({tier}): {n_queries} queries, launches {launches} | " + " | ".join(
            f"{q} median {v['median_s']:.4f} s p90 {v['p90_s']:.4f} s"
            for q, v in rec["shapes"].items())
            + (f" | windows {rec['windows']}, H2D {rec['h2d_bytes_per_query']:.0f} B a query, "
               f"prefetch hits {rec['prefetch_hit']} stalls {rec['prefetch_stall']} "
               f"({rec['stall_s']:.4f} s)" if tier == "streaming" else "")
            + " | rows match numpy, counts match L1's")
    hbm_cache.reset()
    session.conf.set("hyperspace.torch.hbm.budgetMB", 4096)
    session.conf.set("hyperspace.torch.hbm.mode", "off")
    return out


def streaming_phase(workdir: Path, device: str, seed: int, profile: bool = False,
                    scale: float = 1.0, chunk_rows=None, threshold=None,
                    ladder_budgets=LADDER_BUDGETS_MB, ladder_window_rows=None) -> dict:
    """The streaming build, run files and background compaction, in a
    session of its own (lineage on, 200 buckets, ``build.engine=device``,
    residency off), over TPC-H lineitem and orders at SF3 (18,003,645 and
    4,500,000 rows, l_partkey in 1..600,000) written as avro into
    ``src/lineitem_st`` (24 files) and ``src/orders_st`` (6):

    * S0: the source bytes; lineitem must exceed the 256 MiB streaming
      threshold and orders stay under it;
    * S1: li_st built with ``build.mode=auto``, which must stream it
      (2^21-row chunks, 4 staged chunks a run merged on the card, the
      tail through the per-chunk program; finalizeMode merge: 200
      per-bucket files); ord_st builds in memory; the auto probe's verdict
      on this machine; one staged run held exactly against the host
      engine; the staged programs' times; the range filter and Q3;
    * S2: li_runs over the same source with finalizeMode runs: its run
      files and bucketCounts; the range filter, Q3 and a point lookup
      through the segment planner; ``prefetch_index`` and the resident
      range filter through K1c;
    * S3: one TPC-H RF1 batch (SF x 1,500 orders) appended to both
      sources and refreshed incrementally (run files plus per-bucket
      files), then RF2 removes it through the lineage rewrite over the run
      files;
    * S4: ``compact_index("li_runs")`` at 64 buckets a step, step by step,
      until no run file is left.

    Every query runs with launch counts from zero (K1 once per index file
    read, K2 and its fence build once per Q3) and equals numpy over the
    sources as they stand. ``chunk_rows`` and ``threshold`` are for
    rehearsals off the card at a small ``scale`` only."""
    import os

    import hyperspace_tpu_torch as hs
    from hyperspace_tpu_torch.exec.hbm_cache import hbm_cache
    from hyperspace_tpu_torch.index.log_manager import IndexLogManagerImpl
    from hyperspace_tpu_torch.ops import fence
    from hyperspace_tpu_torch.ops.kernels import K1, K1C, K2, K2F
    from hyperspace_tpu_torch.plan.expr import col
    from hyperspace_tpu_torch.storage import layout
    from hyperspace_tpu_torch.storage.avro_io import write_avro
    from hyperspace_tpu_torch.storage.columnar import ColumnarBatch
    from hyperspace_tpu_torch.telemetry.metrics import metrics

    on_card = device == "cuda"
    t_phase = time.perf_counter()
    n_l = int(round(SF1_LINEITEM * STREAM_SF * scale))
    n_o = int(round(SF1_ORDERS * STREAM_SF * scale))
    n_parts = 200_000 * STREAM_SF
    L, O = make_tables(seed + 8, n_o, n_l, n_parts=n_parts)
    t0 = time.perf_counter()
    li_dir = Path(write_avro_dir(workdir / "src" / "lineitem_st", L, LINEITEM_SCHEMA, 24))
    od_dir = Path(write_avro_dir(workdir / "src" / "orders_st", O, ORDERS_SCHEMA, 6))
    thr = STREAM_THRESHOLD if threshold is None else int(threshold)
    li_bytes = sum(f.stat().st_size for f in li_dir.glob("*.avro"))
    od_bytes = sum(f.stat().st_size for f in od_dir.glob("*.avro"))
    out = {"lineitem_rows": n_l, "orders_rows": n_o, "lineitem_bytes": li_bytes,
           "orders_bytes": od_bytes, "threshold_bytes": thr,
           "write_s": time.perf_counter() - t0, "steps": []}
    log(f"streaming S0: TPC-H SF{STREAM_SF}" + (f" x {scale}" if scale != 1.0 else "")
        + f": lineitem {n_l} rows in 24 avro files, {li_bytes} bytes "
        f"({li_bytes / n_l:.2f} a row); orders {n_o} rows in 6 files, {od_bytes} bytes; "
        f"threshold {thr} bytes; written in {out['write_s']:.3f} s")
    if li_bytes <= thr or od_bytes > thr:
        raise AssertionError("streaming S0: lineitem must exceed the threshold and orders not")
    os.environ["HYPERSPACE_TPU_TORCH_PROBE_CACHE"] = str(workdir / "engine_probe.json")
    conf = {
        "hyperspace.system.path": str(workdir / "indexes_streaming"),
        "hyperspace.index.numBuckets": NUM_BUCKETS,
        "hyperspace.index.lineage.enabled": "true",
        "hyperspace.index.build.engine": "device",
        "hyperspace.torch.device": device,
        "hyperspace.torch.hbm.mode": "off",
    }
    if chunk_rows is not None:
        conf["hyperspace.index.build.chunkRows"] = int(chunk_rows)
    if threshold is not None:
        conf["hyperspace.index.build.streamingThresholdBytes"] = int(threshold)
    if not on_card:  # a rehearsal: the zone gate would route small tables away
        conf["hyperspace.torch.hbm.maxBlockFrac"] = 1.0
    session = hs.HyperspaceSession(hs.HyperspaceConf(conf))
    hsp = hs.Hyperspace(session)
    root = Path(conf["hyperspace.system.path"])
    cap = 1 << max(session.conf.build_chunk_rows() - 1, 0).bit_length()
    n_full, tail = divmod(n_l, cap)
    staged_runs = -(-n_full // STREAM_RUN_CHUNKS)
    verb = functools.partial(timed_verb, session, "streaming", profile)

    def files(name):
        entry = IndexLogManagerImpl(root / name).get_latest_stable_log()
        return entry.content.files() if entry is not None and entry.state == "ACTIVE" else []

    present = {"base": (L, O)}  # the sources as they stand, by file
    bounds = range_bounds(L)

    def truth():
        Lp = {c: np.concatenate([p[0][c] for p in present.values()]) for c in L}
        Op = {c: np.concatenate([p[1][c] for p in present.values()]) for c in O}
        return Lp, range_and_q3_truth(Lp, Op, bounds, "streaming")

    def measure(step, index, verb_s, extra=""):
        """The range filter and Q3, launch counts from zero, against numpy."""
        _Lp, (want_r, want_q3) = truth()
        rng_q, q3_q = range_and_q3(session, li_dir, od_dir, bounds)
        used = rng_q.explain().split("Indexes used:")[1]
        if f"{index}:" not in used:
            raise AssertionError(f"streaming {step}: range filter indexes used {used.split()}")
        res, t_r, launches, m, _t = timed_query(session, f"streaming {step} range", profile, rng_q)
        _check(f"streaming {step} range filter", res, R_COLS, want_r)
        read = m.get("scan.files_read", 0)
        if launches.get(K1, 0) != (read if on_card else 0):
            raise AssertionError(f"streaming {step}: K1 launches {launches}, files read {read}")
        res3, t_q3, l3, m3, _t3 = timed_query(session, f"streaming {step} Q3", profile, q3_q)
        _check(f"streaming {step} Q3", res3, Q3_COLS, want_q3)
        want_k2 = 1 if on_card else 0
        if (l3.get(K2, 0), l3.get(K2F, 0)) != (want_k2, want_k2):
            raise AssertionError(f"streaming {step}: Q3 launches {l3}, paths {m3}")
        n_files = len(files(index))
        n_runs = sum(layout.is_run_file(f) for f in files(index))
        row = {"step": step, "verb_s": verb_s, "files": n_files, "run_files": n_runs,
               "range_s": t_r, "range_rows": res.num_rows, "range_files_read": read,
               "range_launches": launches, "range_sweeps": m.get("io.segment.sweeps", 0),
               "q3_s": t_q3, "q3_rows": res3.num_rows, "q3_launches": l3,
               "q3_sweeps": m3.get("io.segment.sweeps", 0),
               "q3_segments": m3.get("io.segment.ranges", 0) + m3.get("io.segment.coalesced", 0)}
        out["steps"].append(row)
        log(f"streaming {step}: {verb_s:.3f} s | {index} files={n_files} (run files {n_runs}) | "
            f"range filter {t_r:.4f} s rows={res.num_rows} files read={read} "
            f"segment sweeps={row['range_sweeps']} launches={launches} | Q3 {t_q3:.4f} s "
            f"rows={res3.num_rows} segment sweeps={row['q3_sweeps']} segments="
            f"{row['q3_segments']} launches={l3}{extra} | matches numpy")
        return row

    # S1: li_st streams under auto (finalizeMode merge), ord_st in memory
    out["auto_probe"] = auto_probe(L, cap, device, workdir)
    metrics.reset()
    t = time.perf_counter()
    with _Profiled("streaming S1 build li_st", profile):
        hsp.create_index(session.read.avro(str(li_dir)), hs.IndexConfig(
            "li_st", ["l_orderkey"], ["l_partkey", "l_quantity", "l_shipdate", "l_extendedprice"]))
    fence(session.device)
    build_s = time.perf_counter() - t
    c, tm = metrics.snapshot(), metrics.timings()
    got = {k: c.get(k, 0) for k in ("build.stream.rows", "build.stream.chunks",
                                    "build.device.staged_chunks", "build.device.staged_runs",
                                    "build.stream.d2h_calls", "build.device.staging_declined.tail",
                                    "build.stream.h2d_bytes", "build.stream.d2h_bytes")}
    want = {"build.stream.rows": n_l, "build.stream.chunks": n_full + (tail > 0),
            "build.device.staged_chunks": n_full, "build.device.staged_runs": staged_runs,
            "build.stream.d2h_calls": staged_runs + (tail > 0)}
    if any(got[k] != v for k, v in want.items()):
        raise AssertionError(f"streaming S1: counters {got}, want {want}")
    index_rows = sum(layout.cached_reader(f).num_rows for f in files("li_st"))
    if len(files("li_st")) != NUM_BUCKETS or index_rows != n_l or \
            any(layout.is_run_file(f) for f in files("li_st")):
        raise AssertionError(f"streaming S1: li_st is not 200 per-bucket files of {n_l} rows")
    timers = {k: tm[k][0] for k in tm if k.startswith("build.stream.")}
    out["li_st"] = {"build_s": build_s, "rows_per_s": n_l / build_s, "counters": got,
                    "timers": timers, "chunk_capacity": cap, "tail_rows": tail,
                    "index_rows": index_rows}
    log(f"streaming S1 build li_st (build.mode=auto -> streaming, engine=device): {build_s:.3f} s, "
        f"{n_l / build_s:.0f} rows/s, index rows {index_rows} | chunks "
        f"{got['build.stream.chunks']} of {cap} rows (tail "
        f"{tail}), staged chunks {got['build.device.staged_chunks']}, runs merged on the card "
        f"{got['build.device.staged_runs']}, D2H calls {got['build.stream.d2h_calls']}, H2D "
        f"{got['build.stream.h2d_bytes']} bytes, D2H {got['build.stream.d2h_bytes']} bytes | "
        + " ".join(f"{k[13:]}={v:.3f}" for k, v in sorted(timers.items())))
    metrics.reset()
    t = verb(hsp.create_index, session.read.avro(str(od_dir)), hs.IndexConfig(
        "ord_st", ["o_orderkey"], ["o_custkey", "o_orderdate", "o_totalprice"]))
    if metrics.get("build.stream.rows") or metrics.get("build.engine.device") != 1:
        raise AssertionError("streaming S1: ord_st did not build in memory")
    out["ord_st_build_s"] = t
    log(f"streaming S1 build ord_st (under the threshold: in memory): {t:.3f} s")
    out["staged_programs"] = staged_programs(L, cap, STREAM_RUN_CHUNKS, device)
    session.enable_hyperspace()
    measure("S1 li_st", "li_st", build_s)
    out["ladder"] = ladder_phase(session, hsp, L, li_dir, seed, ladder_budgets,
                                 ladder_window_rows, profile)

    # S2: the same source as run files; li_st goes so that the rules pick li_runs
    verb(hsp.delete_index, "li_st")
    verb(hsp.vacuum_index, "li_st")
    session.conf.set("hyperspace.index.build.finalizeMode", "runs")
    metrics.reset()
    t = verb(hsp.create_index, session.read.avro(str(li_dir)), hs.IndexConfig(
        "li_runs", ["l_orderkey"], ["l_partkey", "l_quantity", "l_shipdate", "l_extendedprice"]))
    run_files = files("li_runs")
    totals = [int(layout.run_offsets_checked(f)[-1]) for f in run_files]
    if not all(layout.is_run_file(f) for f in run_files) or \
            len(run_files) != staged_runs + (tail > 0) or sum(totals) != n_l:
        raise AssertionError(f"streaming S2: run files {run_files}, bucketCounts totals {totals}")
    out["li_runs"] = {"build_s": t, "rows_per_s": n_l / t, "run_files": len(run_files),
                      "bucket_count_totals": totals,
                      "run_files_metric": metrics.get("build.stream.run_files")}
    log(f"streaming S2 build li_runs (finalizeMode=runs): {t:.3f} s, {n_l / t:.0f} rows/s | "
        f"{len(run_files)} run files, bucketCounts totals {totals}")
    measure("S2 li_runs", "li_runs", t)
    k = int(L["l_orderkey"][n_l // 3])
    point = session.read.avro(str(li_dir)).filter(col("l_orderkey") == k).select(*R_COLS)
    res, t_p, launches, m, _t = timed_query(session, "streaming S2 point", profile, point)
    _check("streaming S2 point lookup", res, R_COLS, [L[c][L["l_orderkey"] == k] for c in R_COLS])
    if not m.get("scan.run_bucket_segments") or launches.get(K1, 0) != (
            m.get("scan.files_read", 0) if on_card else 0):
        raise AssertionError(f"streaming S2 point lookup: launches {launches}, counters {m}")
    out["point"] = {"s": t_p, "rows": res.num_rows, "segments": m["scan.run_bucket_segments"],
                    "sweeps": m.get("io.segment.sweeps", 0), "launches": launches}
    log(f"streaming S2 point lookup: {t_p:.4f} s rows={res.num_rows} bucket segments="
        f"{out['point']['segments']} in {out['point']['sweeps']} sweeps launches={launches} | "
        f"matches numpy")
    session.conf.set("hyperspace.torch.hbm.mode", "auto" if on_card else "force")
    t = time.perf_counter()
    if not hsp.prefetch_index("li_runs", LI_RESIDENT):
        raise AssertionError("prefetch_index(li_runs) did not make the index resident")
    hbm_cache.wait_background()
    fence(session.device)
    t_pre = time.perf_counter() - t
    rng_q, _q3 = range_and_q3(session, li_dir, od_dir, bounds)
    res, t_res, launches, m, _t = timed_query(session, "streaming S2 resident", profile, rng_q)
    session.conf.set("hyperspace.torch.hbm.mode", "off")
    _check("streaming S2 resident range filter", res, R_COLS, truth()[1][0])
    if m.get("scan.path.resident_device", 0) != 1 or launches.get(K1C, 0) != (
            1 if on_card else 0) or launches.get(K1, 0):
        raise AssertionError(f"streaming S2 resident: launches {launches}, counters {m}")
    out["resident"] = {"prefetch_s": t_pre, "s": t_res, "rows": res.num_rows, "launches": launches}
    log(f"streaming S2 resident: prefetch_index(li_runs) {t_pre:.3f} s | range filter "
        f"{t_res:.4f} s rows={res.num_rows} launches={launches} | matches numpy")

    # S3: one RF1 batch appended and refreshed, then RF2 through the lineage rewrite
    n_new = max(1, int(round(1500 * n_o / SF1_ORDERS)))
    li_new, od_new = rf1_batches(O, seed + 8, n_new, n_batches=1, n_parts=n_parts)[0]
    write_avro(li_dir / "part-rf1.avro", ColumnarBatch.from_pydict(li_new, schema=LINEITEM_SCHEMA))
    write_avro(od_dir / "part-rf1.avro", ColumnarBatch.from_pydict(od_new, schema=ORDERS_SCHEMA))
    present["rf1"] = (li_new, od_new)
    t = verb(hsp.refresh_index, "li_runs", "incremental")
    t += verb(hsp.refresh_index, "ord_st", "incremental")
    row = measure("S3 RF1 refreshed incrementally", "li_runs", t,
                  f" | RF1 {n_new} orders, {len(li_new['l_orderkey'])} lineitems")
    if not (0 < row["run_files"] < row["files"]):
        raise AssertionError(f"streaming S3: not a mixed layout: {row}")
    (li_dir / "part-rf1.avro").unlink()
    (od_dir / "part-rf1.avro").unlink()
    del present["rf1"]
    metrics.reset()
    t_li = verb(hsp.refresh_index, "li_runs", "incremental")
    sweeps = metrics.get("io.segment.sweeps")
    t_od = verb(hsp.refresh_index, "ord_st", "incremental")
    row = measure("S3 RF2 refreshed incrementally (lineage rewrite over run files)", "li_runs",
                  t_li + t_od, f" | li_runs {t_li:.3f} s ({sweeps} run sweeps), ord_st {t_od:.3f} s")
    if row["run_files"] != len(run_files) or row["files"] != len(run_files):
        raise AssertionError(f"streaming S3 RF2: {row}")

    # S4: background compaction, one committed step at a time
    log_mgr = IndexLogManagerImpl(root / "li_runs")
    before = len(files("li_runs"))
    step_s, ids = [], [log_mgr.get_latest_id()]
    while True:
        metrics.reset()
        t = time.perf_counter()
        res = hsp.compact_index("li_runs", max_steps=1)
        if not res["steps"]:
            break
        step_s.append(time.perf_counter() - t)
        ids.append(log_mgr.get_latest_id())
        log(f"streaming S4 compaction step {len(step_s)}: {step_s[-1]:.3f} s | buckets "
            f"{metrics.get('compaction.buckets')} runs rewritten "
            f"{metrics.get('compaction.runs_rewritten')} consumed "
            f"{metrics.get('compaction.runs_consumed')} | li_runs files {len(files('li_runs'))} "
            f"(run files {sum(layout.is_run_file(f) for f in files('li_runs'))}) | log ids "
            f"{ids[-2]} -> {ids[-1]}")
    want_steps = -(-NUM_BUCKETS // session.conf.compaction_buckets_per_step())
    after = files("li_runs")
    if len(step_s) != want_steps or any(layout.is_run_file(f) for f in after) or \
            len(after) != NUM_BUCKETS or any(b - a != 2 for a, b in zip(ids, ids[1:])):
        raise AssertionError(f"streaming S4: {len(step_s)} steps, {len(after)} files, ids {ids}")
    out["compaction"] = {"steps_s": step_s, "files_before": before, "files_after": len(after)}
    measure("S4 compacted", "li_runs", sum(step_s),
            f" | {len(step_s)} steps, files {before} -> {len(after)}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"streaming: the phase took {out['phase_s']:.3f} s, the source write included")
    return out


def _phases(arg: str) -> tuple:
    """``--phases``: a comma list of ``PHASES``, in run order; main joins
    any phase that runs in its session."""
    want = {p.strip() for p in arg.split(",") if p.strip()}
    unknown = want - set(PHASES)
    if unknown or not want:
        raise argparse.ArgumentTypeError(
            f"--phases takes a comma list of {','.join(PHASES)} (got {arg!r})")
    if want & {"aggregate", "resident", "front_end"}:
        want.add("main")
    return tuple(p for p in PHASES if p in want)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="fraction of the SF1 row counts (a cut, printed)")
    ap.add_argument("--workdir", default=None, help="scratch directory (default: a temp dir)")
    ap.add_argument("--profile", action="store_true",
                    help="print host and device profiles of each main-path step")
    ap.add_argument("--phases", type=_phases, default=PHASES,
                    help="comma list of the phases to run, of " + ",".join(PHASES)
                    + " (default: all; aggregate, resident and front_end bring main)")
    args = ap.parse_args()
    phases = args.phases

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from hyperspace_tpu_torch.ops import kernels as tk
    except ImportError as e:
        print(f"chip_smoke: the hyperspace_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    if phases != PHASES:
        log(f"phases: {','.join(phases)} (of {','.join(PHASES)})")
    t_start = time.perf_counter()
    t0 = time.perf_counter()
    tk.build_kernels()
    log(f"setup: kernels built and loaded in {time.perf_counter() - t0:.3f} s")
    ptxas = {}
    for kname in (tk.K1, tk.K2):
        ptxas[kname] = ptxas_summary(tk.build_report(kname))
        for fn, info in sorted(ptxas[kname].items()):
            log(f"setup: ptxas {fn}: registers={info.get('registers')} "
                f"stack_frame={info.get('stack_frame')} spill_stores={info.get('spill_stores')} "
                f"spill_loads={info.get('spill_loads')}")
            if info.get("stack_frame") or info.get("spill_stores") or info.get("spill_loads"):
                raise AssertionError(f"ptxas: {fn} uses local memory: {info}")

    n_l = int(round(SF1_LINEITEM * args.scale))
    n_o = int(round(SF1_ORDERS * args.scale))
    if args.scale != 1.0:
        log(f"CUT: scale {args.scale}: lineitem {n_l} rows, orders {n_o} rows (SF1: "
            f"{SF1_LINEITEM}, {SF1_ORDERS})")
    t0 = time.perf_counter()
    lineitem, orders = make_tables(args.seed, n_o, n_l)
    log(f"setup: tables generated in {time.perf_counter() - t0:.3f} s")

    kphase = kernel_phase(lineitem, orders, args.seed) if "kernels" in phases else None
    # launches above compared kernels with their plain versions; each
    # path's counts start from zero inside its phase
    workdir = Path(args.workdir) if args.workdir else Path(tempfile.mkdtemp(prefix="hs_smoke_"))
    stream_out = None
    try:
        main_out = run_main_path(lineitem, orders, workdir, "cuda", args.seed, args.profile,
                                 phases)
        if "streaming" in phases:
            cut = {}
            if args.scale != 1.0:  # a cut: the threshold and chunks shrink with the tables
                cut = {"chunk_rows": max(1024, int((1 << 21) * args.scale)),
                       "threshold": int(STREAM_THRESHOLD * args.scale)}
                log(f"CUT: streaming phase at scale {args.scale}: {cut}")
            stream_out = streaming_phase(workdir / "streaming", "cuda", args.seed, args.profile,
                                         scale=args.scale, **cut)
    finally:
        if not args.workdir:
            shutil.rmtree(workdir, ignore_errors=True)
    # each kernel's launches on its paths (None where no phase of them ran)
    launches = {k: None for k in (tk.K1, tk.K1C, tk.K1P, tk.K1H, tk.K2, tk.K2F)}
    if "launches" in main_out:
        for kname in (tk.K1, tk.K2, tk.K2F):
            launches[kname] = main_out["launches"].get(kname, 0)
    if "resident" in main_out:
        launches[tk.K1C] = main_out["resident"]["launches"].get(tk.K1C, 0)
    if stream_out is not None:
        # K1p on the ladder's compressed and streaming tiers
        launches[tk.K1P] = sum(t["launches"].get(tk.K1P, 0)
                               for t in stream_out["ladder"]["tiers"].values())
    if "hybrid" in main_out:
        # K1h on the hybrid phase's resident-hybrid queries
        launches[tk.K1H] = sum(main_out["hybrid"][s]["launches"].get(tk.K1H, 0)
                               for s in ("h2_delta", "h3_delta"))
    for kname, n in launches.items():
        if n is not None and n <= 0:
            raise AssertionError(f"{kname} was not launched on its path ({launches})")

    details = {}
    if "launches" in main_out:
        details["main_path"] = {k: main_out[k] for k in ("build_s", "query_s", "rows")}
    for key, name in (("aggregate", "aggregate"), ("resident", "resident_path"),
                      ("front_end", "front_end"), ("lifecycle", "lifecycle"),
                      ("hybrid", "hybrid")):
        if key in main_out:
            details[name] = main_out[key]
    log(json.dumps({**details, "streaming": stream_out, "kernel_cases": kphase, "ptxas": ptxas,
                    "phases": list(phases), "total_s": time.perf_counter() - t_start}))
    if kphase is not None:
        log(json.dumps(kernels_line(tk, kphase, launches)))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def kernels_line(tk, kphase: dict, launches: dict) -> dict:
    """The ``kernels`` JSON line: each kernel's route, source, the TPU
    kernel it replaces, its launches on its paths (None where none of them
    ran), its worst error over every case and its times at the main
    path's shape."""
    k1p = kphase["k1p"]["li_st_packed_3col"]
    k1h = kphase["k1h"]["li_hy_3col"]
    k1 = kphase["k1"]["range_3col"]
    k1c = kphase["k1c"]["range_3col"]
    k2 = kphase["k2"]["index_layout"]
    k2f = kphase["k2f"]
    mask_src = "hyperspace_tpu_torch/csrc/predicate_mask.cu"
    join_src = "hyperspace_tpu_torch/csrc/sorted_intersect.cu"
    rows = (
        (tk.K1, mask_src, "hyperspace_tpu/ops/kernels.py:237", "k1", k1),
        (tk.K1C, mask_src, "hyperspace_tpu/exec/hbm_cache.py:476", "k1c", k1c),
        (tk.K1P, mask_src, "hyperspace_tpu/exec/hbm_cache.py:447", "k1p", k1p),
        (tk.K1H, mask_src, "hyperspace_tpu/exec/hbm_cache.py:671", "k1h", k1h),
        (tk.K2, join_src, "hyperspace_tpu/ops/kernels.py:549", "k2", k2),
        (tk.K2F, join_src, "hyperspace_tpu/ops/kernels.py:549", "k2f", k2f),
    )
    out = []
    for name, src, replaces, key, rec in rows:
        cases = kphase[key].values() if key != "k2f" else [k2f]
        out.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                    "launches": launches[name],
                    "max_abs_err": max(c["max_abs_err"] for c in cases),
                    "ms": rec["ms"], "plain_ms": rec["plain_ms"], "device_ms": rec["device_ms"],
                    "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                    "library_ms": rec.get("library_ms")})
    return {"kernels": out}


if __name__ == "__main__":
    sys.exit(main())
