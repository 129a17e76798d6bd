#!/usr/bin/env python3
"""chip_smoke.py — the PyTorch/CUDA port's main path on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py [--seed 0] [--scale 1.0]

It needs a CUDA card and exits non-zero, printing no result, without one
(or without the ``hyperspace_tpu_torch`` package beside it). Phases:

1. header — the card's name and power limit (``nvidia-smi``); the CUDA
   kernels build from ``hyperspace_tpu_torch/csrc`` (timed as set-up);
2. kernels — each kernel against its plain torch version on the card, at
   the main path's shapes, exact equality; times (median of repeats, CUDA
   events), the plain version's time, the library call's time where one
   exists, and the least time the card could take (its bound). K1c (block
   counts) also runs over a 3 GiB table made on the card (3 int32 columns
   x 2^28 rows); K1 and K2 are also timed over operands uploaded once
   (``resident_mask_fn``, ``resident_sorted_intersect``,
   ``resident_smj_amortized``), and the fused aggregate-over-join is held
   against numpy;
3. main path — TPC-H-shaped data at scale factor 1 (lineitem 6,001,215
   rows, orders 1,500,000, made with numpy from ``--seed`` and written as
   avro), two covering indexes with 200 buckets built in memory on the
   card, then a point lookup, a range filter and a Q3-shaped join with
   Hyperspace enabled and residency off (the per-file scan). Every result
   must equal a plain numpy evaluation of the same query, ``explain`` must
   show the index scans, and K1 and K2 must have launched;
4. resident path — in the same session, residency ``auto``:
   ``prefetch_index`` puts li_idx's four predicate columns on the card,
   then 20 point lookups, the range filter 5 times and a filter with a
   float64 bound 5 times run through K1c. Every result must equal numpy
   and the same query's per-file result; K1c must have launched once per
   query and K1 never;
5. one ``kernels`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises: the script then exits non-zero without the last
line. ``--scale`` below 1 cuts both tables' row counts (printed).
"""

from __future__ import annotations

import argparse
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
def make_tables(seed: int, n_orders: int, n_lineitem: int):
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
        "l_partkey": rng.integers(1, 200_001, n_lineitem).astype(np.int64),
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


def searchsorted_pair(r, l):
    """The library yardstick of K2: torch.searchsorted left and right."""
    import torch

    return torch.searchsorted(r, l, side="left"), torch.searchsorted(r, l, side="right")


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------
def kernel_phase(lineitem: dict, orders: dict, seed: int) -> dict:
    import torch

    from hyperspace_tpu_torch.ops import build, kernels as tk
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
    }
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
        k1[name] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                        cols=len(names), rows=n, matches=int(want.sum().item()))
        log(f"K1 {name}: rows={n} cols={len(names)} ms={ms:.4f} plain_ms={plain:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) exact=yes")

    # K1 again over operands uploaded once: the program and pointer table
    # too, so the gap to the wrapper's time is its per-call copies
    dispatch, rcols = tk.resident_mask_fn(preds["range_3col"], arrays, device=dev)
    if not torch.equal(dispatch(rcols), tk.predicate_mask_tensor(
            *tk.prepare_predicate(preds["range_3col"], arrays)[:2], rcols)):
        raise AssertionError("K1 resident_mask_fn disagrees with the wrapper")
    k1["range_3col"]["resident_ms"] = time_ms(lambda: dispatch(rcols))
    log(f"K1 range_3col resident_mask_fn: ms={k1['range_3col']['resident_ms']:.4f} "
        f"(wrapper {k1['range_3col']['ms']:.4f})")

    k1c = {}
    narrowed, names, i32 = tk.prepare_predicate(preds["range_3col"], arrays)
    n_pad = -(-n // tk.BLOCK_ROWS) * tk.BLOCK_ROWS
    padded = []
    for c in names:  # zero-padded, as the resident table holds them
        t = torch.zeros(n_pad, dtype=torch.int32, device=dev)
        t[:n] = torch.from_numpy(np.require(i32[c], requirements=["C", "W"])).to(dev)
        padded.append(t)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    large = [  # the same predicate's columns over 2^28 rows, made on the card
        torch.randint(lo, hi, (LARGE_ROWS,), generator=gen, device=dev, dtype=torch.int32)
        for lo, hi in ((1, 6_000_000), (1, 51), (DAY_1992_01_01, DAY_1998_08_02))
    ]
    for name, cols in (("range_3col", padded), ("large_3col", large)):
        rows = int(cols[0].shape[0])
        ptrs = tk.column_pointer_table(cols)
        got = tk.predicate_block_counts_tensor(narrowed, names, cols, ptrs)
        want = tk.predicate_block_counts_reference(narrowed, names, cols)
        torch.cuda.synchronize()
        err = int((got - want).abs().max().item())
        if err != 0 or got.shape != (rows // tk.BLOCK_ROWS,):
            raise AssertionError(f"K1c {name}: kernel disagrees with plain version")
        ms = time_ms(lambda: tk.predicate_block_counts_tensor(narrowed, names, cols, ptrs))
        plain = time_ms(lambda: tk.predicate_block_counts_reference(narrowed, names, cols),
                        repeats=5)
        n_instr = len(tk.lower_predicate(narrowed, names))
        b_ms, b_by = bound(4 * len(names) * rows + 4 * (rows // tk.BLOCK_ROWS),
                           float(rows) * n_instr)
        k1c[name] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                         max_abs_err=err, cols=len(names), rows_padded=rows,
                         matches=int(want.sum().item()))
        log(f"K1c {name}: rows_padded={rows} cols={len(names)} ms={ms:.4f} "
            f"plain_ms={plain:.4f} bound_ms={b_ms:.4f} ({b_by}) exact=yes")
    del large, padded
    torch.cuda.empty_cache()

    # K2 at the join's shapes: left = lineitem keys laid out as the index
    # stores them (grouped by bucket, key-sorted within), right = orders
    # keys stable-sorted
    l_keys = lineitem["l_orderkey"]
    bucket = build.device_bucket_ids(
        {"k": torch.from_numpy(l_keys).to(dev)}, {"k": "int64"}, ["k"], {}, NUM_BUCKETS
    ).cpu().numpy()
    l_codes = l_keys[np.lexsort((l_keys, bucket))]
    r_sorted = np.sort(orders["o_orderkey"], kind="stable")
    cases = {"index_layout": (l_codes, r_sorted)}
    wide = l_codes.copy()
    wide[:8192] = rng.permutation(wide[:8192])  # scattered tiles: host fix-up
    cases["with_wide_tiles"] = (wide, r_sorted)
    k2 = {}
    for name, (l, r) in cases.items():
        plan = tk._plan_sorted_intersect(l, r)
        if plan is None:
            raise AssertionError(f"K2 {name}: the plan declined")
        s_tile, span, base, l_p, r_p, l32, r32, wide_t = plan
        args = [torch.from_numpy(a).to(dev) for a in (s_tile, span, base, l_p, r_p)]
        lt, eq = tk.sorted_intersect_tensors(*args)
        lt_p, eq_p = tk.sorted_intersect_counts_reference(args[3], args[4])
        torch.cuda.synchronize()
        keep = torch.from_numpy(np.repeat(~wide_t, tk.SMJ_TILE)).to(dev)[: len(l)]
        err = max(
            int((lt[: len(l)] - lt_p[: len(l)]).abs()[keep].max().item()),
            int((eq[: len(l)] - eq_p[: len(l)]).abs()[keep].max().item()),
        )
        full = tk.sorted_intersect_counts(l, r, device=dev)
        if err != 0 or not (
            np.array_equal(full[0], np.searchsorted(r, l, side="left"))
            and np.array_equal(full[1], np.searchsorted(r, l, side="right") - full[0])
        ):
            raise AssertionError(f"K2 {name}: kernel disagrees with plain version")
        ms = time_ms(lambda: tk.sorted_intersect_tensors(*args))
        plain = time_ms(lambda: tk.sorted_intersect_counts_reference(args[3], args[4]))

        lib_ms = time_ms(lambda: searchsorted_pair(args[4], args[3]))
        b_ms, b_by = k2_bound(span, len(l_p), len(r_p))
        k2[name] = dict(ms=ms, plain_ms=plain, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                        max_abs_err=err,
                        n_l=len(l), n_r=len(r), wide_tiles=int(wide_t.sum()),
                        max_span=int(span.max()))
        log(f"K2 {name}: n_l={len(l)} n_r={len(r)} wide_tiles={int(wide_t.sum())} "
            f"max_span={int(span.max())} ms={ms:.4f} plain_ms={plain:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) exact=yes")
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
        amortized_ms=tk.resident_smj_amortized(l_sorted, r_sorted, 17, repeats=5,
                                               prepared=run) * 1e3,
        plain_ms=time_ms(lambda: tk.sorted_intersect_counts_reference(d[3], d[4])),
        library_ms=time_ms(lambda: searchsorted_pair(d[4], d[3])),
        bound_ms=b_ms, bound_by=b_by)
    ks = k2["key_sorted"]
    log(f"K2 key_sorted resident_sorted_intersect: ms={ks['resident_ms']:.4f} "
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
    return {"k1": k1, "k1c": k1c, "k2": k2, "fused_agg": agg}


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
    lineitem, orders, workdir: Path, device: str, seed: int, profile: bool = False
) -> dict:
    """Build both indexes and run the three queries on ``device`` with
    residency off, then the resident phase in the same session; every
    result is checked against numpy. Returns timings and counts."""
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
    out["resident"] = resident_phase(session, hsp, li, L, seed, profile)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="fraction of the SF1 row counts (a cut, printed)")
    ap.add_argument("--workdir", default=None, help="scratch directory (default: a temp dir)")
    ap.add_argument("--profile", action="store_true",
                    help="print host and device profiles of each main-path step")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from hyperspace_tpu_torch.ops import kernels as tk
        from hyperspace_tpu_torch.ops import launch_counts
    except ImportError as e:
        print(f"chip_smoke: the hyperspace_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    t_start = time.perf_counter()
    t0 = time.perf_counter()
    tk.build_kernels()
    log(f"setup: kernels built and loaded in {time.perf_counter() - t0:.3f} s")

    n_l = int(round(SF1_LINEITEM * args.scale))
    n_o = int(round(SF1_ORDERS * args.scale))
    if args.scale != 1.0:
        log(f"CUT: scale {args.scale}: lineitem {n_l} rows, orders {n_o} rows (SF1: "
            f"{SF1_LINEITEM}, {SF1_ORDERS})")
    t0 = time.perf_counter()
    lineitem, orders = make_tables(args.seed, n_o, n_l)
    log(f"setup: tables generated in {time.perf_counter() - t0:.3f} s")

    kphase = kernel_phase(lineitem, orders, args.seed)
    # launches above compared kernels with their plain versions; the main
    # path's counts start from zero inside run_main_path
    workdir = Path(args.workdir) if args.workdir else Path(tempfile.mkdtemp(prefix="hs_smoke_"))
    try:
        main_out = run_main_path(lineitem, orders, workdir, "cuda", args.seed, args.profile)
    finally:
        if not args.workdir:
            shutil.rmtree(workdir, ignore_errors=True)
    launches = main_out["launches"]
    for kname in (tk.K1, tk.K2):
        if launches.get(kname, 0) <= 0:
            raise AssertionError(f"{kname} was not launched on the main path")
    res_launches = main_out["resident"]["launches"]

    k1 = kphase["k1"]["range_3col"]
    k1c = kphase["k1c"]["range_3col"]
    k2 = kphase["k2"]["index_layout"]
    line = {"kernels": [
        {"name": tk.K1, "route": "cuda", "source": "hyperspace_tpu_torch/csrc/predicate_mask.cu",
         "replaces": "hyperspace_tpu/ops/kernels.py:237", "launches": launches[tk.K1],
         "max_abs_err": max(c["max_abs_err"] for c in kphase["k1"].values()), "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"], "library_ms": None},
        {"name": tk.K1C, "route": "cuda", "source": "hyperspace_tpu_torch/csrc/predicate_mask.cu",
         "replaces": "hyperspace_tpu/exec/hbm_cache.py:476", "launches": res_launches[tk.K1C],
         "max_abs_err": max(c["max_abs_err"] for c in kphase["k1c"].values()), "ms": k1c["ms"],
         "plain_ms": k1c["plain_ms"], "bound_ms": k1c["bound_ms"], "bound_by": k1c["bound_by"],
         "library_ms": None},
        {"name": tk.K2, "route": "cuda", "source": "hyperspace_tpu_torch/csrc/sorted_intersect.cu",
         "replaces": "hyperspace_tpu/ops/kernels.py:549", "launches": launches[tk.K2],
         "max_abs_err": max(c["max_abs_err"] for c in kphase["k2"].values()), "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"], "library_ms": k2["library_ms"]},
    ]}
    log(json.dumps({"main_path": {k: main_out[k] for k in ("build_s", "query_s", "rows")},
                    "resident_path": main_out["resident"],
                    "kernel_cases": kphase, "total_s": time.perf_counter() - t_start}))
    log(json.dumps(line))
    # the port drives one card
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
